"""The port's kernel build (aod_meh_hua_torch/kernels/build.py) on the CPU:
how a library is named. No nvcc is needed: names are hashes of the
sources, the shared headers and the flags, and are computed before any
build."""

import re
import shutil

import pytest

from aod_meh_hua_torch.kernels import build


@pytest.fixture
def tmp_pkg(tmp_path, monkeypatch):
    """A copy of the package's csrc/ that build.py reads instead."""
    shutil.copytree(build._PKG / "csrc", tmp_path / "csrc")
    monkeypatch.setattr(build, "_PKG", tmp_path)
    return tmp_path / "csrc"


def test_names_are_stable(tmp_pkg):
    names = {n: build.library_path(n) for n in build.SIGNATURES}
    assert names == {n: build.library_path(n) for n in build.SIGNATURES}
    assert len(set(names.values())) == len(names)
    assert all(p.parent == build.BUILD_DIR for p in names.values())


def test_header_change_renames_every_library(tmp_pkg):
    before = {n: build.library_path(n) for n in build.SIGNATURES}
    header = tmp_pkg / "tc_tile.cuh"
    text = header.read_text()
    header.write_text(text + "\n// edited\n")
    edited = {n: build.library_path(n) for n in build.SIGNATURES}
    assert all(edited[n] != before[n] for n in build.SIGNATURES)
    header.write_text(text)
    assert {n: build.library_path(n) for n in build.SIGNATURES} == before
    (tmp_pkg / "extra.cuh").write_text("#pragma once\n")  # a new header counts too
    assert all(build.library_path(n) != before[n] for n in build.SIGNATURES)


@pytest.mark.parametrize("name", sorted(build.SIGNATURES))
def test_source_change_renames_only_its_library(tmp_pkg, name):
    before = {n: build.library_path(n) for n in build.SIGNATURES}
    src = tmp_pkg / f"{name}.cu"
    src.write_text(src.read_text() + "\n// edited\n")
    after = {n: build.library_path(n) for n in build.SIGNATURES}
    assert after[name] != before[name]
    assert all(after[n] == before[n] for n in build.SIGNATURES if n != name)


def test_sources_include_only_the_shared_headers():
    """Every quoted include of a kernel source is a header of csrc/, so the
    digest covers all the code a library is built from."""
    csrc = build._PKG / "csrc"
    headers = {p.name for p in csrc.glob("*.cuh")}
    assert "tc_tile.cuh" in headers
    for name in build.SIGNATURES:
        text = (csrc / f"{name}.cu").read_text()
        quoted = re.findall(r'#include\s+"([^"]+)"', text)
        assert quoted and set(quoted) <= headers, (name, quoted)


@pytest.mark.parametrize("ablate", ["", "wgmma", "split"])
def test_phase_probes_fit_the_kernel(ablate):
    """tools/kernel_phases.py instruments the fused kernel by text: every
    anchor it needs is in the source once, with or without an ablation."""
    from aod_meh_hua_torch.tools import kernel_phases

    src = build._source("fused_bottleneck").read_text()
    pairs = kernel_phases._PROBES + kernel_phases.ABLATIONS.get(ablate, [])
    out = kernel_phases._replace(src, pairs)
    assert "g_phase" in out and out.count("clock64()") >= 5
