"""The port's backbone probe (aod_meh_hua_torch/tools/pallas_probe.py), its
transposed matmul and the model's conv1x1_matmul option against the JAX
side, on the CPU, on the same numpy inputs.

The JAX tool (tools/analysis/pallas_probe.py) is loaded from its path: its
top level imports only numpy. Tolerances: the transposed matmul is held
to 2^-7 of max|ref|, one bf16 ulp at the largest magnitude, since each
side rounds one f32 sum to bf16; the model's head outputs to 1e-4 in f32
(TF32 does not arise on the CPU), and the port with conv1x1_matmul to the
port without it to 1e-5 of the output's scale (the same f32 sums in
another order).
"""

import argparse
import contextlib
import importlib.util
import io
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aod_meh_hua_tpu.utils.config import tiny_test_config as jtiny
from aod_meh_hua_torch.models.convert import from_jax_variables
from aod_meh_hua_torch.models.detector import build_retinanet
from aod_meh_hua_torch.models.resnet import Conv1x1Matmul
from aod_meh_hua_torch.ops.transposed_matmul import (transposed_matmul,
                                                     transposed_matmul_reference)
from aod_meh_hua_torch.tools import pallas_probe as probe
from aod_meh_hua_torch.utils.config import tiny_test_config as ttiny

from torch_parity import few_threads  # noqa: F401 (the fixture of pytestmark)
from torch_parity import jax_retinanet

pytestmark = pytest.mark.usefixtures("few_threads")

REPO = Path(__file__).resolve().parents[1]
TOL = 2.0 ** -7
TINY = dict(block_counts=(2, 2, 1, 1), stem_width=32)


@pytest.fixture(scope="module")
def jax_tool():
    spec = importlib.util.spec_from_file_location(
        "jax_pallas_probe", REPO / "tools" / "analysis" / "pallas_probe.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("canvas", [(608, 1024), (64, 128)])
def test_conv_shapes_are_the_jax_tools(jax_tool, canvas):
    assert probe.resnet50_conv_shapes(*canvas) == jax_tool.resnet50_conv_shapes(*canvas)


@pytest.mark.parametrize("m", [38912, 1000])  # batch 1 of the probe; a ragged M
def test_transposed_matmul_matches_jax_form(m):
    k, n = 256, 64
    rng = np.random.RandomState(0)  # the JAX tool's inputs (pallas_probe.py:199-203)
    x_np = rng.randn(m, k).astype(np.float32) * 0.1
    wt_np = rng.randn(k, n).astype(np.float32) * 0.02
    px, pw = probe.probe_inputs(m, k, n)
    np.testing.assert_array_equal(px, x_np)
    np.testing.assert_array_equal(pw, wt_np)

    xt_np, wtt_np = np.ascontiguousarray(x_np.T), np.ascontiguousarray(wt_np.T)
    want = np.asarray(jnp.dot(jnp.asarray(wtt_np, jnp.bfloat16), jnp.asarray(xt_np, jnp.bfloat16),
                              preferred_element_type=jnp.float32).astype(jnp.bfloat16)
                      ).astype(np.float32)
    wtt = torch.from_numpy(wtt_np).to(torch.bfloat16)
    xt = torch.from_numpy(xt_np).to(torch.bfloat16)
    got = transposed_matmul_reference(wtt, xt)
    assert got.dtype == torch.bfloat16 and got.shape == (n, m)
    err = np.abs(got.float().numpy() - want).max()
    assert err <= TOL * np.abs(want).max(), err
    # on a CPU tensor the wrapper is the plain version, and launches nothing
    before = transposed_matmul.launches
    assert torch.equal(transposed_matmul(wtt, xt), got)
    assert transposed_matmul.launches == before


class _Timings(Exception):
    """Raised where the JAX tool starts its timings, which the check below
    does not read."""


def test_jax_pallas_kernel_matches_its_xla_form(jax_tool, monkeypatch):
    """The Pallas kernel, in interpret mode as the tool's --cpu runs it,
    equals jnp.dot(wtt, xt, f32).astype(bf16): the form the port's plain
    version is held to above. The tool is stopped at its timings, after
    the check."""

    def stop(*args, **kwargs):
        raise _Timings

    monkeypatch.setattr(jax_tool, "_chain_timed", stop)
    out = io.StringIO()
    with contextlib.redirect_stdout(out), pytest.raises(_Timings):
        jax_tool.matmul_probe(argparse.Namespace(batch=1, iters=1, loop=False, cpu=True))
    lines = [json.loads(s) for s in out.getvalue().splitlines() if "pallas_vs_xla" in s]
    assert lines == [{"pallas_vs_xla_max_abs_err": 0.0}]


def test_transposed_matmul_rejects_what_the_kernel_does_not_take():
    wt = torch.zeros((64, 256), dtype=torch.bfloat16)
    xt = torch.zeros((256, 1024), dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        transposed_matmul(wt, xt[:, ::2])                 # not contiguous
    with pytest.raises(TypeError):
        transposed_matmul(wt.float(), xt.float())         # not bf16
    with pytest.raises(ValueError):
        transposed_matmul(wt, xt[:128].contiguous())      # K does not match
    with pytest.raises(ValueError):
        transposed_matmul(wt[:48].contiguous(), xt)       # N not instantiated
    with pytest.raises(ValueError):
        transposed_matmul(torch.zeros((64, 48), dtype=torch.bfloat16), xt[:48].contiguous())


def _not_measured(values):
    assert values and all(v == probe.NOT_MEASURED for v in values)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_census_on_the_cpu(dtype):
    tf32_before = torch.backends.cudnn.allow_tf32
    rows = probe.census(batch=1, iters=1, dtype=dtype, device="cpu", canvas=probe.CPU_CANVAS)
    assert [r["op"] for r in rows[:-1]] == [s[0] for s in probe.resnet50_conv_shapes(64, 128)]
    _not_measured([r["ms"] for r in rows] + [r["pct_peak"] for r in rows])
    total = rows[-1]
    assert total["op"] == "TOTAL(weighted)" and total["device"] == "cpu"
    assert total["ideal_ms"] == pytest.approx(sum(r["ideal_ms"] * r["count"] for r in rows[:-1]))
    assert all(r["bound_ms"] >= r["ideal_ms"] > 0 for r in rows)
    # the 1x1 stride-2 downsample (16x32 -> 8x16, 256 -> 512) reads a quarter of its input
    down = next(r for r in rows if r["op"] == "C3.b0.down")
    nbytes = dtype.itemsize * (256 * 8 * 16 + 512 * 256 + 512 * 8 * 16)
    assert down["bound_ms"] == pytest.approx(
        max(nbytes / probe.HBM_BYTES_PER_S * 1e3, down["ideal_ms"]))
    assert torch.backends.cudnn.allow_tf32 == tf32_before  # restored


def test_matmul_probe_on_the_cpu():
    res = probe.matmul_probe(batch=2, iters=1, device="cpu", canvas=probe.CPU_CANVAS)
    assert (res["n"], res["k"], res["m"]) == (64, 256, 2 * 16 * 32)
    assert list(res["forms"]) == ["conv_1x1_nhwc", "matmul_MK_KN", "matmul_NK_KM_transposed",
                                  "kernel_NK_KM_transposed"]
    assert res["kernel_calls"] == 1 and res["bound_by"] == "bytes"
    _not_measured([f[key] for f in res["forms"].values() for key in ("ms", "pct_peak")])
    assert all(f["max_abs_err"] <= res["tol"] for f in res["forms"].values())


def test_block_probe_on_the_cpu():
    res = probe.block_probe(batch=1, iters=1, device="cpu", canvas=probe.CPU_CANVAS)
    assert list(res["cases"]) == ["C2.bN", "C2.b0", "C3.bN"] and res["kernel_calls"] == 3
    _not_measured([c[key] for c in res["cases"].values()
                   for key in ("unfused_ms", "fused_ms", "speedup")])
    assert all(c["fused_vs_unfused_rel_err"] <= probe.BLOCK_TOL for c in res["cases"].values())


def test_probe_cli_needs_a_card_or_cpu(capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        probe.main(["--matmul", "--batch", "1"])
    probe.main(["--matmul", "--cpu", "--batch", "1"])
    line = json.loads(capsys.readouterr().out)
    assert line["matmul"]["forms"]["kernel_NK_KM_transposed"]["ms"] == probe.NOT_MEASURED


def test_conv1x1_matmul_matches_jax():
    model, variables = jax_retinanet(conv1x1_matmul=True, **TINY)
    h, w = jtiny().for_orientation("landscape").canvas
    x = np.random.RandomState(0).randn(2, h, w, 3).astype(np.float32)
    want = [np.asarray(a) for a in jax.jit(model.apply)(variables, x)]

    sd = from_jax_variables(variables)
    outs = {}
    for flag in (True, False):
        port = build_retinanet(ttiny(conv1x1_matmul=flag, **TINY), device="cpu")
        port.load_state_dict(sd)
        # with the flag: conv1 and conv3 of each of the 6 blocks, and the 4 downsamples
        assert sum(isinstance(m, Conv1x1Matmul) for m in port.modules()) == (16 if flag else 0)
        with torch.no_grad():
            outs[flag] = [a.numpy() for a in port(torch.from_numpy(x))]
    for name, g, g_off, r in zip(("cls_scores", "bbox_preds", "lambdas"), outs[True],
                                 outs[False], want):
        assert g.shape == r.shape, name
        np.testing.assert_allclose(g, r, atol=1e-4, rtol=1e-4, err_msg=name)
        assert np.abs(g - g_off).max() <= 1e-5 * np.abs(g_off).max(), name


def test_fused_blocks_take_precedence_over_conv1x1_matmul():
    cfg = dict(TINY, fused_blocks=True)
    both = build_retinanet(ttiny(conv1x1_matmul=True, **cfg), device="cpu")
    fused = build_retinanet(ttiny(**cfg), device="cpu")
    fused.load_state_dict(both.state_dict())
    x = torch.from_numpy(np.random.RandomState(1).randn(1, 64, 128, 3).astype(np.float32))
    feats = {}
    for name, model in (("both", both), ("fused", fused)):
        calls = []
        for m in model.modules():
            if isinstance(m, Conv1x1Matmul):
                m.register_forward_hook(lambda mod, i, o: calls.append(mod))
        with torch.no_grad():
            feats[name] = model.backbone(x.permute(0, 3, 1, 2).contiguous(
                memory_format=torch.channels_last))
        feats[name + "_calls"] = len(calls)
    # layer1.1 and layer2.1 fuse: their four 1x1 convs never run as matmuls
    assert feats["both_calls"] == 16 - 4 and feats["fused_calls"] == 0
    for a, b in zip(feats["both"], feats["fused"]):
        assert (a - b).abs().max().item() <= 1e-5 * b.abs().max().item()
