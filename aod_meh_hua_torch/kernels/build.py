"""Build and load the port's CUDA kernels.

Each source under `aod_meh_hua_torch/csrc/` is compiled by `nvcc` for
sm_90a into a shared library with a plain C interface, and loaded with
ctypes. Nothing is built when this module is imported: the first call to
`load` builds, or `build_all` builds every kernel at once, one `nvcc`
process per source, all started together.

Libraries go to `build/kernels/` at the root of the checkout (listed in
.gitignore), named by a hash of the source, the shared headers
(`csrc/*.cuh`, which every source may include) and the flags, so an
edited source or header is rebuilt and an unchanged one is reused.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict

_PKG = Path(__file__).resolve().parents[1]
BUILD_DIR = _PKG.parent / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]

_P = ctypes.c_void_p
_I = ctypes.c_int
# C signature of each kernel's launcher: (name, argtypes)
SIGNATURES = {
    "fused_bottleneck": ("fused_bottleneck_launch",
                         [_I] + [_P] * 10 + [_I] * 6 + [_P]),
    "transposed_matmul": ("transposed_matmul_launch",
                          [_P] * 3 + [_I] * 2 + [ctypes.c_longlong, _P]),
}

_LIBS: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: the port's CUDA kernels are built "
                           "with the CUDA toolkit on the machine with the card")
    return found


def _source(name: str) -> Path:
    return _PKG / "csrc" / f"{name}.cu"


def library_path(name: str) -> Path:
    h = hashlib.sha256(_source(name).read_bytes())
    for header in sorted((_PKG / "csrc").glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    digest = h.hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def _start(name: str):
    """Start nvcc for one source; returns (Popen, tmp, target) or None
    when the library is already built."""
    target = library_path(name)
    if target.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(_source(name))]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, tmp, target


def _finish(name: str, started) -> None:
    proc, tmp, target = started
    out, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name} (exit {proc.returncode}):\n{out}")
    os.replace(tmp, target)  # atomic: a concurrent builder sees all or nothing


def start_build() -> dict:
    """Start one nvcc per kernel not yet built, all together, and return
    at once: pass the result to finish_build (the caller may work on the
    card meanwhile)."""
    return {n: _start(n) for n in SIGNATURES}


def finish_build(started: dict) -> None:
    """Wait for start_build's nvcc processes; raises when one failed."""
    for n, s in started.items():
        if s is not None:
            _finish(n, s)


def build_all() -> None:
    """Build every kernel, one nvcc per source, all started together."""
    finish_build(start_build())


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel `name`, built at first use."""
    lib = _LIBS.get(name)
    if lib is None:
        started = _start(name)
        if started is not None:
            _finish(name, started)
        lib = ctypes.CDLL(str(library_path(name)))
        fn_name, argtypes = SIGNATURES[name]
        fn = getattr(lib, fn_name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _LIBS[name] = lib
    return lib
