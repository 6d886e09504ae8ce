"""Transposed bf16 matrix product: the CUDA kernel's wrapper and its plain
PyTorch version.

Port of the Pallas kernel `pallas_t` (body `pallas_kernel`) of
tools/analysis/pallas_probe.py:232-252, which computes the C2 1x1 conv of
R50 as [N, K] @ [K, M] (N=64 output channels, K=256 input channels, M
spatial sites):

    out[n, m] = bf16( sum_k f32(wt[n, k]) * f32(xt[k, m]) )

The kernel is csrc/transposed_matmul.cu; it takes N in (32, 64) and K a
multiple of 32 up to 256.
"""

from __future__ import annotations

import ctypes

import torch

_N = (32, 64)      # output rows the kernel is instantiated for
_K_STEP, _K_MAX = 32, 256


def transposed_matmul_reference(wt: torch.Tensor, xt: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version: one f32 product, rounded to bf16 once."""
    return (wt.float() @ xt.float()).to(torch.bfloat16)


def _check(wt: torch.Tensor, xt: torch.Tensor) -> None:
    if wt.device != xt.device:
        raise ValueError(f"transposed_matmul: wt on {wt.device}, xt on {xt.device}")
    if wt.dtype != torch.bfloat16 or xt.dtype != torch.bfloat16:
        raise TypeError(f"transposed_matmul: needs bfloat16, got {wt.dtype} and {xt.dtype}")
    if wt.dim() != 2 or xt.dim() != 2 or not wt.is_contiguous() or not xt.is_contiguous():
        raise ValueError("transposed_matmul: wt [N, K] and xt [K, M] must be contiguous 2-D")
    (n, k), (k2, m) = wt.shape, xt.shape
    if k != k2:
        raise ValueError(f"transposed_matmul: wt has K={k}, xt has K={k2}")
    if n not in _N or k % _K_STEP or not 0 < k <= _K_MAX or m == 0:
        raise ValueError(f"transposed_matmul: takes N in {_N}, K a multiple of {_K_STEP} "
                         f"up to {_K_MAX} and M > 0 (N={n}, K={k}, M={m})")


def transposed_matmul(wt: torch.Tensor, xt: torch.Tensor) -> torch.Tensor:
    """wt [N, K] @ xt [K, M] -> [N, M], all bfloat16, summed in f32.

    A CUDA tensor goes through the hand-written kernel, which raises on
    what it does not take and on a failed build or launch; a CPU tensor
    goes through transposed_matmul_reference. Both devices take the same
    shapes and types. `transposed_matmul.launches` counts the kernel's
    launches.
    """
    _check(wt, xt)
    if xt.device.type == "cpu":
        return transposed_matmul_reference(wt, xt)
    if xt.device.type != "cuda":
        raise ValueError(f"transposed_matmul: unsupported device {xt.device}")

    from ..kernels.build import load

    (n, k), m = wt.shape, xt.shape[1]
    out = torch.empty((n, m), dtype=torch.bfloat16, device=xt.device)
    lib = load("transposed_matmul")
    with torch.cuda.device(xt.device):
        stream = torch.cuda.current_stream(xt.device).cuda_stream
        rc = lib.transposed_matmul_launch(wt.data_ptr(), xt.data_ptr(), out.data_ptr(),
                                          n, k, m, ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"transposed_matmul kernel launch failed: CUDA error {rc}")
    transposed_matmul.launches += 1
    return out


transposed_matmul.launches = 0
