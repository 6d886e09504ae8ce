"""Fused stride-1 ResNet bottleneck: BN folding, the CUDA kernel's
wrapper and its plain PyTorch version.

Port of aod_meh_hua_tpu/ops/fused_block.py (`FoldedBlock`, `fold_bn`,
`fold_bottleneck`, and the Pallas kernel `fused_bottleneck`). The block

    out = relu( conv3(relu(conv2_3x3(relu(conv1(x) + b1)) + b2)) + b3
                + residual(x) )

runs in one kernel (csrc/fused_bottleneck.cu) that keeps every
intermediate in shared memory. BN is frozen, so it folds into the convs
exactly: w' = w * scale / sqrt(var + eps), b' = bias - mean * scale /
sqrt(var + eps).

Layouts are the JAX package's: x and the output are NHWC; w1 [Cin, P],
w2 [9, P, P] (taps HW-major, then in, out), w3 [P, Cout], wd [Cin, Cout];
biases [1, C] in float32. Inference only: the kernel has no backward,
as the JAX kernel defines no VJP, so differentiating through the
operator raises, as jax.grad through the JAX kernel does.

The kernel is the PyTorch operator `aod_meh_hua_torch::fused_bottleneck`
(torch.library), so that torch.export keeps it as one node of an
exported program, as jax.export keeps the Pallas call inside its
artifact. Loading such a program needs this module imported, which
registers the operator.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_PLANES = (32, 64, 128)  # bottleneck widths the kernel is instantiated for


class FoldedBlock(NamedTuple):
    """BN-folded bottleneck weights (see fold_bottleneck)."""

    w1: torch.Tensor  # [Cin, P]
    b1: torch.Tensor  # [1, P]
    w2: torch.Tensor  # [9, P, P] (3x3 taps, HW-major)
    b2: torch.Tensor  # [1, P]
    w3: torch.Tensor  # [P, Cout]
    b3: torch.Tensor  # [1, Cout]
    wd: Optional[torch.Tensor]  # [Cin, Cout] downsample or None
    bd: Optional[torch.Tensor]  # [1, Cout]


def fold_bn(weight: torch.Tensor, scale, bias, mean, var, eps: float = 1e-5):
    """Fold a frozen BatchNorm into the preceding OIHW conv weight (exact)."""
    s = scale / torch.sqrt(var + eps)
    return weight * s[:, None, None, None], bias - mean * s


def fold_bottleneck(block) -> FoldedBlock:
    """models/resnet.py Bottleneck (OIHW convs + FrozenBatchNorm2d) ->
    FoldedBlock in the kernel's layout."""

    def folded(conv, bn):
        return fold_bn(conv.weight, bn.weight, bn.bias, bn.running_mean,
                       bn.running_var, bn.eps)

    k1, b1 = folded(block.conv1, block.bn1)
    k2, b2 = folded(block.conv2, block.bn2)
    k3, b3 = folded(block.conv3, block.bn3)
    p, cin = k1.shape[:2]
    cout = k3.shape[0]
    wd = bd = None
    if block.downsample is not None:
        kd, bd_ = folded(block.downsample[0], block.downsample[1])
        wd = kd.reshape(cout, cin).t()
        bd = bd_.reshape(1, -1)
    return FoldedBlock(
        w1=k1.reshape(p, cin).t(), b1=b1.reshape(1, -1),
        w2=k2.permute(2, 3, 1, 0).reshape(9, p, p), b2=b2.reshape(1, -1),
        w3=k3.reshape(cout, p).t(), b3=b3.reshape(1, -1),
        wd=wd, bd=bd,
    )


def fused_bottleneck_reference(x: torch.Tensor, fb: FoldedBlock) -> torch.Tensor:
    """The plain PyTorch version: F.conv2d on the folded weights in f32,
    with weights and intermediates rounded to x's dtype where the kernel
    rounds them. x [B, H, W, Cin] -> [B, H, W, Cout] in x's dtype."""
    dt = x.dtype
    p = fb.w1.shape[1]

    def w(t):
        return t.to(dt).float()

    def bias(t):
        return t.float().reshape(1, -1, 1, 1)

    xf = x.float().permute(0, 3, 1, 2)
    y = F.conv2d(xf, w(fb.w1).t()[:, :, None, None]) + bias(fb.b1)
    y = torch.relu(y).to(dt).float()
    w2 = w(fb.w2).reshape(3, 3, p, p).permute(3, 2, 0, 1)
    y = F.conv2d(y, w2, padding=1) + bias(fb.b2)
    y = torch.relu(y).to(dt).float()
    y = F.conv2d(y, w(fb.w3).t()[:, :, None, None]) + bias(fb.b3)
    if fb.wd is None:
        res = xf
    else:
        res = F.conv2d(xf, w(fb.wd).t()[:, :, None, None]) + bias(fb.bd)
    return torch.relu(y + res).to(dt).permute(0, 2, 3, 1).contiguous()


def _check_and_launch(x: torch.Tensor, w1, b1, w2, b2, w3, b3, wd, bd) -> torch.Tensor:
    """The CUDA kernel on x [B, H, W, Cin] and the folded weights: the
    checks, the launch on the current stream, the launch count."""
    if x.dim() != 4 or not x.is_contiguous():
        raise ValueError("fused_bottleneck: x must be a contiguous NHWC tensor")
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"fused_bottleneck: dtype {x.dtype} is not float32 or bfloat16")
    b, h, w_, cin = x.shape
    p = w1.shape[1]
    cout = w3.shape[1]
    if p not in _PLANES:
        raise ValueError(f"fused_bottleneck: bottleneck width {p} not in {_PLANES}")
    if cin % 32 or cout % p:
        raise ValueError(f"fused_bottleneck: needs Cin % 32 == 0 and Cout % P == 0 "
                         f"(Cin={cin}, P={p}, Cout={cout})")
    if wd is None and cin != cout:
        raise ValueError("fused_bottleneck: identity residual needs Cin == Cout")
    if not 0 < b <= 65535:
        raise ValueError(f"fused_bottleneck: batch {b} out of range")
    if x.data_ptr() % 16:
        raise ValueError("fused_bottleneck: x must be 16-byte aligned")
    if tuple(w1.shape) != (cin, p) or tuple(w2.shape) != (9, p, p):
        raise ValueError("fused_bottleneck: weight shapes do not match x")

    from ..kernels.build import load

    dt = x.dtype
    dev = x.device

    # no copies for a FoldedBlock already in the kernel's layout
    # (models/resnet.py Bottleneck.folded)
    def wt(t):
        return t.to(device=dev, dtype=dt).contiguous()

    def bs(t):
        return t.to(device=dev, dtype=torch.float32).reshape(-1).contiguous()

    args = [wt(w1), bs(b1), wt(w2), bs(b2), wt(w3), bs(b3)]
    args += [None, None] if wd is None else [wt(wd), bs(bd)]
    out = torch.empty((b, h, w_, cout), dtype=dt, device=dev)
    lib = load("fused_bottleneck")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.fused_bottleneck_launch(
            _DTYPE_CODES[dt], x.data_ptr(),
            *[None if a is None else a.data_ptr() for a in args],
            out.data_ptr(), b, h, w_, cin, p, cout, ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"fused_bottleneck kernel launch failed: CUDA error {rc}")
    fused_bottleneck.launches += 1
    return out


# The block as a PyTorch operator, so that torch.export records it as one
# node (the counterpart of the Pallas call inside a jax.export artifact)
# and a saved program calls the kernel when it runs. It dispatches on the
# tensors' device: CUDA -> the kernel, CPU -> the plain version; no other
# device, and no fallback from the one to the other.
@torch.library.custom_op("aod_meh_hua_torch::fused_bottleneck", mutates_args=())
def _fused_bottleneck_op(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                         w2: torch.Tensor, b2: torch.Tensor, w3: torch.Tensor,
                         b3: torch.Tensor, wd: Optional[torch.Tensor],
                         bd: Optional[torch.Tensor]) -> torch.Tensor:
    raise ValueError(f"fused_bottleneck: unsupported device {x.device}")


@_fused_bottleneck_op.register_kernel("cuda")
def _(x, w1, b1, w2, b2, w3, b3, wd, bd):
    return _check_and_launch(x, w1, b1, w2, b2, w3, b3, wd, bd)


@_fused_bottleneck_op.register_kernel("cpu")
def _(x, w1, b1, w2, b2, w3, b3, wd, bd):
    return fused_bottleneck_reference(x, FoldedBlock(w1, b1, w2, b2, w3, b3, wd, bd))


@_fused_bottleneck_op.register_fake
def _(x, w1, b1, w2, b2, w3, b3, wd, bd):
    return x.new_empty((*x.shape[:3], w3.shape[1]))


def _no_backward(ctx, grad):
    raise RuntimeError(
        "fused_bottleneck has no backward (the kernel is for scoring and eval, as "
        "the JAX kernel, which defines no VJP); train with fused_blocks=False")


_fused_bottleneck_op.register_autograd(_no_backward)


def fused_bottleneck(x: torch.Tensor, fb: FoldedBlock) -> torch.Tensor:
    """One stride-1 bottleneck block, fused. x: [B, H, W, Cin] NHWC.

    Calls the operator `aod_meh_hua_torch::fused_bottleneck`: a CUDA
    tensor goes through the hand-written kernel, which raises on what it
    does not take and on a failed build or launch; a CPU tensor goes
    through fused_bottleneck_reference. `fused_bottleneck.launches`
    counts the kernel's launches. A backward through it raises (the
    kernel has none, as the JAX kernel defines no VJP).
    """
    return _fused_bottleneck_op(x, *fb)


fused_bottleneck.launches = 0
