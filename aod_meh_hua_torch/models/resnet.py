"""Bottleneck ResNet backbone with frozen BN (torch).

Port of aod_meh_hua_tpu/models/resnet.py (`Bottleneck` :125-219, `ResNet`
:270-328), which mirrors the reference's mmdet/models/backbones/resnet.py
(depth 50, pytorch style: the stride sits on the 3x3 conv;
norm_eval=True). BN always uses its running statistics, an affine map.

The module runs NCHW tensors in `channels_last` memory, so a fused block
hands the kernel an NHWC view without a copy. Stride-1 blocks of the
stages in `stage_fused` take the fused kernel (ops/fused_block.py) under
the JAX package's gate, so the same blocks fuse in both packages. The
kernel has no backward: a backward through a fused block raises, so a
model is trained with fused_blocks off, as in the JAX package. With
`conv1x1_matmul`, the 1x1 convs of the other blocks run as matrix
products (`Conv1x1Matmul`). With `mc_dropout` > 0, `channel_dropout`
follows every ReLU (the stem's and the three of each block), drawing its
masks from the generator the caller passes to the forward. With
`attention` (an attention_type string), the blocks of the stages in
`stage_with_attention` (c4 and c5) run a GeneralizedAttention (8 heads,
kv_stride 2) after conv2's BN and ReLU, the empirical-attention family's
plugin (JAX models/resnet.py:135-137, 196-201, 285-287, 321); such a
block never fuses.
"""

from __future__ import annotations

import contextlib
from typing import Iterator, Optional, Sequence, Tuple

import torch
from torch import nn

from ..ops.fused_block import FoldedBlock, fold_bottleneck, fused_bottleneck
from ..utils.profiling import span
from .attention import ATTENTION_SPAN, GeneralizedAttention

_NOT_PORTED = "not in the port yet (ROADMAP Queue 1 item {})"


def channel_dropout(x: torch.Tensor, rate: float,
                    generator: Optional[torch.Generator]) -> torch.Tensor:
    """Dropout2d on NCHW `x`: each (image, channel) map is zeroed with
    probability `rate`, the survivors scaled by 1 / (1 - rate). Always
    active when rate > 0: the MC-dropout baseline's stochastic passes
    (aod_meh_hua_tpu/models/resnet.py:31-36, flax Dropout with the H and
    W axes broadcast; the reference's Dropout2d after every ReLU,
    functions.py:492-505). The masks come from `generator`, on x's
    device, never from the global RNG; torch's and JAX's generators give
    other masks from one seed, so the two packages agree in distribution
    only."""
    if rate == 0.0:
        return x
    if generator is None:
        raise ValueError("mc_dropout > 0 needs a torch.Generator in the forward")
    keep_prob = 1.0 - rate
    keep = torch.rand((x.shape[0], x.shape[1], 1, 1), generator=generator,
                      device=x.device) < keep_prob
    return torch.where(keep, x / keep_prob, torch.zeros((), dtype=x.dtype, device=x.device))


class FrozenBatchNorm2d(nn.Module):
    """BatchNorm at its running statistics: y = (x - mean) * scale /
    sqrt(var + eps) + bias, eps 1e-5."""

    def __init__(self, num_features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = self.weight * torch.rsqrt(self.running_var + self.eps)
        b = self.bias - self.running_mean * s
        return x * s.reshape(1, -1, 1, 1) + b.reshape(1, -1, 1, 1)


class Conv1x1Matmul(nn.Conv2d):
    """A 1x1, zero-padding conv computed as [B*H*W, Cin] @ [Cin, Cout] with
    torch.matmul (aod_meh_hua_tpu/models/resnet.py:39-69). The stride is
    taken by subsampling the input first. The parameters are the
    nn.Conv2d's, so state_dicts and from_jax_variables do not change."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        sy, sx = self.stride
        if (sy, sx) != (1, 1):
            x = x[:, :, ::sy, ::sx]
        b, cin, h, w = x.shape
        y = torch.matmul(x.permute(0, 2, 3, 1).reshape(b * h * w, cin),
                         self.weight.reshape(self.out_channels, cin).t())
        return y.reshape(b, h, w, self.out_channels).permute(0, 3, 1, 2)


def _conv(cin: int, cout: int, k: int, stride: int = 1, pad: int = 0,
          as_matmul: bool = False) -> nn.Conv2d:
    """nn.Conv2d without bias, or Conv1x1Matmul for a 1x1, zero-padding
    conv when `as_matmul` (the JAX package's `_make_conv`)."""
    if as_matmul and k == 1 and pad == 0:
        return Conv1x1Matmul(cin, cout, 1, stride=stride, bias=False)
    return nn.Conv2d(cin, cout, k, stride=stride, padding=pad, bias=False)


def _kernel_layout(fb: FoldedBlock, dtype: torch.dtype) -> FoldedBlock:
    """Weights contiguous in `dtype`, biases contiguous float32."""
    return FoldedBlock(*(
        None if a is None else a.to(dtype if name.startswith("w") else torch.float32)
        .contiguous() for name, a in zip(FoldedBlock._fields, fb)))


class Bottleneck(nn.Module):
    """1x1 -> 3x3 (stride) -> 1x1 (4 * planes) + residual, ReLU after each."""

    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 downsample: bool = False, fused: bool = False,
                 conv1x1_matmul: bool = False, mc_dropout: float = 0.0,
                 attention: Optional[str] = None):
        super().__init__()
        self.stride = stride
        self.fused = fused
        self.mc_dropout = mc_dropout
        self.conv1 = _conv(inplanes, planes, 1, as_matmul=conv1x1_matmul)
        self.bn1 = FrozenBatchNorm2d(planes)
        self.conv2 = _conv(planes, planes, 3, stride, 1)
        self.bn2 = FrozenBatchNorm2d(planes)
        self.gen_attention = (GeneralizedAttention(planes, 8, attention, kv_stride=2)
                              if attention else None)
        self.conv3 = _conv(planes, planes * 4, 1, as_matmul=conv1x1_matmul)
        self.bn3 = FrozenBatchNorm2d(planes * 4)
        self.downsample = None
        if downsample:
            self.downsample = nn.Sequential(_conv(inplanes, planes * 4, 1, stride,
                                                  as_matmul=conv1x1_matmul),
                                            FrozenBatchNorm2d(planes * 4))
        self._folded: Optional[FoldedBlock] = None
        self._folded_key = None
        self.fold_in_graph = False  # set by folds_in_graph

    def folded(self, dtype: torch.dtype, in_graph: bool = False) -> FoldedBlock:
        """fold_bottleneck(self) in the kernel's layout: weights contiguous
        in `dtype`, biases contiguous float32, on the parameters' device.

        Without `in_graph` it is folded once and cached, without autograd;
        refolded when a parameter or buffer is replaced, moved or edited in
        place (its `_version` moves), or when `dtype` changes. With
        `in_graph` it is folded anew from the parameters, as operations
        that autograd and torch.export record: a forward that may be
        differentiated takes it (so the operator's backward raises), and
        so does a model under `folds_in_graph` (export)."""
        if in_graph:
            return _kernel_layout(fold_bottleneck(self), dtype)
        tensors = list(self.parameters()) + list(self.buffers())
        key = (dtype, tuple((t.device, t.dtype, t.data_ptr(), t._version) for t in tensors))
        if key != self._folded_key:
            with torch.no_grad():
                self._folded = _kernel_layout(fold_bottleneck(self), dtype)
            self._folded_key = key
        return self._folded

    def fused_eligible(self, cin: int) -> bool:
        """The JAX package's gate (models/resnet.py:145-156): stride 1,
        128-aligned input channels, no dropout and no attention plugin. A
        block with dropout or attention takes the unfused path: that is
        the JAX model's rule (the kernel has neither inside), not a
        fallback."""
        return (self.fused and self.stride == 1 and cin % 128 == 0
                and self.mc_dropout == 0.0 and self.gen_attention is None)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        # fused blocks take precedence over conv1x1_matmul, as in the JAX package
        if self.fused_eligible(x.shape[1]):
            nhwc = x.permute(0, 2, 3, 1)  # a view when x is channels_last
            # differentiating through the kernel raises (it has no backward)
            in_graph = self.fold_in_graph or (torch.is_grad_enabled() and (
                x.requires_grad or any(p.requires_grad for p in self.parameters())))
            out = fused_bottleneck(nhwc.contiguous(), self.folded(x.dtype, in_graph))
            return out.permute(0, 3, 1, 2)
        drop = lambda v: channel_dropout(v, self.mc_dropout, generator)  # noqa: E731
        identity = x
        y = drop(torch.relu(self.bn1(self.conv1(x))))
        y = drop(torch.relu(self.bn2(self.conv2(y))))
        if self.gen_attention is not None:
            with span(ATTENTION_SPAN):
                y = self.gen_attention(y)
        y = self.bn3(self.conv3(y))
        if self.downsample is not None:
            identity = self.downsample(x)
        return drop(torch.relu(y + identity))


@contextlib.contextmanager
def folds_in_graph(model: nn.Module) -> Iterator[nn.Module]:
    """Within the block, every fused Bottleneck of `model` folds its BN
    from the parameters on each forward (Bottleneck.folded(in_graph=
    True)) instead of reading its cache: torch.export then records the
    fold as operations on the parameters, and the exported program needs
    no cache to run. The exporter's explicit choice
    (tools/deployment/export_model.py)."""
    blocks = [m for m in model.modules() if isinstance(m, Bottleneck)]
    for b in blocks:
        b.fold_in_graph = True
    try:
        yield model
    finally:
        for b in blocks:
            b.fold_in_graph = False


class ResNet(nn.Module):
    """Bottleneck ResNet returning (C2, C3, C4, C5), NCHW."""

    def __init__(self, block_counts: Sequence[int] = (3, 4, 6, 3), stem_width: int = 64,
                 fused_blocks: bool = False,
                 stage_fused: Sequence[bool] = (True, True, False, False),
                 conv1x1_matmul: bool = False, mc_dropout: float = 0.0,
                 attention: Optional[str] = None,
                 stage_with_attention: Sequence[bool] = (False, False, True, True)):
        super().__init__()
        self.mc_dropout = mc_dropout
        self.conv1 = _conv(3, stem_width, 7, 2, 3)
        self.bn1 = FrozenBatchNorm2d(stem_width)
        self.maxpool = nn.MaxPool2d(3, stride=2, padding=1)
        inplanes = stem_width
        self.stages = []
        for stage, n_blocks in enumerate(block_counts):
            planes = stem_width * (2 ** stage)
            blocks = []
            for b in range(n_blocks):
                stride = 2 if (stage > 0 and b == 0) else 1
                blocks.append(Bottleneck(inplanes, planes, stride, downsample=(b == 0),
                                         fused=fused_blocks and stage_fused[stage],
                                         conv1x1_matmul=conv1x1_matmul,
                                         mc_dropout=mc_dropout,
                                         attention=(attention if stage_with_attention[stage]
                                                    else None)))
                inplanes = planes * 4
            name = f"layer{stage + 1}"
            self.add_module(name, nn.Sequential(*blocks))
            self.stages.append(name)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> Tuple[torch.Tensor, ...]:
        x = channel_dropout(torch.relu(self.bn1(self.conv1(x))), self.mc_dropout, generator)
        x = self.maxpool(x)
        outs = []
        for name in self.stages:
            for block in getattr(self, name):
                x = block(x, generator)
            outs.append(x)
        return tuple(outs)


def check_backbone_options(cfg) -> None:
    """Raise on the JAX package's backbone options the port lacks."""
    for flag in ("stem_s2d", "backbone_int8", "remat"):
        if getattr(cfg, flag):
            raise NotImplementedError(f"{flag}: " + _NOT_PORTED.format(16))
