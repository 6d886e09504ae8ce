"""The Faster R-CNN family's other backbones: ResNeXt, Res2Net, RegNet,
and `build_backbone`, which builds every backbone of the port's two-stage
models from cfg.backbone_type (torch).

Port of aod_meh_hua_tpu/models/backbones.py (`ResNeXtBottleneck` :43-73,
`Bottle2neck` :76-130, `ResNeXt` :133-157, `Res2Net` :160-184,
`REGNET_ARCHS` :187-197, `regnet_stages` :200-216, `RegNetBlock` :219-241,
`RegNet` :244-268, `build_backbone` :271-301), which mirrors the
reference's mmdet/models/backbones/resnext.py (grouped 3x3 conv2 of
width floor(planes * base_width / 64) * groups), res2net.py (the
hierarchical 3x3 convs over channel splits, the avg-pooled last split of
a stage's first block, the avg-down shortcut) and regnet.py (the
quantised log-linear widths, expansion-1 bottlenecks with a grouped 3x3,
a 32-wide 3x3/2 stem with no max pool). BN is frozen, as in
models/resnet.py. `regnet_stages` is a numpy copy of the JAX function
(the port imports nothing of the JAX package);
tests/test_torch_backbones.py holds it equal for every arch.

The modules take and give NCHW maps and return (C2, C3, C4, C5); their
module names are the JAX package's (layer{s}_{b} as layer{s}.{b},
downsample_conv and downsample_bn as downsample.0 and .1), so
models/convert.py carries a JAX tree over.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .resnet import FrozenBatchNorm2d, ResNet


def _conv(cin: int, cout: int, k: int, stride: int = 1, pad: int = 0,
          groups: int = 1) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, k, stride=stride, padding=pad, bias=False, groups=groups)


def _downsample(cin: int, cout: int, stride: int = 1) -> nn.Sequential:
    return nn.Sequential(_conv(cin, cout, 1, stride), FrozenBatchNorm2d(cout))


class ResNeXtBottleneck(nn.Module):
    """1x1 -> grouped 3x3 (stride) -> 1x1 (4 * planes) + residual."""

    def __init__(self, inplanes: int, planes: int, stride: int = 1, downsample: bool = False,
                 groups: int = 32, base_width: int = 4):
        super().__init__()
        # max(1, .) guards the shrunken test configs (planes < 64), as the JAX block
        width = (planes if groups == 1 else
                 max(1, math.floor(planes * (base_width / 64))) * groups)
        self.conv1 = _conv(inplanes, width, 1)
        self.bn1 = FrozenBatchNorm2d(width)
        self.conv2 = _conv(width, width, 3, stride, 1, groups=groups)
        self.bn2 = FrozenBatchNorm2d(width)
        self.conv3 = _conv(width, planes * 4, 1)
        self.bn3 = FrozenBatchNorm2d(planes * 4)
        self.downsample = _downsample(inplanes, planes * 4, stride) if downsample else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.relu(self.bn1(self.conv1(x)))
        y = torch.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        identity = x if self.downsample is None else self.downsample(x)
        return torch.relu(y + identity)


class Bottle2neck(nn.Module):
    """Res2Net's block: 1x1 to width * scales, then scales - 1 3x3 convs
    over the channel splits (a running sum of the outputs in a 'normal'
    block, fresh splits in a stage's first block, whose last split is
    avg-pooled by the stride), concat, 1x1; the avg-down shortcut."""

    def __init__(self, inplanes: int, planes: int, stride: int = 1, downsample: bool = False,
                 stage_block: bool = False, scales: int = 4, base_width: int = 26):
        super().__init__()
        self.stride, self.stage_block, self.scales = stride, stage_block, scales
        self.width = width = max(1, int(math.floor(planes * (base_width / 64))))
        self.conv1 = _conv(inplanes, width * scales, 1)
        self.bn1 = FrozenBatchNorm2d(width * scales)
        # only the stage block strides (res2net.py:120-135)
        s2 = stride if stage_block else 1
        for i in range(scales - 1):
            self.add_module(f"conv2_{i}", _conv(width, width, 3, s2, 1))
            self.add_module(f"bn2_{i}", FrozenBatchNorm2d(width))
        self.conv3 = _conv(width * scales, planes * 4, 1)
        self.bn3 = FrozenBatchNorm2d(planes * 4)
        self.downsample = _downsample(inplanes, planes * 4) if downsample else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.relu(self.bn1(self.conv1(x)))
        spx = torch.split(y, self.width, dim=1)
        outs, sp = [], None
        for i in range(self.scales - 1):
            sp = spx[i] if (self.stage_block or i == 0) else sp + spx[i]
            sp = torch.relu(getattr(self, f"bn2_{i}")(getattr(self, f"conv2_{i}")(sp)))
            outs.append(sp)
        last = spx[-1]
        if self.stage_block and self.stride != 1:
            # contiguous first: on the card, avg_pool2d's backward of a channel
            # slice of a channels_last map gave another gradient than the CPU's
            # (0.83 apart at a gradient of order 1, the forward equal; torch
            # 2.11, H100), which the slice's own copy does not
            last = F.avg_pool2d(last.contiguous(), 3, self.stride, 1, count_include_pad=False)
        outs.append(last)
        y = self.bn3(self.conv3(torch.cat(outs, dim=1)))
        identity = x
        if self.downsample is not None:
            # AvgPool with ceil (flax's SAME window = stride, pads excluded) + 1x1 + BN
            if self.stride != 1:
                identity = F.avg_pool2d(identity, self.stride, self.stride, ceil_mode=True,
                                        count_include_pad=False)
            identity = self.downsample(identity)
        return torch.relu(y + identity)


class _Stem(nn.Module):
    """The ResNet stem: 7x7/2 conv, frozen BN, ReLU, 3x3/2 max pool."""

    def _stem(self, stem_width: int) -> None:
        self.conv1 = _conv(3, stem_width, 7, 2, 3)
        self.bn1 = FrozenBatchNorm2d(stem_width)
        self.maxpool = nn.MaxPool2d(3, stride=2, padding=1)

    def _stages(self, blocks_of_stage) -> None:
        self.stages = []
        for stage, blocks in enumerate(blocks_of_stage):
            name = f"layer{stage + 1}"
            self.add_module(name, nn.Sequential(*blocks))
            self.stages.append(name)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        x = self.maxpool(torch.relu(self.bn1(self.conv1(x))))
        outs = []
        for name in self.stages:
            x = getattr(self, name)(x)
            outs.append(x)
        return tuple(outs)


class ResNeXt(_Stem):
    """Grouped-conv ResNet; returns (C2..C5). The ResNet stem."""

    def __init__(self, block_counts: Sequence[int] = (3, 4, 23, 3), stem_width: int = 64,
                 groups: int = 32, base_width: int = 4):
        super().__init__()
        self._stem(stem_width)
        inplanes, stages = stem_width, []
        for stage, n in enumerate(block_counts):
            planes, blocks = stem_width * 2 ** stage, []
            for b in range(n):
                blocks.append(ResNeXtBottleneck(inplanes, planes, 2 if (stage > 0 and b == 0)
                                                else 1, b == 0, groups, base_width))
                inplanes = planes * 4
            stages.append(blocks)
        self._stages(stages)


class Res2Net(_Stem):
    """Res2Net-50/101 (26w x 4s by default); returns (C2..C5)."""

    def __init__(self, block_counts: Sequence[int] = (3, 4, 6, 3), stem_width: int = 64,
                 scales: int = 4, base_width: int = 26):
        super().__init__()
        self._stem(stem_width)
        inplanes, stages = stem_width, []
        for stage, n in enumerate(block_counts):
            planes, blocks = stem_width * 2 ** stage, []
            for b in range(n):
                blocks.append(Bottle2neck(inplanes, planes, 2 if (stage > 0 and b == 0) else 1,
                                          downsample=b == 0, stage_block=b == 0, scales=scales,
                                          base_width=base_width))
                inplanes = planes * 4
            stages.append(blocks)
        self._stages(stages)


REGNET_ARCHS = {
    # regnet.py:70-87 arch_settings (bot_mul = 1.0 throughout)
    "regnetx_400mf": dict(w0=24, wa=24.48, wm=2.54, group_w=16, depth=22),
    "regnetx_800mf": dict(w0=56, wa=35.73, wm=2.28, group_w=16, depth=16),
    "regnetx_1.6gf": dict(w0=80, wa=34.01, wm=2.25, group_w=24, depth=18),
    "regnetx_3.2gf": dict(w0=88, wa=26.31, wm=2.25, group_w=48, depth=25),
    "regnetx_4.0gf": dict(w0=96, wa=38.65, wm=2.43, group_w=40, depth=23),
    "regnetx_6.4gf": dict(w0=184, wa=60.83, wm=2.07, group_w=56, depth=17),
    "regnetx_8.0gf": dict(w0=80, wa=49.56, wm=2.88, group_w=120, depth=23),
    "regnetx_12gf": dict(w0=168, wa=73.36, wm=2.37, group_w=112, depth=19),
}


def regnet_stages(arch: dict, divisor: int = 8):
    """(stage_widths, stage_blocks, stage_groups) from the quantized
    log-linear width schedule (regnet.py:251-341)."""
    w0, wa, wm, depth = arch["w0"], arch["wa"], arch["wm"], arch["depth"]
    widths_cont = np.arange(depth) * wa + w0
    ks = np.round(np.log(widths_cont / w0) / np.log(wm))
    widths = w0 * np.power(wm, ks)
    widths = (np.round(widths / divisor) * divisor).astype(int).tolist()
    diff = [w != p for w, p in zip(widths + [0], [0] + widths)]
    stage_widths = [w for w, d in zip(widths, diff[:-1]) if d]
    stage_blocks = np.diff([i for i, d in enumerate(diff) if d]).tolist()
    gw = arch["group_w"]
    groups = [min(gw, w) for w in stage_widths]
    stage_widths = [int(round(w / g) * g) for w, g in zip(stage_widths, groups)]
    return stage_widths, stage_blocks, groups


class RegNetBlock(nn.Module):
    """Expansion-1 bottleneck: 1x1 -> grouped 3x3 (width // group_width
    groups, stride) -> 1x1, all `width` wide."""

    def __init__(self, inplanes: int, width: int, group_width: int, stride: int = 1,
                 downsample: bool = False):
        super().__init__()
        self.conv1 = _conv(inplanes, width, 1)
        self.bn1 = FrozenBatchNorm2d(width)
        self.conv2 = _conv(width, width, 3, stride, 1, groups=width // group_width)
        self.bn2 = FrozenBatchNorm2d(width)
        self.conv3 = _conv(width, width, 1)
        self.bn3 = FrozenBatchNorm2d(width)
        self.downsample = _downsample(inplanes, width, stride) if downsample else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.relu(self.bn1(self.conv1(x)))
        y = torch.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        identity = x if self.downsample is None else self.downsample(x)
        return torch.relu(y + identity)


class RegNet(_Stem):
    """RegNetX: a 32-wide 3x3/2 stem, NO max pool, every stage strides 2:
    output strides 4-32 as ResNet's. Returns the 4 stage outputs."""

    def __init__(self, arch: str = "regnetx_3.2gf", stem_width: int = 32):
        super().__init__()
        widths, blocks, groups = regnet_stages(REGNET_ARCHS[arch])
        self.conv1 = _conv(3, stem_width, 3, 2, 1)
        self.bn1 = FrozenBatchNorm2d(stem_width)
        self.maxpool = nn.Identity()
        inplanes, stages = stem_width, []
        for w, n, g in zip(widths, blocks, groups):
            stage = []
            for b in range(n):
                stage.append(RegNetBlock(inplanes, w, g, 2 if b == 0 else 1, b == 0))
                inplanes = w
            stages.append(stage)
        self._stages(stages)


# backbone_type -> the port's backbone (JAX build_backbone)
BACKBONES = ("resnet", "resnext", "res2net", "regnet", "hrnet", "resnest")


def build_backbone(cfg) -> nn.Module:
    """The two-stage models' backbone from cfg.backbone_type: the ResNet
    (with the empirical-attention plugin, cfg.backbone_attention),
    ResNeXt, Res2Net, RegNet, HRNet or ResNeSt, each with its knobs from
    cfg (JAX build_backbone, whose getattr defaults are the reference's)."""
    kind = cfg.backbone_type
    if kind == "resnet":
        return ResNet(cfg.block_counts, cfg.stem_width,
                      attention=getattr(cfg, "backbone_attention", None))
    if kind == "resnext":
        return ResNeXt(cfg.block_counts, cfg.stem_width, cfg.resnext_groups,
                       cfg.resnext_base_width)
    if kind == "res2net":
        return Res2Net(cfg.block_counts, cfg.stem_width, cfg.res2net_scales,
                       cfg.res2net_base_width)
    if kind == "regnet":
        return RegNet(cfg.regnet_arch, getattr(cfg, "regnet_stem_width", 32))
    if kind == "hrnet":
        from .hrnet import HRNet

        return HRNet(width=getattr(cfg, "hrnet_width", 32),
                     stage_modules=getattr(cfg, "hrnet_stage_modules", (1, 4, 3)),
                     num_blocks=getattr(cfg, "hrnet_num_blocks", 4),
                     stage1_blocks=getattr(cfg, "hrnet_stage1_blocks", 4),
                     stem_width=getattr(cfg, "hrnet_stem_width", 64))
    if kind == "resnest":
        from .resnest import ResNeSt

        return ResNeSt(cfg.block_counts, cfg.stem_width, radix=getattr(cfg, "resnest_radix", 2))
    raise ValueError(f"unknown backbone_type {kind!r}")
