"""ResNeSt backbone (torch): split-attention bottlenecks on a ResNetV1d
trunk.

Port of aod_meh_hua_tpu/models/resnest.py (`SplitAttentionConv` :34-69,
`ResNeStBottleneck` :72-106, `ResNeSt` :109-139), which mirrors the
reference's mmdet/models/backbones/resnest.py (SplitAttentionConv2d:
one grouped conv over the radix splits, BN, ReLU, the radix-summed global
average pool, fc1 / BN / ReLU, fc2, a softmax over the radix axis, or a
sigmoid at radix 1; the 3x3 avg-pool `avd_layer` that carries a block's
stride) on ResNetV1d (the deep stem of three 3x3 convs, the avg-pool
shortcut), at the configs/resnest/ settings (radix 2, groups 1,
reduction_factor 4). BN is frozen.

The split conv's channels are radix-major, as the JAX module's
reshape(b, h, w, r, c) lays them out: in NCHW, view(b, r, c, h, w). Module
names are the JAX package's (stem_conv{i}, stem_bn{i}; a block's conv2 is
the split conv with conv, bn0, fc1, bn1 and fc2).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .resnet import FrozenBatchNorm2d


class SplitAttentionConv(nn.Module):
    """SplitAttentionConv2d: `radix` splits of one grouped conv, fused by
    a learned per-channel softmax over the radix axis."""

    def __init__(self, cin: int, channels: int, stride: int = 1, radix: int = 2,
                 groups: int = 1, reduction_factor: int = 4):
        super().__init__()
        self.radix, self.channels = radix, channels
        inter = max(channels * radix // reduction_factor, 32)
        self.conv = nn.Conv2d(cin, channels * radix, 3, stride=stride, padding=1, bias=False,
                              groups=groups * radix)
        self.bn0 = FrozenBatchNorm2d(channels * radix)
        self.fc1 = nn.Linear(channels, inter)
        self.bn1 = FrozenBatchNorm2d(inter)
        self.fc2 = nn.Linear(inter, channels * radix)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        r, c = self.radix, self.channels
        y = torch.relu(self.bn0(self.conv(x)))
        b, _, h, w = y.shape
        splits = y.reshape(b, r, c, h, w)
        gap = splits.sum(dim=1).mean(dim=(2, 3))  # [B, C]
        gap = torch.relu(self.bn1(self.fc1(gap)[:, :, None, None])[:, :, 0, 0])
        att = self.fc2(gap)
        if r > 1:  # rsoftmax: a softmax over the radix per channel
            att = torch.softmax(att.reshape(b, r, c), dim=1)
        else:
            att = torch.sigmoid(att).reshape(b, 1, c)
        return (splits * att[:, :, :, None, None]).sum(dim=1)


class ResNeStBottleneck(nn.Module):
    """1x1 -> split-attention 3x3 (stride 1) -> the avd 3x3 avg pool of
    the stride -> 1x1 (4 * planes) + the avg-down shortcut."""

    def __init__(self, inplanes: int, planes: int, stride: int = 1, downsample: bool = False,
                 radix: int = 2, groups: int = 1, reduction_factor: int = 4):
        super().__init__()
        self.stride = stride
        self.conv1 = nn.Conv2d(inplanes, planes, 1, bias=False)
        self.bn1 = FrozenBatchNorm2d(planes)
        self.conv2 = SplitAttentionConv(planes, planes, 1, radix, groups, reduction_factor)
        self.conv3 = nn.Conv2d(planes, planes * 4, 1, bias=False)
        self.bn3 = FrozenBatchNorm2d(planes * 4)
        self.downsample = None
        if downsample:
            self.downsample = nn.Sequential(nn.Conv2d(inplanes, planes * 4, 1, bias=False),
                                            FrozenBatchNorm2d(planes * 4))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.conv2(torch.relu(self.bn1(self.conv1(x))))
        if self.stride > 1:  # avd_layer: flax's avg_pool counts the padding
            y = F.avg_pool2d(y, 3, self.stride, 1, count_include_pad=True)
        y = self.bn3(self.conv3(y))
        identity = x
        if self.downsample is not None:
            if self.stride > 1:  # ResNetV1d's avg-down shortcut, VALID (floor)
                identity = F.avg_pool2d(identity, self.stride, self.stride)
            identity = self.downsample(identity)
        return torch.relu(y + identity)


class ResNeSt(nn.Module):
    """ResNeSt-50 style backbone returning (C2, C3, C4, C5): the deep V1d
    stem (half, half, full width), avg-down shortcuts, split-attention
    conv2."""

    def __init__(self, block_counts: Sequence[int] = (3, 4, 6, 3), stem_width: int = 64,
                 radix: int = 2, groups: int = 1, reduction_factor: int = 4):
        super().__init__()
        half = max(stem_width // 2, 4)
        cin = 3
        for i, (f, s) in enumerate(((half, 2), (half, 1), (stem_width, 1))):
            self.add_module(f"stem_conv{i}", nn.Conv2d(cin, f, 3, s, 1, bias=False))
            self.add_module(f"stem_bn{i}", FrozenBatchNorm2d(f))
            cin = f
        self.maxpool = nn.MaxPool2d(3, stride=2, padding=1)
        inplanes, self.stages = stem_width, []
        for stage, n in enumerate(block_counts):
            planes, blocks = stem_width * 2 ** stage, []
            for b in range(n):
                blocks.append(ResNeStBottleneck(inplanes, planes, 2 if (stage > 0 and b == 0)
                                                else 1, b == 0, radix, groups, reduction_factor))
                inplanes = planes * 4
            name = f"layer{stage + 1}"
            self.add_module(name, nn.Sequential(*blocks))
            self.stages.append(name)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        for i in range(3):
            x = torch.relu(getattr(self, f"stem_bn{i}")(getattr(self, f"stem_conv{i}")(x)))
        x = self.maxpool(x)
        outs = []
        for name in self.stages:
            x = getattr(self, name)(x)
            outs.append(x)
        return tuple(outs)
