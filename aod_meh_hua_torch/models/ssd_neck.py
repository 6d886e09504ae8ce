"""SSD neck: L2Norm on conv4_3 + the extra downsampling levels (torch).

Port of aod_meh_hua_tpu/models/ssd_neck.py:20-63, which mirrors the
reference's mmdet/models/necks/ssd_neck.py:10 with the live config
(Config_SSD.py:33-39): in (512, 1024), out (512, 1024, 512, 256, 256,
256), level_strides (2, 2, 1, 1), level_paddings (1, 1, 0, 0),
l2_norm_scale 20. Each extra level is a 1x1 conv (out // 2) + ReLU and a
3x3 conv (the level's stride and padding) + ReLU. Module names are
mmdet's: `l2_norm.weight`, `extra_layers.{i}.{0,1}.conv`.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
from torch import nn

from .vgg import scaled


class L2Norm(nn.Module):
    """x / (||x||_2 over channels + eps) * weight; the norm in f32, eps
    after the sqrt (JAX ssd_neck.py:29-31); weight initialised to scale."""

    def __init__(self, channels: int, scale: float = 20.0, eps: float = 1e-10):
        super().__init__()
        self.weight = nn.Parameter(torch.full((channels,), float(scale)))
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        norm = xf.pow(2).sum(dim=1, keepdim=True).sqrt() + self.eps
        return (self.weight[None, :, None, None] * (xf / norm)).to(x.dtype)


class ConvReLU(nn.Module):
    """mmcv's ConvModule without norm: `conv` then ReLU."""

    def __init__(self, cin: int, cout: int, kernel: int, stride: int = 1, padding: int = 0):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, kernel, stride=stride, padding=padding)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.relu(self.conv(x))


class SSDNeck(nn.Module):
    def __init__(self, in_channels: Sequence[int],
                 out_channels: Sequence[int] = (512, 1024, 512, 256, 256, 256),
                 level_strides: Sequence[int] = (2, 2, 1, 1),
                 level_paddings: Sequence[int] = (1, 1, 0, 0),
                 l2_norm_scale: float = 20.0, width_mult: float = 1.0):
        super().__init__()
        self.l2_norm = L2Norm(in_channels[0], l2_norm_scale) if l2_norm_scale else None
        layers, cin = [], in_channels[-1]
        for ch, stride, pad in zip(out_channels[len(in_channels):], level_strides,
                                   level_paddings):
            ch = scaled(ch, width_mult)
            mid = max(ch // 2, 1)
            layers.append(nn.Sequential(ConvReLU(cin, mid, 1),
                                        ConvReLU(mid, ch, 3, stride, pad)))
            cin = ch
        self.extra_layers = nn.ModuleList(layers)
        self.out_channels = tuple(in_channels) + tuple(
            layer[1].conv.out_channels for layer in layers)

    def forward(self, inputs: Sequence[torch.Tensor]) -> Tuple[torch.Tensor, ...]:
        outs = list(inputs)
        if self.l2_norm is not None:
            outs[0] = self.l2_norm(outs[0])
        feat = outs[-1]
        for layer in self.extra_layers:
            feat = layer(feat)
            outs.append(feat)
        return tuple(outs)
