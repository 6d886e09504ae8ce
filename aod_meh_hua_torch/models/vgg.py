"""SSD-VGG16 backbone (torch), in mmcv's layout.

Port of aod_meh_hua_tpu/models/vgg.py:35-64, which mirrors the
reference's mmdet/models/backbones/ssd_vgg.py:12: VGG-16 features with
ceil-mode 2x2 pooling after blocks 1-4 (with_last_pool=False), then the
SSD extras MaxPool(3, s1, p1) -> conv6 3x3 dilation 6 (1024) -> ReLU ->
conv7 1x1 (1024) -> ReLU. It returns conv4_3's ReLU (512 channels, 38x38
at input 300) and conv7's ReLU (1024, 19x19).

The layers sit in one nn.Sequential `features` at mmcv's indices
(convs at vgg.py:67 `_MMCV_VGG16_CONV_IDX` of the JAX package), so an
mmcv vgg16_caffe or mmdet SSD state_dict loads with no renaming.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

# VGG-16 conv plan: (num_convs, base_channels) per block
VGG16_BLOCKS = ((2, 64), (2, 128), (3, 256), (3, 512), (3, 512))
# mmcv VGG-16 `features` indices of the conv layers, conv1_1 .. conv7
MMCV_VGG16_CONV_IDX = (0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28, 31, 33)
CONV4_3_RELU, CONV7_RELU = 22, 34


def scaled(ch: int, width_mult: float) -> int:
    return max(int(ch * width_mult), 1)


class CeilMaxPool(nn.Module):
    """2x2/2 max pool, ceil_mode=True (75 -> 38)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.max_pool2d(x, 2, 2, ceil_mode=True)


class SSDVGG(nn.Module):
    """NCHW images -> (conv4_3 relu, conv7 relu)."""

    def __init__(self, width_mult: float = 1.0):
        super().__init__()
        layers, cin = [], 3
        for bi, (n_convs, ch) in enumerate(VGG16_BLOCKS):
            ch = scaled(ch, width_mult)
            for _ in range(n_convs):
                layers += [nn.Conv2d(cin, ch, 3, padding=1), nn.ReLU()]
                cin = ch
            if bi < 4:  # with_last_pool=False: no pool after block 5
                layers.append(CeilMaxPool())
        fc = scaled(1024, width_mult)
        layers += [nn.MaxPool2d(3, 1, 1),
                   nn.Conv2d(cin, fc, 3, padding=6, dilation=6), nn.ReLU(),
                   nn.Conv2d(fc, fc, 1), nn.ReLU()]
        self.features = nn.Sequential(*layers)
        self.out_channels = (scaled(512, width_mult), fc)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        outs = []
        for i, layer in enumerate(self.features):
            x = layer(x)
            if i in (CONV4_3_RELU, CONV7_RELU):
                outs.append(x)
        return outs[0], outs[1]
