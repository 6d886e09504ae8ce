"""Feature Pyramid Network, RetinaNet's form (torch).

Port of aod_meh_hua_tpu/models/fpn.py:34-76 for the live config
(reference Config_RetinaNet.py:34-40): start_level=1, out 256 channels,
add_extra_convs='on_input' (P6 from C5, P7 from P6), num_outs=5, no ReLU
before the extra convs. The top-down pass upsamples with nearest
neighbour, torch's floor rule, which the JAX package reproduces.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn


class FPN(nn.Module):
    def __init__(self, in_channels: Sequence[int], out_channels: int = 256,
                 start_level: int = 1, num_outs: int = 5):
        super().__init__()
        self.start_level = start_level
        used = list(in_channels[start_level:])
        self.lateral_convs = nn.ModuleList(nn.Conv2d(c, out_channels, 1) for c in used)
        self.fpn_convs = nn.ModuleList(
            nn.Conv2d(out_channels, out_channels, 3, padding=1) for _ in used)
        n_extra = num_outs - len(used)
        self.extra_convs = nn.ModuleList(
            nn.Conv2d(in_channels[-1] if i == 0 else out_channels, out_channels, 3,
                      stride=2, padding=1)
            for i in range(n_extra))

    def forward(self, inputs: Sequence[torch.Tensor]) -> Tuple[torch.Tensor, ...]:
        used = inputs[self.start_level:]
        laterals = [conv(x) for conv, x in zip(self.lateral_convs, used)]
        for i in range(len(laterals) - 1, 0, -1):
            laterals[i - 1] = laterals[i - 1] + F.interpolate(
                laterals[i], size=laterals[i - 1].shape[2:], mode="nearest")
        outs = [conv(x) for conv, x in zip(self.fpn_convs, laterals)]
        for i, conv in enumerate(self.extra_convs):
            outs.append(conv(inputs[-1] if i == 0 else outs[-1]))
        return tuple(outs)
