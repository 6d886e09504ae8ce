"""Feature Pyramid Network (torch).

Port of aod_meh_hua_tpu/models/fpn.py:34-77, which mirrors the
reference's mmdet/models/necks/fpn.py:10 with its three `add_extra_convs`
modes: 'on_input' (RetinaNet, Config_RetinaNet.py:34-40: start_level=1,
P6 by a stride-2 conv from C5, P7 from P6), 'on_output' (P6 from P5)
and 'maxpool' (Faster R-CNN's add_extra_convs=False: P6 by stride-2
subsampling of the last output, F.max_pool2d(x, 1, stride=2)), with
relu_before_extra_convs. The top-down pass upsamples with nearest
neighbour, torch's floor rule, which the JAX package reproduces.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

EXTRA_MODES = ("on_input", "on_output", "maxpool")


class FPN(nn.Module):
    def __init__(self, in_channels: Sequence[int], out_channels: int = 256,
                 start_level: int = 1, num_outs: int = 5, add_extra_convs: str = "on_input",
                 relu_before_extra_convs: bool = False):
        super().__init__()
        if add_extra_convs not in EXTRA_MODES:
            raise ValueError(f"add_extra_convs={add_extra_convs!r}: one of {EXTRA_MODES}")
        self.start_level = start_level
        self.add_extra_convs = add_extra_convs
        self.relu_before_extra_convs = relu_before_extra_convs
        used = list(in_channels[start_level:])
        self.n_extra = num_outs - len(used)
        self.lateral_convs = nn.ModuleList(nn.Conv2d(c, out_channels, 1) for c in used)
        self.fpn_convs = nn.ModuleList(
            nn.Conv2d(out_channels, out_channels, 3, padding=1) for _ in used)
        first_in = in_channels[-1] if add_extra_convs == "on_input" else out_channels
        self.extra_convs = nn.ModuleList(
            nn.Conv2d(first_in if i == 0 else out_channels, out_channels, 3,
                      stride=2, padding=1)
            for i in range(self.n_extra if add_extra_convs != "maxpool" else 0))

    def forward(self, inputs: Sequence[torch.Tensor]) -> Tuple[torch.Tensor, ...]:
        used = inputs[self.start_level:]
        laterals = [conv(x) for conv, x in zip(self.lateral_convs, used)]
        for i in range(len(laterals) - 1, 0, -1):
            laterals[i - 1] = laterals[i - 1] + F.interpolate(
                laterals[i], size=laterals[i - 1].shape[2:], mode="nearest")
        outs = [conv(x) for conv, x in zip(self.fpn_convs, laterals)]
        if self.add_extra_convs == "maxpool":
            for _ in range(self.n_extra):
                outs.append(outs[-1][:, :, ::2, ::2])
            return tuple(outs)
        for i, conv in enumerate(self.extra_convs):
            if i == 0:
                src = inputs[-1] if self.add_extra_convs == "on_input" else outs[-1]
            else:
                src = torch.relu(outs[-1]) if self.relu_before_extra_convs else outs[-1]
            outs.append(conv(src))
        return tuple(outs)
