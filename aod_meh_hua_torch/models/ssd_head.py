"""MEH SSD head: per-level cls / reg / lambda convs (torch).

Port of aod_meh_hua_tpu/models/ssd_head.py:18-44, which mirrors the
reference's mmdet/models/dense_heads/My_L_ssd_head.py:102-137: per
pyramid level one 3x3 conv per branch (stacked_convs=0): cls with
A*(C+1) channels (explicit background), reg with A*4, L with A and a
ReLU (:176-180); Xavier-uniform weights, zero biases (:71). The number of
anchors A varies by level. Module names are mmdet's:
`{cls,reg,L}_convs.{level}.0`.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
from torch import nn


def _branch(in_channels: Sequence[int], outs: Sequence[int]) -> nn.ModuleList:
    return nn.ModuleList(nn.Sequential(nn.Conv2d(c, o, 3, padding=1))
                         for c, o in zip(in_channels, outs))


class SSDMEHHead(nn.Module):
    def __init__(self, num_classes: int, in_channels: Sequence[int],
                 num_anchors: Sequence[int]):
        super().__init__()
        self.num_classes = num_classes
        self.cls_out = num_classes + 1
        self.cls_convs = _branch(in_channels, [a * self.cls_out for a in num_anchors])
        self.reg_convs = _branch(in_channels, [a * 4 for a in num_anchors])
        self.L_convs = _branch(in_channels, list(num_anchors))

    @torch.no_grad()
    def init_weights(self, gen: torch.Generator) -> None:
        """Xavier-uniform weights, zero biases."""
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                fan_in = m.weight[0].numel()
                fan_out = m.weight.shape[0] * m.weight[0, 0].numel()
                bound = (6.0 / (fan_in + fan_out)) ** 0.5
                m.weight.copy_((torch.rand(m.weight.shape, generator=gen) * 2 - 1) * bound)
                m.bias.zero_()

    def forward(self, feats: Sequence[torch.Tensor]) -> Tuple[tuple, tuple]:
        cls_scores = tuple(c(f) for c, f in zip(self.cls_convs, feats))
        bbox_preds = tuple(r(f) for r, f in zip(self.reg_convs, feats))
        return cls_scores, bbox_preds

    def forward_L(self, feats: Sequence[torch.Tensor]) -> tuple:
        return tuple(torch.relu(conv(f)) for conv, f in zip(self.L_convs, feats))
