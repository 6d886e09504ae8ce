"""MEH Retina head: cls / reg / lambda branches (torch).

Port of aod_meh_hua_tpu/models/retina_head.py:27-105, which mirrors the
reference's mmdet/models/dense_heads/Lambda_L2.py:38-54 (4 stacked 3x3
convs per branch; retina_cls / retina_reg / retina_L; the lambda head has
one channel per anchor) and :96-103 (the ReLU on the lambda branch).
Init: Normal(std 0.01) weights, zero biases, and the AL driver's uniform
(±sqrt(1/(A*k)), k = A*C) re-init of the retina_cls bias.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch
from torch import nn


class ConvBranch(nn.ModuleList):
    """stacked x (3x3 conv + ReLU), no norm (reference norm_cfg=None)."""

    def __init__(self, in_channels: int, channels: int, stacked: int):
        super().__init__(
            nn.Conv2d(in_channels if i == 0 else channels, channels, 3, padding=1)
            for i in range(stacked))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for conv in self:
            x = torch.relu(conv(x))
        return x


class RetinaMEHHead(nn.Module):
    def __init__(self, num_classes: int, in_channels: int, num_anchors: int = 9,
                 feat_channels: int = 256, stacked_convs: int = 4):
        super().__init__()
        self.num_classes = num_classes
        self.num_anchors = num_anchors
        c, s = feat_channels, stacked_convs
        self.cls_convs = ConvBranch(in_channels, c, s)
        self.reg_convs = ConvBranch(in_channels, c, s)
        self.L_convs = ConvBranch(in_channels, c, s)
        last = c if s else in_channels
        self.retina_cls = nn.Conv2d(last, num_anchors * num_classes, 3, padding=1)
        self.retina_reg = nn.Conv2d(last, num_anchors * 4, 3, padding=1)
        self.retina_L = nn.Conv2d(last, num_anchors, 3, padding=1)

    @torch.no_grad()
    def init_weights(self, gen: torch.Generator) -> None:
        """Normal(0.01) weights and zero biases; the uniform cls bias."""
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                m.weight.copy_(torch.randn(m.weight.shape, generator=gen) * 0.01)
                m.bias.zero_()
        bound = math.sqrt(1.0 / (self.num_anchors * self.num_anchors * self.num_classes))
        b = self.retina_cls.bias
        b.copy_((torch.rand(b.shape, generator=gen) * 2 - 1) * bound)

    def forward(self, feats: Sequence[torch.Tensor]) -> Tuple[tuple, tuple]:
        """feats -> per-level (cls_score [B, A*C, H, W], bbox_pred [B, A*4, H, W])."""
        cls_scores = tuple(self.retina_cls(self.cls_convs(f)) for f in feats)
        bbox_preds = tuple(self.retina_reg(self.reg_convs(f)) for f in feats)
        return cls_scores, bbox_preds

    def forward_L(self, feats: Sequence[torch.Tensor]) -> tuple:
        """MEH branch: per-level lambda [B, A, H, W], ReLU-activated."""
        return tuple(torch.relu(self.retina_L(self.L_convs(f))) for f in feats)
