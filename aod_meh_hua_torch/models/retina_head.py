"""MEH Retina head: cls / reg / lambda branches (torch).

Port of aod_meh_hua_tpu/models/retina_head.py:27-105, which mirrors the
reference's mmdet/models/dense_heads/Lambda_L2.py:38-54 (4 stacked 3x3
convs per branch; retina_cls / retina_reg / retina_L; the lambda head has
one channel per anchor) and :96-103 (the ReLU on the lambda branch).
Init: Normal(std 0.01) weights, zero biases, and the AL driver's uniform
(±sqrt(1/(A*k)), k = A*C) re-init of the retina_cls bias. Without the MEH
branch (use_meh=False, the Lambda_L2Net_NoL ablation) the head has no
L_convs and no retina_L, as the JAX model's tree has none. With
`mc_dropout` > 0, channel dropout follows every ReLU of the three
branches (aod_meh_hua_tpu/models/retina_head.py:40-59).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from .resnet import channel_dropout


class ConvBranch(nn.ModuleList):
    """stacked x (3x3 conv + ReLU), no norm (reference norm_cfg=None)."""

    def __init__(self, in_channels: int, channels: int, stacked: int,
                 mc_dropout: float = 0.0):
        super().__init__(
            nn.Conv2d(in_channels if i == 0 else channels, channels, 3, padding=1)
            for i in range(stacked))
        self.mc_dropout = mc_dropout

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        for conv in self:
            x = channel_dropout(torch.relu(conv(x)), self.mc_dropout, generator)
        return x


class RetinaMEHHead(nn.Module):
    def __init__(self, num_classes: int, in_channels: int, num_anchors: int = 9,
                 feat_channels: int = 256, stacked_convs: int = 4, with_lambda: bool = True,
                 mc_dropout: float = 0.0):
        super().__init__()
        self.num_classes = num_classes
        self.num_anchors = num_anchors
        c, s, d = feat_channels, stacked_convs, mc_dropout
        # registered in this order: init_weights draws in module order
        self.cls_convs = ConvBranch(in_channels, c, s, d)
        self.reg_convs = ConvBranch(in_channels, c, s, d)
        if with_lambda:
            self.L_convs = ConvBranch(in_channels, c, s, d)
        last = c if s else in_channels
        self.retina_cls = nn.Conv2d(last, num_anchors * num_classes, 3, padding=1)
        self.retina_reg = nn.Conv2d(last, num_anchors * 4, 3, padding=1)
        if with_lambda:
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

    def forward(self, feats: Sequence[torch.Tensor],
                generator: Optional[torch.Generator] = None) -> Tuple[tuple, tuple]:
        """feats -> per-level (cls_score [B, A*C, H, W], bbox_pred [B, A*4, H, W])."""
        cls_scores, bbox_preds = [], []
        for f in feats:
            cls_scores.append(self.retina_cls(self.cls_convs(f, generator)))
            bbox_preds.append(self.retina_reg(self.reg_convs(f, generator)))
        return tuple(cls_scores), tuple(bbox_preds)

    def forward_L(self, feats: Sequence[torch.Tensor],
                  generator: Optional[torch.Generator] = None) -> tuple:
        """MEH branch: per-level lambda [B, A, H, W], ReLU-activated."""
        return tuple(torch.relu(self.retina_L(self.L_convs(f, generator))) for f in feats)
