"""The Cascade RPN model (torch): two stages of anchor refinement, the
second on a deformable conv whose offsets are the refined anchors'
geometry.

Port of aod_meh_hua_tpu/models/cascade_rpn.py (`DeformConv3x3Explicit`
:37-63, `CascadeRPNNet` :66-131), which mirrors the reference's
mmdet/models/dense_heads/cascade_rpn_head.py (AdaptiveConv :18 in its
'dilation' mode, a plain dilated 3x3 conv, and its 'offset' mode, a
DeformConv2d driven by anchor-geometry offsets; StageCascadeRPNHead :94
with the bridged feature; CascadeRPNHead :675) and
configs/cascade_rpn/crpn_r50_caffe_fpn_1x_coco.py: stage 0 a dilation-3
conv, bridged, regression only; stage 1 the offset deform conv,
objectness and regression, one square anchor per cell.

mmcv's DeformConv2d im2col kernel is the JAX package's nine zero-padded
bilinear gathers (models/deform.py bilinear_zero), each contracted with
its kernel tap; the offsets are no learned branch but the refined
anchors' geometry (engine/cascade_rpn.py anchor_offsets), an input of
the conv. The deform conv runs in the profiler range DEFORM_SPAN.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
from torch import nn

from ..utils.profiling import span
from .deform import _BASE_YX, bilinear_zero
from .detector import flatten_levels
from .two_stage import FasterRCNN

# the profiler ranges of the stage-1 deform conv and of the anchors' refinement
# (engine/cascade_rpn.py; engine/two_stage.py STAGES)
DEFORM_SPAN, REFINE_SPAN = "cascade_rpn.deform", "cascade_rpn.refine"


class DeformConv3x3Explicit(nn.Module):
    """A 3x3 deform conv, stride 1, zero padding, no bias, whose 18
    offset channels ((dy, dx) per tap, row-major taps) arrive as an
    input. The weight is [out, in, 3, 3], tap k at (k // 3, k % 3)."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels, 3, 3))

    def forward(self, x: torch.Tensor, offsets: torch.Tensor) -> torch.Tensor:
        """x [B, C, H, W], offsets [B, H, W, 18] -> [B, out, H, W]: per tap
        the map sampled at grid + tap + offset (bilinear_zero), times the
        tap's kernel, summed over the taps in order."""
        b, c, h, w = x.shape
        feat = x.permute(0, 2, 3, 1)
        gy, gx = torch.meshgrid(torch.arange(h, dtype=offsets.dtype, device=x.device),
                                torch.arange(w, dtype=offsets.dtype, device=x.device),
                                indexing="ij")
        out = None
        for k in range(9):
            ys = (gy + float(_BASE_YX[k, 0]) + offsets[..., 2 * k]).reshape(b, -1)
            xs = (gx + float(_BASE_YX[k, 1]) + offsets[..., 2 * k + 1]).reshape(b, -1)
            y = bilinear_zero(feat, ys, xs) @ self.weight[:, :, k // 3, k % 3].t()
            out = y if out is None else out + y
        return out.reshape(b, h, w, -1).permute(0, 3, 1, 2)


class CascadeRPNNet(FasterRCNN):
    """Backbone + FPN + the two cascade stages, their weights shared by
    the levels: s0_conv (dilated, no bias) and s0_reg; s1_conv (the
    deform conv), s1_cls and s1_reg. No RPN head, no RoI head."""

    def _build_rpn_head(self, cfg):
        return None

    def _build_roi_head(self, cfg) -> None:
        c, d = cfg.fpn_channels, cfg.stage0_dilation
        self.s0_conv = nn.Conv2d(c, c, 3, padding=d, dilation=d, bias=False)
        self.s0_reg = nn.Conv2d(c, 4, 1)
        self.s1_conv = DeformConv3x3Explicit(c, c)
        self.s1_cls = nn.Conv2d(c, 1, 1)
        self.s1_reg = nn.Conv2d(c, 4, 1)

    def _roi_heads(self):
        return []

    @torch.no_grad()
    def init_weights(self, seed: int) -> None:
        """The trunk's init (FasterRCNN.init_weights), then the stages'
        Normal(0.01) weights and zero biases (the JAX initialisers), from a
        generator seeded seed + 1."""
        super().init_weights(seed)
        gen = torch.Generator().manual_seed(seed + 1)
        for m in (self.s0_conv, self.s0_reg, self.s1_conv, self.s1_cls, self.s1_reg):
            m.weight.copy_(torch.randn(m.weight.shape, generator=gen) * 0.01)
            if getattr(m, "bias", None) is not None:
                m.bias.zero_()

    def rpn(self, feats):
        raise TypeError("Cascade RPN's stages are stage0 and stage1")

    def stage0(self, feats: Sequence[torch.Tensor]) -> Tuple[List[torch.Tensor], torch.Tensor]:
        """-> (the bridged maps, the adapted post-ReLU features that replace
        the FPN levels for stage 1; deltas [B, A, 4])."""
        bridged, regs = [], []
        for f in feats:
            x = torch.relu(self.s0_conv(f))
            bridged.append(x)
            regs.append(self.s0_reg(x))
        return bridged, flatten_levels(regs, 4).float()

    def stage1(self, feats: Sequence[torch.Tensor],
               offsets: Sequence[torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
        """-> (objectness [B, A], deltas [B, A, 4])."""
        cls_maps, reg_maps = [], []
        for f, o in zip(feats, offsets):
            with span(DEFORM_SPAN):
                x = torch.relu(self.s1_conv(f, o))
            cls_maps.append(self.s1_cls(x))
            reg_maps.append(self.s1_reg(x))
        return flatten_levels(cls_maps, 1)[..., 0].float(), flatten_levels(reg_maps, 4).float()

    def forward(self, images: torch.Tensor):
        """The JAX module's __call__: stage 1 at zero offsets, (reg0, cls1,
        reg1)."""
        bridged, reg0 = self.stage0(self.features(images))
        zero = [torch.zeros(f.shape[0], f.shape[2], f.shape[3], 18, device=f.device)
                for f in bridged]
        return (reg0,) + self.stage1(bridged, zero)
