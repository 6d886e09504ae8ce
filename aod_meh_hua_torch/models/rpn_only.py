"""The RPN-only and Fast R-CNN models (torch): the two detachable halves
of the two-stage pipeline that the reference registers as detectors of
their own.

Port of aod_meh_hua_tpu/models/rpn_only.py (`RPNOnly` :28-51, `FastRCNN`
:54-79), which mirrors the reference's mmdet/models/detectors/rpn.py:13
(configs/rpn/rpn_r50_fpn_1x_coco.py: backbone + FPN + RPNHead, trained
alone on class-agnostic gt boxes, evaluated by proposal recall) and
detectors/fast_rcnn.py (configs/fast_rcnn/fast_rcnn_r50_fpn_1x_coco.py:
backbone + FPN + the Shared2FC box head on proposals given from
outside). Both are Faster R-CNN's model (models/two_stage.py) with a part
left out: the RPN-only model has no RoI head, Fast R-CNN no RPN head, as
the JAX trees have none. Their steps are engine/rpn_only.py's.
"""

from __future__ import annotations

from typing import Tuple

import torch

from .two_stage import FasterRCNN


class RPNOnly(FasterRCNN):
    """Backbone + FPN + RPN head: forward(images) -> (FPN levels,
    objectness [B, A], deltas [B, A, 4])."""

    def _build_roi_head(self, cfg) -> None:
        pass

    def _roi_heads(self):
        return []

    def roi_forward(self, roi_feats: torch.Tensor):
        raise TypeError("the RPN-only model has no RoI head")


class FastRCNN(FasterRCNN):
    """Backbone + FPN + Shared2FC box head, no RPN head: forward(images) ->
    the FPN levels; roi_forward(RoI features) -> (cls, deltas)."""

    def _build_rpn_head(self, cfg):
        return None

    def rpn(self, feats):
        raise TypeError("Fast R-CNN has no RPN head: its proposals come from outside")

    def forward(self, images: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        return self.features(images)
