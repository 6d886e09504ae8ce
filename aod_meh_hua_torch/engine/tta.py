"""Test-time augmentation of the dense families: multi-scale + flip
inference with one merged NMS.

Port of the dense part of aod_meh_hua_tpu/engine/tta.py
(`make_tta_candidate_step` and `make_tta_merge_step` :33-81, `_flip_x`
:84-91, `canvas_for_scale` :373-379), which mirrors the reference's
MultiScaleFlipAug (datasets/pipelines/test_time_aug.py:10) and
aug_test_bboxes (dense_test_mixins.py:71-143): per augmentation the
candidates without NMS, mapped back to the original image (the flip
undone in the augmented frame, then divided by the scale factor),
concatenated across augmentations, and ONE multiclass NMS. As in the
JAX package, the merged set is cut to the top `test.pre_nms_cands` by a
stable sort before the quadratic NMS, the cap of the single-aug eval.
The two-stage, cascade and mask TTA steps (:94-371) come with the model
zoo (ROADMAP Queue 1 item 15).
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..ops.nms import batched_multiclass_nms
from .batch import EvalBatch, as_tensor
from .eval import EvalStep, batch_on


def make_tta_candidate_step(model, cfg):
    """One augmentation's candidates, mapped back to ORIGINAL image
    coordinates, on the model's device: EvalStep's candidates, the flip
    undone and the scale divided out.

    Returned step: (batch: EvalBatch, flipped [B] bool) -> (boxes
    [B, K, 4] in original coordinates, scores [B, K, C_fg]).
    """
    module = EvalStep(model, cfg)
    dev = module.anchors.device

    @torch.no_grad()
    def step(batch: EvalBatch, flipped):
        batch = batch_on(batch, dev)
        cand = module.candidates(batch)
        # bbox_mapping_back (reference core/bbox/transforms.py): undo the
        # horizontal flip in the AUG image frame (width = resized width),
        # then rescale to original coordinates
        boxes = _flip_x(cand.boxes, as_tensor(flipped, dev), batch.img_shapes[:, 1])
        boxes = boxes / batch.scale_factors[:, None, :]
        return boxes, cand.scores[..., :cfg.num_fg_classes]

    return step


def make_tta_merge_step(cfg):
    """Merged NMS over the aug-concatenated candidate set
    (dense_test_mixins.py:121-131): boxes [B, A*K, 4], scores
    [B, A*K, C_fg] -> NMSResult in original image coordinates."""
    t = cfg.test

    @torch.no_grad()
    def merge(boxes: torch.Tensor, scores: torch.Tensor):
        return batched_multiclass_nms(boxes, scores, t.score_thr, t.nms_iou_thr,
                                      t.max_per_img, min(boxes.shape[1], t.pre_nms_cands))

    return merge


def _flip_x(boxes: torch.Tensor, flipped: torch.Tensor, width: torch.Tensor) -> torch.Tensor:
    """Horizontal flip of [..., 4] boxes where flipped[b] (the mapping is
    its own inverse). width: [B] image width in the boxes' frame."""
    w = width.to(boxes.dtype).reshape((-1,) + (1,) * (boxes.dim() - 2))
    fb = torch.stack([w - boxes[..., 2], boxes[..., 1], w - boxes[..., 0], boxes[..., 3]],
                     dim=-1)
    cond = flipped.reshape((-1,) + (1,) * (boxes.dim() - 1))
    return torch.where(cond, fb, boxes)


def canvas_for_scale(img_scale: Tuple[int, int]) -> Tuple[int, int]:
    """Landscape (H, W) canvas bounding every keep_ratio resize to
    img_scale=(long, short), /32-padded: the rule behind the live
    config's (1000, 600) -> (608, 1024)."""
    long_e, short_e = max(img_scale), min(img_scale)

    def pad(v):
        return int((v + 31) // 32 * 32)

    return (pad(short_e), pad(long_e))
