"""Test-time augmentation: multi-scale + flip inference with one merged
NMS, for the dense families and for Faster and Cascade R-CNN.

Port of aod_meh_hua_tpu/engine/tta.py but for its HTC/SCNet fusion and
mask steps (`make_tta_candidate_step` and `make_tta_merge_step` :33-81,
`_flip_x` :84-91, `make_tta_rpn_step`, `make_tta_proposal_merge`,
`make_tta_roi_step`, `make_tta_two_stage_merge` (also JAX's
`make_tta_cascade_merge`, the same mean over class-agnostic boxes) and
`make_tta_cascade_roi_step` for the plain cascade :94-288,
`canvas_for_scale` :373-379). The
dense part mirrors the reference's
MultiScaleFlipAug (datasets/pipelines/test_time_aug.py:10) and
aug_test_bboxes (dense_test_mixins.py:71-143): per augmentation the
candidates without NMS, mapped back to the original image (the flip
undone in the augmented frame, then divided by the scale factor),
concatenated across augmentations, and ONE multiclass NMS. As in the
JAX package, the merged set is cut to the top `test.pre_nms_cands` by a
stable sort before the quadratic NMS, the cap of the single-aug eval.

The two-stage part mirrors two_stage.py:184 aug_test: per augmentation
the RPN's proposals mapped back to the original image
(aug_test_rpn), ONE class-agnostic NMS over their union
(merge_aug_proposals), then per augmentation the RoI head on that shared
set mapped into the augmented frame, its boxes mapped back, and the
boxes and scores MEANED over the augmentations before one multiclass NMS
(merge_aug_bboxes). The cascade runs its stages per augmentation and
averages their raw logits under one softmax (cascade_roi_head.py:413),
so the merge averages probabilities: do not confuse the two means. The
HTC/SCNet fusion and the mask steps wait for those families (ROADMAP
Queue 1 item 15).
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..ops.bbox import delta_decode
from ..ops.nms import batched_multiclass_nms
from .batch import EvalBatch, as_tensor, prepare_images
from .eval import EvalStep, batch_on
from .two_stage import anchor_table, cascade_refine, extract_rois, make_proposal_fn


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


def make_tta_rpn_step(model, cfg):
    """Two-stage TTA stage 1 (aug_test_rpn): one augmentation's RPN
    proposals mapped back to ORIGINAL coordinates, and the features for
    the RoI stage (the reference extracts them once per augmentation,
    two_stage.py:184-199), on the model's device.

    step(batch: EvalBatch, flipped [B] bool) -> (feats, props [B, P, 4]
    in original coordinates, scores [B, P], valid [B, P])."""
    dev = next(model.parameters()).device
    proposal_fn = make_proposal_fn(cfg)
    anchors = torch.from_numpy(anchor_table(cfg)).to(dev)

    @torch.no_grad()
    def step(batch: EvalBatch, flipped):
        batch = batch_on(batch, dev)
        feats, rpn_cls, rpn_reg = model(prepare_images(batch.images, batch.img_shapes, cfg))
        props, scores, valid = proposal_fn(rpn_cls, rpn_reg, anchors, batch.img_shapes,
                                           cfg.rpn.test_nms_pre, cfg.rpn.test_max_per_img)
        props = _flip_x(props, as_tensor(flipped, dev), batch.img_shapes[:, 1])
        return feats, props / batch.scale_factors[:, None, :], scores, valid

    return step


def make_tta_proposal_merge(cfg):
    """merge_aug_proposals (core/post_processing/merge_augs.py:14): one
    class-agnostic NMS of the augmentations' proposals in original
    coordinates at the RPN's IoU, keeping its test budget. boxes
    [B, A*P, 4], scores and valid [B, A*P] -> (boxes [B, P', 4], valid)."""

    @torch.no_grad()
    def merge(boxes, scores, valid):
        res = batched_multiclass_nms(boxes, (scores * valid)[..., None], 0.0,
                                     cfg.rpn.nms_iou_thr, cfg.rpn.test_max_per_img,
                                     min(boxes.shape[1], cfg.rpn.test_nms_pre))
        return res.boxes, res.valid

    return merge


def _into_aug(props_orig, batch: EvalBatch, flipped):
    """bbox_mapping: original-coordinate boxes into an augmentation's
    frame (scale, then flip)."""
    props = props_orig * batch.scale_factors[:, None, :]
    return _flip_x(props, flipped, batch.img_shapes[:, 1])


def make_tta_roi_step(model, cfg):
    """Two-stage TTA stage 2 (test_mixins.py:116-143, aug_test_bboxes's
    body): the MERGED proposals mapped into this augmentation's frame,
    the RoI head on its features, the per-class decode, and the boxes
    mapped back to original coordinates; no NMS (the merge averages
    first).

    step(feats, batch, flipped, props_orig, prop_valid) -> (boxes
    [B, P, C, 4] in original coordinates, probs [B, P, C + 1])."""
    dev = next(model.parameters()).device
    c = cfg.num_classes

    @torch.no_grad()
    def step(feats, batch: EvalBatch, flipped, props_orig, prop_valid):
        batch = batch_on(batch, dev)
        flipped = as_tensor(flipped, dev)
        props = _into_aug(props_orig, batch, flipped)
        cls, reg = model.roi_forward(extract_rois(cfg, feats, props))
        b, p = props.shape[:2]
        probs = torch.softmax(cls, dim=-1).reshape(b, p, c + 1)
        boxes = delta_decode(props[:, :, None, :], reg.reshape(b, p, c, 4),
                             stds=cfg.rcnn.target_stds, max_shape=batch.img_shapes[:, None, :])
        boxes = _flip_x(boxes, flipped, batch.img_shapes[:, 1])
        return boxes / batch.scale_factors[:, None, None, :], probs

    return step


def make_tta_cascade_roi_step(model, cfg):
    """Cascade TTA stage 2 (cascade_roi_head.py:420-459, aug_test's body)
    for the plain cascade: the MERGED proposals into this augmentation's
    frame, every stage with its refinement, the stages' raw logits
    averaged under ONE softmax, and the last stage's boxes mapped back.

    step(feats, batch, flipped, props_orig, prop_valid) -> (boxes
    [B, P, 4] in original coordinates, class-agnostic; probs
    [B, P, C + 1])."""
    dev = next(model.parameters()).device

    @torch.no_grad()
    def step(feats, batch: EvalBatch, flipped, props_orig, prop_valid):
        batch = batch_on(batch, dev)
        flipped = as_tensor(flipped, dev)
        boxes, logits = cascade_refine(model, cfg, feats, _into_aug(props_orig, batch, flipped),
                                       batch.img_shapes)
        boxes = _flip_x(boxes, flipped, batch.img_shapes[:, 1])
        return boxes / batch.scale_factors[:, None, :], torch.softmax(logits, dim=-1)

    return step


def make_tta_two_stage_merge(cfg):
    """merge_aug_bboxes (merge_augs.py:83) and the final multiclass NMS:
    the MEAN of the augmentations' recovered boxes and probabilities over
    the shared proposal set, then one NMS. boxes [A, B, P, C, 4] (or
    [A, B, P, 4], the cascade's class-agnostic ones), probs
    [A, B, P, C + 1], prop_valid [B, P]."""
    t, c = cfg.test, cfg.num_classes

    @torch.no_grad()
    def merge(boxes, probs, prop_valid):
        fg = probs.mean(dim=0)[..., :c] * prop_valid[..., None]
        return batched_multiclass_nms(boxes.mean(dim=0), fg, t.score_thr, t.nms_iou_thr,
                                      t.max_per_img, min(fg.shape[1], t.pre_nms_cands))

    return merge



def canvas_for_scale(img_scale: Tuple[int, int]) -> Tuple[int, int]:
    """Landscape (H, W) canvas bounding every keep_ratio resize to
    img_scale=(long, short), /32-padded: the rule behind the live
    config's (1000, 600) -> (608, 1024)."""
    long_e, short_e = max(img_scale), min(img_scale)

    def pad(v):
        return int((v + 31) // 32 * 32)

    return (pad(short_e), pad(long_e))
