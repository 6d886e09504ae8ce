"""The RPN-only and Fast R-CNN steps (torch): the two detachable halves of
the two-stage pipeline.

Port of aod_meh_hua_tpu/engine/rpn_only.py (`make_rpn_train_step`
:37-75, `ProposalResult` :81-90, `make_rpn_eval_step` :92-118,
`proposal_recall` :121-139, `ProposalBatch` :142-152,
`make_fast_rcnn_train_step` :155-197, `make_fast_rcnn_eval_step`
:200-222), which mirrors the reference's mmdet/models/detectors/rpn.py
(forward_train :59, the RPN loss alone with the gt labels dropped;
simple_test :87, the proposals as the detections, scored by
fast_eval_recall, datasets/coco.py:418) and detectors/fast_rcnn.py with
roi_heads/standard_roi_head.py (the RoI criterion on proposals given
from outside, the reference's proposal .pkl files, here a
`ProposalBatch`; the standard softmax, decode and NMS on eval proposals).

The steps are engine/two_stage.py's: the RPN's targets and losses
(`rpn_targets`, `rpn_loss`) and the proposals, the RoI sampler
(`roi_sample`, the gts prepended), RoIAlign and the class-specific
losses, the train step's frame (`_make_step`: the uniforms, the global
normalisers across ranks, one backward, the optional clip, SGD). The
JAX RPN step splits its key into one per image, (kp, kn) in the sampler:
uniforms("rpn", A, 2); Fast R-CNN's likewise over the gts and the
proposals: uniforms("roi", G + P, 2).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch
from torch.utils._pytree import _register_namedtuple

from ..utils.profiling import span
from . import two_stage as ts
from .batch import EvalBatch, as_tensor, prepare_images
from .eval import batch_on
from .train import DataAxis


class ProposalResult(NamedTuple):
    """Proposals as detections (rpn.py simple_test): one foreground class,
    label 0 everywhere; the fields of ops/nms.py NMSResult."""

    boxes: torch.Tensor       # [B, K, 4] original-image coordinates
    scores: torch.Tensor      # [B, K]
    labels: torch.Tensor      # [B, K] int64, 0
    valid: torch.Tensor       # [B, K] bool
    anchor_idx: torch.Tensor  # [B, K] int64, the slot


_register_namedtuple(ProposalResult, serialized_type_name="aod_meh_hua_torch.ProposalResult")


class ProposalBatch(NamedTuple):
    """A training batch with proposals given from outside (the reference's
    proposal_file path, datasets/custom.py); numpy arrays or tensors."""

    images: object      # [B, H, W, 3]
    gt_boxes: object    # [B, G, 4]
    gt_labels: object   # [B, G]
    gt_valid: object    # [B, G] bool
    img_shapes: object  # [B, 2]
    proposals: object   # [B, P, 4] canvas coordinates
    prop_valid: object  # [B, P] bool


def proposal_result(boxes: torch.Tensor, scores: torch.Tensor,
                    valid: torch.Tensor) -> ProposalResult:
    """A ProposalResult of [B, K] proposals: labels 0, anchor_idx the slot."""
    b, k = scores.shape
    idx = torch.arange(k, device=scores.device)[None].expand(b, k)
    return ProposalResult(boxes, scores, torch.zeros((b, k), dtype=torch.long,
                                                     device=scores.device), valid, idx)


def make_rpn_train_step(model, cfg, optimizer: torch.optim.Optimizer, device="cuda",
                        mesh=None) -> Callable:
    """The RPN alone (rpn.py forward_train): step(batch: Batch,
    generator=None, uniforms=None) -> aux (loss, loss_rpn_cls,
    loss_rpn_bbox, num_pos), the contract of engine/two_stage.py
    make_faster_rcnn_train_step. The gts' labels are not read."""

    def loss_fn(batch, anchors: torch.Tensor, uniforms: ts.Uniforms, data: DataAxis):
        with span(ts.STAGES[0]):
            _, rpn_cls, rpn_reg = model(prepare_images(batch.images, batch.img_shapes, cfg))
        with span(ts.STAGES[1]):
            t = ts.rpn_targets(*uniforms("rpn", anchors.shape[0], 2), anchors,
                               batch.anchor_valid, batch.gt_boxes, batch.gt_valid, cfg.rpn)
        loss_cls, loss_bbox = ts.rpn_loss(rpn_cls, rpn_reg, t, data)
        total = loss_cls + loss_bbox
        return total, {"loss": total, "loss_rpn_cls": loss_cls, "loss_rpn_bbox": loss_bbox,
                       "num_pos": data.sum(t.is_pos.sum().float())}

    return ts._make_step(model, cfg, optimizer, device, loss_fn, mesh=mesh)


class RPNEvalStep(ts.TwoStageEvalStep):
    """The RPN-only eval (rpn.py simple_test): the test proposals
    (test_nms_pre, test_max_per_img, the level-grouped NMS) as a
    ProposalResult in original-image coordinates."""

    def forward(self, batch: EvalBatch) -> ProposalResult:
        cfg = self.cfg
        with span(ts.STAGES[0]):
            _, rpn_cls, rpn_reg = self.model(prepare_images(batch.images, batch.img_shapes,
                                                            cfg))
        with span(ts.STAGES[2]):
            boxes, scores, valid = self.proposals(rpn_cls, rpn_reg, self.anchors,
                                                  batch.img_shapes, cfg.rpn.test_nms_pre,
                                                  cfg.rpn.test_max_per_img)
        return proposal_result(boxes / batch.scale_factors[:, None, :], scores, valid)


def bbox_overlaps_np(boxes1: np.ndarray, boxes2: np.ndarray, eps: float = 1e-6) -> np.ndarray:
    """IoU [N, M] of boxes1 [N, 4] and boxes2 [M, 4] in float32, the
    arithmetic of ops/bbox.py bbox_overlaps, in numpy."""
    b1, b2 = np.asarray(boxes1, np.float32), np.asarray(boxes2, np.float32)
    a1 = ((b1[:, 2] - b1[:, 0]) * (b1[:, 3] - b1[:, 1]))[:, None]
    a2 = ((b2[:, 2] - b2[:, 0]) * (b2[:, 3] - b2[:, 1]))[None, :]
    lt = np.maximum(b1[:, None, :2], b2[None, :, :2])
    rb = np.minimum(b1[:, None, 2:], b2[None, :, 2:])
    wh = np.clip(rb - lt, np.float32(0.0), None)
    inter = wh[..., 0] * wh[..., 1]
    return inter / np.maximum(a1 + a2 - inter, np.float32(eps))


def proposal_recall(prop_boxes, prop_valid, gt_boxes_list, iou_thr: float = 0.5,
                    top_k: int = 100) -> float:
    """AR@top_k (fast_eval_recall): the share of the gts whose best IoU
    with the image's first top_k valid proposals (score-ordered, as the
    eval step gives them) exceeds iou_thr. Host numpy."""
    hit = total = 0
    for i, gts in enumerate(gt_boxes_list):
        if len(gts) == 0:
            continue
        boxes = np.asarray(prop_boxes[i])[np.asarray(prop_valid[i])][:top_k]
        total += len(gts)
        if len(boxes) == 0:
            continue
        hit += int((bbox_overlaps_np(gts, boxes).max(axis=1) > iou_thr).sum())
    return hit / max(total, 1)


def make_fast_rcnn_train_step(model, cfg, optimizer: torch.optim.Optimizer, device="cuda",
                              mesh=None) -> Callable:
    """Fast R-CNN's step on a ProposalBatch (canvas-coordinate proposals
    in num_proposals slots): the RoI sampler over the gts and the valid
    proposals, RoIAlign, the box head, CE and L1 over the global
    normalisers. aux: loss, loss_cls, loss_bbox, num_pos."""
    c = cfg.num_classes

    def loss_fn(batch: ProposalBatch, anchors, uniforms: ts.Uniforms, data: DataAxis):
        with span(ts.STAGES[0]):
            feats = model(prepare_images(batch.images, batch.img_shapes, cfg))
        smp = ts._sample(cfg, batch, uniforms, "roi", batch.proposals, batch.prop_valid)
        avg_cls, avg_reg, num_pos = ts.roi_counts(smp, data)
        roi_feats = ts.roi_features(model, cfg, feats, smp.rois)
        with span(ts.STAGES[5]):
            cls, reg = model.roi_forward(roi_feats)
        loss_cls = ts._cls_loss(cls, smp, avg_cls)
        loss_bbox = ts._positive_mean(torch.abs(ts._reg_of_labels(reg, smp, c)
                                                - smp.bbox_targets.reshape(-1, 4)),
                                      smp, avg_reg)
        total = loss_cls + loss_bbox
        return total, {"loss": total, "loss_cls": loss_cls, "loss_bbox": loss_bbox,
                       "num_pos": num_pos}

    return ts._make_step(model, cfg, optimizer, device, loss_fn, mesh=mesh)


class FastRCNNEvalStep(ts.TwoStageEvalStep):
    """Fast R-CNN's eval: forward(batch, proposals [B, P, 4] in canvas
    coordinates, prop_valid [B, P]) -> NMSResult (Faster R-CNN's RoI
    stage on the given proposals)."""

    def forward(self, batch: EvalBatch, proposals: torch.Tensor,
                prop_valid: torch.Tensor) -> ts.NMSResult:
        with span(ts.STAGES[0]):
            feats = self.model(prepare_images(batch.images, batch.img_shapes, self.cfg))
        return self._faster(feats, proposals, prop_valid, batch)


def make_fast_rcnn_eval_step(model, cfg, device="cuda") -> Callable:
    """step(batch: EvalBatch, proposals [B, P, 4], prop_valid [B, P]) ->
    NMSResult, boxes in original-image coordinates; the proposals in
    canvas coordinates. Under torch.no_grad(), on `device`."""
    dev = ts._check_step(model, cfg, device)
    module = FastRCNNEvalStep(model, cfg)

    @torch.no_grad()
    def step(batch: EvalBatch, proposals, prop_valid) -> ts.NMSResult:
        return module(batch_on(batch, dev), as_tensor(proposals, dev, torch.float32),
                      as_tensor(prop_valid, dev, torch.bool))

    return step
