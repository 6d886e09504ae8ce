"""TridentNet's steps (torch): the branch-replicated C4 Faster R-CNN
train step, and the single-branch eval.

Port of aod_meh_hua_tpu/engine/trident.py (`_roi_sample_no_gt` :47-67,
`_extract_c4_rois` :70-76, `make_trident_train_step` :79-162,
`make_trident_eval_step` :165-204), which mirrors the reference's
mmdet/models/detectors/trident_faster_rcnn.py (forward_train :60, the gts
replicated across the three branches, which ride the batch axis
branch-major; simple_test :33, the test_branch_idx branch alone, a plain
dilation-2 stage 3), configs/tridentnet/tridentnet_r50_caffe_1x_coco.py
(500 proposals per image in training; the RoI sampler 128 at 0.5 without
the gts as proposals, add_gt_as_proposals=False) and
configs/_base_/models/faster_rcnn_r50_caffe_c4.py (single-level RoIAlign
14 on C4, the conv5 ResLayer head, the standard two-stage losses).

Randomness: the JAX step splits its key into k_rpn and k_roi, each into
one key per row of the R * B branch-major rows (row r * B + i), (kp, kn)
in the sampler. The port asks its source per branch: uniforms("rpn{r}",
A, 2) and uniforms("roi{r}", P, 2), the B rows of branch r (rows r * B
to r * B + B - 1 of JAX's split). Across ranks each rank keeps its
images' rows of each branch (engine/two_stage.py _make_step), and every
normaliser counts the global R * B rows.
"""

from __future__ import annotations

from typing import Callable

import torch

from ..ops.assigner import max_iou_assign
from ..ops.bbox import delta_encode
from ..ops.roi_align import batched_multilevel_roi_align
from ..ops.sampler import random_sample_pos_neg
from ..utils.profiling import span
from . import two_stage as ts
from .batch import EvalBatch, prepare_images
from .train import DataAxis


def roi_sample_no_gt(u_pos, u_neg, props, prop_valid, gt_boxes, gt_labels, gt_valid,
                     cfg) -> ts.RoISample:
    """Assign and sample the RoIs of each image WITHOUT the gts as
    candidates (add_gt_as_proposals=False): max-IoU without low-quality
    matches, the random sampler on (u_pos, u_neg), class-specific targets
    with the rcnn stds. is_gt is False everywhere."""
    rc = cfg.rcnn
    assigned = max_iou_assign(props, gt_boxes, gt_valid, anchor_valid=prop_valid,
                              pos_iou_thr=rc.pos_iou_thr, neg_iou_thr=rc.neg_iou_thr,
                              min_pos_iou=rc.min_pos_iou, match_low_quality=False)
    s = random_sample_pos_neg(u_pos, u_neg, assigned, prop_valid, rc.sampler_num,
                              rc.pos_fraction)
    rois = torch.gather(props, 1, s.inds[..., None].expand(-1, -1, 4))
    gt_idx = (torch.gather(assigned, 1, s.inds) - 1).clamp(0, gt_boxes.shape[1] - 1)
    labels = torch.where(s.is_pos, torch.gather(gt_labels.long(), 1, gt_idx),
                         torch.full_like(gt_idx, cfg.num_classes))
    matched = torch.gather(gt_boxes, 1, gt_idx[..., None].expand(-1, -1, 4))
    deltas = delta_encode(rois, matched, stds=rc.target_stds, eps=1e-6)
    bbox_t = torch.where(s.is_pos[..., None], deltas, torch.zeros_like(deltas))
    return ts.RoISample(rois, labels, s.valid.float(), bbox_t, s.is_pos, s.valid,
                        torch.zeros_like(s.valid), gt_idx)


def extract_c4_rois(cfg, feat: torch.Tensor, rois: torch.Tensor) -> torch.Tensor:
    """Single-level RoIAlign on C4: feat [N, C, H, W], rois [N, S, 4] ->
    [N * S, roi, roi, C] float32, at 1 / c4_stride (ops/roi_align.py's
    batched gather on the one level, which routes every RoI to it)."""
    rc = cfg.rcnn
    with span(ts.STAGES[4]):
        return batched_multilevel_roi_align([feat], rois, [cfg.c4_stride], rc.roi_size,
                                            rc.sampling_ratio)


def _branch_draws(uniforms: ts.Uniforms, stage: str, r: int, n: int):
    """The (u_pos, u_neg) of every branch row, branch-major: [R * B, n]."""
    draws = [uniforms(f"{stage}{k}", n, 2) for k in range(r)]
    return tuple(torch.cat([d[j] for d in draws]) for j in range(2))


def make_trident_train_step(model, cfg, optimizer: torch.optim.Optimizer, device="cuda",
                            mesh=None) -> Callable:
    """TridentNet's step, the contract of engine/two_stage.py
    make_faster_rcnn_train_step: the backbone's R * B branch-major rows,
    the gts, anchor validity and image shapes replicated to them (row
    r * B + i is image i), the RPN's losses and proposals per row, the
    no-gt RoI sampler, the C4 RoIAlign, the ResLayer head, CE and L1.
    aux: loss, loss_rpn_cls, loss_rpn_bbox, loss_cls, loss_bbox, num_pos."""
    proposal_fn = ts.make_proposal_fn(cfg)
    r, c = len(cfg.trident_dilations), cfg.num_classes

    def loss_fn(batch, anchors: torch.Tensor, uniforms: ts.Uniforms, data: DataAxis):
        with span(ts.STAGES[0]):
            feat = model.features(prepare_images(batch.images, batch.img_shapes, cfg))
            rpn_cls, rpn_reg = model.rpn(feat)

        def tile(x):
            return x.repeat((r,) + (1,) * (x.dim() - 1))

        gt_boxes, gt_labels, gt_valid = (tile(batch.gt_boxes), tile(batch.gt_labels),
                                         tile(batch.gt_valid))
        img_shapes = tile(batch.img_shapes)
        with span(ts.STAGES[1]):
            t = ts.rpn_targets(*_branch_draws(uniforms, "rpn", r, anchors.shape[0]), anchors,
                               tile(batch.anchor_valid), gt_boxes, gt_valid, cfg.rpn)
        loss_rpn_cls, loss_rpn_bbox = ts.rpn_loss(rpn_cls, rpn_reg, t, data)
        with torch.no_grad(), span(ts.STAGES[2]):
            props, _, prop_valid = proposal_fn(rpn_cls.detach(), rpn_reg.detach(), anchors,
                                               img_shapes, cfg.rpn.train_nms_pre,
                                               cfg.rpn.train_max_per_img)
        with span(ts.STAGES[3]):
            smp = roi_sample_no_gt(*_branch_draws(uniforms, "roi", r, props.shape[1]), props,
                                   prop_valid, gt_boxes, gt_labels, gt_valid, cfg)
        avg_cls, avg_reg, num_pos = ts.roi_counts(smp, data)
        roi_feats = extract_c4_rois(cfg, feat, smp.rois)
        with span(ts.STAGES[5]):
            cls, reg = model.roi_forward(roi_feats)
        loss_cls = ts._cls_loss(cls, smp, avg_cls)
        loss_bbox = ts._positive_mean(torch.abs(ts._reg_of_labels(reg, smp, c)
                                                - smp.bbox_targets.reshape(-1, 4)),
                                      smp, avg_reg)
        total = loss_rpn_cls + loss_rpn_bbox + loss_cls + loss_bbox
        return total, {"loss": total, "loss_rpn_cls": loss_rpn_cls,
                       "loss_rpn_bbox": loss_rpn_bbox, "loss_cls": loss_cls,
                       "loss_bbox": loss_bbox, "num_pos": num_pos}

    return ts._make_step(model, cfg, optimizer, device, loss_fn, mesh=mesh)


class TridentEvalStep(ts.TwoStageEvalStep):
    """TridentNet's eval: the test_branch_idx branch alone (a plain
    dilation-2 stage 3), the RPN on C4, the test proposals, the C4
    RoIAlign, the ResLayer head, and Faster R-CNN's class-specific decode
    and multiclass NMS: NMSResult."""

    def forward(self, batch: EvalBatch) -> ts.NMSResult:
        cfg = self.cfg
        with span(ts.STAGES[0]):
            feat, rpn_cls, rpn_reg = self.model(prepare_images(batch.images, batch.img_shapes,
                                                               cfg))
        with span(ts.STAGES[2]):
            props, _, prop_valid = self.proposals(rpn_cls, rpn_reg, self.anchors,
                                                  batch.img_shapes, cfg.rpn.test_nms_pre,
                                                  cfg.rpn.test_max_per_img)
        roi_feats = extract_c4_rois(cfg, feat, props)
        with span(ts.STAGES[5]):
            cls, reg = self.model.roi_forward(roi_feats)
        return self._class_specific(props, prop_valid, cls, reg, batch)
