"""Cascade RPN's steps (torch): both refinement stages in one train step,
and the eval's proposals.

Port of aod_meh_hua_tpu/engine/cascade_rpn.py (`anchor_offsets` :43-67,
`_anchor_tables` :70-83, `_stage1_targets_single` :92-107,
`make_crpn_train_step` :110-191, `make_crpn_eval_step` :194-252), which
mirrors the reference's mmdet/models/dense_heads/cascade_rpn_head.py
(forward_train :713: stage 0 on region-assigned static anchors,
refine_bboxes, the anchor offsets into the stage-1 deform conv, stage 1
on max-IoU-assigned refined anchors; anchor_offset :326; refine_bboxes
:530, decoded with each stage's stds and clipped to the image; the
proposals :547, per-level top-k and level-grouped NMS at IoU 0.8) and
configs/cascade_rpn/crpn_r50_caffe_fpn_1x_coco.py: stage 0
RegionAssigner(0.2, 0.5), no sampler, no cls, linear IoU loss x10 on the
decoded boxes over A_tot * B / 200 (the guided-anchoring constant,
cascade_rpn_head.py:477-480), stds (.1, .1, .5, .5); stage 1 MaxIoU
(.7 / .7 / .3) and the random sampler 256, sigmoid BCE and linear IoU
x10, stds (.05, .05, .1, .1).

Randomness: the JAX step splits its key into one per image, (kp, kn) in
the stage-1 sampler: uniforms("rpn", A, 2) (engine/two_stage.py Uniforms).
Across ranks the step is the one-process step on the global batch: the
stage-0 normaliser counts the global batch, the stage-1 one the global
samples.
"""

from __future__ import annotations

from typing import Callable, List, NamedTuple, Tuple

import numpy as np
import torch

from ..ops.assigner import max_iou_assign, region_assign
from ..ops.bbox import delta_decode
from ..ops.losses import binary_cross_entropy_with_logits, iou_loss
from ..ops.nms import grouped_nms
from ..models.cascade_rpn import REFINE_SPAN
from ..ops.sampler import random_sample_pos_neg
from ..utils.profiling import span
from . import two_stage as ts
from .batch import AnchorTable, EvalBatch, prepare_images
from .rpn_only import ProposalResult, proposal_result
from .train import DataAxis

# the taps of a 3x3 deform kernel, row-major (dy, dx): models/deform.py _BASE_YX
_TAPS = np.array([(dy, dx) for dy in (-1, 0, 1) for dx in (-1, 0, 1)], dtype=np.float32)


def anchor_offsets(anchors_flat: torch.Tensor, bounds, featmap_sizes,
                   strides) -> List[torch.Tensor]:
    """Refined anchors [B, A, 4] -> the stage-1 deform conv's offsets per
    level, [B, H, W, 18] with (dy, dx) per tap (anchor_offset,
    cascade_rpn_head.py:326): tap k samples at the anchor's centre plus
    tap_k times half the anchor's extent in cells, as an offset from the
    regular dilation-1 grid."""
    outs = []
    taps = torch.from_numpy(_TAPS).to(anchors_flat.device)
    for (s0, s1), (h, w), stride in zip(bounds, featmap_sizes, strides):
        a = anchors_flat[:, s0:s1].reshape(-1, h, w, 4)
        cx = (a[..., 0] + a[..., 2]) * 0.5 / stride
        cy = (a[..., 1] + a[..., 3]) * 0.5 / stride
        gy, gx = torch.meshgrid(torch.arange(h, dtype=a.dtype, device=a.device),
                                torch.arange(w, dtype=a.dtype, device=a.device), indexing="ij")
        s_off_x = (a[..., 2] - a[..., 0]) / stride / 2.0 - 1.0
        s_off_y = (a[..., 3] - a[..., 1]) / stride / 2.0 - 1.0
        off_y = s_off_y[..., None] * taps[:, 0] + (cy - gy)[..., None]
        off_x = s_off_x[..., None] * taps[:, 1] + (cx - gx)[..., None]
        outs.append(torch.stack([off_y, off_x], dim=-1).reshape(off_y.shape[:3] + (18,)))
    return outs


def anchor_tables(cfg) -> Tuple[np.ndarray, ...]:
    """The static per-anchor host tables of the region assigner: (anchors
    [A, 4], level ids [A], strides [A], feature map (w, h) [A, 2])."""
    sizes = cfg.featmap_sizes()
    anchors = ts.anchor_table(cfg)
    lvl_ids, strides, feat_wh = [], [], []
    for li, ((h, w), s) in enumerate(zip(sizes, cfg.rpn.anchor_strides)):
        n = h * w
        lvl_ids.append(np.full(n, li, np.int64))
        strides.append(np.full(n, s, np.float32))
        feat_wh.append(np.tile([[w, h]], (n, 1)).astype(np.float32))
    return anchors, np.concatenate(lvl_ids), np.concatenate(strides), np.concatenate(feat_wh)


class Stage1Targets(NamedTuple):
    is_pos: torch.Tensor       # [B, A] bool
    weights: torch.Tensor      # [B, A] (the sampled anchors)
    gt_box: torch.Tensor       # [B, A, 4] the matched gt (positive rows)
    num_samples: torch.Tensor  # [B]


def stage1_targets(u_pos, u_neg, anchors, anchor_valid, gt_boxes, gt_valid,
                   rpn_cfg) -> Stage1Targets:
    """Max-IoU assignment (low-quality matches to every maximal anchor) and
    the random sampler over each image's refined anchors [B, A, 4]."""
    assigned = max_iou_assign(anchors, gt_boxes, gt_valid, anchor_valid=anchor_valid,
                              pos_iou_thr=rpn_cfg.pos_iou_thr, neg_iou_thr=rpn_cfg.neg_iou_thr,
                              min_pos_iou=rpn_cfg.min_pos_iou, gt_max_assign_all=True)
    s = random_sample_pos_neg(u_pos, u_neg, assigned, anchor_valid, rpn_cfg.sampler_num,
                              rpn_cfg.pos_fraction)
    a = anchors.shape[1]
    w = ts._scatter_count(s.inds, s.valid.float(), a)
    pos = ts._scatter_count(s.inds, (s.is_pos & s.valid).long(), a) > 0
    gt_idx = (assigned - 1).clamp(0, gt_boxes.shape[1] - 1)
    gt_box = torch.gather(gt_boxes, 1, gt_idx[..., None].expand(-1, -1, 4))
    return Stage1Targets(pos, w, gt_box, s.valid.sum(dim=1))


def _refine(model, cfg, feats, anchors, img_shapes):
    """Stage 0 and the refined anchors' stage 1: (stage-0 deltas, refined
    anchors [B, A, 4] clipped to the images, objectness, stage-1 deltas)."""
    bridged, reg0 = model.stage0(feats)
    with span(REFINE_SPAN):
        anchors1 = delta_decode(anchors[None], reg0.detach(), stds=cfg.s0_stds,
                                max_shape=img_shapes[:, None, :])
        offsets = anchor_offsets(anchors1, cfg.level_bounds(), cfg.featmap_sizes(),
                                 cfg.rpn.anchor_strides)
    cls1, reg1 = model.stage1(bridged, offsets)
    return reg0, anchors1, cls1, reg1


def make_crpn_train_step(model, cfg, optimizer: torch.optim.Optimizer, device="cuda",
                         mesh=None) -> Callable:
    """Cascade RPN's step, the contract of engine/two_stage.py
    make_faster_rcnn_train_step: stage 0's region-assigned IoU loss on the
    decoded static anchors, stage 1's sampled BCE and IoU loss on the
    refined (detached) anchors. aux: loss, loss_s0_reg, loss_s1_cls,
    loss_s1_reg, num_pos."""
    _, lvl, strides, feat_wh = (AnchorTable(t) for t in anchor_tables(cfg))
    num_lvls = len(cfg.featmap_sizes())

    def loss_fn(batch, anchors: torch.Tensor, uniforms: ts.Uniforms, data: DataAxis):
        dev = anchors.device
        with span(ts.STAGES[0]):
            feats = model.features(prepare_images(batch.images, batch.img_shapes, cfg))
        reg0, anchors1, cls1, reg1 = _refine(model, cfg, feats, anchors, batch.img_shapes)
        b, a_tot = reg0.shape[:2]
        with span(ts.STAGES[1]):
            assigned0 = region_assign(anchors, batch.gt_boxes, batch.gt_valid,
                                      batch.anchor_valid, lvl.get(dev), strides.get(dev),
                                      feat_wh.get(dev), float(cfg.rpn.anchor_scale),
                                      float(cfg.rpn.anchor_strides[0]), num_lvls,
                                      cfg.center_ratio, cfg.ignore_ratio)
            gt_idx0 = (assigned0 - 1).clamp(0, batch.gt_boxes.shape[1] - 1)
            gt0 = torch.gather(batch.gt_boxes, 1, gt_idx0[..., None].expand(-1, -1, 4))
            t = stage1_targets(*uniforms("rpn", a_tot, 2), anchors1, batch.anchor_valid,
                               batch.gt_boxes, batch.gt_valid, cfg.rpn)
        boxes0 = delta_decode(anchors[None], reg0, stds=cfg.s0_stds)
        avg0 = b * data.size * a_tot / 200.0
        loss_s0 = (iou_loss(boxes0.reshape(-1, 4), gt0.reshape(-1, 4), linear=True,
                            reduction="none") * (assigned0 > 0).reshape(-1)).sum() / avg0 * 10.0
        num_total = data.sum(t.num_samples.sum().float()).clamp(min=1.0)
        loss_cls = (binary_cross_entropy_with_logits(cls1, t.is_pos.float(), reduction="none")
                    * t.weights).sum() / num_total
        boxes1 = delta_decode(anchors1, reg1, stds=cfg.s1_stds)
        loss_s1 = (iou_loss(boxes1.reshape(-1, 4), t.gt_box.reshape(-1, 4), linear=True,
                            reduction="none") * t.is_pos.reshape(-1)).sum() / num_total * 10.0
        total = loss_s0 + loss_cls + loss_s1
        return total, {"loss": total, "loss_s0_reg": loss_s0, "loss_s1_cls": loss_cls,
                       "loss_s1_reg": loss_s1, "num_pos": data.sum(t.is_pos.sum().float())}

    return ts._make_step(model, cfg, optimizer, device, loss_fn, mesh=mesh)


class CascadeRPNEvalStep(ts.TwoStageEvalStep):
    """Cascade RPN's eval (the rpn.py simple_test contract): both stages,
    per level the test_nms_pre best stage-1 sigmoid scores (ties by
    index, as lax.top_k), decoded from the refined anchors with the
    stage-1 stds and clipped, the level-grouped NMS at IoU nms_iou_thr
    (0.8): a ProposalResult in original-image coordinates."""

    def forward(self, batch: EvalBatch) -> ProposalResult:
        cfg = self.cfg
        nms_pre = cfg.rpn.test_nms_pre
        with span(ts.STAGES[0]):
            feats = self.model.features(prepare_images(batch.images, batch.img_shapes, cfg))
        _, anchors1, cls1, reg1 = _refine(self.model, cfg, feats, self.anchors,
                                          batch.img_shapes)
        with span(ts.STAGES[2]):
            scs, bxs, lvls = [], [], []
            for li, (s0, s1) in enumerate(cfg.level_bounds()):
                sc = torch.sigmoid(cls1[:, s0:s1])
                reg, anc = reg1[:, s0:s1], anchors1[:, s0:s1]
                n = s1 - s0
                if n > nms_pre:
                    top = torch.sort(sc, dim=1, descending=True, stable=True)
                    sc, idx = top.values[:, :nms_pre], top.indices[:, :nms_pre]
                    reg = torch.gather(reg, 1, idx[..., None].expand(-1, -1, 4))
                    anc = torch.gather(anc, 1, idx[..., None].expand(-1, -1, 4))
                    n = nms_pre
                bxs.append(delta_decode(anc, reg, stds=cfg.s1_stds,
                                        max_shape=batch.img_shapes[:, None, :]))
                scs.append(sc)
                lvls.append(torch.full((n,), li, dtype=torch.long, device=sc.device))
            scores, boxes = torch.cat(scs, dim=1), torch.cat(bxs, dim=1)
            lvl = torch.cat(lvls)[None].expand(scores.shape[0], -1)
            ok = (boxes[..., 2] > boxes[..., 0]) & (boxes[..., 3] > boxes[..., 1])
            dets = grouped_nms(boxes, scores, lvl, ok, cfg.rpn.nms_iou_thr,
                               cfg.rpn.test_max_per_img, self.device_loop)
        return proposal_result(dets.boxes / batch.scale_factors[:, None, :], dets.scores,
                               dets.valid)

