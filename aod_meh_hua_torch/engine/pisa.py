"""PISA (Prime Sample Attention) Faster R-CNN's train step (torch): the
ScoreHLR sampler, ISR-P reweighting and the CARL loss in the RoI head.

Port of the R-CNN half of aod_meh_hua_tpu/engine/pisa.py
(`group_rank_desc` :45-58, `isr_p_label_weights` :61-122,
`carl_loss_dense` :125-143, `_score_hlr_neg` :223-291,
`make_pisa_rcnn_train_step` :301-451), which mirrors the reference's
mmdet/models/roi_heads/pisa_roi_head.py, core/bbox/samplers/
score_hlr_sampler.py and models/losses/pisa_loss.py at
configs/pisa/pisa_faster_rcnn_r50_fpn_1x_coco.py (isr k 2 bias 0, carl
k 1 bias 0.2, hlr k 0.5 bias 0, SmoothL1 beta 1, proposals widened to
2000). PISA RetinaNet's step runs on the retina zoo model, which is not
ported (ROADMAP Queue 1 item 15.5).

The step: Faster R-CNN's stage 1 and RPN losses; the candidates (the
gts, then the proposals) through a no-grad RoI pass (their scores and
deltas); per image the random positives, the ScoreHLR negatives (the
greedy NMS keep set over the valid negatives, score-descending, is
nms_match's group leaders; each box joins its best-scoring covering
leader; the importance num_valid - rank-in-group + max_score ranks the
negatives; the invalid ones are drawn at random to fill) and their
weights, the positives packed first in a random order; the RoI loss with
ISR-P's positive label weights (no gradient), CE, SmoothL1 and CARL,
whose softmax score keeps its gradient.

Randomness: each image takes three uniforms, where the JAX step splits
its per-image key into kp, kn, kpack: the positives' ranks, the invalid
negatives' ranks and the positives' pack order (engine/two_stage.py
`uniforms("roi", n, 3)`). The pack order decides the slot order, and
ISR-P breaks its rank ties by slot index, so a test holds the samples to
JAX's index for index under JAX's key tree. The sorts are stable
(`group_rank_desc`: two stable sorts, the lexsort's order).

Across ranks (a data mesh) the step is the one-process step on the
global batch, as the JAX step is one jit over the sharded batch: ISR-P
ranks the positives of each class over the global batch (each rank's
fixed-length (label, adjusted IoU, positive) rows are gathered in global
order, ranked, and the local slice kept), and max_l_num, the rescale
sums, CARL's normaliser and the loss normalisers are global.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from ..ops.assigner import max_iou_assign
from ..ops.bbox import bbox_overlaps, delta_decode, delta_encode
from ..ops.losses import softmax_cross_entropy
from ..ops.nms import _greedy_keep_sorted
from ..ops.sampler import _ranks
from . import two_stage
from .batch import Batch
from .train import DataAxis
from .two_stage import (PISA_SPAN, STAGES, RoISample, Uniforms, _make_step, _rpn_stage,
                        _span, extract_rois, roi_counts)

_BIG = 2 ** 30
# the fields of Faster R-CNN's other variants that PISA's step does not read
# (JAX make_pisa_rcnn_train_step samples with ScoreHLR, extracts with the
# single-level extractor and regresses with SmoothL1): a config that sets
# one is refused rather than trained without it
_NOT_READ = {"num_bins": None, "balanced_l1_alpha": None, "roi_extractor": "single"}


def group_rank_desc(values: torch.Tensor, group_id: torch.Tensor, mask: torch.Tensor,
                    num_groups: int) -> torch.Tensor:
    """Descending rank (0 = largest) of each masked element WITHIN its
    group, per row of values [..., N] (rows never mix); ties rank by index.
    The JAX function's lexsort (primary the group, masked last; secondary
    the value descending; stable), as two stable sorts. Masked-out
    elements get an arbitrary rank. group_id in [0, num_groups)."""
    shape = values.shape
    n = shape[-1]
    rows = values.numel() // max(n, 1)
    gid = torch.where(mask, group_id.long(),
                      torch.full_like(group_id, num_groups, dtype=torch.long))
    gid = (gid.reshape(rows, n)
           + torch.arange(rows, device=values.device)[:, None] * (num_groups + 1)).reshape(-1)
    by_value = torch.argsort(-values.reshape(-1), stable=True)
    order = by_value[torch.argsort(gid[by_value], stable=True)]
    total = gid.numel()
    pos = torch.empty_like(order)
    pos[order] = torch.arange(total, device=values.device)
    first = torch.full((rows * (num_groups + 1),), total, dtype=torch.long,
                       device=values.device).scatter_reduce(0, gid, pos, "amin")
    return (pos - first[gid]).reshape(shape)


def _iou_aligned(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    x1 = torch.maximum(a[:, 0], b[:, 0])
    y1 = torch.maximum(a[:, 1], b[:, 1])
    x2 = torch.minimum(a[:, 2], b[:, 2])
    y2 = torch.minimum(a[:, 3], b[:, 3])
    inter = (x2 - x1).clamp(min=0) * (y2 - y1).clamp(min=0)
    area_a = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    area_b = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    return inter / (area_a + area_b - inter).clamp(min=1e-6)


@torch.no_grad()
def isr_p_label_weights(cls_scores, deltas, t_labels, t_label_weights, t_bbox_targets, rois,
                        gt_group, num_classes: int, target_stds, k: float, bias: float,
                        data: Optional[DataAxis] = None) -> torch.Tensor:
    """ISR-P's label weights [N] (pisa_loss.py:8-122), the RoI head's
    softmax-CE branch, without gradient: the positives' IoU-HLR ranks (the
    decoded prediction's IoU with its target ranked within its (class,
    gt) group, max_l_num - that rank added, then ranked within its class,
    ties by row), mapped to (max_l_num - rank) / max_l_num, sharpened by
    (bias + w (1 - bias))^k and rescaled so that the positives' CE keeps its weighted
    sum; the negatives keep theirs. deltas [N, 4] at each row's label;
    gt_group [N] the gt index (image * max_gt + gt). Across `data`
    the class ranks, max_l_num and the sums are the global batch's."""
    data = data or DataAxis()
    is_pos = t_labels < num_classes
    pred = delta_decode(rois, deltas, stds=target_stds)
    target = delta_decode(rois, t_bbox_targets, stds=target_stds)
    ious = _iou_aligned(pred, target)
    lab = torch.where(is_pos, t_labels, torch.zeros_like(t_labels))
    counts = data.sum(torch.zeros(num_classes, dtype=torch.long, device=ious.device)
                      .index_add_(0, lab, is_pos.long()))
    max_l_num = counts.max().clamp(min=1).float()
    n = gt_group.shape[0]
    cg = gt_group.clamp(0, n - 1) * num_classes + lab
    t_rank = group_rank_desc(ious, cg, is_pos, n * num_classes)
    ious_adj = ious + (max_l_num - t_rank.float())
    if data.group is None:
        l_rank = group_rank_desc(ious_adj, lab, is_pos, num_classes)
    else:  # ranked within each class over the global batch, in global order
        every = group_rank_desc(data.gather(ious_adj), data.gather(lab),
                                data.gather(is_pos.long()) > 0, num_classes)
        l_rank = every[data.index * n:(data.index + 1) * n]
    w = t_label_weights * (max_l_num - l_rank.float()) / max_l_num
    w = (bias + w * (1.0 - bias)) ** k
    ce = softmax_cross_entropy(cls_scores, t_labels, reduction="none")
    ce = torch.where(is_pos, ce, torch.zeros_like(ce))
    sums = data.sum(torch.stack([(ce * t_label_weights).sum(), (ce * w).sum()]))
    ratio = sums[0] / sums[1].clamp(min=1e-12)
    return torch.where(is_pos, w * ratio, t_label_weights)


def carl_loss_dense(cls_scores, t_labels, deltas, t_bbox_targets, num_classes: int,
                    beta: float, k: float, bias: float, avg_factor,
                    data: Optional[DataAxis] = None) -> torch.Tensor:
    """CARL (pisa_loss.py:125-183), softmax branch: SmoothL1 at `beta` of
    each positive, weighted by (bias + (1 - bias) * its softmax score of
    the target class)^k, the weights normalised to sum to num_pos, over
    avg_factor. The score keeps its gradient (to fc_cls); across `data`
    num_pos and the weights' sum are global, the sum inside autograd."""
    data = data or DataAxis()
    is_pos = t_labels < num_classes
    num_pos = data.sum(is_pos.sum().float())
    sel = t_labels.clamp(0, num_classes - 1)
    score = torch.gather(torch.softmax(cls_scores, dim=-1), 1, sel[:, None])[:, 0]
    w = (bias + (1.0 - bias) * score) ** k
    w = torch.where(is_pos, w, torch.zeros_like(w))
    w = w * (num_pos / data.sum_with_grad(w.sum()).clamp(min=1e-12))
    diff = torch.abs(deltas - t_bbox_targets)
    sl1 = torch.where(diff < beta, 0.5 * diff * diff / beta, diff - 0.5 * beta)
    per = sl1 / torch.as_tensor(avg_factor).clamp(min=1.0)
    return (per * (w * is_pos)[:, None]).sum()


@torch.no_grad()
def score_hlr_neg(u_rand, cands, neg_mask, cls_nograd, delta_nograd, num_expected_neg, cfg):
    """ScoreHLRSampler._sample_neg (score_hlr_sampler.py:101-213) per
    image of [B, N] candidates: (sel_neg [B, N] bool, neg_weight [B, N]).
    The valid negatives (max foreground score above hlr_score_thr) are
    grouped as nms_match groups them (the leaders are the greedy keep set
    over them, score-descending; each box joins its best-scoring leader
    covering it above hlr_iou_thr) and ranked by importance
    num_valid - rank-in-group + max_score; the first num_expected_neg
    (a [B] tensor) are taken, the rest filled with invalid negatives in
    the order of the uniforms u_rand [B, N]; the weights follow their
    importance rank, sharpened, rescaled to keep the background CE's sum;
    an image without a valid negative takes its random ones at weight 1."""
    c, rc = cfg.num_classes, cfg.rcnn
    b, n = neg_mask.shape
    probs = torch.softmax(cls_nograd, dim=-1)
    max_score, argmax_cls = probs[..., :c].max(dim=-1)
    ce_bg = -torch.log(probs[..., c].clamp(min=1e-12))
    valid = neg_mask & (max_score > cfg.hlr_score_thr)
    num_valid = valid.sum(dim=1, keepdim=True)
    sel_delta = torch.gather(delta_nograd.reshape(b, n, c, 4), 2,
                             argmax_cls[..., None, None].expand(b, n, 1, 4))[:, :, 0]
    boxes = delta_decode(cands, sel_delta, stds=rc.target_stds)

    inf = torch.full((), float("inf"), device=boxes.device)
    order = torch.argsort(torch.where(valid, -max_score, inf), dim=1, stable=True)
    keep_sorted = _greedy_keep_sorted(torch.gather(boxes, 1, order[..., None].expand(-1, -1, 4)),
                                      torch.gather(valid, 1, order), cfg.hlr_iou_thr)
    leaders = torch.zeros_like(valid).scatter_(1, order, keep_sorted)
    iou = bbox_overlaps(boxes, boxes).clamp(0.0, 1.0)  # [B, N, N]
    eye = torch.eye(n, dtype=torch.bool, device=boxes.device)
    cover = (leaders[:, None, :] & (iou > cfg.hlr_iou_thr)) | (eye & leaders[:, :, None])
    del iou
    lead_score = torch.where(cover, max_score[:, None, :], -inf)
    group = lead_score.argmax(dim=2)
    del cover, lead_score

    g_rank = group_rank_desc(max_score, group, valid, n)
    imp = num_valid.float() - g_rank.float() + max_score
    imp_rank = group_rank_desc(imp, torch.zeros_like(group), valid, 1)
    num_expected_neg = num_expected_neg[:, None]
    num_hlr = torch.minimum(num_valid, num_expected_neg)
    sel_hlr = valid & (imp_rank < num_hlr)
    invalid = neg_mask & ~valid
    sel_rand = invalid & (_ranks(u_rand, invalid) < num_expected_neg - num_hlr)
    sel_neg = sel_hlr | sel_rand

    up = torch.maximum(num_expected_neg, num_valid).float()
    w_hlr = (up - imp_rank.float()) / up
    min_w = (up - (num_hlr - 1).clamp(min=0).float()) / up
    zero = torch.zeros((), device=up.device)
    w = torch.where(sel_hlr, w_hlr, torch.where(sel_rand, min_w, zero))
    w = (cfg.hlr_bias + (1.0 - cfg.hlr_bias) * w) ** cfg.hlr_k
    ori = (ce_bg * sel_neg).sum(dim=1, keepdim=True)
    new = (ce_bg * w * sel_neg).sum(dim=1, keepdim=True)
    w = w * (ori / new.clamp(min=1e-12))
    w = torch.where(num_valid > 0, w, sel_neg.float())
    return sel_neg, w


def pisa_sample(u, cands, cand_valid, cls_ng, delta_ng, gt_boxes, gt_labels, gt_valid,
                cfg) -> RoISample:
    """PISA's RoI sample of each image of [B, N] candidates (JAX
    sample_single :319-356) on its three uniforms u = (the positives'
    ranks, the invalid negatives', the pack order): up to sampler_num *
    pos_fraction random positives, the ScoreHLR negatives filling the
    rest, packed into sampler_num slots, the positives first in the pack
    order, then the negatives by index. label_weights hold 1 for a
    positive and the ScoreHLR weight for a negative."""
    rc, c = cfg.rcnn, cfg.num_classes
    u_pos, u_neg, u_pack = u
    num_gt = gt_boxes.shape[1]
    assigned = max_iou_assign(cands, gt_boxes, gt_valid, anchor_valid=cand_valid,
                              pos_iou_thr=rc.pos_iou_thr, neg_iou_thr=rc.neg_iou_thr,
                              min_pos_iou=rc.min_pos_iou, match_low_quality=False)
    pos_mask = (assigned > 0) & cand_valid
    neg_mask = (assigned == 0) & cand_valid
    sel_pos = pos_mask & (_ranks(u_pos, pos_mask) < int(rc.sampler_num * rc.pos_fraction))
    sel_neg, neg_w = score_hlr_neg(u_neg, cands, neg_mask, cls_ng, delta_ng,
                                   rc.sampler_num - sel_pos.sum(dim=1), cfg)
    s, n = rc.sampler_num, cands.shape[1]
    neg_pri = torch.where(sel_neg, s + torch.arange(n, device=cands.device),
                          torch.full((), _BIG, device=cands.device))
    priority = torch.where(sel_pos, _ranks(u_pack, sel_pos), neg_pri)
    order = torch.argsort(priority, dim=1, stable=True)[:, :s]
    slot_ok = torch.gather(priority, 1, order) < _BIG
    inds = torch.where(slot_ok, order, 0)
    rois = torch.gather(cands, 1, inds[..., None].expand(-1, -1, 4))
    is_pos = torch.gather(sel_pos, 1, inds) & slot_ok
    gt_idx = (torch.gather(assigned, 1, inds) - 1).clamp(0, num_gt - 1)
    labels = torch.where(is_pos, torch.gather(gt_labels.long(), 1, gt_idx),
                         torch.full_like(gt_idx, c))
    matched = torch.gather(gt_boxes, 1, gt_idx[..., None].expand(-1, -1, 4))
    deltas = delta_encode(rois, matched, stds=rc.target_stds, eps=1e-6)
    bbox_t = torch.where(is_pos[..., None], deltas, torch.zeros_like(deltas))
    zero = torch.zeros((), device=rois.device)
    lw = torch.where(is_pos, torch.ones((), device=rois.device),
                     torch.where(slot_ok, torch.gather(neg_w, 1, inds), zero))
    return RoISample(rois, labels, lw, bbox_t, is_pos, slot_ok,
                     (inds < num_gt) & slot_ok, gt_idx)


def check_pisa_options(cfg) -> None:
    for name, default in _NOT_READ.items():
        if getattr(cfg, name) != default:
            raise ValueError(f"{name}={getattr(cfg, name)!r}: PISA's step samples with ScoreHLR, "
                             "extracts single-level RoIs and regresses with SmoothL1, and reads "
                             "no such field (as the JAX step)")


def make_pisa_rcnn_train_step(model, cfg, optimizer: torch.optim.Optimizer,
                              device="cuda", mesh=None) -> Callable:
    """PISA Faster R-CNN's step (pisa_roi_head.py:34-159), the contract of
    engine/two_stage.py make_faster_rcnn_train_step (uniforms "roi" take 3
    draws): the RPN, the no-grad RoI pass over every candidate, the
    ScoreHLR sample (pisa_sample), the RoI head, ISR-P's weights on the
    CE, SmoothL1 (beta 1) and CARL, each over the global batch's
    normalisers. aux adds loss_carl to Faster R-CNN's keys."""
    check_pisa_options(cfg)
    proposal_fn = two_stage.make_proposal_fn(cfg)
    rc, c = cfg.rcnn, cfg.num_classes

    def loss_fn(batch: Batch, anchors: torch.Tensor, uniforms: Uniforms, data: DataAxis):
        feats, loss_rpn_cls, loss_rpn_bbox, props, prop_valid = _rpn_stage(
            model, cfg, proposal_fn, batch, anchors, uniforms, data)
        b, g = batch.gt_boxes.shape[:2]
        cands = torch.cat([batch.gt_boxes, props], dim=1)
        cand_valid = torch.cat([batch.gt_valid, prop_valid], dim=1)
        p = cands.shape[1]
        with torch.no_grad(), _span(PISA_SPAN):
            cls_ng, delta_ng = model.roi_forward(extract_rois(cfg, [f.detach() for f in feats],
                                                              cands))
            u = uniforms("roi", p, 3)
            smp = pisa_sample(u, cands, cand_valid, cls_ng.reshape(b, p, c + 1),
                              delta_ng.reshape(b, p, -1), batch.gt_boxes, batch.gt_labels,
                              batch.gt_valid, cfg)
        with _span(STAGES[4]):
            roi_feats = extract_rois(cfg, feats, smp.rois)
        with _span(STAGES[5]):
            cls, reg = model.roi_forward(roi_feats)
        labels = smp.labels.reshape(-1)
        sel = labels.clamp(0, c - 1)
        reg_sel = torch.gather(reg, 1, sel[:, None, None].expand(-1, 1, 4))[:, 0]
        rois, bbox_t = smp.rois.reshape(-1, 4), smp.bbox_targets.reshape(-1, 4)
        # the (image, gt) groups lie within one rank: numbered per rank
        gt_group = (torch.arange(b, device=cands.device)[:, None] * g + smp.gt_idx).reshape(-1)
        lw = isr_p_label_weights(cls.detach(), reg_sel.detach(), labels,
                                 smp.label_weights.reshape(-1), bbox_t, rois, gt_group, c,
                                 rc.target_stds, cfg.isr_k, cfg.isr_bias, data)
        smp = smp._replace(label_weights=lw.reshape(b, -1))
        avg_cls, avg_reg, num_pos = roi_counts(smp, data)
        loss_cls = (softmax_cross_entropy(cls, labels, reduction="none") * lw).sum() / avg_cls
        diff = torch.abs(reg_sel - bbox_t)
        sl1 = torch.where(diff < 1.0, 0.5 * diff * diff, diff - 0.5)
        loss_bbox = (sl1 * smp.is_pos.reshape(-1)[:, None]).sum() / avg_reg
        loss_carl = carl_loss_dense(cls, labels, reg_sel, bbox_t, c, 1.0, cfg.carl_k,
                                    cfg.carl_bias, avg_reg, data)
        total = loss_rpn_cls + loss_rpn_bbox + loss_cls + loss_bbox + loss_carl
        aux = {"loss": total, "loss_rpn_cls": loss_rpn_cls, "loss_rpn_bbox": loss_rpn_bbox,
               "loss_cls": loss_cls, "loss_bbox": loss_bbox, "loss_carl": loss_carl,
               "num_pos": num_pos}
        return total, aux

    return _make_step(model, cfg, optimizer, device, loss_fn, mesh=mesh)
