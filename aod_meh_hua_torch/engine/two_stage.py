"""Faster R-CNN engine: proposals, RPN targets, RoI sampling and the
two-stage train and eval steps (torch).

Port of aod_meh_hua_tpu/engine/two_stage.py (`make_proposal_fn` :55-97,
`_rpn_targets_single` :100-119, `_roi_sample_single` :132-167,
`_extract_rois` :170-186, `make_faster_rcnn_train_step` :202-288,
`make_faster_rcnn_eval_step` :291-331), which mirrors the reference's
rpn_head.py:135-200 (per-level sigmoid + top-k, decode, level-grouped NMS
at IoU 0.7), two_stage.py forward_train (RPN losses on 256 sampled
anchors per image, proposals, StandardRoIHead: assign at 0.5 without
low-quality matches, RandomSampler 512 at 0.25 with the gts prepended as
proposals, targets with stds (.1, .1, .2, .2), CE + L1) and the eval's
softmax, per-class decode and multiclass NMS (bbox_head.get_bboxes).

Shapes are fixed as in the JAX package: proposals in [B, max_per_img]
slots with validity, samples in [B, num] slots, jax.vmap an explicit
batch dimension. Randomness: where the JAX step splits its key per
stage, per image and per sampler set, the port's step draws its
uniforms from a `torch.Generator` (`generator_uniforms`), or takes them
from a caller's `uniforms(stage, n)` (a test passes the draws of JAX's
key tree, and the selection is then JAX's index for index).

The train step is engine/train.py's: one forward, one backward, the
optional global-norm clip, one torch-exact SGD step over the non-frozen
parameters. The proposals are computed without gradient, as the
reference's detached proposal_list. Both steps run on the model's device
and take batches of numpy arrays or tensors; a model and config of the
family's variants raise (models/two_stage.py check_two_stage_options).

Each stage runs in a profiler range named in STAGES (a no-op unless
torch.profiler records), so that a trace splits the device time by
stage: chip_smoke.py's Faster R-CNN phase reads them.
"""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..models.two_stage import check_two_stage_options
from ..ops.assigner import max_iou_assign
from ..ops.bbox import delta_decode, delta_encode
from ..ops.losses import binary_cross_entropy_with_logits, softmax_cross_entropy
from ..ops.nms import NMSResult, batched_multiclass_nms, grouped_nms
from ..ops.roi_align import batched_multilevel_roi_align
from ..ops.sampler import random_sample_pos_neg
from ..utils.device import resolve_device
from .batch import AnchorTable, Batch, EvalBatch, as_tensor, prepare_images
from .eval import batch_on
from .train import _clip_by_global_norm

# the profiler ranges of the steps' stages, in order
STAGES = ("faster_rcnn.stage1", "faster_rcnn.rpn_targets", "faster_rcnn.proposals",
          "faster_rcnn.roi_sample", "faster_rcnn.roi_align", "faster_rcnn.roi_head",
          "faster_rcnn.detections")
_span = torch.profiler.record_function

# uniforms(stage, n) -> (u_pos [B, n], u_neg [B, n]): the draws that rank
# the positives and the negatives of each image's n candidates, stage
# "rpn" (the anchors) or "roi" (gts + proposals)
Uniforms = Callable[[str, int], Tuple[torch.Tensor, torch.Tensor]]


def generator_uniforms(generator: torch.Generator, b: int) -> Uniforms:
    """Uniforms drawn from `generator`, on its device: per stage u_pos,
    then u_neg, each [b, n]."""
    def draw(stage: str, n: int):
        return tuple(torch.rand((b, n), generator=generator, device=generator.device)
                     for _ in range(2))

    return draw


def anchor_table(cfg) -> np.ndarray:
    """The RPN anchors of cfg's canvas, all levels, [A, 4] float32."""
    gen = cfg.build_anchor_generator()
    return np.concatenate(gen.grid_anchors(cfg.featmap_sizes())).astype(np.float32)


def make_proposal_fn(cfg) -> Callable:
    """Returns proposals(rpn_cls [B, A], rpn_reg [B, A, 4], anchors [A, 4],
    img_shapes [B, 2], nms_pre, max_out) -> (boxes [B, P, 4], scores
    [B, P], valid [B, P]): per level the nms_pre best sigmoid scores
    (ties by index, as lax.top_k), decoded and clipped to each image,
    then the level-grouped greedy NMS. Call it without gradient."""
    bounds = cfg.level_bounds()

    def proposals(rpn_cls, rpn_reg, anchors, img_shapes, nms_pre: int, max_out: int):
        b = rpn_cls.shape[0]
        scs, bxs, lvls = [], [], []
        for li, (s0, s1) in enumerate(bounds):
            sc = torch.sigmoid(rpn_cls[:, s0:s1])
            reg = rpn_reg[:, s0:s1]
            anc = anchors[s0:s1]
            n = s1 - s0
            if n > nms_pre:
                top = torch.sort(sc, dim=1, descending=True, stable=True)
                sc, idx = top.values[:, :nms_pre], top.indices[:, :nms_pre]
                reg = torch.gather(reg, 1, idx[..., None].expand(-1, -1, 4))
                anc = anc[idx]
                n = nms_pre
            else:
                anc = anc[None].expand(b, -1, -1)
            bxs.append(delta_decode(anc, reg, max_shape=img_shapes))
            scs.append(sc)
            lvls.append(torch.full((n,), li, dtype=torch.long, device=sc.device))
        scores = torch.cat(scs, dim=1)
        boxes = torch.cat(bxs, dim=1)
        lvl = torch.cat(lvls)[None].expand(b, -1)
        # min_bbox_size = 0: strictly positive extents survive
        ok = (boxes[..., 2] > boxes[..., 0]) & (boxes[..., 3] > boxes[..., 1])
        dets = grouped_nms(boxes, scores, lvl, ok, cfg.rpn.nms_iou_thr, max_out)
        return dets.boxes, dets.scores, dets.valid

    return proposals


def _scatter_count(inds: torch.Tensor, values: torch.Tensor, n: int) -> torch.Tensor:
    """Per image, `values` [B, S] added at `inds` [B, S] into n zeros:
    [B, n]. A scatter-add: the unfilled sampler slots all carry index 0
    with value 0 and must not clobber a real sample there."""
    b = inds.shape[0]
    flat = (inds + torch.arange(b, device=inds.device)[:, None] * n).reshape(-1)
    out = torch.zeros(b * n, dtype=values.dtype, device=values.device)
    return out.index_add_(0, flat, values.reshape(-1)).reshape(b, n)


class RPNTargets(NamedTuple):
    is_pos: torch.Tensor        # [B, A] bool (the sampled positives)
    weights: torch.Tensor       # [B, A] float (1 on the sampled anchors)
    bbox_targets: torch.Tensor  # [B, A, 4]
    num_samples: torch.Tensor   # [B] int64


def rpn_targets(u_pos, u_neg, anchors, anchor_valid, gt_boxes, gt_valid, rpn_cfg) -> RPNTargets:
    """Assign (0.7 / 0.3, low-quality matches at 0.3 to every maximal
    anchor) and sample the RPN's anchors of each image."""
    assigned = max_iou_assign(anchors, gt_boxes, gt_valid, anchor_valid=anchor_valid,
                              pos_iou_thr=rpn_cfg.pos_iou_thr, neg_iou_thr=rpn_cfg.neg_iou_thr,
                              min_pos_iou=rpn_cfg.min_pos_iou, gt_max_assign_all=True)
    s = random_sample_pos_neg(u_pos, u_neg, assigned, anchor_valid, rpn_cfg.sampler_num,
                              rpn_cfg.pos_fraction, neg_pos_ub=rpn_cfg.neg_pos_ub)
    a = anchors.shape[0]
    w = _scatter_count(s.inds, s.valid.float(), a)
    pos = _scatter_count(s.inds, (s.is_pos & s.valid).long(), a) > 0
    gt_idx = (assigned - 1).clamp(0, gt_boxes.shape[1] - 1)
    matched = torch.gather(gt_boxes, 1, gt_idx[..., None].expand(-1, -1, 4))
    deltas = delta_encode(anchors, matched, eps=1e-6)
    bbox_t = torch.where(pos[..., None], deltas, torch.zeros_like(deltas))
    return RPNTargets(pos, w, bbox_t, s.valid.sum(dim=1))


class RoISample(NamedTuple):
    rois: torch.Tensor           # [B, S, 4]
    labels: torch.Tensor         # [B, S] int64 (num_classes = background)
    label_weights: torch.Tensor  # [B, S]
    bbox_targets: torch.Tensor   # [B, S, 4] encoded deltas (positive rows)
    is_pos: torch.Tensor         # [B, S] bool
    valid: torch.Tensor          # [B, S] bool
    is_gt: torch.Tensor          # [B, S] bool (a RoI taken from a gt row)
    gt_idx: torch.Tensor         # [B, S] int64 assigned gt (clipped; positive rows)


def roi_sample(u_pos, u_neg, props, prop_valid, gt_boxes, gt_labels, gt_valid,
               cfg) -> RoISample:
    """Assign and sample the RoIs of each image, the gts prepended to the
    proposals (base_sampler.sample's order)."""
    rc = cfg.rcnn
    num_gt = gt_boxes.shape[1]
    cands = torch.cat([gt_boxes, props], dim=1)
    cand_valid = torch.cat([gt_valid, prop_valid], dim=1)
    assigned = max_iou_assign(cands, gt_boxes, gt_valid, anchor_valid=cand_valid,
                              pos_iou_thr=rc.pos_iou_thr, neg_iou_thr=rc.neg_iou_thr,
                              min_pos_iou=rc.min_pos_iou, match_low_quality=False)
    s = random_sample_pos_neg(u_pos, u_neg, assigned, cand_valid, rc.sampler_num,
                              rc.pos_fraction)
    rois = torch.gather(cands, 1, s.inds[..., None].expand(-1, -1, 4))
    gt_idx = (torch.gather(assigned, 1, s.inds) - 1).clamp(0, num_gt - 1)
    labels = torch.where(s.is_pos, torch.gather(gt_labels.long(), 1, gt_idx),
                         torch.full_like(gt_idx, cfg.num_classes))
    matched = torch.gather(gt_boxes, 1, gt_idx[..., None].expand(-1, -1, 4))
    deltas = delta_encode(rois, matched, stds=rc.target_stds, eps=1e-6)
    bbox_t = torch.where(s.is_pos[..., None], deltas, torch.zeros_like(deltas))
    return RoISample(rois, labels, s.valid.float(), bbox_t, s.is_pos, s.valid,
                     (s.inds < num_gt) & s.valid, gt_idx)


def extract_rois(cfg, feats, rois: torch.Tensor) -> torch.Tensor:
    """Multi-level RoIAlign of rois [B, S, 4] over the first
    len(roi_strides) FPN levels: [B * S, roi, roi, C] float32."""
    rc = cfg.rcnn
    return batched_multilevel_roi_align(feats[:len(rc.roi_strides)], rois, rc.roi_strides,
                                        rc.roi_size, rc.sampling_ratio, rc.finest_scale)


def _check_step(model, cfg, device) -> torch.device:
    check_two_stage_options(cfg)
    dev = resolve_device(device)
    param = next(model.parameters())
    if param.device.type != dev.type:
        raise ValueError(f"model is on {param.device}, the step on {dev}")
    return dev


def make_faster_rcnn_train_step(model, cfg, optimizer: torch.optim.Optimizer,
                                device="cuda") -> Callable:
    """Returns step(batch: Batch, generator=None, uniforms=None) -> aux
    (detached scalar tensors on `device`): one forward, one backward and
    one optimizer step on `model`, which lives on `device`. The samplers'
    uniforms come from `uniforms` when given, else from `generator` (a
    torch.Generator on `device`). Where the optimizer carries a
    grad_clip (engine/train.py make_optimizer) the gradients are clipped
    by their global norm first. cfg's canvas fixes the anchor table: one
    step per orientation (cfg.for_orientation)."""
    dev = _check_step(model, cfg, device)
    grad_clip = optimizer.defaults.get("grad_clip")
    proposal_fn = make_proposal_fn(cfg)
    c = cfg.num_classes

    def loss_fn(batch: Batch, anchors: torch.Tensor, uniforms: Uniforms):
        """(total, aux), aux with loss, loss_rpn_cls, loss_rpn_bbox,
        loss_cls, loss_bbox and num_pos (the JAX step's keys)."""
        with _span(STAGES[0]):
            feats, rpn_cls, rpn_reg = model(prepare_images(batch.images, batch.img_shapes, cfg))

        # RPN losses over the sampled anchors
        with _span(STAGES[1]):
            t = rpn_targets(*uniforms("rpn", anchors.shape[0]), anchors, batch.anchor_valid,
                            batch.gt_boxes, batch.gt_valid, cfg.rpn)
        num_total = t.num_samples.sum().float().clamp(min=1.0)
        loss_rpn_cls = (binary_cross_entropy_with_logits(
            rpn_cls, t.is_pos.float(), reduction="none") * t.weights).sum() / num_total
        loss_rpn_bbox = (torch.abs(rpn_reg - t.bbox_targets)
                         * t.is_pos[..., None]).sum() / num_total

        # proposals without gradient (the reference's detached proposal_list)
        with torch.no_grad(), _span(STAGES[2]):
            props, _, prop_valid = proposal_fn(rpn_cls.detach(), rpn_reg.detach(), anchors,
                                               batch.img_shapes, cfg.rpn.train_nms_pre,
                                               cfg.rpn.train_max_per_img)

        # RoI sampling and the second stage's losses
        n_cands = batch.gt_boxes.shape[1] + props.shape[1]
        with _span(STAGES[3]):
            smp = roi_sample(*uniforms("roi", n_cands), props, prop_valid, batch.gt_boxes,
                             batch.gt_labels, batch.gt_valid, cfg)
        with _span(STAGES[4]):
            roi_feats = extract_rois(cfg, feats, smp.rois)
        with _span(STAGES[5]):
            cls, reg = model.roi_forward(roi_feats)
        labels = smp.labels.reshape(-1)
        label_w = smp.label_weights.reshape(-1)
        avg_cls = (label_w > 0).sum().float().clamp(min=1.0)
        loss_cls = (softmax_cross_entropy(cls, labels, reduction="none")
                    * label_w).sum() / avg_cls
        # the class-specific deltas of each row's label, clipped into range
        sel = labels.clamp(0, c - 1)
        reg_sel = torch.gather(reg, 1, sel[:, None, None].expand(-1, 1, 4))[:, 0]
        pos = smp.is_pos.reshape(-1)
        avg_reg = smp.valid.sum().float().clamp(min=1.0)  # the sampled RoIs (bbox_head.py:302)
        loss_bbox = (torch.abs(reg_sel - smp.bbox_targets.reshape(-1, 4))
                     * pos[:, None]).sum() / avg_reg

        total = loss_rpn_cls + loss_rpn_bbox + loss_cls + loss_bbox
        aux = {"loss": total, "loss_rpn_cls": loss_rpn_cls, "loss_rpn_bbox": loss_rpn_bbox,
               "loss_cls": loss_cls, "loss_bbox": loss_bbox, "num_pos": pos.sum().float()}
        return total, aux

    anchors = AnchorTable(anchor_table(cfg))

    def step(batch: Batch, generator: Optional[torch.Generator] = None,
             uniforms: Optional[Uniforms] = None) -> Dict[str, torch.Tensor]:
        b = Batch(images=as_tensor(batch.images, dev),
                  gt_boxes=as_tensor(batch.gt_boxes, dev, torch.float32),
                  gt_labels=as_tensor(batch.gt_labels, dev, torch.long),
                  gt_valid=as_tensor(batch.gt_valid, dev, torch.bool),
                  anchor_valid=as_tensor(batch.anchor_valid, dev, torch.bool),
                  img_shapes=as_tensor(batch.img_shapes, dev))
        if uniforms is None:
            if generator is None:
                raise ValueError("the two-stage step draws its samples: pass a "
                                 "torch.Generator or uniforms")
            uniforms = generator_uniforms(generator, b.images.shape[0])
        model.zero_grad(set_to_none=True)
        total, aux = loss_fn(b, anchors.get(dev), uniforms)
        total.backward()
        if grad_clip:
            _clip_by_global_norm(model.parameters(), grad_clip)
        optimizer.step()
        return {k: v.detach() for k, v in aux.items()}

    return step


def make_faster_rcnn_eval_step(model, cfg, device="cuda") -> Callable:
    """Returns step(batch: EvalBatch) -> NMSResult ([B, max_per_img]
    fields, boxes in original-image coordinates), under torch.no_grad(),
    on `device` where `model` lives: features, proposals (test_nms_pre,
    test_max_per_img), RoIAlign, the box head, softmax, per-class decode
    with the target stds, the rescale, and multiclass NMS over the
    class-specific boxes. The same contract as engine/eval.py
    make_eval_step, so detections_to_per_class reads it."""
    dev = _check_step(model, cfg, device)
    proposal_fn = make_proposal_fn(cfg)
    anchors = torch.from_numpy(anchor_table(cfg)).to(dev)
    t, c = cfg.test, cfg.num_classes

    @torch.no_grad()
    def step(batch: EvalBatch) -> NMSResult:
        batch = batch_on(batch, dev)
        with _span(STAGES[0]):
            feats, rpn_cls, rpn_reg = model(prepare_images(batch.images, batch.img_shapes, cfg))
        with _span(STAGES[2]):
            props, _, prop_valid = proposal_fn(rpn_cls, rpn_reg, anchors, batch.img_shapes,
                                               cfg.rpn.test_nms_pre, cfg.rpn.test_max_per_img)
        with _span(STAGES[4]):
            roi_feats = extract_rois(cfg, feats, props)
        with _span(STAGES[5]):
            cls, reg = model.roi_forward(roi_feats)
        with _span(STAGES[6]):
            b, p = props.shape[:2]
            probs = torch.softmax(cls, dim=-1).reshape(b, p, c + 1)
            boxes = delta_decode(props[:, :, None, :], reg.reshape(b, p, c, 4),
                                 stds=cfg.rcnn.target_stds,
                                 max_shape=batch.img_shapes[:, None, :])
            boxes = boxes / batch.scale_factors[:, None, None, :]
            fg = probs[..., :c] * prop_valid[..., None]
            return batched_multiclass_nms(boxes, fg, t.score_thr, t.nms_iou_thr,
                                          t.max_per_img, t.pre_nms_cands)

    return step
