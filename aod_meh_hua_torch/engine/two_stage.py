"""The two-stage engine: proposals, RPN targets, RoI sampling and the
train and eval steps of Faster, Cascade, Dynamic and Double-Head R-CNN
and of the Faster R-CNN variants on the Faster R-CNN step (Libra R-CNN,
PAFPN, CARAFE, GRoIE, empirical attention, HRNet, ResNeSt, FPG, GN+WS;
PISA's step is engine/pisa.py, on this module's stages, and so are the
proposal families' steps and eval modules, engine/rpn_only.py,
cascade_rpn.py, trident.py and grid_rcnn.py, which TRAIN_STEPS and
eval_module dispatch to) (torch).

Port of aod_meh_hua_tpu/engine/two_stage.py: `make_proposal_fn` :55-97,
`_rpn_targets_single` :100-119, `_roi_sample_single` :132-167 (with
Libra's CombinedSampler branch :151-156), `_extract_rois` :170-186,
`_extract_rois_groie` :188-199,
`make_faster_rcnn_train_step` :202-288 (with Libra's balanced L1
:258-263), `make_faster_rcnn_eval_step`
:291-331, `make_cascade_train_step` and `make_cascade_eval_step`
:336-472 (the eval steps as one module, `TwoStageEvalStep`), `init_dynamic_state` (the port's models/two_stage.py
`DynamicState`) and `make_dynamic_rcnn_train_step` :479-625, `_scale_rois`, `_extract_rois_routed` and the Double-Head
train and eval steps :633-784. The Faster R-CNN step mirrors the reference's
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
from a caller's `uniforms(stage, n, k)`, k the draws the stage's sampler
takes (2; Libra R-CNN's RoI sampler 7, PISA's 3): a test passes the draws of
JAX's key tree, and the selection is then JAX's index for index.

Cascade R-CNN (cascade_roi_head.py) samples each of its three stages
anew (stage names "roi0", "roi1", "roi2", where JAX splits k_roi once
per stage) on the previous stage's detached, class-agnostic boxes,
decoded with that stage's stds, its gt rows dropped; its eval averages
the stages' raw logits and takes one softmax. Dynamic R-CNN
(dynamic_roi_head.py) assigns at the model's `dynamic.iou_thr` and
weighs SmoothL1 by `dynamic.beta`, and refreshes both every
update_iter_interval steps from ring buffers on the card, with no read
back to the host. Double-Head R-CNN (double_roi_head.py) extracts the
regression branch's RoIs 1.3x rescaled, routed to their level by the
unscaled RoI, and trains its head's BatchNorm.

The train step is engine/train.py's: one forward, one backward, the
optional global-norm clip, one torch-exact SGD step over the non-frozen
parameters. The proposals are computed without gradient, as the
reference's detached proposal_list. Both steps run on the model's device
and take batches of numpy arrays or tensors; a model and config of a variant
the port lacks raise (models/two_stage.py check_two_stage_options).
Under a data mesh the train step on N ranks is the one-process step on
the global batch, as the JAX step (one jit over the sharded batch,
aod_meh_hua_tpu/parallel/mesh.py) is: the global batch's uniforms, every
normaliser and Dynamic R-CNN's two statistics over the global batch, the
double head's BatchNorm on the global batch's statistics, gradients
summed (_make_step).

The eval step is one module for every family (TwoStageEvalStep): the
eager step and the step that torch.export traces
(tools/deployment/export_model.py) are the same code, the NMS fixpoints
a device while_loop in the latter.

Each stage runs in a profiler range named in STAGES (a no-op unless
torch.profiler records), so that a trace splits the device time by
stage: chip_smoke.py's two-stage phases read them. An exported program
holds no range (utils/profiling.py span).
"""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

import importlib

from ..models import cascade_rpn as _crpn, grid_rcnn as _grid
from ..models.trident import BRANCH_SPAN
from ..models.two_stage import (CONV_BRANCH_SPAN, FASTER_RCNN_VARIANTS, GROIE_SPAN,
                                VARIANT_SPANS, check_two_stage_options)
from ..ops.assigner import max_iou_assign
from ..ops.bbox import bbox_overlaps, delta_decode, delta_encode
from ..ops.losses import (balanced_l1_loss, binary_cross_entropy_with_logits,
                          softmax_cross_entropy)
from ..ops.nms import NMSResult, batched_multiclass_nms, grouped_nms
from ..ops.roi_align import batched_multilevel_roi_align
from ..ops.sampler import libra_sample_pos_neg, random_sample_pos_neg
from ..utils.device import resolve_device
from ..utils.profiling import span as _span
from .batch import AnchorTable, Batch, EvalBatch, as_tensor, prepare_images
from .eval import batch_on
from .train import DataAxis, _clip_by_global_norm, _sum_gradients

# the profiler ranges of the steps' stages, in order: the Faster R-CNN
# stages every family shares, then the cascade's refinement, Dynamic
# R-CNN's statistics, the double head's rescaled extraction and conv
# branch, and the ranges of the Faster R-CNN variants' modules (the
# backbone's attention, the CARAFE reassembly, the BFP, GRoIE's fusion),
# each inside the stage that runs it, PISA's no-grad RoI pass and sampler,
# and the proposal families' own modules (Cascade RPN's deform conv, the
# tridented stage 3, the grid head) and stages (Cascade RPN's region
# assignment and refinement, Grid R-CNN's targets and refinement)
# PISA's no-grad RoI pass over every candidate and its ScoreHLR sampler
# (engine/pisa.py)
PISA_SPAN = "pisa.score_hlr"
STAGES = ("faster_rcnn.stage1", "faster_rcnn.rpn_targets", "faster_rcnn.proposals",
          "faster_rcnn.roi_sample", "faster_rcnn.roi_align", "faster_rcnn.roi_head",
          "faster_rcnn.detections", "cascade_rcnn.refine", "dynamic_rcnn.statistics",
          "double_head_rcnn.roi_align_reg", CONV_BRANCH_SPAN) + VARIANT_SPANS + (
    PISA_SPAN, _crpn.DEFORM_SPAN, _crpn.REFINE_SPAN, BRANCH_SPAN, _grid.GRID_SPAN,
    _grid.TARGETS_SPAN, _grid.REFINE_SPAN)

# uniforms(stage, n, k) -> k draws [B, n] that rank each image's n
# candidates of stage "rpn" (the anchors), "roi" (gts + proposals) or the
# cascade's "roi{i}": k is what the stage's sampler takes, 2 for the
# random sampler (u_pos, u_neg) and LIBRA_DRAWS for Libra R-CNN's
Uniforms = Callable[[str, int, int], Tuple[torch.Tensor, ...]]
# Libra's RoI sampler: kp1, kp2, kp3, kp4, kn1, kn2, km (ops/sampler.py)
LIBRA_DRAWS = 7
# PISA's: kp, kn, kpack (engine/pisa.py pisa_sample)
PISA_DRAWS = 3


def generator_uniforms(generator: torch.Generator, b: int) -> Uniforms:
    """Uniforms drawn from `generator`, on its device: per stage its k
    draws in turn, each [b, n]."""
    def draw(stage: str, n: int, k: int):
        return tuple(torch.rand((b, n), generator=generator, device=generator.device)
                     for _ in range(k))

    return draw


def roi_draws(cfg) -> int:
    """The uniforms cfg's RoI sampler takes per stage."""
    if cfg.family == "pisa_faster_rcnn":
        return PISA_DRAWS
    return LIBRA_DRAWS if cfg.num_bins else 2


def anchor_table(cfg) -> np.ndarray:
    """The RPN anchors of cfg's canvas, all levels, [A, 4] float32."""
    gen = cfg.build_anchor_generator()
    return np.concatenate(gen.grid_anchors(cfg.featmap_sizes())).astype(np.float32)


def make_proposal_fn(cfg, device_loop: bool = False) -> Callable:
    """Returns proposals(rpn_cls [B, A], rpn_reg [B, A, 4], anchors [A, 4],
    img_shapes [B, 2], nms_pre, max_out) -> (boxes [B, P, 4], scores
    [B, P], valid [B, P]): per level the nms_pre best sigmoid scores
    (ties by index, as lax.top_k), decoded and clipped to each image,
    then the level-grouped greedy NMS (its fixpoint a device while_loop
    with `device_loop`, for torch.export). Call it without gradient."""
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
        dets = grouped_nms(boxes, scores, lvl, ok, cfg.rpn.nms_iou_thr, max_out, device_loop)
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


def roi_sample(u, props, prop_valid, gt_boxes, gt_labels, gt_valid,
               cfg, pos_iou_thr=None, stds=None) -> RoISample:
    """Assign and sample the RoIs of each image, the gts prepended to the
    proposals (base_sampler.sample's order): the random sampler on u =
    (u_pos, u_neg), or, where cfg.num_bins is set, Libra R-CNN's
    CombinedSampler on its seven draws u, with each candidate's max IoU
    over the valid gts (0 for an invalid candidate; JAX :151-156).
    `pos_iou_thr` (a float or a 0-d tensor: Dynamic R-CNN's) and `stds`
    override cfg.rcnn's for the cascade's stages and Dynamic R-CNN, where
    the negative and minimum-positive thresholds follow the positive one."""
    rc = cfg.rcnn
    thr = rc.pos_iou_thr if pos_iou_thr is None else pos_iou_thr
    stds = rc.target_stds if stds is None else stds
    num_gt = gt_boxes.shape[1]
    cands = torch.cat([gt_boxes, props], dim=1)
    cand_valid = torch.cat([gt_valid, prop_valid], dim=1)
    assigned = max_iou_assign(cands, gt_boxes, gt_valid, anchor_valid=cand_valid,
                              pos_iou_thr=thr,
                              neg_iou_thr=rc.neg_iou_thr if pos_iou_thr is None else thr,
                              min_pos_iou=rc.min_pos_iou if pos_iou_thr is None else thr,
                              match_low_quality=False)
    if cfg.num_bins:
        zero = torch.zeros((), device=cands.device)
        ov = torch.where(gt_valid[..., None], bbox_overlaps(gt_boxes, cands), zero)
        max_ov = torch.where(cand_valid, ov.amax(dim=1), zero)
        s = libra_sample_pos_neg(u, assigned, cand_valid, max_ov, rc.sampler_num,
                                 rc.pos_fraction, num_gt=num_gt, num_bins=cfg.num_bins)
    else:
        s = random_sample_pos_neg(*u, assigned, cand_valid, rc.sampler_num, rc.pos_fraction)
    rois = torch.gather(cands, 1, s.inds[..., None].expand(-1, -1, 4))
    gt_idx = (torch.gather(assigned, 1, s.inds) - 1).clamp(0, num_gt - 1)
    labels = torch.where(s.is_pos, torch.gather(gt_labels.long(), 1, gt_idx),
                         torch.full_like(gt_idx, cfg.num_classes))
    matched = torch.gather(gt_boxes, 1, gt_idx[..., None].expand(-1, -1, 4))
    deltas = delta_encode(rois, matched, stds=stds, eps=1e-6)
    bbox_t = torch.where(s.is_pos[..., None], deltas, torch.zeros_like(deltas))
    return RoISample(rois, labels, s.valid.float(), bbox_t, s.is_pos, s.valid,
                     (s.inds < num_gt) & s.valid, gt_idx)


def extract_rois(cfg, feats, rois: torch.Tensor,
                 routing_rois: Optional[torch.Tensor] = None,
                 roi_size: Optional[int] = None) -> torch.Tensor:
    """Multi-level RoIAlign of rois [B, S, 4] over the first
    len(roi_strides) FPN levels: [B * S, roi, roi, C] float32, each RoI
    on the level of its routing RoI (itself by default); roi_size
    overrides cfg.rcnn.roi_size (Grid R-CNN's grid branch extracts at 14)."""
    rc = cfg.rcnn
    return batched_multilevel_roi_align(feats[:len(rc.roi_strides)], rois, rc.roi_strides,
                                        rc.roi_size if roi_size is None else roi_size,
                                        rc.sampling_ratio, rc.finest_scale,
                                        routing_rois=routing_rois)


def extract_rois_groie(model, cfg, feats, rois: torch.Tensor) -> torch.Tensor:
    """GRoIE's GenericRoIExtractor (JAX _extract_rois_groie :188-199,
    generic_roi_extractor.py:44-85): every RoI of rois [B, S, 4] aligned
    on EVERY level at 1 / stride, with no finest_scale routing (one
    single-level batched RoIAlign per level, its RoIs in blocks), then the
    model's fusion (shared pre-conv, sum, post attention; the profiler
    range GROIE_SPAN): [B * S, roi, roi, C] float32."""
    rc = cfg.rcnn
    per_level = [batched_multilevel_roi_align([feats[i]], rois, [stride], rc.roi_size,
                                              rc.sampling_ratio)
                 for i, stride in enumerate(rc.roi_strides)]
    with _span(GROIE_SPAN):
        return model.groie_fuse(per_level)


def roi_features(model, cfg, feats, rois: torch.Tensor) -> torch.Tensor:
    """The RoI features of cfg's extractor in the RoIAlign range
    (STAGES[4]): GRoIE's (extract_rois_groie) or the routed single-level
    one (extract_rois)."""
    with _span(STAGES[4]):
        if cfg.roi_extractor == "groie":
            return extract_rois_groie(model, cfg, feats, rois)
        return extract_rois(cfg, feats, rois)


def scale_rois(rois: torch.Tensor, factor: float) -> torch.Tensor:
    """Each RoI's width and height times `factor` about its center
    (single_level_roi_extractor.py roi_rescale; JAX _scale_rois)."""
    cx = (rois[..., 0] + rois[..., 2]) * 0.5
    cy = (rois[..., 1] + rois[..., 3]) * 0.5
    hw = (rois[..., 2] - rois[..., 0]) * (0.5 * factor)
    hh = (rois[..., 3] - rois[..., 1]) * (0.5 * factor)
    return torch.stack([cx - hw, cy - hh, cx + hw, cy + hh], dim=-1)


def _check_step(model, cfg, device) -> torch.device:
    check_two_stage_options(cfg)
    dev = resolve_device(device)
    param = next(model.parameters())
    if param.device.type != dev.type:
        raise ValueError(f"model is on {param.device}, the step on {dev}")
    return dev


def _device_batch(batch: Batch, dev) -> Batch:
    """The batch on `dev`: a Batch, or Fast R-CNN's ProposalBatch
    (engine/rpn_only.py)."""
    if hasattr(batch, "proposals"):
        from .rpn_only import ProposalBatch

        return ProposalBatch(images=as_tensor(batch.images, dev),
                             gt_boxes=as_tensor(batch.gt_boxes, dev, torch.float32),
                             gt_labels=as_tensor(batch.gt_labels, dev, torch.long),
                             gt_valid=as_tensor(batch.gt_valid, dev, torch.bool),
                             img_shapes=as_tensor(batch.img_shapes, dev),
                             proposals=as_tensor(batch.proposals, dev, torch.float32),
                             prop_valid=as_tensor(batch.prop_valid, dev, torch.bool))
    return Batch(images=as_tensor(batch.images, dev),
                 gt_boxes=as_tensor(batch.gt_boxes, dev, torch.float32),
                 gt_labels=as_tensor(batch.gt_labels, dev, torch.long),
                 gt_valid=as_tensor(batch.gt_valid, dev, torch.bool),
                 anchor_valid=as_tensor(batch.anchor_valid, dev, torch.bool),
                 img_shapes=as_tensor(batch.img_shapes, dev))


def rpn_loss(rpn_cls, rpn_reg, t: RPNTargets, data: DataAxis):
    """The RPN's BCE over its sampled anchors and L1 over the positives,
    each over the global batch's sample count: (loss_cls, loss_bbox)."""
    num_total = data.sum(t.num_samples.sum().float()).clamp(min=1.0)
    loss_cls = (binary_cross_entropy_with_logits(
        rpn_cls, t.is_pos.float(), reduction="none") * t.weights).sum() / num_total
    loss_bbox = (torch.abs(rpn_reg - t.bbox_targets) * t.is_pos[..., None]).sum() / num_total
    return loss_cls, loss_bbox


def _rpn_stage(model, cfg, proposal_fn, batch: Batch, anchors, uniforms: Uniforms,
               data: DataAxis):
    """Stage 1 of every family's train step: the features, the RPN's two
    losses over its sampled anchors, and the proposals without gradient
    (the reference's detached proposal_list): (feats, loss_rpn_cls,
    loss_rpn_bbox, props, prop_valid). The losses divide by the global
    batch's sample count (`data`)."""
    with _span(STAGES[0]):
        feats, rpn_cls, rpn_reg = model(prepare_images(batch.images, batch.img_shapes, cfg))
    with _span(STAGES[1]):
        t = rpn_targets(*uniforms("rpn", anchors.shape[0], 2), anchors, batch.anchor_valid,
                        batch.gt_boxes, batch.gt_valid, cfg.rpn)
    loss_rpn_cls, loss_rpn_bbox = rpn_loss(rpn_cls, rpn_reg, t, data)
    with torch.no_grad(), _span(STAGES[2]):
        props, _, prop_valid = proposal_fn(rpn_cls.detach(), rpn_reg.detach(), anchors,
                                           batch.img_shapes, cfg.rpn.train_nms_pre,
                                           cfg.rpn.train_max_per_img)
    return feats, loss_rpn_cls, loss_rpn_bbox, props, prop_valid


def _sample(cfg, batch: Batch, uniforms: Uniforms, stage: str, props, prop_valid,
            **kw) -> RoISample:
    n_cands = batch.gt_boxes.shape[1] + props.shape[1]
    with _span(STAGES[3]):
        return roi_sample(uniforms(stage, n_cands, roi_draws(cfg)), props, prop_valid,
                          batch.gt_boxes, batch.gt_labels, batch.gt_valid, cfg, **kw)


def roi_counts(smp: RoISample, data: DataAxis):
    """A sample's normalisers over the global batch, in one all-reduce:
    (avg_cls, the RoIs with label weight; avg_reg, the sampled RoIs,
    bbox_head.py:302's avg_factor; each at least 1), and num_pos."""
    c = data.sum(torch.stack([(smp.label_weights > 0).sum(), smp.valid.sum(),
                              smp.is_pos.sum()]).float())
    return c[0].clamp(min=1.0), c[1].clamp(min=1.0), c[2]


def _cls_loss(cls, smp: RoISample, avg_cls) -> torch.Tensor:
    """Softmax CE over the sampled RoIs, averaged over those with weight."""
    label_w = smp.label_weights.reshape(-1)
    return (softmax_cross_entropy(cls, smp.labels.reshape(-1), reduction="none")
            * label_w).sum() / avg_cls


def _reg_of_labels(reg, smp: RoISample, c: int) -> torch.Tensor:
    """The class-specific deltas [R, C, 4] of each row's label (clipped
    into range): [R, 4]."""
    sel = smp.labels.reshape(-1).clamp(0, c - 1)
    return torch.gather(reg, 1, sel[:, None, None].expand(-1, 1, 4))[:, 0]


def _positive_mean(err, smp: RoISample, avg_reg) -> torch.Tensor:
    """err [R, 4] summed over the positive rows, over the sampled RoIs."""
    return (err * smp.is_pos.reshape(-1)[:, None]).sum() / avg_reg


def _rank_rows(uniforms: Uniforms, lo: int, b: int) -> Uniforms:
    """The global batch's uniforms -> rows lo:lo + b, this rank's images."""
    return lambda stage, n, k: tuple(u[lo:lo + b] for u in uniforms(stage, n, k))


def _make_step(model, cfg, optimizer, device, loss_fn, after=None, mesh=None) -> Callable:
    """The train step around loss_fn(batch, anchors, uniforms, data) ->
    (total, aux): the batch on the device, the uniforms, one backward, the
    optional clip, one optimizer step, then after(aux) (Dynamic R-CNN's
    refresh); the detached aux out.

    Under a data mesh (parallel/mesh.py; data parallel, the model
    replicated) `batch` is this rank's rows of the global batch
    (shard_batch) and the step is the one-process step on the global
    batch, as the JAX step is one jit over the sharded batch: the
    uniforms are the global batch's (every rank draws them all from the
    same seeded generator) and each rank keeps its rows, so that it
    samples what the one process samples for its images; every loss
    divides by the global normaliser (DataAxis.sum); the gradients are
    summed, never averaged, and clipped after the sum; aux holds the
    global values (the losses summed over the ranks)."""
    dev = _check_step(model, cfg, device)
    grad_clip = optimizer.defaults.get("grad_clip")
    anchors = AnchorTable(anchor_table(cfg))
    if mesh is None:
        data = DataAxis()
    else:
        from ..parallel.mesh import data_axis_of

        data = DataAxis(*data_axis_of(mesh))

    def step(batch: Batch, generator: Optional[torch.Generator] = None,
             uniforms: Optional[Uniforms] = None) -> Dict[str, torch.Tensor]:
        b = _device_batch(batch, dev)
        rows = b.images.shape[0]
        if uniforms is None:
            if generator is None:
                raise ValueError("the two-stage step draws its samples: pass a "
                                 "torch.Generator or uniforms")
            uniforms = generator_uniforms(generator, rows * data.size)
        if data.group is not None:
            uniforms = _rank_rows(uniforms, data.index * rows, rows)
        model.zero_grad(set_to_none=True)
        total, aux = loss_fn(b, anchors.get(dev), uniforms, data)
        total.backward()
        if data.group is not None:
            _sum_gradients(model.parameters(), data)
            losses = [k for k in aux if "loss" in k]
            summed = data.sum(torch.stack([aux[k].detach() for k in losses]))
            aux = {**aux, **dict(zip(losses, summed.unbind()))}
        if grad_clip:
            _clip_by_global_norm(model.parameters(), grad_clip)
        optimizer.step()
        if after is not None:
            after(aux)
        return {k: v.detach() for k, v in aux.items() if not k.startswith("_")}

    return step


def make_faster_rcnn_train_step(model, cfg, optimizer: torch.optim.Optimizer,
                                device="cuda", mesh=None) -> Callable:
    """Returns step(batch: Batch, generator=None, uniforms=None) -> aux
    (detached scalar tensors on `device`): one forward, one backward and
    one optimizer step on `model`, which lives on `device`. The samplers'
    uniforms come from `uniforms` when given, else from `generator` (a
    torch.Generator on `device`). Where the optimizer carries a
    grad_clip (engine/train.py make_optimizer) the gradients are clipped
    by their global norm first. cfg's canvas fixes the anchor table: one
    step per orientation (cfg.for_orientation). mesh: a data mesh
    (_make_step); `uniforms` then gives the global batch's draws."""
    proposal_fn = make_proposal_fn(cfg)
    c = cfg.num_classes

    def loss_fn(batch: Batch, anchors: torch.Tensor, uniforms: Uniforms, data: DataAxis):
        """(total, aux), aux with loss, loss_rpn_cls, loss_rpn_bbox,
        loss_cls, loss_bbox and num_pos (the JAX step's keys)."""
        feats, loss_rpn_cls, loss_rpn_bbox, props, prop_valid = _rpn_stage(
            model, cfg, proposal_fn, batch, anchors, uniforms, data)
        smp = _sample(cfg, batch, uniforms, "roi", props, prop_valid)
        avg_cls, avg_reg, num_pos = roi_counts(smp, data)
        roi_feats = roi_features(model, cfg, feats, smp.rois)
        with _span(STAGES[5]):
            cls, reg = model.roi_forward(roi_feats)
        loss_cls = _cls_loss(cls, smp, avg_cls)
        reg_sel, targets = _reg_of_labels(reg, smp, c), smp.bbox_targets.reshape(-1, 4)
        if cfg.balanced_l1_alpha is not None:  # Libra (JAX :258-263)
            err = balanced_l1_loss(reg_sel, targets, reduction="none",
                                   alpha=cfg.balanced_l1_alpha, gamma=cfg.balanced_l1_gamma,
                                   beta=cfg.balanced_l1_beta)
        else:
            err = torch.abs(reg_sel - targets)
        loss_bbox = _positive_mean(err, smp, avg_reg)
        total = loss_rpn_cls + loss_rpn_bbox + loss_cls + loss_bbox
        aux = {"loss": total, "loss_rpn_cls": loss_rpn_cls, "loss_rpn_bbox": loss_rpn_bbox,
               "loss_cls": loss_cls, "loss_bbox": loss_bbox, "num_pos": num_pos}
        return total, aux

    return _make_step(model, cfg, optimizer, device, loss_fn, mesh=mesh)


def make_cascade_train_step(model, cfg, optimizer: torch.optim.Optimizer,
                            device="cuda", mesh=None) -> Callable:
    """Cascade R-CNN's step (cascade_roi_head.forward_train +
    refine_bboxes), the contract of make_faster_rcnn_train_step: the RPN,
    then num_stages RoI stages, stage i sampled under uniforms "roi{i}"
    at stage_pos_iou_thrs[i] with stage_stds[i], its class-agnostic
    losses weighed by stage_loss_weights[i], each over its own global
    counts. Each next stage takes this stage's sampled RoIs decoded by its
    detached deltas and clipped, the rows taken from gts dropped. aux:
    loss, loss_rpn_cls, loss_rpn_bbox, s{i}.loss_cls, s{i}.loss_bbox and
    num_pos (over all stages)."""
    proposal_fn = make_proposal_fn(cfg)

    def loss_fn(batch: Batch, anchors: torch.Tensor, uniforms: Uniforms, data: DataAxis):
        feats, loss_rpn_cls, loss_rpn_bbox, props, prop_valid = _rpn_stage(
            model, cfg, proposal_fn, batch, anchors, uniforms, data)
        b = props.shape[0]
        total = loss_rpn_cls + loss_rpn_bbox
        aux = {"loss_rpn_cls": loss_rpn_cls, "loss_rpn_bbox": loss_rpn_bbox}
        num_pos = torch.zeros((), device=props.device)
        for stage in range(cfg.num_stages):
            stds = cfg.stage_stds[stage]
            smp = _sample(cfg, batch, uniforms, f"roi{stage}", props, prop_valid,
                          pos_iou_thr=cfg.stage_pos_iou_thrs[stage], stds=stds)
            avg_cls, avg_reg, stage_pos = roi_counts(smp, data)  # every stage, on every rank
            with _span(STAGES[4]):
                roi_feats = extract_rois(cfg, feats, smp.rois)
            with _span(STAGES[5]):
                cls, reg = model.roi_forward(roi_feats, stage)
            loss_cls = _cls_loss(cls, smp, avg_cls)
            loss_bbox = _positive_mean(torch.abs(reg[:, 0] - smp.bbox_targets.reshape(-1, 4)),
                                       smp, avg_reg)
            total = total + cfg.stage_loss_weights[stage] * (loss_cls + loss_bbox)
            aux[f"s{stage}.loss_cls"] = loss_cls
            aux[f"s{stage}.loss_bbox"] = loss_bbox
            num_pos = num_pos + stage_pos
            if stage < cfg.num_stages - 1:
                with torch.no_grad(), _span(STAGES[7]):
                    props = delta_decode(smp.rois, reg[:, 0].detach().reshape(b, -1, 4),
                                         stds=stds, max_shape=batch.img_shapes[:, None, :])
                    prop_valid = smp.valid & ~smp.is_gt
        aux["loss"] = total
        aux["num_pos"] = num_pos
        return total, aux

    return _make_step(model, cfg, optimizer, device, loss_fn, mesh=mesh)


# the refresh keeps the beta when the median is below this (dynamic_roi_head.py:143)
DYNAMIC_EPS = 1e-15


def even_median(x: torch.Tensor) -> torch.Tensor:
    """The median of a 1-D tensor as jnp.median takes it: the mean of the
    two middle values of an even-length one (torch.median returns the
    lower), computed as (lo + hi) * 0.5."""
    s = torch.sort(x).values
    n = s.shape[0]
    return (s[(n - 1) // 2] + s[n // 2]) * 0.5


def beta_statistic(targets: torch.Tensor, pos: torch.Tensor, k_max: int,
                   initial_beta: float, data: Optional[DataAxis] = None) -> torch.Tensor:
    """Dynamic R-CNN's per-step beta statistic (dynamic_roi_head.py:119-125,
    JAX :568-575): the min(k_max, num_pos)-th smallest mean |dx|, |dy|
    target over the positives, initial_beta with none. Across a `data`
    axis the positives are every rank's: each rank's fixed-length
    where(pos, xy, inf) is gathered, so every rank selects the same
    global value (k_max is then beta_topk times the global batch). The
    k-th value is a gather at a device index, so nothing is read back to
    the host."""
    data = data or DataAxis()
    xy = torch.abs(targets[:, :2]).mean(dim=1)
    xy_all = data.gather(torch.where(pos, xy, torch.full_like(xy, float("inf"))))
    num_pos = torch.isfinite(xy_all).sum()
    xy_sorted = torch.sort(xy_all).values
    k = num_pos.clamp(max=k_max).clamp(min=1)
    return torch.where(num_pos > 0, xy_sorted.gather(0, (k - 1).reshape(1))[0],
                       torch.full_like(xy[0], initial_beta))


def make_dynamic_rcnn_train_step(model, cfg, optimizer: torch.optim.Optimizer,
                                 device="cuda", mesh=None) -> Callable:
    """Faster R-CNN's step with Dynamic R-CNN's adapting hyperparameters
    (dynamic_roi_head.py), on `model.dynamic`'s buffers: the RoI assigner
    samples at iou_thr and SmoothL1 weighs by beta; each step writes its
    IoU statistic (the iou_topk-th largest proposal max-IoU of each
    image, averaged over the global batch) and its beta statistic (the
    min(beta_topk * B, num_pos)-th smallest mean |dx|, |dy| target of the
    global batch's positives, the initial beta with none) into ring slot
    step % interval, and the step in slot interval - 1 refreshes iou_thr
    to max(initial_iou, mean) and beta to min(initial_beta, median) (the
    old beta kept where the median is below DYNAMIC_EPS). All of it stays
    on the device, and across ranks it is the same on every rank. aux
    adds iou_thr and beta, the step's values."""
    dyn = model.dynamic
    proposal_fn = make_proposal_fn(cfg)
    interval, c = cfg.update_iter_interval, cfg.num_classes

    def loss_fn(batch: Batch, anchors: torch.Tensor, uniforms: Uniforms, data: DataAxis):
        feats, loss_rpn_cls, loss_rpn_bbox, props, prop_valid = _rpn_stage(
            model, cfg, proposal_fn, batch, anchors, uniforms, data)
        b_global = props.shape[0] * data.size
        with torch.no_grad(), _span(STAGES[8]):
            ov = torch.where(batch.gt_valid[..., None], bbox_overlaps(batch.gt_boxes, props),
                             torch.zeros((), device=props.device))
            max_iou = torch.where(prop_valid, ov.amax(dim=1), torch.zeros((), device=ov.device))
            k_iou = min(cfg.iou_topk, max_iou.shape[1])
            cur_iou = data.sum(torch.topk(max_iou, k_iou, dim=1).values[:, -1].sum()) / b_global
        iou_thr, beta = dyn.iou_thr.clone(), dyn.beta.clone()
        smp = _sample(cfg, batch, uniforms, "roi", props, prop_valid, pos_iou_thr=iou_thr)
        avg_cls, avg_reg, num_pos = roi_counts(smp, data)
        with _span(STAGES[4]):
            roi_feats = extract_rois(cfg, feats, smp.rois)
        with _span(STAGES[5]):
            cls, reg = model.roi_forward(roi_feats)
        loss_cls = _cls_loss(cls, smp, avg_cls)
        targets = smp.bbox_targets.reshape(-1, 4)
        diff = torch.abs(_reg_of_labels(reg, smp, c) - targets)
        loss_bbox = _positive_mean(torch.where(diff < beta, 0.5 * diff * diff / beta,
                                               diff - 0.5 * beta), smp, avg_reg)
        with torch.no_grad(), _span(STAGES[8]):
            cur_beta = beta_statistic(targets, smp.is_pos.reshape(-1), cfg.beta_topk * b_global,
                                      cfg.initial_beta, data)
        total = loss_rpn_cls + loss_rpn_bbox + loss_cls + loss_bbox
        aux = {"loss": total, "loss_rpn_cls": loss_rpn_cls, "loss_rpn_bbox": loss_rpn_bbox,
               "loss_cls": loss_cls, "loss_bbox": loss_bbox, "num_pos": num_pos,
               "iou_thr": iou_thr, "beta": beta, "_cur_iou": cur_iou, "_cur_beta": cur_beta}
        return total, aux

    @torch.no_grad()
    def refresh(aux):
        with _span(STAGES[8]):
            idx = dyn.step % interval
            slot = torch.arange(interval, device=idx.device) == idx
            iou_hist = torch.where(slot, aux["_cur_iou"], dyn.iou_hist)
            beta_hist = torch.where(slot, aux["_cur_beta"], dyn.beta_hist)
            now = idx == interval - 1
            med = even_median(beta_hist)
            new_beta = torch.where(med < DYNAMIC_EPS, dyn.beta, med.clamp(max=cfg.initial_beta))
            dyn.iou_thr.copy_(torch.where(now, iou_hist.mean().clamp(min=cfg.initial_iou),
                                          dyn.iou_thr))
            dyn.beta.copy_(torch.where(now, new_beta, dyn.beta))
            dyn.iou_hist.copy_(iou_hist)
            dyn.beta_hist.copy_(beta_hist)
            dyn.step.add_(1)

    return _make_step(model, cfg, optimizer, device, loss_fn, after=refresh, mesh=mesh)


def _double_extract(cfg, feats, rois):
    """The double head's two extractions: the classification branch's at
    the RoIs, the regression branch's at the RoIs rescaled by
    reg_roi_scale_factor, each routed to its level by the unscaled RoI."""
    with _span(STAGES[4]):
        cls_feats = extract_rois(cfg, feats, rois)
    with _span(STAGES[9]):
        reg_feats = extract_rois(cfg, feats, scale_rois(rois, cfg.reg_roi_scale_factor),
                                 routing_rois=rois)
    return cls_feats, reg_feats


def make_double_head_train_step(model, cfg, optimizer: torch.optim.Optimizer,
                                device="cuda", mesh=None) -> Callable:
    """Double-Head R-CNN's step (double_roi_head.py:16-33 and
    dh_faster_rcnn_r50_fpn_1x_coco.py), the contract of
    make_faster_rcnn_train_step: the two extractions, the head with its
    BatchNorm in training (its running statistics move, flax's way; under
    a mesh by the global batch's statistics), CE and SmoothL1 (beta 1) at
    weights cls_loss_weight and bbox_loss_weight."""
    proposal_fn = make_proposal_fn(cfg)
    c = cfg.num_classes

    def loss_fn(batch: Batch, anchors: torch.Tensor, uniforms: Uniforms, data: DataAxis):
        feats, loss_rpn_cls, loss_rpn_bbox, props, prop_valid = _rpn_stage(
            model, cfg, proposal_fn, batch, anchors, uniforms, data)
        smp = _sample(cfg, batch, uniforms, "roi", props, prop_valid)
        avg_cls, avg_reg, num_pos = roi_counts(smp, data)
        cls_feats, reg_feats = _double_extract(cfg, feats, smp.rois)
        with _span(STAGES[5]):
            cls, reg = model.roi_forward(cls_feats, reg_feats, train=True, data=data)
        loss_cls = cfg.cls_loss_weight * _cls_loss(cls, smp, avg_cls)
        diff = torch.abs(_reg_of_labels(reg, smp, c) - smp.bbox_targets.reshape(-1, 4))
        loss_bbox = cfg.bbox_loss_weight * _positive_mean(
            torch.where(diff < 1.0, 0.5 * diff * diff, diff - 0.5), smp, avg_reg)
        total = loss_rpn_cls + loss_rpn_bbox + loss_cls + loss_bbox
        aux = {"loss": total, "loss_rpn_cls": loss_rpn_cls, "loss_rpn_bbox": loss_rpn_bbox,
               "loss_cls": loss_cls, "loss_bbox": loss_bbox, "num_pos": num_pos}
        return total, aux

    return _make_step(model, cfg, optimizer, device, loss_fn, mesh=mesh)


def make_pisa_rcnn_train_step(model, cfg, optimizer: torch.optim.Optimizer,
                              device="cuda", mesh=None) -> Callable:
    """PISA Faster R-CNN's step (engine/pisa.py, which builds on this
    module)."""
    from .pisa import make_pisa_rcnn_train_step as make

    return make(model, cfg, optimizer, device=device, mesh=mesh)


def _step_of(module: str, name: str) -> Callable:
    """The maker `name` of this package's `module` (the proposal families'
    steps, engine/rpn_only.py, cascade_rpn.py, trident.py, grid_rcnn.py,
    which build on this module), imported when it is called."""
    def make(model, cfg, optimizer, device="cuda", mesh=None):
        return getattr(importlib.import_module(f"{__package__}.{module}"), name)(
            model, cfg, optimizer, device=device, mesh=mesh)

    return make


# family -> its train step's maker (the JAX trainer's make_steps,
# tools/train_detector.py:128-192: the Faster R-CNN variants take Faster
# R-CNN's step, PISA and the proposal families their own)
TRAIN_STEPS = {"cascade_rcnn": make_cascade_train_step,
               "dynamic_rcnn": make_dynamic_rcnn_train_step,
               "double_head_rcnn": make_double_head_train_step,
               **{family: make_faster_rcnn_train_step for family in FASTER_RCNN_VARIANTS},
               "pisa_faster_rcnn": make_pisa_rcnn_train_step,
               "rpn": _step_of("rpn_only", "make_rpn_train_step"),
               "cascade_rpn": _step_of("cascade_rpn", "make_crpn_train_step"),
               "tridentnet": _step_of("trident", "make_trident_train_step"),
               "fast_rcnn": _step_of("rpn_only", "make_fast_rcnn_train_step"),
               "grid_rcnn": _step_of("grid_rcnn", "make_grid_rcnn_train_step")}


def step_draws(cfg) -> Dict[str, Tuple[int, int]]:
    """stage -> (n, k): the uniforms cfg's family's train step asks its
    source for, k draws [B, n] per stage (`Uniforms`): the RPN's anchors
    ("rpn"), the RoI candidates ("roi", the cascade's "roi{i}"), Trident's
    per branch ("rpn{r}", "roi{r}"), Grid R-CNN's jitter ("jitter", four
    per sampled RoI, one draw)."""
    family = cfg.family
    n_anchor = cfg.level_bounds()[-1][1]
    n_props = cfg.max_gt + cfg.rpn.train_max_per_img
    if family in ("rpn", "cascade_rpn"):
        return {"rpn": (n_anchor, 2)}
    if family == "fast_rcnn":
        return {"roi": (cfg.max_gt + cfg.num_proposals, 2)}
    if family == "tridentnet":
        out = {}
        for r in range(len(cfg.trident_dilations)):
            out[f"rpn{r}"] = (n_anchor, 2)
            out[f"roi{r}"] = (cfg.rpn.train_max_per_img, 2)
        return out
    if family == "cascade_rcnn":
        return {"rpn": (n_anchor, 2), **{
            f"roi{i}": (n_props if i == 0 else cfg.max_gt + cfg.rcnn.sampler_num, 2)
            for i in range(cfg.num_stages)}}
    out = {"rpn": (n_anchor, 2), "roi": (n_props, roi_draws(cfg))}
    if family == "grid_rcnn":
        out["jitter"] = (cfg.rcnn.sampler_num * 4, 1)
    return out


def make_two_stage_train_step(model, cfg, optimizer, device="cuda", mesh=None) -> Callable:
    """cfg's family's train step (on a data mesh with `mesh`)."""
    return TRAIN_STEPS[cfg.family](model, cfg, optimizer, device=device, mesh=mesh)


def cascade_refine(model, cfg, feats, props, img_shapes):
    """Every cascade stage on props [B, P, 4] (cascade_roi_head.simple_test):
    each stage scores and refines the boxes with its class-agnostic
    deltas and stds, clipped to img_shapes. Returns (the last stage's
    boxes [B, P, 4], the stages' raw logits averaged [B, P, C + 1])."""
    b, p = props.shape[:2]
    logits = None
    for stage in range(cfg.num_stages):
        with _span(STAGES[4]):
            roi_feats = extract_rois(cfg, feats, props)
        with _span(STAGES[5]):
            cls, reg = model.roi_forward(roi_feats, stage)
        logits = cls if logits is None else logits + cls
        with _span(STAGES[7]):
            props = delta_decode(props, reg[:, 0].reshape(b, p, 4), stds=cfg.stage_stds[stage],
                                 max_shape=img_shapes[:, None, :])
    return props, (logits / cfg.num_stages).reshape(b, p, -1)


class TwoStageEvalStep(torch.nn.Module):
    """The eval step of every two-stage family as a module (engine/eval.py
    EvalStep's contract): forward(batch: EvalBatch of tensors on the
    model's device) -> NMSResult ([B, max_per_img] fields, boxes in
    original-image coordinates), so detections_to_per_class reads it. The
    features and the test proposals (test_nms_pre, test_max_per_img), then
    the family's RoI stage:
    - faster_rcnn (and dynamic_rcnn, whose statistics buffers ride along
      unused): RoIAlign, the box head, softmax, the per-class decode with
      the target stds, the rescale, multiclass NMS over the class-specific
      boxes;
    - cascade_rcnn: every stage in turn (cascade_refine), the last
      stage's boxes under one softmax of the stages' averaged raw logits
      (the reference sums the cls_score logits, cascade_roi_head.py:329-332,
      and get_bboxes takes one softmax), then multiclass NMS over the
      class-agnostic boxes;
    - double_head_rcnn: Faster R-CNN's with the double extraction and the
      head's BatchNorm at its running statistics.

    The anchor table is a buffer. The eager steps run it under
    torch.no_grad() (make_two_stage_eval_step); torch.export traces it
    with `device_loop`, which runs every NMS fixpoint (the proposals', the
    detections') as a device-side while_loop where the eager step checks
    for convergence on the host: the same detections. Each stage runs in
    its profiler range (STAGES) eagerly; the exported program holds none."""

    _ROI_STAGES = {"cascade_rcnn": "_cascade", "double_head_rcnn": "_double_head"}

    def __init__(self, model, cfg, device_loop: bool = False):
        super().__init__()
        check_two_stage_options(cfg)
        self.model, self.cfg, self.device_loop = model, cfg, device_loop
        self.proposals = make_proposal_fn(cfg, device_loop)
        self.roi_stage = getattr(self, self._ROI_STAGES.get(cfg.family, "_faster"))
        device = next(model.parameters()).device
        self.register_buffer("anchors", torch.from_numpy(anchor_table(cfg)).to(device))

    def forward(self, batch: EvalBatch) -> NMSResult:
        cfg = self.cfg
        with _span(STAGES[0]):
            feats, rpn_cls, rpn_reg = self.model(prepare_images(batch.images, batch.img_shapes,
                                                                cfg))
        with _span(STAGES[2]):
            props, _, prop_valid = self.proposals(rpn_cls, rpn_reg, self.anchors,
                                                  batch.img_shapes, cfg.rpn.test_nms_pre,
                                                  cfg.rpn.test_max_per_img)
        return self.roi_stage(feats, props, prop_valid, batch)

    def _nms(self, boxes, fg) -> NMSResult:
        t = self.cfg.test
        return batched_multiclass_nms(boxes, fg, t.score_thr, t.nms_iou_thr, t.max_per_img,
                                      t.pre_nms_cands, self.device_loop)

    def _class_specific(self, props, prop_valid, cls, reg, batch: EvalBatch) -> NMSResult:
        """Softmax, the per-class decode with the target stds, the rescale to
        the original image, and multiclass NMS over the class-specific boxes."""
        cfg, c = self.cfg, self.cfg.num_classes
        b, p = props.shape[:2]
        with _span(STAGES[6]):
            probs = torch.softmax(cls, dim=-1).reshape(b, p, c + 1)
            boxes = delta_decode(props[:, :, None, :], reg.reshape(b, p, c, 4),
                                 stds=cfg.rcnn.target_stds, max_shape=batch.img_shapes[:, None, :])
            boxes = boxes / batch.scale_factors[:, None, None, :]
            return self._nms(boxes, probs[..., :c] * prop_valid[..., None])

    def _faster(self, feats, props, prop_valid, batch: EvalBatch) -> NMSResult:
        roi_feats = roi_features(self.model, self.cfg, feats, props)
        with _span(STAGES[5]):
            cls, reg = self.model.roi_forward(roi_feats)
        return self._class_specific(props, prop_valid, cls, reg, batch)

    def _cascade(self, feats, props, prop_valid, batch: EvalBatch) -> NMSResult:
        c = self.cfg.num_classes
        boxes, logits = cascade_refine(self.model, self.cfg, feats, props, batch.img_shapes)
        with _span(STAGES[6]):
            fg = torch.softmax(logits, dim=-1)[..., :c] * prop_valid[..., None]
            return self._nms(boxes / batch.scale_factors[:, None, :], fg)

    def _double_head(self, feats, props, prop_valid, batch: EvalBatch) -> NMSResult:
        cls_feats, reg_feats = _double_extract(self.cfg, feats, props)
        with _span(STAGES[5]):
            cls, reg = self.model.roi_forward(cls_feats, reg_feats, train=False)
        return self._class_specific(props, prop_valid, cls, reg, batch)


# family -> (module of this package, its eval module's class): the proposal
# families' (each a TwoStageEvalStep with its own forward); the others take
# TwoStageEvalStep itself
_EVAL_MODULES = {"rpn": ("rpn_only", "RPNEvalStep"),
                 "cascade_rpn": ("cascade_rpn", "CascadeRPNEvalStep"),
                 "tridentnet": ("trident", "TridentEvalStep"),
                 "grid_rcnn": ("grid_rcnn", "GridRCNNEvalStep")}
FAST_RCNN_EVAL = ("fast_rcnn eval needs external proposals: use "
                  "engine.rpn_only.make_fast_rcnn_eval_step(model, cfg)(batch, proposals, "
                  "prop_valid), the reference's proposal_file contract "
                  "(detectors/fast_rcnn.py)")


def eval_module(model, cfg, device_loop: bool = False) -> TwoStageEvalStep:
    """cfg's family's eval module: TwoStageEvalStep, or the proposal
    family's subclass of it (RPN-only and Cascade RPN give a
    ProposalResult). Fast R-CNN's takes proposals from outside
    (engine/rpn_only.py make_fast_rcnn_eval_step) and raises here."""
    if cfg.family == "fast_rcnn":
        raise ValueError(FAST_RCNN_EVAL)
    if cfg.family in _EVAL_MODULES:
        module, name = _EVAL_MODULES[cfg.family]
        cls = getattr(importlib.import_module(f"{__package__}.{module}"), name)
        return cls(model, cfg, device_loop)
    return TwoStageEvalStep(model, cfg, device_loop)


def make_two_stage_eval_step(model, cfg, device="cuda") -> Callable:
    """Returns step(batch: EvalBatch) -> NMSResult ([B, max_per_img]
    fields, boxes in original-image coordinates; a ProposalResult of the
    same fields for RPN-only and Cascade RPN): cfg's family's eval module
    (eval_module) under torch.no_grad(), on `device` where `model` lives,
    on a batch of numpy arrays or tensors. The same contract as
    engine/eval.py make_eval_step."""
    dev = _check_step(model, cfg, device)
    module = eval_module(model, cfg)

    @torch.no_grad()
    def step(batch: EvalBatch) -> NMSResult:
        return module(batch_on(batch, dev))

    return step


# the Faster R-CNN eval step's name (a TwoStageEvalStep, as every family's)
make_faster_rcnn_eval_step = make_two_stage_eval_step
# family -> its eval step's maker (JAX api.py make_eval_step_for)
EVAL_STEPS = {family: make_two_stage_eval_step for family in TRAIN_STEPS}
