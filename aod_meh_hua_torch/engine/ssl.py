"""Semi-supervised (pseudo-label) training step, MEH-RetinaNet.

Port of aod_meh_hua_tpu/engine/ssl.py:44-154 (`make_pseudo_loss_fn`,
`make_pseudo_train_step`), which mirrors the reference's
mmdet/models/dense_heads/Lambda_L2.py:122-233 (the unlabeled-batch loss)
and Epoch_Based_Runner_Lambda.py:56-75 (the SSL epoch interleaves a
labeled and an unlabeled step; the unlabeled one also runs the MEH phase
on the real-GT positives, since the simulated pool keeps its VOC
annotations). Per pyramid level and per image:

- anchors whose softmax maximum is >= prob_threshold propose boxes
  (decoded without a border clip, Lambda_L2.py:153);
- multiclass NMS at IoU pseudo_nms_iou, at most max_pseudo, gives the
  pseudo GT, and max_iou_assign re-assigns the anchors to it;
- the L1 box loss regresses the pseudo targets;
- the cls loss is the sigmoid focal loss on the pseudo-logits
  log(p / (1 - p + eps) + eps) of the softmax, whatever cfg.cls_loss says
  (ops/losses.py pseudo_logits's edl_softmax_focal branch is that
  formula), weighted by the Jensen-Shannon divergence to uniform, flipped
  and min/max-scaled over the level's anchors, with the positives at 1;
- the 'cR1' rescale pins each level's cls value to its bbox value,
  keeping the cls gradient's direction.

The JAX function maps one (image, level) with jax.vmap; here the images
of a level form the batch dimension of the port's batched NMS and
assigner. Everything that builds the pseudo targets is computed without
gradient, where the JAX loss takes stop_gradient of it.
"""

from __future__ import annotations

import math
from typing import Callable, Tuple

import numpy as np
import torch

from ..ops.assigner import max_iou_assign
from ..ops.bbox import delta_decode, delta_encode
from ..ops.losses import pseudo_logits, sigmoid_focal_loss_elementwise
from ..ops.nms import NMSResult, batched_multiclass_nms
from .batch import Batch, prepare_images
from .train import _meh_regression, _targets, make_step_of_loss


@torch.no_grad()
def pseudo_detections(cfg, probs: torch.Tensor, reg: torch.Tensor, anchors: torch.Tensor,
                      valid: torch.Tensor, prob_threshold: float = 0.5,
                      pseudo_nms_iou: float = 0.5, max_pseudo: int = 100) -> NMSResult:
    """One level's pseudo GT: probs [B, Al, C] (softmax), reg [B, Al, 4],
    anchors [Al, 4], valid [B, Al] -> NMSResult of [B, max_pseudo]."""
    conf_ok = (probs.amax(dim=-1) >= prob_threshold) & valid
    boxes = delta_decode(anchors, reg, means=cfg.target_means, stds=cfg.target_stds)
    masked = torch.where(conf_ok[..., None], probs, torch.zeros_like(probs))
    cands = min(cfg.test.pre_nms_cands, boxes.shape[1] * probs.shape[-1])
    return batched_multiclass_nms(boxes, masked, prob_threshold, pseudo_nms_iou, max_pseudo,
                                  pre_nms_cands=cands)


@torch.no_grad()
def pseudo_targets(cfg, probs: torch.Tensor, reg: torch.Tensor, anchors: torch.Tensor,
                   valid: torch.Tensor, prob_threshold: float = 0.5,
                   pseudo_nms_iou: float = 0.5, max_pseudo: int = 100
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """One level's pseudo targets from probs [B, Al, C] and reg [B, Al, 4]:
    (pos [B, Al], box targets [B, Al, 4], labels [B, Al] with C the
    background, cls weights w [B, Al])."""
    c = cfg.num_classes
    dets = pseudo_detections(cfg, probs, reg, anchors, valid, prob_threshold,
                             pseudo_nms_iou, max_pseudo)
    assigned = max_iou_assign(
        anchors, dets.boxes, dets.valid, anchor_valid=valid,
        pos_iou_thr=cfg.pos_iou_thr, neg_iou_thr=cfg.neg_iou_thr,
        min_pos_iou=cfg.min_pos_iou, gt_max_assign_all=cfg.gt_max_assign_all)
    pos = (assigned > 0) & valid
    gt_idx = (assigned - 1).clamp(0, max_pseudo - 1)
    pseudo_boxes = torch.gather(dets.boxes, 1, gt_idx[..., None].expand(*gt_idx.shape, 4))
    targets = delta_encode(anchors, pseudo_boxes, means=cfg.target_means,
                           stds=cfg.target_stds, eps=1e-6)
    targets = torch.where(pos[..., None], targets, torch.zeros_like(targets))
    labels = torch.where(pos, torch.gather(dets.labels, 1, gt_idx), torch.full_like(gt_idx, c))
    # JSD-to-uniform weights (Lambda_L2.py:172-184), min/max over each
    # image's anchors of the level
    uni = 1.0 / c
    logp = torch.log(probs.clamp(min=1e-30))
    kld_cu = (uni * (math.log(uni) - logp)).sum(dim=-1)  # KL(u || p)
    kld_uc = (probs * (logp - math.log(uni))).sum(dim=-1)  # KL(p || u)
    jsd = 0.5 * (kld_cu + kld_uc)
    flip = jsd.amax(dim=1, keepdim=True) - jsd
    lo, hi = flip.amin(dim=1, keepdim=True), flip.amax(dim=1, keepdim=True)
    w = (flip - lo) / (hi - lo + 1e-6)
    w = torch.where(pos, torch.ones_like(w), w)
    w = torch.where(valid, w, torch.zeros_like(w))
    return pos, targets, labels, w


def pseudo_level_loss(cfg, cls: torch.Tensor, reg: torch.Tensor, anchors: torch.Tensor,
                      valid: torch.Tensor, prob_threshold: float, pseudo_nms_iou: float,
                      max_pseudo: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One level of every image: (loss_cls_raw, loss_bbox_raw, loss_noR
    [B, Al]) before the division by the real-GT positives.

    At an anchor positive for the pseudo box it proposed itself, the
    target is the encoding of its own decoded box, so |reg - target| is
    rounding noise and the sign of its L1 gradient is arbitrary, in the
    JAX package too (its jitted and eager programs part there)."""
    pos, targets, labels, w = pseudo_targets(
        cfg, torch.softmax(cls.detach(), dim=-1), reg.detach(), anchors, valid,
        prob_threshold, pseudo_nms_iou, max_pseudo)
    loss_bbox = (torch.abs(reg - targets) * pos[..., None]).sum()
    elem = sigmoid_focal_loss_elementwise(pseudo_logits(cls, "edl_softmax_focal"), labels,
                                          gamma=cfg.focal_gamma, alpha=cfg.focal_alpha)
    return (elem * w[..., None]).sum(), loss_bbox, elem.sum(dim=-1)


def make_pseudo_loss_fn(model: torch.nn.Module, cfg, prob_threshold: float = 0.5,
                        pseudo_nms_iou: float = 0.5, max_pseudo: int = 100
                        ) -> Tuple[Callable, np.ndarray]:
    """The unlabeled-batch loss, make_retina_loss_fn's contract: returns
    (loss_fn, anchors_host); loss_fn(batch: Batch of tensors on the
    model's device, anchors [A, 4]) -> (total, aux) with aux's loss,
    loss_cls, loss_bbox, loss_meh and num_pos. The real GT of `batch`
    feeds only the normaliser (its positives) and the MEH weights."""
    gen = cfg.build_anchor_generator()
    anchors_host = np.concatenate(gen.grid_anchors(cfg.featmap_sizes())).astype(np.float32)
    bounds = cfg.level_bounds()

    def loss_fn(batch: Batch, anchors: torch.Tensor):
        cls_scores, bbox_preds, lambdas = model(
            prepare_images(batch.images, batch.img_shapes, cfg))
        t = _targets(cfg, batch, anchors)
        num_total = t.num_pos.sum().float()
        zero = torch.zeros((), dtype=torch.float32, device=cls_scores.device)
        loss_cls = loss_bbox = loss_meh = zero
        for s0, s1 in bounds:
            lc, lb, lnor = pseudo_level_loss(cfg, cls_scores[:, s0:s1], bbox_preds[:, s0:s1],
                                             anchors[s0:s1], batch.anchor_valid[:, s0:s1],
                                             prob_threshold, pseudo_nms_iou, max_pseudo)
            lc, lb = lc / num_total, lb / num_total
            # 'cR1' (Lambda_L2.py:193-195): the cls value pinned to the bbox value
            both = (lb > 0) & (lc > 0)
            scale = torch.where(both, (lb / lc.clamp(min=1e-12)).detach(), torch.ones_like(lc))
            loss_cls = loss_cls + lc * scale
            loss_bbox = loss_bbox + lb
            if lambdas is not None:
                w = t.bbox_weights[:, s0:s1, 0]  # the real-GT positives
                loss_meh = loss_meh + _meh_regression(lambdas[:, s0:s1], lnor.detach(), w,
                                                      cfg.meh_loss)
        total = loss_cls + loss_bbox + loss_meh
        aux = {"loss": total, "loss_cls": loss_cls, "loss_bbox": loss_bbox,
               "loss_meh": loss_meh, "num_pos": num_total}
        return total, aux

    return loss_fn, anchors_host


def make_pseudo_train_step(model: torch.nn.Module, cfg, optimizer: torch.optim.Optimizer,
                           device="cuda") -> Callable:
    """step(batch: Batch) -> aux: one optimizer step on the pseudo-label
    loss (the unlabeled half of the reference's interleaved SSL
    iteration; pair it with engine/train.py make_train_step), with the
    optimizer of create_train_state, as make_train_step takes it."""
    return make_step_of_loss(model, cfg, optimizer, make_pseudo_loss_fn, device)
