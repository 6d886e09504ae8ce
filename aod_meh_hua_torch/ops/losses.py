"""Classification and regression losses of MEH-RetinaNet and MEH-SSD
(torch): focal, the EDL variants, L1, softmax cross-entropy, and Libra
R-CNN's balanced L1, and Cascade RPN's IoU loss.

Port of aod_meh_hua_tpu/ops/losses.py:25-162, :177-200, :238-271 and
:323-352 (`_aligned_iou_terms`, `iou_loss`), which mirrors the
reference's mmdet/models/losses/EDL_Softmax_FocalLoss.py:31-68 (the live
cls loss: softmax -> pseudo-logit -> sigmoid focal loss),
EDL_FocalLoss.py, EDL_ReLU.py, mmcv's sigmoid_focal_loss kernel (per
(anchor, class) terms with integer targets), smooth_l1_loss.py (L1Loss,
the live bbox loss), cross_entropy_loss.py (SSD's and the RoI head's CE
over C+1 columns, the RPN's sigmoid BCE), iou_loss.py (IoULoss) and
utils.py weight_reduce_loss. Labels run over
[0, C], where C is background.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F


def weight_reduce_loss(loss: torch.Tensor, weight: Optional[torch.Tensor] = None,
                       reduction: str = "mean",
                       avg_factor: Optional[torch.Tensor] = None) -> torch.Tensor:
    """mmdet's weight-then-reduce helper. With avg_factor and
    reduction='mean': sum(loss * weight) / avg_factor."""
    if weight is not None:
        if weight.dim() < loss.dim():
            weight = weight.reshape(weight.shape + (1,) * (loss.dim() - weight.dim()))
        loss = loss * weight
    if reduction == "none":
        return loss
    if reduction == "sum":
        return loss.sum()
    if reduction == "mean":
        return loss.mean() if avg_factor is None else loss.sum() / avg_factor
    raise ValueError(f"unknown reduction {reduction!r}")


def _one_hot_fg(labels: torch.Tensor, num_classes: int) -> torch.Tensor:
    """One-hot over the foreground classes; a label outside [0, num_classes)
    (the background num_classes, or a dataset class the model does not
    have) gives a row of zeros, as jax.nn.one_hot does."""
    classes = torch.arange(num_classes, device=labels.device)
    return (labels.long()[..., None] == classes).float()


def sigmoid_focal_loss_elementwise(logits: torch.Tensor, labels: torch.Tensor,
                                   gamma: float = 2.0, alpha: float = 0.25) -> torch.Tensor:
    """Per-(anchor, class) focal terms [..., C]: for the target class
    -alpha (1 - p)^gamma log(p), for the rest -(1 - alpha) p^gamma
    log(1 - p), p = sigmoid(logits), the logs in log-sigmoid form."""
    p = torch.sigmoid(logits)
    t = _one_hot_fg(labels, logits.shape[-1])
    pos = -alpha * torch.pow(1.0 - p, gamma) * F.logsigmoid(logits)
    neg = -(1.0 - alpha) * torch.pow(p, gamma) * F.logsigmoid(-logits)
    return t * pos + (1.0 - t) * neg


def sigmoid_focal_loss(logits, labels, weight=None, gamma: float = 2.0, alpha: float = 0.25,
                       reduction: str = "mean", avg_factor=None) -> torch.Tensor:
    loss = sigmoid_focal_loss_elementwise(logits, labels, gamma=gamma, alpha=alpha)
    return weight_reduce_loss(loss, weight, reduction, avg_factor)


def pseudo_logits(logits: torch.Tensor, cls_loss: str, eps: float = 1e-9) -> torch.Tensor:
    """The logits the sigmoid focal loss sees under each cls loss:
    'edl_softmax_focal' (the live config) p = softmax(logits);
    'edl_focal' p = (relu(logits) + 1) / S (EDL_FocalLoss.py:31-70); both
    then log(p / (1 - p + eps) + eps). 'focal' passes the logits on."""
    if cls_loss == "focal":
        return logits
    if cls_loss == "edl_softmax_focal":
        p = torch.softmax(logits, dim=-1)
    elif cls_loss == "edl_focal":
        conc = torch.relu(logits) + 1.0
        p = conc / conc.sum(dim=-1, keepdim=True)
    else:
        raise ValueError(f"unknown cls_loss {cls_loss!r}")
    return torch.log(p / (1.0 - p + eps) + eps)


def edl_softmax_focal_loss(logits, labels, weight=None, gamma: float = 2.0,
                           alpha: float = 0.25, reduction: str = "mean", avg_factor=None,
                           eps: float = 1e-9, loss_weight: float = 1.0) -> torch.Tensor:
    """The live RetinaNet cls loss: prob = softmax(logits), pseudo-logit
    log(prob / (1 - prob + eps) + eps), then the sigmoid focal loss."""
    pseudo = pseudo_logits(logits, "edl_softmax_focal", eps)
    loss = sigmoid_focal_loss_elementwise(pseudo, labels, gamma=gamma, alpha=alpha)
    return loss_weight * weight_reduce_loss(loss, weight, reduction, avg_factor)


def edl_focal_loss(logits, labels, weight=None, gamma: float = 2.0, alpha: float = 0.25,
                   reduction: str = "mean", avg_factor=None, eps: float = 1e-9,
                   loss_weight: float = 1.0) -> torch.Tensor:
    """EDL_FocalLoss.py: evidence relu(logits), alpha_c = e + 1,
    p = alpha_c / S, focal loss on log(p / (1 - p))."""
    pseudo = pseudo_logits(logits, "edl_focal", eps)
    loss = sigmoid_focal_loss_elementwise(pseudo, labels, gamma=gamma, alpha=alpha)
    return loss_weight * weight_reduce_loss(loss, weight, reduction, avg_factor)


def edl_relu_loss(logits, labels, weight=None, reduction: str = "mean", avg_factor=None,
                  loss_weight: float = 1.0) -> torch.Tensor:
    """EDL_ReLU.py log-likelihood: sum_c y_c (log S - log a_c) with
    a = relu(logits) + 1; per anchor before the reduction."""
    conc = torch.relu(logits) + 1.0
    s = conc.sum(dim=-1, keepdim=True)
    y = _one_hot_fg(labels, logits.shape[-1])
    loss = (y * (torch.log(s) - torch.log(conc))).sum(dim=-1)
    return loss_weight * weight_reduce_loss(loss, weight, reduction, avg_factor)


def l1_loss(pred, target, weight=None, reduction: str = "mean", avg_factor=None,
            loss_weight: float = 1.0) -> torch.Tensor:
    loss = torch.abs(pred - target)
    return loss_weight * weight_reduce_loss(loss, weight, reduction, avg_factor)


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor, weight=None,
                          reduction: str = "mean", avg_factor=None) -> torch.Tensor:
    """Per-anchor softmax CE with integer labels, for heads with an
    explicit background column C (SSD). [..., C+1] logits -> [...] before
    the reduction. A label outside [0, C] is read as jnp's
    take_along_axis(mode="clip") reads it in the JAX package: a negative
    one counts from the end, then the index clamps into range."""
    log_p = torch.log_softmax(logits, dim=-1)
    n = logits.shape[-1]
    idx = labels.long()
    idx = torch.where(idx < 0, idx + n, idx).clamp(0, n - 1)
    loss = -torch.gather(log_p, -1, idx[..., None])[..., 0]
    return weight_reduce_loss(loss, weight, reduction, avg_factor)


def binary_cross_entropy_with_logits(logits: torch.Tensor, targets: torch.Tensor, weight=None,
                                     reduction: str = "mean",
                                     avg_factor=None) -> torch.Tensor:
    """Sigmoid BCE on float targets in the stable form
    max(x, 0) - x * t + log1p(exp(-|x|)) (the reference's
    CrossEntropyLoss(use_sigmoid=True), the RPN's objectness loss)."""
    loss = torch.clamp(logits, min=0.0) - logits * targets \
        + torch.log1p(torch.exp(-torch.abs(logits)))
    return weight_reduce_loss(loss, weight, reduction, avg_factor)


def balanced_l1_loss(pred: torch.Tensor, target: torch.Tensor, weight=None, beta: float = 1.0,
                     alpha: float = 0.5, gamma: float = 1.5, reduction: str = "mean",
                     avg_factor=None, loss_weight: float = 1.0) -> torch.Tensor:
    """Balanced L1 (Libra R-CNN; JAX ops/losses.py:177-200, the reference's
    mmdet/models/losses/balanced_l1_loss.py:12-50). Below beta the
    gradient is promoted logarithmically; above it the loss is gamma-scaled
    L1, the constants chosen so that value and derivative are continuous
    at beta (b such that alpha * ln(b + 1) = gamma)."""
    diff = torch.abs(pred - target)
    b = math.e ** (gamma / alpha) - 1.0
    loss = torch.where(
        diff < beta,
        alpha / b * (b * diff + 1.0) * torch.log1p(b * diff / beta) - alpha * diff,
        gamma * diff + gamma / b - alpha * beta)
    return loss_weight * weight_reduce_loss(loss, weight, reduction, avg_factor)


def aligned_iou(pred: torch.Tensor, target: torch.Tensor, eps: float) -> torch.Tensor:
    """IoU of aligned box pairs pred[i], target[i] (x1, y1, x2, y2): the
    overlap over the union, the union at least eps."""
    lt = torch.maximum(pred[..., :2], target[..., :2])
    rb = torch.minimum(pred[..., 2:], target[..., 2:])
    wh = (rb - lt).clamp(min=0.0)
    overlap = wh[..., 0] * wh[..., 1]
    ap = (pred[..., 2] - pred[..., 0]).clamp(min=0.0) * (pred[..., 3] - pred[..., 1]).clamp(min=0.0)
    at = ((target[..., 2] - target[..., 0]).clamp(min=0.0)
          * (target[..., 3] - target[..., 1]).clamp(min=0.0))
    return overlap / (ap + at - overlap).clamp(min=eps)


def iou_loss(pred: torch.Tensor, target: torch.Tensor, weight=None, linear: bool = False,
             eps: float = 1e-6, reduction: str = "mean", avg_factor=None,
             loss_weight: float = 1.0) -> torch.Tensor:
    """IoULoss (iou_loss.py): -log(iou), or 1 - iou in linear mode, the
    IoU clipped below at eps."""
    ious = aligned_iou(pred, target, eps).clamp(min=eps)
    loss = (1.0 - ious) if linear else -torch.log(ious)
    return loss_weight * weight_reduce_loss(loss, weight, reduction, avg_factor)
