"""Training: one step that fuses the supervised and the MEH phases.

Port of aod_meh_hua_tpu/engine/train.py (`frozen_mask`, `make_optimizer`,
`set_learning_rate`, `schedule_lr`, `create_train_state` :52-124,
`_meh_regression` :126-136, `make_loss_fn` :154-158,
`make_retina_loss_fn` :161-219, `make_ssd_loss_fn` :221-275,
`make_train_step` :277-335), which mirrors the reference's
Epoch_Based_Runner_Lambda.py:20-38 (per iteration: the main loss's
backward and SGD step on the trunk, then the MEH loss on the pre-update
per-anchor cls loss, backward and SGD step on the lambda branch),
train_Lambda.py:41-48 (two SGDs with the same lr, momentum and wd),
Lambda_L2.py:106-121, :235-252 and L_anchor_head.py:290-320, and for
SSD My_L_ssd_head.py:182-233 (per-image OHEM cross-entropy, smooth L1,
the unweighted MEH regression).

The MEH branch reads detached FPN features (models/detector.py) and
regresses the detached per-anchor loss `loss_noR`, so the gradient of
loss_cls + loss_bbox + loss_meh splits exactly as the reference's two
backwards: one backward and one SGD update do both phases. Weight decay
and momentum act per parameter, so one torch.optim.SGD over the
non-frozen parameters is update for update the reference's two
optimizers, and the JAX package's optax chain.

Under a data mesh (parallel/mesh.py) each rank runs the step on its rows
of the global batch, and the step is the single-process step on the
whole batch: in JAX the step is one jit over the sharded global batch
(`num_total = t.num_pos.sum()` counts every rank's positives, JAX :174,
:241), so the port all-reduces the normaliser and sums the gradients
(see `DataAxis` and make_step_of_loss).
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..ops.assigner import anchor_targets
from ..ops.losses import (pseudo_logits, sigmoid_focal_loss_elementwise,
                          softmax_cross_entropy)
from ..utils.config import RetinaNetConfig, TrainConfig
from ..utils.device import resolve_device
from .batch import AnchorTable, Batch, as_tensor, prepare_images

_STEM = ("conv1", "bn1")


def frozen_mask(model: torch.nn.Module, frozen_stages: int = 1) -> Dict[str, bool]:
    """Parameter name -> True for the parameters training must not touch:
    the ResNet stem and layer1..layer{frozen_stages} (the reference's
    frozen_stages=1, resnet.py:305). frozen_stages <= 0 freezes nothing."""
    frozen = set(_STEM + tuple(f"layer{i}" for i in range(1, frozen_stages + 1))) \
        if frozen_stages > 0 else set()
    out = {}
    for name, _ in model.named_parameters():
        parts = name.split(".")
        out[name] = parts[0] == "backbone" and parts[1] in frozen
    return out


def make_optimizer(tcfg: TrainConfig, model: torch.nn.Module,
                   frozen_stages: int = 1) -> torch.optim.SGD:
    """torch.optim.SGD(lr, momentum, weight_decay, dampening=0,
    nesterov=False) over the non-frozen parameters: buf = mu * buf +
    (g + wd * p); p -= lr * buf, the JAX package's optax chain. The
    frozen parameters stay out of it, so they see neither weight decay
    nor momentum. tcfg.grad_clip rides along in optimizer.defaults, as
    optax keeps clip_by_global_norm in the chain: make_train_step reads
    it there."""
    if tcfg.optimizer != "sgd":
        raise NotImplementedError(
            f"optimizer={tcfg.optimizer!r}: the port trains with SGD only; AdamW comes "
            "with the DETR family (ROADMAP Queue 1 item 15)")
    mask = frozen_mask(model, frozen_stages)
    opt = torch.optim.SGD([p for name, p in model.named_parameters() if not mask[name]],
                          lr=tcfg.lr, momentum=tcfg.momentum,
                          weight_decay=tcfg.weight_decay, dampening=0.0, nesterov=False)
    opt.defaults["grad_clip"] = tcfg.grad_clip
    return opt


def create_train_state(model: torch.nn.Module, tcfg: TrainConfig,
                       frozen_stages: int = 1) -> torch.optim.SGD:
    """Readies `model` for training and returns its optimizer (the model
    and the optimizer's momentum buffers are the train state).

    The frozen parameters keep requires_grad only when tcfg.grad_clip is
    set: optax's clip_by_global_norm sits before the frozen mask, so its
    global norm counts their gradients too (make_train_step clips by the
    optimizer's grad_clip, which is tcfg's). Otherwise backward skips
    them."""
    mask = frozen_mask(model, frozen_stages)
    for name, p in model.named_parameters():
        p.requires_grad_(not mask[name] or bool(tcfg.grad_clip))
    return make_optimizer(tcfg, model, frozen_stages)


def set_learning_rate(optimizer: torch.optim.Optimizer, lr: float) -> None:
    """Set every parameter group's learning rate."""
    for group in optimizer.param_groups:
        group["lr"] = lr


def schedule_lr(tcfg: TrainConfig, outer_epoch: int, inner_epoch: int) -> float:
    """The reference script's schedule (tools/train_RetinaNet.py:179-200): the lr is
    reset to base each outer epoch and drops x0.1 at lr_step_epoch of the
    final outer epoch only."""
    lr = tcfg.lr
    if outer_epoch == tcfg.outer_epoch - 1 and inner_epoch >= tcfg.lr_step_epoch:
        lr = lr * 0.1
    return lr


class DataAxis:
    """The ranks that split the global batch's rows (the mesh's `data`
    dimension): its process group and size. DataAxis() is one process
    holding the whole batch, where every method is the identity."""

    def __init__(self, group=None, size: int = 1):
        self.group, self.size = group, size
        # this rank's block of the global batch's rows
        self.index = 0 if group is None else dist.get_rank(group)

    def sum(self, t: torch.Tensor) -> torch.Tensor:
        """t summed over the axis (a new tensor, outside autograd)."""
        if self.group is None:
            return t
        t = t.detach().clone()
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=self.group)
        return t

    def sum_with_grad(self, t: torch.Tensor) -> torch.Tensor:
        """t summed over the axis inside autograd: the gradient that reaches
        t is the sum over the ranks of the gradients of the sum, as every
        rank's loss reads the global value."""
        if self.group is None:
            return t
        return _AllReduceSum.apply(t, self.group)

    def gather(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's t (a 1-D tensor of the same length on each),
        concatenated in rank order (outside autograd)."""
        if self.group is None:
            return t
        parts = [torch.empty_like(t) for _ in range(self.size)]
        dist.all_gather(parts, t.detach().contiguous(), group=self.group)
        return torch.cat(parts)


class _AllReduceSum(torch.autograd.Function):
    """all_reduce(SUM) whose backward all-reduces the incoming gradient."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        t = t.clone()
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
        return t

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        dist.all_reduce(grad, op=dist.ReduceOp.SUM, group=ctx.group)
        return grad, None


def _meh_regression(lam: torch.Tensor, target: torch.Tensor, w: torch.Tensor,
                    kind: str) -> torch.Tensor:
    """Per-level MEH loss (Lambda_L2.py:235-252 and the L1/MSLE ablations)."""
    lam = lam + 1e-9
    if kind == "l2":
        return torch.mean((torch.abs(lam - target) * w) ** 2) * 5.0
    if kind == "l1":
        return torch.mean(torch.abs(lam - target) * w)
    if kind == "msle":
        return torch.mean(torch.abs(torch.log(lam + 1.0) - torch.log(target + 1.0)) * w)
    raise ValueError(kind)


def make_retina_loss_fn(model: torch.nn.Module, cfg: RetinaNetConfig,
                        data: Optional[DataAxis] = None) -> Tuple[Callable, np.ndarray]:
    """Returns (loss_fn, anchors_host); loss_fn(batch: Batch of tensors on
    the model's device, anchors [A, 4]) -> (total, aux) with aux's
    loss, loss_cls, loss_bbox, loss_meh and num_pos.

    With a `data` axis, `batch` is this rank's rows of the global batch,
    and the sum of every rank's total is the global batch's loss:
    num_pos is the global count, and the MEH means are this rank's share
    of the global mean."""
    data = data or DataAxis()
    gen = cfg.build_anchor_generator()
    anchors_host = np.concatenate(gen.grid_anchors(cfg.featmap_sizes())).astype(np.float32)
    bounds = cfg.level_bounds()

    def loss_fn(batch: Batch, anchors: torch.Tensor):
        cls_scores, bbox_preds, lambdas = model(
            prepare_images(batch.images, batch.img_shapes, cfg))
        t = _targets(cfg, batch, anchors)
        # trap: the normaliser is global (JAX :174 sums num_pos over the
        # whole sharded batch); a per-rank count is another gradient
        num_total = data.sum(t.num_pos.sum().float())
        elem = sigmoid_focal_loss_elementwise(pseudo_logits(cls_scores, cfg.cls_loss),
                                              t.labels, gamma=cfg.focal_gamma,
                                              alpha=cfg.focal_alpha)  # [B, A, C]
        loss_cls = (elem * t.label_weights[..., None]).sum() / num_total
        # the unreduced per-anchor loss, the MEH regression target (loss_noR)
        loss_nor = elem.sum(dim=-1).detach()  # [B, A]
        loss_bbox = (torch.abs(bbox_preds - t.bbox_targets) * t.bbox_weights).sum() / num_total
        loss_meh = torch.zeros((), dtype=torch.float32, device=cls_scores.device)
        if lambdas is not None:
            w = t.bbox_weights[..., 0]  # Lambda_L2.py:237 weights by the bbox weights
            for s0, s1 in bounds:
                loss_meh = loss_meh + _meh_regression(
                    lambdas[:, s0:s1], loss_nor[:, s0:s1], w[:, s0:s1], cfg.meh_loss)
            # trap: a mean over [B, A_level] (JAX :130); with equal row
            # slices the global mean is the sum of the local means / size
            loss_meh = loss_meh / data.size
        total = loss_cls + loss_bbox + loss_meh
        aux = {"loss": total, "loss_cls": loss_cls, "loss_bbox": loss_bbox,
               "loss_meh": loss_meh, "num_pos": num_total}
        return total, aux

    return loss_fn, anchors_host


def _targets(cfg, batch: Batch, anchors: torch.Tensor):
    return anchor_targets(anchors, batch.anchor_valid, batch.gt_boxes, batch.gt_labels,
                          batch.gt_valid, num_classes=cfg.num_classes,
                          target_means=cfg.target_means, target_stds=cfg.target_stds,
                          pos_iou_thr=cfg.pos_iou_thr, neg_iou_thr=cfg.neg_iou_thr,
                          min_pos_iou=cfg.min_pos_iou,
                          gt_max_assign_all=cfg.gt_max_assign_all)


def ohem_negatives(ce: torch.Tensor, pos: torch.Tensor, neg: torch.Tensor,
                   neg_pos_ratio: int) -> torch.Tensor:
    """The negatives OHEM keeps, [B, A] bool: per image the
    min(neg_pos_ratio * #pos, #neg) negatives of largest CE. Ties go to
    the lower anchor index, as the JAX package's stable
    jnp.argsort(-masked) gives them."""
    num_neg = torch.minimum(neg_pos_ratio * pos.sum(dim=1), neg.sum(dim=1))  # [B]
    masked = torch.where(neg, ce, torch.full_like(ce, -float("inf")))
    order = torch.argsort(-masked, dim=1, stable=True)  # hardest negatives first
    rank = torch.empty_like(order)
    rank.scatter_(1, order, torch.arange(order.shape[1], device=ce.device).expand_as(order))
    return neg & (rank < num_neg[:, None])


def make_ssd_loss_fn(model: torch.nn.Module, cfg,
                     data: Optional[DataAxis] = None) -> Tuple[Callable, np.ndarray]:
    """The SSD loss (make_retina_loss_fn's signature): OHEM softmax CE
    (neg:pos = cfg.neg_pos_ratio) and smooth L1 over the positives, each
    over the total positives; the MEH term regresses lambda onto the
    weighted CE of every anchor (loss_noR, detached): per image the mean
    over all anchors of |lambda + 1e-9 - loss_noR|^2, summed over the
    batch, times cfg.meh_loss_weight, unweighted (the runner never passes
    mineW). `data` as in make_retina_loss_fn."""
    data = data or DataAxis()
    gen = cfg.build_anchor_generator()
    anchors_host = np.concatenate(gen.grid_anchors(cfg.featmap_sizes())).astype(np.float32)
    c = cfg.num_classes

    def loss_fn(batch: Batch, anchors: torch.Tensor):
        cls_scores, bbox_preds, lambdas = model(
            prepare_images(batch.images, batch.img_shapes, cfg))
        t = _targets(cfg, batch, anchors)
        num_total = data.sum(t.num_pos.sum().float())  # trap: global, as in the Retina loss
        ce = softmax_cross_entropy(cls_scores, t.labels, reduction="none") * t.label_weights
        pos = (t.labels < c) & (t.label_weights > 0)
        neg = (t.labels == c) & (t.label_weights > 0)
        # OHEM picks each image's negatives from its own anchors (JAX
        # :249-255), so the choice stays on the rank that holds the image
        sel_neg = ohem_negatives(ce.detach(), pos, neg, cfg.neg_pos_ratio)
        zero = torch.zeros_like(ce)
        loss_cls = (torch.where(pos, ce, zero).sum() + torch.where(sel_neg, ce, zero).sum()) \
            / num_total
        diff = torch.abs(bbox_preds - t.bbox_targets)
        beta = cfg.smoothl1_beta
        sl1 = torch.where(diff < beta, 0.5 * diff * diff / beta, diff - 0.5 * beta)
        loss_bbox = (sl1 * t.bbox_weights).sum() / num_total
        loss_meh = torch.zeros((), dtype=torch.float32, device=cls_scores.device)
        if lambdas is not None:
            err = torch.abs(lambdas + 1e-9 - ce.detach())  # SSD's loss_noR: the weighted CE
            if cfg.meh_weighted:
                err = err * t.bbox_weights[..., 0]
            # a sum over images (JAX :271): the ranks' sums add up, no division
            loss_meh = (err ** 2).mean(dim=1).sum() * cfg.meh_loss_weight
        total = loss_cls + loss_bbox + loss_meh
        aux = {"loss": total, "loss_cls": loss_cls, "loss_bbox": loss_bbox,
               "loss_meh": loss_meh, "num_pos": num_total}
        return total, aux

    return loss_fn, anchors_host


def make_loss_fn(model: torch.nn.Module, cfg,
                 data: Optional[DataAxis] = None) -> Tuple[Callable, np.ndarray]:
    """Family dispatch: the EDL-focal Retina loss or the OHEM-CE SSD loss."""
    if cfg.family == "ssd":
        return make_ssd_loss_fn(model, cfg, data)
    return make_retina_loss_fn(model, cfg, data)


def _clip_by_global_norm(params: Iterable[torch.Tensor], max_norm: float,
                         shard_group=None) -> None:
    """optax.clip_by_global_norm on .grad in place: g * max_norm / norm
    when the global norm exceeds max_norm, g unchanged otherwise. Under
    FSDP (`shard_group`, the mesh's fsdp group) each gradient is a DTensor
    of which this rank holds one shard: the squares of the shards are
    summed over the group."""
    grads = [p.grad for p in params if p.grad is not None]
    if shard_group is None:
        norm = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g) for g in grads]))
    else:
        local = [g.to_local() for g in grads]
        sq = torch.stack([torch.linalg.vector_norm(g) for g in local]).square().sum()
        dist.all_reduce(sq, op=dist.ReduceOp.SUM, group=shard_group)
        norm, grads = sq.sqrt(), local
    scale = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
    torch._foreach_mul_(grads, scale)


def _sum_gradients(params: Iterable[torch.Tensor], data: DataAxis) -> None:
    """Data parallel: every rank's gradient summed over the data axis, in
    place, through one flat buffer (one all_reduce per step). A sum, not
    DDP's mean: each rank's loss already carries the global normaliser.
    Every rank flattens the same parameters: one backward reaches every
    trainable one, the MEH branch included (its input is detached, not
    its weights), and with use_meh=False no rank has the branch. BN is
    frozen (RetinaNet) or absent (SSD), so nothing needs sync-BN."""
    grads = [p.grad for p in params if p.grad is not None]
    flat = torch._utils._flatten_dense_tensors(grads)
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=data.group)
    for g, r in zip(grads, torch._utils._unflatten_dense_tensors(flat, grads)):
        g.copy_(r)


def make_train_step(model: torch.nn.Module, cfg,
                    optimizer: torch.optim.Optimizer, device="cuda", mesh=None) -> Callable:
    """Returns step(batch: Batch) -> aux (detached scalar tensors on
    `device`): one forward, one backward and one optimizer step on
    `model`, which lives on `device` with fused_blocks off (the fused
    kernel has no backward). Where the optimizer carries a grad_clip
    (make_optimizer's TrainConfig.grad_clip), the gradients are clipped
    by their global norm over every parameter that has one, the frozen
    ones included, before the optimizer sees them.

    mesh: a parallel/mesh.py DeviceMesh. `batch` is then this rank's rows
    of the global batch (shard_batch), the model is replicated
    (parallel.replicate: data parallel) or sharded on the mesh's fsdp
    dimension (parallel.shard_params_fsdp), and the step is the global
    batch's step; aux holds the global values."""
    return make_step_of_loss(model, cfg, optimizer, make_loss_fn, device, mesh)


def make_step_of_loss(model: torch.nn.Module, cfg, optimizer: torch.optim.Optimizer,
                      make_loss: Callable, device="cuda", mesh=None) -> Callable:
    """make_train_step around the loss that make_loss(model, cfg) returns,
    a (loss_fn, anchors_host) pair of make_retina_loss_fn's contract;
    under a mesh make_loss(model, cfg, data) must take the DataAxis."""
    dev = resolve_device(device)
    if getattr(cfg, "fused_blocks", False):
        raise ValueError("the fused bottleneck kernel has no backward; train with "
                         "fused_blocks=False")
    param = next(model.parameters())
    if param.device.type != dev.type:
        raise ValueError(f"model is on {param.device}, the step on {dev}")
    grad_clip = optimizer.defaults.get("grad_clip")
    data, shard_group = None, None
    if mesh is None:
        loss_fn, anchors_host = make_loss(model, cfg)
    else:
        from ..parallel.mesh import data_axis_of, fsdp_group_of

        data, shard_group = DataAxis(*data_axis_of(mesh)), fsdp_group_of(mesh)
        loss_fn, anchors_host = make_loss(model, cfg, data)
    anchors = AnchorTable(anchors_host)

    def step(batch: Batch) -> Dict[str, torch.Tensor]:
        b = Batch(images=as_tensor(batch.images, dev),
                  gt_boxes=as_tensor(batch.gt_boxes, dev, torch.float32),
                  gt_labels=as_tensor(batch.gt_labels, dev, torch.long),
                  gt_valid=as_tensor(batch.gt_valid, dev, torch.bool),
                  anchor_valid=as_tensor(batch.anchor_valid, dev, torch.bool),
                  img_shapes=as_tensor(batch.img_shapes, dev))
        model.zero_grad(set_to_none=True)
        total, aux = loss_fn(b, anchors.get(dev))
        total.backward()
        if data is not None:
            if shard_group is None:
                _sum_gradients(model.parameters(), data)
            # under FSDP the backward's reduce-scatter has summed them
            # already (shard_params_fsdp sets its divide factor)
            parts = ("loss", "loss_cls", "loss_bbox", "loss_meh")
            summed = data.sum(torch.stack([aux[k].detach() for k in parts]))
            aux = {**dict(zip(parts, summed.unbind())), "num_pos": aux["num_pos"]}
        # clipping after the reduction, on the global gradient
        if grad_clip:
            _clip_by_global_norm(model.parameters(), grad_clip, shard_group)
        optimizer.step()
        return {k: v.detach() for k, v in aux.items()}

    return step
