"""Pool scoring: forward -> per-level top-k -> decode -> NMS -> membership
-> Dirichlet MI -> HUA (Entropy_NMS), or forward -> full-map softmax ->
Dirichlet MI -> scale/class HUA (Entropy_ALL, Entropy_NoNMS).

Port of aod_meh_hua_tpu/engine/score.py (`_mi_fn` :35-47,
`make_nms_output_core` :49-98, `make_output_scorer` :101-126,
`make_scale_core` :129-169, `make_scale_output_scorer` :172-189,
`make_score_step` :192-244), which mirrors the reference's
apis/test.py:90-135 and Lambda_L2.py:254-384, :489-537, :539-569,
:597-619, :636-691. Runs eagerly under torch.no_grad(); the step returns
one [B] score vector and one [B] max-confidence vector on the device.

The MI is closed-form by default. With hua.mi_mode="sampled" it is the
reference's Monte-Carlo estimate, and every step takes an explicit
torch.Generator on the step's device (where the JAX steps take a key),
shared by the images of a batch.
"""

from __future__ import annotations

import functools
from typing import Callable, Optional

import torch

from ..ops.dirichlet import dirichlet_mi_sampled, dirichlet_mutual_information
from ..ops.hua import hua_object_scores, hua_scale_scores, object_membership, parse_agg_spec
from ..ops.nms import batched_multiclass_nms
from ..utils.config import RetinaNetConfig
from ..utils.device import resolve_device
from .batch import AnchorTable, EvalBatch, as_tensor, prepare_images
from .postprocess import make_candidate_selector

_UNC_TYPES = {"epistemic": "epistemic", "aleatoric": "aleatoric", "total": "total",
              "shannon": "total"}
_MI_MODES = ("closed", "sampled")


def _check_mi_mode(cfg: RetinaNetConfig) -> None:
    if cfg.hua.mi_mode not in _MI_MODES:
        raise ValueError(f"hua.mi_mode={cfg.hua.mi_mode!r}: expected one of {_MI_MODES}")


def _mi_fn(cfg: RetinaNetConfig, generator: Optional[torch.Generator]) -> Callable:
    """Closed-form MI, or the seeded Monte-Carlo estimate in sampled mode,
    which needs a generator."""
    if cfg.hua.mi_mode == "sampled":
        if generator is None:
            raise ValueError("hua.mi_mode='sampled' needs a torch.Generator")
        return functools.partial(dirichlet_mi_sampled, generator=generator,
                                 num_samples=cfg.hua.mi_samples, chunk=cfg.hua.mi_chunk)
    return dirichlet_mutual_information


def make_nms_output_core(cfg: RetinaNetConfig, select) -> Callable:
    """The Entropy_NMS core on raw head outputs: (cls_scores [B, A, C],
    bbox_preds [B, A, 4], lambdas [B, A], img_shapes [B, 2],
    scale_factors [B, 4], anchors [A, 4], generator=None) ->
    (unc [B], maxconf [B])."""
    _check_mi_mode(cfg)
    agg = parse_agg_spec(cfg.hua.agg)
    hua = cfg.hua
    t = cfg.test
    unc_type = _UNC_TYPES[hua.unc_type.lower()]

    def core(cls_scores, bbox_preds, lambdas, img_shapes, scale_factors, anchors,
             generator: Optional[torch.Generator] = None):
        mi_fn = _mi_fn(cfg, generator)
        cand = select(anchors, cls_scores, bbox_preds, lambdas, img_shapes)
        # the reference pool sweep runs rescale=True (apis/test.py:115)
        boxes = cand.boxes / scale_factors[:, None, :]
        dets = batched_multiclass_nms(boxes, cand.scores[..., :cfg.num_fg_classes],
                                      t.score_thr, t.nms_iou_thr, t.max_per_img,
                                      t.pre_nms_cands)
        member = object_membership(boxes, dets.boxes, dets.scores, dets.valid,
                                   score_thr=hua.obj_score_thr, iou_thr=hua.memb_iou_thr)
        unc = hua_object_scores(
            cand.scores, cand.lambdas, member, level_bounds=cand.bounds, agg=agg,
            fg_score_thr=hua.fg_score_thr, lambda_eps=hua.lambda_eps,
            lambda_scale=hua.lambda_scale, unc_type=unc_type, mi_fn=mi_fn,
            num_fg_classes=cfg.num_fg_classes, agg_order=hua.agg_order,
            cls_weight=hua.cls_weight)
        return unc, cand.max_prob

    return core


def make_scale_core(cfg: RetinaNetConfig) -> Callable:
    """The Entropy_ALL / Entropy_NoNMS core on raw head outputs:
    (cls_scores [B, A, C] logits over the FULL maps, lambdas [B, A] or
    None, generator=None) -> unc [B]. Entropy_ALL rescales the alphas by
    the full-map lambda mean; Entropy_NoNMS passes no lambdas."""
    _check_mi_mode(cfg)
    agg = parse_agg_spec(cfg.hua.agg)
    hua = cfg.hua
    unc_type = _UNC_TYPES[hua.unc_type.lower()]
    full_bounds = cfg.level_bounds()

    def core(cls_scores, lambdas, generator: Optional[torch.Generator] = None):
        mi_fn = _mi_fn(cfg, generator)
        levels = [torch.softmax(cls_scores[:, s0:s1], dim=-1) for s0, s1 in full_bounds]
        lams = None if lambdas is None else [lambdas[:, s0:s1] for s0, s1 in full_bounds]
        return hua_scale_scores(
            levels, lams, agg, fg_score_thr=hua.fg_score_thr, lambda_eps=hua.lambda_eps,
            lambda_scale=hua.lambda_scale, unc_type=unc_type, mi_fn=mi_fn,
            num_fg_classes=cfg.num_fg_classes)

    return core


def make_output_scorer(cfg: RetinaNetConfig, device="cuda") -> Callable:
    """Entropy_NMS scorer over raw head outputs (no model forward):
    step(cls_scores, bbox_preds, lambdas, img_shapes, scale_factors,
    generator=None) -> (unc [B], maxconf [B]) on `device`. Arrays may be
    numpy or tensors."""
    dev = resolve_device(device)
    select, anchors_host = make_candidate_selector(cfg)
    core = make_nms_output_core(cfg, select)
    anchors = AnchorTable(anchors_host)

    @torch.no_grad()
    def step(cls_scores, bbox_preds, lambdas, img_shapes, scale_factors,
             generator: Optional[torch.Generator] = None):
        f32 = torch.float32
        return core(as_tensor(cls_scores, dev, f32), as_tensor(bbox_preds, dev, f32),
                    as_tensor(lambdas, dev, f32), as_tensor(img_shapes, dev),
                    as_tensor(scale_factors, dev, f32), anchors.get(dev), generator)

    return step


def make_scale_output_scorer(cfg: RetinaNetConfig, device="cuda") -> Callable:
    """Entropy_ALL / Entropy_NoNMS scorer over raw head outputs (no model
    forward): step(cls_scores [B, A, C], lambdas [B, A] or None,
    generator=None) -> unc [B] on `device`."""
    dev = resolve_device(device)
    core = make_scale_core(cfg)

    @torch.no_grad()
    def step(cls_scores, lambdas=None, generator: Optional[torch.Generator] = None):
        f32 = torch.float32
        lam = None if lambdas is None else as_tensor(lambdas, dev, f32)
        return core(as_tensor(cls_scores, dev, f32), lam, generator)

    return step


def _maxconf(cls_scores: torch.Tensor) -> torch.Tensor:
    """getMaxConf: per-image max softmax probability over every anchor."""
    return torch.softmax(cls_scores, dim=-1).flatten(1).amax(dim=1)


def make_score_step(model, cfg: RetinaNetConfig, device="cuda") -> Callable:
    """Returns step(batch: EvalBatch, generator=None) -> (unc [B],
    maxconf [B]) on `device`, where `model` lives. Dispatches on
    cfg.hua.pool: Entropy_NMS, or Entropy_ALL / Entropy_NoNMS (the latter
    without lambdas). 'Random' is host-side (al/uncertainty.py)."""
    dev = resolve_device(device)
    pool = cfg.hua.pool
    if pool not in ("Entropy_NMS", "Entropy_ALL", "Entropy_NoNMS"):
        raise ValueError(f"score step does not handle pool {pool!r}")
    param = next(model.parameters())
    if param.device.type != dev.type:
        raise ValueError(f"model is on {param.device}, the step on {dev}")
    select, anchors_host = make_candidate_selector(cfg)
    nms_core = make_nms_output_core(cfg, select)
    scale_core = make_scale_core(cfg)
    anchors = AnchorTable(anchors_host)
    with_lambda = pool == "Entropy_ALL"

    @torch.no_grad()
    def step(batch: EvalBatch, generator: Optional[torch.Generator] = None):
        img_shapes = as_tensor(batch.img_shapes, dev)
        images = prepare_images(as_tensor(batch.images, dev), img_shapes, cfg)
        if pool == "Entropy_NMS":
            cls_scores, bbox_preds, lambdas = model(images)
            return nms_core(cls_scores, bbox_preds, lambdas, img_shapes,
                            as_tensor(batch.scale_factors, dev, torch.float32),
                            anchors.get(dev), generator)
        cls_scores, _, lambdas = model(images, with_meh=with_lambda)
        return scale_core(cls_scores, lambdas, generator), _maxconf(cls_scores)

    return step
