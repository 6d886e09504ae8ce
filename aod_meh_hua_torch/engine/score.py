"""Pool scoring for the Entropy_NMS pool: forward -> per-level top-k ->
decode -> NMS -> membership -> closed-form Dirichlet MI -> HUA.

Port of aod_meh_hua_tpu/engine/score.py (`make_nms_output_core` :49-98,
`make_output_scorer` :101-126, `make_score_step` :192-244), which mirrors
the reference's apis/test.py:90-135 and Lambda_L2.py:254-384,
:489-537, :597-619. Runs eagerly under torch.no_grad(); the step returns
one [B] score vector and one [B] max-confidence vector on the device.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ..ops.hua import hua_object_scores, object_membership, parse_agg_spec
from ..ops.nms import batched_multiclass_nms
from ..utils.config import RetinaNetConfig
from ..utils.device import resolve_device
from .batch import AnchorTable, EvalBatch, prepare_images
from .postprocess import make_candidate_selector

_UNC_TYPES = {"epistemic": "epistemic", "aleatoric": "aleatoric", "total": "total",
              "shannon": "total"}


def _check_hua(cfg: RetinaNetConfig) -> None:
    if cfg.hua.mi_mode != "closed":
        raise NotImplementedError(
            f"hua.mi_mode={cfg.hua.mi_mode!r}: the sampled Dirichlet MI is not in the "
            "port yet (ROADMAP Queue 1)")


def make_nms_output_core(cfg: RetinaNetConfig, select) -> Callable:
    """The Entropy_NMS core on raw head outputs: (cls_scores [B, A, C],
    bbox_preds [B, A, 4], lambdas [B, A], img_shapes [B, 2],
    scale_factors [B, 4], anchors [A, 4]) -> (unc [B], maxconf [B])."""
    _check_hua(cfg)
    agg = parse_agg_spec(cfg.hua.agg)
    hua = cfg.hua
    t = cfg.test
    unc_type = _UNC_TYPES[hua.unc_type.lower()]

    def core(cls_scores, bbox_preds, lambdas, img_shapes, scale_factors, anchors):
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
            lambda_scale=hua.lambda_scale, unc_type=unc_type,
            num_fg_classes=cfg.num_fg_classes, agg_order=hua.agg_order,
            cls_weight=hua.cls_weight)
        return unc, cand.max_prob

    return core


def _as_tensor(a, device, dtype=None) -> torch.Tensor:
    t = a if isinstance(a, torch.Tensor) else torch.from_numpy(np.asarray(a))
    return t.to(device=device, dtype=dtype)


def make_output_scorer(cfg: RetinaNetConfig, device="cuda") -> Callable:
    """Entropy_NMS scorer over raw head outputs (no model forward):
    step(cls_scores, bbox_preds, lambdas, img_shapes, scale_factors) ->
    (unc [B], maxconf [B]) on `device`. Arrays may be numpy or tensors."""
    dev = resolve_device(device)
    select, anchors_host = make_candidate_selector(cfg)
    core = make_nms_output_core(cfg, select)
    anchors = AnchorTable(anchors_host)

    @torch.no_grad()
    def step(cls_scores, bbox_preds, lambdas, img_shapes, scale_factors):
        f32 = torch.float32
        return core(_as_tensor(cls_scores, dev, f32), _as_tensor(bbox_preds, dev, f32),
                    _as_tensor(lambdas, dev, f32), _as_tensor(img_shapes, dev),
                    _as_tensor(scale_factors, dev, f32), anchors.get(dev))

    return step


def make_score_step(model, cfg: RetinaNetConfig, device="cuda") -> Callable:
    """Returns step(batch: EvalBatch) -> (unc [B], maxconf [B]) on `device`,
    where `model` lives. Only the Entropy_NMS pool is in the port so far;
    'Random' is host-side (al/uncertainty.py)."""
    dev = resolve_device(device)
    pool = cfg.hua.pool
    if pool in ("Entropy_ALL", "Entropy_NoNMS"):
        raise NotImplementedError(
            f"pool {pool!r}: hua_scale_scores is not in the port yet (ROADMAP Queue 1)")
    if pool != "Entropy_NMS":
        raise ValueError(f"score step does not handle pool {pool!r}")
    param = next(model.parameters())
    if param.device.type != dev.type:
        raise ValueError(f"model is on {param.device}, the step on {dev}")
    select, anchors_host = make_candidate_selector(cfg)
    core = make_nms_output_core(cfg, select)
    anchors = AnchorTable(anchors_host)

    @torch.no_grad()
    def step(batch: EvalBatch):
        img_shapes = _as_tensor(batch.img_shapes, dev)
        images = prepare_images(_as_tensor(batch.images, dev), img_shapes, cfg)
        cls_scores, bbox_preds, lambdas = model(images)
        return core(cls_scores, bbox_preds, lambdas, img_shapes,
                    _as_tensor(batch.scale_factors, dev, torch.float32), anchors.get(dev))

    return step
