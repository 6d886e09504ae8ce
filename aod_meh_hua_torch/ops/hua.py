"""HUA — Hierarchical Uncertainty Aggregation over NMS objects (torch).

Port of aod_meh_hua_tpu/ops/hua.py (`parse_agg_spec` :46-61,
`_masked_reduce` :64-81, `object_membership` :84-99, `lambda_rescale`
:102-116, `hua_object_scores` :119-214, `hua_scale_scores` :217-266),
which mirrors the reference's Lambda_L2.py:343-349 (GetObjectIdx),
:489-537 (ComputeObjUnc), :571-633 (AggregateObjScaleUnc, ChangeOrder +
AggregateObjClassScaleUnc, clsW) and :539-569 + :636-691
(ComputeScaleUnc / AggregateScaleUnc, the pools without objects). Objects are a static axis (the NMS output slots), membership a
dense [A, K] mask, and the class -> scale -> object reduction masked
sums, means and maxes. Empty sets read exactly 0, which the zeroRate
selection depends on. The JAX function is per image under vmap; the
port takes an explicit batch dimension.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from .bbox import bbox_overlaps
from .dirichlet import dirichlet_mutual_information

_NEG = -1e30


def parse_agg_spec(spec: str) -> Dict[str, str]:
    """'objectSum_scaleMax_classSum' -> {'object': 'sum', ...}."""
    out: Dict[str, str] = {}
    for part in spec.split("_"):
        for level in ("object", "scale", "class"):
            if part.startswith(level):
                how = part[len(level):].lower()
                if how not in ("sum", "avg", "max"):
                    raise ValueError(f"bad aggregation {part!r} in {spec!r}")
                out[level] = how
    if "class" not in out or "scale" not in out:
        raise ValueError(f"aggregation spec {spec!r} missing class/scale")
    return out


def _masked_reduce(vals: torch.Tensor, valid: torch.Tensor, how: str,
                   dim: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Reduce `vals` over `dim` using only `valid` entries.
    Returns (reduced, any_valid); positions with no valid entry read 0."""
    any_valid = valid.any(dim=dim)
    zero = torch.zeros((), dtype=vals.dtype, device=vals.device)
    if how == "sum":
        red = torch.where(valid, vals, zero).sum(dim=dim)
    elif how == "avg":
        cnt = valid.sum(dim=dim).clamp(min=1)
        red = torch.where(valid, vals, zero).sum(dim=dim) / cnt
    elif how == "max":
        red = torch.where(valid, vals, torch.full_like(vals, _NEG)).amax(dim=dim)
    else:
        raise ValueError(how)
    return torch.where(any_valid, red, zero), any_valid


def object_membership(cand_boxes: torch.Tensor, det_boxes: torch.Tensor,
                      det_scores: torch.Tensor, det_valid: torch.Tensor,
                      score_thr: float = 0.3, iou_thr: float = 0.5) -> torch.Tensor:
    """Anchor <-> object membership [B, A, K]: objects are NMS survivors
    with score > score_thr; candidate a belongs to object k iff
    IoU(a, k) > iou_thr."""
    keep = det_valid & (det_scores > score_thr)
    return (bbox_overlaps(cand_boxes, det_boxes) > iou_thr) & keep[..., None, :]


def lambda_rescale(lam: torch.Tensor, pair_count: torch.Tensor, eps: float = 1e-7,
                   scale: float = 25.0) -> torch.Tensor:
    """lambda' = mean(lambda over matched pairs) / (lambda + eps) * scale,
    over the last axis. pair_count[a] is the number of (anchor, object)
    pairs anchor a forms, so the mean is pair-weighted."""
    tot = pair_count.sum(dim=-1, keepdim=True).clamp(min=1.0)
    mean = (lam * pair_count).sum(dim=-1, keepdim=True) / tot
    return mean / (lam + eps) * scale


def hua_object_scores(
    cand_scores: torch.Tensor,
    cand_lambda: torch.Tensor,
    member: torch.Tensor,
    level_bounds: Sequence[Tuple[int, int]],
    agg: Dict[str, str],
    fg_score_thr: float = 0.3,
    lambda_eps: float = 1e-7,
    lambda_scale: float = 25.0,
    unc_type: str = "epistemic",
    mi_fn: Callable = None,
    num_fg_classes: int = None,
    agg_order: str = "class_first",
    cls_weight: bool = False,
) -> torch.Tensor:
    """HUA score per image for the Entropy_NMS pool -> [B].

    cand_scores [B, A, C] class probabilities of the candidates
    (concatenated over levels); cand_lambda [B, A]; member [B, A, K];
    level_bounds: (start, end) per level into A. See the JAX function
    for the meaning of each option.
    """
    if mi_fn is None:
        mi_fn = dirichlet_mutual_information
    num_cls = cand_scores.shape[-1]
    num_fg = num_fg_classes or num_cls
    dt = cand_scores.dtype

    sums: List[torch.Tensor] = []
    cnts: List[torch.Tensor] = []
    for s0, s1 in level_bounds:
        scores_l = cand_scores[:, s0:s1]                       # [B, Al, C]
        lam_l = cand_lambda[:, s0:s1]                          # [B, Al]
        fg_l = scores_l.amax(dim=-1) > fg_score_thr            # pair gate
        enable_l = (scores_l[..., :num_fg].amax(dim=-1) > fg_score_thr).any(dim=-1)
        pair_w = member[:, s0:s1] & fg_l[..., None] & enable_l[:, None, None]
        m = pair_w.sum(dim=-1).to(dt)                          # pairs per anchor

        lam_p = lambda_rescale(lam_l, m, eps=lambda_eps, scale=lambda_scale)
        unc = getattr(mi_fn(scores_l * lam_p[..., None]), unc_type)  # [B, Al]

        # torch.argmax takes the first maximum, as jnp.argmax does
        onehot = torch.nn.functional.one_hot(scores_l.argmax(dim=-1), num_cls).to(dt)
        w = pair_w.to(dt).transpose(1, 2)                      # [B, K, Al]
        sums.append(w @ (onehot * unc[..., None]))              # [B, K, C]
        cnts.append(w @ onehot)

    u = torch.stack(sums, dim=1)  # [B, S, K, C]
    n = torch.stack(cnts, dim=1)
    valid = n > 0
    mean_u = torch.where(valid, u / n.clamp(min=1.0), torch.zeros_like(u))

    if agg_order == "class_first":
        v_sc, ok_sc = _masked_reduce(mean_u, valid, agg["class"], dim=3)   # [B, S, K]
        v_o, ok_o = _masked_reduce(v_sc, ok_sc, agg["scale"], dim=1)       # [B, K]
    elif agg_order == "scale_first":
        v_kc, ok_kc = _masked_reduce(mean_u, valid, agg["scale"], dim=1)   # [B, K, C]
        v_o, ok_o = _masked_reduce(v_kc, ok_kc, agg["class"], dim=2)       # [B, K]
    else:
        raise ValueError(f"bad agg_order {agg_order!r}")
    score, ok = _masked_reduce(v_o, ok_o, agg["object"], dim=1)
    score = torch.where(ok, score, torch.zeros_like(score))
    if cls_weight:
        # classes over every (object, scale) cell, empty reductions included
        score = score * valid.any(dim=2).any(dim=1).sum(dim=-1).to(dt)
    return score


def hua_scale_scores(
    level_scores: Sequence[torch.Tensor],
    level_lambda: Optional[Sequence[torch.Tensor]],
    agg: Dict[str, str],
    fg_score_thr: float = 0.3,
    lambda_eps: float = 1e-7,
    lambda_scale: float = 25.0,
    unc_type: str = "epistemic",
    mi_fn: Callable = None,
    num_fg_classes: int = None,
) -> torch.Tensor:
    """Scale/class HUA score per image for Entropy_ALL / Entropy_NoNMS -> [B].

    level_scores: per level [B, Nl, C] softmax probabilities over the
    FULL feature map (no top-k). level_lambda: per level [B, Nl] MEH
    lambda, or None for no lambda rescale (the Entropy_NoNMS pathway).
    The FG gate reads the first `num_fg_classes` columns only.
    """
    if mi_fn is None:
        mi_fn = dirichlet_mutual_information
    num_cls = level_scores[0].shape[-1]
    num_fg = num_fg_classes or num_cls

    sums: List[torch.Tensor] = []
    cnts: List[torch.Tensor] = []
    for li, probs in enumerate(level_scores):
        fg = probs[..., :num_fg].amax(dim=-1) > fg_score_thr         # [B, Nl]
        alpha = probs
        if level_lambda is not None:
            lam = level_lambda[li]
            # the mean runs over the whole level map, not the FG-masked part
            lam_p = lam.mean(dim=-1, keepdim=True) / (lam + lambda_eps) * lambda_scale
            alpha = probs * lam_p[..., None]
        unc = getattr(mi_fn(alpha), unc_type)                           # [B, Nl]
        # torch.argmax takes the first maximum, as jnp.argmax does
        onehot = torch.nn.functional.one_hot(probs.argmax(dim=-1), num_cls).to(probs.dtype)
        w = onehot * fg[..., None].to(probs.dtype)                       # [B, Nl, C]
        sums.append((w * unc[..., None]).sum(dim=1))                     # [B, C]
        cnts.append(w.sum(dim=1))

    u = torch.stack(sums, dim=1)  # [B, S, C]
    n = torch.stack(cnts, dim=1)
    valid = n > 0
    mean_u = torch.where(valid, u / n.clamp(min=1.0), torch.zeros_like(u))
    v_s, ok_s = _masked_reduce(mean_u, valid, agg["class"], dim=2)   # [B, S]
    score, ok = _masked_reduce(v_s, ok_s, agg["scale"], dim=1)       # [B]
    return torch.where(ok, score, torch.zeros_like(score))
