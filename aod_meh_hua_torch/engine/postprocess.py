"""Inference post-processing: score transform, per-level top-k, box
decoding.

Port of aod_meh_hua_tpu/engine/postprocess.py:26-132, which mirrors the
reference's Lambda_L2.py:264-304 ('relu' activation: alphas =
softmax(cls_score); S = sum(alphas) + 1e-20; scores = alphas / (S + 1e-9);
top-k by max foreground score) and My_L_ssd_head.py:320-356 ('softmax'
activation, SSD: scores = softmax over the C+1 columns, background
included; top-k by the max over the foreground columns only). Level l
contributes min(nms_pre, A_l) candidates.

Ties: jax.lax.top_k puts the lower index first among equal keys, and the
zeroed pad region of a canvas gives many anchors identical logits. The
port ranks with a stable descending sort, which orders ties the same way.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..ops.bbox import delta_decode


class Candidates(NamedTuple):
    scores: torch.Tensor   # [B, K, C] transformed class scores
    boxes: torch.Tensor    # [B, K, 4] decoded, clipped to the image shape
    lambdas: Optional[torch.Tensor]  # [B, K] MEH lambda (None without MEH)
    bounds: Tuple[Tuple[int, int], ...]  # per-level (start, end) in K
    max_prob: Optional[torch.Tensor] = None  # [B] max softmax prob over ALL anchors


def transform_scores(cls_scores: torch.Tensor, family: str = "retinanet") -> torch.Tensor:
    """The retina 'relu' transform: alphas / ((sum(alphas) + 1e-20) + 1e-9);
    for SSD the softmax over every column, background included."""
    alphas = torch.softmax(cls_scores, dim=-1)
    if family == "ssd":
        return alphas
    s = alphas.sum(dim=-1, keepdim=True) + 1e-20
    return alphas / (s + 1e-9)


def topk_indices(keys: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k largest keys along the last axis, in descending
    order, lower index first among equals (jax.lax.top_k's order)."""
    return torch.sort(keys, dim=-1, descending=True, stable=True).indices[..., :k]


def make_candidate_selector(cfg):
    """Returns (select, anchors_host); `select` takes the anchor table
    [A, 4] as an argument."""
    if cfg.test.fast_topk:
        raise NotImplementedError(
            "test.fast_topk: approximate top-k is a TPU lever, not in the port "
            "(ROADMAP Queue 1 item 16)")
    gen = cfg.build_anchor_generator()
    anchors_host = np.concatenate(gen.grid_anchors(cfg.featmap_sizes())).astype(np.float32)
    bounds = cfg.level_bounds()
    topk_bounds = tuple(cfg.topk_level_bounds())
    nms_pre = cfg.test.nms_pre
    num_fg = cfg.num_fg_classes
    family = cfg.family

    def select(all_anchors, cls_scores, bbox_preds, lambdas, img_shapes,
               use_topk: bool = True) -> Candidates:
        out_scores, out_boxes, out_lam = [], [], []
        max_prob = None
        bsz = cls_scores.shape[0]
        for s0, s1 in bounds:
            logits = cls_scores[:, s0:s1]
            preds = bbox_preds[:, s0:s1]
            anchors = all_anchors[s0:s1]
            lam = lambdas[:, s0:s1] if lambdas is not None else None
            if use_topk and s1 - s0 > nms_pre:
                # rank in the log domain: max fg prob = exp(max fg logit - lse)
                lse = torch.logsumexp(logits, dim=-1)
                key = logits[..., :num_fg].amax(dim=-1) - lse
                lvl_max = torch.exp((logits.amax(dim=-1) - lse).amax(dim=-1))
                idx = topk_indices(key, nms_pre)  # [B, k]
                logits = torch.gather(logits, 1, idx[..., None].expand(-1, -1, logits.shape[-1]))
                preds = torch.gather(preds, 1, idx[..., None].expand(-1, -1, 4))
                anchors = anchors[idx]  # [B, k, 4]
                if lam is not None:
                    lam = torch.gather(lam, 1, idx)
                scores = transform_scores(logits, family)
            else:
                scores = transform_scores(logits, family)
                lvl_max = scores.reshape(bsz, -1).amax(dim=-1)
                anchors = anchors[None].expand(bsz, -1, -1)
            max_prob = lvl_max if max_prob is None else torch.maximum(max_prob, lvl_max)
            out_scores.append(scores)
            out_boxes.append(delta_decode(anchors, preds, means=cfg.target_means,
                                          stds=cfg.target_stds, max_shape=img_shapes))
            if lam is not None:
                out_lam.append(lam)
        cand_lam = torch.cat(out_lam, dim=1) if out_lam else None
        b = topk_bounds if use_topk else tuple(bounds)
        return Candidates(torch.cat(out_scores, dim=1), torch.cat(out_boxes, dim=1),
                          cand_lam, b, max_prob)

    return select, anchors_host
