"""Fixed-shape multiclass and grouped NMS (torch), batched.

Port of aod_meh_hua_tpu/ops/nms.py (`_compact_keep` :39-49,
`multiclass_nms` :52-95, `_greedy_keep_sorted` :98-140, `grouped_nms`
:143-174, `batched_multiclass_nms` :177-189), which mirrors the
reference's mmdet/core/post_processing/bbox_nms.py:7 with mmcv NMS
semantics (greedy by descending score, suppress when IoU > iou_thr, ties
by original index), and mmcv's batched_nms with group ids (the RPN's
per-level NMS, rpn_head.py:169-171). The (anchor, class) candidates are
capped at `pre_nms_cands` by a stable top-k, classes (or groups) are
kept apart by the offset trick, and the kept set is the fixpoint of the
suppression map. jax.vmap becomes an explicit batch dimension.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch.utils._pytree import _register_namedtuple

from .bbox import bbox_overlaps

_NEG_INF = -1e10


class NMSResult(NamedTuple):
    boxes: torch.Tensor       # [B, K, 4] (x1, y1, x2, y2)
    scores: torch.Tensor      # [B, K]
    labels: torch.Tensor      # [B, K] int64 class ids (0-based, no background)
    valid: torch.Tensor       # [B, K] bool
    anchor_idx: torch.Tensor  # [B, K] int64 index into the input box array


# a name under which torch.export serialises the type in a program's
# input and output specs (JAX's register_namedtuple_serialization)
_register_namedtuple(NMSResult, serialized_type_name="aod_meh_hua_torch.NMSResult")


def _compact_keep(keep: torch.Tensor, max_out: int):
    """Pack each row's kept candidates (already score-ordered) into its
    first `max_out` slots: position = running count of kept.
    keep [B, k] -> (slots [B, max_out] int64, ok [B, max_out] bool)."""
    b, k = keep.shape
    pos = torch.cumsum(keep.long(), dim=1) - 1
    tgt = torch.where(keep & (pos < max_out), pos, torch.full_like(pos, max_out))
    slots = torch.zeros((b, max_out + 1), dtype=torch.long, device=keep.device)
    src = torch.arange(k, device=keep.device).expand(b, k)
    slots.scatter_(1, tgt, src)  # column max_out collects the dropped ones
    ok = torch.arange(max_out, device=keep.device)[None, :] < keep.sum(dim=1, keepdim=True)
    return slots[:, :max_out], ok


# map applications between two convergence checks (each check reads a
# flag back from the device)
CHECK_INTERVAL = 8

# elements of one block of the IoU matrix: the RPN's candidate sets (about
# 8,300 per image at train) build their [B, k, k] suppression mask in row
# blocks, never holding the whole float IoU matrix and its corner
# intermediates; RetinaNet's 1,000 candidates at batch 64 fit in one block
SUPPRESSION_BLOCK = 1 << 26


def _converged(prev: torch.Tensor, keep: torch.Tensor) -> bool:
    """True when one more application of the map left the mask as it was:
    the loop's only host sync."""
    return torch.equal(prev, keep)


def _greedy_keep_sorted(off_boxes: torch.Tensor, cand_ok: torch.Tensor,
                        iou_thr: float, device_loop: bool = False) -> torch.Tensor:
    """Exact greedy-NMS keep mask [B, k] for candidates sorted by
    descending score.

    Greedy NMS is the unique fixpoint of
        keep[i] = ok[i] and not exists j < i: keep[j] and IoU(i, j) > thr;
    iterating the map from keep = ok reaches it within the suppression
    chain's depth d. The loop applies the map CHECK_INTERVAL times between
    two checks; past the fixpoint the map leaves every mask unchanged, so
    the extra applications are exact, and the host reads a flag back
    ceil((d + 1) / CHECK_INTERVAL) times instead of d + 1.

    device_loop: the same iteration as one torch while_loop, whose
    condition is the "mask changed" flag on the device (JAX's
    lax.while_loop, aod_meh_hua_tpu/ops/nms.py:138): the form that
    torch.export records (engine/eval.py EvalStep). The masks are the
    host loop's, bit for bit: each body applies the map CHECK_INTERVAL
    times and the loop stops after the same body.
    """
    sup = _suppression_mask(off_boxes, iou_thr)  # [B, j, i]

    def interval(keep):
        for _ in range(CHECK_INTERVAL):
            prev, keep = keep, cand_ok & ~(keep[:, :, None] & sup).any(dim=1)
        return prev, keep

    if device_loop:
        from torch._higher_order_ops import while_loop

        def body(changed, keep):
            prev, keep = interval(keep)
            return (prev != keep).any(), keep

        start = torch.ones((), dtype=torch.bool, device=cand_ok.device)
        # the condition returns a new tensor: a while_loop may not alias its inputs
        return while_loop(lambda changed, keep: changed.clone(), body, (start, cand_ok))[1]
    keep = cand_ok
    while True:
        prev, keep = interval(keep)
        if _converged(prev, keep):
            return keep


def _suppression_mask(off_boxes: torch.Tensor, iou_thr: float) -> torch.Tensor:
    """sup[b, j, i] = j < i and IoU(j, i) > iou_thr, a [B, k, k] bool built
    in blocks of rows of at most SUPPRESSION_BLOCK IoUs; each entry is the
    one the whole matrix gives."""
    b, k, _ = off_boxes.shape
    ar = torch.arange(k, device=off_boxes.device)
    rows = max(1, SUPPRESSION_BLOCK // max(b * k, 1))
    return torch.cat([(bbox_overlaps(off_boxes[:, lo:lo + rows], off_boxes) > iou_thr)
                      & (ar[lo:lo + rows, None] < ar[None, :])
                      for lo in range(0, max(k, 1), rows)], dim=1)


def _gather_rows(t: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """t [B, N] or [B, N, 4] at idx [B, K] along dim 1."""
    return torch.gather(t, 1, idx if t.dim() == 2 else idx[..., None].expand(-1, -1, 4))


def grouped_nms(boxes: torch.Tensor, scores: torch.Tensor, group_ids: torch.Tensor,
                valid: torch.Tensor, iou_thr: float, max_out: int,
                device_loop: bool = False) -> NMSResult:
    """Single-class greedy NMS per image in which boxes of different group
    ids never suppress each other. boxes [B, N, 4], scores [B, N],
    group_ids [B, N] int, valid [B, N] bool -> NMSResult of [B, max_out]
    fields; `labels` carries the group id and `anchor_idx` the index into
    the N candidates. The candidates are ordered by descending score,
    ties by index (the JAX package's stable argsort of the negated
    scores). device_loop: the fixpoint as a device-side while_loop
    (_greedy_keep_sorted), for torch.export."""
    neg = torch.full((), _NEG_INF, dtype=scores.dtype, device=scores.device)
    order = torch.sort(torch.where(valid, scores, neg), dim=1, descending=True,
                       stable=True).indices
    zero = torch.zeros((), dtype=boxes.dtype, device=boxes.device)
    max_coord = torch.where(valid[..., None], boxes, zero).amax(dim=(1, 2))
    groups = _gather_rows(group_ids, order)
    off_boxes = _gather_rows(boxes, order) \
        + (groups.to(boxes.dtype) * (max_coord[:, None] + 1.0))[..., None]
    keep = _greedy_keep_sorted(off_boxes, _gather_rows(valid, order), iou_thr, device_loop)
    kept_slots, ok = _compact_keep(keep, max_out)
    slots = torch.gather(order, 1, kept_slots)  # back to the candidates' indices
    return NMSResult(torch.where(ok[..., None], _gather_rows(boxes, slots), zero),
                     torch.where(ok, _gather_rows(scores, slots), zero),
                     torch.where(ok, _gather_rows(group_ids, slots), 0).long(),
                     ok, torch.where(ok, slots, 0))


def batched_multiclass_nms(boxes: torch.Tensor, scores: torch.Tensor, score_thr: float,
                           iou_thr: float, max_out: int, pre_nms_cands: int = 1000,
                           device_loop: bool = False) -> NMSResult:
    """Multiclass NMS per image with static output shape [B, max_out].

    boxes [B, N, 4] shared across classes, or [B, N, C, 4] one box per
    class (the RoI head's class-specific regression, the JAX package's
    boxes[anchor_idx, labels]); scores [B, N, C] foreground class scores.
    device_loop: the fixpoint as a device-side while_loop
    (_greedy_keep_sorted), for torch.export.
    """
    b, n, c = scores.shape
    flat = scores.reshape(b, -1)  # pair (anchor, class): idx = anchor * C + class
    cand = torch.where(flat > score_thr, flat, torch.full_like(flat, _NEG_INF))
    k = min(pre_nms_cands, n * c)
    order = torch.sort(cand, dim=1, descending=True, stable=True)
    top_scores, top_idx = order.values[:, :k], order.indices[:, :k]
    anchor_idx = top_idx // c
    labels = top_idx % c
    if boxes.dim() == 4:  # row anchor * C + class of the flattened per-class boxes
        cand_boxes = _gather_rows(boxes.reshape(b, n * c, 4), top_idx)
    else:
        cand_boxes = _gather_rows(boxes, anchor_idx)
    cand_ok = top_scores > score_thr

    # class-offset trick over the valid candidates: classes never overlap
    max_coord = torch.where(cand_ok[..., None], cand_boxes,
                            torch.zeros_like(cand_boxes)).amax(dim=(1, 2))
    offsets = labels.to(boxes.dtype) * (max_coord[:, None] + 1.0)
    keep = _greedy_keep_sorted(cand_boxes + offsets[..., None], cand_ok, iou_thr, device_loop)

    slots, ok = _compact_keep(keep, max_out)

    zero = torch.zeros((), dtype=boxes.dtype, device=boxes.device)
    out_boxes = torch.where(ok[..., None], _gather_rows(cand_boxes, slots), zero)
    out_scores = torch.where(ok, _gather_rows(top_scores, slots), zero)
    out_labels = torch.where(ok, _gather_rows(labels, slots), 0)
    out_anchor = torch.where(ok, _gather_rows(anchor_idx, slots), 0)
    return NMSResult(out_boxes, out_scores, out_labels, ok, out_anchor)


def multiclass_nms(boxes: torch.Tensor, scores: torch.Tensor, score_thr: float,
                   iou_thr: float, max_out: int, pre_nms_cands: int = 1000) -> NMSResult:
    """Single-image multiclass NMS: boxes [N, 4] or [N, C, 4], scores
    [N, C] -> NMSResult of [max_out] fields."""
    res = batched_multiclass_nms(boxes[None], scores[None], score_thr, iou_thr,
                                 max_out, pre_nms_cands)
    return NMSResult(*(t[0] for t in res))
