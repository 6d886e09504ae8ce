"""Max-IoU assignment and dense anchor targets (torch), batched.

Port of aod_meh_hua_tpu/ops/assigner.py (`max_iou_assign` :24-91,
`AnchorTargets` and `anchor_targets` :161-219, Cascade RPN's
`region_assign` :220-304), which mirrors the reference's
mmdet/core/bbox/assigners/max_iou_assigner.py:10 (assign_wrt_overlaps,
with the ordered low-quality matching of step 4),
L_anchor_head.py:155-202 (_get_targets_single), PseudoSampler and
region_assigner.py:57. GT
boxes are padded to max_gt with a validity mask. The JAX functions are
per image under jax.vmap; these take any leading batch dimensions
([B, ...]) with one anchor table [A, 4] for every image.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .bbox import bbox_overlaps, delta_encode


def max_iou_assign(
    anchors: torch.Tensor,
    gt_boxes: torch.Tensor,
    gt_valid: torch.Tensor,
    anchor_valid: Optional[torch.Tensor] = None,
    pos_iou_thr: float = 0.5,
    neg_iou_thr: float = 0.4,
    min_pos_iou: float = 0.0,
    gt_max_assign_all: bool = True,
    match_low_quality: bool = True,
) -> torch.Tensor:
    """Assign each anchor a gt by mmdet's 4-step MaxIoU rule.

    anchors [A, 4]; gt_boxes [..., G, 4]; gt_valid [..., G] bool;
    anchor_valid [..., A] bool or None (invalid anchors leave the overlap
    matrix, which matters for the per-gt maxima of step 4). Returns
    [..., A] int64 in mmdet's encoding: -1 ignore, 0 background, g + 1
    assigned to gt g.
    """
    num_gt = gt_boxes.shape[-2]
    overlaps = bbox_overlaps(gt_boxes, anchors)  # [..., G, A]
    neg_one = torch.full((), -1.0, dtype=overlaps.dtype, device=overlaps.device)
    overlaps = torch.where(gt_valid[..., :, None], overlaps, neg_one)
    if anchor_valid is not None:
        overlaps = torch.where(anchor_valid[..., None, :], overlaps, neg_one)

    # per anchor over the valid gts (-1 if none); argmax takes the first gt on ties
    max_overlaps = overlaps.amax(dim=-2)
    argmax_overlaps = overlaps.argmax(dim=-2)
    assigned = torch.full(max_overlaps.shape, -1, dtype=torch.long, device=overlaps.device)
    # step 2: negatives (0 <= max < neg_thr)
    assigned = torch.where((max_overlaps >= 0) & (max_overlaps < neg_iou_thr),
                           torch.zeros_like(assigned), assigned)
    # step 3: positives
    assigned = torch.where(max_overlaps >= pos_iou_thr, argmax_overlaps + 1, assigned)

    if match_low_quality:
        gt_max = overlaps.amax(dim=-1, keepdim=True)  # [..., G, 1]
        if gt_max_assign_all:
            is_max = overlaps == gt_max
        else:
            is_max = torch.nn.functional.one_hot(overlaps.argmax(dim=-1),
                                                 overlaps.shape[-1]).bool()
        cand = is_max & (gt_max >= min_pos_iou) & gt_valid[..., :, None]
        # the reference overwrites in gt order, so the last matching gt wins
        gt_ids = torch.arange(1, num_gt + 1, device=overlaps.device)[:, None]
        lowq = torch.where(cand, gt_ids, torch.zeros_like(gt_ids)).amax(dim=-2)  # [..., A]
        assigned = torch.where(lowq > 0, lowq, assigned)

    # the reference's short-circuit: no gt at all -> everything background
    return torch.where(gt_valid.any(dim=-1, keepdim=True), assigned, torch.zeros_like(assigned))


class AnchorTargets(NamedTuple):
    """Dense per-anchor training targets, [..., A] / [..., A, 4]."""

    labels: torch.Tensor         # int64; num_classes = background
    label_weights: torch.Tensor  # float32; 1 for pos and neg, 0 for ignored or invalid
    bbox_targets: torch.Tensor   # float32 [..., A, 4] encoded deltas (0 off the positives)
    bbox_weights: torch.Tensor   # float32 [..., A, 4]; rows of 1 for the positives
    num_pos: torch.Tensor        # int64 [...]: max(#pos, 1), the reference's per-image clamp
    gt_inds: torch.Tensor        # int64; the assigned gt index (meaningful where pos)


def anchor_targets(
    anchors: torch.Tensor,
    anchor_valid: torch.Tensor,
    gt_boxes: torch.Tensor,
    gt_labels: torch.Tensor,
    gt_valid: torch.Tensor,
    num_classes: int,
    target_means=(0.0, 0.0, 0.0, 0.0),
    target_stds=(1.0, 1.0, 1.0, 1.0),
    pos_iou_thr: float = 0.5,
    neg_iou_thr: float = 0.4,
    min_pos_iou: float = 0.0,
    gt_max_assign_all: bool = True,
    pos_weight: float = -1.0,
) -> AnchorTargets:
    """Anchor targets with allowed_border=-1 (only `anchor_valid`, the
    pad-region flags, gates anchors) and PseudoSampler (every assigned
    pos and neg counts). Invalid anchors get the background label with
    zero weight, the reference's unmap(fill=num_classes) / unmap(fill=0).
    """
    assigned = max_iou_assign(
        anchors, gt_boxes, gt_valid, anchor_valid=anchor_valid,
        pos_iou_thr=pos_iou_thr, neg_iou_thr=neg_iou_thr,
        min_pos_iou=min_pos_iou, gt_max_assign_all=gt_max_assign_all)
    pos = (assigned > 0) & anchor_valid
    neg = (assigned == 0) & anchor_valid

    gt_idx = (assigned - 1).clamp(0, gt_boxes.shape[-2] - 1)
    matched_gt = torch.gather(gt_boxes, -2, gt_idx[..., None].expand(*gt_idx.shape, 4))
    labels = torch.where(pos, torch.gather(gt_labels.long(), -1, gt_idx),
                         torch.full_like(gt_idx, num_classes))
    pos_w = 1.0 if pos_weight <= 0 else float(pos_weight)
    label_weights = pos.float() * pos_w + neg.float()

    deltas = delta_encode(anchors, matched_gt, means=target_means, stds=target_stds, eps=1e-6)
    bbox_targets = torch.where(pos[..., None], deltas, torch.zeros_like(deltas))
    bbox_weights = pos[..., None].float().expand(*pos.shape, 4).contiguous()
    num_pos = pos.sum(dim=-1).clamp(min=1)
    return AnchorTargets(labels, label_weights, bbox_targets.float(), bbox_weights,
                         num_pos, gt_idx)


def region_assign(anchors: torch.Tensor, gt_boxes: torch.Tensor, gt_valid: torch.Tensor,
                  anchor_valid: torch.Tensor, level_ids: torch.Tensor,
                  anchor_strides: torch.Tensor, feat_wh: torch.Tensor, anchor_scale: float,
                  base_stride: float, num_lvls: int, center_ratio: float = 0.2,
                  ignore_ratio: float = 0.5) -> torch.Tensor:
    """RegionAssigner (region_assigner.py:57; Cascade RPN's stage 0): each
    gt claims anchors at ONE pyramid level, the one whose base anchor size
    best matches sqrt(gt area); anchor centres inside the gt's shrunken
    `center_ratio` region are positive, those inside the larger
    `ignore_ratio` region (on its own level and on the two adjacent ones)
    ignored. The regions are taken at each anchor's stride, rounded half
    to even and clamped to its feature map (calc_region).

    The reference loops over the gts, a later one overwriting an earlier
    one: per anchor the highest-index gt that touched it (positive or
    own-level ignore) decides, then the adjacent-level ignores and the
    anchor validity apply, as its trailing steps 4-5.

    anchors [A, 4] (one anchor per cell); gt_boxes [..., G, 4]; gt_valid
    [..., G]; anchor_valid [..., A]; level_ids, anchor_strides [A] and
    feat_wh [A, 2] the anchors' level, stride and feature map (w, h).
    Returns [..., A] int64: -1 ignore, 0 background, g + 1 positive."""
    r1 = (1.0 - center_ratio) / 2.0
    r2 = (1.0 - ignore_ratio) / 2.0
    dev = gt_boxes.device
    gw = gt_boxes[..., 2] - gt_boxes[..., 0]
    gh = gt_boxes[..., 3] - gt_boxes[..., 1]
    scale = torch.sqrt((gw * gh).clamp(min=1e-12))
    base = torch.log2(torch.tensor(anchor_scale * base_stride, dtype=scale.dtype, device=dev))
    target_lvl = torch.floor(torch.log2(scale) - base + 0.5).clamp(0, num_lvls - 1).long()

    s = anchor_strides
    acx = (anchors[:, 0] + anchors[:, 2]) * 0.5 / s
    acy = (anchors[:, 1] + anchors[:, 3]) * 0.5 / s

    def inside(ratio):
        # each gt's region at every anchor's stride, clamped to its map: [..., G, A]
        fb = gt_boxes[..., :, None, :] / s[:, None]
        x1 = torch.round((1 - ratio) * fb[..., 0] + ratio * fb[..., 2])
        y1 = torch.round((1 - ratio) * fb[..., 1] + ratio * fb[..., 3])
        x2 = torch.round(ratio * fb[..., 0] + (1 - ratio) * fb[..., 2])
        y2 = torch.round(ratio * fb[..., 1] + (1 - ratio) * fb[..., 3])
        fw, fh = feat_wh[:, 0], feat_wh[:, 1]
        zero = torch.zeros((), dtype=fb.dtype, device=dev)
        x1, x2 = (torch.minimum(torch.maximum(v, zero), fw) for v in (x1, x2))
        y1, y2 = (torch.minimum(torch.maximum(v, zero), fh) for v in (y1, y2))
        return (acx >= x1) & (acx <= x2) & (acy >= y1) & (acy <= y2)

    lvl_eq = target_lvl[..., :, None] == level_ids
    lvl_adj = (target_lvl[..., :, None] - level_ids).abs() == 1
    gv = gt_valid[..., :, None]
    pos_mat = inside(r1) & lvl_eq & gv
    ign_mat = inside(r2)
    ign_own = ign_mat & lvl_eq & gv
    ign_adj = (ign_mat & lvl_adj & gv).any(dim=-2)

    num_gt = gt_boxes.shape[-2]
    gt_ids = torch.arange(1, num_gt + 1, device=dev)[:, None]
    last = torch.where(pos_mat | ign_own, gt_ids, torch.zeros_like(gt_ids)).amax(dim=-2)
    gsel = (last - 1).clamp(0, num_gt - 1)
    last_is_pos = torch.gather(pos_mat, -2, gsel[..., None, :])[..., 0, :]
    minus = torch.full_like(last, -1)
    assigned = torch.where(last > 0, torch.where(last_is_pos, last, minus),
                           torch.zeros_like(last))
    assigned = torch.where(ign_adj, minus, assigned)
    return torch.where(anchor_valid, assigned, minus)
