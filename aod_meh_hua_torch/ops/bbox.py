"""Box primitives: IoU overlaps, delta-XYWH encoding and decoding (torch).

Port of aod_meh_hua_tpu/ops/bbox.py:19-142, which mirrors the reference's
mmdet/core/bbox/iou_calculators/iou2d_calculator.py and
delta_xywh_bbox_coder.py:98 (bbox2delta) and :144 (delta2bbox). Boxes are (x1, y1, x2, y2) in
pixels; area = (x2 - x1) * (y2 - y1) (no +1). Every function broadcasts
over leading batch dimensions.
"""

from __future__ import annotations

import math

import torch


def bbox_area(boxes: torch.Tensor) -> torch.Tensor:
    """Area of boxes [..., 4] -> [...]."""
    return (boxes[..., 2] - boxes[..., 0]) * (boxes[..., 3] - boxes[..., 1])


def bbox_overlaps(boxes1: torch.Tensor, boxes2: torch.Tensor,
                  mode: str = "iou", eps: float = 1e-6) -> torch.Tensor:
    """Pairwise overlaps between boxes1 [..., N, 4] and boxes2 [..., M, 4].

    mode='iou': intersection over union; mode='iof': intersection over
    the area of boxes1. Returns [..., N, M]; degenerate boxes give 0.
    """
    if mode not in ("iou", "iof"):
        raise ValueError(f"unsupported mode {mode!r}")
    a1 = bbox_area(boxes1)[..., :, None]
    a2 = bbox_area(boxes2)[..., None, :]
    lt = torch.maximum(boxes1[..., :, None, :2], boxes2[..., None, :, :2])
    rb = torch.minimum(boxes1[..., :, None, 2:], boxes2[..., None, :, 2:])
    wh = (rb - lt).clamp(min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    union = a1 + a2 - inter if mode == "iou" else a1 + torch.zeros_like(a2)
    return inter / union.clamp(min=eps)


def delta_encode(proposals: torch.Tensor, gt: torch.Tensor,
                 means=(0.0, 0.0, 0.0, 0.0), stds=(1.0, 1.0, 1.0, 1.0),
                 eps: float = 0.0) -> torch.Tensor:
    """Encode gt boxes as (dx, dy, dw, dh) deltas w.r.t. proposals.
    `eps` floors the proposals' widths and heights, which keeps padded
    rows finite (they are masked downstream)."""
    px = (proposals[..., 0] + proposals[..., 2]) * 0.5
    py = (proposals[..., 1] + proposals[..., 3]) * 0.5
    pw = proposals[..., 2] - proposals[..., 0]
    ph = proposals[..., 3] - proposals[..., 1]
    gx = (gt[..., 0] + gt[..., 2]) * 0.5
    gy = (gt[..., 1] + gt[..., 3]) * 0.5
    gw = gt[..., 2] - gt[..., 0]
    gh = gt[..., 3] - gt[..., 1]
    if eps:
        pw = pw.clamp(min=eps)
        ph = ph.clamp(min=eps)
    dx = (gx - px) / pw
    dy = (gy - py) / ph
    dw = torch.log((gw / pw).clamp(min=1e-12))
    dh = torch.log((gh / ph).clamp(min=1e-12))
    deltas = torch.stack([dx, dy, dw, dh], dim=-1)
    means = torch.as_tensor(means, dtype=deltas.dtype, device=deltas.device)
    stds = torch.as_tensor(stds, dtype=deltas.dtype, device=deltas.device)
    return (deltas - means) / stds


def delta_decode(rois: torch.Tensor, deltas: torch.Tensor,
                 means=(0.0, 0.0, 0.0, 0.0), stds=(1.0, 1.0, 1.0, 1.0),
                 max_shape=None, wh_ratio_clip: float = 16.0 / 1000.0) -> torch.Tensor:
    """Apply (dx, dy, dw, dh) deltas to rois; optionally clip to max_shape.

    Denormalise, clamp dw/dh to ±|log(wh_ratio_clip)|, shift and scale
    the centers, and clip x to [0, W] and y to [0, H] when max_shape
    (H, W) is given. max_shape may carry the rois' leading batch dims
    (one (H, W) per image).
    """
    means = torch.as_tensor(means, dtype=deltas.dtype, device=deltas.device)
    stds = torch.as_tensor(stds, dtype=deltas.dtype, device=deltas.device)
    d = deltas * stds + means
    max_ratio = abs(math.log(wh_ratio_clip))
    dx, dy = d[..., 0], d[..., 1]
    dw = d[..., 2].clamp(-max_ratio, max_ratio)
    dh = d[..., 3].clamp(-max_ratio, max_ratio)

    px = (rois[..., 0] + rois[..., 2]) * 0.5
    py = (rois[..., 1] + rois[..., 3]) * 0.5
    pw = rois[..., 2] - rois[..., 0]
    ph = rois[..., 3] - rois[..., 1]
    gx = px + pw * dx
    gy = py + ph * dy
    gw = pw * torch.exp(dw)
    gh = ph * torch.exp(dh)
    x1 = gx - gw * 0.5
    y1 = gy - gh * 0.5
    x2 = gx + gw * 0.5
    y2 = gy + gh * 0.5

    if max_shape is not None:
        max_shape = torch.as_tensor(max_shape, device=deltas.device)
        h = max_shape[..., 0].to(deltas.dtype)
        w = max_shape[..., 1].to(deltas.dtype)
        while h.ndim < x1.ndim:
            h = h[..., None]
            w = w[..., None]
        zero = torch.zeros((), dtype=deltas.dtype, device=deltas.device)
        x1 = torch.minimum(torch.maximum(x1, zero), w)
        y1 = torch.minimum(torch.maximum(y1, zero), h)
        x2 = torch.minimum(torch.maximum(x2, zero), w)
        y2 = torch.minimum(torch.maximum(y2, zero), h)
    return torch.stack([x1, y1, x2, y2], dim=-1)
