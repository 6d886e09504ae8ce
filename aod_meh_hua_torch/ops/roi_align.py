"""RoIAlign as bilinear gathers (torch), single- and multi-level.

Port of aod_meh_hua_tpu/ops/roi_align.py (`_bilinear_gather` :31-62,
`roi_align` :65-103, `map_roi_levels` :106-112, `multilevel_roi_align`
:115-140), which mirrors mmcv's RoIAlign (aligned=True: the half-pixel
offset; aligned=False: the legacy rule with a 1-pixel minimum RoI
extent) with the torchvision edge rules (a sample outside [-1, dim]
reads zero, one in the border band clamps to the edge), and the
reference's FPN routing by sqrt-area (single_level_roi_extractor.py:36-54,
finest_scale 56). The sampling grid is fixed at sampling_ratio x
sampling_ratio points per bin, the JAX package's static form of the
reference's adaptive sampling_ratio=0.

Layout: a feature map is [H, W, C] (or a level of [B, C, H, W] maps,
read as [B, H, W, C]), and RoI features come out [R, out, out, C], the
JAX package's (h, w, c) order, which the box head's first fc flattens.

The JAX function aligns every RoI on every level and keeps the routed
one by a mask. Here each RoI is sampled on its own level only, through
one gather over the levels' maps laid end to end: a masked sum adds
zeros to the routed value, so the values are the same. RoIs go through
in blocks of ROI_BLOCK (the eval step's 8,000 RoIs at full width would
otherwise hold 1.6 GB per bilinear corner). The gradient into the maps
is index_select's, a scatter-add, as jnp.take's transpose is.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

# RoIs sampled per block: 2,048 x 49 bins x 4 points x 256 channels in f32
# is 411 MB for each bilinear corner
ROI_BLOCK = 2048


def _sample(table: torch.Tensor, base: torch.Tensor, h: torch.Tensor, w: torch.Tensor,
            ys: torch.Tensor, xs: torch.Tensor) -> torch.Tensor:
    """Bilinear samples of the [N, C] `table` at float coordinates ys, xs
    [P] on maps of h x w (float [P]) whose rows start at `base` [P]:
    [P, C]. The torchvision rules: a point with y < -1 or y > h (x alike)
    gives 0; coordinates in [-1, 0] clamp to 0, in [dim - 1, dim] to
    dim - 1."""
    inside = (ys >= -1.0) & (ys <= h) & (xs >= -1.0) & (xs <= w)
    y = torch.minimum(ys.clamp(min=0.0), h - 1.0)
    x = torch.minimum(xs.clamp(min=0.0), w - 1.0)
    y0 = torch.floor(y)
    x0 = torch.floor(x)
    y1 = torch.minimum(y0 + 1.0, h - 1.0)
    x1 = torch.minimum(x0 + 1.0, w - 1.0)
    ly = y - y0
    lx = x - x0
    wi = w.long()

    def take(yy, xx):
        return torch.index_select(table, 0, base + yy.long() * wi + xx.long())

    val = (take(y0, x0) * ((1 - ly) * (1 - lx))[:, None]
           + take(y0, x1) * ((1 - ly) * lx)[:, None]
           + take(y1, x0) * (ly * (1 - lx))[:, None]
           + take(y1, x1) * (ly * lx)[:, None])
    return torch.where(inside[:, None], val, torch.zeros((), dtype=val.dtype, device=val.device))


def _align(table: torch.Tensor, rois: torch.Tensor, base: torch.Tensor, h: torch.Tensor,
           w: torch.Tensor, scale: torch.Tensor, out_size: int, sampling_ratio: int,
           aligned: bool) -> torch.Tensor:
    """RoIAlign of rois [R, 4] over the [N, C] table, each RoI on its own
    map (base, h, w, scale [R]): [R, out, out, C]."""
    r, c, s = rois.shape[0], table.shape[1], out_size
    n = max(sampling_ratio, 1)
    offset = 0.5 if aligned else 0.0
    x1 = rois[:, 0] * scale - offset
    y1 = rois[:, 1] * scale - offset
    roi_w = rois[:, 2] * scale - offset - x1
    roi_h = rois[:, 3] * scale - offset - y1
    if not aligned:  # the legacy rule: at least one pixel
        roi_w = roi_w.clamp(min=1.0)
        roi_h = roi_h.clamp(min=1.0)
    bin_w = roi_w / s
    bin_h = roi_h / s
    bins = torch.arange(s, dtype=rois.dtype, device=rois.device)
    pts = (torch.arange(n, dtype=rois.dtype, device=rois.device) + 0.5) / n
    ys = y1[:, None, None] + (bins[None, :, None] + pts[None, None, :]) * bin_h[:, None, None]
    xs = x1[:, None, None] + (bins[None, :, None] + pts[None, None, :]) * bin_w[:, None, None]
    shape = (r, s, s, n, n)
    yy = ys[:, :, None, :, None].expand(shape).reshape(-1)
    xx = xs[:, None, :, None, :].expand(shape).reshape(-1)

    def per_point(t):
        return t[:, None].expand(r, s * s * n * n).reshape(-1)

    vals = _sample(table, per_point(base), per_point(h), per_point(w), yy, xx)
    return vals.reshape(r, s, s, n * n, c).mean(dim=3)


def _blocked(fn, r: int, *per_roi: torch.Tensor) -> torch.Tensor:
    """fn over the RoIs in blocks of ROI_BLOCK, concatenated."""
    return torch.cat([fn(*(t[lo:lo + ROI_BLOCK] for t in per_roi))
                      for lo in range(0, max(r, 1), ROI_BLOCK)])


def roi_align(feat: torch.Tensor, rois: torch.Tensor, out_size: int = 7,
              spatial_scale: float = 1.0, sampling_ratio: int = 2,
              aligned: bool = True) -> torch.Tensor:
    """Single-level RoIAlign: feat [H, W, C] (one image), rois [R, 4]
    (x1, y1, x2, y2 in image coordinates) -> [R, out, out, C]."""
    h, w, c = feat.shape
    r = rois.shape[0]
    dev = rois.device

    def const(v, dtype):
        return torch.full((r,), v, dtype=dtype, device=dev)

    scale = torch.tensor(spatial_scale, dtype=rois.dtype, device=dev)
    return _blocked(lambda rr, bb, hh, ww, sc: _align(feat.reshape(h * w, c), rr, bb, hh, ww,
                                                      sc, out_size, sampling_ratio, aligned),
                    r, rois, const(0, torch.long), const(h, rois.dtype), const(w, rois.dtype),
                    scale.expand(r))


def map_roi_levels(rois: torch.Tensor, num_levels: int, finest_scale: int = 56) -> torch.Tensor:
    """FPN level per RoI [...]: floor(log2(sqrt(area) / finest_scale +
    1e-6)) clamped to [0, num_levels - 1], int64."""
    scale = torch.sqrt((rois[..., 2] - rois[..., 0]).clamp(min=0.0)
                       * (rois[..., 3] - rois[..., 1]).clamp(min=0.0))
    lvl = torch.floor(torch.log2(scale / finest_scale + 1e-6))
    return lvl.clamp(0, num_levels - 1).long()


def batched_multilevel_roi_align(feats: Sequence[torch.Tensor], rois: torch.Tensor,
                                 strides: Sequence[int], out_size: int = 7,
                                 sampling_ratio: int = 2, finest_scale: int = 56,
                                 routing_rois: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Multi-level RoIAlign over a batch: feats per level [B, C, H_l, W_l]
    (any memory format), rois [B, S, 4] -> [B * S, out, out, C] float32,
    each RoI aligned (aligned=True) on the level its scale maps to.
    routing_rois [B, S, 4]: boxes used only for the level mapping (the
    reference maps the original RoIs, then aligns the rescaled ones)."""
    b, n_roi = rois.shape[:2]
    dev = rois.device
    lvls = map_roi_levels(rois if routing_rois is None else routing_rois,
                          len(feats), finest_scale).reshape(-1)
    # the levels' NHWC maps end to end: row base of image i on level l is
    # starts[l] + i * H_l * W_l
    tables, starts, hs, ws, off = [], [], [], [], 0
    for f in feats:
        _, c, h, w = f.shape
        tables.append(f.float().permute(0, 2, 3, 1).reshape(b * h * w, c))
        starts.append(off)
        hs.append(h)
        ws.append(w)
        off += b * h * w
    table = torch.cat(tables)
    img = torch.arange(b, device=dev).repeat_interleave(n_roi)

    def level_table(vals, dtype):
        return torch.tensor(vals, dtype=dtype, device=dev)[lvls]

    h_r = level_table(hs, torch.float32)
    w_r = level_table(ws, torch.float32)
    base = level_table(starts, torch.long) + img * (h_r * w_r).long()
    # 1 / stride rounded to f32, the JAX package's jnp.asarray(1.0 / stride)
    scale = level_table([1.0 / s for s in strides[:len(feats)]], torch.float32)
    return _blocked(lambda rr, bb, hh, ww, sc: _align(table, rr, bb, hh, ww, sc, out_size,
                                                      sampling_ratio, True),
                    b * n_roi, rois.reshape(-1, 4).float(), base, h_r, w_r, scale)


def multilevel_roi_align(feats: Sequence[torch.Tensor], rois: torch.Tensor,
                         strides: Sequence[int], out_size: int = 7, sampling_ratio: int = 2,
                         finest_scale: int = 56,
                         routing_rois: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One image's multi-level extraction, the JAX function's signature:
    feats per level [H_l, W_l, C], rois [R, 4] -> [R, out, out, C] f32."""
    return batched_multilevel_roi_align(
        [f.permute(2, 0, 1)[None] for f in feats], rois[None], strides, out_size,
        sampling_ratio, finest_scale, None if routing_rois is None else routing_rois[None])
