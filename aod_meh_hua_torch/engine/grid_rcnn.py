"""Grid R-CNN's steps (torch): the grid heatmaps trained on jittered
positives, and the eval's refinement by boundary voting.

Port of aod_meh_hua_tpu/engine/grid_rcnn.py (`_jitter_boxes` :49-62,
`_grid_point_factors` :65-69, `grid_targets` :72-102,
`make_grid_rcnn_train_step` :105-200, `make_grid_rcnn_eval_step`
:203-293), which mirrors the reference's
mmdet/models/roi_heads/grid_roi_head.py (_random_jitter :27-50, amplitude
0.15 on the centre and size, clipped to the image less one; the grid
branch on the jittered positives, the cls-only box branch :79-120) and
mask_heads/grid_head.py (get_targets :222-287: per point a disc of radius
pos_radius at the gt's grid point in the 2x-expanded box's whole-map
cells, cropped to the point's sub-region, the expanded boxes no wider or
taller than the grid ignored; loss :289-295, BCE at weight 15 on the
fused and the unfused heatmaps, averaged over the elements; get_bboxes
:297-362, the per-point argmax in its sub-region mapped into the
expanded detection box, then each side the score-weighted mean of its
edge points).

Randomness: the JAX step splits its key into k_rpn, k_roi and k_jit,
each into one key per image: the RPN's sampler (kp, kn) on
uniforms("rpn", A, 2), the RoI sampler's on uniforms("roi", G + P, 2),
and the jitter's uniform [S, 4] draw on uniforms("jitter", S * 4, 1),
taken to [-0.15, 0.15) as jax.random.uniform takes its [0, 1) floats
(`jitter_offsets`).
"""

from __future__ import annotations

import math
from typing import Callable

import numpy as np
import torch

from ..models.grid_rcnn import REFINE_SPAN, TARGETS_SPAN, calc_sub_regions
from ..ops.losses import binary_cross_entropy_with_logits
from ..utils.profiling import span
from . import two_stage as ts
from .batch import EvalBatch, prepare_images
from .train import DataAxis

JITTER = 0.15  # grid_roi_head.py _random_jitter's amplitude


def jitter_offsets(u: torch.Tensor, amplitude: float = JITTER) -> torch.Tensor:
    """Uniforms in [0, 1) -> offsets in [-amplitude, amplitude), the
    arithmetic of jax.random.uniform(minval=-a, maxval=a): u * (a - (-a))
    + (-a) in float32, then at least -a."""
    lo = torch.tensor(-amplitude, dtype=torch.float32, device=u.device)
    hi = torch.tensor(amplitude, dtype=torch.float32, device=u.device)
    return torch.maximum(lo, u * (hi - lo) + lo)


def jitter_boxes(off: torch.Tensor, boxes: torch.Tensor, img_shapes: torch.Tensor) -> torch.Tensor:
    """_random_jitter of boxes [B, S, 4] by offsets [B, S, 4] (the centre
    moves by w, h times off[:2], the size scales by 1 + off[2:]), clipped
    to each image's [0, w - 1] x [0, h - 1]."""
    cxcy = (boxes[..., 2:] + boxes[..., :2]) / 2
    wh = torch.abs(boxes[..., 2:] - boxes[..., :2])
    new_c = cxcy + wh * off[..., :2]
    new_wh = wh * (1 + off[..., 2:])
    b = torch.cat([new_c - new_wh / 2, new_c + new_wh / 2], dim=-1)
    h = (img_shapes[:, 0] - 1).to(b.dtype)[:, None]
    w = (img_shapes[:, 1] - 1).to(b.dtype)[:, None]
    zero = torch.zeros((), dtype=b.dtype, device=b.device)
    return torch.stack([torch.minimum(torch.maximum(b[..., 0], zero), w),
                        torch.minimum(torch.maximum(b[..., 1], zero), h),
                        torch.minimum(torch.maximum(b[..., 2], zero), w),
                        torch.minimum(torch.maximum(b[..., 3], zero), h)], dim=-1)


def grid_point_factors(grid_points: int, grid_size: int) -> np.ndarray:
    """Each point's (fx, fy): its gt grid point is fx * x1 + (1 - fx) * x2."""
    return np.asarray([(1 - (j // grid_size) / (grid_size - 1),
                        1 - (j % grid_size) / (grid_size - 1))
                       for j in range(grid_points)], np.float32)


def grid_targets(pos_boxes: torch.Tensor, gt_boxes: torch.Tensor, grid_points: int,
                 whole_map: int, pos_radius: int):
    """get_targets for jittered boxes [..., S, 4] and their matched gts:
    (targets [..., S, points, half, half] float32, each point's disc in
    its sub-region; roi_ok [..., S], the expanded box wider and taller
    than the grid)."""
    gs = int(math.isqrt(grid_points))
    half = whole_map // 4 * 2
    subs = calc_sub_regions(grid_points, gs, whole_map)
    fac = grid_point_factors(grid_points, gs)
    w = pos_boxes[..., 2] - pos_boxes[..., 0]
    h = pos_boxes[..., 3] - pos_boxes[..., 1]
    ex1 = pos_boxes[..., 0] - w / 2
    ey1 = pos_boxes[..., 1] - h / 2
    ew, eh = 2 * w, 2 * h
    ok = (ew > gs) & (eh > gs)
    ar = torch.arange(half, dtype=torch.float32, device=pos_boxes.device)
    outs = []
    for j in range(grid_points):
        fx, fy = (float(v) for v in fac[j])
        gx = fx * gt_boxes[..., 0] + float(np.float32(1) - fac[j, 0]) * gt_boxes[..., 2]
        gy = fy * gt_boxes[..., 1] + float(np.float32(1) - fac[j, 1]) * gt_boxes[..., 3]
        # floor is int()'s truncation for the in-box (positive) points
        cx = torch.floor((gx - ex1) / ew.clamp(min=1e-6) * whole_map)
        cy = torch.floor((gy - ey1) / eh.clamp(min=1e-6) * whole_map)
        xs, ys = ar + subs[j][0], ar + subs[j][1]
        d2 = ((xs - cx[..., None, None]) ** 2 + (ys[:, None] - cy[..., None, None]) ** 2)
        outs.append((d2 <= pos_radius ** 2).float())
    return torch.stack(outs, dim=-3), ok


def make_grid_rcnn_train_step(model, cfg, optimizer: torch.optim.Optimizer, device="cuda",
                              mesh=None) -> Callable:
    """Grid R-CNN's step, the contract of engine/two_stage.py
    make_faster_rcnn_train_step: the RPN's losses and proposals, the RoI
    sampler (gts prepended), the cls-only head's CE, and the grid head on
    every sampled RoI jittered, its BCE on the fused and the unfused
    heatmaps over the positives whose expanded box is larger than the
    grid (the global count across ranks). aux: loss, loss_rpn_cls,
    loss_rpn_bbox, loss_cls, loss_grid, num_pos."""
    proposal_fn = ts.make_proposal_fn(cfg)
    whole = cfg.grid_roi_size * 4

    def loss_fn(batch, anchors: torch.Tensor, uniforms: ts.Uniforms, data: DataAxis):
        feats, loss_rpn_cls, loss_rpn_bbox, props, prop_valid = ts._rpn_stage(
            model, cfg, proposal_fn, batch, anchors, uniforms, data)
        smp = ts._sample(cfg, batch, uniforms, "roi", props, prop_valid)
        avg_cls, _, num_pos = ts.roi_counts(smp, data)
        roi_feats = ts.roi_features(model, cfg, feats, smp.rois)
        with span(ts.STAGES[5]):
            cls = model.roi_forward(roi_feats)
        loss_cls = ts._cls_loss(cls, smp, avg_cls)
        b, s = smp.rois.shape[:2]
        with torch.no_grad(), span(TARGETS_SPAN):
            off = jitter_offsets(uniforms("jitter", s * 4, 1)[0].reshape(b, s, 4))
            jit = jitter_boxes(off, smp.rois, batch.img_shapes)
            matched = torch.gather(batch.gt_boxes, 1, smp.gt_idx[..., None].expand(-1, -1, 4))
            tg, ok = grid_targets(jit, matched, cfg.grid_points, whole, cfg.grid_pos_radius)
            roi_ok = (smp.is_pos & ok).reshape(-1)
        with span(ts.STAGES[4]):
            grid_feats = ts.extract_rois(cfg, feats, jit, roi_size=cfg.grid_roi_size)
        fused, unfused = model.grid(grid_feats, True)
        tg = tg.reshape((-1,) + tg.shape[2:]).permute(0, 2, 3, 1)
        per_elem = (binary_cross_entropy_with_logits(fused, tg, reduction="none")
                    + binary_cross_entropy_with_logits(unfused, tg, reduction="none"))
        denom = data.sum(roi_ok.sum().float()).clamp(min=1.0) * float(np.prod(tg.shape[1:]))
        loss_grid = cfg.grid_loss_weight * (per_elem * roi_ok[:, None, None, None]).sum() / denom
        total = loss_rpn_cls + loss_rpn_bbox + loss_cls + loss_grid
        return total, {"loss": total, "loss_rpn_cls": loss_rpn_cls,
                       "loss_rpn_bbox": loss_rpn_bbox, "loss_cls": loss_cls,
                       "loss_grid": loss_grid, "num_pos": num_pos}

    return ts._make_step(model, cfg, optimizer, device, loss_fn, mesh=mesh)


class GridRCNNEvalStep(ts.TwoStageEvalStep):
    """Grid R-CNN's eval: the proposals scored by the cls-only head (the
    boxes are the proposals, with_reg=False), multiclass NMS, then the
    grid head on the kept detections and each side of each box by
    boundary voting (grid_head.get_bboxes): NMSResult."""

    def forward(self, batch: EvalBatch) -> ts.NMSResult:
        cfg, c, gp = self.cfg, self.cfg.num_classes, self.cfg.grid_points
        gs = int(math.isqrt(gp))
        half = cfg.grid_roi_size * 4 // 4 * 2
        with span(ts.STAGES[0]):
            feats, rpn_cls, rpn_reg = self.model(prepare_images(batch.images, batch.img_shapes,
                                                                cfg))
        with span(ts.STAGES[2]):
            props, _, prop_valid = self.proposals(rpn_cls, rpn_reg, self.anchors,
                                                  batch.img_shapes, cfg.rpn.test_nms_pre,
                                                  cfg.rpn.test_max_per_img)
        roi_feats = ts.roi_features(self.model, cfg, feats, props)
        with span(ts.STAGES[5]):
            cls = self.model.roi_forward(roi_feats)
        b, p = props.shape[:2]
        sf = batch.scale_factors
        with span(ts.STAGES[6]):
            fg = torch.softmax(cls, dim=-1).reshape(b, p, c + 1)[..., :c] * prop_valid[..., None]
            orig = props / sf[:, None, :]
            dets = self._nms(orig[:, :, None, :].expand(b, p, c, 4), fg)
        # the kept detections in canvas coordinates, for the grid features
        det_net = dets.boxes * sf[:, None, :]
        with span(ts.STAGES[4]):
            grid_feats = ts.extract_rois(cfg, feats, det_net, roi_size=cfg.grid_roi_size)
        heat, _ = self.model.grid(grid_feats, False)
        with span(REFINE_SPAN):
            n = heat.shape[0]
            hm = torch.sigmoid(heat.permute(0, 3, 1, 2).reshape(n, gp, -1))
            score = hm.amax(dim=-1)
            idx = hm.argmax(dim=-1)  # the first index of the maximum, as jnp.argmax
            subs = torch.tensor(calc_sub_regions(gp, gs, cfg.grid_roi_size * 4),
                                dtype=torch.float32, device=heat.device)
            xs = (idx % half).float() + subs[None, :, 0]
            ys = torch.div(idx, half, rounding_mode="floor").float() + subs[None, :, 1]
            db = det_net.reshape(n, 4)
            w = (db[:, 2] - db[:, 0])[:, None]
            h = (db[:, 3] - db[:, 1])[:, None]
            abs_x = (xs + 0.5) / half * w + (db[:, 0][:, None] - w / 2)
            abs_y = (ys + 0.5) / half * h + (db[:, 1][:, None] - h / 2)

            def vote(vals, inds):
                s = score[:, inds]
                return (vals[:, inds] * s).sum(1) / s.sum(1).clamp(min=1e-6)

            refined = torch.stack([vote(abs_x, list(range(gs))),
                                   vote(abs_y, [i * gs for i in range(gs)]),
                                   vote(abs_x, [gp - gs + i for i in range(gs)]),
                                   vote(abs_y, [(i + 1) * gs - 1 for i in range(gs)])],
                                  dim=1).reshape(b, -1, 4)
            shp = batch.img_shapes[:, None, :].float()
            zero = torch.zeros((), device=refined.device)
            refined = torch.stack([
                torch.minimum(torch.maximum(refined[..., 0], zero), shp[..., 1]),
                torch.minimum(torch.maximum(refined[..., 1], zero), shp[..., 0]),
                torch.minimum(torch.maximum(refined[..., 2], zero), shp[..., 1]),
                torch.minimum(torch.maximum(refined[..., 3], zero), shp[..., 0])], dim=-1)
            refined = refined / sf[:, None, :]
            return dets._replace(boxes=torch.where(dets.valid[..., None], refined, dets.boxes))
