"""The Grid R-CNN model (torch): the Faster R-CNN trunk with a
classification-only RoI head and the grid-point heatmap head.

Port of aod_meh_hua_tpu/models/grid_rcnn.py (`grid_neighbors` :36-52,
`calc_sub_regions` :55-77, `_Transition` :80-90, `GridHead` :93-156,
`_ClsOnlyHead` :159-175, `GridRCNN` :178-227), which mirrors the
reference's mmdet/models/roi_heads/mask_heads/grid_head.py:12-190 (eight
3x3 convs, the first at stride 2, at 9 x 64 channels with GN(36); the
first- and second-order neighbour fusion, a depthwise 5x5 and a 1x1 per
neighbour; two grouped 4x4 stride-2 deconvs, 7 -> 14 -> 28, with GN(9)
between, the second one logit map per point with a 0.01-prior bias; in
training both the fused and the unfused heatmaps) and
roi_heads/grid_roi_head.py (the Shared2FC box head with with_reg=False).

The grouped deconvs are nine ConvTranspose2d per deconv, as the JAX
package's nine per-point modules, so that each point's weights carry
over (models/convert.py flips a flax ConvTranspose kernel into torch's
layout). GroupNorm takes flax's epsilon, 1e-6. The head runs in the
profiler range GRID_SPAN.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch
from torch import nn

from ..utils.profiling import span
from .two_stage import FasterRCNN, _lecun_normal_convs

# the profiler ranges of the grid head, of the jitter and targets, and of the
# boundary voting (engine/grid_rcnn.py; engine/two_stage.py STAGES)
GRID_SPAN, TARGETS_SPAN, REFINE_SPAN = ("grid_rcnn.grid_head", "grid_rcnn.targets",
                                        "grid_rcnn.refine")
GN_EPS = 1e-6  # flax.linen.GroupNorm's


def grid_neighbors(grid_size: int):
    """The 4-neighbourhoods in the reference's column-major point order
    (grid_head.py:103-117: i the column, j the row, index i * size + j)."""
    out = []
    for i in range(grid_size):
        for j in range(grid_size):
            nbrs = []
            if i > 0:
                nbrs.append((i - 1) * grid_size + j)
            if j > 0:
                nbrs.append(i * grid_size + j - 1)
            if j < grid_size - 1:
                nbrs.append(i * grid_size + j + 1)
            if i < grid_size - 1:
                nbrs.append((i + 1) * grid_size + j)
            out.append(tuple(nbrs))
    return out


def calc_sub_regions(grid_points: int, grid_size: int, whole_map: int):
    """Each point's half-size representation region (grid_head.py:191-220,
    the Grid R-CNN Plus reduction): (x1, y1, x2, y2) in whole-map cells."""
    half = whole_map // 4 * 2
    subs = []
    for i in range(grid_points):
        x_idx = i // grid_size
        y_idx = i % grid_size
        if x_idx == 0:
            sx = 0
        elif x_idx == grid_size - 1:
            sx = half
        else:
            sx = max(int((x_idx / (grid_size - 1) - 0.25) * whole_map), 0)
        if y_idx == 0:
            sy = 0
        elif y_idx == grid_size - 1:
            sy = half
        else:
            sy = max(int((y_idx / (grid_size - 1) - 0.25) * whole_map), 0)
        subs.append((sx, sy, sx + half, sy + half))
    return subs


class _Transition(nn.Module):
    """Depthwise 5x5 + 1x1, both with bias (grid_head.py:126-149)."""

    def __init__(self, channels: int):
        super().__init__()
        self.dw = nn.Conv2d(channels, channels, 5, padding=2, groups=channels)
        self.pw = nn.Conv2d(channels, channels, 1)

    def forward(self, x):
        return self.pw(self.dw(x))


class GridHead(nn.Module):
    """x [R, S, S, C] (S = 14) -> (fused heatmaps [R, 2S, 2S, points],
    unfused ones in training, else the fused again), float32."""

    def __init__(self, in_channels: int, grid_points: int = 9, num_convs: int = 8,
                 point_channels: int = 64):
        super().__init__()
        gp, c = grid_points, point_channels
        self.grid_points, self.point_channels = gp, c
        conv_out = gp * c
        for i in range(num_convs):
            self.add_module(f"conv{i}", nn.Conv2d(in_channels if i == 0 else conv_out, conv_out,
                                                  3, stride=2 if i == 0 else 1, padding=1))
            self.add_module(f"gn{i}", nn.GroupNorm(36, conv_out, eps=GN_EPS))
        self.num_convs = num_convs
        self.neighbors = grid_neighbors(int(math.isqrt(gp)))
        for order in ("fo", "so"):
            for i, points in enumerate(self.neighbors):
                for j in range(len(points)):
                    self.add_module(f"{order}_{i}_{j}", _Transition(c))
        for i in range(gp):
            self.add_module(f"deconv1_{i}", nn.ConvTranspose2d(c, c, 4, stride=2, padding=1))
            self.add_module(f"deconv2_{i}", nn.ConvTranspose2d(c, 1, 4, stride=2, padding=1))
        self.gn_deconv = nn.GroupNorm(gp, conv_out, eps=GN_EPS)

    @torch.no_grad()
    def init_weights(self, gen: torch.Generator) -> None:
        """The JAX head's initialisers: LeCun-normal convs with zero biases,
        GN at identity, Normal(0.001) deconvs, the last deconvs' biases at
        the 0.01 prior's logit."""
        _lecun_normal_convs(self.modules(), gen)
        prior = -math.log(0.99 / 0.01)
        for i in range(self.grid_points):
            for name in ("deconv1", "deconv2"):
                m = getattr(self, f"{name}_{i}")
                m.weight.copy_(torch.randn(m.weight.shape, generator=gen) * 0.001)
                m.bias.fill_(prior if name == "deconv2" else 0.0)

    def _heatmaps(self, feats: Sequence[torch.Tensor]) -> torch.Tensor:
        """The two grouped deconvs (the same modules for the fused and the
        unfused pass): [R, points, 2S, 2S] float32."""
        c = self.point_channels
        y = torch.cat([getattr(self, f"deconv1_{i}")(f) for i, f in enumerate(feats)], dim=1)
        y = torch.relu(self.gn_deconv(y))
        return torch.cat([getattr(self, f"deconv2_{i}")(y[:, i * c:(i + 1) * c])
                          for i in range(self.grid_points)], dim=1).float()

    def forward(self, x: torch.Tensor, train: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
        with span(GRID_SPAN):
            x = x.permute(0, 3, 1, 2)
            for i in range(self.num_convs):
                x = torch.relu(getattr(self, f"gn{i}")(getattr(self, f"conv{i}")(x)))
            c = self.point_channels
            slices = [x[:, i * c:(i + 1) * c] for i in range(self.grid_points)]
            x_fo = []
            for i, points in enumerate(self.neighbors):
                acc = slices[i]
                for j, p in enumerate(points):
                    acc = acc + getattr(self, f"fo_{i}_{j}")(slices[p])
                x_fo.append(acc)
            x_so = []
            for i, points in enumerate(self.neighbors):
                acc = slices[i]
                for j, p in enumerate(points):
                    acc = acc + getattr(self, f"so_{i}_{j}")(x_fo[p])
                x_so.append(acc)
            fused = self._heatmaps(x_so).permute(0, 2, 3, 1)
            unfused = self._heatmaps(slices).permute(0, 2, 3, 1) if train else fused
            return fused, unfused


class ClsOnlyHead(nn.Module):
    """Shared2FCBBoxHead with with_reg=False: roi_feats [R, S, S, C],
    flattened (h, w, c) -> fc -> fc -> cls [R, C + 1]."""

    def __init__(self, num_classes: int, in_channels: int, roi_size: int = 7,
                 fc_channels: int = 1024):
        super().__init__()
        self.shared_fc0 = nn.Linear(roi_size * roi_size * in_channels, fc_channels)
        self.shared_fc1 = nn.Linear(fc_channels, fc_channels)
        self.fc_cls = nn.Linear(fc_channels, num_classes + 1)

    @torch.no_grad()
    def init_weights(self, gen: torch.Generator) -> None:
        """LeCun-normal shared fcs (flax Dense's default), Normal(0.01)
        fc_cls, zero biases."""
        for fc in (self.shared_fc0, self.shared_fc1):
            fc.weight.copy_(torch.randn(fc.weight.shape, generator=gen) * fc.in_features ** -0.5)
        self.fc_cls.weight.copy_(torch.randn(self.fc_cls.weight.shape, generator=gen) * 0.01)
        for fc in (self.shared_fc0, self.shared_fc1, self.fc_cls):
            fc.bias.zero_()

    def forward(self, roi_feats: torch.Tensor) -> torch.Tensor:
        f = roi_feats.reshape(roi_feats.shape[0], -1)
        f = torch.relu(self.shared_fc1(torch.relu(self.shared_fc0(f))))
        return self.fc_cls(f).float()


class GridRCNN(FasterRCNN):
    """Backbone + FPN + RPN + the cls-only box head (`bbox_head`) + the
    grid head (`grid_head`)."""

    def _build_roi_head(self, cfg) -> None:
        self.bbox_head = ClsOnlyHead(cfg.num_classes, cfg.fpn_channels, cfg.rcnn.roi_size,
                                     cfg.rcnn.fc_channels)
        self.grid_head = GridHead(cfg.fpn_channels, cfg.grid_points, cfg.grid_convs,
                                  cfg.grid_point_channels)

    @torch.no_grad()
    def init_weights(self, seed: int) -> None:
        super().init_weights(seed)
        self.grid_head.init_weights(torch.Generator().manual_seed(seed + 1))

    def roi_forward(self, roi_feats: torch.Tensor) -> torch.Tensor:
        """The class logits [R, C + 1] (the JAX model's roi_cls)."""
        return self.bbox_head(roi_feats)

    def grid(self, grid_feats: torch.Tensor, train: bool = False):
        return self.grid_head(grid_feats, train)
