"""Octave anchors of the RetinaNet family and their pad-region flags
(numpy).

A copy of `AnchorGenerator` (:25-156, without its `scales`/`base_sizes`
overrides, other families' anchors), `_valid_flags` (:71-93),
`SSDAnchorGenerator` (:160-247) and `anchor_valid_flags` (:244-262) from
aod_meh_hua_tpu/ops/anchors.py. It mirrors the reference's
mmdet/core/anchor/anchor_generator.py:12 (octave scales, center_offset=0,
ratio-major base anchors, row-major grid, single_level_valid_flags) and
its SSDAnchorGenerator (the min/max size schedule, scale-minor base
anchors). The port keeps its own copy because the JAX
package's `ops/__init__.py` imports jax; tests/test_torch_ops.py and
tests/test_torch_train.py hold the two copies bit-equal.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np


def _base_anchors(
    base_size: float,
    scales: np.ndarray,
    ratios: np.ndarray,
    center: Tuple[float, float],
    scale_major: bool,
) -> np.ndarray:
    """Base anchors [num_ratios*num_scales, 4] around `center`.

    scale_major=True: ratio-major ordering (all scales of ratio 0 first),
    the reference's `(w * w_ratios[:, None] * scales[None, :])`.
    """
    w = h = float(base_size)
    x_c, y_c = center
    h_ratios = np.sqrt(ratios)
    w_ratios = 1.0 / h_ratios
    if scale_major:
        ws = (w * w_ratios[:, None] * scales[None, :]).reshape(-1)
        hs = (h * h_ratios[:, None] * scales[None, :]).reshape(-1)
    else:
        ws = (w * scales[:, None] * w_ratios[None, :]).reshape(-1)
        hs = (h * scales[:, None] * h_ratios[None, :]).reshape(-1)
    return np.stack(
        [x_c - 0.5 * ws, y_c - 0.5 * hs, x_c + 0.5 * ws, y_c + 0.5 * hs],
        axis=-1,
    ).astype(np.float32)


def _grid_anchors(base: np.ndarray, feat_size: Tuple[int, int], stride: Tuple[int, int]) -> np.ndarray:
    """Tile base anchors over a feature grid; row-major cells, anchor-minor.

    Output [H*W*A, 4]: the first A rows are the anchors of cell (0, 0),
    then (0, 1), ... — the layout a head's [B, H, W, A*C] -> [B, H*W*A, C]
    reshape implies.
    """
    feat_h, feat_w = feat_size
    stride_w, stride_h = stride
    shift_x = np.arange(feat_w, dtype=np.float32) * stride_w
    shift_y = np.arange(feat_h, dtype=np.float32) * stride_h
    xx = np.tile(shift_x, feat_h)
    yy = np.repeat(shift_y, feat_w)
    shifts = np.stack([xx, yy, xx, yy], axis=-1)
    return (base[None, :, :] + shifts[:, None, :]).reshape(-1, 4)


def _valid_flags(
    feat_size: Tuple[int, int],
    stride: Tuple[int, int],
    valid_shape: Tuple[int, int],
    num_base_anchors: int,
) -> np.ndarray:
    """Per-anchor validity for an image padded to `valid_shape` (h, w):
    a grid cell is valid iff its index is below ceil(valid_extent /
    stride), expanded to all anchors of the cell."""
    feat_h, feat_w = feat_size
    valid_h = min(int(math.ceil(valid_shape[0] / stride[1])), feat_h)
    valid_w = min(int(math.ceil(valid_shape[1] / stride[0])), feat_w)
    vx = np.zeros(feat_w, dtype=bool)
    vx[:valid_w] = True
    vy = np.zeros(feat_h, dtype=bool)
    vy[:valid_h] = True
    valid = np.tile(vx, feat_h) & np.repeat(vy, feat_w)
    return np.repeat(valid, num_base_anchors)


@dataclass
class AnchorGenerator:
    """Octave anchor generator (RetinaNet family).

    scales = octave_base_scale * 2**(i / scales_per_octave); base size of
    each level is its stride; anchor centers sit at stride * cell_index
    (center_offset = 0).
    """

    strides: Sequence[int] = (8, 16, 32, 64, 128)
    ratios: Sequence[float] = (0.5, 1.0, 2.0)
    octave_base_scale: int = 4
    scales_per_octave: int = 3
    scale_major: bool = True
    center_offset: float = 0.0
    # an explicit scale list (TridentNet's (2, 4, 8, 16, 32)); None derives
    # the octave schedule (JAX ops/anchors.py:108-123)
    scales: Optional[Sequence[float]] = None

    def __post_init__(self):
        self.strides = [(s, s) if isinstance(s, int) else tuple(s) for s in self.strides]
        if self.scales is not None:
            self.scales = np.asarray(self.scales, dtype=np.float32)
        else:
            self.scales = np.array(
                [self.octave_base_scale * 2 ** (i / self.scales_per_octave)
                 for i in range(self.scales_per_octave)], dtype=np.float32)
        self._ratios = np.asarray(self.ratios, dtype=np.float32)
        self.base_anchors: List[np.ndarray] = []
        for sw, sh in self.strides:
            base_size = min(sw, sh)
            center = (self.center_offset * base_size, self.center_offset * base_size)
            self.base_anchors.append(
                _base_anchors(base_size, self.scales, self._ratios, center, self.scale_major)
            )

    @property
    def num_levels(self) -> int:
        return len(self.strides)

    @property
    def num_base_anchors(self) -> List[int]:
        return [b.shape[0] for b in self.base_anchors]

    def grid_anchors(self, featmap_sizes: Sequence[Tuple[int, int]]) -> List[np.ndarray]:
        return [
            _grid_anchors(self.base_anchors[i], featmap_sizes[i], self.strides[i])
            for i in range(self.num_levels)
        ]

    def valid_flags(
        self, featmap_sizes: Sequence[Tuple[int, int]], pad_shape: Tuple[int, int]
    ) -> List[np.ndarray]:
        return [
            _valid_flags(featmap_sizes[i], self.strides[i], pad_shape, self.num_base_anchors[i])
            for i in range(self.num_levels)
        ]


@dataclass
class SSDAnchorGenerator:
    """SSD anchor generator (heterogeneous anchors per level).

    The min/max size schedule follows the reference: ratio range scanned in
    integer percent steps over (num_levels - 2) intervals, with the first
    level's sizes special-cased by (input_size, basesize_ratio_range[0]).
    Per level: [min-square, sqrt(min*max)-square, ratio anchors at scale 1].
    """

    strides: Sequence[int] = (8, 16, 32, 64, 100, 300)
    ratios: Sequence[Sequence[float]] = ((2,), (2, 3), (2, 3), (2, 3), (2,), (2,))
    basesize_ratio_range: Tuple[float, float] = (0.15, 0.9)
    input_size: int = 300
    scale_major: bool = False

    # (input_size, basesize_ratio_range[0]) -> the first level's (min, max) percent
    _FIRST_LEVEL = {(300, 0.15): (7, 15), (300, 0.2): (10, 20),
                    (512, 0.1): (4, 10), (512, 0.15): (7, 15)}

    def __post_init__(self):
        self.strides = [(s, s) if isinstance(s, int) else tuple(s) for s in self.strides]
        self.centers = [(sw / 2.0, sh / 2.0) for (sw, sh) in self.strides]

        min_ratio = int(self.basesize_ratio_range[0] * 100)
        max_ratio = int(self.basesize_ratio_range[1] * 100)
        step = int(np.floor(max_ratio - min_ratio) / (self.num_levels - 2))
        min_sizes, max_sizes = [], []
        for ratio in range(min_ratio, max_ratio + 1, step):
            min_sizes.append(int(self.input_size * ratio / 100))
            max_sizes.append(int(self.input_size * (ratio + step) / 100))
        if self.input_size not in (300, 512):
            raise ValueError("input_size must be 300 or 512")
        first = self._FIRST_LEVEL.get((self.input_size, self.basesize_ratio_range[0]))
        if first is None:
            raise ValueError(f"basesize_ratio_range[0] = {self.basesize_ratio_range[0]} "
                             f"is not supported for input {self.input_size}")
        min_sizes.insert(0, int(self.input_size * first[0] / 100))
        max_sizes.insert(0, int(self.input_size * first[1] / 100))

        self.base_sizes = min_sizes
        self.base_anchors: List[np.ndarray] = []
        for k in range(self.num_levels):
            scales = np.array([1.0, np.sqrt(max_sizes[k] / min_sizes[k])], dtype=np.float32)
            anchor_ratio = [1.0]
            for r in self.ratios[k]:
                anchor_ratio += [1.0 / r, float(r)]
            anchor_ratio = np.asarray(anchor_ratio, dtype=np.float32)
            base = _base_anchors(min_sizes[k], scales, anchor_ratio, self.centers[k],
                                 self.scale_major)
            # keep [scale0/ratio1, scale1/ratio1, scale0/other-ratios...]
            indices = list(range(len(anchor_ratio)))
            indices.insert(1, len(indices))
            self.base_anchors.append(base[np.asarray(indices)])

    @property
    def num_levels(self) -> int:
        return len(self.strides)

    @property
    def num_base_anchors(self) -> List[int]:
        return [b.shape[0] for b in self.base_anchors]

    def grid_anchors(self, featmap_sizes: Sequence[Tuple[int, int]]) -> List[np.ndarray]:
        return [
            _grid_anchors(self.base_anchors[i], featmap_sizes[i], self.strides[i])
            for i in range(self.num_levels)
        ]

    def valid_flags(
        self, featmap_sizes: Sequence[Tuple[int, int]], pad_shape: Tuple[int, int]
    ) -> List[np.ndarray]:
        return [
            _valid_flags(featmap_sizes[i], self.strides[i], pad_shape, self.num_base_anchors[i])
            for i in range(self.num_levels)
        ]


def anchor_valid_flags(
    generator,
    featmap_sizes: Sequence[Tuple[int, int]],
    pad_shapes: np.ndarray,
) -> np.ndarray:
    """Batch valid flags: pad_shapes [B, 2] (h, w) -> bool [B, total_anchors]
    (the reference's valid_flags + anchor_inside_flags with
    allowed_border=-1)."""
    flags = []
    for hw in np.asarray(pad_shapes):
        per_level = generator.valid_flags(featmap_sizes, (int(hw[0]), int(hw[1])))
        flags.append(np.concatenate(per_level))
    return np.stack(flags)
