"""Feature Pyramid Grids neck (torch).

Port of aod_meh_hua_tpu/models/fpg.py (`_ActConvNorm` :29-53, `FPG`
:56-101), which mirrors the reference's mmdet/models/necks/fpg.py (plain
1x1 laterals and a max-pool extra level, then `stack_times` bottom-up
stages; each cell not skipped sums its same-stage-up (a stride-2 conv of
the finer level just computed), across-lateral (a 1x1 of the previous
stage's level), across-down (nearest x2 and a 3x3 of the previous
stage's coarser level) and across-skip (a 1x1 of stage 0's level)
transitions, each a ConvModule ordered act, conv, norm; a 3x3 last conv
per level) at configs/fpg/faster_rcnn_r50_fpg_crop640_50e_coco.py
(stack_times 9, the staircase skip_inds). BN is frozen, the framework's
norm_eval convention.

The across-down transition doubles the coarser level, which must then
match the finer one: every level's size halves exactly only on a canvas
that divides by 64, and models/two_stage.py refuses another, as the JAX
package fails on it. Module names are the JAX package's
(s{s}_l{l}_{lateral,same_up,across_down,across_skip}, out_{i}; the
laterals lateral_{i} as lateral_convs.{i}).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
from torch import nn

from ..utils.profiling import span
from .hrnet import upsample_nearest
from .resnet import FrozenBatchNorm2d

# the profiler range of the FPG neck (engine/two_stage.py STAGES)
FPG_SPAN = "fpg.neck"
# the reference config's skip_inds: level l skips the stages listed
SKIP_INDS = ((0, 1, 2, 3), (0, 1, 2), (0, 1), (0,), ())


class _ActConvNorm(nn.Module):
    """ConvModule(order=('act', 'conv', 'norm')): ReLU, an optional
    nearest x2, a bias-free conv, frozen BN."""

    def __init__(self, cin: int, features: int, kernel: int = 3, stride: int = 1,
                 upsample: bool = False):
        super().__init__()
        self.upsample = upsample
        self.conv = nn.Conv2d(cin, features, kernel, stride=stride, padding=(kernel - 1) // 2,
                              bias=False)
        self.bn = FrozenBatchNorm2d(features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = torch.relu(x)
        if self.upsample:
            x = upsample_nearest(x, 2)
        return self.bn(self.conv(x))


class FPG(nn.Module):
    def __init__(self, in_channels: Sequence[int], out_channels: int = 256,
                 inter_channels: int = 256, num_outs: int = 5, stack_times: int = 9,
                 skip_inds: Sequence[Sequence[int]] = SKIP_INDS):
        super().__init__()
        self.num_outs, self.stack_times, self.skip_inds = num_outs, stack_times, skip_inds
        c = inter_channels
        self.lateral_convs = nn.ModuleList(nn.Conv2d(ci, c, 1) for ci in in_channels)
        self.n_extra = num_outs - len(in_channels)
        for s in range(stack_times):
            for lvl in range(num_outs):
                if s in skip_inds[lvl]:
                    continue
                self.add_module(f"s{s}_l{lvl}_lateral", _ActConvNorm(c, c, 1))
                if lvl > 0:
                    self.add_module(f"s{s}_l{lvl}_same_up", _ActConvNorm(c, c, 3, stride=2))
                if lvl < num_outs - 1:
                    self.add_module(f"s{s}_l{lvl}_across_down",
                                    _ActConvNorm(c, c, 3, upsample=True))
                self.add_module(f"s{s}_l{lvl}_across_skip", _ActConvNorm(c, c, 1))
        for i in range(num_outs):
            self.add_module(f"out_{i}", _ActConvNorm(c, out_channels, 3))

    def forward(self, inputs: Sequence[torch.Tensor]) -> Tuple[torch.Tensor, ...]:
        with span(FPG_SPAN):
            feats = [conv(f) for conv, f in zip(self.lateral_convs, inputs)]
            for _ in range(self.n_extra):
                feats.append(feats[-1][:, :, ::2, ::2])  # max_pool, window 1, stride 2
            outs = [feats]
            for s in range(self.stack_times):
                cur, nxt = outs[-1], []
                for lvl in range(self.num_outs):
                    if s in self.skip_inds[lvl]:
                        nxt.append(cur[lvl])
                        continue
                    cell = lambda name: getattr(self, f"s{s}_l{lvl}_{name}")  # noqa: E731
                    acc = cell("lateral")(cur[lvl])
                    if lvl > 0:
                        acc = acc + cell("same_up")(nxt[-1])
                    if lvl < self.num_outs - 1:
                        acc = acc + cell("across_down")(cur[lvl + 1])
                    nxt.append(acc + cell("across_skip")(outs[0][lvl]))
                outs.append(nxt)
            return tuple(getattr(self, f"out_{i}")(outs[-1][i]) for i in range(self.num_outs))
