"""HRNet backbone and HRFPN neck (torch).

Port of aod_meh_hua_tpu/models/hrnet.py (`FrozenBasicBlock` :37-62,
`HRModule` :72-119, `HRNet` :122-178, `HRFPN` :181-202), which mirrors
the reference's mmdet/models/backbones/hrnet.py (the two stride-2 3x3
stem convs, a bottleneck stage 1, then parallel branches at strides
4-32 with HRModule exchange units: per-branch BasicBlocks, then every
branch fused into every other, 1x1 + BN + nearest upsampling from a
coarser one, stride-2 3x3 + BN chains from a finer one; the transitions
adapt the channels and start each new branch from the last one) and
necks/hrfpn.py (every branch bilinearly upsampled to stride 4, concat, a
1x1 reduction, the pyramid by average pools, a 3x3 conv per level), at
configs/hrnet/faster_rcnn_hrnetv2p_w{18,32}: branch widths w, 2w, 4w,
8w, modules (1, 4, 3), 4 BasicBlocks per branch. BN is frozen; stage
1's blocks are the plain Bottleneck of models/resnet.py (never fused:
no two-stage family fuses, as in the JAX package).

HRFPN's upsampling is jax.image.resize's bilinear (half-pixel centres,
edge weights renormalised), which for an integer upsample is
F.interpolate(mode="bilinear", align_corners=False) at the output size
(tests/test_torch_hrnet_fpg.py holds it at the full-width branch shapes).
Its pyramid pools are VALID average pools (floor), so P6 is floor(H / 64)
rows where the anchor table takes ceil: models/two_stage.py refuses a
canvas that does not divide by 64, as the JAX package fails on it.
Module names are the JAX package's (trans{s}_{i}_conv, stage{s}_module{m},
branch{i}_block{b}, fuse{i}_{j}_conv[{k}], reduction_conv, fpn_conv{i}).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..utils.profiling import span
from .resnet import Bottleneck, FrozenBatchNorm2d

# the profiler range of HRFPN (engine/two_stage.py STAGES)
HRFPN_SPAN = "hrnet.hrfpn"


def _conv3(cin: int, cout: int, stride: int = 1) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, 3, stride=stride, padding=1, bias=False)


class FrozenBasicBlock(nn.Module):
    """torchvision's BasicBlock with frozen BN (HRNet's branches)."""

    def __init__(self, cin: int, features: int, stride: int = 1):
        super().__init__()
        self.conv1 = _conv3(cin, features, stride)
        self.bn1 = FrozenBatchNorm2d(features)
        self.conv2 = _conv3(features, features)
        self.bn2 = FrozenBatchNorm2d(features)
        self.downsample = None
        if stride != 1 or cin != features:
            self.downsample = nn.Sequential(nn.Conv2d(cin, features, 1, stride=stride,
                                                      bias=False), FrozenBatchNorm2d(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.bn2(self.conv2(torch.relu(self.bn1(self.conv1(x)))))
        identity = x if self.downsample is None else self.downsample(x)
        return torch.relu(y + identity)


def upsample_nearest(x: torch.Tensor, factor: int) -> torch.Tensor:
    """NCHW nearest upsampling by an integer factor (each pixel a
    factor x factor block), as the JAX package's broadcast."""
    b, c, h, w = x.shape
    return x[:, :, :, None, :, None].expand(b, c, h, factor, w, factor).reshape(
        b, c, h * factor, w * factor)


class HRModule(nn.Module):
    """One exchange unit: num_blocks BasicBlocks per branch, then the
    full cross-resolution fusion (hrnet.py:120-198)."""

    def __init__(self, channels: Sequence[int], num_blocks: int = 4):
        super().__init__()
        self.channels = list(channels)
        n = len(channels)
        for i, c in enumerate(channels):
            for b in range(num_blocks):
                self.add_module(f"branch{i}_block{b}", FrozenBasicBlock(c, c))
        self.num_blocks = num_blocks
        if n == 1:
            return
        for i in range(n):
            for j in range(n):
                if j > i:  # coarser -> finer: 1x1 + BN (+ nearest up)
                    self.add_module(f"fuse{i}_{j}_conv",
                                    nn.Conv2d(channels[j], channels[i], 1, bias=False))
                    self.add_module(f"fuse{i}_{j}_bn", FrozenBatchNorm2d(channels[i]))
                elif j < i:  # finer -> coarser: a chain of stride-2 3x3 convs
                    for k in range(i - j):
                        cout = channels[i] if k == i - j - 1 else channels[j]
                        self.add_module(f"fuse{i}_{j}_conv{k}", _conv3(channels[j], cout, 2))
                        self.add_module(f"fuse{i}_{j}_bn{k}", FrozenBatchNorm2d(cout))

    def forward(self, xs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        n = len(self.channels)
        ys = []
        for i, x in enumerate(xs):
            for b in range(self.num_blocks):
                x = getattr(self, f"branch{i}_block{b}")(x)
            ys.append(x)
        if n == 1:
            return ys
        fused = []
        for i in range(n):
            acc = ys[i]
            for j in range(n):
                if j > i:
                    v = getattr(self, f"fuse{i}_{j}_bn")(getattr(self, f"fuse{i}_{j}_conv")(ys[j]))
                    v = upsample_nearest(v, 2 ** (j - i))
                elif j < i:
                    v = ys[j]
                    for k in range(i - j):
                        v = getattr(self, f"fuse{i}_{j}_bn{k}")(
                            getattr(self, f"fuse{i}_{j}_conv{k}")(v))
                        if k != i - j - 1:
                            v = torch.relu(v)
                else:
                    continue
                acc = acc + v
            fused.append(torch.relu(acc))
        return fused


class HRNet(nn.Module):
    """HRNetV2p-w{width}: returns the 4 branch maps (strides 4-32, widths
    w, 2w, 4w, 8w)."""

    def __init__(self, width: int = 32, stage_modules: Sequence[int] = (1, 4, 3),
                 num_blocks: int = 4, stage1_blocks: int = 4, stem_width: int = 64):
        super().__init__()
        self.conv1 = _conv3(3, stem_width, 2)
        self.bn1 = FrozenBatchNorm2d(stem_width)
        self.conv2 = _conv3(stem_width, stem_width, 2)
        self.bn2 = FrozenBatchNorm2d(stem_width)
        self.layer1 = nn.Sequential(*[
            Bottleneck(stem_width if b == 0 else stem_width * 4, stem_width,
                       downsample=(b == 0)) for b in range(stage1_blocks)])
        widths = [width, 2 * width, 4 * width, 8 * width]
        chans = [stem_width * 4]
        # per stage: the transition of each branch ("pass", "adapt" or "new")
        self.transitions = []
        self.stage_modules = list(stage_modules)
        for stage in (2, 3, 4):
            kinds = []
            for i in range(stage):
                if i < len(chans):
                    if chans[i] == widths[i]:
                        kinds.append("pass")
                        continue
                    cin, stride = chans[i], 1
                else:  # a new branch: stride-2 3x3 from the last previous branch
                    cin, stride = chans[-1], 2
                kinds.append("adapt" if stride == 1 else "new")
                self.add_module(f"trans{stage}_{i}_conv", _conv3(cin, widths[i], stride))
                self.add_module(f"trans{stage}_{i}_bn", FrozenBatchNorm2d(widths[i]))
            self.transitions.append(kinds)
            chans = widths[:stage]
            for m in range(stage_modules[stage - 2]):
                self.add_module(f"stage{stage}_module{m}", HRModule(chans, num_blocks))

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        x = torch.relu(self.bn1(self.conv1(x)))
        x = torch.relu(self.bn2(self.conv2(x)))
        xs = [self.layer1(x)]
        for stage, kinds in zip((2, 3, 4), self.transitions):
            nxt = []
            for i, kind in enumerate(kinds):
                if kind == "pass":
                    nxt.append(xs[i])
                    continue
                src = xs[i] if kind == "adapt" else xs[-1]
                conv, bn = (getattr(self, f"trans{stage}_{i}_{k}") for k in ("conv", "bn"))
                nxt.append(torch.relu(bn(conv(src))))
            xs = nxt
            for m in range(self.stage_modules[stage - 2]):
                xs = getattr(self, f"stage{stage}_module{m}")(xs)
        return tuple(xs)


class HRFPN(nn.Module):
    """hrfpn.py:12: every branch bilinearly upsampled by 2^i, concat, a
    1x1 reduction to out_channels, the pyramid by VALID average pools of
    2^i, then a 3x3 conv per level."""

    def __init__(self, in_channels: Sequence[int], out_channels: int = 256, num_outs: int = 5):
        super().__init__()
        self.num_outs = num_outs
        self.reduction_conv = nn.Conv2d(sum(in_channels), out_channels, 1)
        for i in range(num_outs):
            self.add_module(f"fpn_conv{i}", nn.Conv2d(out_channels, out_channels, 3, padding=1))

    def forward(self, inputs: Sequence[torch.Tensor]) -> Tuple[torch.Tensor, ...]:
        with span(HRFPN_SPAN):
            outs = [inputs[0]]
            for i in range(1, len(inputs)):
                v = inputs[i]
                f = 2 ** i
                outs.append(F.interpolate(v, size=(v.shape[2] * f, v.shape[3] * f),
                                          mode="bilinear", align_corners=False))
            red = self.reduction_conv(torch.cat(outs, dim=1))
            levels = [red] + [F.avg_pool2d(red, 2 ** i, 2 ** i) for i in range(1, self.num_outs)]
            return tuple(getattr(self, f"fpn_conv{i}")(lv) for i, lv in enumerate(levels))
