"""Feature Pyramid Network and the Faster R-CNN variants' necks (torch).

Port of aod_meh_hua_tpu/models/fpn.py: `FPN` :34-77, which mirrors the
reference's mmdet/models/necks/fpn.py:10 with its three `add_extra_convs`
modes: 'on_input' (RetinaNet, Config_RetinaNet.py:34-40: start_level=1,
P6 by a stride-2 conv from C5, P7 from P6), 'on_output' (P6 from P5)
and 'maxpool' (Faster R-CNN's add_extra_convs=False: P6 by stride-2
subsampling of the last output, F.max_pool2d(x, 1, stride=2)), with
relu_before_extra_convs. The top-down pass upsamples with nearest
neighbour, torch's floor rule, which the JAX package reproduces. Then
Libra R-CNN's `adaptive_max_pool`, `NonLocal2D` and `BFP` (:79-162),
`PAFPN` (:165-206) and `carafe_upsample`, `CARAFE` and `FPNCARAFE`
(:292-369), with `nearest_resize` (:24-31) for the resizes of
non-integer ratio. The modules take and give NCHW maps.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..utils.profiling import span

EXTRA_MODES = ("on_input", "on_output", "maxpool")


class FPN(nn.Module):
    def __init__(self, in_channels: Sequence[int], out_channels: int = 256,
                 start_level: int = 1, num_outs: int = 5, add_extra_convs: str = "on_input",
                 relu_before_extra_convs: bool = False):
        super().__init__()
        if add_extra_convs not in EXTRA_MODES:
            raise ValueError(f"add_extra_convs={add_extra_convs!r}: one of {EXTRA_MODES}")
        self.start_level = start_level
        self.add_extra_convs = add_extra_convs
        self.relu_before_extra_convs = relu_before_extra_convs
        used = list(in_channels[start_level:])
        self.n_extra = num_outs - len(used)
        self.lateral_convs = nn.ModuleList(nn.Conv2d(c, out_channels, 1) for c in used)
        self.fpn_convs = nn.ModuleList(
            nn.Conv2d(out_channels, out_channels, 3, padding=1) for _ in used)
        first_in = in_channels[-1] if add_extra_convs == "on_input" else out_channels
        self.extra_convs = nn.ModuleList(
            nn.Conv2d(first_in if i == 0 else out_channels, out_channels, 3,
                      stride=2, padding=1)
            for i in range(self.n_extra if add_extra_convs != "maxpool" else 0))

    def forward(self, inputs: Sequence[torch.Tensor]) -> Tuple[torch.Tensor, ...]:
        used = inputs[self.start_level:]
        laterals = [conv(x) for conv, x in zip(self.lateral_convs, used)]
        for i in range(len(laterals) - 1, 0, -1):
            laterals[i - 1] = laterals[i - 1] + F.interpolate(
                laterals[i], size=laterals[i - 1].shape[2:], mode="nearest")
        outs = [conv(x) for conv, x in zip(self.fpn_convs, laterals)]
        if self.add_extra_convs == "maxpool":
            for _ in range(self.n_extra):
                outs.append(outs[-1][:, :, ::2, ::2])
            return tuple(outs)
        for i, conv in enumerate(self.extra_convs):
            if i == 0:
                src = inputs[-1] if self.add_extra_convs == "on_input" else outs[-1]
            else:
                src = torch.relu(outs[-1]) if self.relu_before_extra_convs else outs[-1]
            outs.append(conv(src))
        return tuple(outs)


def nearest_resize(x: torch.Tensor, size: Sequence[int]) -> torch.Tensor:
    """NCHW nearest-neighbour resize with the JAX package's index rule
    (JAX models/fpn.py:24-31: src = floor(dst * (in / out)) in float64),
    as index gathers; torch's own rule rounds in float32."""
    h, w = x.shape[2:]
    th, tw = int(size[0]), int(size[1])
    rows = torch.from_numpy(np.floor(np.arange(th) * (h / th)).astype(np.int64)).to(x.device)
    cols = torch.from_numpy(np.floor(np.arange(tw) * (w / tw)).astype(np.int64)).to(x.device)
    return x.index_select(2, rows).index_select(3, cols)


def adaptive_max_pool(x: torch.Tensor, size: Sequence[int]) -> torch.Tensor:
    """NCHW adaptive max pool (JAX models/fpn.py:79-102): the window of
    output o spans floor(o * in / out) to ceil((o + 1) * in / out), torch's
    own rule, so F.adaptive_max_pool2d computes it (held to JAX's at the
    BFP's non-integer ratios in tests/test_torch_rcnn_variants.py)."""
    return F.adaptive_max_pool2d(x, (int(size[0]), int(size[1])))


class NonLocal2D(nn.Module):
    """Embedded-Gaussian non-local block with BFP's settings (JAX
    models/fpn.py:105-128, mmcv NonLocal2d at reduction 1 and
    use_scale=False): y = softmax(theta phi^T) g, unscaled, and
    x + conv_out(y)."""

    def __init__(self, channels: int):
        super().__init__()
        self.g = nn.Conv2d(channels, channels, 1)
        self.theta = nn.Conv2d(channels, channels, 1)
        self.phi = nn.Conv2d(channels, channels, 1)
        self.conv_out = nn.Conv2d(channels, channels, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape

        def rows(conv):  # [B, HW, C], positions row-major
            return conv(x).reshape(b, c, h * w).transpose(1, 2)

        theta, phi, g = rows(self.theta), rows(self.phi), rows(self.g)
        attn = torch.softmax(torch.matmul(theta, phi.transpose(1, 2)), dim=-1)
        y = torch.matmul(attn, g).transpose(1, 2).reshape(b, c, h, w)
        return x + self.conv_out(y)


# the profiler range of the BFP (engine/two_stage.py STAGES)
BFP_SPAN = "libra_rcnn.bfp"


class BFP(nn.Module):
    """Balanced Feature Pyramid (Libra R-CNN; JAX models/fpn.py:131-162,
    the reference's mmdet/models/necks/bfp.py:10-101): every level
    gathered at the refine level's size (finer ones max-pooled, coarser
    ones upsampled by nearest neighbour), averaged, refined by a
    non-local block (refine_type "non_local", the reference config's; the
    JAX module's 3x3 "conv" refine is not ported), and scattered back to
    each level as a residual."""

    def __init__(self, channels: int, refine_level: int = 2):
        super().__init__()
        self.refine_level = refine_level
        self.refine = NonLocal2D(channels)

    def forward(self, inputs: Sequence[torch.Tensor]) -> Tuple[torch.Tensor, ...]:
        size = inputs[self.refine_level].shape[2:]
        feats = [adaptive_max_pool(x, size) if i < self.refine_level else nearest_resize(x, size)
                 for i, x in enumerate(inputs)]
        bsf = feats[0]
        for f in feats[1:]:
            bsf = bsf + f
        bsf = self.refine(bsf / len(feats))
        return tuple(x + (nearest_resize(bsf, x.shape[2:]) if i < self.refine_level
                          else adaptive_max_pool(bsf, x.shape[2:]))
                     for i, x in enumerate(inputs))


class PAFPN(nn.Module):
    """Path Aggregation FPN (JAX models/fpn.py:165-206, the reference's
    mmdet/models/necks/pafpn.py:10-160 as configs/pafpn/
    faster_rcnn_r50_pafpn_1x_coco.py sets it): the FPN's top-down pass,
    then a bottom-up path (inter[i + 1] += stride-2 conv(inter[i])), 3x3
    convs on levels 1.. and maxpool extras (stride-2 subsampling)."""

    def __init__(self, in_channels: Sequence[int], out_channels: int = 256,
                 start_level: int = 0, num_outs: int = 5):
        super().__init__()
        self.start_level = start_level
        used = list(in_channels[start_level:])
        self.n_extra = num_outs - len(used)
        self.lateral_convs = nn.ModuleList(nn.Conv2d(c, out_channels, 1) for c in used)
        self.fpn_convs = nn.ModuleList(
            nn.Conv2d(out_channels, out_channels, 3, padding=1) for _ in used)
        self.downsample_convs = nn.ModuleList(
            nn.Conv2d(out_channels, out_channels, 3, stride=2, padding=1)
            for _ in range(len(used) - 1))
        self.pafpn_convs = nn.ModuleList(
            nn.Conv2d(out_channels, out_channels, 3, padding=1) for _ in range(len(used) - 1))

    def forward(self, inputs: Sequence[torch.Tensor]) -> Tuple[torch.Tensor, ...]:
        laterals = [conv(x) for conv, x in zip(self.lateral_convs, inputs[self.start_level:])]
        for i in range(len(laterals) - 1, 0, -1):
            laterals[i - 1] = laterals[i - 1] + nearest_resize(laterals[i],
                                                               laterals[i - 1].shape[2:])
        inter = [conv(x) for conv, x in zip(self.fpn_convs, laterals)]
        for i, conv in enumerate(self.downsample_convs):
            inter[i + 1] = inter[i + 1] + conv(inter[i])
        outs = [inter[0]] + [conv(x) for conv, x in zip(self.pafpn_convs, inter[1:])]
        for _ in range(self.n_extra):
            outs.append(outs[-1][:, :, ::2, ::2])
        return tuple(outs)


# the profiler range of CARAFE's kernel prediction and reassembly
CARAFE_SPAN = "carafe.upsample"


def _carafe_phases(x: torch.Tensor, masks: torch.Tensor, k_up: int, scale: int) -> torch.Tensor:
    """CARAFE's reassembly with the masks in sub-pixel phases: x [B, C, H,
    W], masks [B, s * s, k * k, H, W] (phase sy * s + sx, the fine pixel
    (y * s + sy, x * s + sx)) -> [B, C, H * s, W * s]. Each fine pixel is
    the k x k weighted sum of the source neighbourhood around its parent
    pixel, taken in JAX's order (tap i * k + j, i major), but computed at
    the coarse resolution for the s * s phases at once: JAX's form
    repeats each of the k * k shifted views to the fine grid first
    (JAX models/fpn.py:292-316), the same products in the same order."""
    b, c, h, w = x.shape
    r = k_up // 2
    xp = F.pad(x, (r, r, r, r))
    out = None
    for i in range(k_up):
        for j in range(k_up):
            term = xp[:, None, :, i:i + h, j:j + w] * masks[:, :, i * k_up + j, None]
            out = term if out is None else out + term
    return (out.reshape(b, scale, scale, c, h, w).permute(0, 3, 4, 1, 5, 2)
            .reshape(b, c, h * scale, w * scale))


def carafe_upsample(x: torch.Tensor, masks: torch.Tensor, k_up: int, scale: int) -> torch.Tensor:
    """JAX carafe_upsample (models/fpn.py:292-316) in NCHW: x [B, C, H,
    W], masks [B, k * k, H * s, W * s] (softmaxed over the k * k taps)
    -> [B, C, H * s, W * s]."""
    b, kk, fh, fw = masks.shape
    h, w = fh // scale, fw // scale
    phases = (masks.reshape(b, kk, h, scale, w, scale).permute(0, 3, 5, 1, 2, 4)
              .reshape(b, scale * scale, kk, h, w))
    return _carafe_phases(x, phases, k_up, scale)


class CARAFE(nn.Module):
    """The CARAFE upsampler (JAX models/fpn.py:319-343, mmcv ops/carafe.py
    with configs/carafe/*.py's c_mid 64, k_encoder 3, k_up 5, scale 2): a
    1x1 channel compressor, a k_encoder conv predicting k_up^2 * s^2
    kernel weights per coarse pixel (channel (sy * s + sx) * k_up^2 +
    tap, JAX's pixel-shuffle order), a softmax over the taps, then the
    reassembly."""

    def __init__(self, channels: int, c_mid: int = 64, k_encoder: int = 3, k_up: int = 5,
                 scale: int = 2):
        super().__init__()
        self.k_up, self.scale = k_up, scale
        self.channel_compressor = nn.Conv2d(channels, c_mid, 1)
        self.content_encoder = nn.Conv2d(c_mid, k_up * k_up * scale * scale, k_encoder,
                                         padding=k_encoder // 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, _, h, w = x.shape
        s, k = self.scale, self.k_up
        with span(CARAFE_SPAN):
            m = self.content_encoder(self.channel_compressor(x))
            m = torch.softmax(m.reshape(b, s * s, k * k, h, w), dim=2)
            return _carafe_phases(x.float(), m, k, s)


class FPNCARAFE(nn.Module):
    """The FPN whose top-down upsampling is CARAFE (JAX models/fpn.py:
    346-369, the reference's mmdet/models/necks/fpn_carafe.py with
    configs/carafe/faster_rcnn_r50_fpn_carafe_1x_coco.py): 1x1 laterals on
    every input, lateral[i - 1] += CARAFE_i(lateral[i]) cropped to its
    size, 3x3 output convs, and maxpool extras (stride-2 subsampling)."""

    def __init__(self, in_channels: Sequence[int], out_channels: int = 256, num_outs: int = 5):
        super().__init__()
        self.num_outs = num_outs
        self.lateral_convs = nn.ModuleList(nn.Conv2d(c, out_channels, 1) for c in in_channels)
        self.carafe = nn.ModuleDict({str(i): CARAFE(out_channels)
                                     for i in range(len(in_channels) - 1, 0, -1)})
        self.fpn_convs = nn.ModuleList(
            nn.Conv2d(out_channels, out_channels, 3, padding=1) for _ in in_channels)

    def forward(self, inputs: Sequence[torch.Tensor]) -> Tuple[torch.Tensor, ...]:
        lats = [conv(x) for conv, x in zip(self.lateral_convs, inputs)]
        for i in range(len(lats) - 1, 0, -1):
            up = self.carafe[str(i)](lats[i])
            h, w = lats[i - 1].shape[2:]
            lats[i - 1] = lats[i - 1] + up[:, :, :h, :w]
        outs = [conv(x) for conv, x in zip(self.fpn_convs, lats)]
        while len(outs) < self.num_outs:
            outs.append(outs[-1][:, :, ::2, ::2])
        return tuple(outs)
