"""GN + Weight Standardization Faster R-CNN (torch).

Port of aod_meh_hua_tpu/models/gn_ws.py (`ConvWS` :31-56, `_gn` :59-61,
`WSBottleneck` :64-92, `WSResNet` :95-117, `WSFPN` :120-154,
`Shared4Conv1FCBBoxHead` :157-186; `GNWSFasterRCNN` :189-224 is
models/two_stage.py's), which
mirrors the reference's configs/gn+ws/faster_rcnn_r50_fpn_gn_ws-all_1x_coco.py
(ConvWS + GroupNorm(32) in place of conv + BN in the backbone and the
FPN; the Shared4Conv1FCBBoxHead RoI head: four ConvWS + GN + ReLU convs,
then one fc1024). weight_standardize=False is the plain-GN 'gn' family.

ConvWS standardises its kernel per output channel over (in, kh, kw) with
the POPULATION std (ddof 0) plus 1e-5, as the JAX package does (mmcv's
conv_ws_2d takes torch's unbiased std; the port follows the JAX
package). GroupNorm(min(32, C), eps 1e-5) computes in float32. The GN
layers train: only conv1 and layer1 are frozen (engine/train.py's mask
by name, as JAX's). Module names are the JAX package's (gn{i},
downsample_gn as downsample.1, lateral_gn_{i}, fpn_gn_{i},
shared_conv_{i}, shared_gn_{i}).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

WS_EPS = 1e-5


class ConvWS(nn.Conv2d):
    """A bias-free conv whose kernel is standardised per output channel
    before it is applied: (w - mean) / (std + 1e-5), std with ddof 0; with
    ws False a plain conv. Padding (k - 1) // 2."""

    def __init__(self, cin: int, cout: int, kernel: int = 3, stride: int = 1, ws: bool = True):
        super().__init__(cin, cout, kernel, stride=stride, padding=(kernel - 1) // 2, bias=False)
        self.ws = ws

    def standardized_weight(self) -> torch.Tensor:
        w = self.weight
        if not self.ws:
            return w
        mean = w.mean(dim=(1, 2, 3), keepdim=True)
        std = w.std(dim=(1, 2, 3), keepdim=True, unbiased=False) + WS_EPS
        return (w - mean) / std

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv2d(x, self.standardized_weight(), None, self.stride, self.padding)


def group_norm(channels: int) -> nn.GroupNorm:
    """GroupNorm(min(32, C) groups, eps 1e-5), the JAX package's _gn."""
    return nn.GroupNorm(min(32, channels), channels, eps=1e-5)


class WSBottleneck(nn.Module):
    def __init__(self, inplanes: int, planes: int, stride: int = 1, downsample: bool = False,
                 ws: bool = True):
        super().__init__()
        self.conv1 = ConvWS(inplanes, planes, 1, ws=ws)
        self.gn1 = group_norm(planes)
        self.conv2 = ConvWS(planes, planes, 3, stride, ws=ws)
        self.gn2 = group_norm(planes)
        self.conv3 = ConvWS(planes, planes * 4, 1, ws=ws)
        self.gn3 = group_norm(planes * 4)
        self.downsample = None
        if downsample:
            self.downsample = nn.Sequential(ConvWS(inplanes, planes * 4, 1, stride, ws=ws),
                                            group_norm(planes * 4))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.relu(self.gn1(self.conv1(x)))
        y = torch.relu(self.gn2(self.conv2(y)))
        y = self.gn3(self.conv3(y))
        identity = x if self.downsample is None else self.downsample(x)
        return torch.relu(y + identity)


class WSResNet(nn.Module):
    """The ResNet with ConvWS + GN; returns (C2..C5)."""

    def __init__(self, block_counts: Sequence[int] = (3, 4, 6, 3), stem_width: int = 64,
                 ws: bool = True):
        super().__init__()
        self.conv1 = ConvWS(3, stem_width, 7, 2, ws=ws)
        self.gn1 = group_norm(stem_width)
        self.maxpool = nn.MaxPool2d(3, stride=2, padding=1)
        inplanes, self.stages = stem_width, []
        for stage, n in enumerate(block_counts):
            planes, blocks = stem_width * 2 ** stage, []
            for b in range(n):
                blocks.append(WSBottleneck(inplanes, planes, 2 if (stage > 0 and b == 0) else 1,
                                           b == 0, ws))
                inplanes = planes * 4
            name = f"layer{stage + 1}"
            self.add_module(name, nn.Sequential(*blocks))
            self.stages.append(name)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        x = self.maxpool(torch.relu(self.gn1(self.conv1(x))))
        outs = []
        for name in self.stages:
            x = getattr(self, name)(x)
            outs.append(x)
        return tuple(outs)


class WSFPN(nn.Module):
    """The FPN with ConvWS + GN lateral and output convs, no activation
    (mmdet's FPN ConvModules), the top-down nearest x2 cropped to the
    finer level, the extra level a stride-2 max pool of window 1."""

    def __init__(self, in_channels: Sequence[int], out_channels: int = 256, num_outs: int = 5,
                 ws: bool = True):
        super().__init__()
        c, self.num_outs = out_channels, num_outs
        self.lateral_convs = nn.ModuleList(ConvWS(ci, c, 1, ws=ws) for ci in in_channels)
        self.fpn_convs = nn.ModuleList(ConvWS(c, c, 3, ws=ws) for _ in in_channels)
        for i in range(len(in_channels)):
            self.add_module(f"lateral_gn_{i}", group_norm(c))
            self.add_module(f"fpn_gn_{i}", group_norm(c))

    def forward(self, inputs: Sequence[torch.Tensor]) -> Tuple[torch.Tensor, ...]:
        lats = [getattr(self, f"lateral_gn_{i}")(conv(f))
                for i, (conv, f) in enumerate(zip(self.lateral_convs, inputs))]
        for i in range(len(lats) - 2, -1, -1):
            up = lats[i + 1].repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)
            lats[i] = lats[i] + up[:, :, :lats[i].shape[2], :lats[i].shape[3]]
        outs = [getattr(self, f"fpn_gn_{i}")(conv(f))
                for i, (conv, f) in enumerate(zip(self.fpn_convs, lats))]
        while len(outs) < self.num_outs:
            outs.append(outs[-1][:, :, ::2, ::2])
        return tuple(outs)


class Shared4Conv1FCBBoxHead(nn.Module):
    """RoI features [R, S, S, C] -> four ConvWS + GN + ReLU 3x3 convs ->
    flattened (h, w, c), as the port's other heads -> fc1024 -> (cls
    [R, C + 1], class-specific deltas [R, num_classes, 4])."""

    def __init__(self, num_classes: int, in_channels: int, roi_size: int = 7,
                 conv_channels: int = 256, fc_channels: int = 1024, ws: bool = True):
        super().__init__()
        self.num_classes = num_classes
        cin = in_channels
        for i in range(4):
            self.add_module(f"shared_conv_{i}", ConvWS(cin, conv_channels, 3, ws=ws))
            self.add_module(f"shared_gn_{i}", group_norm(conv_channels))
            cin = conv_channels
        self.shared_fcs = nn.ModuleList([nn.Linear(roi_size * roi_size * conv_channels,
                                                   fc_channels)])
        self.fc_cls = nn.Linear(fc_channels, num_classes + 1)
        self.fc_reg = nn.Linear(fc_channels, num_classes * 4)

    @torch.no_grad()
    def init_weights(self, gen: torch.Generator) -> None:
        """LeCun-normal convs, Xavier-uniform shared fc, Normal(0.01)
        fc_cls, Normal(0.001) fc_reg, zero biases, GN at identity."""
        from .two_stage import _lecun_normal_convs, _xavier_uniform

        _lecun_normal_convs(self.modules(), gen)
        _xavier_uniform(self.shared_fcs[0], gen)
        self.fc_cls.weight.copy_(torch.randn(self.fc_cls.weight.shape, generator=gen) * 0.01)
        self.fc_reg.weight.copy_(torch.randn(self.fc_reg.weight.shape, generator=gen) * 0.001)
        for fc in (*self.shared_fcs, self.fc_cls, self.fc_reg):
            fc.bias.zero_()

    def forward(self, roi_feats: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        x = roi_feats.permute(0, 3, 1, 2)
        for i in range(4):
            x = torch.relu(getattr(self, f"shared_gn_{i}")(getattr(self, f"shared_conv_{i}")(x)))
        x = torch.relu(self.shared_fcs[0](x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)))
        return (self.fc_cls(x).float(),
                self.fc_reg(x).float().reshape(-1, self.num_classes, 4))
