"""The TridentNet model (torch): a C4 Faster R-CNN whose stage-3 3x3
convs share one kernel over three dilations.

Port of aod_meh_hua_tpu/models/trident.py (`TridentConv3x3` :36-67,
`TridentBottleneck` :70-102, `TridentResNetC4` :105-144,
`ResLayerBBoxHead` :147-173, `TridentFasterRCNN` :176-206), which
mirrors the reference's mmdet/models/backbones/trident_resnet.py
(TridentConv :13, one shared kernel at dilations (1, 2, 3);
TridentBottleneck :92, conv2 tridented, the rest shared;
TridentResNet :234, branches concatenated on the batch axis),
detectors/trident_faster_rcnn.py (:60, the gts replicated branch-major
in training; :33, only branch test_branch_idx at test) and
configs/_base_/models/faster_rcnn_r50_caffe_c4.py (three ResNet stages to
C4 at stride 16, the RPN with 15 anchors on C4, RoIAlign 14 on the one
level, the conv5 ResLayer at stride 2 and an average-pooled box head).

The branches ride the batch axis branch-major: row r * B + i is image i
in branch r. Every BN is frozen (caffe norm_eval), an affine map, so one
forward of the folded batch equals three. The branch convs run in the
profiler range BRANCH_SPAN.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..utils.profiling import span
from .resnet import Bottleneck, FrozenBatchNorm2d, _conv
from .two_stage import RPNHead, _lecun_normal_convs

# the profiler range of the tridented stage 3 (engine/two_stage.py STAGES)
BRANCH_SPAN = "trident.branches"


class TridentConv3x3(nn.Module):
    """One 3x3 kernel [out, in, 3, 3]; branch r runs it at dilation and
    padding dilations[r]. The input is [R * B, C, H, W] branch-major, or
    [B, C, H, W] for the single branch `single_branch_idx`."""

    def __init__(self, in_channels: int, out_channels: int, stride: int = 1,
                 dilations: Sequence[int] = (1, 2, 3)):
        super().__init__()
        self.stride, self.dilations = stride, tuple(dilations)
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels, 3, 3))

    def _conv(self, x: torch.Tensor, d: int) -> torch.Tensor:
        return F.conv2d(x, self.weight, stride=self.stride, padding=d, dilation=d)

    def forward(self, x: torch.Tensor, single_branch_idx=None) -> torch.Tensor:
        if single_branch_idx is not None:
            return self._conv(x, self.dilations[single_branch_idx])
        branches = x.chunk(len(self.dilations), dim=0)
        return torch.cat([self._conv(v, d) for v, d in zip(branches, self.dilations)])


class TridentBottleneck(nn.Module):
    """A bottleneck whose conv2 is tridented; the 1x1 convs, the frozen
    BN and the downsample run on the folded batch."""

    def __init__(self, inplanes: int, planes: int, stride: int = 1, downsample: bool = False,
                 dilations: Sequence[int] = (1, 2, 3)):
        super().__init__()
        self.conv1 = _conv(inplanes, planes, 1)
        self.bn1 = FrozenBatchNorm2d(planes)
        self.conv2 = TridentConv3x3(planes, planes, stride, dilations)
        self.bn2 = FrozenBatchNorm2d(planes)
        self.conv3 = _conv(planes, planes * 4, 1)
        self.bn3 = FrozenBatchNorm2d(planes * 4)
        self.downsample = (nn.Sequential(_conv(inplanes, planes * 4, 1, stride),
                                         FrozenBatchNorm2d(planes * 4)) if downsample else None)

    def forward(self, x: torch.Tensor, single_branch_idx=None) -> torch.Tensor:
        y = torch.relu(self.bn1(self.conv1(x)))
        y = torch.relu(self.bn2(self.conv2(y, single_branch_idx)))
        y = self.bn3(self.conv3(y))
        identity = x if self.downsample is None else self.downsample(x)
        return torch.relu(y + identity)


class TridentResNetC4(nn.Module):
    """The stem, two plain stages and the tridented stage 3 -> C4 (stride
    16). Training: [B] images -> [R * B] branch-major maps; eval
    (single_branch): [B] -> [B] at dilations[test_branch_idx]."""

    def __init__(self, block_counts: Sequence[int] = (3, 4, 6), stem_width: int = 64,
                 dilations: Sequence[int] = (1, 2, 3), test_branch_idx: int = 1):
        super().__init__()
        self.num_branches, self.test_branch_idx = len(dilations), test_branch_idx
        self.conv1 = _conv(3, stem_width, 7, 2, 3)
        self.bn1 = FrozenBatchNorm2d(stem_width)
        self.maxpool = nn.MaxPool2d(3, stride=2, padding=1)
        inplanes = stem_width
        for stage in (0, 1):
            planes = stem_width * 2 ** stage
            blocks = []
            for b in range(block_counts[stage]):
                blocks.append(Bottleneck(inplanes, planes, 2 if (stage > 0 and b == 0) else 1,
                                         downsample=(b == 0)))
                inplanes = planes * 4
            self.add_module(f"layer{stage + 1}", nn.Sequential(*blocks))
        planes = stem_width * 4
        self.layer3 = nn.ModuleList()
        for b in range(block_counts[2]):
            self.layer3.append(TridentBottleneck(inplanes, planes, 2 if b == 0 else 1,
                                                 downsample=(b == 0), dilations=dilations))
            inplanes = planes * 4

    def forward(self, x: torch.Tensor, single_branch: bool = False) -> torch.Tensor:
        x = self.maxpool(torch.relu(self.bn1(self.conv1(x))))
        x = self.layer2(self.layer1(x))
        idx = self.test_branch_idx if single_branch else None
        with span(BRANCH_SPAN):
            if not single_branch:  # branch-major: row r * B + i
                x = x.repeat(self.num_branches, 1, 1, 1)
            for block in self.layer3:
                x = block(x, idx)
        return x


class ResLayerBBoxHead(nn.Module):
    """The C4 RoI head: the conv5 ResLayer (stride 2, 14x14 -> 7x7) over
    roi_feats [R, S, S, C], the average pool, linear cls (C + 1) and
    class-specific deltas: (cls [R, C + 1], deltas [R, C, 4])."""

    def __init__(self, num_classes: int, in_channels: int, head_blocks: int = 3,
                 head_planes: int = 512):
        super().__init__()
        self.num_classes = num_classes
        blocks, inplanes = [], in_channels
        for b in range(head_blocks):
            blocks.append(Bottleneck(inplanes, head_planes, 2 if b == 0 else 1,
                                     downsample=(b == 0)))
            inplanes = head_planes * 4
        self.layer4 = nn.Sequential(*blocks)
        self.fc_cls = nn.Linear(inplanes, num_classes + 1)
        self.fc_reg = nn.Linear(inplanes, num_classes * 4)

    @torch.no_grad()
    def init_weights(self, gen: torch.Generator) -> None:
        """LeCun-normal convs, Normal(0.01) fc_cls, Normal(0.001) fc_reg,
        zero biases (the JAX head's initialisers)."""
        _lecun_normal_convs(self.modules(), gen)
        self.fc_cls.weight.copy_(torch.randn(self.fc_cls.weight.shape, generator=gen) * 0.01)
        self.fc_reg.weight.copy_(torch.randn(self.fc_reg.weight.shape, generator=gen) * 0.001)
        self.fc_cls.bias.zero_()
        self.fc_reg.bias.zero_()

    def forward(self, roi_feats: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        x = self.layer4(roi_feats.permute(0, 3, 1, 2).contiguous(
            memory_format=torch.channels_last)).mean(dim=(2, 3))
        return (self.fc_cls(x).float(),
                self.fc_reg(x).float().reshape(-1, self.num_classes, 4))


class TridentFasterRCNN(nn.Module):
    """The TridentNet backbone, the RPN head on C4 (num_anchors_per_cell
    anchors) and the ResLayer box head."""

    def __init__(self, cfg):
        super().__init__()
        self.cfg = cfg
        self.backbone = TridentResNetC4(cfg.block_counts, cfg.stem_width, cfg.trident_dilations,
                                        cfg.test_branch_idx)
        self.rpn_head = RPNHead(cfg.stem_width * 16, cfg.num_anchors_per_cell)
        self.bbox_head = ResLayerBBoxHead(cfg.num_classes, cfg.stem_width * 16, cfg.head_blocks,
                                          cfg.stem_width * 8)

    @torch.no_grad()
    def init_weights(self, seed: int) -> None:
        """Seeded init on the CPU: LeCun-normal backbone convs (the shared
        trident kernels too), BN at identity, the heads' own init."""
        gen = torch.Generator().manual_seed(seed)
        _lecun_normal_convs(self.backbone.modules(), gen)
        for m in self.backbone.modules():
            if isinstance(m, TridentConv3x3):
                m.weight.copy_(torch.randn(m.weight.shape, generator=gen)
                               * m.weight[0].numel() ** -0.5)
        self.rpn_head.init_weights(gen)
        self.bbox_head.init_weights(gen)

    def _roi_heads(self):
        return [self.bbox_head]

    def features(self, images: torch.Tensor, single_branch: bool = False) -> torch.Tensor:
        """images [B, H, W, 3] -> C4 [R * B, C, H/16, W/16] (channels_last),
        or [B, ...] for the test branch alone."""
        x = images.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
        return self.backbone(x, single_branch)

    def rpn(self, feat: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        return self.rpn_head([feat])

    def roi_forward(self, roi_feats: torch.Tensor):
        return self.bbox_head(roi_feats)

    def forward(self, images: torch.Tensor, single_branch: bool = True):
        """(C4, objectness [rows, A], deltas [rows, A, 4]), the test branch
        alone by default."""
        feat = self.features(images, single_branch)
        return (feat,) + self.rpn(feat)
