"""Faster R-CNN R50-FPN (torch): the RPN head, the shared 2-fc box head
and the detector that holds them.

Port of aod_meh_hua_tpu/models/two_stage.py (`RPNHead` :32-61,
`Shared2FCBBoxHead` :64-97, `FasterRCNN` :100-212 in its ResNet + FPN
form, `build_faster_rcnn` :273), which mirrors the reference's
configs/_base_/models/faster_rcnn_r50_fpn.py: R50 + FPN (start_level 0,
5 outputs, P6 by stride-2 subsampling), RPNHead (3x3 conv + ReLU, then
1x1 objectness and deltas over 3 anchors, rpn_head.py:29-43) and
Shared2FCBBoxHead (two fc1024, softmax C+1 classes with the background
last, class-specific deltas, convfc_bbox_head.py).

The modules hold weights and the three stage forwards (`features`,
`rpn`, `roi_forward`); the proposals, sampling and targets live in
engine/two_stage.py. Public layouts are the JAX package's: images
[B, H, W, 3] in; RPN outputs flattened to [B, A_tot] and [B, A_tot, 4]
in ops/anchors.py's cell-major, anchor-minor order; RoI features
[R, 7, 7, C], which the first fc reads flattened in (h, w, c) order, as
the JAX head flattens them (an mmdet .pth reads (c, h, w): its import
waits for the reference-checkpoint part of ROADMAP Queue 1 item 15).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence, Tuple

import torch
from torch import nn

from ..utils.config import FasterRCNNConfig
from ..utils.device import resolve_device
from .detector import flatten_levels
from .fpn import FPN
from .resnet import ResNet

# the config's fields that select a variant of the family; the port builds
# the form their defaults describe
_VARIANT_FIELDS = ("backbone_type", "neck_type", "backbone_dcn", "backbone_gcb_ratio",
                   "roi_extractor", "bfp_refine_level", "bfp_refine_type", "num_bins",
                   "balanced_l1_alpha", "balanced_l1_gamma", "balanced_l1_beta")


def check_two_stage_options(cfg) -> None:
    """Raise on a config the port cannot build: another family, a variant
    of the Faster R-CNN family (ROADMAP Queue 1 item 15), bfloat16 compute
    (item 16), remat or the space-to-depth stem (item 16)."""
    family = getattr(cfg, "family", None)
    if family != "faster_rcnn":
        raise NotImplementedError(
            f"the {family} family is not ported yet (ROADMAP Queue 1 item 15)")
    defaults = {f.name: f.default for f in dataclasses.fields(FasterRCNNConfig)}
    for name in _VARIANT_FIELDS:
        if getattr(cfg, name) != defaults[name]:
            raise NotImplementedError(
                f"{name}={getattr(cfg, name)!r}: the port builds Faster R-CNN with the "
                "ResNet + FPN trunk only; the family's variants are not ported yet "
                "(ROADMAP Queue 1 item 15)")
    if cfg.compute_dtype != "float32":
        raise NotImplementedError(
            f"compute_dtype={cfg.compute_dtype!r}: the port's model runs float32 "
            "(ROADMAP Queue 1 item 16)")
    for flag in ("remat", "stem_s2d"):
        if getattr(cfg, flag):
            raise NotImplementedError(f"{flag}: not in the port yet (ROADMAP Queue 1 item 16)")


class RPNHead(nn.Module):
    """Shared 3x3 conv + ReLU, then 1x1 objectness (A) and deltas (A * 4)."""

    def __init__(self, in_channels: int, num_anchors: int = 3):
        super().__init__()
        self.rpn_conv = nn.Conv2d(in_channels, in_channels, 3, padding=1)
        self.rpn_cls = nn.Conv2d(in_channels, num_anchors, 1)
        self.rpn_reg = nn.Conv2d(in_channels, num_anchors * 4, 1)

    @torch.no_grad()
    def init_weights(self, gen: torch.Generator) -> None:
        """Normal(0.01) weights, zero biases (the JAX head's initialisers)."""
        for m in (self.rpn_conv, self.rpn_cls, self.rpn_reg):
            m.weight.copy_(torch.randn(m.weight.shape, generator=gen) * 0.01)
            m.bias.zero_()

    def forward(self, feats: Sequence[torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
        """Per-level maps -> (objectness [B, A_tot], deltas [B, A_tot, 4]), f32."""
        cls_maps, reg_maps = [], []
        for f in feats:
            x = torch.relu(self.rpn_conv(f))
            cls_maps.append(self.rpn_cls(x))
            reg_maps.append(self.rpn_reg(x))
        return (flatten_levels(cls_maps, 1)[..., 0].float(),
                flatten_levels(reg_maps, 4).float())


class Shared2FCBBoxHead(nn.Module):
    """RoI features [R, S, S, C], flattened (h, w, c) -> fc -> fc ->
    (cls [R, C + 1], class-specific deltas [R, num_classes, 4])."""

    def __init__(self, num_classes: int, in_channels: int, roi_size: int = 7,
                 fc_channels: int = 1024):
        super().__init__()
        self.num_classes = num_classes
        self.shared_fcs = nn.ModuleList([
            nn.Linear(roi_size * roi_size * in_channels, fc_channels),
            nn.Linear(fc_channels, fc_channels)])
        self.fc_cls = nn.Linear(fc_channels, num_classes + 1)
        self.fc_reg = nn.Linear(fc_channels, num_classes * 4)

    @torch.no_grad()
    def init_weights(self, gen: torch.Generator) -> None:
        """Xavier-uniform shared fcs, Normal(0.01) fc_cls, Normal(0.001)
        fc_reg, zero biases (convfc_bbox_head.py's init_cfg)."""
        for fc in self.shared_fcs:
            out_f, in_f = fc.weight.shape
            bound = math.sqrt(6.0 / (in_f + out_f))
            fc.weight.copy_((torch.rand(fc.weight.shape, generator=gen) * 2 - 1) * bound)
        self.fc_cls.weight.copy_(torch.randn(self.fc_cls.weight.shape, generator=gen) * 0.01)
        self.fc_reg.weight.copy_(torch.randn(self.fc_reg.weight.shape, generator=gen) * 0.001)
        for fc in (*self.shared_fcs, self.fc_cls, self.fc_reg):
            fc.bias.zero_()

    def forward(self, roi_feats: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        x = roi_feats.reshape(roi_feats.shape[0], -1)
        for fc in self.shared_fcs:
            x = torch.relu(fc(x))
        return self.fc_cls(x).float(), self.fc_reg(x).float().reshape(-1, self.num_classes, 4)


class FasterRCNN(nn.Module):
    """Weights and stage forwards; the orchestration is engine/two_stage.py."""

    def __init__(self, cfg: FasterRCNNConfig):
        super().__init__()
        check_two_stage_options(cfg)
        self.cfg = cfg
        self.backbone = ResNet(cfg.block_counts, cfg.stem_width)
        self.neck = FPN(cfg.backbone_channels, cfg.fpn_channels, start_level=0,
                        num_outs=len(cfg.rpn.anchor_strides), add_extra_convs="maxpool")
        self.rpn_head = RPNHead(cfg.fpn_channels, cfg.rpn.num_anchors)
        self.bbox_head = Shared2FCBBoxHead(cfg.num_classes, cfg.fpn_channels,
                                           cfg.rcnn.roi_size, cfg.rcnn.fc_channels)

    @torch.no_grad()
    def init_weights(self, seed: int) -> None:
        """Seeded init on the CPU: LeCun-normal backbone and neck convs,
        zero neck biases, the heads' own init; BN at identity statistics."""
        gen = torch.Generator().manual_seed(seed)
        for m in list(self.backbone.modules()) + list(self.neck.modules()):
            if isinstance(m, nn.Conv2d):
                fan_in = m.weight[0].numel()
                m.weight.copy_(torch.randn(m.weight.shape, generator=gen) * fan_in ** -0.5)
                if m.bias is not None:
                    m.bias.zero_()
        self.rpn_head.init_weights(gen)
        self.bbox_head.init_weights(gen)

    def features(self, images: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        """images [B, H, W, 3] -> the FPN levels P2..P6, NCHW (channels_last)."""
        x = images.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
        return self.neck(self.backbone(x))

    def rpn(self, feats: Sequence[torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
        return self.rpn_head(feats)

    def roi_forward(self, roi_feats: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        return self.bbox_head(roi_feats)

    def forward(self, images: torch.Tensor):
        """The stage-1 forward: (FPN levels, objectness, deltas)."""
        feats = self.features(images)
        return (feats,) + self.rpn(feats)


def build_faster_rcnn(cfg: FasterRCNNConfig, device="cuda", seed: int = 0) -> FasterRCNN:
    """A seeded Faster R-CNN in eval mode on `device` (channels_last).
    Raises when device is CUDA and there is no card."""
    dev = resolve_device(device)
    model = FasterRCNN(cfg)
    model.init_weights(seed)
    return model.to(device=dev, memory_format=torch.channels_last).eval()
