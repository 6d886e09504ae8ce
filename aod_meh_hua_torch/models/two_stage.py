"""The two-stage detectors (torch): Faster R-CNN R50-FPN and its Cascade,
Dynamic and Double-Head forms, and the Faster R-CNN variants on its
model (Libra R-CNN, PAFPN, CARAFE, GRoIE, empirical attention, PISA,
HRNet, ResNeSt, FPG, the backbone_type switches of models/backbones.py)
or on its surface (GN+WS, `GNWSFasterRCNN`); the RPN head, the shared
2-fc box head, the double head, and the detectors that hold them. The
proposal families (RPN-only, Fast R-CNN, Cascade RPN, TridentNet, Grid
R-CNN) have their models in models/rpn_only.py, cascade_rpn.py,
trident.py and grid_rcnn.py, built here (`build_two_stage`).

Port of aod_meh_hua_tpu/models/two_stage.py (`RPNHead` :32-61,
`Shared2FCBBoxHead` :64-97, `FasterRCNN` :100-212 with the ResNet
backbone, its attention plugin, the FPN, PAFPN and CARAFE necks, the BFP
and GRoIE's `groie_fuse`, `CascadeRCNN` :215-256, `build_faster_rcnn` :273 as `build_two_stage`,
`_HeadBottleneck`, `BasicResBlock`, `DoubleConvFCBBoxHead` and
`DoubleHeadRCNN` :291-420),
which mirrors the reference's configs/_base_/models/faster_rcnn_r50_fpn.py:
R50 + FPN (start_level 0, 5 outputs, P6 by stride-2 subsampling), RPNHead
(3x3 conv + ReLU, then 1x1 objectness and deltas over 3 anchors,
rpn_head.py:29-43) and Shared2FCBBoxHead (two fc1024, softmax C+1
classes with the background last, class-specific deltas,
convfc_bbox_head.py); cascade_rcnn_r50_fpn.py's three class-agnostic
heads; double_bbox_head.py's conv regression branch and fc
classification branch. Dynamic R-CNN's model is Faster R-CNN's (JAX
api.py:56) with its training statistics as buffers (`DynamicState`),
which the JAX package keeps under batch_stats["__dynamic_rcnn__"]
(engine/two_stage.py:479-495).

The modules hold weights and the stage forwards (`features`, `rpn`,
`roi_forward`); the proposals, sampling and targets live in
engine/two_stage.py. Public layouts are the JAX package's: images
[B, H, W, 3] in; RPN outputs flattened to [B, A_tot] and [B, A_tot, 4]
in ops/anchors.py's cell-major, anchor-minor order; RoI features
[R, 7, 7, C], which the first fc reads flattened in (h, w, c) order, as
the JAX head flattens them (an mmdet .pth reads (c, h, w): its import
waits for the reference-checkpoint part of ROADMAP Queue 1 item 15).

The double head's BatchNorm trains while the backbone's stays frozen,
and the model is kept in eval mode, so its `roi_forward` takes `train`
as the JAX head does (`HeadBatchNorm2d`: flax's statistics, below).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence, Tuple

import torch
from torch import nn

from ..utils.config import FasterRCNNConfig
from ..utils.device import resolve_device
from ..utils.profiling import span
from .attention import ATTENTION_SPAN, GeneralizedAttention
from .backbones import BACKBONES, build_backbone
from .detector import SkipDefaultInit, flatten_levels
from .fpg import FPG, FPG_SPAN
from .fpn import BFP, BFP_SPAN, CARAFE_SPAN, FPN, FPNCARAFE, PAFPN
from .gn_ws import Shared4Conv1FCBBoxHead, WSFPN, WSResNet
from .hrnet import HRFPN, HRFPN_SPAN
from .resnest import SplitAttentionConv

# the config's fields that select a variant of the Faster R-CNN family
# (the JAX package's subclasses' switches); the Cascade, Dynamic and
# Double-Head families take none of them, as their JAX models read none
_VARIANT_FIELDS = ("backbone_type", "neck_type", "backbone_dcn", "backbone_gcb_ratio",
                   "roi_extractor", "bfp_refine_level", "bfp_refine_type", "num_bins",
                   "balanced_l1_alpha", "balanced_l1_gamma", "balanced_l1_beta",
                   "backbone_attention")
# the families on the Faster R-CNN model and step or on its step (GN+WS's
# model, PISA's step), which take the variant fields (JAX api.py:50-104,
# tools/train_detector.py:128-132, 185-188)
FASTER_RCNN_VARIANTS = ("faster_rcnn", "libra_rcnn", "pafpn", "carafe", "hrnet", "resnest",
                        "groie", "empirical_attention", "fpg", "gn_ws", "pisa_faster_rcnn")
# the necks of the port (models/fpn.py, hrnet.py, fpg.py); nasfpn is not ported
NECKS = ("fpn", "pafpn", "carafe_fpn", "hrfpn", "fpg")
# the necks whose levels must halve exactly down to the coarsest anchor stride
# (HRFPN's VALID pools, FPG's across-down sums)
_EXACT_PYRAMID_NECKS = ("hrfpn", "fpg")


def check_two_stage_options(cfg) -> None:
    """Raise on a config the port cannot build: another family; on the
    Faster R-CNN variants, a deformable conv or GCNet block (ROADMAP
    Queue 1 item 15.5), another backbone, neck, BFP refine or RoI
    extractor (item 15); any variant field on the Cascade, Dynamic and
    Double-Head families (item 15); bfloat16 compute (item 16), remat or
    the space-to-depth stem (item 16). A ValueError for an HRFPN or FPG
    neck on a canvas whose sides do not divide by its coarsest anchor
    stride (check_canvas)."""
    family = getattr(cfg, "family", None)
    if family not in TWO_STAGE_FAMILIES:
        raise NotImplementedError(
            f"the {family} family is not ported yet (ROADMAP Queue 1 item 15)")
    defaults = {f.name: f.default for f in dataclasses.fields(FasterRCNNConfig)}
    defaults["backbone_attention"] = None
    if family not in FASTER_RCNN_VARIANTS:
        for name in _VARIANT_FIELDS:
            if getattr(cfg, name, None) != defaults[name]:
                raise NotImplementedError(
                    f"{name}={getattr(cfg, name)!r} on {family}: the variant switches of "
                    "Faster R-CNN are not ported for this family (ROADMAP Queue 1 item 15)")
    for name in ("backbone_dcn", "backbone_gcb_ratio"):
        if getattr(cfg, name) is not None:
            raise NotImplementedError(
                f"{name}={getattr(cfg, name)!r}: the deformable convs and GCNet blocks come "
                "with models/deform.py (ROADMAP Queue 1 item 15.5)")
    for name, ok in (("backbone_type", cfg.backbone_type in BACKBONES),
                     ("neck_type", cfg.neck_type in NECKS),
                     ("bfp_refine_type", cfg.bfp_refine_type == "non_local"),
                     ("roi_extractor", cfg.roi_extractor in ("single", "groie"))):
        if not ok:
            raise NotImplementedError(f"{name}={getattr(cfg, name)!r}: {_NOT_PORTED_VARIANT}")
    if cfg.compute_dtype != "float32":
        raise NotImplementedError(
            f"compute_dtype={cfg.compute_dtype!r}: the port's model runs float32 "
            "(ROADMAP Queue 1 item 16)")
    for flag in ("remat", "stem_s2d"):
        if getattr(cfg, flag):
            raise NotImplementedError(f"{flag}: not in the port yet (ROADMAP Queue 1 item 16)")
    check_canvas(cfg)


def check_canvas(cfg) -> None:
    """HRFPN and FPG need every pyramid level to halve exactly: HRFPN's
    VALID average pools give floor(side / 64) rows at P6 where the anchor
    table takes the ceiling, and FPG's across-down transition adds a
    doubled P6 to P5, so a side that does not divide by the coarsest
    anchor stride fails in the JAX package (a short RPN output, a shape
    error). The port refuses such a canvas, in either orientation, here."""
    if cfg.neck_type not in _EXACT_PYRAMID_NECKS:
        return
    stride = max(cfg.rpn.anchor_strides)
    level = len(cfg.rpn.anchor_strides) + 1  # P2 is the first level
    for side, n in zip(("height", "width"), cfg.canvas):
        if n % stride:
            raise ValueError(
                f"{cfg.family}: canvas {tuple(cfg.canvas)}: its {side} {n} does not divide by "
                f"{stride}, the stride of the {cfg.neck_type} neck's level P{level}, so that "
                f"level does not halve its P{level - 1} exactly")


_NOT_PORTED_VARIANT = ("the port builds the Faster R-CNN variants on the backbones of "
                       "models/backbones.py BACKBONES with the necks of NECKS; this one is not "
                       "ported yet (ROADMAP Queue 1 item 15)")


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
    (cls [R, C + 1], deltas [R, num_classes, 4], or [R, 1, 4] when
    reg_class_agnostic: the cascade heads)."""

    def __init__(self, num_classes: int, in_channels: int, roi_size: int = 7,
                 fc_channels: int = 1024, reg_class_agnostic: bool = False):
        super().__init__()
        self.reg_out = 1 if reg_class_agnostic else num_classes
        self.shared_fcs = nn.ModuleList([
            nn.Linear(roi_size * roi_size * in_channels, fc_channels),
            nn.Linear(fc_channels, fc_channels)])
        self.fc_cls = nn.Linear(fc_channels, num_classes + 1)
        self.fc_reg = nn.Linear(fc_channels, self.reg_out * 4)

    @torch.no_grad()
    def init_weights(self, gen: torch.Generator) -> None:
        """Xavier-uniform shared fcs, Normal(0.01) fc_cls, Normal(0.001)
        fc_reg, zero biases (convfc_bbox_head.py's init_cfg)."""
        for fc in self.shared_fcs:
            _xavier_uniform(fc, gen)
        self.fc_cls.weight.copy_(torch.randn(self.fc_cls.weight.shape, generator=gen) * 0.01)
        self.fc_reg.weight.copy_(torch.randn(self.fc_reg.weight.shape, generator=gen) * 0.001)
        for fc in (*self.shared_fcs, self.fc_cls, self.fc_reg):
            fc.bias.zero_()

    def forward(self, roi_feats: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        x = roi_feats.reshape(roi_feats.shape[0], -1)
        for fc in self.shared_fcs:
            x = torch.relu(fc(x))
        return self.fc_cls(x).float(), self.fc_reg(x).float().reshape(-1, self.reg_out, 4)


def _lecun_normal_convs(modules, gen: torch.Generator) -> None:
    """N(0, 1/fan_in) conv weights, zero conv biases."""
    for m in modules:
        if isinstance(m, nn.Conv2d):
            fan_in = m.weight[0].numel()
            m.weight.copy_(torch.randn(m.weight.shape, generator=gen) * fan_in ** -0.5)
            if m.bias is not None:
                m.bias.zero_()


def _xavier_uniform(fc: nn.Linear, gen: torch.Generator) -> None:
    out_f, in_f = fc.weight.shape
    bound = math.sqrt(6.0 / (in_f + out_f))
    fc.weight.copy_((torch.rand(fc.weight.shape, generator=gen) * 2 - 1) * bound)


# the profiler range of GRoIE's fusion (engine/two_stage.py STAGES)
GROIE_SPAN = "groie.fuse"
# the ranges of the Faster R-CNN variants' modules, in STAGES
VARIANT_SPANS = (ATTENTION_SPAN, CARAFE_SPAN, BFP_SPAN, GROIE_SPAN, HRFPN_SPAN, FPG_SPAN)


def _build_neck(cfg) -> nn.Module:
    """The config's neck over C2..C5 (JAX models/two_stage.py:123-159):
    the FPN with maxpool extras, PAFPN, the CARAFE FPN, HRFPN or FPG."""
    num_outs = len(cfg.rpn.anchor_strides)
    cin = cfg.backbone_channels
    if cfg.neck_type == "pafpn":
        return PAFPN(cin, cfg.fpn_channels, start_level=0, num_outs=num_outs)
    if cfg.neck_type == "carafe_fpn":
        return FPNCARAFE(cin, cfg.fpn_channels, num_outs=num_outs)
    if cfg.neck_type == "hrfpn":
        return HRFPN(cin, cfg.fpn_channels, num_outs=num_outs)
    if cfg.neck_type == "fpg":
        return FPG(cin, cfg.fpn_channels, cfg.fpn_channels, num_outs=num_outs,
                   stack_times=getattr(cfg, "fpg_stack_times", 9))
    return FPN(cin, cfg.fpn_channels, start_level=0, num_outs=num_outs,
               add_extra_convs="maxpool")


class FasterRCNN(nn.Module):
    """Weights and stage forwards; the orchestration is engine/two_stage.py.
    The subclasses replace the RoI head (`_build_roi_head`). The Faster
    R-CNN variants (JAX :110-193) switch parts of this model: the neck
    (cfg.neck_type), the backbone's attention blocks
    (cfg.backbone_attention), Libra's BFP after the neck
    (cfg.bfp_refine_level) and GRoIE's fusion of every level's RoI
    features (cfg.roi_extractor "groie": `groie_pre`, a 5x5 conv shared by
    the levels, and `groie_post`, GeneralizedAttention(6, "0100",
    kv_stride 2))."""

    def __init__(self, cfg: FasterRCNNConfig):
        super().__init__()
        check_two_stage_options(cfg)
        self.cfg = cfg
        self.backbone = self._build_backbone(cfg)
        self.neck = self._build_neck(cfg)
        self.bfp = (BFP(cfg.fpn_channels, cfg.bfp_refine_level)
                    if cfg.bfp_refine_level is not None else None)
        self.rpn_head = self._build_rpn_head(cfg)
        self.groie_pre = self.groie_post = None
        if cfg.roi_extractor == "groie":
            c = cfg.fpn_channels
            self.groie_pre = nn.Conv2d(c, c, 5, padding=2)
            self.groie_post = GeneralizedAttention(c, 6, "0100", kv_stride=2)
        self._build_roi_head(cfg)

    def _build_backbone(self, cfg) -> nn.Module:
        return build_backbone(cfg)

    def _build_neck(self, cfg) -> nn.Module:
        return _build_neck(cfg)

    def _build_rpn_head(self, cfg) -> nn.Module:
        return RPNHead(cfg.fpn_channels, cfg.rpn.num_anchors)

    def _build_roi_head(self, cfg) -> None:
        self.bbox_head = Shared2FCBBoxHead(cfg.num_classes, cfg.fpn_channels,
                                           cfg.rcnn.roi_size, cfg.rcnn.fc_channels)

    def _roi_heads(self):
        return [self.bbox_head]

    @torch.no_grad()
    def init_weights(self, seed: int) -> None:
        """Seeded init on the CPU: LeCun-normal backbone and neck convs,
        zero neck biases, the heads' own init; BN at identity statistics."""
        gen = torch.Generator().manual_seed(seed)
        _lecun_normal_convs(list(self.backbone.modules()) + list(self.neck.modules()), gen)
        for m in self.backbone.modules():  # ResNeSt's split-attention fcs
            if isinstance(m, SplitAttentionConv):
                for fc in (m.fc1, m.fc2):
                    fc.weight.copy_(torch.randn(fc.weight.shape, generator=gen)
                                    * fc.in_features ** -0.5)
                    fc.bias.zero_()
        if self.rpn_head is not None:
            self.rpn_head.init_weights(gen)
        for head in self._roi_heads():
            head.init_weights(gen)
        if self.bfp is not None:
            _lecun_normal_convs(self.bfp.modules(), gen)
        if self.groie_pre is not None:
            _lecun_normal_convs([self.groie_pre], gen)
        for m in self.modules():  # the attention blocks' own init: gamma 0, the identity
            if isinstance(m, GeneralizedAttention):
                m.init_weights(gen)

    def features(self, images: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        """images [B, H, W, 3] -> the FPN levels P2..P6, NCHW (channels_last),
        through the BFP when the config has one."""
        x = images.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
        feats = self.neck(self.backbone(x))
        if self.bfp is not None:
            with span(BFP_SPAN):
                feats = self.bfp(feats)
        return feats

    def rpn(self, feats: Sequence[torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
        return self.rpn_head(feats)

    def roi_forward(self, roi_feats: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        return self.bbox_head(roi_feats)

    def groie_fuse(self, per_level: Sequence[torch.Tensor]) -> torch.Tensor:
        """GenericRoIExtractor's aggregation (JAX :169-176): each level's
        RoI features [R, S, S, C] through the shared pre-conv and ReLU,
        summed over the levels in order, then the post attention:
        [R, S, S, C]."""
        acc = None
        for f in per_level:
            y = torch.relu(self.groie_pre(f.permute(0, 3, 1, 2)))
            acc = y if acc is None else acc + y
        return self.groie_post(acc).permute(0, 2, 3, 1)

    def forward(self, images: torch.Tensor):
        """The stage-1 forward: (FPN levels, objectness, deltas)."""
        feats = self.features(images)
        return (feats,) + self.rpn(feats)


class CascadeRCNN(FasterRCNN):
    """The Faster R-CNN trunk with num_stages class-agnostic Shared2FC
    heads (`bbox_heads`, the JAX package's bbox_head_{i})."""

    def _build_roi_head(self, cfg) -> None:
        self.bbox_heads = nn.ModuleList([
            Shared2FCBBoxHead(cfg.num_classes, cfg.fpn_channels, cfg.rcnn.roi_size,
                              cfg.rcnn.fc_channels, reg_class_agnostic=True)
            for _ in range(cfg.num_stages)])

    def _roi_heads(self):
        return list(self.bbox_heads)

    def roi_forward(self, roi_feats: torch.Tensor, stage: int):
        return self.bbox_heads[stage](roi_feats)


class DynamicState(nn.Module):
    """Dynamic R-CNN's training statistics, as buffers on the card (the
    JAX package's batch_stats["__dynamic_rcnn__"]): ring buffers of the
    last update_iter_interval per-step IoU and beta statistics, the
    active assigner threshold and SmoothL1 beta, and the step counter
    that picks each step's ring slot (the JAX TrainState's step)."""

    def __init__(self, cfg):
        super().__init__()
        t = cfg.update_iter_interval
        self.register_buffer("iou_hist", torch.zeros(t))
        self.register_buffer("beta_hist", torch.zeros(t))
        self.register_buffer("iou_thr", torch.tensor(float(cfg.rcnn.pos_iou_thr)))
        self.register_buffer("beta", torch.tensor(float(cfg.initial_beta)))
        self.register_buffer("step", torch.zeros((), dtype=torch.long))


class DynamicRCNN(FasterRCNN):
    """Faster R-CNN with Dynamic R-CNN's statistics (`dynamic`); the
    adaptation lives in the train step."""

    def _build_roi_head(self, cfg) -> None:
        super()._build_roi_head(cfg)
        self.dynamic = DynamicState(cfg)


class HeadBatchNorm2d(nn.Module):
    """A trainable BatchNorm with flax's nn.BatchNorm statistics (momentum
    0.99, epsilon 1e-5): in training the batch mean and the BIASED batch
    variance, as E[x^2] - E[x]^2 clipped at 0 (flax's fast variance),
    normalise the input and move the running statistics by 1%; torch's
    BatchNorm2d moves running_var by the unbiased variance. `train` is an
    argument: the model stays in eval mode, its backbone BN frozen. Across
    ranks every rank moves its running statistics by the same global
    values."""

    def __init__(self, channels: int, momentum: float = 0.99, eps: float = 1e-5):
        super().__init__()
        self.momentum, self.eps = momentum, eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x: torch.Tensor, train: bool = False, data=None) -> torch.Tensor:
        """`data`, in training: the data axis (engine/train.py DataAxis)
        whose ranks hold the rest of the global batch. The statistics are
        then the global batch's, as the JAX step's BatchNorm takes them
        under jit over a sharded batch: the per-channel sums of x and x^2
        and the element count all-reduced, with their gradient."""
        if not train:
            mean, var = self.running_mean, self.running_var
        else:
            if data is None or data.group is None:
                mean, ex2 = x.mean(dim=(0, 2, 3)), (x * x).mean(dim=(0, 2, 3))
            else:
                c = x.shape[1]
                count = torch.full((1,), x.numel() // c, dtype=x.dtype, device=x.device)
                sums = data.sum_with_grad(torch.cat([x.sum(dim=(0, 2, 3)),
                                                     (x * x).sum(dim=(0, 2, 3)), count]))
                mean, ex2 = sums[:c] / sums[2 * c], sums[c:2 * c] / sums[2 * c]
            var = (ex2 - mean * mean).clamp(min=0.0)
            with torch.no_grad():
                m = self.momentum
                self.running_mean.mul_(m).add_(mean.detach(), alpha=1 - m)
                self.running_var.mul_(m).add_(var.detach(), alpha=1 - m)
        mul = torch.rsqrt(var + self.eps) * self.weight
        return (x - mean[:, None, None]) * mul[:, None, None] + self.bias[:, None, None]


class _HeadBottleneck(nn.Module):
    """The conv branch's bottleneck: 1x1 -> 3x3 -> 1x1 (x4 channels), each
    with a trainable BN, ReLU after the residual sum."""

    def __init__(self, planes: int):
        super().__init__()
        self.conv1 = nn.Conv2d(planes * 4, planes, 1, bias=False)
        self.bn1 = HeadBatchNorm2d(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, padding=1, bias=False)
        self.bn2 = HeadBatchNorm2d(planes)
        self.conv3 = nn.Conv2d(planes, planes * 4, 1, bias=False)
        self.bn3 = HeadBatchNorm2d(planes * 4)

    def forward(self, x, train: bool = False, data=None):
        y = torch.relu(self.bn1(self.conv1(x), train, data))
        y = torch.relu(self.bn2(self.conv2(y), train, data))
        return torch.relu(self.bn3(self.conv3(y), train, data) + x)


class BasicResBlock(nn.Module):
    """double_bbox_head.py:10-73: 3x3 + BN + ReLU -> 1x1 + BN on the main
    path, 1x1 + BN on the identity path, ReLU after the sum (the channel
    lift 256 -> 1024)."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.conv1 = nn.Conv2d(in_channels, in_channels, 3, padding=1, bias=False)
        self.bn1 = HeadBatchNorm2d(in_channels)
        self.conv2 = nn.Conv2d(in_channels, out_channels, 1, bias=False)
        self.bn2 = HeadBatchNorm2d(out_channels)
        self.conv_identity = nn.Conv2d(in_channels, out_channels, 1, bias=False)
        self.bn_identity = HeadBatchNorm2d(out_channels)

    def forward(self, x, train: bool = False, data=None):
        y = torch.relu(self.bn1(self.conv1(x), train, data))
        y = self.bn2(self.conv2(y), train, data)
        return torch.relu(y + self.bn_identity(self.conv_identity(x), train, data))


# the profiler range of the conv branch (engine/two_stage.py STAGES)
CONV_BRANCH_SPAN = "double_head_rcnn.conv_branch"


class DoubleConvFCBBoxHead(nn.Module):
    """double_bbox_head.py:76-177: the regression branch is convolutional
    (BasicResBlock + num_convs bottlenecks + global average pool ->
    fc_reg, class-specific), the classification branch fully connected
    (num_fcs fcs + fc_cls)."""

    def __init__(self, num_classes: int, in_channels: int, roi_size: int = 7,
                 num_convs: int = 4, num_fcs: int = 2, conv_out_channels: int = 1024,
                 fc_out_channels: int = 1024):
        super().__init__()
        self.num_classes = num_classes
        self.res_block = BasicResBlock(in_channels, conv_out_channels)
        self.conv_branch = nn.ModuleList([_HeadBottleneck(conv_out_channels // 4)
                                          for _ in range(num_convs)])
        self.fc_reg = nn.Linear(conv_out_channels, num_classes * 4)
        dims = [roi_size * roi_size * in_channels] + [fc_out_channels] * num_fcs
        self.fc_branch = nn.ModuleList([nn.Linear(i, o) for i, o in zip(dims, dims[1:])])
        self.fc_cls = nn.Linear(dims[-1], num_classes + 1)

    @torch.no_grad()
    def init_weights(self, gen: torch.Generator) -> None:
        """The JAX head's initialisers: LeCun-normal convs, BN at identity,
        Xavier-uniform fc_branch, Normal(0.01) fc_cls, Normal(0.001)
        fc_reg, zero biases."""
        _lecun_normal_convs(self.modules(), gen)
        for fc in self.fc_branch:
            _xavier_uniform(fc, gen)
        self.fc_cls.weight.copy_(torch.randn(self.fc_cls.weight.shape, generator=gen) * 0.01)
        self.fc_reg.weight.copy_(torch.randn(self.fc_reg.weight.shape, generator=gen) * 0.001)
        for fc in (*self.fc_branch, self.fc_cls, self.fc_reg):
            fc.bias.zero_()

    def conv_branch_forward(self, x_reg: torch.Tensor, train: bool = False,
                            data=None) -> torch.Tensor:
        """[R, S, S, C] -> the pooled [R, conv_out] features."""
        with span(CONV_BRANCH_SPAN):
            y = self.res_block(x_reg.permute(0, 3, 1, 2), train, data)
            for block in self.conv_branch:
                y = block(y, train, data)
            return y.mean(dim=(2, 3))

    def forward(self, x_cls: torch.Tensor, x_reg: torch.Tensor, train: bool = False,
                data=None):
        """(cls [R, C + 1], class-specific deltas [R, num_classes, 4]); in
        training the BN statistics come from all R RoIs, and from every
        rank's RoIs across a `data` axis (HeadBatchNorm2d)."""
        reg = self.fc_reg(self.conv_branch_forward(x_reg, train, data))
        f = x_cls.reshape(x_cls.shape[0], -1)
        for fc in self.fc_branch:
            f = torch.relu(fc(f))
        return self.fc_cls(f).float(), reg.float().reshape(-1, self.num_classes, 4)


class DoubleHeadRCNN(FasterRCNN):
    """The Faster R-CNN trunk with the DoubleConvFCBBoxHead; the engine
    feeds it two RoI extractions (cls at the RoI, reg at 1.3x the RoI)."""

    def _build_roi_head(self, cfg) -> None:
        self.bbox_head = DoubleConvFCBBoxHead(
            cfg.num_classes, cfg.fpn_channels, cfg.rcnn.roi_size, cfg.dh_num_convs,
            cfg.dh_num_fcs, cfg.dh_conv_out, cfg.dh_fc_out)

    def roi_forward(self, cls_feats: torch.Tensor, reg_feats: torch.Tensor,
                    train: bool = False, data=None):
        return self.bbox_head(cls_feats, reg_feats, train, data)


class GNWSFasterRCNN(FasterRCNN):
    """GN + WS Faster R-CNN (JAX models/gn_ws.py `GNWSFasterRCNN`
    :189-224): the Faster R-CNN surface (features, rpn, roi_forward) over
    WSResNet, WSFPN, the RPN head and Shared4Conv1FCBBoxHead
    (models/gn_ws.py); weight_standardize False is plain GN. Faster
    R-CNN's train and eval steps drive it unchanged. The JAX model reads
    none of the backbone, neck and RoI-extractor switches, and this one
    refuses them (a ValueError) rather than ignore them."""

    def __init__(self, cfg):
        ignored = [n for n in ("backbone_type", "neck_type", "roi_extractor",
                               "bfp_refine_level", "backbone_attention")
                   if getattr(cfg, n, None) != _GN_WS_BASE.get(n)]
        if ignored:
            raise ValueError(f"gn_ws builds its own WS-ResNet, WS-FPN and RoI head and reads "
                             f"none of {ignored}")
        super().__init__(cfg)

    def _build_backbone(self, cfg) -> nn.Module:
        return WSResNet(cfg.block_counts, cfg.stem_width, ws=cfg.weight_standardize)

    def _build_neck(self, cfg) -> nn.Module:
        return WSFPN(cfg.backbone_channels, cfg.fpn_channels, len(cfg.rpn.anchor_strides),
                     ws=cfg.weight_standardize)

    def _build_roi_head(self, cfg) -> None:
        self.bbox_head = Shared4Conv1FCBBoxHead(
            cfg.num_classes, cfg.fpn_channels, cfg.rcnn.roi_size, cfg.fpn_channels,
            cfg.rcnn.fc_channels, ws=cfg.weight_standardize)


_GN_WS_BASE = {"backbone_type": "resnet", "neck_type": "fpn", "roi_extractor": "single",
               "bfp_refine_level": None, "backbone_attention": None}

def _proposal_families():
    """The proposal families' models (models/rpn_only.py, cascade_rpn.py,
    trident.py, grid_rcnn.py), which build on this module's."""
    from .cascade_rpn import CascadeRPNNet
    from .grid_rcnn import GridRCNN
    from .rpn_only import FastRCNN, RPNOnly
    from .trident import TridentFasterRCNN

    return {"rpn": RPNOnly, "cascade_rpn": CascadeRPNNet, "tridentnet": TridentFasterRCNN,
            "fast_rcnn": FastRCNN, "grid_rcnn": GridRCNN}


# family -> the port's model class (the Faster R-CNN variants on FasterRCNN,
# as JAX api.py:50-104 builds them with init_faster_rcnn, PISA's too: its
# novelty is the train step; GN+WS on its own model; the proposal families'
# in _proposal_families)
_MODELS = {"faster_rcnn": FasterRCNN, "cascade_rcnn": CascadeRCNN,
           "dynamic_rcnn": DynamicRCNN, "double_head_rcnn": DoubleHeadRCNN,
           **{family: FasterRCNN for family in FASTER_RCNN_VARIANTS},
           "gn_ws": GNWSFasterRCNN}
# the proposal families: RPN-only and Cascade RPN (their eval gives proposals),
# TridentNet, Fast R-CNN (on proposals from outside) and Grid R-CNN
PROPOSAL_FAMILIES = ("rpn", "cascade_rpn", "tridentnet", "fast_rcnn", "grid_rcnn")
# the two-stage families the port builds
TWO_STAGE_FAMILIES = tuple(_MODELS) + PROPOSAL_FAMILIES


def build_two_stage(cfg, device="cuda", seed: int = 0) -> FasterRCNN:
    """A seeded model of cfg's two-stage family in eval mode on `device`
    (channels_last). Raises when device is CUDA and there is no card."""
    check_two_stage_options(cfg)
    dev = resolve_device(device)
    with SkipDefaultInit():
        model = (_MODELS.get(cfg.family) or _proposal_families()[cfg.family])(cfg)
    model.init_weights(seed)
    return model.to(device=dev, memory_format=torch.channels_last).eval()
