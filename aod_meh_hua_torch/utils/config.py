"""Config dataclasses of the ported families.

A copy of `AnchorConfig`, `TestCfg`, `HUACfg`, `RetinaNetConfig`,
`SSDAnchorCfg`, `SSDConfig`, `TrainConfig`, `ALConfig` and
`tiny_test_config` from aod_meh_hua_tpu/utils/config.py (:18-298,
:2246-2294, :3545), and of the two-stage families' `RPNCfg`, `RCNNCfg`, `FasterRCNNConfig`,
`CascadeRCNNConfig`, `DynamicRCNNConfig`, `DoubleHeadRCNNConfig`,
`LibraRCNNConfig`, `PAFPNFasterRCNNConfig`, `CARAFEFasterRCNNConfig`,
`GRoIEFasterRCNNConfig`, `EmpiricalAttentionConfig`,
`GNWSFasterRCNNConfig`, `FPGFasterRCNNConfig`, `HRNetFasterRCNNConfig`,
`ResNeStFasterRCNNConfig`, `PISAFasterRCNNConfig`, the proposal
families' `RPNOnlyConfig`, `TridentNetConfig`, `CascadeRPNConfig`,
`FastRCNNConfig` and `GridRCNNConfig`, and their tiny factories
(:301-455, :583-595, :598-621, :625-681, :700-787, :790-819, :823-860,
:1064-1083, :1097-1131, :2513, :2532, :2551, :2570-2612, :2719-2795,
:2935, :2973, :2992-3010, :3312, :3331-3440) with `ZOO_FAMILIES` (:3569)
cut to the families the port has, and the
reference-config loader (`_cfg_get`, `_KNOWN_TOP_KEYS`, `_LOSS_CLS_MAP`,
`_warn`, `reference_data_roots`, `load_reference_config`, :2297-2510).
The port keeps its own copy because it imports nothing of the JAX
package; tests/test_torch_ops.py, tests/test_torch_two_stage.py,
tests/test_torch_rcnn_families.py and tests/test_torch_config_loader.py
hold the copies equal field by field and the loaders equal file by file.
"""

from __future__ import annotations

import dataclasses
import runpy
from dataclasses import dataclass, field
from typing import Optional, Tuple


@dataclass(frozen=True)
class AnchorConfig:
    strides: Tuple[int, ...] = (8, 16, 32, 64, 128)
    ratios: Tuple[float, ...] = (0.5, 1.0, 2.0)
    octave_base_scale: int = 4
    scales_per_octave: int = 3

    @property
    def num_anchors(self) -> int:
        return len(self.ratios) * self.scales_per_octave


@dataclass(frozen=True)
class TestCfg:
    """Post-processing config (reference test_cfg, Config_RetinaNet.py:79-85)."""

    nms_pre: int = 1000
    score_thr: float = 0.05
    nms_iou_thr: float = 0.5
    max_per_img: int = 100
    pre_nms_cands: int = 1000  # static candidate cap for fixed-shape NMS
    # approximate per-level top-k (a TPU lever in the JAX package); the
    # port runs the exact sort and raises when this is set
    fast_topk: bool = False


@dataclass(frozen=True)
class HUACfg:
    """Uncertainty scoring config (Config_RetinaNet.py:14-19 + Lambda_L2.py)."""

    pool: str = "Entropy_NMS"           # Random | Entropy_ALL | Entropy_NMS | Entropy_NoNMS
    unc_type: str = "epistemic"          # epistemic | aleatoric | total
    agg: str = "objectSum_scaleMax_classSum"
    # aggregation order ('class_first' = AggregateObjScaleUnc,
    # 'scale_first' = ChangeOrder + AggregateObjClassScaleUnc) and the
    # clsW class-count weighting (Lambda_L2.py:571-633)
    agg_order: str = "class_first"
    cls_weight: bool = False
    obj_score_thr: float = 0.3           # GetObjectIdx score_thr
    memb_iou_thr: float = 0.5            # GetObjectIdx iou_thr
    fg_score_thr: float = 0.3            # FG anchor confidence gate
    lambda_eps: float = 1e-7
    lambda_scale: float = 25.0
    mi_mode: str = "closed"              # closed | sampled (parity mode)
    mi_samples: int = 500
    mi_chunk: int = 50


@dataclass(frozen=True)
class RetinaNetConfig:
    """MEH-RetinaNet (reference Config_RetinaNet.py model dict)."""

    num_classes: int = 20
    canvas: Tuple[int, int] = (608, 1024)   # (H, W): keep-ratio (1000, 600) resize + /32 pad
    # backbone (ResNet-50-FPN); block_counts/width shrink for unit tests
    block_counts: Tuple[int, ...] = (3, 4, 6, 3)
    stem_width: int = 64
    frozen_stages: int = 1
    # neck
    fpn_channels: int = 256
    # head
    stacked_convs: int = 4
    feat_channels: int = 256
    anchor: AnchorConfig = field(default_factory=AnchorConfig)
    # bbox coder
    target_means: Tuple[float, ...] = (0.0, 0.0, 0.0, 0.0)
    target_stds: Tuple[float, ...] = (1.0, 1.0, 1.0, 1.0)
    # assigner (train_cfg)
    pos_iou_thr: float = 0.5
    neg_iou_thr: float = 0.4
    min_pos_iou: float = 0.0
    gt_max_assign_all: bool = True
    # losses
    focal_gamma: float = 2.0
    focal_alpha: float = 0.25
    cls_loss: str = "edl_softmax_focal"  # edl_softmax_focal | focal | edl_focal
    bbox_loss: str = "l1"
    meh_loss: str = "l2"                 # l2 (Lambda_L2) | l1 (Lambda_L1) | msle (Lambda_MSLE)
    meh_loss_weight: float = 5.0         # Lambda_L2.py:241 final *5
    use_meh: bool = True                 # False = Lambda_L2Net_NoL ablation
    # data batching
    max_gt: int = 64
    # image normalization (img_norm_cfg, Config_RetinaNet.py:99-100),
    # applied on the device to uint8 batches
    img_mean: Tuple[float, ...] = (123.675, 116.28, 103.53)
    img_std: Tuple[float, ...] = (58.395, 57.12, 57.375)
    img_to_rgb: bool = True
    compute_dtype: str = "float32"       # float32 | bfloat16
    # MC-dropout baseline: channel dropout after every ReLU when > 0
    mc_dropout: float = 0.0
    # the next three are levers of the JAX package; the port does not
    # have them yet and raises when one is set
    remat: bool = False
    stem_s2d: bool = False
    backbone_int8: bool = False
    # backbone 1x1 convs as matrix products (models/resnet.py Conv1x1Matmul)
    conv1x1_matmul: bool = False
    # whole-bottleneck fused kernel for the stride-1 C2/C3 blocks
    # (ops/fused_block.py). Scoring/eval only: the kernel has no backward.
    fused_blocks: bool = False
    # which backbone stages the fused path covers when fused_blocks is on
    # (stride-1 blocks with Cin % 128 == 0 only; see models/resnet.py)
    fused_stages: Tuple[bool, ...] = (True, True, False, False)
    test: TestCfg = field(default_factory=TestCfg)
    hua: HUACfg = field(default_factory=HUACfg)

    family = "retinanet"

    @property
    def backbone_channels(self) -> Tuple[int, ...]:
        w = self.stem_width
        return (4 * w, 8 * w, 16 * w, 32 * w)  # C2..C5 bottleneck expansions

    @property
    def cls_out_channels(self) -> int:
        return self.num_classes  # 'relu' activation: no background channel

    @property
    def num_fg_classes(self) -> int:
        return self.num_classes

    def build_anchor_generator(self):
        from ..ops.anchors import AnchorGenerator

        return AnchorGenerator(
            strides=self.anchor.strides, ratios=self.anchor.ratios,
            octave_base_scale=self.anchor.octave_base_scale,
            scales_per_octave=self.anchor.scales_per_octave,
        )

    def for_orientation(self, orientation: str) -> "RetinaNetConfig":
        """Per-orientation variant: `canvas` is landscape; portrait
        batches run on the transposed canvas."""
        h, w = self.canvas
        land = (max(h, w) == w)
        if (orientation == "landscape") == land:
            return self
        return dataclasses.replace(self, canvas=(w, h))

    def featmap_sizes(self):
        h, w = self.canvas
        assert h % 32 == 0 and w % 32 == 0, "canvas must be divisible by 32"
        sizes = [(h // 8, w // 8), (h // 16, w // 16), (h // 32, w // 32)]
        for _ in range(len(self.anchor.strides) - 3):
            ph, pw = sizes[-1]
            sizes.append(((ph + 1) // 2, (pw + 1) // 2))
        return sizes

    def level_bounds(self):
        """Static (start, end) anchor offsets per level (full maps)."""
        a = self.anchor.num_anchors
        bounds, off = [], 0
        for (h, w) in self.featmap_sizes():
            n = h * w * a
            bounds.append((off, off + n))
            off += n
        return bounds

    def topk_level_bounds(self):
        """Static (start, end) offsets after per-level nms_pre top-k."""
        a = self.anchor.num_anchors
        bounds, off = [], 0
        for (h, w) in self.featmap_sizes():
            n = min(h * w * a, self.test.nms_pre)
            bounds.append((off, off + n))
            off += n
        return bounds


@dataclass(frozen=True)
class SSDAnchorCfg:
    strides: Tuple[int, ...] = (8, 16, 32, 64, 100, 300)
    ratios: Tuple[Tuple[float, ...], ...] = ((2,), (2, 3), (2, 3), (2, 3), (2,), (2,))
    basesize_ratio_range: Tuple[float, float] = (0.15, 0.9)
    input_size: int = 300


@dataclass(frozen=True)
class SSDConfig:
    """MEH-SSD300-VGG16 (reference Config_SSD.py model dict).

    One fixed square canvas (the reference warps with keep_ratio=False,
    Config_SSD.py:106), so no orientation bucketing.
    """

    num_classes: int = 20
    input_size: int = 300
    # backbone: VGG16; width_mult shrinks channels for unit tests
    width_mult: float = 1.0
    neck_out_channels: Tuple[int, ...] = (512, 1024, 512, 256, 256, 256)
    level_strides: Tuple[int, ...] = (2, 2, 1, 1)
    level_paddings: Tuple[int, ...] = (1, 1, 0, 0)
    l2_norm_scale: float = 20.0
    anchor: SSDAnchorCfg = field(default_factory=SSDAnchorCfg)
    # bbox coder
    target_means: Tuple[float, ...] = (0.0, 0.0, 0.0, 0.0)
    target_stds: Tuple[float, ...] = (0.1, 0.1, 0.2, 0.2)
    # assigner (train_cfg): neg threshold 0.5, single-anchor low-quality
    pos_iou_thr: float = 0.5
    neg_iou_thr: float = 0.5
    min_pos_iou: float = 0.0
    gt_max_assign_all: bool = False
    # losses: OHEM CE (neg:pos = 3) + smooth L1
    neg_pos_ratio: int = 3
    smoothl1_beta: float = 1.0
    meh_loss: str = "l2"
    meh_loss_weight: float = 2.0        # My_L_ssd_head.py:224 final *2
    meh_weighted: bool = False          # loss_single_L without mineW kwarg
    use_meh: bool = True
    max_gt: int = 64
    # img_norm_cfg (Config_SSD.py:87): caffe-style std = 1
    img_mean: Tuple[float, ...] = (123.675, 116.28, 103.53)
    img_std: Tuple[float, ...] = (1.0, 1.0, 1.0)
    img_to_rgb: bool = True
    compute_dtype: str = "float32"
    test: TestCfg = field(default_factory=lambda: TestCfg(
        nms_pre=1000, score_thr=0.02, nms_iou_thr=0.5, max_per_img=200))
    hua: HUACfg = field(default_factory=HUACfg)

    family = "ssd"

    @property
    def canvas(self) -> Tuple[int, int]:
        return (self.input_size, self.input_size)

    @property
    def cls_out_channels(self) -> int:
        return self.num_classes + 1  # explicit background class

    @property
    def num_fg_classes(self) -> int:
        return self.num_classes

    def for_orientation(self, orientation: str) -> "SSDConfig":
        return self  # square warp: one canvas for both orientations

    def build_anchor_generator(self):
        from ..ops.anchors import SSDAnchorGenerator

        return SSDAnchorGenerator(
            strides=self.anchor.strides, ratios=self.anchor.ratios,
            basesize_ratio_range=self.anchor.basesize_ratio_range,
            input_size=self.anchor.input_size,
        )

    def featmap_sizes(self):
        sizes = {300: [(38, 38), (19, 19), (10, 10), (5, 5), (3, 3), (1, 1)],
                 512: [(64, 64), (32, 32), (16, 16), (8, 8), (6, 6), (4, 4), (1, 1)]}
        return sizes[self.input_size]

    def level_bounds(self):
        gen = self.build_anchor_generator()
        bounds, off = [], 0
        for (h, w), a in zip(self.featmap_sizes(), gen.num_base_anchors):
            n = h * w * a
            bounds.append((off, off + n))
            off += n
        return bounds

    def topk_level_bounds(self):
        gen = self.build_anchor_generator()
        bounds, off = [], 0
        for (h, w), a in zip(self.featmap_sizes(), gen.num_base_anchors):
            n = min(h * w * a, self.test.nms_pre)
            bounds.append((off, off + n))
            off += n
        return bounds


@dataclass(frozen=True)
class TrainConfig:
    """Optimizer/schedule (reference Config_RetinaNet.py:89-94 + the
    training script's overrides). The port trains with SGD only:
    engine/train.py make_optimizer raises for another `optimizer`."""

    lr: float = 0.001
    momentum: float = 0.9
    weight_decay: float = 1e-4
    batch_size: int = 2
    seed: int = 20
    # reference schedule: outer_epoch x epoch_ratio[0] inner epochs; lr
    # drops x0.1 at lr_step_epoch of the FINAL outer epoch only
    outer_epoch: int = 2
    epoch_ratio: Tuple[int, ...] = (3, 1)
    lr_step_epoch: int = 2
    # "sgd" (torch-exact SGD), or the DETR family's AdamW variants
    optimizer: str = "sgd"
    backbone_lr_mult: float = 1.0
    grad_clip: Optional[float] = None
    # linear warmup (SSD config: 500 iters, ratio 1e-3; Config_SSD.py:158-162)
    warmup_iters: int = 0
    warmup_ratio: float = 1e-3
    # full train-state snapshot every N inner epochs (0 = off)
    ckpt_interval: int = 1


@dataclass(frozen=True)
class ALConfig:
    """Active-learning loop (reference Config_RetinaNet.py:156-166 + the
    driver's flags)."""

    cycles: Tuple[int, ...] = (0, 1, 2, 3, 4, 5, 6)
    x_l_0_size: int = 16551 // 20
    x_s_size: int = 16551 // 40
    x_l_repeat: int = 2
    x_u_repeat: int = 2
    zero_rate: float = 0.15              # train_RetinaNet.py:39
    use_max_conf: str = "False"          # False | min | max
    eval_interval: int = 3
    # pool-scoring / eval batch size, decoupled from the train batch
    score_batch_size: int = 64
    # int8 pool scoring is a lever of the JAX package; the port raises
    int8_scoring: bool = False

    def __post_init__(self):
        if self.int8_scoring:
            raise NotImplementedError(
                "int8_scoring: the port scores in float32 (ROADMAP Queue 1 item 16)")


def tiny_test_config(**overrides) -> RetinaNetConfig:
    """A shrunken RetinaNet for fast CPU unit tests."""
    base = dict(
        canvas=(128, 256),
        block_counts=(1, 1, 1, 1),
        stem_width=8,
        fpn_channels=16,
        stacked_convs=1,
        feat_channels=16,
        num_classes=6,
        max_gt=8,
        test=TestCfg(nms_pre=200, pre_nms_cands=256, max_per_img=20),
    )
    base.update(overrides)
    return RetinaNetConfig(**base)


@dataclass(frozen=True)
class RPNCfg:
    """RPN anchors / targets / proposal settings
    (configs/_base_/models/faster_rcnn_r50_fpn.py rpn_head + train_cfg.rpn
    + *_cfg.rpn_proposal)."""

    anchor_strides: Tuple[int, ...] = (4, 8, 16, 32, 64)
    anchor_scale: int = 8
    ratios: Tuple[float, ...] = (0.5, 1.0, 2.0)
    # assigner (train_cfg.rpn.assigner)
    pos_iou_thr: float = 0.7
    neg_iou_thr: float = 0.3
    min_pos_iou: float = 0.3
    # sampler (RandomSampler num=256, pos_fraction=0.5; neg_pos_ub >= 0
    # caps negatives at neg_pos_ub * num_pos — Libra sets 5)
    sampler_num: int = 256
    pos_fraction: float = 0.5
    neg_pos_ub: int = -1
    # proposal generation
    train_nms_pre: int = 2000
    train_max_per_img: int = 1000
    test_nms_pre: int = 1000
    test_max_per_img: int = 1000
    nms_iou_thr: float = 0.7

    @property
    def num_anchors(self) -> int:
        return len(self.ratios)


@dataclass(frozen=True)
class RCNNCfg:
    """RoI head settings (roi_head + train_cfg.rcnn)."""

    # assigner (match_low_quality=False)
    pos_iou_thr: float = 0.5
    neg_iou_thr: float = 0.5
    min_pos_iou: float = 0.5
    # sampler (num=512, pos_fraction=0.25, add_gt_as_proposals=True)
    sampler_num: int = 512
    pos_fraction: float = 0.25
    # RoIAlign (output_size=7, strides 4-32, finest_scale=56); the
    # reference's sampling_ratio=0 is adaptive — fixed 2 here (static shapes)
    roi_size: int = 7
    sampling_ratio: int = 2
    finest_scale: int = 56
    roi_strides: Tuple[int, ...] = (4, 8, 16, 32)
    fc_channels: int = 1024
    target_stds: Tuple[float, ...] = (0.1, 0.1, 0.2, 0.2)


@dataclass(frozen=True)
class FasterRCNNConfig:
    """Faster R-CNN R50-FPN, VOC classes (the upstream two-stage family
    the reference keeps registered; configs/pascal_voc/ uses the same
    1000x600 keep-ratio scale as RetinaNet).

    The fields from `backbone_dcn` on select the JAX package's variants
    of the family (other backbones, necks, RoI extractors, Libra R-CNN's
    balanced pyramid, sampler and loss; the last eight are fields of its
    subclasses there). The port builds every backbone_type of
    models/backbones.py BACKBONES with the FPN, PAFPN, CARAFE FPN, HRFPN
    or FPG neck, the BFP, GRoIE, Libra's sampler and loss, and the
    subclass field `backbone_attention`; models/two_stage.py
    check_two_stage_options raises on deformable convs and GCNet blocks,
    on any variant field of the Cascade, Dynamic and Double-Head
    families, and on compute_dtype="bfloat16", remat and stem_s2d.
    backbone_channels follows backbone_type."""

    num_classes: int = 20
    canvas: Tuple[int, int] = (608, 1024)
    block_counts: Tuple[int, ...] = (3, 4, 6, 3)
    stem_width: int = 64
    frozen_stages: int = 1
    fpn_channels: int = 256
    rpn: RPNCfg = field(default_factory=RPNCfg)
    rcnn: RCNNCfg = field(default_factory=RCNNCfg)
    max_gt: int = 64
    img_mean: Tuple[float, ...] = (123.675, 116.28, 103.53)
    img_std: Tuple[float, ...] = (58.395, 57.12, 57.375)
    img_to_rgb: bool = True
    compute_dtype: str = "float32"
    remat: bool = False
    stem_s2d: bool = False
    backbone_dcn: Optional[str] = None
    backbone_gcb_ratio: Optional[float] = None
    backbone_type: str = "resnet"
    resnext_groups: int = 32
    resnext_base_width: int = 4
    res2net_scales: int = 4
    res2net_base_width: int = 26
    regnet_arch: str = "regnetx_3.2gf"
    test: TestCfg = field(default_factory=lambda: TestCfg(
        nms_pre=1000, score_thr=0.05, nms_iou_thr=0.5, max_per_img=100,
        pre_nms_cands=1000))
    # the JAX package's subclasses' switches, at the base family's values
    neck_type: str = "fpn"
    roi_extractor: str = "single"
    bfp_refine_level: Optional[int] = None
    bfp_refine_type: str = "non_local"
    num_bins: Optional[int] = None
    balanced_l1_alpha: Optional[float] = None
    balanced_l1_gamma: float = 1.5
    balanced_l1_beta: float = 1.0

    family = "faster_rcnn"

    @property
    def backbone_channels(self) -> Tuple[int, ...]:
        """C2..C5's channels for backbone_type: 4w..32w of the stem width
        for the ResNet-like backbones, RegNet's stage widths, HRNet's
        branch widths w, 2w, 4w, 8w (the necks' in-channels, which flax
        infers and PyTorch needs)."""
        if self.backbone_type == "regnet":
            from ..models.backbones import REGNET_ARCHS, regnet_stages

            return tuple(regnet_stages(REGNET_ARCHS[self.regnet_arch])[0])
        if self.backbone_type == "hrnet":
            w = getattr(self, "hrnet_width", HRNET_WIDTH)
            return (w, 2 * w, 4 * w, 8 * w)
        w = self.stem_width
        return (4 * w, 8 * w, 16 * w, 32 * w)

    @property
    def num_fg_classes(self) -> int:
        return self.num_classes

    def for_orientation(self, orientation: str) -> "FasterRCNNConfig":
        h, w = self.canvas
        land = (max(h, w) == w)
        if (orientation == "landscape") == land:
            return self
        return dataclasses.replace(self, canvas=(w, h))

    def build_anchor_generator(self):
        from ..ops.anchors import AnchorGenerator

        return AnchorGenerator(
            strides=self.rpn.anchor_strides, ratios=self.rpn.ratios,
            octave_base_scale=self.rpn.anchor_scale, scales_per_octave=1,
        )

    def featmap_sizes(self):
        h, w = self.canvas
        assert h % 32 == 0 and w % 32 == 0, "canvas must be divisible by 32"
        sizes = [(h // 4, w // 4), (h // 8, w // 8), (h // 16, w // 16),
                 (h // 32, w // 32)]
        for _ in range(len(self.rpn.anchor_strides) - 4):
            ph, pw = sizes[-1]
            sizes.append(((ph + 1) // 2, (pw + 1) // 2))
        return sizes

    def level_bounds(self):
        a = self.rpn.num_anchors
        bounds, off = [], 0
        for (h, w) in self.featmap_sizes():
            n = h * w * a
            bounds.append((off, off + n))
            off += n
        return bounds


def _tiny_two_stage(rpn_kw=None, **base_extra):
    """The shared fields of the JAX package's tiny two-stage factories."""
    return dict(
        canvas=(64, 128),
        block_counts=(1, 1, 1, 1),
        stem_width=8,
        fpn_channels=16,
        num_classes=6,
        max_gt=8,
        rpn=RPNCfg(train_nms_pre=256, train_max_per_img=64,
                   test_nms_pre=256, test_max_per_img=64,
                   sampler_num=64, **(rpn_kw or {})),
        rcnn=RCNNCfg(sampler_num=32, fc_channels=32),
        test=TestCfg(nms_pre=200, pre_nms_cands=128, max_per_img=20),
        **base_extra,
    )


def tiny_faster_rcnn_config(**overrides) -> FasterRCNNConfig:
    """A shrunken Faster R-CNN for fast CPU unit tests."""
    base = _tiny_two_stage()
    base.update(overrides)
    return FasterRCNNConfig(**base)


@dataclass(frozen=True)
class CascadeRCNNConfig(FasterRCNNConfig):
    """Cascade R-CNN R50-FPN (reference
    configs/_base_/models/cascade_rcnn_r50_fpn.py): the Faster R-CNN
    trunk with three progressively tighter RoI stages
    (pos thr 0.5/0.6/0.7, stds 0.1/0.05/0.033, class-agnostic reg,
    stage loss weights 1/0.5/0.25)."""

    num_stages: int = 3
    stage_pos_iou_thrs: Tuple[float, ...] = (0.5, 0.6, 0.7)
    stage_stds: Tuple[Tuple[float, ...], ...] = (
        (0.1, 0.1, 0.2, 0.2),
        (0.05, 0.05, 0.1, 0.1),
        (0.033, 0.033, 0.067, 0.067),
    )
    stage_loss_weights: Tuple[float, ...] = (1.0, 0.5, 0.25)

    family = "cascade_rcnn"


@dataclass(frozen=True)
class DynamicRCNNConfig(FasterRCNNConfig):
    """Dynamic R-CNN (reference
    configs/dynamic_rcnn/dynamic_rcnn_r50_fpn_1x_coco.py +
    mmdet/models/roi_heads/dynamic_roi_head.py): Faster R-CNN whose RoI
    assigner IoU threshold and SmoothL1 beta adapt to the training
    statistics every update_iter_interval iterations; proposal NMS at
    IoU 0.85."""

    iou_topk: int = 75
    beta_topk: int = 10
    update_iter_interval: int = 100
    initial_iou: float = 0.4
    initial_beta: float = 1.0
    rpn: RPNCfg = field(default_factory=lambda: RPNCfg(nms_iou_thr=0.85))

    family = "dynamic_rcnn"


@dataclass(frozen=True)
class DoubleHeadRCNNConfig(FasterRCNNConfig):
    """Double-Head R-CNN (reference
    configs/double_heads/dh_faster_rcnn_r50_fpn_1x_coco.py +
    mmdet/models/roi_heads/double_roi_head.py + bbox_heads/
    double_bbox_head.py): the RoI head splits into a convolutional
    regression branch (BasicResBlock + 4 bottlenecks, fed 1.3x-rescaled
    RoIs) and a fully connected classification branch; both losses at
    weight 2.0."""

    reg_roi_scale_factor: float = 1.3
    dh_num_convs: int = 4
    dh_num_fcs: int = 2
    dh_conv_out: int = 1024
    dh_fc_out: int = 1024
    cls_loss_weight: float = 2.0
    bbox_loss_weight: float = 2.0

    family = "double_head_rcnn"


def tiny_dynamic_rcnn_config(**overrides) -> DynamicRCNNConfig:
    """A shrunken Dynamic R-CNN for fast CPU unit tests."""
    base = _tiny_two_stage(dict(nms_iou_thr=0.85), iou_topk=8, beta_topk=2,
                           update_iter_interval=4)
    base.update(overrides)
    return DynamicRCNNConfig(**base)


def tiny_double_head_config(**overrides) -> DoubleHeadRCNNConfig:
    """A shrunken Double-Head R-CNN for fast CPU unit tests."""
    base = _tiny_two_stage(dh_num_convs=1, dh_num_fcs=1, dh_conv_out=16, dh_fc_out=32)
    base.update(overrides)
    return DoubleHeadRCNNConfig(**base)


def tiny_cascade_config(**overrides) -> CascadeRCNNConfig:
    """A shrunken Cascade R-CNN for fast CPU unit tests."""
    base = _tiny_two_stage()
    base.update(overrides)
    return CascadeRCNNConfig(**base)


# --- the Faster R-CNN variants on the same trunk (JAX :598-621, :790-819,
# :1097-1104): each is FasterRCNNConfig with the switches it sets ---------------

@dataclass(frozen=True)
class LibraRCNNConfig(FasterRCNNConfig):
    """Libra R-CNN (reference
    configs/libra_rcnn/libra_faster_rcnn_r50_fpn_1x_coco.py +
    mmdet/models/necks/bfp.py + core/bbox/samplers/
    {instance_balanced_pos,iou_balanced_neg}_sampler.py +
    models/losses/balanced_l1_loss.py): Faster R-CNN plus a Balanced
    Feature Pyramid after the FPN, the IoU-balanced CombinedSampler in
    the RoI head, Balanced L1 bbox regression, and RPN neg_pos_ub=5."""

    bfp_refine_level: int = 2
    bfp_refine_type: str = "non_local"
    num_bins: int = 3
    balanced_l1_alpha: float = 0.5
    balanced_l1_gamma: float = 1.5
    balanced_l1_beta: float = 1.0
    rpn: RPNCfg = field(default_factory=lambda: RPNCfg(neg_pos_ub=5))

    family = "libra_rcnn"


@dataclass(frozen=True)
class PAFPNFasterRCNNConfig(FasterRCNNConfig):
    """Faster R-CNN with the Path Aggregation FPN (reference
    configs/pafpn/faster_rcnn_r50_pafpn_1x_coco.py +
    mmdet/models/necks/pafpn.py): the only delta is the neck's extra
    bottom-up path."""

    neck_type: str = "pafpn"

    family = "pafpn"


@dataclass(frozen=True)
class CARAFEFasterRCNNConfig(FasterRCNNConfig):
    """Faster R-CNN with CARAFE top-down upsampling (reference
    configs/carafe/faster_rcnn_r50_fpn_carafe_1x_coco.py +
    mmdet/models/necks/fpn_carafe.py + the mmcv CARAFE op)."""

    neck_type: str = "carafe_fpn"

    family = "carafe"


@dataclass(frozen=True)
class GRoIEFasterRCNNConfig(FasterRCNNConfig):
    """Faster R-CNN with the Generic RoI Extractor (reference
    configs/groie/faster_rcnn_r50_fpn_groie_1x_coco.py +
    roi_heads/roi_extractors/generic_roi_extractor.py): RoIAlign the
    SAME rois from EVERY pyramid level (no finest_scale routing), a
    shared 5x5 pre-conv per level, sum aggregation, and a
    GeneralizedAttention ('0100', 6 heads, kv_stride 2) post module."""

    roi_extractor: str = "groie"

    family = "groie"


@dataclass(frozen=True)
class EmpiricalAttentionConfig(FasterRCNNConfig):
    """Faster R-CNN with GeneralizedAttention blocks after conv2 in
    backbone stages c4-c5 (reference configs/empirical_attention/
    faster_rcnn_r50_fpn_attention_{0010,1111}_1x_coco.py — the
    attention_type mask selects the energy terms; the default '0010'
    keeps only the bias-&-key-content term)."""

    backbone_attention: str = "0010"

    family = "empirical_attention"


def tiny_libra_config(**overrides) -> LibraRCNNConfig:
    """A shrunken Libra R-CNN for fast CPU unit tests."""
    base = _tiny_two_stage(dict(neg_pos_ub=5))
    base.update(overrides)
    return LibraRCNNConfig(**base)


def tiny_pafpn_config(**overrides) -> PAFPNFasterRCNNConfig:
    """A shrunken PAFPN Faster R-CNN for fast CPU unit tests."""
    base = _tiny_two_stage()
    base.update(overrides)
    return PAFPNFasterRCNNConfig(**base)


def tiny_carafe_config(**overrides) -> CARAFEFasterRCNNConfig:
    """A shrunken CARAFE Faster R-CNN for fast CPU unit tests."""
    base = _tiny_two_stage()
    base.update(overrides)
    return CARAFEFasterRCNNConfig(**base)


def tiny_groie_config(**overrides) -> GRoIEFasterRCNNConfig:
    """A shrunken GRoIE Faster R-CNN for fast CPU unit tests."""
    base = _tiny_two_stage()
    base.update(overrides)
    return GRoIEFasterRCNNConfig(**base)


def tiny_empirical_attention_config(**overrides) -> EmpiricalAttentionConfig:
    """A shrunken empirical-attention Faster R-CNN for CPU unit tests."""
    base = _tiny_two_stage(backbone_attention="1111")  # exercise every energy term
    base.update(overrides)
    return EmpiricalAttentionConfig(**base)


@dataclass(frozen=True)
class GNWSFasterRCNNConfig(FasterRCNNConfig):
    """Faster R-CNN with GroupNorm + Weight Standardization everywhere
    (reference configs/gn+ws/faster_rcnn_r50_fpn_gn_ws-all_1x_coco.py:
    ConvWS + GN(32) in backbone and FPN, Shared4Conv1FCBBoxHead RoI
    head). weight_standardize=False gives the plain-GN 'gn' family."""

    weight_standardize: bool = True

    family = "gn_ws"


@dataclass(frozen=True)
class FPGFasterRCNNConfig(FasterRCNNConfig):
    """Faster R-CNN with the Feature Pyramid Grids neck (reference
    configs/fpg/faster_rcnn_r50_fpg_crop640_50e_coco.py +
    mmdet/models/necks/fpg.py): 9 stacked bottom-up pathway stages over
    a 5-level grid with lateral / same-up / across-down / skip
    transitions (all act-conv-norm), staircase skip_inds."""

    neck_type: str = "fpg"
    fpg_stack_times: int = 9

    family = "fpg"


# HRNetV2p-w32's branch width (the backbone_type "hrnet" default)
HRNET_WIDTH = 32


@dataclass(frozen=True)
class HRNetFasterRCNNConfig(FasterRCNNConfig):
    """Faster R-CNN with the HRNetV2p backbone + HRFPN neck (reference
    configs/hrnet/faster_rcnn_hrnetv2p_w{18,32}_1x_coco.py +
    mmdet/models/backbones/hrnet.py + necks/hrfpn.py): parallel
    multi-resolution branches with exchange units instead of a serial
    trunk; the neck concatenates all branches at stride 4 and avg-pools
    the pyramid."""

    backbone_type: str = "hrnet"
    neck_type: str = "hrfpn"
    hrnet_width: int = HRNET_WIDTH
    hrnet_stage_modules: Tuple[int, ...] = (1, 4, 3)
    hrnet_num_blocks: int = 4
    hrnet_stage1_blocks: int = 4
    hrnet_stem_width: int = 64

    family = "hrnet"


@dataclass(frozen=True)
class ResNeStFasterRCNNConfig(FasterRCNNConfig):
    """Faster R-CNN with the ResNeSt split-attention backbone (reference
    configs/resnest/faster_rcnn_s50_fpn_syncbn-backbone+head_*.py +
    mmdet/models/backbones/resnest.py): radix-2 split-attention conv2,
    deep V1d stem, avg-down shortcuts."""

    backbone_type: str = "resnest"
    resnest_radix: int = 2

    family = "resnest"


@dataclass(frozen=True)
class PISAFasterRCNNConfig(FasterRCNNConfig):
    """PISA Faster R-CNN (reference configs/pisa/pisa_faster_rcnn_r50_
    fpn_1x_coco.py + roi_heads/pisa_roi_head.py + samplers/
    score_hlr_sampler.py): ScoreHLR negative sampling/weighting (one
    extra no-grad RoI pass), ISR-P positive reweighting and CARL in the
    RoI loss; RPN proposals widened to 2000 train/test."""

    isr_k: float = 2.0
    isr_bias: float = 0.0
    carl_k: float = 1.0
    carl_bias: float = 0.2
    hlr_k: float = 0.5
    hlr_bias: float = 0.0
    hlr_score_thr: float = 0.05
    hlr_iou_thr: float = 0.5
    rpn: RPNCfg = field(default_factory=lambda: RPNCfg(
        train_nms_pre=2000, train_max_per_img=2000,
        test_nms_pre=2000, test_max_per_img=2000,
        sampler_num=256))
    rcnn: RCNNCfg = field(default_factory=lambda: RCNNCfg(
        sampler_num=512, pos_fraction=0.25))

    family = "pisa_faster_rcnn"


def tiny_pisa_rcnn_config(**overrides) -> PISAFasterRCNNConfig:
    """A shrunken PISA Faster R-CNN for fast CPU unit tests."""
    base = _tiny_two_stage()
    base["rcnn"] = RCNNCfg(sampler_num=32, pos_fraction=0.25, fc_channels=32)
    base.update(overrides)
    return PISAFasterRCNNConfig(**base)


def tiny_gn_ws_config(**overrides) -> GNWSFasterRCNNConfig:
    """A shrunken GN+WS Faster R-CNN for fast CPU unit tests."""
    base = _tiny_two_stage()
    base.update(overrides)
    return GNWSFasterRCNNConfig(**base)


def tiny_fpg_config(**overrides) -> FPGFasterRCNNConfig:
    """A shrunken FPG Faster R-CNN for fast CPU unit tests."""
    base = _tiny_two_stage(fpg_stack_times=5)
    base.update(overrides)
    return FPGFasterRCNNConfig(**base)


def tiny_hrnet_config(**overrides) -> HRNetFasterRCNNConfig:
    """A shrunken HRNet Faster R-CNN for fast CPU unit tests."""
    base = _tiny_two_stage(hrnet_width=4, hrnet_stage_modules=(1, 1, 1), hrnet_num_blocks=1,
                           hrnet_stage1_blocks=1, hrnet_stem_width=8)
    del base["block_counts"]  # HRNet's tiny config keeps the R50 default (unread)
    base.update(overrides)
    return HRNetFasterRCNNConfig(**base)


def tiny_resnest_config(**overrides) -> ResNeStFasterRCNNConfig:
    """A shrunken ResNeSt Faster R-CNN for fast CPU unit tests."""
    base = _tiny_two_stage()
    base.update(overrides)
    return ResNeStFasterRCNNConfig(**base)


@dataclass(frozen=True)
class RPNOnlyConfig(FasterRCNNConfig):
    """Proposal-only RPN (reference mmdet/models/detectors/rpn.py +
    configs/rpn/rpn_r50_fpn_1x_coco.py): backbone + FPN + RPNHead
    trained alone on class-agnostic gt boxes; eval emits the proposals
    as single-class detections and is scored by AR@k proposal recall
    (fast_eval_recall)."""

    family = "rpn"

    @property
    def num_fg_classes(self) -> int:
        return 1


@dataclass(frozen=True)
class TridentNetConfig(FasterRCNNConfig):
    """TridentNet (reference configs/tridentnet/
    tridentnet_r50_caffe_1x_coco.py + mmdet/models/backbones/
    trident_resnet.py + detectors/trident_faster_rcnn.py +
    roi_heads/trident_roi_head.py): a C4 Faster R-CNN whose stage-3
    conv2s share ONE kernel applied at dilations (1, 2, 3) — three
    scale-specialized branches riding the batch axis at train time
    (gts replicated branch-major), with only branch test_branch_idx=1
    run at eval. RoI head = single-level RoIAlign 14 on C4 + the conv5
    ResLayer (stride 2) + avg-pool BBoxHead (faster_rcnn_r50_caffe_c4).
    Caffe normalization (BGR, std 1)."""

    block_counts: Tuple[int, ...] = (3, 4, 6)
    head_blocks: int = 3
    trident_dilations: Tuple[int, ...] = (1, 2, 3)
    test_branch_idx: int = 1
    c4_stride: int = 16
    anchor_scales: Tuple[float, ...] = (2.0, 4.0, 8.0, 16.0, 32.0)
    rpn: RPNCfg = field(default_factory=lambda: RPNCfg(
        anchor_strides=(16,), ratios=(0.5, 1.0, 2.0),
        train_nms_pre=4000, train_max_per_img=500,
        test_nms_pre=2000, test_max_per_img=1000))
    rcnn: RCNNCfg = field(default_factory=lambda: RCNNCfg(
        sampler_num=128, pos_fraction=0.5, roi_size=14, roi_strides=(16,)))
    img_mean: Tuple[float, ...] = (103.530, 116.280, 123.675)
    img_std: Tuple[float, ...] = (1.0, 1.0, 1.0)
    img_to_rgb: bool = False

    family = "tridentnet"

    @property
    def num_anchors_per_cell(self) -> int:
        return len(self.rpn.ratios) * len(self.anchor_scales)

    def build_anchor_generator(self):
        from ..ops.anchors import AnchorGenerator

        return AnchorGenerator(strides=self.rpn.anchor_strides,
                               ratios=self.rpn.ratios,
                               scales=self.anchor_scales)

    def featmap_sizes(self):
        h, w = self.canvas
        assert h % 32 == 0 and w % 32 == 0
        return [(h // self.c4_stride, w // self.c4_stride)]

    def level_bounds(self):
        (h, w), = self.featmap_sizes()
        return [(0, h * w * self.num_anchors_per_cell)]


@dataclass(frozen=True)
class CascadeRPNConfig(RPNOnlyConfig):
    """Cascade RPN (reference configs/cascade_rpn/
    crpn_r50_caffe_fpn_1x_coco.py + mmdet/models/dense_heads/
    cascade_rpn_head.py): two-stage anchor refinement with a single
    square anchor per cell — stage 0 adapts features with a dilated
    conv and regresses on region-assigned anchors (IoU loss on decoded
    boxes, no cls); stage 1 runs an anchor-offset deform conv on the
    bridged features over the refined anchors (MaxIoU .7/.7/.3 +
    RandomSampler 256, BCE + IoU loss). Proposal NMS iou 0.8."""

    rpn: RPNCfg = field(default_factory=lambda: RPNCfg(
        ratios=(1.0,), pos_iou_thr=0.7, neg_iou_thr=0.7, min_pos_iou=0.3,
        sampler_num=256, pos_fraction=0.5, nms_iou_thr=0.8,
        train_nms_pre=2000, train_max_per_img=2000,
        test_nms_pre=2000, test_max_per_img=2000))
    s0_stds: Tuple[float, ...] = (0.1, 0.1, 0.5, 0.5)
    s1_stds: Tuple[float, ...] = (0.05, 0.05, 0.1, 0.1)
    center_ratio: float = 0.2
    ignore_ratio: float = 0.5
    stage0_dilation: int = 3

    family = "cascade_rpn"


@dataclass(frozen=True)
class FastRCNNConfig(FasterRCNNConfig):
    """Fast R-CNN (reference mmdet/models/detectors/fast_rcnn.py +
    configs/fast_rcnn/fast_rcnn_r50_fpn_1x_coco.py): backbone + FPN +
    RoI head consuming EXTERNALLY supplied proposals (the reference's
    proposal_file .pkls; here fixed-width [B, P, 4] arrays with a valid
    mask). num_proposals is P, the per-image proposal slot count."""

    num_proposals: int = 512

    family = "fast_rcnn"


@dataclass(frozen=True)
class GridRCNNConfig(FasterRCNNConfig):
    """Grid R-CNN (reference configs/grid_rcnn/grid_rcnn_r50_fpn_
    gn-head_2x_coco.py + roi_heads/grid_roi_head.py + mask_heads/
    grid_head.py): cls-only RoI head; box geometry from a 9-point grid
    heatmap head (8 GN convs at 576ch, neighbor fusion, grouped
    deconvs to 28x28 sub-region maps) trained on jittered positives and
    decoded by boundary voting. RPN bbox loss here is plain L1 (the
    reference's SmoothL1 beta 1/9 — equal above |x| = 1/9)."""

    grid_points: int = 9
    grid_convs: int = 8
    grid_point_channels: int = 64
    grid_roi_size: int = 14
    grid_pos_radius: int = 1
    grid_loss_weight: float = 15.0

    family = "grid_rcnn"


def tiny_rpn_config(**overrides) -> RPNOnlyConfig:
    """A shrunken proposal-only RPN for fast CPU unit tests."""
    base = _tiny_two_stage()
    del base["rcnn"]
    base.update(overrides)
    return RPNOnlyConfig(**base)


def tiny_fast_rcnn_config(**overrides) -> FastRCNNConfig:
    """A shrunken Fast R-CNN for fast CPU unit tests."""
    base = _tiny_two_stage(num_proposals=64)
    base.update(overrides)
    return FastRCNNConfig(**base)


def tiny_trident_config(**overrides) -> TridentNetConfig:
    """A shrunken TridentNet for fast CPU unit tests."""
    base = dict(
        canvas=(64, 128),
        block_counts=(1, 1, 1),
        head_blocks=1,
        stem_width=8,
        num_classes=6,
        max_gt=8,
        anchor_scales=(1.0, 2.0, 4.0),
        rpn=RPNCfg(anchor_strides=(16,), ratios=(0.5, 1.0, 2.0),
                   train_nms_pre=96, train_max_per_img=48,
                   test_nms_pre=96, test_max_per_img=48, sampler_num=64),
        rcnn=RCNNCfg(sampler_num=32, pos_fraction=0.5, roi_size=14,
                     roi_strides=(16,)),
        test=TestCfg(nms_pre=48, pre_nms_cands=48, max_per_img=20),
    )
    base.update(overrides)
    return TridentNetConfig(**base)


def tiny_cascade_rpn_config(**overrides) -> CascadeRPNConfig:
    """A shrunken Cascade RPN for fast CPU unit tests."""
    base = _tiny_two_stage(rpn_kw=dict(ratios=(1.0,), pos_iou_thr=0.7, neg_iou_thr=0.7,
                                       min_pos_iou=0.3, nms_iou_thr=0.8))
    del base["rcnn"]
    base.update(overrides)
    return CascadeRPNConfig(**base)


def tiny_grid_rcnn_config(**overrides) -> GridRCNNConfig:
    """A shrunken Grid R-CNN for fast CPU unit tests."""
    base = _tiny_two_stage(grid_point_channels=8)  # conv_out 72, still divisible by GN 36
    base.update(overrides)
    return GridRCNNConfig(**base)


# The model-zoo families the port has: name -> (full-size config class,
# tiny test-config factory), the JAX package's ZOO_FAMILIES (:3569) cut to
# them, in its order. Every port CLI reads its --family choices here; the
# other 33 families of the JAX registry come with ROADMAP Queue 1 item 15.
ZOO_FAMILIES = {
    "faster_rcnn": (FasterRCNNConfig, tiny_faster_rcnn_config),
    "libra_rcnn": (LibraRCNNConfig, tiny_libra_config),
    "pafpn": (PAFPNFasterRCNNConfig, tiny_pafpn_config),
    "dynamic_rcnn": (DynamicRCNNConfig, tiny_dynamic_rcnn_config),
    "double_head_rcnn": (DoubleHeadRCNNConfig, tiny_double_head_config),
    "cascade_rcnn": (CascadeRCNNConfig, tiny_cascade_config),
    "rpn": (RPNOnlyConfig, tiny_rpn_config),
    "cascade_rpn": (CascadeRPNConfig, tiny_cascade_rpn_config),
    "tridentnet": (TridentNetConfig, tiny_trident_config),
    "hrnet": (HRNetFasterRCNNConfig, tiny_hrnet_config),
    "resnest": (ResNeStFasterRCNNConfig, tiny_resnest_config),
    "groie": (GRoIEFasterRCNNConfig, tiny_groie_config),
    "fpg": (FPGFasterRCNNConfig, tiny_fpg_config),
    "gn_ws": (GNWSFasterRCNNConfig, tiny_gn_ws_config),
    "empirical_attention": (EmpiricalAttentionConfig, tiny_empirical_attention_config),
    "fast_rcnn": (FastRCNNConfig, tiny_fast_rcnn_config),
    "pisa_faster_rcnn": (PISAFasterRCNNConfig, tiny_pisa_rcnn_config),
    "grid_rcnn": (GridRCNNConfig, tiny_grid_rcnn_config),
    "carafe": (CARAFEFasterRCNNConfig, tiny_carafe_config),
}

# the two AL families and the zoo: every family init_detector builds
ALL_FAMILIES = ("retinanet", "ssd") + tuple(ZOO_FAMILIES)


# --- the reference-config loader (JAX utils/config.py:2297-2510) -------------------

def _cfg_get(ns: dict, path: str, default=None):
    cur = ns
    for part in path.split("."):
        if isinstance(cur, dict) and part in cur:
            cur = cur[part]
        else:
            return default
    return cur


# top-level keys the loader understands (or knowingly ignores: log, dist and
# runner settings are the host loop's business here); the JAX list verbatim
_KNOWN_TOP_KEYS = {
    "checkpoint_config", "log_config", "custom_hooLoks", "custom_hooks",
    "dist_params", "log_level", "load_from", "resume_from", "workflow",
    "uncertainty_pool", "uncertainty_type", "uncertainty_pool2",
    "input_size", "model", "optimizer", "optimizer_config", "lr_config",
    "runner", "dataset_type", "data_root", "img_norm_cfg",
    "train_pipeline", "test_pipeline", "data", "evaluation",
    "X_S_size", "X_L_0_size", "cycles", "epoch_ratio", "outer_epoch",
    "X_L_repeat", "X_U_repeat", "train_cfg", "k",
}

_LOSS_CLS_MAP = {
    "EDL_Softmax_FocalLoss": "edl_softmax_focal",
    "EDL_FocalLoss": "edl_focal",
    "EDL_ReLU": "edl_relu",
    "FocalLoss": "focal",
    "MyFocalLoss": "focal",
}


def _warn(msg: str):
    import warnings

    warnings.warn(f"load_reference_config: {msg}", stacklevel=3)


def reference_data_roots(ns: dict):
    """Extract (voc07, voc12) dataset roots from a loaded reference
    config's data.train.dataset.img_prefix / data_root
    (Config_RetinaNet.py:98,133-139). Returns (voc07, voc12-or-None)."""
    prefixes = _cfg_get(ns, "data.train.dataset.img_prefix") or \
        _cfg_get(ns, "data.train.img_prefix")
    if prefixes is None and ns.get("data_root"):
        root = ns["data_root"]
        prefixes = [root + "VOC2007/", root + "VOC2012/"]
    if prefixes is None:
        return None, None
    if isinstance(prefixes, str):
        prefixes = [prefixes]
    voc07 = next((p.rstrip("/") for p in prefixes if "2007" in p), None)
    voc12 = next((p.rstrip("/") for p in prefixes if "2012" in p), None)
    return voc07, voc12


def load_reference_config(path: str):
    """Load a reference-style plain-python config file.

    Executes the file (the mmcv Config.fromfile semantic for the two live
    monolithic configs, Config_RetinaNet.py / Config_SSD.py) and maps
    every AL-relevant key onto the dataclasses above; dispatches on
    model.type to build a RetinaNetConfig or SSDConfig. Unrecognized
    top-level keys and un-honorable settings warn loudly; an optimizer
    or classification loss the engine cannot reproduce raises.
    Returns (model_cfg, TrainConfig, ALConfig, raw namespace).
    """
    ns = runpy.run_path(path)
    for key in sorted(k for k in ns if not k.startswith("__")):
        if key not in _KNOWN_TOP_KEYS and not callable(ns[key]) \
                and not isinstance(ns[key], type(runpy)):
            _warn(f"unrecognized top-level key {key!r} is ignored")

    model = ns.get("model", {})
    mtype = str(model.get("type", "SSL_L_RetinaNet"))
    if "SSD" in mtype.upper():
        family = "ssd"
    elif "RETINANET" in mtype.upper():
        family = "retinanet"
    else:
        raise ValueError(
            f"model.type {mtype!r}: the reference-config loader maps the two "
            f"live AL configs (Config_RetinaNet.py / Config_SSD.py). Zoo "
            f"families (FasterRCNN/CascadeRCNN/FCOS/ATSS) are configured via "
            f"their dataclasses + tools/train_detector.py, not mmcv-style "
            f"_base_-inheriting config files.")
    ag = _cfg_get(model, "bbox_head.anchor_generator", {}) or {}
    test_cfg = model.get("test_cfg", {}) or {}
    train_cfg = model.get("train_cfg", {}) or {}
    assigner = train_cfg.get("assigner", {}) or {}
    coder = _cfg_get(model, "bbox_head.bbox_coder", {}) or {}
    loss_cls = _cfg_get(model, "bbox_head.loss_cls", {}) or {}
    nms = test_cfg.get("nms", {}) or {}
    neck = model.get("neck", {}) or {}

    hua = HUACfg(
        pool=ns.get("uncertainty_pool", "Entropy_NMS"),
        unc_type=ns.get("uncertainty_type", "Epistemic").lower(),
        agg=ns.get("uncertainty_pool2", "objectSum_scaleMax_classSum"),
    )

    if family == "ssd":
        tcfg_defaults = dict(max_per_img=200, score_thr=0.02)
        model_cfg = SSDConfig(
            num_classes=_cfg_get(model, "bbox_head.num_classes", 20),
            input_size=ns.get("input_size", ag.get("input_size", 300)),
            neck_out_channels=tuple(neck.get("out_channels",
                                             (512, 1024, 512, 256, 256, 256))),
            level_strides=tuple(neck.get("level_strides", (2, 2, 1, 1))),
            level_paddings=tuple(neck.get("level_paddings", (1, 1, 0, 0))),
            l2_norm_scale=neck.get("l2_norm_scale", 20.0),
            anchor=SSDAnchorCfg(
                strides=tuple(ag.get("strides", (8, 16, 32, 64, 100, 300))),
                ratios=tuple(tuple(r) for r in ag.get(
                    "ratios", ((2,), (2, 3), (2, 3), (2, 3), (2,), (2,)))),
                basesize_ratio_range=tuple(ag.get("basesize_ratio_range", (0.15, 0.9))),
                input_size=ag.get("input_size", ns.get("input_size", 300)),
            ),
            target_means=tuple(coder.get("target_means", (0.0,) * 4)),
            target_stds=tuple(coder.get("target_stds", (0.1, 0.1, 0.2, 0.2))),
            pos_iou_thr=assigner.get("pos_iou_thr", 0.5),
            neg_iou_thr=assigner.get("neg_iou_thr", 0.5),
            min_pos_iou=assigner.get("min_pos_iou", 0.0),
            gt_max_assign_all=assigner.get("gt_max_assign_all", False),
            neg_pos_ratio=train_cfg.get("neg_pos_ratio", 3),
            smoothl1_beta=train_cfg.get("smoothl1_beta", 1.0),
            test=TestCfg(
                nms_pre=test_cfg.get("nms_pre", 1000),
                score_thr=test_cfg.get("score_thr", tcfg_defaults["score_thr"]),
                nms_iou_thr=nms.get("iou_threshold", 0.5),
                max_per_img=test_cfg.get("max_per_img", tcfg_defaults["max_per_img"]),
            ),
            hua=hua,
        )
    else:
        if loss_cls:
            lc_type = loss_cls.get("type", "EDL_Softmax_FocalLoss")
            if lc_type not in _LOSS_CLS_MAP:
                raise ValueError(
                    f"loss_cls.type {lc_type!r} has no engine equivalent "
                    f"(known: {sorted(_LOSS_CLS_MAP)})")
            cls_loss = _LOSS_CLS_MAP[lc_type]
        else:
            cls_loss = "edl_softmax_focal"
        model_cfg = RetinaNetConfig(
            num_classes=_cfg_get(model, "bbox_head.num_classes", 20),
            frozen_stages=_cfg_get(model, "backbone.frozen_stages", 1),
            fpn_channels=neck.get("out_channels", 256),
            stacked_convs=_cfg_get(model, "bbox_head.stacked_convs", 4),
            feat_channels=_cfg_get(model, "bbox_head.feat_channels", 256),
            anchor=AnchorConfig(
                strides=tuple(ag.get("strides", (8, 16, 32, 64, 128))),
                ratios=tuple(ag.get("ratios", (0.5, 1.0, 2.0))),
                octave_base_scale=ag.get("octave_base_scale", 4),
                scales_per_octave=ag.get("scales_per_octave", 3),
            ),
            target_means=tuple(coder.get("target_means", (0.0,) * 4)),
            target_stds=tuple(coder.get("target_stds", (1.0,) * 4)),
            pos_iou_thr=assigner.get("pos_iou_thr", 0.5),
            neg_iou_thr=assigner.get("neg_iou_thr", 0.4),
            min_pos_iou=assigner.get("min_pos_iou", 0.0),
            gt_max_assign_all=assigner.get("gt_max_assign_all", True),
            cls_loss=cls_loss,
            focal_gamma=loss_cls.get("gamma", 2.0),
            focal_alpha=loss_cls.get("alpha", 0.25),
            test=TestCfg(
                nms_pre=test_cfg.get("nms_pre", 1000),
                score_thr=test_cfg.get("score_thr", 0.05),
                nms_iou_thr=nms.get("iou_threshold", 0.5),
                max_per_img=test_cfg.get("max_per_img", 100),
            ),
            hua=hua,
        )

    opt = ns.get("optimizer", {})
    if opt.get("type", "SGD") != "SGD":
        raise ValueError(
            f"optimizer.type {opt.get('type')!r}: the engine implements the "
            f"reference's SGD(momentum, wd) exactly; other optimizers would "
            f"silently change training semantics")
    lr_cfg = ns.get("lr_config", {}) or {}
    if lr_cfg.get("policy", "step") != "step":
        _warn(f"lr_config.policy {lr_cfg.get('policy')!r} unsupported; using 'step'")
    steps = lr_cfg.get("step", [2])
    if len(steps) > 1:
        _warn(f"lr_config.step {steps}: only the first step epoch is honored "
              f"(the AL schedule re-inits per run; train_RetinaNet.py:179-200)")
    warmup = lr_cfg.get("warmup")
    if warmup not in (None, "linear"):
        _warn(f"lr_config.warmup {warmup!r} unsupported; using linear")
    opt_cfg = ns.get("optimizer_config", {}) or {}
    train = TrainConfig(
        lr=opt.get("lr", 0.001),
        momentum=opt.get("momentum", 0.9),
        weight_decay=opt.get("weight_decay", 1e-4),
        batch_size=_cfg_get(ns, "data.samples_per_gpu", 2),
        outer_epoch=ns.get("outer_epoch", 2),
        epoch_ratio=tuple(ns.get("epoch_ratio", (3, 1))),
        lr_step_epoch=steps[0],
        grad_clip=(opt_cfg.get("grad_clip") or {}).get("max_norm")
        if isinstance(opt_cfg.get("grad_clip"), dict) else opt_cfg.get("grad_clip"),
        warmup_iters=lr_cfg.get("warmup_iters", 0) if warmup else 0,
        warmup_ratio=lr_cfg.get("warmup_ratio", 1e-3),
    )
    al = ALConfig(
        cycles=tuple(ns.get("cycles", range(7))),
        x_l_0_size=ns.get("X_L_0_size", 16551 // 20),
        x_s_size=ns.get("X_S_size", 16551 // 40),
        # X_L_repeat overrides RepeatDataset times (active_datasets.py:63)
        x_l_repeat=ns.get("X_L_repeat", 2),
        x_u_repeat=ns.get("X_U_repeat", 2),
        eval_interval=_cfg_get(ns, "evaluation.interval", 3),
    )
    return model_cfg, train, al, ns
