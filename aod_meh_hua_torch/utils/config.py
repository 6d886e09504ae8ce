"""Config dataclasses of the ported families.

A copy of `AnchorConfig`, `TestCfg`, `HUACfg`, `RetinaNetConfig`,
`SSDAnchorCfg`, `SSDConfig`, `TrainConfig`, `ALConfig` and
`tiny_test_config` from aod_meh_hua_tpu/utils/config.py (:18-298,
:2246-2294, :3545), and of the Faster R-CNN family's `RPNCfg`, `RCNNCfg`,
`FasterRCNNConfig` and `tiny_faster_rcnn_config` (:301-434, :2513) with
`ZOO_FAMILIES` (:3569) cut to the families the port has.
The port keeps its own copy because it imports nothing of the JAX
package; tests/test_torch_ops.py and tests/test_torch_two_stage.py hold
the copies equal field by field.
"""

from __future__ import annotations

import dataclasses
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
    balanced pyramid, sampler and loss; the last seven are fields of its
    subclasses there). The port builds the ResNet + FPN form only:
    models/two_stage.py check_two_stage_options raises on any of them
    set, as on compute_dtype="bfloat16", remat and stem_s2d."""

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


def tiny_faster_rcnn_config(**overrides) -> FasterRCNNConfig:
    """A shrunken Faster R-CNN for fast CPU unit tests."""
    base = dict(
        canvas=(64, 128),
        block_counts=(1, 1, 1, 1),
        stem_width=8,
        fpn_channels=16,
        num_classes=6,
        max_gt=8,
        rpn=RPNCfg(train_nms_pre=256, train_max_per_img=64,
                   test_nms_pre=256, test_max_per_img=64,
                   sampler_num=64),
        rcnn=RCNNCfg(sampler_num=32, fc_channels=32),
        test=TestCfg(nms_pre=200, pre_nms_cands=128, max_per_img=20),
    )
    base.update(overrides)
    return FasterRCNNConfig(**base)


# The model-zoo families the port has: name -> (full-size config class,
# tiny test-config factory), the JAX package's ZOO_FAMILIES (:3569) cut to
# them. Every port CLI reads its --family choices here; the other 51
# families of the JAX registry come with ROADMAP Queue 1 item 15.
ZOO_FAMILIES = {
    "faster_rcnn": (FasterRCNNConfig, tiny_faster_rcnn_config),
}

# the two AL families and the zoo: every family init_detector builds
ALL_FAMILIES = ("retinanet", "ssd") + tuple(ZOO_FAMILIES)
