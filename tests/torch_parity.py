"""Inputs shared by the port's parity tests (tests/test_torch_*.py):
seeded variables of a tiny JAX MEH-RetinaNet and of a thin JAX MEH-SSD,
and seeded synthetic training batches, as numpy arrays.

TINY is tiny_test_config(block_counts=(2, 2, 1, 1), stem_width=32,
num_classes=20): layer1.1 (Cin 128) and layer2.1 (Cin 256) pass the
fused gate, and layer1, which training freezes, has two blocks.
"""

import contextlib
import functools
import os

import jax
import numpy as np
import pytest
import torch

from aod_meh_hua_tpu.models.detector import build_retinanet
from aod_meh_hua_tpu.models.ssd_detector import build_ssd
from aod_meh_hua_tpu.ops import anchor_valid_flags
from aod_meh_hua_tpu.utils.config import SSDConfig, tiny_test_config

TINY = dict(block_counts=(2, 2, 1, 1), stem_width=32, num_classes=20)
# the thin SSD of the tests (the JAX SSD CLI's --mini model): the real
# 300 geometry, 8732 anchors, 21 columns, VGG16 at 1/8 of its width
THIN_SSD = dict(width_mult=0.125, max_gt=8)


@functools.lru_cache(maxsize=None)
def _tree(overrides):
    cfg = tiny_test_config(**dict(overrides))
    model = build_retinanet(cfg)
    h, w = cfg.canvas
    return model, jax.eval_shape(model.init, jax.random.PRNGKey(0),
                                 jax.ShapeDtypeStruct((1, h, w, 3), np.float32))


def jax_retinanet(seed=0, **overrides):
    """(Flax model, variables) of tiny_test_config(**overrides), the
    variables a seeded numpy draw in the tree model.init makes (tracing
    it, which is much faster on the CPU than running it): convs
    N(0, 1/fan_in), the head's N(0, 0.01^2), zero conv biases but a
    uniform retina_cls bias, BN with scale and bias near (1, 0) and
    running statistics near (0, 1), so that folding BN is not the
    identity."""
    model, shapes = _tree(tuple(sorted(overrides.items())))
    rng = np.random.RandomState(seed)

    def draw(path, leaf):
        keys = [getattr(k, "key", str(k)) for k in path]
        shape, name = leaf.shape, keys[-1]
        if name == "kernel":
            std = 0.01 if "head" in keys else float(np.prod(shape[:-1])) ** -0.5
            return (rng.randn(*shape) * std).astype(np.float32)
        if name == "bias" and "retina_cls" in keys:
            return rng.uniform(-0.05, 0.05, shape).astype(np.float32)
        if name in ("scale", "var"):
            return rng.uniform(0.7, 1.3, shape).astype(np.float32)
        if name == "mean" or (name == "bias" and keys[1] == "backbone"):
            return (rng.randn(*shape) * 0.05).astype(np.float32)
        return np.zeros(shape, np.float32)

    return model, jax.tree_util.tree_map_with_path(draw, shapes)


@functools.lru_cache(maxsize=None)
def _ssd_tree(overrides):
    cfg = SSDConfig(**dict(overrides))
    model = build_ssd(cfg)
    s = cfg.input_size
    return model, jax.eval_shape(model.init, jax.random.PRNGKey(0),
                                 jax.ShapeDtypeStruct((1, s, s, 3), np.float32))


def jax_ssd(seed=0, **overrides):
    """(Flax model, variables) of SSDConfig(**THIN_SSD, **overrides), a
    seeded numpy draw in the tree model.init makes: backbone and neck
    convs N(0, 1/fan_in) with small biases, head convs Xavier-uniform
    with small biases, L2Norm scales around 20."""
    model, shapes = _ssd_tree(tuple(sorted({**THIN_SSD, **overrides}.items())))
    rng = np.random.RandomState(seed)

    def draw(path, leaf):
        keys = [getattr(k, "key", str(k)) for k in path]
        shape, name = leaf.shape, keys[-1]
        if name == "kernel":
            if keys[1] == "head":
                bound = (6.0 / (np.prod(shape[:-2]) * (shape[-2] + shape[-1]))) ** 0.5
                return rng.uniform(-bound, bound, shape).astype(np.float32)
            return (rng.randn(*shape) * float(np.prod(shape[:-1])) ** -0.5).astype(np.float32)
        if name == "scale":
            return rng.uniform(15.0, 25.0, shape).astype(np.float32)
        return (rng.randn(*shape) * 0.02).astype(np.float32)

    return model, jax.tree_util.tree_map_with_path(draw, shapes)


def train_batch(cfg, seed=0, b=2, max_boxes=3):
    """(images, gt_boxes, gt_labels, gt_valid, anchor_valid, img_shapes):
    normalised float32 canvases, 1..max_boxes boxes per image padded to
    cfg.max_gt, and the pad-region flags of each image's shape (the
    second image is cut short, so some anchors are invalid)."""
    rng = np.random.RandomState(seed)
    h, w = cfg.canvas
    images = rng.randn(b, h, w, 3).astype(np.float32) * 0.5
    g = cfg.max_gt
    gt_boxes = np.zeros((b, g, 4), np.float32)
    gt_labels = np.zeros((b, g), np.int32)
    gt_valid = np.zeros((b, g), bool)
    shapes = np.tile([[h, w]], (b, 1)).astype(np.int32)
    shapes[1:] = [h - 24, w - 40]
    for i in range(b):
        for j in range(rng.randint(1, max_boxes + 1)):
            x1, y1 = rng.uniform(0, shapes[i, 1] - 72), rng.uniform(0, shapes[i, 0] - 72)
            bw, bh = rng.uniform(16, 70), rng.uniform(16, 70)
            gt_boxes[i, j] = [x1, y1, x1 + bw, y1 + bh]
            gt_labels[i, j] = rng.randint(0, cfg.num_classes)
            gt_valid[i, j] = True
    av = anchor_valid_flags(cfg.build_anchor_generator(), cfg.featmap_sizes(), shapes)
    return images, gt_boxes, gt_labels, gt_valid, av, shapes


# torch's intra-op threads while a port test file runs: the tiny models'
# ops are too small to split, and torch's default of one thread per core,
# in each of the suite's workers, oversubscribes the machine (a tiny
# forward took 0.1-0.7 s with 8 threads against 0.015 s with 1 or 2)
TEST_THREADS = 2


@pytest.fixture(scope="module")
def few_threads():
    """torch.set_num_threads(TEST_THREADS) for a module, restored after.
    A file opts in with pytestmark = pytest.mark.usefixtures("few_threads")
    and imports the fixture."""
    before = torch.get_num_threads()
    torch.set_num_threads(TEST_THREADS)
    try:
        yield
    finally:
        torch.set_num_threads(before)


def mini_voc(root):
    """The mini VOC tree of tests/test_al_loop.py under `root`:
    make_voc(n=14, seed=3), its first 4 ids also the test split. Returns
    the VOC2007 directory."""
    from test_data import make_voc

    base, _, ids = make_voc(str(root), "VOC2007", n=14, seed=3)
    with open(os.path.join(base, "ImageSets/Main/test.txt"), "w") as f:
        f.write("\n".join(ids[:4]))
    return base


def sharpen(variables, factor):
    """JAX variables with the retina_cls kernel scaled by `factor` (logits
    of std ~1.5 at 150 on the tiny models), a stand-in for a trained cls
    head: random heads give a near-uniform softmax, and every pool score
    is 0."""
    params = dict(variables["params"])
    head = dict(params["head"])
    cls = dict(head["retina_cls"])
    cls["kernel"] = np.asarray(cls["kernel"]) * np.float32(factor)
    head["retina_cls"] = cls
    params["head"] = head
    return {**variables, "params": params}


def no_exact_low_quality_ties(cfg, arrays):
    """True when no valid GT of a train_batch has its maximal IoU at two
    valid anchors with exactly the same value: the ties of the assigner's
    low-quality matches, which the jitted JAX program breaks otherwise
    than eager JAX and the port (ROADMAP Queue 3)."""
    from aod_meh_hua_torch.ops.bbox import bbox_overlaps

    anchors = torch.from_numpy(np.concatenate(
        cfg.build_anchor_generator().grid_anchors(cfg.featmap_sizes())).astype(np.float32))
    _, boxes, _, gt_valid, av, _ = (torch.from_numpy(np.asarray(a)) for a in arrays)
    ious = torch.where(av[:, None, :], bbox_overlaps(boxes, anchors), torch.tensor(-1.0))
    counts = (ious == ious.amax(dim=-1, keepdim=True)).sum(dim=-1)
    return bool((counts[gt_valid] == 1).all())


@contextlib.contextmanager
def numerics_flags_kept():
    """Restore torch's cuDNN and matmul flags on exit: the port's CLIs pin
    them process-wide (utils/device.py pin_numerics), and the flags of
    one test must not leak into the next in the same worker."""
    b = torch.backends
    saved = (b.cudnn.allow_tf32, b.cuda.matmul.allow_tf32, b.cudnn.deterministic,
             b.cudnn.benchmark)
    try:
        yield
    finally:
        (b.cudnn.allow_tf32, b.cuda.matmul.allow_tf32, b.cudnn.deterministic,
         b.cudnn.benchmark) = saved


@contextlib.contextmanager
def tf32_off():
    """TF32 off for the block (the parity tests' setting), restored after."""
    with numerics_flags_kept():
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        yield


@functools.lru_cache(maxsize=None)
def _two_stage_tree(family, overrides):
    from aod_meh_hua_tpu.models import (build_cascade_rcnn, build_double_head_rcnn,
                                        build_faster_rcnn)
    from aod_meh_hua_tpu.utils.config import ZOO_FAMILIES

    from aod_meh_hua_tpu.models.cascade_rpn import build_cascade_rpn
    from aod_meh_hua_tpu.models.gn_ws import build_gn_ws
    from aod_meh_hua_tpu.models.grid_rcnn import build_grid_rcnn
    from aod_meh_hua_tpu.models.rpn_only import build_fast_rcnn, build_rpn_only
    from aod_meh_hua_tpu.models.trident import build_trident

    cfg = ZOO_FAMILIES[family][1](**dict(overrides))
    build = {"cascade_rcnn": build_cascade_rcnn, "double_head_rcnn": build_double_head_rcnn,
             "gn_ws": build_gn_ws, "rpn": build_rpn_only, "fast_rcnn": build_fast_rcnn,
             "cascade_rpn": build_cascade_rpn, "tridentnet": build_trident,
             "grid_rcnn": build_grid_rcnn}.get(family, build_faster_rcnn)
    model = build(cfg)
    h, w = cfg.canvas
    return model, jax.eval_shape(model.init, jax.random.PRNGKey(0),
                                 jax.ShapeDtypeStruct((1, h, w, 3), np.float32))


def jax_faster_rcnn(seed=0, rpn_cls_std=3.0, fc_cls_std=1.5, **overrides):
    """(Flax model, variables) of tiny_faster_rcnn_config(**overrides), a
    seeded numpy draw in the tree model.init makes: convs and the shared
    fcs N(0, 1/fan_in), fc_reg N(0, 0.1/fan_in), small biases, BN near
    identity as jax_retinanet's. The rpn_cls kernel's draw is scaled by
    `rpn_cls_std` and fc_cls's by `fc_cls_std` (objectness logits of std
    0.7 on the tiny model's batch): the JAX initialisers' N(0, 0.01)
    heads put every sigmoid and softmax score within an ulp or two of
    its neighbours, where the two packages' roundings order near-ties
    differently (a stand-in for trained heads, as `sharpen`)."""
    return jax_two_stage("faster_rcnn", seed, rpn_cls_std, fc_cls_std, **overrides)


# GeneralizedAttention's leaves that its initialisers set to zero (the
# block is then the identity and a test of it checks nothing): the draw
# makes them N(0, 0.5) (key_bias, geom_bias) and U(0.5, 1) (gamma)
ATTENTION_LEAVES = ("key_bias", "geom_bias", "gamma")


def jax_two_stage(family, seed=0, rpn_cls_std=3.0, fc_cls_std=1.5, **overrides):
    """jax_faster_rcnn's draw for the tiny config of any ported two-stage
    family of the JAX registry (its model: Faster R-CNN's for
    dynamic_rcnn and the Faster R-CNN variants, the cascade's three
    heads, the double head with its BN), every fc_cls sharpened alike,
    every attention block's gamma and biases non-zero (ATTENTION_LEAVES)."""
    model, shapes = _two_stage_tree(family, tuple(sorted(overrides.items())))
    rng = np.random.RandomState(seed)

    def draw(path, leaf):
        keys = [getattr(k, "key", str(k)) for k in path]
        shape, name = leaf.shape, keys[-1]
        if name == "kernel":
            std = float(np.prod(shape[:-1])) ** -0.5
            if "rpn_cls" in keys or "s1_cls" in keys:
                std *= rpn_cls_std
            elif "fc_cls" in keys:
                std *= fc_cls_std
            elif "fc_reg" in keys:
                std *= 0.1
            return (rng.randn(*shape) * std).astype(np.float32)
        if name in ("scale", "var"):
            return rng.uniform(0.7, 1.3, shape).astype(np.float32)
        if name == "mean" or name == "bias":
            return (rng.randn(*shape) * 0.05).astype(np.float32)
        if name == "gamma":
            return rng.uniform(0.5, 1.0, shape).astype(np.float32)
        if name in ATTENTION_LEAVES:
            return (rng.randn(*shape) * 0.5).astype(np.float32)
        return np.zeros(shape, np.float32)

    return model, jax.tree_util.tree_map_with_path(draw, shapes)


@functools.lru_cache(maxsize=None)
def two_stage_pair(family):
    """(Flax model, variables, the port's model carrying them) of the
    family's tiny config: one jax_two_stage draw, shared by a test file."""
    from aod_meh_hua_torch.api import load_weights
    from aod_meh_hua_torch.models.convert import from_jax_variables
    from aod_meh_hua_torch.models.two_stage import build_two_stage
    from aod_meh_hua_torch.utils.config import ZOO_FAMILIES

    jmodel, variables = jax_two_stage(family)
    model = build_two_stage(ZOO_FAMILIES[family][1](), device="cpu")
    load_weights(model, from_jax_variables(variables))
    return jmodel, variables, model


def two_stage_batch(cfg, seed=0, b=2, max_boxes=3, labels_up_to=None):
    """A train_batch for the two-stage tiny canvas (64 x 128): boxes of
    10-40 pixels inside each image's shape (the second image cut short),
    labels below `labels_up_to` (cfg.num_classes by default)."""
    rng = np.random.RandomState(seed)
    h, w = cfg.canvas
    images = rng.randn(b, h, w, 3).astype(np.float32) * 0.5
    g = cfg.max_gt
    gt_boxes = np.zeros((b, g, 4), np.float32)
    gt_labels = np.zeros((b, g), np.int32)
    gt_valid = np.zeros((b, g), bool)
    shapes = np.tile([[h, w]], (b, 1)).astype(np.int32)
    shapes[1:] = [h - 8, w - 24]
    for i in range(b):
        for j in range(rng.randint(1, max_boxes + 1)):
            bw, bh = rng.uniform(10, 40), rng.uniform(10, 40)
            x1 = rng.uniform(0, shapes[i, 1] - bw)
            y1 = rng.uniform(0, shapes[i, 0] - bh)
            gt_boxes[i, j] = [x1, y1, x1 + bw, y1 + bh]
            gt_labels[i, j] = rng.randint(0, labels_up_to or cfg.num_classes)
            gt_valid[i, j] = True
    av = anchor_valid_flags(cfg.build_anchor_generator(), cfg.featmap_sizes(), shapes)
    return images, gt_boxes, gt_labels, gt_valid, av, shapes


def jax_sampler_draws(key, n, k):
    """The k uniforms [n] a JAX sampler draws from `key`: one per key of
    split(key, k), in order (random_sample_pos_neg's kp, kn; Libra's
    kp1, kp2, kp3, kp4, kn1, kn2, km)."""
    return [np.asarray(jax.random.uniform(kk, (n,))) for kk in jax.random.split(key, k)]


def jax_step_uniforms(key, b, n_anchor, n_roi, roi_draws=2):
    """A port `uniforms(stage, n, k)` source holding the draws of the JAX
    Faster R-CNN step's key tree under `key`: k_rpn, k_roi = split(key),
    split(k, B) per image, then the sampler's own split (2 draws for the
    RPN, roi_draws for the RoI sampler)."""
    k_rpn, k_roi = jax.random.split(key)
    out = {}
    for stage, k, n, m in (("rpn", k_rpn, n_anchor, 2), ("roi", k_roi, n_roi, roi_draws)):
        draws = [jax_sampler_draws(kk, n, m) for kk in jax.random.split(k, b)]
        out[stage] = tuple(torch.from_numpy(np.stack([d[i] for d in draws])) for i in range(m))

    def uniforms(stage, n, k):
        assert out[stage][0].shape[1] == n and len(out[stage]) == k, (stage, n, k)
        return out[stage]

    return uniforms


def jax_family_uniforms(family, key, cfg, b):
    """A port `uniforms(stage, n, k)` source holding the draws of the JAX
    train step of a proposal family under `key` (engine/two_stage.py
    step_draws names the stages):
    - rpn, cascade_rpn: split(key, B) per image, (kp, kn) in the sampler;
    - fast_rcnn: the same for the RoI sampler;
    - tridentnet: k_rpn, k_roi = split(key), each split into the R * B
      branch-major rows (row r * B + i), branch r's rows for "rpn{r}" and
      "roi{r}";
    - grid_rcnn: k_rpn, k_roi, k_jit = split(key, 3), each split per
      image; the jitter the [S, 4] uniform of each image's key, flattened."""
    from aod_meh_hua_torch.engine.two_stage import step_draws

    sizes = step_draws(cfg)

    def per_row(k, rows, n, m):
        draws = [jax_sampler_draws(kk, n, m) for kk in jax.random.split(k, rows)]
        return tuple(torch.from_numpy(np.stack([d[i] for d in draws])) for i in range(m))

    out = {}
    if family in ("rpn", "cascade_rpn", "fast_rcnn"):
        (stage, (n, m)), = sizes.items()
        out[stage] = per_row(key, b, n, m)
    elif family == "tridentnet":
        r = len(cfg.trident_dilations)
        for stage, k in zip(("rpn", "roi"), jax.random.split(key)):
            n = sizes[f"{stage}0"][0]
            rows = per_row(k, r * b, n, 2)
            for j in range(r):
                out[f"{stage}{j}"] = tuple(u[j * b:(j + 1) * b] for u in rows)
    elif family == "grid_rcnn":
        k_rpn, k_roi, k_jit = jax.random.split(key, 3)
        out["rpn"] = per_row(k_rpn, b, *sizes["rpn"])
        out["roi"] = per_row(k_roi, b, *sizes["roi"])
        s = sizes["jitter"][0] // 4
        out["jitter"] = (torch.from_numpy(np.stack([
            np.asarray(jax.random.uniform(kk, (s, 4))).reshape(-1)
            for kk in jax.random.split(k_jit, b)])),)
    else:
        raise ValueError(family)

    def uniforms(stage, n, k):
        assert out[stage][0].shape[1] == n and len(out[stage]) == k, (stage, n, k)
        return out[stage]

    return uniforms


def proposal_batch(cfg, seed=0, b=2):
    """A Fast R-CNN ProposalBatch of numpy arrays: two_stage_batch's images
    and gts with proposals in cfg.num_proposals slots, each valid gt with
    four jittered copies of it first, then random boxes inside the image,
    the last 4 slots of the second image invalid."""
    images, gt_boxes, gt_labels, gt_valid, _, shapes = two_stage_batch(cfg, seed, b)
    rng = np.random.RandomState(seed + 100)
    p = cfg.num_proposals
    props = np.zeros((b, p, 4), np.float32)
    for i in range(b):
        h, w = shapes[i]
        rows = [g + rng.randn(4) * 2.0 for g in gt_boxes[i][gt_valid[i]] for _ in range(4)]
        while len(rows) < p:
            bw, bh = rng.uniform(6, 40), rng.uniform(6, 40)
            x1, y1 = rng.uniform(0, w - bw), rng.uniform(0, h - bh)
            rows.append([x1, y1, x1 + bw, y1 + bh])
        props[i] = np.asarray(rows[:p], np.float32)
        props[i, :, 0::2] = np.clip(props[i, :, 0::2], 0, w)
        props[i, :, 1::2] = np.clip(props[i, :, 1::2], 0, h)
    valid = np.ones((b, p), bool)
    valid[1, -4:] = False
    return images, gt_boxes, gt_labels, gt_valid, shapes, props, valid
