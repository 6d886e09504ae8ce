"""The port's MEH-SSD300 against the JAX package's, on the CPU: the config
and anchors (aod_meh_hua_torch/utils/config.py SSDConfig, ops/anchors.py
SSDAnchorGenerator), the model (models/vgg.py, ssd_neck.py, ssd_head.py,
ssd_detector.py, carried over by models/convert.py), the loss
(ops/losses.py softmax_cross_entropy, engine/train.py make_ssd_loss_fn)
and the softmax family of the score and eval steps, at the thin SSD of
the JAX SSD CLI's --mini (width 1/8, the real 300 geometry: 8732
anchors, 21 columns), with TF32 pinned off. Inputs are seeded numpy;
the weights are one seeded draw (tests/torch_parity.py jax_ssd).

Tolerances: configs, anchors and valid flags are copies and must be
equal; forward outputs agree to 1e-4 of their scale (f32 convolutions
summed in another order); each loss term to rtol 1e-4, and the OHEM
selection must be the same set (ties go to the lower anchor, as the
JAX package's stable argsort gives them); two SGD steps leave every
parameter within 1e-4 of its tensor's max-abs; pool scores rtol 1e-4
with the same exact-zero set, NMS survivors identical and the eval mAP
bit-equal. The 8732-anchor oracle test mirrors
tests/test_acquisition_oracle_ssd.py against the float64 transcription
of the reference chain (tests/reference_oracle.py score_image_ssd), with
its tolerances, on a pool of ORACLE_POOL images.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aod_meh_hua_tpu.engine.batch import Batch as JBatch
from aod_meh_hua_tpu.engine.batch import EvalBatch as JEvalBatch
from aod_meh_hua_tpu.engine.eval import detections_to_per_class as jper_class
from aod_meh_hua_tpu.engine.eval import make_eval_step as jmake_eval_step
from aod_meh_hua_tpu.engine.score import make_score_step as jmake_score_step
from aod_meh_hua_tpu.engine.train import create_train_state as jcreate_train_state
from aod_meh_hua_tpu.engine.train import make_ssd_loss_fn as jmake_ssd_loss_fn
from aod_meh_hua_tpu.engine.train import make_train_step as jmake_train_step
from aod_meh_hua_tpu.models.ssd_neck import L2Norm as JL2Norm
from aod_meh_hua_tpu.ops import anchor_valid_flags as janchor_valid_flags
from aod_meh_hua_tpu.ops import anchors as janchors
from aod_meh_hua_tpu.ops.losses import softmax_cross_entropy as jce
from aod_meh_hua_tpu.utils import config as jcfg
from aod_meh_hua_torch.data.splits import update_labeled_set
from aod_meh_hua_torch.engine.batch import Batch, EvalBatch
from aod_meh_hua_torch.engine.eval import detections_to_per_class, make_eval_step
from aod_meh_hua_torch.engine.postprocess import make_candidate_selector
from aod_meh_hua_torch.engine.score import (make_nms_output_core, make_output_scorer,
                                            make_score_step)
from aod_meh_hua_torch.engine.train import (_targets, create_train_state, make_ssd_loss_fn,
                                            make_train_step, ohem_negatives)
from aod_meh_hua_torch.models.convert import from_jax_variables
from aod_meh_hua_torch.models.ssd_detector import build_ssd
from aod_meh_hua_torch.models.ssd_neck import L2Norm
from aod_meh_hua_torch.models.vgg import MMCV_VGG16_CONV_IDX
from aod_meh_hua_torch.ops import anchors as tanchors
from aod_meh_hua_torch.ops.losses import softmax_cross_entropy as tce
from aod_meh_hua_torch.utils import config as tcfg
from aod_meh_hua_torch.utils.voc_eval import eval_map

import reference_oracle as oracle
from test_acquisition_oracle_ssd import _gen_image
from torch_parity import THIN_SSD, jax_ssd, tf32_off, train_batch
from torch_parity import few_threads  # noqa: F401 (the fixture of pytestmark)

pytestmark = pytest.mark.usefixtures("few_threads")


@pytest.fixture(autouse=True, scope="module")
def _tf32_off():
    with tf32_off():
        yield


ORACLE_POOL = 128
SSD512 = dict(input_size=512, anchor_kw=dict(
    input_size=512, strides=(8, 16, 32, 64, 128, 256, 512),
    ratios=((2,), (2, 3), (2, 3), (2, 3), (2, 3), (2,), (2,)), basesize_ratio_range=(0.1, 0.9)))


def _cfgs(size=300, **kw):
    """(JAX SSDConfig, port SSDConfig) at input 300 or 512."""
    if size == 512:
        kw = dict(kw, input_size=512)
        return tuple(m.SSDConfig(anchor=m.SSDAnchorCfg(**SSD512["anchor_kw"]), **kw)
                     for m in (jcfg, tcfg))
    return jcfg.SSDConfig(**kw), tcfg.SSDConfig(**kw)


def _port(variables):
    model = build_ssd(tcfg.SSDConfig(**THIN_SSD), device="cpu")
    model.load_state_dict(from_jax_variables(variables))
    return model


def _canvases(n, seed=0):
    """n seeded uint8 300x300 canvases: 30-pixel cells of random colour
    plus noise, with scale factors of 500x375 and 375x500 originals."""
    rng = np.random.RandomState(seed)
    coarse = rng.randint(0, 256, (n, 10, 10, 3)).astype(np.uint8)
    imgs = coarse.repeat(30, axis=1).repeat(30, axis=2).astype(np.int16)
    imgs = np.clip(imgs + rng.randint(-20, 21, imgs.shape), 0, 255).astype(np.uint8)
    shapes = np.full((n, 2), 300, np.int32)
    sfs = np.array([[0.6, 0.8, 0.6, 0.8] if i % 2 else [0.8, 0.6, 0.8, 0.6]
                    for i in range(n)], np.float32)
    return imgs, shapes, sfs


# --- config and anchors --------------------------------------------------

@pytest.mark.parametrize("size", [300, 512])
def test_ssd_config_bounds_equal(size):
    j, t = _cfgs(size)
    assert j.canvas == t.canvas == (size, size)
    assert j.featmap_sizes() == t.featmap_sizes()
    assert j.level_bounds() == t.level_bounds()
    assert j.topk_level_bounds() == t.topk_level_bounds()
    assert j.cls_out_channels == t.cls_out_channels == 21
    assert t.family == "ssd" and t.for_orientation("portrait") is t


@pytest.mark.parametrize("size", [300, 512])
def test_ssd_anchors_and_valid_flags_exact(size):
    """The anchors and the valid flags bit for bit; (4, 6, 6, 6, 4, 4)
    anchors per level and 8732 in all at input 300."""
    j, t = _cfgs(size)
    jg, tg = j.build_anchor_generator(), t.build_anchor_generator()
    assert jg.num_base_anchors == tg.num_base_anchors
    assert jg.base_sizes == tg.base_sizes
    for a, b in zip(jg.base_anchors, tg.base_anchors):
        np.testing.assert_array_equal(a, b)
    ja, ta = jg.grid_anchors(j.featmap_sizes()), tg.grid_anchors(t.featmap_sizes())
    for a, b in zip(ja, ta):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    if size == 300:
        assert tg.num_base_anchors == [4, 6, 6, 6, 4, 4]
        assert sum(len(a) for a in ta) == 8732 == t.level_bounds()[-1][1]
    pads = np.array([[size, size], [320, 320], [200, 256]], np.int32)
    np.testing.assert_array_equal(
        tanchors.anchor_valid_flags(tg, t.featmap_sizes(), pads),
        janchor_valid_flags(jg, j.featmap_sizes(), pads))


def test_ssd_anchor_generator_refuses_what_jax_refuses():
    for kw in (dict(input_size=400), dict(basesize_ratio_range=(0.3, 0.9))):
        with pytest.raises(ValueError):
            janchors.SSDAnchorGenerator(**kw)
        with pytest.raises(ValueError):
            tanchors.SSDAnchorGenerator(**kw)


# --- the model -------------------------------------------------------------

def test_vgg_layout_and_ceil_pool():
    """mmcv's layout: convs at features.{0, 2, 5, ..., 31, 33}; the ceil
    pools take 75 to 38, so a 300 input gives conv4_3 at 38x38 and conv7
    at 19x19; the state_dict names are mmdet's."""
    model = build_ssd(tcfg.SSDConfig(**THIN_SSD), device="cpu")
    convs = [i for i, m in enumerate(model.backbone.features) if isinstance(m, torch.nn.Conv2d)]
    assert tuple(convs) == MMCV_VGG16_CONV_IDX
    with torch.no_grad():
        c43, c7 = model.backbone(torch.zeros(1, 3, 300, 300))
    assert c43.shape[-2:] == (38, 38) and c7.shape[-2:] == (19, 19)
    assert torch.nn.functional.max_pool2d(torch.zeros(1, 1, 75, 75), 2, 2,
                                          ceil_mode=True).shape[-1] == 38
    keys = set(model.state_dict())
    assert {"neck.l2_norm.weight", "neck.extra_layers.3.1.conv.weight",
            "bbox_head.L_convs.5.0.bias", "backbone.features.33.weight"} <= keys


def test_l2norm_matches_jax():
    """The norm over channels (dim 1 in NCHW), eps after the sqrt; a
    vector near zero is lifted to the scale's norm in both."""
    rng = np.random.RandomState(0)
    x = rng.randn(2, 6, 5, 7).astype(np.float32)
    x[0, :, 0, 0] = 1e-6
    x[1, :, 1, 1] = 0.0
    scale = rng.uniform(15, 25, 6).astype(np.float32)
    want = JL2Norm().apply({"params": {"scale": jnp.asarray(scale)}},
                           jnp.asarray(x.transpose(0, 2, 3, 1)))
    m = L2Norm(6)
    with torch.no_grad():
        m.weight.copy_(torch.from_numpy(scale))
        got = m(torch.from_numpy(x)).numpy().transpose(0, 2, 3, 1)
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-6, atol=1e-6)
    assert np.abs(got[0, 0, 0]).sum() > 10


def test_ssd_head_and_init():
    """Xavier-uniform head with zero biases, L2Norm at 20; per level the
    cls conv has A * 21 channels, reg A * 4, L A."""
    model = build_ssd(tcfg.SSDConfig(**THIN_SSD), device="cpu", seed=3)
    assert torch.equal(model.neck.l2_norm.weight, torch.full_like(model.neck.l2_norm.weight, 20))
    for lvl, a in enumerate([4, 6, 6, 6, 4, 4]):
        for branch, per in (("cls_convs", 21), ("reg_convs", 4), ("L_convs", 1)):
            conv = getattr(model.bbox_head, branch)[lvl][0]
            assert conv.out_channels == a * per
            fan_in, fan_out = conv.weight[0].numel(), conv.out_channels * 9
            assert conv.weight.abs().max() <= (6 / (fan_in + fan_out)) ** 0.5
            assert not conv.bias.any()


@pytest.mark.parametrize("with_meh", [True, False])
def test_ssd_forward_matches_jax(with_meh):
    """(cls [B, 8732, 21], reg [B, 8732, 4], lambda [B, 8732]) to 1e-4 of
    each output's scale; the lambda branch reads detached features."""
    jm, v = jax_ssd(seed=1)
    rng = np.random.RandomState(2)
    x = (rng.randn(2, 300, 300, 3) * 60).astype(np.float32)
    want = jax.jit(jm.apply, static_argnames="with_meh")(v, jnp.asarray(x), with_meh=with_meh)
    model = _port(v)
    got = model(torch.from_numpy(x), with_meh=with_meh)
    assert got[0].shape == (2, 8732, 21) and got[1].shape == (2, 8732, 4)
    for w, g in zip(want[:2], got[:2]):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), rtol=0,
                                   atol=1e-4 * np.abs(np.asarray(w)).max())
    if not with_meh:
        assert want[2] is None and got[2] is None
        return
    w = np.asarray(want[2])
    np.testing.assert_allclose(got[2].detach().numpy(), w, rtol=0, atol=1e-4 * np.abs(w).max())
    got[2].sum().backward()
    trunk = [p for n, p in model.named_parameters() if not n.startswith("bbox_head.L_convs")]
    assert all(p.grad is None for p in trunk)


# --- the loss --------------------------------------------------------------

def test_softmax_cross_entropy_matches_jax():
    """Per anchor with integer labels over C+1 columns; labels outside
    [0, C] clamp into it (jnp's mode="clip")."""
    rng = np.random.RandomState(0)
    logits = (rng.randn(3, 50, 21) * 3).astype(np.float32)
    labels = rng.randint(0, 21, (3, 50))
    labels[0, :3] = [25, 21, -2]
    w = rng.rand(3, 50).astype(np.float32)
    for kw in (dict(reduction="none"), dict(reduction="mean"), dict(reduction="sum"),
               dict(reduction="mean", avg_factor=7.0)):
        want = jce(jnp.asarray(logits), jnp.asarray(labels), weight=jnp.asarray(w), **kw)
        got = tce(torch.from_numpy(logits), torch.from_numpy(labels), weight=torch.from_numpy(w),
                  **kw)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


def _jax_ohem(ce, pos, neg, ratio):
    """aod_meh_hua_tpu/engine/train.py:245-252's selection, per image."""
    def one(ce_i, pos_i, neg_i):
        num_neg = jnp.minimum(ratio * pos_i.sum(), neg_i.sum())
        masked = jnp.where(neg_i, ce_i, -jnp.inf)
        order = jnp.argsort(-masked)
        rank = jnp.zeros_like(order).at[order].set(jnp.arange(order.shape[0]))
        return neg_i & (rank < num_neg)

    return np.asarray(jax.vmap(one)(jnp.asarray(ce), jnp.asarray(pos), jnp.asarray(neg)))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ohem_selection_matches_jax_with_ties(seed):
    """CE values on a coarse grid, so that many negatives tie at the
    selection's edge: the same set of negatives."""
    rng = np.random.RandomState(seed)
    ce = (rng.randint(0, 6, (3, 400)) * 0.5).astype(np.float32)
    pos = rng.rand(3, 400) < 0.04
    neg = ~pos & (rng.rand(3, 400) < 0.9)
    neg[2] &= rng.rand(400) < 0.05  # fewer negatives than 3 x positives
    want = _jax_ohem(ce, pos, neg, 3)
    got = ohem_negatives(torch.from_numpy(ce), torch.from_numpy(pos), torch.from_numpy(neg),
                         3).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.sum() > 0


def _batches(cfg, seed=0):
    arrs = train_batch(cfg, seed=seed, b=2, max_boxes=3)
    arrs = (arrs[0] * 60,) + arrs[1:]
    return JBatch(*[jnp.asarray(a) for a in arrs]), Batch(*arrs)


def _port_batch(b):
    return Batch(*(torch.from_numpy(np.asarray(a)) for a in b))._replace(
        gt_labels=torch.from_numpy(np.asarray(b.gt_labels)).long())


def test_ssd_loss_terms_and_ohem_selection_match_jax():
    """Each loss term rtol 1e-4 on the same weights and batch, and the
    negatives OHEM keeps are the same set."""
    jm, v = jax_ssd(seed=4)
    j, t = _cfgs(300, **THIN_SSD)
    jb, tb = _batches(j)
    jloss, anchors = jmake_ssd_loss_fn(jm, j)
    _, jaux = jax.jit(jloss)(v["params"], {}, jb, jnp.asarray(anchors))
    model = _port(v)
    tloss, tanch = make_ssd_loss_fn(model, t)
    np.testing.assert_array_equal(anchors, tanch)
    with torch.no_grad():
        _, taux = tloss(_port_batch(tb), torch.from_numpy(tanch))
    for k in ("loss", "loss_cls", "loss_bbox", "loss_meh", "num_pos"):
        np.testing.assert_allclose(float(taux[k]), float(jaux[k]), rtol=1e-4, err_msg=k)

    # the selection, on each side's own CE
    cls, _, _ = jax.jit(jm.apply)(v, jnp.asarray(jb.images))
    from aod_meh_hua_tpu.engine.train import _make_targets_fn
    jt = _make_targets_fn(j)(jnp.asarray(anchors), jb.anchor_valid, jb.gt_boxes, jb.gt_labels,
                             jb.gt_valid)
    jce_ = np.asarray(jce(cls, jt.labels, reduction="none") * jt.label_weights)
    c = j.num_classes
    lab, lw = np.asarray(jt.labels), np.asarray(jt.label_weights)
    want = _jax_ohem(jce_, (lab < c) & (lw > 0), (lab == c) & (lw > 0), 3)
    pb = _port_batch(tb)
    with torch.no_grad():
        tcls = model(pb.images)[0]
        tt = _targets(t, pb, torch.from_numpy(tanch))
        tce_ = tce(tcls, tt.labels, reduction="none") * tt.label_weights
        got = ohem_negatives(tce_, (tt.labels < c) & (tt.label_weights > 0),
                             (tt.labels == c) & (tt.label_weights > 0), 3).numpy()
    np.testing.assert_array_equal(got, want)
    assert 0 < got.sum() < (lab == c).sum()


def test_ssd_two_sgd_steps_match_jax():
    """Two steps of the SSD train step (SGD, nothing frozen) from the same
    weights: losses rtol 1e-4, parameters within 1e-4 of each tensor's
    max-abs."""
    jm, v = jax_ssd(seed=5)
    j, t = _cfgs(300, **THIN_SSD)
    jb, tb = _batches(j, seed=1)
    tcfg_train = tcfg.TrainConfig(lr=0.01)
    state, tx = jcreate_train_state(jm, v, jcfg.TrainConfig(lr=0.01), frozen_stages=0)
    jstep = jmake_train_step(jm, j, tx)
    model = _port(v)
    tstep = make_train_step(model, t, create_train_state(model, tcfg_train, frozen_stages=0),
                            device="cpu")
    for _ in range(2):
        state, jaux = jstep(state, jb)
        taux = tstep(tb)
        for k in ("loss", "loss_cls", "loss_bbox", "loss_meh"):
            np.testing.assert_allclose(float(taux[k]), float(jaux[k]), rtol=1e-4, err_msg=k)
    want = from_jax_variables({"params": jax.tree_util.tree_map(np.asarray, state.params)})
    got = model.state_dict()
    assert set(want) == set(got)
    for k, w in want.items():
        np.testing.assert_allclose(got[k].numpy(), w.numpy(), rtol=0,
                                   atol=1e-4 * float(w.abs().max()), err_msg=k)


# --- scoring and eval --------------------------------------------------------

@pytest.fixture(scope="module")
def shared():
    """The JAX model and variables, the port model carrying them, and four
    canvases. The SSD reads unnormalised pixels (std 1), so its random
    foreground logits already have a std of about 2 and objects pass
    the 0.3 gates; a sharper head would saturate the softmax, where keys
    one ulp apart between the libraries reorder the top-k."""
    jm, v = jax_ssd(seed=6)
    return jm, v, _port(v), _canvases(4, seed=1)


@pytest.mark.parametrize("pool", ["Entropy_NMS", "Entropy_ALL", "Entropy_NoNMS"])
def test_ssd_score_step_matches_jax(shared, pool):
    """The score step in each pool: the same zero set and rtol 1e-4 per
    image (max-confidence too)."""
    jm, v, model, (imgs, shapes, sfs) = shared
    agg = "objectSum_scaleMax_classSum" if pool == "Entropy_NMS" else "scaleAvg_classAvg"
    j, t = (dataclasses.replace(c, hua=dataclasses.replace(c.hua, pool=pool, agg=agg))
            for c in _cfgs(300, **THIN_SSD))
    valid = np.ones(len(imgs), bool)
    ju, jmc = jmake_score_step(jm, j)(v, JEvalBatch(jnp.asarray(imgs), jnp.asarray(shapes),
                                                    jnp.asarray(sfs), jnp.asarray(valid)))
    tu, tmc = make_score_step(model, t, device="cpu")(EvalBatch(imgs, shapes, sfs, valid))
    ju, tu = np.asarray(ju), tu.numpy()
    assert (ju > 0).sum() >= 2, "too few non-zero scores for a real check"
    np.testing.assert_array_equal(tu == 0, ju == 0)
    np.testing.assert_allclose(tu, ju, rtol=1e-4, atol=0)
    np.testing.assert_allclose(tmc.numpy(), np.asarray(jmc), rtol=1e-4, atol=0)


def test_ssd_eval_survivors_and_map_match_jax(shared):
    """The eval step's NMS survivors identical (labels, anchor indices,
    validity; scores and boxes to 1e-5 relative) and the VOC mAP against
    synthetic ground truth bit-equal."""
    jm, v, model, (imgs, shapes, sfs) = shared
    j, t = _cfgs(300, **THIN_SSD)
    valid = np.ones(len(imgs), bool)
    jd = jmake_eval_step(jm, j)(v, JEvalBatch(jnp.asarray(imgs), jnp.asarray(shapes),
                                              jnp.asarray(sfs), jnp.asarray(valid)))
    td = make_eval_step(model, t, device="cpu")(EvalBatch(imgs, shapes, sfs, valid))
    for f in ("labels", "anchor_idx", "valid"):
        np.testing.assert_array_equal(getattr(td, f).numpy(), np.asarray(getattr(jd, f)), f)
    assert td.valid.sum() > 4
    np.testing.assert_allclose(td.scores.numpy(), np.asarray(jd.scores), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(td.boxes.numpy(), np.asarray(jd.boxes), rtol=1e-5, atol=1e-3)
    rng = np.random.RandomState(3)
    gts = []
    for _ in range(len(imgs)):
        k = rng.randint(1, 5)
        xy = rng.uniform(0, 300, (k, 2))
        gts.append({"bboxes": np.concatenate([xy, xy + rng.uniform(30, 200, (k, 2))], 1)
                    .astype(np.float32), "labels": rng.randint(0, 20, k)})
    # detections as their own ground truth too, where every survivor counts
    kept = jper_class(jd, 20)
    gts += [{"bboxes": np.concatenate([a[:, :4] for a in img]),
             "labels": np.concatenate([np.full(len(a), c) for c, a in enumerate(img)])}
            for img in kept]
    want = eval_map(jper_class(jd, 20) * 2, gts)["mAP"]
    got = eval_map(detections_to_per_class(td, 20) * 2, gts)["mAP"]
    assert got == want and want > 0


# --- the 8732-anchor acquisition oracle ------------------------------------------

def _oracle_image(logits, deltas, lams, shape, sf):
    """tests/reference_oracle.py score_image_ssd at SSDConfig()'s settings."""
    cfg = jcfg.SSDConfig()
    anchors = np.concatenate(cfg.build_anchor_generator().grid_anchors(cfg.featmap_sizes()))
    bounds, t, h = cfg.level_bounds(), cfg.test, cfg.hua
    return oracle.score_image_ssd(
        [logits[s0:s1] for s0, s1 in bounds], [deltas[s0:s1] for s0, s1 in bounds],
        [lams[s0:s1] for s0, s1 in bounds], [anchors[s0:s1] for s0, s1 in bounds],
        tuple(shape), sf, nms_pre=t.nms_pre, score_thr=t.score_thr,
        nms_iou_thr=t.nms_iou_thr, max_per_img=t.max_per_img,
        obj_score_thr=h.obj_score_thr, memb_iou_thr=h.memb_iou_thr,
        fg_score_thr=h.fg_score_thr, lambda_eps=h.lambda_eps,
        lambda_scale=h.lambda_scale, agg=h.agg, target_means=cfg.target_means,
        target_stds=cfg.target_stds)


@pytest.fixture(scope="module")
def oracle_pool():
    """The port's make_output_scorer on tests/test_acquisition_oracle_ssd.py's
    synthetic head outputs, and the float64 reference chain on the same."""
    cfg = jcfg.SSDConfig()
    tcfg_ = tcfg.SSDConfig()
    step = make_output_scorer(tcfg_, device="cpu")
    imgs = [_gen_image(i) for i in range(ORACLE_POOL)]
    port_u, port_mc = [], []
    for b0 in range(0, ORACLE_POOL, 16):
        chunk = imgs[b0:b0 + 16]
        u, mc = step(*(np.stack([c[k] for c in chunk]) for k in range(5)))
        port_u.append(u.numpy())
        port_mc.append(mc.numpy())
    ora_u, ora_mc = [], []
    for im in imgs:
        res = _oracle_image(*im)
        ora_u.append(res["unc"])
        ora_mc.append(res["maxconf"])
    return (np.concatenate(port_u), np.concatenate(port_mc), np.asarray(ora_u),
            np.asarray(ora_mc))


def test_ssd_oracle_scores_zero_sets_and_maxconf(oracle_pool):
    """Per-image scores to 5e-3, the same exact-zero set, getMaxConf over
    every column (about the background's probability) to rtol 1e-4, and
    the ranking of the non-zero images (Spearman rho > 0.9999)."""
    pu, pmc, ou, omc = oracle_pool
    assert (ou == 0).sum() > ORACLE_POOL // 8 and (ou > 0).sum() > ORACLE_POOL // 4
    np.testing.assert_array_equal(pu == 0, ou == 0)
    np.testing.assert_allclose(pu, ou, atol=5e-3)
    np.testing.assert_allclose(pmc, omc, rtol=1e-4)
    assert omc.min() > 0.5
    nz = ou > 0
    ra = np.argsort(np.argsort(pu[nz])).astype(np.float64)
    rb = np.argsort(np.argsort(ou[nz])).astype(np.float64)
    ra, rb = ra - ra.mean(), rb - rb.mean()
    assert float((ra * rb).sum() / np.sqrt((ra ** 2).sum() * (rb ** 2).sum())) > 0.9999


def test_ssd_scoring_chain_in_float64_is_the_reference_chain():
    """The port's Entropy_NMS core in float64 equals the float64
    transcription of the reference to 1e-12 on 16 oracle images: the
    SSD composition is semantically exact; what the f32 tests allow is
    rounding (the MI is a difference of large digamma sums)."""
    cfg = tcfg.SSDConfig()
    select, anchors = make_candidate_selector(cfg)
    core = make_nms_output_core(cfg, select)
    imgs = [_gen_image(i) for i in range(16)]
    arrays = [torch.from_numpy(np.stack([im[k] for im in imgs])) for k in range(5)]
    arrays = [a if k == 3 else a.double() for k, a in enumerate(arrays)]
    with torch.no_grad():
        got = core(*arrays, torch.from_numpy(anchors).double())[0].numpy()
    want = [_oracle_image(*im)["unc"] for im in imgs]
    assert (np.asarray(want) > 0).sum() > 4
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


def test_ssd_oracle_selection_parity(oracle_pool):
    """The acquisition at the SSD driver's zeroRate 0.15: the same images
    but for those within f32 noise of the boundary."""
    pu, _, ou, _ = oracle_pool
    x_all, x_s = np.arange(ORACLE_POOL), 8
    sel = update_labeled_set(pu, x_all, np.arange(0), x_s, np.random.RandomState(7), zero_rate=0.15)[0]
    ref = oracle.update_x_l(ou, x_all, np.arange(0), x_s, 0.15, np.random.RandomState(7))
    diff = np.setxor1d(sel, ref)
    if diff.size:
        assert ou[diff].max() - ou[diff].min() <= 5e-3, (diff, ou[diff])
    assert len(np.intersect1d(sel, ref)) >= len(ref) - 2
