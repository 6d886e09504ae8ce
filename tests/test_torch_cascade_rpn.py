"""Cascade RPN (aod_meh_hua_torch: ops/assigner.py region_assign,
ops/losses.py iou_loss, models/deform.py, models/cascade_rpn.py,
engine/cascade_rpn.py) against the JAX package's, on the CPU, f32; the
train steps in tests/test_torch_cascade_rpn_steps.py.

The region assigner is also held to the JAX tests' numpy transcription of
the reference's sequential loop (tests/test_cascade_rpn.py
_region_assign_reference). bilinear_zero is the JAX package's
four-corner zero-padded gather, tested at positions outside the map, on
its edges and exactly on integers. The models share one JAX variables
draw of the tiny config (tests/torch_parity.py jax_two_stage, s1_cls
sharpened); the stage-1 sampler runs on JAX's draws (one key per image,
(kp, kn)).

Tolerances: the assignments, the sampled anchors and the proposals'
slots equal; the gathers, offsets and losses rtol 1e-6 (atol 1e-6); the
forwards within 1e-4 of each output's max-abs; the eval's scores and
boxes rtol 1e-4 (boxes atol 1e-4 px) and AR@100 equal. The forward of
the whole model: tests/test_torch_cascade_rpn_steps.py.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aod_meh_hua_tpu.engine import EvalBatch as JEvalBatch
from aod_meh_hua_tpu.engine import cascade_rpn as jcrpn
from aod_meh_hua_tpu.engine import rpn_only as jrpn
from aod_meh_hua_tpu.models import cascade_rpn as jmodels
from aod_meh_hua_tpu.models import deform as jdeform
from aod_meh_hua_tpu.ops import assigner as jassigner
from aod_meh_hua_tpu.ops import losses as jlosses
from aod_meh_hua_tpu.utils import config as jcfg
from aod_meh_hua_torch.engine import cascade_rpn as tcrpn
from aod_meh_hua_torch.engine import rpn_only as trpn
from aod_meh_hua_torch.engine import two_stage as tts
from aod_meh_hua_torch.engine.batch import EvalBatch as TEvalBatch
from aod_meh_hua_torch.models import cascade_rpn as tmodels
from aod_meh_hua_torch.models import deform as tdeform
from aod_meh_hua_torch.models.convert import from_jax_variables
from aod_meh_hua_torch.ops import assigner as tassigner
from aod_meh_hua_torch.ops import losses as tlosses
from aod_meh_hua_torch.utils import config as tcfg
from test_cascade_rpn import _region_assign_reference
from test_torch_rpn_fast_rcnn import _eval_batch, dets_match
from torch_parity import jax_sampler_draws, jax_two_stage, two_stage_batch
from torch_proposal_parity import max_abs_rel, port_model
from torch_parity import few_threads  # noqa: F401 (the fixture of pytestmark)

pytestmark = pytest.mark.usefixtures("few_threads")

TC, JC = tcfg.tiny_cascade_rpn_config(), jcfg.tiny_cascade_rpn_config()


def _t(a):
    return torch.from_numpy(np.array(a))


def test_region_assign_matches_the_reference_and_jax():
    """Eight images of 1-5 gts (small to larger than the coarsest level),
    batched in the port, each held to the reference transcription with
    every anchor valid, and to JAX's function with a pad region invalid."""
    anchors, lvl, strides, feat_wh = tcrpn.anchor_tables(TC)
    janchors, jlvl, jstrides, jfeat_wh = jcrpn._anchor_tables(JC)
    np.testing.assert_array_equal(anchors, janchors)
    np.testing.assert_array_equal(lvl, jlvl)
    np.testing.assert_array_equal(strides, jstrides)
    np.testing.assert_array_equal(feat_wh, jfeat_wh)
    sizes = TC.featmap_sizes()
    anchors_lvl = TC.build_anchor_generator().grid_anchors(sizes)
    rng = np.random.RandomState(7)
    gts = np.zeros((8, TC.max_gt, 4), np.float32)
    gv = np.zeros((8, TC.max_gt), bool)
    for t in range(8):
        g = rng.randint(1, 6)
        x1, y1 = rng.uniform(0, 90, g), rng.uniform(0, 40, g)
        w, h = rng.uniform(4, 120, g), rng.uniform(4, 60, g)
        gts[t, :g] = np.stack([x1, y1, x1 + w, y1 + h], axis=1)
        gv[t, :g] = True
    av = np.ones((8, len(anchors)), bool)
    av[4:, ::7] = False

    def port(valid):
        return tassigner.region_assign(
            _t(anchors), _t(gts), _t(gv), _t(valid), _t(lvl), _t(strides), _t(feat_wh),
            float(TC.rpn.anchor_scale), float(TC.rpn.anchor_strides[0]), len(sizes)).numpy()

    everywhere = port(np.ones_like(av))
    got = port(av)
    for t in range(8):
        want = _region_assign_reference(anchors_lvl, sizes, TC.rpn.anchor_strides,
                                        gts[t][gv[t]], TC.rpn.anchor_scale)
        np.testing.assert_array_equal(everywhere[t], want, err_msg=f"image {t}")
        jgot = jassigner.region_assign(
            jnp.asarray(janchors), jnp.asarray(gts[t]), jnp.asarray(gv[t]), jnp.asarray(av[t]),
            jnp.asarray(jlvl), jnp.asarray(jstrides), jnp.asarray(jfeat_wh),
            float(JC.rpn.anchor_scale), float(JC.rpn.anchor_strides[0]), len(sizes))
        np.testing.assert_array_equal(got[t], np.asarray(jgot), err_msg=f"image {t}")
    assert (got > 0).sum() > 10 and (got == -1).sum() > (everywhere == -1).sum()


@pytest.mark.parametrize("linear", [True, False])
def test_iou_loss_matches_jax(linear):
    """Aligned pairs: overlapping, disjoint (IoU clipped at eps), one
    degenerate box, identical."""
    rng = np.random.RandomState(0)
    xy = rng.uniform(0, 50, (40, 2))
    pred = np.concatenate([xy, xy + rng.uniform(1, 30, (40, 2))], 1).astype(np.float32)
    tgt = (pred + rng.randn(40, 4) * 8).astype(np.float32)
    tgt[0] = pred[0] + 100
    tgt[1, 2:] = tgt[1, :2]
    tgt[2] = pred[2]
    got = tlosses.iou_loss(_t(pred), _t(tgt), linear=linear, reduction="none").numpy()
    want = np.asarray(jlosses.iou_loss(jnp.asarray(pred), jnp.asarray(tgt), linear=linear,
                                       reduction="none"))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    w = rng.uniform(0, 1, 40).astype(np.float32)
    np.testing.assert_allclose(
        float(tlosses.iou_loss(_t(pred), _t(tgt), _t(w), linear=linear, avg_factor=7.0)),
        float(jlosses.iou_loss(jnp.asarray(pred), jnp.asarray(tgt), jnp.asarray(w),
                               linear=linear, avg_factor=7.0)), rtol=1e-6)


def test_bilinear_zero_matches_jax():
    """Positions outside the map (a corner in, a corner out, all out),
    on its edges and exactly on integers; batched in the port."""
    rng = np.random.RandomState(0)
    feat = rng.randn(2, 5, 7, 3).astype(np.float32)
    ys = np.concatenate([rng.uniform(-2, 7, 40), [0, 1, 4, 4, -1, 5, -0.5, 4.5, 2, -3]])
    xs = np.concatenate([rng.uniform(-2, 9, 40), [0, 6, 3, 6.5, 2, 1, -0.25, 2, 7, 0]])
    ys, xs = np.stack([ys, ys[::-1]]).astype(np.float32), np.stack([xs, xs[::-1]]).astype(
        np.float32)
    got = tdeform.bilinear_zero(_t(feat), _t(ys), _t(xs)).numpy()
    for i in range(2):
        want = np.asarray(jdeform.bilinear_zero(jnp.asarray(feat[i]), jnp.asarray(ys[i]),
                                                jnp.asarray(xs[i])))
        np.testing.assert_allclose(got[i], want, rtol=1e-6, atol=1e-6)
    # on an integer inside the map: the map's value; past the border: zero
    np.testing.assert_array_equal(got[0, 40], feat[0, 0, 0])
    np.testing.assert_array_equal(got[0, 42], feat[0, 4, 3])
    assert not got[0, 48].any() and not got[0, 49].any()


def test_anchor_offsets_match_jax():
    """Refined anchors of every level, off the grid and of any extent."""
    rng = np.random.RandomState(1)
    anchors = tcrpn.anchor_tables(TC)[0]
    a = np.stack([anchors + rng.randn(*anchors.shape) * 3 for _ in range(2)]).astype(np.float32)
    a[..., 2:] = np.maximum(a[..., 2:], a[..., :2] + 1)
    bounds, sizes, strides = TC.level_bounds(), TC.featmap_sizes(), TC.rpn.anchor_strides
    got = tcrpn.anchor_offsets(_t(a), bounds, sizes, strides)
    want = jcrpn.anchor_offsets(jnp.asarray(a), bounds, sizes, strides)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-6)


def test_deform_conv_matches_jax():
    """DeformConv3x3Explicit: nine gathers at grid + tap + offset, each
    times its tap's kernel, with offsets that reach outside the map."""
    rng = np.random.RandomState(2)
    x = rng.randn(2, 6, 9, 5).astype(np.float32)
    off = (rng.randn(2, 6, 9, 18) * 1.5).astype(np.float32)
    jconv = jmodels.DeformConv3x3Explicit(4)
    variables = jconv.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(off))
    want = jconv.apply(variables, jnp.asarray(x), jnp.asarray(off))
    conv = tmodels.DeformConv3x3Explicit(5, 4)
    conv.load_state_dict({"weight": from_jax_variables(variables)["weight"]})
    with torch.no_grad():
        got = conv(_t(x).permute(0, 3, 1, 2), _t(off)).permute(0, 2, 3, 1)
    assert max_abs_rel(got, want) < 1e-5


def test_stage1_sampler_matches_jax():
    """The stage-1 targets (max-IoU on each image's refined anchors, the
    random sampler on JAX's (kp, kn) draws): the sampled anchors, their
    positives and matched gts equal, index for index."""
    arrays = two_stage_batch(JC, seed=1, max_boxes=6)
    _, gtb, _, gtv, av, _ = arrays
    rng = np.random.RandomState(4)
    anchors = tcrpn.anchor_tables(TC)[0]
    a1 = np.stack([anchors + rng.randn(*anchors.shape) * 2 for _ in range(2)]).astype(
        np.float32)
    a1[..., 2:] = np.maximum(a1[..., 2:], a1[..., :2] + 1)
    keys = jax.random.split(jax.random.PRNGKey(9), 2)
    want = jax.jit(jax.vmap(lambda k, a, v, g, gv: jcrpn._stage1_targets_single(
        k, a, v, g, gv, JC.rpn)))(keys, jnp.asarray(a1), jnp.asarray(av), jnp.asarray(gtb),
                                 jnp.asarray(gtv))
    draws = [jax_sampler_draws(k, a1.shape[1], 2) for k in keys]
    u = [_t(np.stack([d[j] for d in draws])) for j in range(2)]
    got = tcrpn.stage1_targets(*u, _t(a1), _t(av), _t(gtb), _t(gtv), TC.rpn)
    np.testing.assert_array_equal(got.is_pos.numpy(), np.asarray(want.is_pos))
    np.testing.assert_array_equal(got.weights.numpy(), np.asarray(want.weights))
    np.testing.assert_array_equal(got.num_samples.numpy(), np.asarray(want.num_samples))
    pos = got.is_pos.numpy()
    np.testing.assert_array_equal(got.gt_box.numpy()[pos], np.asarray(want.gt_box)[pos])
    assert pos.sum() > 0 and (got.weights.numpy() > 0).sum(1).min() == TC.rpn.sampler_num


@functools.lru_cache(maxsize=None)
def _jax_eval(jmodel):
    """One JAX eval step (one compile) for both cases."""
    return jcrpn.make_crpn_eval_step(jmodel, JC)


@pytest.mark.parametrize("tied", [False, True])
def test_eval_and_recall_match_jax(tied):
    """The eval of four images with their own scale factors (per-level
    top-k, the stage-1 decode, the level-grouped NMS at 0.8) as a
    one-class ProposalResult, and AR@100; `tied`: s1_cls's weight zero,
    so that every objectness of a level ties and the top-k and the NMS
    order keep the lowest indices in both packages."""
    jmodel, variables = jax_two_stage("cascade_rpn")
    if tied:
        params = dict(variables["params"])
        params["s1_cls"] = {**params["s1_cls"],
                            "kernel": np.zeros_like(params["s1_cls"]["kernel"])}
        variables = {**variables, "params": params}
    batch = _eval_batch(JC)
    want = _jax_eval(jmodel)(variables, JEvalBatch(*(jnp.asarray(a) for a in batch)))
    got = tts.make_two_stage_eval_step(port_model("cascade_rpn", variables), TC, "cpu")(
        TEvalBatch(*batch))
    assert type(got) is trpn.ProposalResult
    dets_match(got, want, 4 * 20)
    if tied:
        assert (got.scores.numpy()[got.valid.numpy()] == got.scores[0, 0].item()).all()
    gts = [np.asarray(want.boxes[i][:5]) + 3.0 for i in range(4)]
    boxes, valid = [b.numpy() for b in got.boxes], [v.numpy() for v in got.valid]
    assert trpn.proposal_recall(boxes, valid, gts) == jrpn.proposal_recall(boxes, valid, gts) > 0
