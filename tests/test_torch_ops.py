"""The port's ops (aod_meh_hua_torch/ops, utils/config) against the JAX
package's: the same seeded numpy inputs through both, on the CPU.

Tolerances: anchors and configs are copies and must be equal; IoUs
agree to 1e-6 and decoded boxes to 1e-6 of the box extent (both f32,
same formula); NMS survivors, labels and
anchor indices are discrete and must be identical; MI agrees to 2e-6:
it is the difference of two f32 sums of about 3 nats (ulp 2.4e-7) whose
digamma terms differ in their last bits between the two libraries, and
each side is about 1e-6 off the f64 value; HUA scores to rtol 1e-5.
"""

import ast
import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aod_meh_hua_tpu.ops import bbox as jbbox
from aod_meh_hua_tpu.ops import dirichlet as jdir
from aod_meh_hua_tpu.ops import hua as jhua
from aod_meh_hua_tpu.ops import nms as jnms
from aod_meh_hua_tpu.utils import config as jcfg
from aod_meh_hua_torch.ops import bbox as tbbox
from aod_meh_hua_torch.ops import dirichlet as tdir
from aod_meh_hua_torch.ops import hua as thua
from aod_meh_hua_torch.ops import nms as tnms
from aod_meh_hua_torch.utils import config as tcfg
from torch_parity import few_threads  # noqa: F401 (the fixture of pytestmark)

pytestmark = pytest.mark.usefixtures("few_threads")

REPO = Path(__file__).resolve().parents[1]
_jnms = jax.jit(jnms.batched_multiclass_nms, static_argnums=(2, 3, 4, 5))


def _t(a):
    return torch.from_numpy(np.array(a))


def _boxes(rng, n, size=100.0):
    xy = rng.uniform(0, size, (n, 2))
    wh = rng.uniform(2, size / 3, (n, 2))
    return np.concatenate([xy, xy + wh], -1).astype(np.float32)


# --- config and anchors ------------------------------------------------

@pytest.mark.parametrize("name", ["AnchorConfig", "TestCfg", "HUACfg", "RetinaNetConfig",
                                  "TrainConfig", "ALConfig", "SSDAnchorCfg", "SSDConfig"])
def test_config_fields_equal(name):
    j, t = getattr(jcfg, name), getattr(tcfg, name)
    jf = [(f.name, f.default if f.default is not dataclasses.MISSING else f.default_factory())
          for f in dataclasses.fields(j)]
    tf = [(f.name, f.default if f.default is not dataclasses.MISSING else f.default_factory())
          for f in dataclasses.fields(t)]
    assert [n for n, _ in jf] == [n for n, _ in tf]
    for (n, a), (_, b) in zip(jf, tf):
        assert dataclasses.asdict(a) == dataclasses.asdict(b) if dataclasses.is_dataclass(a) \
            else a == b, n


@pytest.mark.parametrize("orientation", ["landscape", "portrait"])
@pytest.mark.parametrize("tiny", [False, True])
def test_config_bounds_equal(orientation, tiny):
    j = (jcfg.tiny_test_config() if tiny else jcfg.RetinaNetConfig()).for_orientation(orientation)
    t = (tcfg.tiny_test_config() if tiny else tcfg.RetinaNetConfig()).for_orientation(orientation)
    assert j.canvas == t.canvas
    assert j.featmap_sizes() == t.featmap_sizes()
    assert j.level_bounds() == t.level_bounds()
    assert j.topk_level_bounds() == t.topk_level_bounds()
    assert j.backbone_channels == t.backbone_channels
    assert j.anchor.num_anchors == t.anchor.num_anchors


@pytest.mark.parametrize("orientation", ["landscape", "portrait"])
def test_anchors_bit_equal(orientation):
    j = jcfg.RetinaNetConfig().for_orientation(orientation)
    t = tcfg.RetinaNetConfig().for_orientation(orientation)
    ja = j.build_anchor_generator().grid_anchors(j.featmap_sizes())
    ta = t.build_anchor_generator().grid_anchors(t.featmap_sizes())
    assert len(ja) == len(ta) == 5
    for a, b in zip(ja, ta):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


# --- boxes ---------------------------------------------------------------

@pytest.mark.parametrize("mode", ["iou", "iof"])
def test_bbox_overlaps(mode):
    rng = np.random.RandomState(0)
    a, b = _boxes(rng, 40), _boxes(rng, 30)
    a[3] = [5, 5, 5, 9]  # degenerate
    want = np.asarray(jbbox.bbox_overlaps(jnp.asarray(a), jnp.asarray(b), mode=mode))
    got = tbbox.bbox_overlaps(_t(a), _t(b), mode=mode).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


def test_bbox_area_and_batched_overlaps():
    rng = np.random.RandomState(1)
    a, b = _boxes(rng, 24).reshape(2, 12, 4), _boxes(rng, 16).reshape(2, 8, 4)
    np.testing.assert_allclose(tbbox.bbox_area(_t(a)).numpy(),
                               np.asarray(jbbox.bbox_area(jnp.asarray(a))), atol=1e-6)
    np.testing.assert_allclose(tbbox.bbox_overlaps(_t(a), _t(b)).numpy(),
                               np.asarray(jbbox.bbox_overlaps(jnp.asarray(a), jnp.asarray(b))),
                               atol=1e-6)


@pytest.mark.parametrize("stds", [(1.0, 1.0, 1.0, 1.0), (0.1, 0.1, 0.2, 0.2)])
def test_delta_decode_per_image_clip(stds):
    rng = np.random.RandomState(2)
    rois = _boxes(rng, 2 * 50, 300.0).reshape(2, 50, 4)
    deltas = (rng.randn(2, 50, 4) * 2.0).astype(np.float32)  # hits the ratio clamp
    shapes = np.array([[200, 300], [300, 150]], np.int32)
    want = jbbox.delta_decode(jnp.asarray(rois), jnp.asarray(deltas), stds=stds,
                              max_shape=jnp.asarray(shapes))
    got = tbbox.delta_decode(_t(rois), _t(deltas), stds=stds, max_shape=_t(shapes))
    # 1e-6 of the 300-pixel extent: exp() differs in its last bits, and
    # x1 = cx - w/2 turns that into an absolute error on the coordinate
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6 * 300, rtol=0)
    unclipped = tbbox.delta_decode(_t(rois), _t(deltas), stds=stds)
    want_u = np.asarray(jbbox.delta_decode(jnp.asarray(rois), jnp.asarray(deltas), stds=stds))
    np.testing.assert_allclose(unclipped.numpy(), want_u,
                               atol=1e-6 * np.abs(want_u).max(), rtol=0)


# --- NMS -------------------------------------------------------------------

def _nms_inputs(seed, b=3, n=120, c=5, ties=True):
    rng = np.random.RandomState(seed)
    centers = _boxes(rng, 8)
    boxes = np.repeat(centers, n // 8 + 1, axis=0)[:n]
    boxes = boxes + rng.randn(n, 4).astype(np.float32) * 3.0
    boxes = np.stack([boxes] * b)
    scores = rng.uniform(0, 1, (b, n, c)).astype(np.float32) ** 3
    if ties:  # many exactly equal scores, as a zeroed pad region gives
        scores[:, ::3] = 0.25
        scores[:, 1::7, 2] = 0.6
    return boxes.astype(np.float32), scores


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("pre_nms_cands,max_out", [(1000, 100), (64, 20)])
def test_multiclass_nms_identical(seed, pre_nms_cands, max_out):
    boxes, scores = _nms_inputs(seed)
    want = _jnms(jnp.asarray(boxes), jnp.asarray(scores), 0.05, 0.5, max_out, pre_nms_cands)
    got = tnms.batched_multiclass_nms(_t(boxes), _t(scores), 0.05, 0.5, max_out, pre_nms_cands)
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    assert got.valid.any()
    np.testing.assert_array_equal(got.labels.numpy(), np.asarray(want.labels))
    np.testing.assert_array_equal(got.anchor_idx.numpy(), np.asarray(want.anchor_idx))
    np.testing.assert_array_equal(got.scores.numpy(), np.asarray(want.scores))
    np.testing.assert_array_equal(got.boxes.numpy(), np.asarray(want.boxes))


def test_multiclass_nms_single_image_and_empty():
    boxes, scores = _nms_inputs(5, b=1)
    want = jnms.multiclass_nms(jnp.asarray(boxes[0]), jnp.asarray(scores[0]), 0.05, 0.5, 30)
    got = tnms.multiclass_nms(_t(boxes[0]), _t(scores[0]), 0.05, 0.5, 30)
    np.testing.assert_array_equal(got.anchor_idx.numpy(), np.asarray(want.anchor_idx))
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    empty = tnms.multiclass_nms(_t(boxes[0]), _t(scores[0] * 0.0), 0.05, 0.5, 30)
    assert not empty.valid.any() and float(empty.scores.abs().sum()) == 0.0


def _chain_inputs(n=40):
    """One class, n boxes in a row, each overlapping the next by IoU > 0.5
    and the one after by less, scores falling along the row: greedy NMS
    keeps every other box, and the suppression chain is n deep."""
    x = np.arange(n, dtype=np.float32) * 3.0
    boxes = np.stack([x, np.zeros(n), x + 10.0, np.full(n, 10.0)], -1).astype(np.float32)
    scores = np.linspace(0.9, 0.1, n, dtype=np.float32)[:, None]
    return boxes[None], scores[None]


def _nms_counting_syncs(monkeypatch, interval, boxes, scores, pre_nms_cands, max_out):
    """batched_multiclass_nms with CHECK_INTERVAL = interval; returns the
    result and the number of convergence checks (host syncs) it made."""
    checks = []
    real = tnms._converged
    monkeypatch.setattr(tnms, "CHECK_INTERVAL", interval)
    monkeypatch.setattr(tnms, "_converged", lambda a, b: checks.append(1) or real(a, b))
    out = tnms.batched_multiclass_nms(_t(boxes), _t(scores), 0.05, 0.5, max_out, pre_nms_cands)
    return out, len(checks)


@pytest.mark.parametrize("case", ["seed0", "seed1", "seed2", "seed5", "chain"])
@pytest.mark.parametrize("pre_nms_cands,max_out", [(1000, 100), (64, 20)])
def test_nms_fixpoint_checked_every_interval(monkeypatch, case, pre_nms_cands, max_out):
    """Checking convergence every CHECK_INTERVAL map applications keeps the
    masks bit-equal to checking after each one (the loop before), with at
    most ceil(depth / interval) + 1 host syncs where that loop made
    depth + 1; the chain case is deeper than one interval."""
    boxes, scores = _chain_inputs() if case == "chain" else _nms_inputs(int(case[4:]))
    every, syncs_every = _nms_counting_syncs(monkeypatch, 1, boxes, scores, pre_nms_cands,
                                             max_out)
    interval = 8
    got, syncs = _nms_counting_syncs(monkeypatch, interval, boxes, scores, pre_nms_cands,
                                     max_out)
    for a, b in zip(got, every):
        assert torch.equal(a, b)
    depth = syncs_every - 1
    assert syncs <= -(-depth // interval) + 1
    if case == "chain":
        kept = min(20, (min(pre_nms_cands, 40) + 1) // 2, max_out)
        assert depth > interval and int(got.valid.sum()) == kept
        assert got.anchor_idx[0, :kept].tolist() == list(range(0, 2 * kept, 2))


# --- Dirichlet MI ------------------------------------------------------

@pytest.mark.parametrize("scale", [0.5, 5.0, 50.0])
def test_dirichlet_closed_form(scale):
    rng = np.random.RandomState(3)
    alpha = (rng.dirichlet(np.ones(20), 64) * scale).astype(np.float32)
    alpha[0, :3] = 0.0  # clamped to eps
    want = jdir.dirichlet_mutual_information(jnp.asarray(alpha))
    got = tdir.dirichlet_mutual_information(_t(alpha))
    for name in ("epistemic", "aleatoric", "total"):
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                                   atol=2e-6, rtol=0, err_msg=name)


# --- HUA -----------------------------------------------------------------

@pytest.mark.parametrize("spec", ["objectSum_scaleMax_classSum", "objectAvg_scaleSum_classMax",
                                  "scaleAvg_classAvg"])
def test_parse_agg_spec(spec):
    assert thua.parse_agg_spec(spec) == jhua.parse_agg_spec(spec)


def test_parse_agg_spec_rejects():
    for bad in ("objectSum_scaleMin_classSum", "objectSum_classSum"):
        with pytest.raises(ValueError):
            thua.parse_agg_spec(bad)


def _hua_inputs(seed, b=4, c=6):
    rng = np.random.RandomState(seed)
    bounds = ((0, 40), (40, 70), (70, 82))
    a = bounds[-1][1]
    logits = rng.randn(b, a, c).astype(np.float32) * 2.0
    scores = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    scores[:, 70:] *= 0.2  # a level with nothing over the FG gate
    scores = scores.astype(np.float32)
    lam = (np.abs(rng.randn(b, a)) + 0.1).astype(np.float32)
    cand_boxes = np.stack([_boxes(rng, a, 60.0) for _ in range(b)])
    det_boxes = cand_boxes[:, :10] + rng.randn(b, 10, 4).astype(np.float32)
    det_scores = rng.uniform(0.1, 0.9, (b, 10)).astype(np.float32)
    det_valid = rng.uniform(size=(b, 10)) > 0.3
    det_valid[-1] = False  # an image with no object: exact zero
    return bounds, scores, lam, cand_boxes, det_boxes, det_scores, det_valid


def test_object_membership_and_lambda_rescale():
    bounds, scores, lam, cb, db, ds, dv = _hua_inputs(4)
    want = jax.vmap(jhua.object_membership)(*map(jnp.asarray, (cb, db, ds, dv)))
    got = thua.object_membership(_t(cb), _t(db), _t(ds), _t(dv))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    m = got.sum(-1).float()
    want_l = jax.vmap(jhua.lambda_rescale)(jnp.asarray(lam), jnp.asarray(m.numpy()))
    np.testing.assert_allclose(thua.lambda_rescale(_t(lam), m).numpy(), np.asarray(want_l),
                               rtol=1e-6)


@pytest.mark.parametrize("agg_order", ["class_first", "scale_first"])
@pytest.mark.parametrize("cls_weight", [False, True])
@pytest.mark.parametrize("spec", ["objectSum_scaleMax_classSum", "objectMax_scaleAvg_classAvg"])
def test_hua_object_scores(agg_order, cls_weight, spec):
    bounds, scores, lam, cb, db, ds, dv = _hua_inputs(5)
    agg = jhua.parse_agg_spec(spec)
    member = np.asarray(jax.vmap(jhua.object_membership)(*map(jnp.asarray, (cb, db, ds, dv))))
    fn = lambda s, l, m: jhua.hua_object_scores(s, l, m, bounds, agg, agg_order=agg_order,
                                                cls_weight=cls_weight)
    want = np.asarray(jax.jit(jax.vmap(fn))(jnp.asarray(scores), jnp.asarray(lam),
                                            jnp.asarray(member)))
    got = thua.hua_object_scores(_t(scores), _t(lam), _t(member), bounds, agg,
                                 agg_order=agg_order, cls_weight=cls_weight).numpy()
    np.testing.assert_array_equal(got == 0, want == 0)
    assert (got != 0).sum() >= 2 and got[-1] == 0
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("spec,num_fg,with_lambda", [
    ("scaleAvg_classAvg", None, True), ("scaleSum_classMax", None, False),
    ("scaleMax_classSum", 5, True)])
def test_hua_scale_scores(spec, num_fg, with_lambda):
    """Full-map probabilities with planted confident anchors; the last
    image has none (score exactly 0). num_fg < C gates on the first
    columns only, as the SSD family's background column needs."""
    rng = np.random.RandomState(3)
    sizes = (300, 120, 40)
    levels, lams = [], []
    for n in sizes:
        logits = rng.randn(4, n, 6).astype(np.float32) * 0.1  # max prob < 0.3
        for b in range(3):
            hot = rng.choice(n, 6, replace=False)
            logits[b, hot, rng.randint(0, 6, 6)] += 4.0
        e = np.exp(logits - logits.max(-1, keepdims=True))
        levels.append((e / e.sum(-1, keepdims=True)).astype(np.float32))
        lams.append((np.abs(rng.randn(4, n)) + 0.1).astype(np.float32))
    agg = jhua.parse_agg_spec(spec)
    lam_arg = lams if with_lambda else None
    fn = lambda ls, ll: jhua.hua_scale_scores(ls, ll, agg, num_fg_classes=num_fg)
    want = np.asarray(jax.jit(jax.vmap(fn))([jnp.asarray(a) for a in levels],
                                            None if lam_arg is None else
                                            [jnp.asarray(a) for a in lam_arg]))
    got = thua.hua_scale_scores([_t(a) for a in levels],
                                None if lam_arg is None else [_t(a) for a in lam_arg],
                                agg, num_fg_classes=num_fg).numpy()
    np.testing.assert_array_equal(got == 0, want == 0)
    assert (got[:3] > 0).all() and got[3] == 0
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)


# --- import rule ---------------------------------------------------------

def _imported_modules(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_no_jax():
    """Neither the port nor chip_smoke.py imports JAX, the JAX package, or
    what the machine with the card lacks (OpenCV, PIL, torchvision,
    msgpack)."""
    files = sorted((REPO / "aod_meh_hua_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 82
    # the two-stage families' modules (the variants' attention, necks and
    # backbones, PISA's step, the proposal families' models and steps), the
    # config printer, gen_proposals and the deployment tools among them
    names = {str(f.relative_to(REPO)) for f in files}
    assert {f"aod_meh_hua_torch/{m}.py" for m in (
        "ops/roi_align", "ops/sampler", "ops/nms", "models/two_stage", "engine/two_stage",
        "engine/train", "engine/tta", "tools/train_detector", "tools/print_config",
        "tools/deployment/export_model", "tools/deployment/package_model",
        "tools/deployment/test_exported", "tools/deployment/serve",
        "utils/profiling", "models/attention", "models/fpn", "models/resnest",
        "models/hrnet", "models/fpg", "models/gn_ws", "models/backbones",
        "engine/pisa", "models/rpn_only", "models/cascade_rpn", "models/deform",
        "models/trident", "models/grid_rcnn", "engine/rpn_only", "engine/cascade_rpn",
        "engine/trident", "engine/grid_rcnn", "tools/gen_proposals")} <= names
    refused = ("jax", "jaxlib", "flax", "aod_meh_hua_tpu", "cv2", "PIL", "torchvision",
               "msgpack",
               # the root `tools` too: the port copies from tools/analysis, it does not import it
               "tools")
    for f in files:
        for mod in _imported_modules(f):
            assert mod.split(".")[0] not in refused, (f, mod)


def test_alconfig_int8_scoring_raises():
    with pytest.raises(NotImplementedError, match="item 16"):
        tcfg.ALConfig(int8_scoring=True)
