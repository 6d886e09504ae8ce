"""The port's Faster R-CNN (aod_meh_hua_torch: ops/roi_align.py,
ops/sampler.py, ops/nms.py grouped_nms and class-specific boxes, the BCE
loss, models/fpn.py's three modes, models/two_stage.py and
engine/two_stage.py) against the JAX package's, on the CPU, f32.

The same seeded numpy inputs go through both; the models share one JAX
variables draw (tests/torch_parity.py jax_faster_rcnn, its RPN and class
heads sharpened so that no score sits within an ulp of its neighbour)
carried over with from_jax_variables. The samplers of both packages run
on JAX's own uniforms: those jax.random draws from the key tree the JAX
step splits (per stage, per image, then kp, kn in the sampler).

Tolerances: configs equal; the ops rtol 1e-5 (RoIAlign with atol 1e-5
on unit-normal maps: XLA's CPU backend contracts the sample coordinate
y1 + t * bin into one FMA, the port rounds the product first, so a
coordinate may sit an ulp apart and a value by that ulp times the map's
slope, up to 4.3e-6 here); the sampler, grouped NMS survivors, level maps, RPN targets'
masks and RoI samples exact; the model's stage outputs and the eval
step's detections rtol 1e-4 with the same valid sets; the train step's
losses rtol 1e-4 and its parameters after each of two SGD steps to 1e-4
of each tensor's max-abs.
"""

import dataclasses
import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aod_meh_hua_tpu.engine import Batch as JBatch
from aod_meh_hua_tpu.engine import EvalBatch as JEvalBatch
from aod_meh_hua_tpu.engine import create_train_state as jcreate_state
from aod_meh_hua_tpu.engine import two_stage as jts
from aod_meh_hua_tpu.models.fpn import FPN as JFPN
from aod_meh_hua_tpu.utils import config as jcfg
from aod_meh_hua_torch.engine import two_stage as tts
from aod_meh_hua_torch.engine.batch import Batch as TBatch
from aod_meh_hua_torch.engine.batch import EvalBatch as TEvalBatch
from aod_meh_hua_torch.engine.train import create_train_state as tcreate_state
from aod_meh_hua_torch.models.convert import from_jax_variables
from aod_meh_hua_torch.models.fpn import FPN as TFPN
from aod_meh_hua_torch.models.two_stage import FasterRCNN, build_two_stage
from aod_meh_hua_torch.ops import losses as tlosses
from aod_meh_hua_torch.ops import nms as tnms
from aod_meh_hua_torch.ops import roi_align as troi
from aod_meh_hua_torch.ops import sampler as tsampler
from aod_meh_hua_torch.utils import config as tcfg
from torch_parity import jax_faster_rcnn, jax_step_uniforms, two_stage_batch
from torch_parity import few_threads  # noqa: F401 (the fixture of pytestmark)

pytestmark = pytest.mark.usefixtures("few_threads")

# the JAX ops modules (aod_meh_hua_tpu.ops re-exports functions of the same names)
jlosses, jnms, jroi, jsampler = (importlib.import_module(f"aod_meh_hua_tpu.ops.{m}")
                                 for m in ("losses", "nms", "roi_align", "sampler"))


def _t(a):
    return torch.from_numpy(np.array(a))


def _fields(cls):
    return [(f.name, f.default if f.default is not dataclasses.MISSING else f.default_factory())
            for f in dataclasses.fields(cls)]


def _same_value(a, b):
    return dataclasses.asdict(a) == dataclasses.asdict(b) if dataclasses.is_dataclass(a) \
        else a == b


# --- config ---------------------------------------------------------------------

# the port's fields past the JAX class's: its subclasses' switches, at the
# values the base family has there (getattr defaults, models/two_stage.py)
VARIANT_FIELDS = ("neck_type", "roi_extractor", "bfp_refine_level", "bfp_refine_type",
                  "num_bins", "balanced_l1_alpha", "balanced_l1_gamma", "balanced_l1_beta")


@pytest.mark.parametrize("name", ["RPNCfg", "RCNNCfg", "FasterRCNNConfig"])
def test_config_fields_equal(name):
    jf, tf = _fields(getattr(jcfg, name)), _fields(getattr(tcfg, name))
    extra = VARIANT_FIELDS if name == "FasterRCNNConfig" else ()
    assert [n for n, _ in tf] == [n for n, _ in jf] + list(extra)
    for (n, a), (_, b) in zip(jf, tf):
        assert _same_value(a, b), n
    if extra:  # the Libra subclass's values of the same switches are the variant's
        libra = dict(_fields(jcfg.LibraRCNNConfig))
        assert libra["balanced_l1_gamma"] == 1.5 and libra["balanced_l1_beta"] == 1.0
        assert libra["bfp_refine_type"] == "non_local"


@pytest.mark.parametrize("orientation", ["landscape", "portrait"])
@pytest.mark.parametrize("tiny", [False, True])
def test_config_geometry_equal(orientation, tiny):
    j = (jcfg.tiny_faster_rcnn_config() if tiny else jcfg.FasterRCNNConfig()
         ).for_orientation(orientation)
    t = (tcfg.tiny_faster_rcnn_config() if tiny else tcfg.FasterRCNNConfig()
         ).for_orientation(orientation)
    assert _same_value(jcfg.FasterRCNNConfig(**{
        f.name: getattr(j, f.name) for f in dataclasses.fields(j)}), j)
    assert j.canvas == t.canvas and j.featmap_sizes() == t.featmap_sizes()
    assert j.level_bounds() == t.level_bounds()
    np.testing.assert_array_equal(
        np.concatenate(t.build_anchor_generator().grid_anchors(t.featmap_sizes())),
        np.concatenate(j.build_anchor_generator().grid_anchors(j.featmap_sizes())))


def test_zoo_registry_holds_the_ported_families():
    assert set(tcfg.ZOO_FAMILIES) <= set(jcfg.ZOO_FAMILIES)
    assert tcfg.ALL_FAMILIES == ("retinanet", "ssd") + tuple(tcfg.ZOO_FAMILIES)
    for name, (full, tiny) in tcfg.ZOO_FAMILIES.items():
        jfull, jtiny = jcfg.ZOO_FAMILIES[name]
        assert full.family == jfull.family == name
        assert dataclasses.asdict(tiny()) == {
            **dataclasses.asdict(jtiny()), **{f: getattr(tiny(), f) for f in VARIANT_FIELDS}}


@pytest.mark.parametrize("field,value,item", [
    ("backbone_type", "swin", "item 15"), ("neck_type", "nasfpn", "item 15"),
    ("backbone_dcn", "dcn", "item 15.5"), ("backbone_gcb_ratio", 0.25, "item 15.5"),
    ("backbone_dcn", "mdcn", "item 15.5"), ("backbone_gcb_ratio", 0.0625, "item 15.5"),
    ("roi_extractor", "generic", "item 15"), ("stem_s2d", True, "item 16"),
    ("compute_dtype", "bfloat16", "item 16"), ("remat", True, "item 16")])
def test_variants_raise(field, value, item):
    cfg = tcfg.tiny_faster_rcnn_config(**{field: value})
    with pytest.raises(NotImplementedError, match=item):
        FasterRCNN(cfg)
    model = build_two_stage(tcfg.tiny_faster_rcnn_config(), device="cpu")
    with pytest.raises(NotImplementedError, match=item):
        tts.make_faster_rcnn_eval_step(model, cfg, device="cpu")


# --- ops ----------------------------------------------------------------------------

def _feat(seed=0, h=12, w=16, c=5):
    return np.random.RandomState(seed).randn(h, w, c).astype(np.float32)


# rois across the edge bands: inside, sub-pixel, partly outside [-1, 0], past the
# far border, degenerate, and fully outside
EDGE_ROIS = np.array([
    [0.0, 0.0, 8.0, 6.0], [2.5, 1.5, 14.0, 11.0], [-2.0, -2.0, 4.0, 4.0],
    [10.0, 8.0, 30.0, 30.0], [3.0, 3.0, 3.6, 3.6], [-0.7, -0.4, 15.6, 11.8],
    [5.0, 5.0, 5.0, 9.0], [-40.0, -40.0, -20.0, -20.0], [14.9, 10.9, 16.4, 12.6],
], np.float32)


@pytest.mark.parametrize("scale", [1.0, 0.5, 0.25, 1.0 / 3.0])
@pytest.mark.parametrize("aligned", [True, False])
def test_roi_align_matches_jax(aligned, scale):
    feat = _feat(1)
    rois = EDGE_ROIS / np.float32(scale)
    for out_size, ratio in ((4, 2), (7, 2), (3, 1)):
        want = np.asarray(jroi.roi_align(jnp.asarray(feat), jnp.asarray(rois), out_size, scale,
                                         ratio, aligned))
        got = troi.roi_align(_t(feat), _t(rois), out_size, scale, ratio, aligned).numpy()
        assert got.shape == want.shape == (len(rois), out_size, out_size, feat.shape[-1])
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_roi_align_blocks_equal_one_pass(monkeypatch):
    """RoIs in ROI_BLOCK blocks give the one-pass values, bit for bit."""
    feat = _feat(2)
    rng = np.random.RandomState(3)
    xy = rng.uniform(-2, 14, (50, 2))
    rois = np.concatenate([xy, xy + rng.uniform(0.5, 9, (50, 2))], 1).astype(np.float32)
    whole = troi.roi_align(_t(feat), _t(rois))
    monkeypatch.setattr(troi, "ROI_BLOCK", 7)
    assert torch.equal(troi.roi_align(_t(feat), _t(rois)), whole)


def _pyramid_rois(seed, n=40, extent=240.0):
    rng = np.random.RandomState(seed)
    side = np.exp(rng.uniform(np.log(4), np.log(extent), (n, 2)))
    xy = rng.uniform(-10, extent, (n, 2))
    return np.concatenate([xy, xy + side], 1).astype(np.float32)


def test_map_roi_levels_matches_jax():
    rois = _pyramid_rois(4, n=400, extent=900.0)
    rois[:3] = [[0, 0, 0, 0], [5, 5, 3, 3], [0, 0, 112, 112]]  # empty, inverted, a boundary
    for levels in (4, 3):
        want = np.asarray(jroi.map_roi_levels(jnp.asarray(rois), levels))
        got = troi.map_roi_levels(_t(rois), levels).numpy()
        np.testing.assert_array_equal(got, want)
        assert len(np.unique(got)) == levels


@pytest.mark.parametrize("routing", [False, True])
def test_multilevel_roi_align_matches_jax(routing):
    rng = np.random.RandomState(5)
    strides = (4, 8, 16, 32)
    feats = [rng.randn(64 // s, 128 // s, 6).astype(np.float32) for s in strides]
    rois = _pyramid_rois(6, n=80, extent=240.0)
    route = (_pyramid_rois(7, n=80, extent=400.0) if routing else None)
    kw = dict(out_size=7, sampling_ratio=2, finest_scale=14)  # every level gets RoIs
    want = np.asarray(jroi.multilevel_roi_align(
        [jnp.asarray(f) for f in feats], jnp.asarray(rois), strides,
        routing_rois=None if route is None else jnp.asarray(route), **kw))
    got = troi.multilevel_roi_align([_t(f) for f in feats], _t(rois), strides,
                                    routing_rois=None if route is None else _t(route),
                                    **kw).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    lv = troi.map_roi_levels(_t(rois if route is None else route), 4, 14)
    assert len(torch.unique(lv)) == 4


def test_roi_align_gradient_matches_jax():
    """The gradient into the maps (a scatter-add of the bilinear weights)
    against jax.grad of the masked JAX form, rtol 1e-5 (atol 1e-5, the
    FMA-rounded coordinates of the module docstring)."""
    rng = np.random.RandomState(8)
    strides = (4, 8, 16, 32)
    feats = [rng.randn(64 // s, 128 // s, 3).astype(np.float32) for s in strides]
    rois = _pyramid_rois(9, n=30, extent=120.0)
    w = rng.randn(30, 7, 7, 3).astype(np.float32)

    def jloss(fs):
        return (jroi.multilevel_roi_align(fs, jnp.asarray(rois), strides, 7, 2, 14)
                * w).sum()

    want = jax.grad(jloss)([jnp.asarray(f) for f in feats])
    tf = [_t(f).requires_grad_() for f in feats]
    (troi.multilevel_roi_align(tf, _t(rois), strides, 7, 2, 14) * _t(w)).sum().backward()
    for g, j in zip(tf, want):
        np.testing.assert_allclose(g.grad.numpy(), np.asarray(j), rtol=1e-5, atol=1e-5)


def test_bce_with_logits_matches_jax():
    rng = np.random.RandomState(10)
    logits = (rng.randn(300) * 4).astype(np.float32)
    targets = (rng.uniform(size=300) > 0.5).astype(np.float32)
    weight = rng.uniform(size=300).astype(np.float32)
    for kw in (dict(reduction="none"), dict(reduction="sum"),
               dict(reduction="mean", avg_factor=np.float32(37.0))):
        want = np.asarray(jlosses.binary_cross_entropy_with_logits(
            jnp.asarray(logits), jnp.asarray(targets), jnp.asarray(weight), **kw))
        got = tlosses.binary_cross_entropy_with_logits(_t(logits), _t(targets), _t(weight),
                                                       **kw).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)


def _boxes(rng, n, extent=200.0):
    xy = rng.uniform(0, extent, (n, 2))
    return np.concatenate([xy, xy + rng.uniform(4, 60, (n, 2))], -1).astype(np.float32)


@pytest.mark.parametrize("n,groups", [(300, 5), (3000, 5), (120, 1)])
def test_grouped_nms_matches_jax(n, groups):
    """Equal survivors (boxes, scores, group ids, source indices) per image,
    at a candidate count over JAX's 2048 switch too; score ties and
    invalid candidates included."""
    rng = np.random.RandomState(n)
    b = 2
    boxes = np.stack([_boxes(rng, n) for _ in range(b)])
    scores = rng.uniform(size=(b, n)).astype(np.float32)
    scores[:, 10:20] = scores[:, :1]  # ties, broken by index
    gid = rng.randint(0, groups, (b, n)).astype(np.int32)
    valid = rng.uniform(size=(b, n)) > 0.1
    fn = jax.jit(jax.vmap(functools.partial(jnms.grouped_nms, iou_thr=0.6, max_out=80)))
    want = fn(jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(gid), jnp.asarray(valid))
    got = tnms.grouped_nms(_t(boxes), _t(scores), _t(gid).long(), _t(valid), 0.6, 80)
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    for name in ("boxes", "scores", "labels", "anchor_idx"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                                      err_msg=name)
    assert got.valid.sum() > 40


def test_suppression_blocks_equal_one_pass(monkeypatch):
    rng = np.random.RandomState(11)
    boxes = _t(np.stack([_boxes(rng, 257) for _ in range(2)]))
    whole = tnms._suppression_mask(boxes, 0.5)
    monkeypatch.setattr(tnms, "SUPPRESSION_BLOCK", 2 * 257 * 10)
    assert torch.equal(tnms._suppression_mask(boxes, 0.5), whole)


def test_multiclass_nms_class_specific_boxes_matches_jax():
    rng = np.random.RandomState(12)
    b, n, c = 2, 150, 5
    boxes = np.stack([_boxes(rng, n * c).reshape(n, c, 4) for _ in range(b)])
    scores = rng.uniform(size=(b, n, c)).astype(np.float32) ** 3
    fn = jax.jit(jax.vmap(lambda bx, sc: jnms.multiclass_nms(bx, sc, 0.05, 0.5, 40, 200)))
    want = fn(jnp.asarray(boxes), jnp.asarray(scores))
    got = tnms.batched_multiclass_nms(_t(boxes), _t(scores), 0.05, 0.5, 40, 200)
    for name in ("valid", "boxes", "scores", "labels", "anchor_idx"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                                      err_msg=name)
    one = tnms.multiclass_nms(_t(boxes[0]), _t(scores[0]), 0.05, 0.5, 40, 200)
    assert torch.equal(one.boxes, got.boxes[0])


def _jax_fpn_params(mode, relu, start_level, in_ch, x):
    fpn = JFPN(out_channels=8, start_level=start_level, num_outs=5,
               relu_before_extra_convs=relu, add_extra_convs=mode)
    shapes = jax.eval_shape(fpn.init, jax.random.PRNGKey(0), x)
    rng = np.random.RandomState(13)
    params = jax.tree_util.tree_map(
        lambda s: (rng.randn(*s.shape) * (0.3 if len(s.shape) == 4 else 0.1)).astype(np.float32),
        shapes)
    return fpn, params


@pytest.mark.parametrize("mode,relu,start_level", [
    ("on_input", False, 1), ("on_output", False, 1), ("on_output", True, 1),
    ("maxpool", False, 0), ("on_input", True, 0)])
def test_fpn_modes_match_jax(mode, relu, start_level):
    rng = np.random.RandomState(14)
    in_ch = (8, 12, 16, 20)
    x = [rng.randn(1, 40 // 2 ** i, 56 // 2 ** i, c).astype(np.float32)
         for i, c in enumerate(in_ch)]
    fpn, params = _jax_fpn_params(mode, relu, start_level, in_ch,
                                  [jnp.asarray(a) for a in x])
    want = fpn.apply(params, [jnp.asarray(a) for a in x])
    sd = {k[len("neck."):]: v for k, v in
          from_jax_variables({"params": {"neck": params["params"]}}).items()}
    port = TFPN(in_ch, 8, start_level=start_level, num_outs=5, add_extra_convs=mode,
                relu_before_extra_convs=relu)
    port.load_state_dict(sd)
    got = port([_t(a).permute(0, 3, 1, 2) for a in x])
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.permute(0, 2, 3, 1).detach().numpy(), np.asarray(w),
                                   rtol=1e-5, atol=1e-5)


def test_retinanet_fpn_unchanged():
    """RetinaNet's neck keeps its form: the default mode is on_input, its
    state_dict names are the same, and two extra convs take C5 then P6."""
    fpn = TFPN((256, 512, 1024, 2048))
    assert fpn.add_extra_convs == "on_input" and not fpn.relu_before_extra_convs
    assert [k for k in fpn.state_dict()] == (
        [f"lateral_convs.{i}.{p}" for i in range(3) for p in ("weight", "bias")]
        + [f"fpn_convs.{i}.{p}" for i in range(3) for p in ("weight", "bias")]
        + [f"extra_convs.{i}.{p}" for i in range(2) for p in ("weight", "bias")])
    assert fpn.extra_convs[0].in_channels == 2048 and fpn.extra_convs[1].in_channels == 256
    assert not any("extra" in k for k in TFPN((8, 16), 8, 0, 4, "maxpool").state_dict())


# --- the sampler ----------------------------------------------------------------------

def jax_draws(key, n):
    """The uniforms JAX's random_sample_pos_neg draws from `key`."""
    kp, kn = jax.random.split(key)
    return (np.asarray(jax.random.uniform(kp, (n,))), np.asarray(jax.random.uniform(kn, (n,))))


SAMPLER_CASES = {  # (n, positives, negatives, num, pos_fraction, neg_pos_ub)
    "rpn": (3000, 40, 2500, 256, 0.5, -1),
    "rcnn": (1064, 300, 700, 512, 0.25, -1),
    "few_pos": (500, 3, 400, 64, 0.5, -1),
    "no_pos": (500, 0, 400, 64, 0.5, -1),
    "underfull": (300, 5, 20, 64, 0.5, -1),
    "empty": (100, 0, 0, 32, 0.25, -1),
    "neg_pos_ub": (800, 6, 700, 256, 0.5, 5),
    "neg_pos_ub_no_pos": (800, 0, 700, 256, 0.5, 5),
    "many_ties": (20000, 3000, 16000, 512, 0.25, -1),  # about 24 tied draws
}


@pytest.mark.parametrize("case", list(SAMPLER_CASES))
def test_sampler_matches_jax_exactly(case):
    n, n_pos, n_neg, num, frac, ub = SAMPLER_CASES[case]
    rng = np.random.RandomState(len(case))
    assigned = np.full(n, -1, np.int32)
    perm = rng.permutation(n)
    assigned[perm[:n_pos]] = rng.randint(1, 5, n_pos)
    assigned[perm[n_pos:n_pos + n_neg]] = 0
    valid = rng.uniform(size=n) > 0.05
    key = jax.random.PRNGKey(len(case) * 7)
    want = jsampler.random_sample_pos_neg(key, jnp.asarray(assigned), jnp.asarray(valid), num,
                                          frac, neg_pos_ub=ub)
    u_pos, u_neg = jax_draws(key, n)
    if case == "many_ties":
        assert len(np.unique(u_pos)) < n
    got = tsampler.random_sample_pos_neg(_t(u_pos)[None], _t(u_neg)[None],
                                         _t(assigned)[None].long(), _t(valid)[None], num, frac,
                                         neg_pos_ub=ub)
    for name in ("inds", "is_pos", "valid"):
        np.testing.assert_array_equal(getattr(got, name)[0].numpy(),
                                      np.asarray(getattr(want, name)), err_msg=name)
    assert int(got.num_pos[0]) == int(want.num_pos)


# --- the model and the steps, stage by stage ----------------------------------------------

JC, TC = jcfg.tiny_faster_rcnn_config(), tcfg.tiny_faster_rcnn_config()


@pytest.fixture(scope="module")
def shared():
    """One JAX variables draw, the port's model carrying it, a batch, and
    JAX's stage-1 outputs on it."""
    jmodel, variables = jax_faster_rcnn()
    model = build_two_stage(TC, device="cpu")
    model.load_state_dict(from_jax_variables(variables))
    arrays = two_stage_batch(JC, seed=1)
    stage1 = jax.jit(functools.partial(jmodel.apply, method=jts._stage1))
    jfeats, jcls, jreg = stage1(variables, jnp.asarray(arrays[0]))
    return jmodel, variables, model, arrays, (jfeats, jcls, jreg)


def test_port_init_follows_the_jax_initialisers():
    model = build_two_stage(tcfg.FasterRCNNConfig(), device="cpu", seed=3)
    head, rpn = model.bbox_head, model.rpn_head
    for conv in (rpn.rpn_conv, rpn.rpn_cls, rpn.rpn_reg):
        assert abs(conv.weight.std().item() - 0.01) < 1e-3 and not conv.bias.any()
    assert abs(head.fc_cls.weight.std().item() - 0.01) < 1e-3
    assert abs(head.fc_reg.weight.std().item() - 0.001) < 1e-4
    fc0 = head.shared_fcs[0].weight
    bound = (6.0 / (fc0.shape[0] + fc0.shape[1])) ** 0.5
    assert fc0.abs().max() <= bound and fc0.abs().max() > 0.99 * bound
    assert fc0.shape == (1024, 7 * 7 * 256)
    assert not any(k.startswith("neck.extra") for k in model.state_dict())


def test_forward_matches_jax(shared):
    jmodel, variables, model, arrays, (jfeats, jcls, jreg) = shared
    with torch.no_grad():
        feats, cls, reg = model(_t(arrays[0]))
    assert len(feats) == 5
    for f, j in zip(feats, jfeats):
        j = np.asarray(j)
        np.testing.assert_allclose(f.permute(0, 2, 3, 1).numpy(), j, rtol=1e-4,
                                   atol=1e-4 * np.abs(j).max())
    np.testing.assert_allclose(cls.numpy(), np.asarray(jcls), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(reg.numpy(), np.asarray(jreg), rtol=1e-4, atol=1e-5)
    assert np.asarray(jcls).std() > 0.3  # sharpened: no sigmoid near-ties
    # the box head reads (h, w, c): the same RoI features give the same outputs
    roi = np.random.RandomState(15).randn(9, 7, 7, TC.fpn_channels).astype(np.float32)
    jout = jmodel.apply(variables, jnp.asarray(roi), method=jts._roi)
    tout = model.roi_forward(_t(roi))
    for g, w in zip(tout, jout):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("train", [True, False])
def test_proposals_match_jax(shared, train):
    """From JAX's RPN outputs: the same proposals (boxes rtol 1e-4, scores,
    valid slots) per image; no near-tie swap arises on these inputs."""
    _, _, _, arrays, (_, jcls, jreg) = shared
    nms_pre, max_out = ((JC.rpn.train_nms_pre, JC.rpn.train_max_per_img) if train
                        else (JC.rpn.test_nms_pre, JC.rpn.test_max_per_img))
    anchors = tts.anchor_table(TC)
    want = jax.jit(jts.make_proposal_fn(JC), static_argnums=(4, 5))(
        jcls, jreg, jnp.asarray(anchors), jnp.asarray(arrays[5]), nms_pre, max_out)
    with torch.no_grad():
        got = tts.make_proposal_fn(TC)(_t(jcls), _t(jreg), _t(anchors), _t(arrays[5]),
                                       nms_pre, max_out)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=1e-4)
    assert got[2].sum() > max_out // 2


def test_rpn_targets_and_roi_samples_match_jax(shared):
    """Given the same anchors, gts, proposals and JAX's draws: the RPN's
    targets (exact masks and counts, deltas rtol 1e-5) and the RoI samples
    (exact indices, labels, masks; deltas rtol 1e-5)."""
    _, _, _, arrays, (_, jcls, jreg) = shared
    images, gtb, gtl, gtv, av, shapes = arrays
    anchors = tts.anchor_table(TC)
    b = images.shape[0]
    key = jax.random.PRNGKey(3)
    k_rpn, k_roi = jax.random.split(key)
    jt = jax.jit(jax.vmap(functools.partial(jts._rpn_targets_single, rpn_cfg=JC.rpn),
                          in_axes=(0, None, 0, 0, 0)))(
        jax.random.split(k_rpn, b), jnp.asarray(anchors), jnp.asarray(av), jnp.asarray(gtb),
        jnp.asarray(gtv))
    props, _, pvalid = jax.jit(jts.make_proposal_fn(JC), static_argnums=(4, 5))(
        jcls, jreg, jnp.asarray(anchors), jnp.asarray(shapes), JC.rpn.train_nms_pre,
        JC.rpn.train_max_per_img)
    js = jax.jit(jax.vmap(functools.partial(jts._roi_sample_single, cfg=JC)))(
        jax.random.split(k_roi, b), props, pvalid, jnp.asarray(gtb), jnp.asarray(gtl),
        jnp.asarray(gtv))
    uniforms = jax_step_uniforms(key, b, len(anchors), JC.max_gt + props.shape[1])
    tt = tts.rpn_targets(*uniforms("rpn", len(anchors), 2), _t(anchors), _t(av), _t(gtb), _t(gtv),
                         TC.rpn)
    for name in ("is_pos", "weights", "num_samples"):
        np.testing.assert_array_equal(getattr(tt, name).numpy(), np.asarray(getattr(jt, name)),
                                      err_msg=name)
    np.testing.assert_allclose(tt.bbox_targets.numpy(), np.asarray(jt.bbox_targets),
                               rtol=1e-5, atol=1e-6)
    assert tt.is_pos.sum() > 0
    ts_ = tts.roi_sample(uniforms("roi", JC.max_gt + props.shape[1], 2), _t(props), _t(pvalid),
                         _t(gtb), _t(gtl).long(), _t(gtv), TC)
    for name in ("labels", "label_weights", "is_pos", "valid", "is_gt", "gt_idx"):
        np.testing.assert_array_equal(getattr(ts_, name).numpy(), np.asarray(getattr(js, name)),
                                      err_msg=name)
    np.testing.assert_array_equal(ts_.rois.numpy(), np.asarray(js.rois))
    np.testing.assert_allclose(ts_.bbox_targets.numpy(), np.asarray(js.bbox_targets),
                               rtol=1e-5, atol=1e-6)
    assert ts_.is_pos.sum() > ts_.is_gt.sum() > 0  # proposals reach the positives too


def test_scatter_add_keeps_index_zero():
    """An unfilled slot (index 0, value 0) next to a real sample at anchor 0
    leaves its weight and positive flag: the scatter adds, never sets."""
    inds = torch.tensor([[0, 5, 0, 0]])
    vals = torch.tensor([[1.0, 1.0, 0.0, 0.0]])
    assert tts._scatter_count(inds, vals, 8).tolist() == [[1, 0, 0, 0, 0, 1, 0, 0]]


def test_eval_step_matches_jax(shared):
    """The eval step's NMSResult, rtol 1e-4, the same valid sets, on four
    images with their own scale factors (class-specific boxes, rescale)."""
    jmodel, variables, model, arrays, _ = shared
    images = np.concatenate([arrays[0], two_stage_batch(JC, seed=2)[0]])
    shapes = np.concatenate([arrays[5], arrays[5]])
    sf = np.repeat(np.array([[1.0], [1.5], [0.7], [1.25]], np.float32), 4, axis=1)
    batch = (images, shapes, sf, np.ones(4, bool))
    want = jts.make_faster_rcnn_eval_step(jmodel, JC)(
        variables, JEvalBatch(*(jnp.asarray(a) for a in batch)))
    got = tts.make_faster_rcnn_eval_step(model, TC, device="cpu")(TEvalBatch(*batch))
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    np.testing.assert_array_equal(got.labels.numpy(), np.asarray(want.labels))
    np.testing.assert_array_equal(got.anchor_idx.numpy(), np.asarray(want.anchor_idx))
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores), rtol=1e-4)
    np.testing.assert_allclose(got.boxes.numpy(), np.asarray(want.boxes), rtol=1e-4, atol=1e-3)
    assert got.valid.sum() > 40 and len(torch.unique(got.labels[got.valid])) > 1


# --- the train step -------------------------------------------------------------------------

STEPS = 2


@pytest.fixture(scope="module")
def two_steps(shared):
    """Two SGD steps in each package from the shared weights on the same
    batch, the port's samplers on JAX's draws."""
    from aod_meh_hua_tpu.utils.config import TrainConfig as JTrainConfig

    jmodel, variables, _, arrays, _ = shared
    state, tx = jcreate_state(jmodel, jax.tree_util.tree_map(jnp.asarray, variables),
                              JTrainConfig(batch_size=2), frozen_stages=JC.frozen_stages)
    state = jax.device_put(state, jax.devices()[0])
    jstep = jts.make_faster_rcnn_train_step(jmodel, JC, tx)
    model = build_two_stage(TC, device="cpu")
    model.load_state_dict(from_jax_variables(variables))
    initial = {k: v.clone() for k, v in model.state_dict().items()}
    opt = tcreate_state(model, tcfg.TrainConfig(batch_size=2), frozen_stages=TC.frozen_stages)
    tstep = tts.make_faster_rcnn_train_step(model, TC, opt, device="cpu")
    n_anchor = TC.level_bounds()[-1][1]
    n_roi = TC.max_gt + TC.rpn.train_max_per_img
    out = []
    for i in range(STEPS):
        key = jax.random.PRNGKey(20 + i)
        state, jaux = jstep(state, JBatch(*(jnp.asarray(a) for a in arrays)), key)
        taux = tstep(TBatch(*arrays), uniforms=jax_step_uniforms(key, 2, n_anchor, n_roi))
        want = from_jax_variables({"params": jax.device_get(state.params),
                                   "batch_stats": variables["batch_stats"]})
        out.append(({k: float(v) for k, v in jaux.items()}, {k: float(v) for k, v in taux.items()},
                    want, {k: v.clone() for k, v in model.state_dict().items()}))
    return initial, out


def test_train_step_losses_match_jax(two_steps):
    _, out = two_steps
    for i, (jaux, taux, _, _) in enumerate(out):
        assert set(taux) == set(jaux) == {"loss", "loss_rpn_cls", "loss_rpn_bbox", "loss_cls",
                                          "loss_bbox", "num_pos"}
        for name in jaux:
            np.testing.assert_allclose(taux[name], jaux[name], rtol=1e-4,
                                       err_msg=f"step {i} {name}")
        assert jaux["num_pos"] > 0 and np.isfinite(taux["loss"])


def test_train_step_params_match_jax(two_steps):
    """After each step every tensor within 1e-4 of its max-abs of JAX's;
    the frozen stem and layer1 unchanged; the heads moved."""
    initial, out = two_steps
    for i, (_, _, want, got) in enumerate(out):
        assert set(got) == set(want)
        for name, w in want.items():
            scale = max(w.abs().max().item(), 1e-12)
            err = (got[name] - w).abs().max().item()
            assert err <= 1e-4 * scale, (i, name, err, scale)
    last = out[-1][3]
    for name, v in initial.items():
        frozen = name.startswith(("backbone.conv1", "backbone.bn1", "backbone.layer1"))
        assert torch.equal(last[name], v) == (frozen or "running_" in name), name
