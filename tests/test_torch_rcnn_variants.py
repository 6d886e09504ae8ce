"""The Faster R-CNN variants' ops and modules in the port
(aod_meh_hua_torch: utils/config.py's five configs, ops/losses.py
balanced_l1_loss, ops/sampler.py libra_sample_pos_neg, models/fpn.py's
adaptive_max_pool, NonLocal2D, BFP, PAFPN, carafe_upsample and FPNCARAFE,
models/attention.py GeneralizedAttention, models/resnet.py's attention
plugin and models/convert.py)
against the JAX package's, on the CPU, f32. The families' steps:
tests/test_torch_rcnn_variant_steps.py and
tests/test_torch_rcnn_attention_steps.py (training) and
tests/test_torch_rcnn_variant_eval.py (eval, GRoIE's extraction).

The same seeded numpy inputs go through both; a module's JAX parameters
go through from_jax_variables, and every attention block runs with a
non-zero gamma, key_bias and geom_bias (at init they are zero, and the
block is the identity: a test of that form checks nothing but that).
Libra's sampler runs on the seven uniforms JAX's splits its key into.

Tolerances: configs equal field by field; the sampler's slots index for
index; balanced L1 and its gradient rtol 1e-6; the pools and resizes
exact; the necks, NonLocal2D and CARAFE within 1e-5 of the output's
max-abs; GeneralizedAttention's residual (output
minus input) within 1e-5 of its max-abs; the ResNet with attention's
levels within 1e-5 of their max-abs.
"""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aod_meh_hua_tpu.models import attention as jattention
from aod_meh_hua_tpu.models import fpn as jfpn
from aod_meh_hua_tpu.models.resnet import ResNet as JResNet
from aod_meh_hua_tpu.utils import config as jcfg
from aod_meh_hua_torch.models import attention as tattention
from aod_meh_hua_torch.models import fpn as tfpn
from aod_meh_hua_torch.models import two_stage as tmodels
from aod_meh_hua_torch.models.convert import from_jax_variables
from aod_meh_hua_torch.models.resnet import ResNet as TResNet
from aod_meh_hua_torch.ops import losses as tlosses
from aod_meh_hua_torch.ops import sampler as tsampler
from aod_meh_hua_torch.utils import config as tcfg
from torch_parity import ATTENTION_LEAVES, jax_sampler_draws, two_stage_pair
from torch_parity import few_threads  # noqa: F401 (the fixture of pytestmark)

pytestmark = pytest.mark.usefixtures("few_threads")

jlosses, jsampler = (importlib.import_module(f"aod_meh_hua_tpu.ops.{m}")
                     for m in ("losses", "sampler"))

FAMILIES = ("libra_rcnn", "pafpn", "carafe", "groie", "empirical_attention")
CLASSES = {"libra_rcnn": "LibraRCNNConfig", "pafpn": "PAFPNFasterRCNNConfig",
           "carafe": "CARAFEFasterRCNNConfig", "groie": "GRoIEFasterRCNNConfig",
           "empirical_attention": "EmpiricalAttentionConfig"}
# the full-width levels P2..P6 (C2..C5 for the necks) in each orientation
LEVELS = {"landscape": [(152, 256), (76, 128), (38, 64), (19, 32), (10, 16)],
          "portrait": [(256, 152), (128, 76), (64, 38), (32, 19), (16, 10)]}


def _t(a):
    return torch.from_numpy(np.array(a))


def _nchw(a):
    return _t(a).permute(0, 3, 1, 2)


def _nhwc(t):
    return t.permute(0, 2, 3, 1).detach().numpy()


def _close_of_scale(got, want, tol=1e-5):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= tol * max(np.abs(want).max(), 1e-12), (err, np.abs(want).max())


def _defaults(cls):
    return {f.name: (f.default if f.default is not dataclasses.MISSING else f.default_factory())
            for f in dataclasses.fields(cls)}


def _value(v):
    return dataclasses.asdict(v) if dataclasses.is_dataclass(v) else v


def _port_module(module, jparams):
    module.load_state_dict(from_jax_variables({"params": jparams}))
    return module


def _init_apply(module, seed, *args):
    """(params, output) of a Flax module's init and apply, one jitted program."""
    def run(*a):
        v = module.init(jax.random.PRNGKey(seed), *a)
        return v["params"], module.apply(v, *a)

    return jax.jit(run)(*args)


def _excite(params, seed):
    """The JAX tree with every attention leaf (zero at init) drawn non-zero."""
    rng = np.random.RandomState(seed)

    def draw(path, leaf):
        name = getattr(path[-1], "key", str(path[-1]))
        if name == "gamma":
            return jnp.asarray(rng.uniform(0.5, 1.0, leaf.shape).astype(np.float32))
        if name in ATTENTION_LEAVES:
            return jnp.asarray((rng.randn(*leaf.shape) * 0.5).astype(np.float32))
        return leaf

    return jax.tree_util.tree_map_with_path(draw, params)


# --- configs ------------------------------------------------------------------------

@pytest.mark.parametrize("family", FAMILIES)
def test_variant_configs_equal(family):
    name = CLASSES[family]
    j, t = _defaults(getattr(jcfg, name)), _defaults(getattr(tcfg, name))
    assert set(j) <= set(t)
    for k, v in j.items():
        assert _value(t[k]) == _value(v), k
    assert getattr(tcfg, name).family == getattr(jcfg, name).family == family
    (tfull, ttiny), (jfull, jtiny) = tcfg.ZOO_FAMILIES[family], jcfg.ZOO_FAMILIES[family]
    assert tfull is getattr(tcfg, name)
    for tc, jc in ((tfull(), jfull()), (ttiny(), jtiny())):
        got = dataclasses.asdict(tc)
        assert {k: got[k] for k in dataclasses.asdict(jc)} == dataclasses.asdict(jc)
        assert tc.featmap_sizes() == jc.featmap_sizes()
    if family == "empirical_attention":
        assert tfull().backbone_attention == "0010" and ttiny().backbone_attention == "1111"


@pytest.mark.parametrize("field,value", [
    ("backbone_type", "swin"), ("backbone_dcn", "dcn"), ("backbone_gcb_ratio", 0.25),
    ("backbone_dcn", "mdcn"), ("backbone_gcb_ratio", 0.0625), ("neck_type", "nasfpn"),
    ("roi_extractor", "generic"), ("bfp_refine_type", "conv")])
def test_variant_switches_refuse_the_rest(field, value):
    for family in ("libra_rcnn", "groie"):
        cfg = tcfg.ZOO_FAMILIES[family][1](**{field: value})
        with pytest.raises(NotImplementedError, match="item 15"):
            tmodels.build_two_stage(cfg, device="cpu")
    with pytest.raises(ValueError, match="attention_type"):
        tmodels.build_two_stage(tcfg.tiny_empirical_attention_config(backbone_attention="01"),
                                device="cpu")


@pytest.mark.parametrize("family", FAMILIES)
def test_variant_jax_tree_maps_onto_the_port_model(family):
    """Every JAX leaf lands on a port tensor of the same shape, and every
    port tensor comes from one; the attention leaves among them."""
    _, variables, model = two_stage_pair(family)
    sd = from_jax_variables(variables)
    want = model.state_dict()
    assert set(sd) == set(want)
    for k, v in sd.items():
        assert v.shape == want[k].shape, k
    leaves = {k.rsplit(".", 1)[1] for k in sd} & set(ATTENTION_LEAVES)
    assert leaves == {"empirical_attention": {"key_bias", "geom_bias", "gamma"},
                      "groie": {"gamma"}}.get(family, set())


# --- balanced L1 and Libra's sampler ---------------------------------------------------

def test_balanced_l1_and_its_gradient_match_jax():
    rng = np.random.RandomState(0)
    pred = rng.randn(300, 4).astype(np.float32)
    target = (pred + rng.choice([-1, 1], pred.shape) * np.concatenate([
        rng.uniform(0, 2.5, (297, 4)), [[1.0] * 4, [0.0] * 4, [1e-7] * 4]])).astype(np.float32)
    kw = dict(alpha=0.5, gamma=1.5, beta=1.0)
    want = jlosses.balanced_l1_loss(jnp.asarray(pred), jnp.asarray(target), reduction="none",
                                    **kw)
    tp = _t(pred).requires_grad_()
    got = tlosses.balanced_l1_loss(tp, _t(target), reduction="none", **kw)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-6, atol=1e-7)
    jgrad = jax.grad(lambda p: jlosses.balanced_l1_loss(p, jnp.asarray(target), **kw))(
        jnp.asarray(pred))
    tlosses.balanced_l1_loss(tp, _t(target), **kw).backward()
    np.testing.assert_allclose(tp.grad.numpy(), np.asarray(jgrad), rtol=1e-6, atol=1e-9)


NUM_GT = 8


def _sampler_case(case, seed):
    """One image's (assigned, valid, max_overlaps) of `case`."""
    rng = np.random.RandomState(seed)
    n = {"under_full": 60, "one_gt": 900}.get(case, 1200)
    valid = rng.uniform(size=n) > 0.05
    assigned = np.where(rng.uniform(size=n) < 0.05, -1, 0)
    per_gt = {"under_full": [3, 2], "over_full_grow": [300, 2, 2],
              "over_full_shrink": [40] * NUM_GT, "one_gt": [200], "no_positives": [],
              "bin_edge": [5, 4]}[case]
    order = rng.permutation(n)
    at = 0
    for g, count in enumerate(per_gt):
        assigned[order[at:at + count]] = g + 1
        at += count
    ov = np.where(assigned > 0, rng.uniform(0.5, 1.0, n), rng.uniform(0.0, 0.5, n) ** 2)
    if case == "bin_edge":
        # the largest valid max IoU held by a negative, and negatives on
        # the bin boundaries; at the maximum the interval's rounding
        # decides (EDGE_IOU: in the last bin under JAX's jitted rounding,
        # past it under a true division)
        ov = np.where(assigned > 0, rng.uniform(0.5, 0.6, n), ov * 0.8)
        neg = np.flatnonzero((assigned == 0) & valid)
        top = EDGE_IOU
        ov[neg[:4]] = [top, top / 3, 2 * top / 3, top * np.float32(1 / 3)]
    ov = np.where(valid, ov, 0.0).astype(np.float32)
    return assigned.astype(np.int32), valid, ov


def _edge_iou():
    """A max IoU m at which floor(m / (m * f32(1 / 3))) is 2 and
    floor(m / (m / 3)) is 3 in f32."""
    third = np.float32(1.0 / 3.0)
    for m in np.linspace(0.6, 0.7, 2001).astype(np.float32):
        if np.floor(m / (m * third)) == 2 and np.floor(m / (m / np.float32(3))) == 3:
            return m
    raise AssertionError("no IoU splits the two roundings")


EDGE_IOU = _edge_iou()


@pytest.mark.parametrize("case", ["under_full", "over_full_grow", "over_full_shrink", "one_gt",
                                  "no_positives", "bin_edge"])
def test_libra_sampler_matches_jax(case):
    """The same slots index for index under JAX's seven draws, two images
    of the case at once (the port batched, JAX per image)."""
    num, frac = (64, 0.25) if case == "under_full" else (512, 0.25)
    imgs = [_sampler_case(case, s) for s in (1, 2)]
    keys = jax.random.split(jax.random.PRNGKey(7), 2)
    fn = jax.jit(lambda k, a, v, o: jsampler.libra_sample_pos_neg(
        k, a, v, o, num, frac, num_gt=NUM_GT, num_bins=3))
    want = [fn(k, *map(jnp.asarray, img)) for k, img in zip(keys, imgs)]
    draws = [jax_sampler_draws(k, len(imgs[0][0]), 7) for k in keys]
    u = [_t(np.stack([d[i] for d in draws])) for i in range(7)]
    got = tsampler.libra_sample_pos_neg(u, *(_t(np.stack(x)).long() if i == 0 else
                                            _t(np.stack(x)) for i, x in enumerate(zip(*imgs))),
                                        num, frac, num_gt=NUM_GT, num_bins=3)
    for b, w in enumerate(want):
        for name in ("inds", "is_pos", "valid", "num_pos"):
            g, v = getattr(got, name)[b].numpy(), np.asarray(getattr(w, name))
            if name == "inds":  # an unfilled slot's index is 0 in both
                g = np.where(got.valid[b].numpy(), g, 0)
            np.testing.assert_array_equal(g, v, err_msg=f"{case} image {b} {name}")
    num_pos = got.num_pos.numpy()
    if case == "no_positives":
        assert (num_pos == 0).all() and got.valid.all()
    if case == "over_full_shrink" or case == "over_full_grow":
        assert (num_pos == int(num * frac)).all()
    if case == "bin_edge":  # the negative at the maximum IoU is drawn only as a leftover
        assert got.valid.sum(1).tolist() == [num, num]


def test_group_ranks_match_jax():
    rng = np.random.RandomState(3)
    mask = rng.uniform(size=(2, 500)) > 0.3
    group = rng.randint(0, 5, (2, 500))
    keys = jax.random.split(jax.random.PRNGKey(9), 2)
    want = [np.asarray(jsampler._group_ranks(k, jnp.asarray(m), jnp.asarray(g), 5))
            for k, m, g in zip(keys, mask, group)]
    u = _t(np.stack([np.asarray(jax.random.uniform(k, (500,))) for k in keys]))
    got = tsampler._group_ranks(u, _t(mask), _t(group), 5).numpy()
    np.testing.assert_array_equal(got, np.stack(want))


# --- the necks -------------------------------------------------------------------------

@pytest.mark.parametrize("orientation", ["landscape", "portrait"])
def test_pools_and_resizes_follow_jax_index_rules(orientation):
    """adaptive_max_pool and nearest_resize at the BFP's level pairs (P2,
    P3 pooled and P5, P6 resized to P4; P4 resized to P2, P3 and pooled
    to P5, P6: ratios of 3.8 and 1/3.8 among them), bit for bit."""
    sizes = LEVELS[orientation]
    rng = np.random.RandomState(4)
    xs = [rng.randn(1, *hw, 3).astype(np.float32) for hw in sizes]
    for i, x in enumerate(xs):
        pairs = [(x, sizes[2])] if i != 2 else [(x, hw) for j, hw in enumerate(sizes) if j != 2]
        for src, dst in pairs:
            pool = dst[0] <= src.shape[1]
            jf, tf = ((jfpn.adaptive_max_pool, tfpn.adaptive_max_pool) if pool
                      else (jfpn.nearest_resize, tfpn.nearest_resize))
            want = jax.jit(jf, static_argnums=1)(jnp.asarray(src), dst)
            np.testing.assert_array_equal(_nhwc(tf(_nchw(src), dst)), np.asarray(want),
                                          err_msg=f"{src.shape} -> {dst}")


def _level_inputs(sizes, channels, seed):
    rng = np.random.RandomState(seed)
    return [rng.randn(2, h, w, c).astype(np.float32) for (h, w), c in zip(sizes, channels)]


@pytest.mark.parametrize("orientation", ["landscape", "portrait"])
def test_bfp_matches_jax(orientation):
    """The BFP at the full-width levels P2..P6 (4 channels): every level's
    output, and its NonLocal2D alone on the refine level."""
    xs = _level_inputs(LEVELS[orientation], [4] * 5, 5)
    params, want = _init_apply(jfpn.BFP(refine_level=2), 1, [jnp.asarray(x) for x in xs])
    tm = _port_module(tfpn.BFP(4, refine_level=2), params)
    got = tm([_nchw(x) for x in xs])
    for g, w in zip(got, want):
        _close_of_scale(_nhwc(g), w)
    jnl = jax.jit(jfpn.NonLocal2D(4).apply)({"params": params["refine"]}, jnp.asarray(xs[2]))
    _close_of_scale(_nhwc(tm.refine(_nchw(xs[2]))), jnl)


@pytest.mark.parametrize("orientation", ["landscape", "portrait"])
def test_pafpn_matches_jax(orientation):
    """PAFPN on C2..C5 at the full-width sizes (narrow channels)."""
    xs = _level_inputs(LEVELS[orientation][:4], [4, 8, 16, 32], 6)
    params, want = _init_apply(jfpn.PAFPN(out_channels=8, start_level=0, num_outs=5), 2,
                               [jnp.asarray(x) for x in xs])
    got = _port_module(tfpn.PAFPN([4, 8, 16, 32], 8, 0, 5), params)([_nchw(x) for x in xs])
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        _close_of_scale(_nhwc(g), w)


def test_carafe_upsample_matches_jax():
    rng = np.random.RandomState(7)
    x = rng.randn(2, 5, 9, 6).astype(np.float32)
    masks = jax.nn.softmax(jnp.asarray(rng.randn(2, 10, 18, 25).astype(np.float32)), axis=-1)
    want = jax.jit(jfpn.carafe_upsample, static_argnums=(2, 3))(jnp.asarray(x), masks, 5, 2)
    got = tfpn.carafe_upsample(_nchw(x), _nchw(np.asarray(masks)), 5, 2)
    _close_of_scale(_nhwc(got), want)


@pytest.mark.parametrize("orientation", ["landscape", "portrait"])
def test_fpn_carafe_matches_jax(orientation):
    """The CARAFE FPN on C2..C5 at the full-width sizes (narrow
    channels), the coarsest odd (19 -> 38 -> 76 -> 152)."""
    xs = _level_inputs(LEVELS[orientation][:4], [4, 8, 16, 32], 8)
    params, want = _init_apply(jfpn.FPNCARAFE(out_channels=8, num_outs=5), 3,
                               [jnp.asarray(x) for x in xs])
    got = _port_module(tfpn.FPNCARAFE([4, 8, 16, 32], 8, 5), params)([_nchw(x) for x in xs])
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        _close_of_scale(_nhwc(g), w)


# --- GeneralizedAttention and the ResNet plugin ---------------------------------------

@pytest.mark.parametrize("attention_type,channels,heads,size", [
    ("0010", 32, 8, (9, 16)), ("0100", 16, 6, (7, 7)), ("1111", 32, 8, (7, 11)),
    ("1111", 64, 8, (5, 8))])
def test_generalized_attention_matches_jax(attention_type, channels, heads, size):
    """kv_stride 2 (odd sides pool by floor), gamma and biases non-zero:
    the residual within 1e-5 of its max-abs."""
    rng = np.random.RandomState(9)
    x = rng.randn(2, *size, channels).astype(np.float32)
    jm = jattention.GeneralizedAttention(num_heads=heads, attention_type=attention_type,
                                         kv_stride=2)
    params = _excite(jax.jit(jm.init)(jax.random.PRNGKey(4), jnp.asarray(x))["params"], 10)
    want = np.asarray(jax.jit(jm.apply)({"params": params}, jnp.asarray(x)))
    tm = _port_module(tattention.GeneralizedAttention(channels, heads, attention_type, 2), params)
    got = _nhwc(tm(_nchw(x)))
    _close_of_scale(got - x, want - x)
    assert np.abs(want - x).max() > 0.1


def test_generalized_attention_is_the_identity_at_init():
    model = tmodels.build_two_stage(tcfg.tiny_groie_config(), device="cpu", seed=2)
    x = torch.randn(3, 16, 7, 7)
    assert not model.groie_post.gamma.any()
    assert torch.equal(model.groie_post(x), x)
    block = tmodels.build_two_stage(tcfg.tiny_empirical_attention_config(), device="cpu")
    att = block.backbone.layer4[0].gen_attention
    assert not att.key_bias.any() and not att.geom_bias.any()
    y = torch.randn(2, att.proj_conv.out_channels, 2, 4)
    assert torch.equal(att(y), y)


def test_resnet_attention_plugin_matches_jax():
    """The tiny backbone with "1111" blocks in c4 and c5 (a non-zero
    gamma and biases in each): every level within 1e-5 of its max-abs."""
    _, variables, model = two_stage_pair("empirical_attention")
    x = np.random.RandomState(11).randn(2, 64, 128, 3).astype(np.float32)
    jm = JResNet(block_counts=(1, 1, 1, 1), stem_width=8, attention="1111")
    want = jax.jit(jm.apply)({"params": variables["params"]["backbone"],
                              "batch_stats": variables["batch_stats"]["backbone"]},
                             jnp.asarray(x))
    assert isinstance(model.backbone, TResNet)
    with torch.no_grad():
        got = model.backbone(_nchw(x).contiguous(memory_format=torch.channels_last))
    for g, w in zip(got, want):
        _close_of_scale(_nhwc(g), w)
    assert [b.gen_attention is not None for b in (model.backbone.layer1[0],
                                                  model.backbone.layer3[0])] == [False, True]
