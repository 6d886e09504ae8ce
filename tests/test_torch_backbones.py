"""The rest of Faster R-CNN's config variants in the port: their configs and
refusals, the backbones (aod_meh_hua_torch: models/backbones.py ResNeXt,
Res2Net, RegNet, regnet_stages and build_backbone, models/resnest.py,
models/hrnet.py HRNet), models/gn_ws.py ConvWS, the tree conversion
(models/convert.py) and engine/train.py's frozen mask, against the JAX
package's, on the CPU, f32. The necks, GN+WS's modules and the canvas
refusals: tests/test_torch_hrnet_fpg.py; PISA: tests/test_torch_pisa.py;
the steps, eval and exports: the files they name.

The backbones run on seeded numpy draws of their JAX variables (convs
N(0, 1/fan_in), BN statistics off the identity) carried over with
from_jax_variables, on one batch of two 64 x 128 images.

Tolerances: configs equal field by field; regnet_stages equal; each
backbone level within 1e-5 of its max-abs; ConvWS's output within 1e-5
of its max-abs; the frozen sets equal.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aod_meh_hua_tpu.engine.train import frozen_mask as jfrozen_mask
from aod_meh_hua_tpu.models import backbones as jbackbones
from aod_meh_hua_tpu.models import gn_ws as jgn_ws
from aod_meh_hua_tpu.utils import config as jcfg
from aod_meh_hua_torch.engine import two_stage as tts
from aod_meh_hua_torch.engine.train import frozen_mask
from aod_meh_hua_torch.models import backbones as tbackbones
from aod_meh_hua_torch.models import gn_ws as tgn_ws
from aod_meh_hua_torch.models import two_stage as tmodels
from aod_meh_hua_torch.models.convert import from_jax_variables
from aod_meh_hua_torch.utils import config as tcfg
from torch_parity import jax_two_stage, two_stage_pair
from torch_parity import few_threads  # noqa: F401 (the fixture of pytestmark)

pytestmark = pytest.mark.usefixtures("few_threads")

FAMILIES = ("pisa_faster_rcnn", "gn_ws", "resnest", "hrnet", "fpg")
CLASSES = {"pisa_faster_rcnn": "PISAFasterRCNNConfig", "gn_ws": "GNWSFasterRCNNConfig",
           "resnest": "ResNeStFasterRCNNConfig", "hrnet": "HRNetFasterRCNNConfig",
           "fpg": "FPGFasterRCNNConfig"}
# backbone_type -> (the family whose tiny config carries it, its overrides)
BACKBONES = {"resnet": ("faster_rcnn", {}),
             "resnext": ("faster_rcnn", {"backbone_type": "resnext"}),
             "res2net": ("faster_rcnn", {"backbone_type": "res2net"}),
             "regnet": ("faster_rcnn", {"backbone_type": "regnet",
                                        "regnet_arch": "regnetx_400mf"}),
             "hrnet": ("hrnet", {}), "resnest": ("resnest", {})}


def _defaults(cls):
    return {f.name: (f.default if f.default is not dataclasses.MISSING else f.default_factory())
            for f in dataclasses.fields(cls)}


def _value(v):
    return dataclasses.asdict(v) if dataclasses.is_dataclass(v) else v


def draw_variables(shapes, seed):
    """A seeded numpy draw of a JAX variables tree: conv and Dense kernels
    N(0, 1/fan_in), BN and GN scales and variances U(0.7, 1.3), biases
    and means N(0, 0.05)."""
    rng = np.random.RandomState(seed)

    def draw(path, leaf):
        name = getattr(path[-1], "key", str(path[-1]))
        if name == "kernel":
            return (rng.randn(*leaf.shape) * float(np.prod(leaf.shape[:-1])) ** -0.5
                    ).astype(np.float32)
        if name in ("scale", "var"):
            return rng.uniform(0.7, 1.3, leaf.shape).astype(np.float32)
        return (rng.randn(*leaf.shape) * 0.05).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def run_module(jmodule, tmodule, x, seed=0):
    """(JAX output, port output) of a Flax module and its port on x (NHWC
    numpy): the JAX variables drawn (draw_variables) and carried over."""
    shapes = jax.eval_shape(jmodule.init, jax.random.PRNGKey(0), x)
    variables = draw_variables(shapes, seed)
    tmodule.load_state_dict(from_jax_variables(variables))
    want = jmodule.apply(variables, jnp.asarray(x))
    with torch.no_grad():
        got = tmodule(torch.from_numpy(x).permute(0, 3, 1, 2))
    return want, got


def close_of_scale(got, want, tol=1e-5):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.abs(got - want).max()
    assert err <= tol * max(np.abs(want).max(), 1e-12), (err, np.abs(want).max())


def _image(seed=0, b=2, h=64, w=128):
    return np.random.RandomState(seed).randn(b, h, w, 3).astype(np.float32)


# --- configs and refusals ----------------------------------------------------------

@pytest.mark.parametrize("family", FAMILIES)
def test_configs_equal(family):
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


def test_registry_is_the_jax_order_cut_to_the_port():
    assert len(tcfg.ZOO_FAMILIES) == 19
    assert list(tcfg.ZOO_FAMILIES) == [f for f in jcfg.ZOO_FAMILIES if f in tcfg.ZOO_FAMILIES]
    assert set(tmodels.TWO_STAGE_FAMILIES) == set(tcfg.ZOO_FAMILIES)
    assert set(tts.TRAIN_STEPS) == set(tcfg.ZOO_FAMILIES)
    assert tmodels._MODELS["gn_ws"] is tmodels.GNWSFasterRCNN
    assert tmodels._MODELS["pisa_faster_rcnn"] is tmodels.FasterRCNN


@pytest.mark.parametrize("backbone", list(BACKBONES))
def test_backbone_channels_follow_the_backbone(backbone):
    """The necks' in-channels: the port's config names what flax infers."""
    family, over = BACKBONES[backbone]
    cfg = tcfg.ZOO_FAMILIES[family][1](**over)
    model = tmodels.build_two_stage(cfg, device="cpu")
    with torch.no_grad():
        levels = model.backbone(torch.zeros(1, 3, 64, 128))
    assert tuple(lv.shape[1] for lv in levels) == cfg.backbone_channels
    full = dataclasses.replace(tcfg.ZOO_FAMILIES[family][0](), **{
        k: v for k, v in over.items() if k != "regnet_arch"})
    want = {"resnet": (256, 512, 1024, 2048), "resnext": (256, 512, 1024, 2048),
            "res2net": (256, 512, 1024, 2048), "resnest": (256, 512, 1024, 2048),
            "hrnet": (32, 64, 128, 256), "regnet": (96, 192, 432, 1008)}[backbone]
    assert full.backbone_channels == want


@pytest.mark.parametrize("field,value,error,match", [
    ("backbone_dcn", "dcn", NotImplementedError, "item 15.5"),
    ("backbone_gcb_ratio", 0.25, NotImplementedError, "item 15.5"),
    ("compute_dtype", "bfloat16", NotImplementedError, "item 16"),
    ("remat", True, NotImplementedError, "item 16"),
    ("stem_s2d", True, NotImplementedError, "item 16"),
    ("backbone_type", "swin", NotImplementedError, "item 15")])
def test_refusals_name_their_item(field, value, error, match):
    for family in ("hrnet", "pisa_faster_rcnn", "gn_ws"):
        cfg = dataclasses.replace(tcfg.ZOO_FAMILIES[family][1](), **{field: value})
        with pytest.raises(error, match=match):
            tmodels.build_two_stage(cfg, device="cpu")


def test_variant_fields_refused_on_the_other_families():
    for family in ("cascade_rcnn", "dynamic_rcnn", "double_head_rcnn"):
        for field, value in (("backbone_type", "resnest"), ("neck_type", "fpg")):
            with pytest.raises(NotImplementedError, match="item 15"):
                tmodels.build_two_stage(tcfg.ZOO_FAMILIES[family][1](**{field: value}),
                                        device="cpu")
    # the fields that GN+WS's model and PISA's step do not read
    with pytest.raises(ValueError, match="neck_type"):
        tmodels.build_two_stage(tcfg.tiny_gn_ws_config(neck_type="pafpn"), device="cpu")
    cfg = tcfg.tiny_pisa_rcnn_config(num_bins=3)
    model = tmodels.build_two_stage(cfg, device="cpu")
    with pytest.raises(ValueError, match="num_bins"):
        tts.make_two_stage_train_step(model, cfg, torch.optim.SGD(model.parameters(), 0.1),
                                      device="cpu")


# --- backbones --------------------------------------------------------------------------

@pytest.mark.parametrize("arch", sorted(jbackbones.REGNET_ARCHS))
def test_regnet_stages_equal_jax(arch):
    assert tbackbones.REGNET_ARCHS[arch] == jbackbones.REGNET_ARCHS[arch]
    assert tbackbones.regnet_stages(tbackbones.REGNET_ARCHS[arch]) == \
        jbackbones.regnet_stages(jbackbones.REGNET_ARCHS[arch])


@pytest.mark.parametrize("backbone", [b for b in BACKBONES if b != "resnet"])
def test_backbones_match_jax(backbone):
    """build_backbone of each backbone_type (the tiny widths; RegNetX-400MF)
    against the JAX package's build_backbone: C2..C5 within 1e-5 of their
    max-abs."""
    family, over = BACKBONES[backbone]
    jc, tc = jcfg.ZOO_FAMILIES[family][1](**over), tcfg.ZOO_FAMILIES[family][1](**over)
    want, got = run_module(jbackbones.build_backbone(jc, jnp.float32),
                           tbackbones.build_backbone(tc), _image(), seed=3)
    assert len(got) == 4
    for w, g in zip(want, got):
        close_of_scale(g.permute(0, 2, 3, 1).numpy(), w)


@pytest.mark.parametrize("radix", [1, 2, 4])
def test_split_attention_conv_matches_jax(radix):
    """The radix-major channels, the radix softmax (a sigmoid at radix 1),
    the frozen BN on the pooled vector, at a stride."""
    from aod_meh_hua_tpu.models.resnest import SplitAttentionConv as J
    from aod_meh_hua_torch.models.resnest import SplitAttentionConv as T

    x = np.random.RandomState(radix).randn(2, 9, 14, 12).astype(np.float32)
    want, got = run_module(J(channels=12, stride=2, radix=radix), T(12, 12, 2, radix), x,
                           seed=radix)
    close_of_scale(got.permute(0, 2, 3, 1).numpy(), want)


def test_conv_ws_standardises_with_the_population_std():
    """ConvWS against the JAX ConvWS on a kernel of fan-in 2, where ddof 0
    and ddof 1 part by a factor near sqrt(2); the plain conv with ws off."""
    x = np.random.RandomState(0).randn(2, 6, 7, 2).astype(np.float32)
    for ws in (True, False):
        want, got = run_module(jgn_ws.ConvWS(features=5, kernel=1, ws=ws),
                               tgn_ws.ConvWS(2, 5, 1, ws=ws), x, seed=1)
        close_of_scale(got.permute(0, 2, 3, 1).numpy(), want)
    conv = tgn_ws.ConvWS(2, 5, 1)
    w = conv.weight.detach()
    unbiased = (w - w.mean(dim=(1, 2, 3), keepdim=True)) / (
        w.std(dim=(1, 2, 3), keepdim=True) + 1e-5)
    assert not torch.allclose(conv.standardized_weight(), unbiased, rtol=0.1)


# --- the tree and the frozen mask -----------------------------------------------------------

@pytest.mark.parametrize("family", FAMILIES)
def test_jax_tree_maps_onto_the_port_model(family):
    """Every JAX leaf lands on a port tensor of the same shape (grouped
    convs included), and every port tensor comes from one."""
    _, variables, model = two_stage_pair(family)
    sd, want = from_jax_variables(variables), model.state_dict()
    assert set(sd) == set(want)
    for k, v in sd.items():
        assert v.shape == want[k].shape, k


def test_an_unknown_leaf_raises():
    with pytest.raises(KeyError, match="no port counterpart"):
        from_jax_variables({"params": {"backbone": {"stem_conv0": {"weird": np.zeros(3)}}}})


@pytest.mark.parametrize("backbone", list(BACKBONES) + ["gn_ws"])
def test_frozen_sets_equal_jax(backbone):
    """engine/train.py's mask (by name) freezes exactly the port tensors of
    the JAX leaves that the JAX mask (engine/train.py:52-67) freezes."""
    family, over = BACKBONES.get(backbone, ("gn_ws", {}))
    jmodel, variables = jax_two_stage(family, **over)
    mask = jfrozen_mask(variables["params"], 1)
    flags = from_jax_variables({"params": jax.tree_util.tree_map(
        lambda p, m: np.full(p.shape, float(m), np.float32), variables["params"], mask)})
    want = {k for k, v in flags.items() if v.flatten()[0] == 1.0}
    model = tmodels.build_two_stage(tcfg.ZOO_FAMILIES[family][1](**over), device="cpu")
    got = {k for k, frozen in frozen_mask(model, 1).items() if frozen}
    assert got == want and got
    stem = {k.split(".")[1] for k in got}
    assert stem == {"hrnet": {"conv1", "bn1", "layer1"}, "resnest": {"layer1"},
                    "gn_ws": {"conv1", "layer1"}}.get(backbone, {"conv1", "bn1", "layer1"})
