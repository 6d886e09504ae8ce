"""The port's Cascade, Dynamic and Double-Head R-CNN (aod_meh_hua_torch:
utils/config.py, models/two_stage.py, models/convert.py,
engine/two_stage.py, engine/checkpoint.py and api.py's eval dispatch)
against the JAX package's, on the CPU, f32. The eval steps, the
full-width heads, the trainer and the server for the three families:
tests/test_torch_rcnn_entry_points.py.

The same seeded numpy inputs go through both; each family's models share
one JAX variables draw (tests/torch_parity.py jax_two_stage: the RPN and
class heads sharpened, so that no score sits within an ulp of its
neighbour) carried over with from_jax_variables. The samplers of both
packages run on JAX's own uniforms, drawn from the key tree the JAX step
splits: k_rpn, k_roi = split(key); the cascade splits k_roi once per
stage (k_roi, k = split(k_roi)), then split(k, B) per image and (kp,
kn) in the sampler.

Tolerances: configs equal field by field; the sampled RoIs of every
cascade stage index for index; the losses rtol 1e-4 and the parameters
after each SGD step to 1e-4 of each tensor's max-abs (the double head's
BN running statistics and Dynamic R-CNN's statistics among them, the
threshold and beta to 1e-6).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aod_meh_hua_tpu.engine import Batch as JBatch
from aod_meh_hua_tpu.engine import create_train_state as jcreate_state
from aod_meh_hua_tpu.engine import two_stage as jts
from aod_meh_hua_tpu.utils import config as jcfg
from aod_meh_hua_torch import api as tapi
from aod_meh_hua_torch.engine import two_stage as tts
from aod_meh_hua_torch.engine.batch import Batch as TBatch
from aod_meh_hua_torch.engine.checkpoint import (load_model_state_dict, load_train_state,
                                                 save_train_state)
from aod_meh_hua_torch.engine.train import create_train_state as tcreate_state
from aod_meh_hua_torch.models import two_stage as tmodels
from aod_meh_hua_torch.models.convert import from_jax_variables
from aod_meh_hua_torch.utils import config as tcfg
from torch_parity import two_stage_batch, two_stage_pair
from torch_parity import few_threads  # noqa: F401 (the fixture of pytestmark)

pytestmark = pytest.mark.usefixtures("few_threads")

FAMILIES = ("cascade_rcnn", "dynamic_rcnn", "double_head_rcnn")
# the port's fields past the JAX classes': the Faster R-CNN variants' switches
VARIANT_FIELDS = ("neck_type", "roi_extractor", "bfp_refine_level", "bfp_refine_type",
                  "num_bins", "balanced_l1_alpha", "balanced_l1_gamma", "balanced_l1_beta")
N_ANCHOR = tcfg.tiny_faster_rcnn_config().level_bounds()[-1][1]


def _t(a):
    return torch.from_numpy(np.array(a))


def _defaults(cls):
    return {f.name: (f.default if f.default is not dataclasses.MISSING else f.default_factory())
            for f in dataclasses.fields(cls)}


def _value(v):
    return dataclasses.asdict(v) if dataclasses.is_dataclass(v) else v


# --- config -----------------------------------------------------------------------

@pytest.mark.parametrize("name", ["CascadeRCNNConfig", "DynamicRCNNConfig",
                                  "DoubleHeadRCNNConfig"])
def test_family_config_fields_equal(name):
    j, t = _defaults(getattr(jcfg, name)), _defaults(getattr(tcfg, name))
    assert set(t) == set(j) | set(VARIANT_FIELDS)
    for k, v in j.items():
        assert _value(t[k]) == _value(v), k
    assert getattr(tcfg, name).family == getattr(jcfg, name).family


@pytest.mark.parametrize("family", FAMILIES)
def test_family_full_and_tiny_configs_equal(family):
    (tfull, ttiny), (jfull, jtiny) = tcfg.ZOO_FAMILIES[family], jcfg.ZOO_FAMILIES[family]
    for t, j in ((tfull(), jfull()), (ttiny(), jtiny())):
        got = dataclasses.asdict(t)
        assert {k: got[k] for k in dataclasses.asdict(j)} == dataclasses.asdict(j)
        assert t.featmap_sizes() == j.featmap_sizes() and t.canvas == j.canvas
    assert tcfg.ALL_FAMILIES == ("retinanet", "ssd") + tuple(tcfg.ZOO_FAMILIES)


@pytest.mark.parametrize("family", FAMILIES)
def test_family_variant_fields_still_raise(family):
    cfg = tcfg.ZOO_FAMILIES[family][1](neck_type="pafpn")
    with pytest.raises(NotImplementedError, match="item 15"):
        tmodels.build_two_stage(cfg, device="cpu")
    with pytest.raises(NotImplementedError, match="item 16"):
        tmodels.build_two_stage(dataclasses.replace(cfg, neck_type="fpn", remat=True),
                                device="cpu")


# --- models and conversion --------------------------------------------------------------

@pytest.mark.parametrize("family", FAMILIES)
def test_jax_tree_maps_onto_the_port_model(family):
    """Every JAX leaf lands on a port tensor of the same element count, and
    every port tensor but Dynamic R-CNN's statistics (not in a fresh JAX
    tree: the JAX step adds them) comes from one."""
    _, variables, model = two_stage_pair(family)
    sd = from_jax_variables(variables)
    want = model.state_dict()
    assert set(sd) == {k for k in want if not k.startswith("dynamic.")}
    for k, v in sd.items():
        assert v.numel() == want[k].numel(), k


def test_dynamic_state_converts_and_checkpoints(tmp_path):
    """batch_stats["__dynamic_rcnn__"] maps to the dynamic buffers, an
    unknown leaf there raises, a save_train_state round trip keeps the
    state and the step, and a file without the state loads with the
    state left at its initial values."""
    cfg = tcfg.tiny_dynamic_rcnn_config()
    jdyn = {"iou_hist": np.arange(4, dtype=np.float32) / 10, "beta_hist": np.ones(4, np.float32),
            "iou_thr": np.float32(0.45), "beta": np.float32(0.3)}
    _, variables, _ = two_stage_pair("dynamic_rcnn")
    tree = {**variables, "batch_stats": {**variables["batch_stats"], "__dynamic_rcnn__": jdyn}}
    sd = from_jax_variables(tree)
    for k, v in jdyn.items():
        np.testing.assert_array_equal(sd[f"dynamic.{k}"].numpy(), v)
    with pytest.raises(KeyError, match="__dynamic_rcnn__"):
        from_jax_variables({"params": {"__dynamic_rcnn__": jdyn}})
    model = tmodels.build_two_stage(cfg, device="cpu")
    tapi.load_weights(model, sd)
    assert float(model.dynamic.beta) == pytest.approx(0.3) and int(model.dynamic.step) == 0
    model.dynamic.step.fill_(7)
    save_train_state(str(tmp_path), {"model": model.state_dict(), "momentum": {}, "step": 7},
                     {"epoch": 0})
    state, _ = load_train_state(str(tmp_path))
    for k, v in model.state_dict().items():
        assert torch.equal(state["model"][k], v), k
    path = str(tmp_path / "frcnn.ckpt")
    torch.save({k: v for k, v in sd.items() if not k.startswith("dynamic.")}, path)
    fresh = tmodels.build_two_stage(cfg, device="cpu")
    tapi.load_weights(fresh, load_model_state_dict(path, "dynamic_rcnn"))
    for k, v in tmodels.DynamicState(cfg).named_buffers():
        assert torch.equal(getattr(fresh.dynamic, k), v), k
    with pytest.raises(RuntimeError, match="Missing key"):
        tapi.load_weights(fresh, {k: v for k, v in sd.items() if "rpn" not in k})


@pytest.mark.parametrize("n", [4, 5, 100, 1])
def test_even_median_matches_jnp(n):
    """jnp.median of an even-length history is the mean of the two middle
    values, (lo + hi) * 0.5, where torch.median returns the lower one."""
    x = np.random.RandomState(n).rand(n).astype(np.float32) * 3
    got = tts.even_median(_t(x))
    assert float(got) == float(jnp.median(jnp.asarray(x)))
    if n % 2 == 0:
        assert float(got) != float(torch.median(_t(x)))


# --- the train steps under JAX's uniforms -------------------------------------------------

def jax_draws(key, n):
    kp, kn = jax.random.split(key)
    return (np.asarray(jax.random.uniform(kp, (n,))), np.asarray(jax.random.uniform(kn, (n,))))


def _per_image(key, b, n):
    draws = [jax_draws(k, n) for k in jax.random.split(key, b)]
    return tuple(torch.from_numpy(np.stack([d[i] for d in draws])) for i in range(2))


def jax_uniforms(key, b, cfg, cascade=False):
    """A port `uniforms` source holding the draws of the JAX step's key tree."""
    k_rpn, k_roi = jax.random.split(key)
    out = {"rpn": _per_image(k_rpn, b, N_ANCHOR)}
    if cascade:
        n = cfg.max_gt + cfg.rpn.train_max_per_img
        for stage in range(cfg.num_stages):
            k_roi, k = jax.random.split(k_roi)
            out[f"roi{stage}"] = _per_image(k, b, n)
            n = cfg.max_gt + cfg.rcnn.sampler_num
    else:
        out["roi"] = _per_image(k_roi, b, cfg.max_gt + cfg.rpn.train_max_per_img)

    def uniforms(stage, n, k):
        assert out[stage][0].shape[1] == n and len(out[stage]) == k, (stage, n, k)
        return out[stage]

    return uniforms


JSTEPS = {"cascade_rcnn": jts.make_cascade_train_step,
          "dynamic_rcnn": jts.make_dynamic_rcnn_train_step,
          "double_head_rcnn": jts.make_double_head_train_step}
N_STEPS = {"cascade_rcnn": 2, "dynamic_rcnn": 5, "double_head_rcnn": 2}


@functools.lru_cache(maxsize=None)
def _train(family):
    """N_STEPS[family] SGD steps in each package from the shared weights on
    one batch, the port's samplers on JAX's draws: per step (JAX aux, port
    aux, JAX state as a port state_dict, port state_dict)."""
    from aod_meh_hua_tpu.utils.config import TrainConfig as JTrainConfig

    jmodel, variables, _ = two_stage_pair(family)
    jc, tc = jcfg.ZOO_FAMILIES[family][1](), tcfg.ZOO_FAMILIES[family][1]()
    arrays = two_stage_batch(jc, seed=1)
    state, tx = jcreate_state(jmodel, jax.tree_util.tree_map(jnp.asarray, variables),
                              JTrainConfig(batch_size=2), frozen_stages=jc.frozen_stages)
    state = jax.device_put(state, jax.devices()[0])
    jstep = JSTEPS[family](jmodel, jc, tx)
    model = tmodels.build_two_stage(tc, device="cpu")
    tapi.load_weights(model, from_jax_variables(variables))
    initial = {k: v.clone() for k, v in model.state_dict().items()}
    opt = tcreate_state(model, tcfg.TrainConfig(batch_size=2), frozen_stages=tc.frozen_stages)
    tstep = tts.make_two_stage_train_step(model, tc, opt, device="cpu")
    out = []
    for i in range(N_STEPS[family]):
        key = jax.random.PRNGKey(30 + i)
        state, jaux = jstep(state, JBatch(*(jnp.asarray(a) for a in arrays)), key)
        taux = tstep(TBatch(*arrays), uniforms=jax_uniforms(key, 2, tc, family == "cascade_rcnn"))
        want = from_jax_variables({"params": jax.device_get(state.params),
                                   "batch_stats": jax.device_get(state.batch_stats)})
        if family == "dynamic_rcnn":
            want["dynamic.step"] = torch.tensor(int(state.step))
        out.append(({k: float(v) for k, v in jaux.items()},
                    {k: float(v) for k, v in taux.items()}, want,
                    {k: v.clone() for k, v in model.state_dict().items()}))
    return initial, out


@pytest.mark.parametrize("family", FAMILIES)
def test_train_steps_losses_match_jax(family):
    _, out = _train(family)
    for i, (jaux, taux, _, _) in enumerate(out):
        assert set(taux) == set(jaux), (set(taux) ^ set(jaux))
        for name in jaux:
            tol = 1e-6 if name in ("iou_thr", "beta") else 0
            np.testing.assert_allclose(taux[name], jaux[name], rtol=1e-4, atol=tol,
                                       err_msg=f"step {i} {name}")
        assert jaux["num_pos"] > 0 and np.isfinite(taux["loss"])


@pytest.mark.parametrize("family", FAMILIES)
def test_train_steps_params_match_jax(family):
    """After each step every tensor within 1e-4 of its max-abs of JAX's
    (the double head's BN running statistics included); the frozen stem
    and layer1 unchanged; the heads moved."""
    initial, out = _train(family)
    for i, (_, _, want, got) in enumerate(out):
        assert set(got) == set(want)
        for name, w in want.items():
            if name.startswith("dynamic."):
                continue
            scale = max(w.abs().max().item(), 1e-12)
            err = (got[name] - w).abs().max().item()
            assert err <= 1e-4 * scale, (i, name, err, scale)
    last = out[-1][3]
    for name, v in initial.items():
        if name.startswith("dynamic."):
            continue
        frozen = name.startswith(("backbone.conv1", "backbone.bn1", "backbone.layer1"))
        moved_by_bn = "running_" in name and name.startswith("bbox_head")
        assert torch.equal(last[name], v) == (frozen or ("running_" in name and not moved_by_bn)), \
            name


def test_dynamic_statistics_match_jax_across_a_refresh():
    """Five steps at interval 4: the threshold and beta equal JAX's within
    1e-6 after every step, the rings to rtol 1e-5 (each entry a statistic
    of that step's proposals and targets, which after an SGD step sit an
    ulp or two from JAX's, as test_train_steps_params_match_jax allows);
    the refresh after the fourth moved the threshold; the ring slot is
    the step counter's."""
    _, out = _train("dynamic_rcnn")
    for i, (_, _, want, got) in enumerate(out):
        for k in ("iou_thr", "beta"):
            np.testing.assert_allclose(got[f"dynamic.{k}"].numpy(), want[f"dynamic.{k}"].numpy(),
                                       rtol=0, atol=1e-6, err_msg=f"step {i} {k}")
        for k in ("iou_hist", "beta_hist"):
            np.testing.assert_allclose(got[f"dynamic.{k}"].numpy(), want[f"dynamic.{k}"].numpy(),
                                       rtol=1e-5, atol=0, err_msg=f"step {i} {k}")
        assert int(got["dynamic.step"]) == int(want["dynamic.step"]) == i + 1
    cfg = tcfg.tiny_dynamic_rcnn_config()
    assert out[2][3]["dynamic.iou_thr"] == cfg.rcnn.pos_iou_thr  # no refresh before slot 3
    assert out[3][3]["dynamic.iou_thr"] != cfg.rcnn.pos_iou_thr
    assert out[4][1]["iou_thr"] == float(out[3][3]["dynamic.iou_thr"])


def test_cascade_samples_match_jax_index_for_index():
    """Each cascade stage's RoI sample, from JAX's stage-1 proposals and
    refined boxes under JAX's draws: the same RoIs, labels, masks and gt
    rows per stage, the refinement dropping the gt rows."""
    _, _, model = two_stage_pair("cascade_rcnn")
    jc, tc = jcfg.tiny_cascade_config(), tcfg.tiny_cascade_config()
    images, gtb, gtl, gtv, av, shapes = two_stage_batch(jc, seed=1)
    with torch.no_grad():  # the port's proposals (held to JAX's in test_torch_two_stage.py)
        _, rpn_cls, rpn_reg = model(_t(images))
        props, _, pvalid = tts.make_proposal_fn(tc)(
            rpn_cls, rpn_reg, _t(tts.anchor_table(tc)), _t(shapes), tc.rpn.train_nms_pre,
            tc.rpn.train_max_per_img)
    props, pvalid = jnp.asarray(props.numpy()), jnp.asarray(pvalid.numpy())
    key = jax.random.PRNGKey(5)
    uniforms = jax_uniforms(key, 2, tc, cascade=True)
    _, k_roi = jax.random.split(key)
    rng = np.random.RandomState(2)
    tprops, tvalid = _t(props), _t(pvalid)
    for stage in range(jc.num_stages):
        k_roi, k = jax.random.split(k_roi)
        js = jax.jit(jax.vmap(functools.partial(
            jts._roi_sample_single, cfg=jc, pos_iou_thr=jc.stage_pos_iou_thrs[stage],
            stds=jc.stage_stds[stage])))(
            jax.random.split(k, 2), props, pvalid, jnp.asarray(gtb), jnp.asarray(gtl),
            jnp.asarray(gtv))
        n = jc.max_gt + props.shape[1]
        ts_ = tts.roi_sample(uniforms(f"roi{stage}", n, 2), tprops, tvalid, _t(gtb),
                             _t(gtl).long(), _t(gtv), tc, pos_iou_thr=tc.stage_pos_iou_thrs[stage],
                             stds=tc.stage_stds[stage])
        for name in ("labels", "is_pos", "valid", "is_gt", "gt_idx"):
            np.testing.assert_array_equal(getattr(ts_, name).numpy(),
                                          np.asarray(getattr(js, name)), err_msg=(stage, name))
        np.testing.assert_array_equal(ts_.rois.numpy(), np.asarray(js.rois))
        np.testing.assert_allclose(ts_.bbox_targets.numpy(), np.asarray(js.bbox_targets),
                                   rtol=1e-5, atol=1e-6)
        assert ts_.is_pos.sum() > ts_.is_gt.sum() > 0
        # the same refinement on both sides, from one set of deltas: each
        # positive moved halfway to its gt, every RoI jittered
        d = (np.asarray(js.bbox_targets) * 0.5
             + rng.randn(2, ts_.rois.shape[1], 4) * 0.02).astype(np.float32)
        props = jts.delta_decode(js.rois, jnp.asarray(d), stds=jc.stage_stds[stage],
                                 max_shape=jnp.asarray(shapes)[:, None, :])
        pvalid = js.valid & ~js.is_gt
        tprops = tts.delta_decode(ts_.rois, _t(d), stds=tc.stage_stds[stage],
                                  max_shape=_t(shapes)[:, None, :])
        tvalid = ts_.valid & ~ts_.is_gt
        np.testing.assert_allclose(tprops.numpy(), np.asarray(props), rtol=1e-6, atol=1e-4)
        np.testing.assert_array_equal(tvalid.numpy(), np.asarray(pvalid))
        props = jnp.asarray(tprops.numpy())  # one input for the next stage
