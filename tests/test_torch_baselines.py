"""The port's baseline scorers (aod_meh_hua_torch/al/baselines.py, the
channel dropout of the models, al/uncertainty.py score_num_objects) and
the deep-ensemble mode of its AL driver and CLI against the JAX
package's, on the CPU, f32.

Weights: tests/torch_parity.py jax_retinanet draws on the tiny config,
carried to the port with models/convert.py from_jax_variables; the cls
head is sharpened (its kernel x150, logits of std ~1.5) so that the
members disagree by more than rounding.

Tolerances:
- Ensemble step: rtol 1e-4 and an atol of 1e-6 x the mean total entropy
  (epistemic is a difference of two entropies of that size), against the
  JAX step and against the float64 numpy transcription of
  tests/test_baselines.py; identical members give 0 to 1e-6.
- The log's clamp: the port clamps at the smallest normal float32, the
  JAX package at 1e-38, a subnormal that XLA flushes to 0, so JAX gives
  NaN below a logit of about -87.3. The port is finite everywhere and
  equal to JAX wherever JAX is finite; the test asserts JAX's NaN, so
  that the divergence stays visible (ROADMAP Queue 3).
- MC dropout: on shared per-pass logits, _scale_mean_epistemic to rtol
  1e-5. Torch's and JAX's generators give other masks from one seed, so
  the dropout itself is held to its definition, not to JAX's masks.
- score_num_objects: exact.
- The ensemble driver: the seeds are the JAX driver's formulas
  (al/loop.py:387-417). Trained weights part between the packages (the
  jitted JAX step breaks exact IoU ties otherwise, ROADMAP Queue 3), so
  the sweep is held through both packages' score_pool_ensemble from
  shared member weights, to rtol 1e-4.
"""

import contextlib
import io
import os

import jax
import numpy as np
import pytest
import torch

from aod_meh_hua_tpu.al import baselines as jbase
from aod_meh_hua_tpu.al.uncertainty import score_num_objects as jscore_num_objects
from aod_meh_hua_tpu.data import EvalLoader as JEvalLoader
from aod_meh_hua_tpu.data import PipelineConfig as JPipelineConfig
from aod_meh_hua_tpu.data.voc import VOCDataset as JVOCDataset
from aod_meh_hua_tpu.engine.batch import EvalBatch as JEvalBatch
from aod_meh_hua_tpu.utils.config import tiny_test_config as jtiny
from aod_meh_hua_torch.al import baselines as tbase
from aod_meh_hua_torch.al import loop as tloop
from aod_meh_hua_torch.al.uncertainty import score_num_objects
from aod_meh_hua_torch.data.loader import EvalLoader
from aod_meh_hua_torch.data.pipeline import PipelineConfig
from aod_meh_hua_torch.data.voc import VOCDataset
from aod_meh_hua_torch.engine.batch import EvalBatch
from aod_meh_hua_torch.models.convert import from_jax_variables
from aod_meh_hua_torch.models.detector import build_retinanet
from aod_meh_hua_torch.models.resnet import channel_dropout
from aod_meh_hua_torch.tools import train_retinanet as tcli
from aod_meh_hua_torch.utils.config import ALConfig, TrainConfig
from aod_meh_hua_torch.utils.config import tiny_test_config as ttiny

from torch_parity import few_threads  # noqa: F401 (the fixture of pytestmark)
from torch_parity import jax_retinanet, mini_voc, numerics_flags_kept, sharpen

pytestmark = pytest.mark.usefixtures("few_threads")

SHARPEN = 150.0
SEEDS = (1, 2, 3)


@pytest.fixture(scope="module")
def members():
    """Three JAX members from distinct seeds, sharpened, and their port
    counterparts on the CPU."""
    jmodel, _ = jax_retinanet()
    jvars = [sharpen(jax_retinanet(seed)[1], SHARPEN) for seed in SEEDS]
    tmodels = []
    for v in jvars:
        m = build_retinanet(ttiny(), device="cpu")
        m.load_state_dict(from_jax_variables(v))
        tmodels.append(m)
    return jmodel, jvars, tmodels


def _batch(orientation, b=2, seed=0):
    h, w = jtiny().for_orientation(orientation).canvas
    rng = np.random.RandomState(seed)
    return (rng.randn(b, h, w, 3).astype(np.float32) * 0.5,
            np.tile([[h, w]], (b, 1)).astype(np.int32), np.ones((b, 4), np.float32),
            np.ones(b, bool))


def _transcription(logits, bounds):
    """tests/test_baselines.py's numpy transcription of ComputeMI in
    float64: logits [M, B, A, C] -> ([B] epistemic, mean total entropy)."""
    preds = 1.0 / (1.0 + np.exp(-logits.astype(np.float64)))
    out, totals = [], []
    for b in range(preds.shape[1]):
        per_scale = []
        for s0, s1 in bounds:
            p = preds[:, b, s0:s1]
            avg = p.mean(0)
            total = -(avg * np.log(avg)).sum(-1)
            ale = (-(p * np.log(p)).sum(-1)).mean(0)
            per_scale.append((total - ale).mean())
            totals.append(total.mean())
        out.append(np.mean(per_scale))
    return np.array(out), float(np.mean(totals))


@pytest.mark.parametrize("orientation", ["landscape", "portrait"])
def test_ensemble_step_matches_jax_and_transcription(members, orientation):
    jmodel, jvars, tmodels = members
    cfg_j, cfg_t = jtiny().for_orientation(orientation), ttiny().for_orientation(orientation)
    arrays = _batch(orientation)
    want = np.asarray(jbase.make_ensemble_score_step(jmodel, cfg_j)(jvars, JEvalBatch(*arrays)))
    got = tbase.make_ensemble_score_step(tmodels, cfg_t, device="cpu")(EvalBatch(*arrays))
    got = got.numpy()
    with torch.no_grad():
        logits = np.stack([m(torch.from_numpy(arrays[0]), with_meh=False)[0].numpy()
                           for m in tmodels])
    oracle, mean_total = _transcription(logits, cfg_t.level_bounds())
    atol = 1e-6 * mean_total
    assert got.shape == (2,) and (oracle > 100 * atol).all()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=atol)
    np.testing.assert_allclose(got, oracle, rtol=1e-4, atol=atol)


def test_identical_members_score_zero(members):
    _, _, tmodels = members
    got = tbase.make_ensemble_score_step([tmodels[0]] * 3, ttiny(), device="cpu")(
        EvalBatch(*_batch("landscape")))
    np.testing.assert_allclose(got.numpy(), 0.0, atol=1e-6)


def test_sig_entropy_clamps_at_a_normal_float():
    """Logits of -120 and -95 make JAX's clamp constant (1e-38, flushed to
    0) give NaN; the port's stays finite, and both agree elsewhere."""
    logits = np.array([[-120.0], [-95.0], [-80.0], [-50.0]], np.float32)
    logits = np.concatenate([logits, np.zeros_like(logits)], axis=1)  # a second class at 0
    jax_h = np.asarray(jbase._sig_entropy(jax.numpy.asarray(logits)))
    port_h = tbase._sig_entropy(torch.from_numpy(logits)).numpy()
    assert np.isfinite(port_h).all()
    assert np.isnan(jax_h[:2]).all(), "JAX's subnormal clamp no longer gives NaN"
    np.testing.assert_allclose(port_h[2:], jax_h[2:], rtol=1e-6)
    s = np.asarray(jax.nn.sigmoid(jax.numpy.asarray(logits)))
    assert np.isfinite(tbase._scale_mean_epistemic(
        torch.from_numpy(s)[None], torch.from_numpy(port_h)[None], 1, [(0, 4)])).all()


def test_scale_mean_epistemic_matches_jax_on_shared_passes():
    rng = np.random.RandomState(4)
    passes = (rng.randn(5, 2, 60, 6) * 3).astype(np.float32)
    bounds = [(0, 36), (36, 54), (54, 60)]
    jsig = sum(jax.nn.sigmoid(jax.numpy.asarray(p)) for p in passes)
    jh = sum(jbase._sig_entropy(jax.numpy.asarray(p)) for p in passes)
    want = np.asarray(jbase._scale_mean_epistemic(jsig, jh, len(passes), bounds))
    tsig = sum(torch.sigmoid(torch.from_numpy(p)) for p in passes)
    th = sum(tbase._sig_entropy(torch.from_numpy(p)) for p in passes)
    got = tbase._scale_mean_epistemic(tsig, th, len(passes), bounds).numpy()
    assert (want > 0).all()
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_mc_dropout_step(members):
    """At rate 0 the passes are identical and the score is that of one
    repeated member, 0; at rate 0.1 the passes disagree, and two
    generator seeds give two estimates."""
    _, _, tmodels = members
    arrays = EvalBatch(*_batch("landscape"))
    plain = tbase.make_mc_dropout_score_step(tmodels[0], ttiny(), num_passes=3, device="cpu")
    g = torch.Generator().manual_seed(0)
    u0 = plain(arrays, g)
    same = tbase.make_ensemble_score_step([tmodels[0]] * 3, ttiny(), device="cpu")(arrays)
    torch.testing.assert_close(u0, same, rtol=0, atol=0)
    np.testing.assert_allclose(u0.numpy(), 0.0, atol=1e-6)

    mc_cfg = ttiny(mc_dropout=0.1)
    mc = build_retinanet(mc_cfg, device="cpu")
    mc.load_state_dict(tmodels[0].state_dict())  # dropout adds no parameter
    step = tbase.make_mc_dropout_score_step(mc, mc_cfg, num_passes=3, device="cpu")
    u1 = step(arrays, torch.Generator().manual_seed(0)).numpy()
    u1b = step(arrays, torch.Generator().manual_seed(0)).numpy()
    u2 = step(arrays, torch.Generator().manual_seed(7)).numpy()
    assert np.isfinite(u1).all() and (u1 > 0).all()
    np.testing.assert_array_equal(u1, u1b)
    assert not np.allclose(u1, u2)
    with pytest.raises(ValueError, match="torch.Generator"):
        step(arrays, None)


def test_channel_dropout():
    """Dropout2d: whole (image, channel) maps zeroed, the rest scaled by
    1 / (1 - p); the drop share within 5 binomial standard deviations;
    the same generator seed gives the same masks. A block with dropout
    is refused the fused path (the JAX model's gate)."""
    p = 0.3
    x = torch.rand(16, 64, 5, 7) + 0.5
    y = channel_dropout(x, p, torch.Generator().manual_seed(3))
    dropped = (y == 0).all(dim=(2, 3))
    kept = ~dropped
    assert ((y != 0) == kept[..., None, None]).all()
    torch.testing.assert_close(y[kept], x[kept] / (1 - p), rtol=1e-6, atol=0)
    n = dropped.numel()
    share = dropped.float().mean().item()
    assert abs(share - p) <= 5 * np.sqrt(p * (1 - p) / n)
    y2 = channel_dropout(x, p, torch.Generator().manual_seed(3))
    assert torch.equal(y, y2)
    assert channel_dropout(x, 0.0, None) is x

    fused = build_retinanet(ttiny(fused_blocks=True, mc_dropout=0.1, block_counts=(2, 2, 1, 1),
                                  stem_width=32), device="cpu")
    blocks = [m for m in fused.backbone.modules() if hasattr(m, "fused_eligible")]
    assert blocks and not any(b.fused_eligible(b.conv1.in_channels) for b in blocks)


def test_score_num_objects_matches_jax(tmp_path):
    base = mini_voc(tmp_path)
    split = os.path.join(base, "ImageSets/Main/trainval.txt")
    tds, jds = VOCDataset(split, base), JVOCDataset(split, base)
    idx = np.arange(len(tds))
    got, want = score_num_objects(tds, idx), jscore_num_objects(jds, idx)
    assert got.dtype == np.float64 and (got > 0).all()
    np.testing.assert_array_equal(got, want)


# --- the ensemble driver -------------------------------------------------------

@pytest.fixture(scope="module")
def voc(tmp_path_factory):
    return mini_voc(tmp_path_factory.mktemp("ensvoc"))


@pytest.fixture(scope="module")
def ensemble_run(voc, tmp_path_factory):
    """The port CLI's --mini --cpu run with the deep-ensemble baseline of
    two members, its model seeds, loader seeds and log recorded."""
    seeds, loaders, out = [], [], io.StringIO()
    real_init, real_loader = tloop.ALDriver._init_model, tloop.TrainLoader

    def init(self, seed):
        seeds.append(seed)
        return real_init(self, seed)

    def loader(dataset, x_l, *args, seed, **kwargs):
        loaders.append(int(seed))
        return real_loader(dataset, x_l, *args, seed=seed, **kwargs)

    work = str(tmp_path_factory.mktemp("ens_work"))
    with pytest.MonkeyPatch.context() as mp, numerics_flags_kept():
        mp.setattr(tloop.ALDriver, "_init_model", init)
        mp.setattr(tloop, "TrainLoader", loader)
        with contextlib.redirect_stdout(out):
            driver = tcli.main(["--mini", "--cpu", "--voc07", voc, "--work-dir", work,
                               "--baseline", "ensemble", "--ensemble-size", "2",
                               "--no-validate"])
    return driver, work, seeds, loaders, out.getvalue().splitlines()


def test_ensemble_driver_runs_members_with_the_jax_seeds(ensemble_run):
    """Member m of cycle c starts from seed + c + 10_000 m and trains run
    ri with seed + 100 c + ri + 10_000 m (JAX al/loop.py:387-417); the
    last cycle scores nothing, so trains no member."""
    driver, work, seeds, loaders, log = ensemble_run
    s = 20
    assert seeds == [s, s + 10_000, s + 1]
    assert loaders == [s, s + 1, s + 10_000, s + 10_001, s + 100, s + 101]
    assert any("ensemble member 2/2" in line for line in log)
    assert driver.baseline == "ensemble" and driver.ensemble_size == 2
    x_l0, x_l1 = (np.load(os.path.join(work, f"X_L_{c}.npy")) for c in (0, 1))
    assert set(x_l0) < set(x_l1) and len(x_l1) == len(x_l0) + driver.al.x_s_size
    unc = np.load(os.path.join(work, "Unc_1.npy"))
    assert unc.shape == (len(driver.pool),) and np.isfinite(unc).all() and (unc > 0).any()
    assert [t["member"] for t in driver.timings if t["phase"] == "ensemble_member"] == [1]


def test_ensemble_driver_refuses_maxconf(voc, tmp_path):
    paths = tloop.ALPaths(voc07=voc, voc12=None, work_dir=str(tmp_path))
    with pytest.raises(ValueError, match="use_max_conf"):
        tloop.ALDriver(ttiny(), TrainConfig(), ALConfig(use_max_conf="min"), paths,
                       baseline="ensemble", device="cpu")
    with pytest.raises(ValueError, match="unknown baseline"):
        tloop.ALDriver(ttiny(), TrainConfig(), ALConfig(), paths, baseline="mcdropout",
                       device="cpu")


def test_ensemble_sweep_matches_jax_on_shared_members(members, voc):
    """Both packages' score_pool_ensemble over the mini pool's landscape
    images (the step tests hold both orientations), through their loaders
    with the driver's --mini pipeline, from the same two members; the
    other images keep 0 in both."""
    jmodel, jvars, tmodels = members
    split = os.path.join(voc, "ImageSets/Main/trainval.txt")
    tds, jds = VOCDataset(split, voc), JVOCDataset(split, voc)
    n = len(tds)
    idx = np.array([i for i in range(n) if tds.aspect_flag(i)])
    jcfg, tcfg = jtiny(), ttiny()
    jpipe = JPipelineConfig(img_scale=(250, 120), canvas=jcfg.canvas, device_normalize=True)
    tpipe = PipelineConfig(img_scale=(250, 120), canvas=tcfg.canvas, device_normalize=True)
    want = jbase.score_pool_ensemble(
        jmodel, jvars[:2], jcfg, JEvalLoader(jds, idx, jpipe, batch_size=8), n)
    got = tbase.score_pool_ensemble(
        tmodels[:2], tcfg, EvalLoader(tds, idx, tpipe, batch_size=8), n, device="cpu")
    assert got.shape == (n,) and len(idx) == 12 and (want[idx] > 0).all()
    np.testing.assert_array_equal(got == 0, want == 0)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=0)
