"""The port's SSD CLI (aod_meh_hua_torch/tools/train_ssd.py through
al/loop.py's SSD branch) against the JAX package's SSD driver, on the
CPU, on the synthetic mini VOC of tests/test_al_loop.py; and the
numerics both CLIs pin.

The SSD criterion: the port CLI's 2-cycle `--mini --cpu` run acquires the
same images as the JAX driver built with exactly the settings that the
JAX SSD CLI's --mini builds (tools/train_ssd.py:101-133: SSDConfig(width
0.125, max_gt 8), the SSD TrainConfig (batch 8, warmup 500 at 1e-3,
lr_step_epoch 1) with outer_epoch 1, epoch_ratio (1,) and no warmup, the
SSD ALConfig (11 cycles of 1000, repeats 16) with cycles (0, 1),
x_l_0_size 4, x_s_size 2, x_l_repeat 1, score_batch_size 8; seed 20,
zero_rate 0.15, name ssd_meh). The JAX driver is built in process rather
than through the JAX CLI's main(), whose jax.config updates would
outlive the test. Both start each cycle from the same weights: the JAX
package's init_ssd(cfg, PRNGKey(seed)), carried to the port with
models/convert.py from_jax_variables. Both drivers' schedules (every lr
set, each run's loader seed and indices) must be equal.

Tolerances: X_L_0 and X_L_1 identical; Unc_1 with the same exact-zero
set, and within rtol 1e-3 when the port sweeps with the JAX run's cycle-0
weights (not from its own: see test_ssd_cli_acquires_the_same_images_as_jax);
mAPs within 1e-4; the runs' mean losses within rtol 1e-3. The port's SSD
augment chain and float resize are bit-equal to the JAX package's OpenCV
calls (tests/test_torch_ssd_data.py), so both trainings see the same
batches.
A second check gives the sweeps teeth: both drivers score the pool and
evaluate the test split from one set of weights, the JAX run's final
ones with the foreground rows of the cls head scaled by 2, and acquire
from those scores with one RNG state (training left out, as in
tests/test_torch_al_loop.py).
"""

import json
import os
from types import SimpleNamespace

import flax.serialization
import jax
import numpy as np
import pytest
import torch

from aod_meh_hua_tpu.al import ALDriver as JALDriver
from aod_meh_hua_tpu.al import ALPaths as JALPaths
from aod_meh_hua_tpu.al import loop as jloop
from aod_meh_hua_tpu.al.uncertainty import score_pool as jscore_pool
from aod_meh_hua_tpu.data import EvalLoader as JEvalLoader
from aod_meh_hua_tpu.models.ssd_detector import build_ssd as jbuild_ssd
from aod_meh_hua_tpu.utils.config import ALConfig as JALConfig
from aod_meh_hua_tpu.utils.config import SSDConfig as JSSDConfig
from aod_meh_hua_tpu.utils.config import TrainConfig as JTrainConfig
from aod_meh_hua_torch.al import loop as tloop
from aod_meh_hua_torch.al.uncertainty import score_pool as tscore_pool
from aod_meh_hua_torch.data import splits as tsplits
from aod_meh_hua_torch.data.loader import EvalLoader
from aod_meh_hua_torch.engine import checkpoint as tckpt
from aod_meh_hua_torch.models.convert import from_jax_variables
from aod_meh_hua_torch.models.ssd_detector import build_ssd
from aod_meh_hua_torch.tools import train_retinanet, train_ssd
from aod_meh_hua_torch.utils.device import pin_numerics

from test_data import make_voc
from test_torch_al_loop import _npy, _record_schedule, _train_log
from torch_parity import few_threads  # noqa: F401 (the fixture of pytestmark)

pytestmark = pytest.mark.usefixtures("few_threads")

FG_SHARPEN = 2.0
PINNED = (False, False, True, False)  # cudnn.allow_tf32, matmul.allow_tf32, deterministic, benchmark


def _flags():
    b = torch.backends
    return (b.cudnn.allow_tf32, b.cuda.matmul.allow_tf32, b.cudnn.deterministic,
            b.cudnn.benchmark)


def _set_flags(flags):
    b = torch.backends
    b.cudnn.allow_tf32, b.cuda.matmul.allow_tf32, b.cudnn.deterministic, \
        b.cudnn.benchmark = flags


@pytest.fixture
def torch_default_flags():
    """torch's default numerics flags for the test, and whatever was set
    before it afterwards."""
    saved = _flags()
    _set_flags((True, False, False, False))
    yield
    _set_flags(saved)


@pytest.fixture(scope="module")
def mini_voc(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("ssdalvoc"))
    base, _, ids = make_voc(root, "VOC2007", n=14, seed=3)
    with open(os.path.join(base, "ImageSets/Main/test.txt"), "w") as f:
        f.write("\n".join(ids[:4]))
    return base


@pytest.fixture(scope="module")
def runs(mini_voc, tmp_path_factory):
    """The JAX SSD --mini run and the port SSD CLI's --mini --cpu run from
    the same initial weights, each with its schedule recorded."""
    saved = _flags()
    init_vars, jevents, tevents = {}, [], []
    cfg = JSSDConfig(width_mult=0.125, max_gt=8)
    # init_ssd (models/ssd_detector.py:64-69) with one jitted init for both
    # cycles' seeds: it compiles once and gives the same arrays
    jmodel = jbuild_ssd(cfg)
    jinit = jax.jit(jmodel.init)
    canvas = np.zeros((1, 300, 300, 3), np.float32)

    def jax_init(self, seed):
        variables = jinit(jax.random.PRNGKey(seed), canvas)
        init_vars[seed] = jax.tree_util.tree_map(np.asarray, variables)
        return jmodel, variables

    tcfg = JTrainConfig(batch_size=8, seed=20, outer_epoch=1, epoch_ratio=(1,), lr_step_epoch=1,
                        warmup_iters=0, warmup_ratio=1e-3)
    al = JALConfig(cycles=(0, 1), x_l_0_size=4, x_s_size=2, x_l_repeat=1, x_u_repeat=16,
                   score_batch_size=8, zero_rate=0.15)
    jwork = str(tmp_path_factory.mktemp("jax_ssd_work"))
    np.random.seed(20)
    jdriver = JALDriver(cfg, tcfg, al, JALPaths(voc07=mini_voc, voc12=None, work_dir=jwork),
                        validate=True, name="ssd_meh", log=None)
    jdriver._init_model = jax_init.__get__(jdriver)
    with pytest.MonkeyPatch.context() as mp:
        _record_schedule(mp, jloop, jevents)
        jmetrics = jdriver.run()

    def port_init(self, seed):
        model = build_ssd(self.cfg, device=self.device)
        model.load_state_dict(from_jax_variables(init_vars[seed]))
        return model

    twork = str(tmp_path_factory.mktemp("port_ssd_work"))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tloop.ALDriver, "_init_model", port_init)
        _record_schedule(mp, tloop, tevents)
        _set_flags((True, False, False, False))
        tdriver = train_ssd.main(["--mini", "--cpu", "--voc07", mini_voc, "--work-dir", twork])
        flags = _flags()
    _set_flags(saved)
    return SimpleNamespace(jwork=jwork, jmetrics=jmetrics, jdriver=jdriver, jevents=jevents,
                           twork=twork, tdriver=tdriver, tevents=tevents, flags=flags)


def test_ssd_cli_acquires_the_same_images_as_jax(runs):
    """X_L_0 and X_L_1 identical, Unc_1 with the same zero set, and the
    mAPs within 1e-4. Unc_1 itself is held through the sweep: the port's
    driver scoring the pool with the JAX run's cycle-0 weights gives the
    JAX run's Unc_1 to rtol 1e-3. The port's own cycle-0 weights are not
    the JAX run's: this mini SSD trains on losses in the thousands, and
    four f32 SGD steps carry the libraries' rounding differences (losses
    equal to 1e-7 at the first epoch) to a few percent of some bias
    tensors' max, so each run's Unc_1, a sum over ~100 objects per
    image, differs by whole objects (about 2%)."""
    jwork, twork, tdriver = runs.jwork, runs.twork, runs.tdriver
    np.testing.assert_array_equal(_npy(twork, "X_L_0"), _npy(jwork, "X_L_0"))
    np.testing.assert_array_equal(_npy(twork, "X_L_1"), _npy(jwork, "X_L_1"))
    ju, tu = _npy(jwork, "Unc_1"), _npy(twork, "Unc_1")
    np.testing.assert_array_equal(tu == 0, ju == 0)
    path = os.path.join(jwork, "model_save", "ssd_meh_Cycle0_Epoch1_mycode.ckpt")
    model = build_ssd(tdriver.cfg, device="cpu")
    model.load_state_dict(tckpt.load_model_state_dict(path, "ssd"))
    loader = EvalLoader(tdriver.pool, np.arange(len(tdriver.pool)), tdriver.pipeline,
                        batch_size=tdriver.al.score_batch_size,
                        cache=tdriver._canvas_cache("pool", tdriver.pool))
    swept, _ = tscore_pool(model, tdriver.cfg, loader, len(tdriver.pool), device="cpu")
    assert (ju > 0).sum() >= 3
    np.testing.assert_array_equal(swept == 0, ju == 0)
    np.testing.assert_allclose(swept, ju, rtol=1e-3, atol=0)
    metrics = runs.tdriver.metrics
    assert [m["cycle"] for m in metrics] == [m["cycle"] for m in runs.jmetrics] == [0, 1]
    np.testing.assert_allclose([m["mAP"] for m in metrics], [m["mAP"] for m in runs.jmetrics],
                               rtol=0, atol=1e-4)
    assert [m["n_labeled"] for m in metrics] == [m["n_labeled"] for m in runs.jmetrics]


def test_ssd_cli_schedule_matches_jax(runs):
    """Every learning rate set and every run's loader (seed, labeled
    indices), in order; train_log.jsonl's iters and lr per epoch; and
    the same mean losses, the trainings having seen the same batches."""
    assert runs.tevents == runs.jevents
    loaders = [e for e in runs.jevents if e[0] == "loader"]
    assert [e[1] for e in loaders] == [20, 21, 120, 121]
    assert _train_log(runs.twork) == _train_log(runs.jwork)
    losses = [[json.loads(line)["mean_loss"] for line in open(os.path.join(w, "train_log.jsonl"))]
              for w in (runs.twork, runs.jwork)]
    np.testing.assert_allclose(losses[0], losses[1], rtol=1e-3)


def test_ssd_cli_artifacts_and_pinned_numerics(runs):
    """What tests/test_al_loop.py::test_al_two_cycles checks, on the port
    SSD CLI's run, and the numerics flags it left (the card's: no TF32,
    deterministic cuDNN)."""
    work, driver = runs.twork, runs.tdriver
    assert runs.flags == PINNED
    assert driver.cfg.family == "ssd" and driver.name == "ssd_meh"
    assert driver.augment_fn is not None and not driver.pipeline.keep_ratio
    x_l0, x_l1 = _npy(work, "X_L_0"), _npy(work, "X_L_1")
    assert len(x_l0) == 4 and len(x_l0) < len(x_l1) <= len(x_l0) + 2
    assert set(x_l0) <= set(x_l1)
    assert np.isfinite(_npy(work, "Unc_1")).all()
    ckpts = [f for f in os.listdir(driver.paths.save_dir) if "_mycode" in f]
    assert sorted(ckpts) == ["ssd_meh_Cycle0_Epoch1_mycode.ckpt",
                             "ssd_meh_Cycle1_Epoch1_mycode.ckpt"]
    state = tckpt.load_checkpoint(tckpt.latest_path(driver.paths.save_dir))
    assert set(state) == set(driver.model.state_dict())


def test_ssd_sweeps_match_jax_on_shared_weights(runs):
    """Both drivers' pool sweep (canvas cache, loaders, the scatter to
    pool order), acquisition and eval mAP from one set of weights with
    non-zero scores: the JAX run's last, its foreground logits scaled."""
    jwork, tdriver, jdriver = runs.jwork, runs.tdriver, runs.jdriver
    path = os.path.join(jwork, "model_save", "ssd_meh_Cycle1_Epoch1_mycode.ckpt")
    with open(path, "rb") as f:
        variables = flax.serialization.msgpack_restore(f.read())
    for name, leaf in variables["params"]["head"].items():
        if name.startswith("cls_"):
            fg = (np.arange(leaf["kernel"].shape[-1]) % 21) < 20
            leaf["kernel"] = np.array(leaf["kernel"])
            leaf["bias"] = np.array(leaf["bias"])
            leaf["kernel"][..., fg] *= FG_SHARPEN
            leaf["bias"][fg] *= FG_SHARPEN
    jloader = JEvalLoader(jdriver.pool, np.arange(len(jdriver.pool)), jdriver.pipeline,
                          batch_size=8, cache=jdriver._canvas_cache("pool", jdriver.pool))
    ju, jmc = jscore_pool(jdriver.model, variables, jdriver.cfg, jloader, len(jdriver.pool),
                          steps=jdriver._score_steps_cache())
    tdriver.model.load_state_dict(from_jax_variables(variables))
    tloader = EvalLoader(tdriver.pool, np.arange(len(tdriver.pool)), tdriver.pipeline,
                         batch_size=8, cache=tdriver._canvas_cache("pool", tdriver.pool))
    tu, tmc = tscore_pool(tdriver.model, tdriver.cfg, tloader, len(tdriver.pool), device="cpu")
    assert (ju > 0).sum() >= 3, "too few non-zero scores for a real check"
    np.testing.assert_array_equal(tu == 0, ju == 0)
    np.testing.assert_allclose(tu, ju, rtol=1e-3, atol=0)
    np.testing.assert_allclose(tmc, jmc, rtol=1e-3, atol=0)
    x_all = np.random.RandomState(5).permutation(len(ju))
    picks = [tsplits.update_labeled_set(u, x_all, np.arange(4), 4, np.random.RandomState(7),
                                        zero_rate=0.5) for u in (ju, tu)]
    for a, b in zip(*picks):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(tdriver.evaluate(), jdriver.evaluate(variables), rtol=0,
                               atol=1e-4)


@pytest.mark.parametrize("flags", [["--dtype", "bfloat16"]])
def test_unported_ssd_cli_flags_raise(flags):
    """The JAX SSD CLI's flags of modes the port does not have are parsed
    and refused with their ROADMAP item, never ignored."""
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 item"):
        train_ssd.main(flags + ["--cpu", "--voc07", "unused", "--work-dir", "unused"])


@pytest.mark.parametrize("cli", [train_retinanet, train_ssd])
def test_cli_pins_the_numerics(cli, mini_voc, tmp_path, torch_default_flags):
    """main() of either CLI leaves cuDNN and matmuls without TF32 and
    cuDNN deterministic, non-benchmarking, as the reference pins them;
    from torch's defaults (the run itself is stubbed: the flags are set
    before the driver runs)."""
    assert _flags() != PINNED
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tloop.ALDriver, "run", lambda self, **kw: None)
        cli.main(["--mini", "--cpu", "--voc07", mini_voc, "--work-dir", str(tmp_path)])
    assert _flags() == PINNED
    pin_numerics()
    assert _flags() == PINNED


def test_ssd_cli_mini_settings():
    """--mini cuts the SSD CLI as the JAX SSD CLI's does, and the full
    settings are the SSD schedule."""
    seen = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tloop.ALDriver, "run", lambda self, **kw: seen.setdefault("d", self))
        mp.setattr(tloop.ALDriver, "__init__",
                   lambda self, m, t, a, p, **kw: self.__dict__.update(cfg=m, tcfg=t, al=a, kw=kw))
        saved = _flags()
        try:
            full = train_ssd.main(["--cpu", "--voc07", "v", "--work-dir", "w"])
            mini = train_ssd.main(["--mini", "--cpu", "--voc07", "v", "--work-dir", "w"])
        finally:
            _set_flags(saved)
    assert (full.tcfg.batch_size, full.tcfg.outer_epoch, full.tcfg.epoch_ratio,
            full.tcfg.lr_step_epoch, full.tcfg.warmup_iters, full.tcfg.warmup_ratio) == \
        (8, 2, (5, 1), 1, 500, 1e-3)
    assert (full.al.cycles, full.al.x_l_0_size, full.al.x_s_size, full.al.x_l_repeat,
            full.al.x_u_repeat, full.al.score_batch_size) == (tuple(range(11)), 1000, 1000, 16,
                                                              16, 64)
    assert full.cfg.width_mult == 1.0 and full.kw["name"] == "ssd_meh"
    assert (mini.cfg.width_mult, mini.cfg.max_gt, mini.tcfg.outer_epoch, mini.tcfg.epoch_ratio,
            mini.tcfg.warmup_iters) == (0.125, 8, 1, (1,), 0)
    assert (mini.al.cycles, mini.al.x_l_0_size, mini.al.x_s_size, mini.al.x_l_repeat,
            mini.al.score_batch_size) == ((0, 1), 4, 2, 1, 8)

