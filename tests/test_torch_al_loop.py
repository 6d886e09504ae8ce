"""The port's AL driver and CLI (aod_meh_hua_torch/al/loop.py,
aod_meh_hua_torch/tools/train_retinanet.py) against the JAX package's, on
the CPU, on the synthetic mini VOC of tests/test_al_loop.py.

The main-path criterion: the port CLI's 2-cycle `--mini --cpu` run
acquires the same images as the JAX driver built with exactly the
settings that the JAX CLI's --mini builds (tools/train_retinanet.py:
135-145: tiny_test_config, outer_epoch 1, epoch_ratio (1,), cycles (0, 1),
x_l_0_size 4, x_s_size 2, x_l_repeat 1, score_batch_size 8,
img_scale (250, 120), device_normalize; seed 20, zero_rate 0.15). The JAX
driver is built in process rather than through the JAX CLI's main(),
whose jax.config updates (platform, compilation cache directory) would
outlive the test in the worker process.

Both start each cycle from the same weights: the JAX package's
init_retinanet(tiny_test_config(), PRNGKey(seed)), carried to the port
with models/convert.py from_jax_variables.

Both drivers' schedules are recorded and must be equal: every learning
rate set and each run's loader (seed, labeled indices), in order. A
second pair of runs, with the train steps stubbed, covers the warmup and
the lr step, which the --mini schedule does not reach.

Tolerances: X_L_0 and X_L_1 identical; Unc_1 within rtol 1e-3 with the
same exact-zero set (two f32 implementations after a few SGD steps; the
acquisition is a top-k and a zero set, which must agree exactly); the
cycle mAPs within 1e-4.

At this size every pool score of that run is exactly 0 and both mAPs are
0 (random weights find no object), in the JAX run as in the port's, so
the acquisition there rests on the zeroRate draws alone. A second check
gives the sweeps teeth: after both runs, both drivers score the pool
(through their canvas caches) and evaluate the test split with one set
of weights, the JAX run's final ones with the cls head's kernel scaled
by 150 (logits of std ~1.5, as tests/test_torch_score.py does), and
acquire from those scores with one RNG state. Training is left out of
that check on purpose: the jitted JAX step breaks exact IoU ties in the
assigner's low-quality matches differently from eager JAX and from the
port (8 positives where both of those find 10 on one image of this
tree), so the two trainings part by more than float rounding.
"""

import dataclasses
import hashlib
import json
import os
import shutil
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
from aod_meh_hua_tpu.data import PipelineConfig as JPipelineConfig
from aod_meh_hua_tpu.models.detector import build_retinanet as jbuild_retinanet
from aod_meh_hua_tpu.utils.config import ALConfig as JALConfig
from aod_meh_hua_tpu.utils.config import TrainConfig as JTrainConfig
from aod_meh_hua_tpu.utils.config import tiny_test_config as jtiny
from aod_meh_hua_torch.al import loop as tloop
from aod_meh_hua_torch.al.uncertainty import score_pool as tscore_pool
from aod_meh_hua_torch.data import splits as tsplits
from aod_meh_hua_torch.data.loader import EvalLoader
from aod_meh_hua_torch.engine import checkpoint as tckpt
from aod_meh_hua_torch.data.pipeline import PipelineConfig as TPipelineConfig
from aod_meh_hua_torch.models.convert import from_jax_variables
from aod_meh_hua_torch.models.detector import build_retinanet
from aod_meh_hua_torch.tools import score_pool
from aod_meh_hua_torch.tools import train_retinanet as tcli
from aod_meh_hua_torch.utils.config import ALConfig as TALConfig
from aod_meh_hua_torch.utils.config import TrainConfig as TTrainConfig
from aod_meh_hua_torch.utils.config import tiny_test_config as ttiny

from torch_parity import few_threads  # noqa: F401 (the fixture of pytestmark)
from torch_parity import jax_retinanet, numerics_flags_kept
from torch_parity import mini_voc as mini_voc_tree

pytestmark = pytest.mark.usefixtures("few_threads")

CLS_SHARPEN = 150.0


@pytest.fixture(scope="module")
def mini_voc(tmp_path_factory):
    return mini_voc_tree(tmp_path_factory.mktemp("alvoc"))


def _record_schedule(mp, loop_module, events):
    """Record, in order, every learning rate the driver's runs set and
    every TrainLoader they build (run seed and labeled indices)."""
    real_set, real_loader = loop_module.set_learning_rate, loop_module.TrainLoader

    def set_lr(opt, lr):
        events.append(("lr", float(lr)))
        return real_set(opt, lr)

    def loader(dataset, x_l, *args, seed, **kwargs):
        events.append(("loader", int(seed), tuple(int(i) for i in x_l)))
        return real_loader(dataset, x_l, *args, seed=seed, **kwargs)

    mp.setattr(loop_module, "set_learning_rate", set_lr)
    mp.setattr(loop_module, "TrainLoader", loader)


def _train_log(work):
    """(iters, lr) of each epoch in train_log.jsonl."""
    with open(os.path.join(work, "train_log.jsonl")) as f:
        return [(e["iters"], e["lr"]) for e in map(json.loads, f)]


@pytest.fixture(scope="module")
def runs(mini_voc, tmp_path_factory):
    """The JAX --mini run and the port CLI's --mini --cpu run from the
    same initial weights, each with its schedule recorded."""
    init_vars = {}
    jevents, tevents = [], []

    # the JAX CLI's --mini settings (tools/train_retinanet.py:135-145)
    cfg = jtiny()
    # init_retinanet (models/detector.py:99-110) with one jitted init for
    # both cycles' seeds: it compiles once, where init_retinanet jits a
    # new model's init at each call, and gives the same arrays
    jmodel = jbuild_retinanet(cfg)
    jinit = jax.jit(jmodel.init)
    canvas = np.zeros((1, *cfg.canvas, 3), np.float32)

    def jax_init(self, seed):
        variables = jinit(jax.random.PRNGKey(seed), canvas)
        init_vars[seed] = jax.tree_util.tree_map(np.asarray, variables)
        return jmodel, variables

    tcfg = dataclasses.replace(JTrainConfig(), outer_epoch=1, epoch_ratio=(1,), seed=20)
    al = dataclasses.replace(JALConfig(), cycles=(0, 1), x_l_0_size=4, x_s_size=2,
                             x_l_repeat=1, score_batch_size=8, zero_rate=0.15)
    pipe = JPipelineConfig(img_scale=(250, 120), canvas=cfg.canvas, device_normalize=True)
    jwork = str(tmp_path_factory.mktemp("jax_work"))
    np.random.seed(20)
    jdriver = JALDriver(cfg, tcfg, al, JALPaths(voc07=mini_voc, voc12=None, work_dir=jwork),
                        pipeline=pipe, validate=True, log=None)
    jdriver._init_model = jax_init.__get__(jdriver)
    with pytest.MonkeyPatch.context() as mp:
        _record_schedule(mp, jloop, jevents)
        jmetrics = jdriver.run()

    def port_init(self, seed):
        model = build_retinanet(self.cfg, device=self.device)
        model.load_state_dict(from_jax_variables(init_vars[seed]))
        return model

    twork = str(tmp_path_factory.mktemp("port_work"))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tloop.ALDriver, "_init_model", port_init)
        _record_schedule(mp, tloop, tevents)
        with numerics_flags_kept():
            tdriver = tcli.main(["--mini", "--cpu", "--voc07", mini_voc, "--work-dir", twork])
    return SimpleNamespace(jwork=jwork, jmetrics=jmetrics, jdriver=jdriver, jevents=jevents,
                           twork=twork, tdriver=tdriver, tevents=tevents, port_init=port_init)


def _npy(work, name):
    return np.load(os.path.join(work, f"{name}.npy"))


def test_cli_acquires_the_same_images_as_jax(runs):
    jwork, jmetrics, twork, tdriver = runs.jwork, runs.jmetrics, runs.twork, runs.tdriver
    np.testing.assert_array_equal(_npy(twork, "X_L_0"), _npy(jwork, "X_L_0"))
    np.testing.assert_array_equal(_npy(twork, "X_L_1"), _npy(jwork, "X_L_1"))
    ju, tu = _npy(jwork, "Unc_1"), _npy(twork, "Unc_1")
    np.testing.assert_array_equal(tu == 0, ju == 0)
    np.testing.assert_allclose(tu, ju, rtol=1e-3, atol=0)
    assert [m["cycle"] for m in tdriver.metrics] == [m["cycle"] for m in jmetrics]
    np.testing.assert_allclose([m["mAP"] for m in tdriver.metrics],
                               [m["mAP"] for m in jmetrics], rtol=0, atol=1e-4)
    assert [m["n_labeled"] for m in tdriver.metrics] == [m["n_labeled"] for m in jmetrics]


def test_cli_schedule_matches_jax(runs):
    """The --mini runs' schedule: every learning rate set and every run's
    loader (seed tcfg.seed + cycle * 100 + ri, labeled indices), in
    order, and train_log.jsonl's iters and lr per epoch."""
    assert runs.tevents == runs.jevents
    loaders = [e for e in runs.jevents if e[0] == "loader"]
    assert [e[1] for e in loaders] == [20, 21, 120, 121]  # outer_epoch 1: two runs
    assert _train_log(runs.twork) == _train_log(runs.jwork)


LOSS_KEYS = ("loss", "loss_cls", "loss_bbox", "loss_meh")


def _batch_digest(batch):
    return tuple(hashlib.sha256(np.ascontiguousarray(np.asarray(a)).tobytes()).hexdigest()
                 for a in batch)


def test_train_schedule_matches_jax_with_warmup_and_lr_step(mini_voc, tmp_path):
    """The branches of the run schedule that --mini does not reach: three
    runs of three epochs (outer_epoch 2), a linear warmup over 5
    iterations that restarts with each run and ends inside its third
    epoch, and the x0.1 step from epoch 1 of the final run only, in cycle
    3 (run seeds 7 + 300 + ri). Both drivers' train steps are stubbed
    (a unit loss; they record the orientation and the batch's arrays),
    so the schedules and the loader streams fed to the steps are
    compared, not the trainings."""
    tkw = dict(batch_size=2, outer_epoch=2, epoch_ratio=(3,), lr=0.01, lr_step_epoch=1,
               warmup_iters=5, warmup_ratio=0.1, ckpt_interval=0, seed=7)
    akw = dict(cycles=(3,), x_l_0_size=4, x_s_size=2, x_l_repeat=1, score_batch_size=4)
    events = {"jax": [], "port": []}

    def jstep(self, orientation):
        def step(state, batch):
            events["jax"].append(("step", orientation, _batch_digest(batch)))
            return state, {k: np.float32(1.0) for k in LOSS_KEYS}
        return step

    def tstep(self, orientation):
        def step(batch):
            events["port"].append(("step", orientation, _batch_digest(batch)))
            return {k: torch.ones(()) for k in LOSS_KEYS}
        return step

    jwork, twork = str(tmp_path / "jax"), str(tmp_path / "port")
    with pytest.MonkeyPatch.context() as mp:
        _record_schedule(mp, jloop, events["jax"])
        _record_schedule(mp, tloop, events["port"])
        mp.setattr(JALDriver, "_train_step", jstep)
        mp.setattr(JALDriver, "_init_model", lambda self, seed: jax_retinanet(seed))
        mp.setattr(tloop.ALDriver, "_train_step", tstep)
        cfg = jtiny()
        JALDriver(cfg, JTrainConfig(**tkw), JALConfig(**akw),
                  JALPaths(voc07=mini_voc, voc12=None, work_dir=jwork),
                  pipeline=JPipelineConfig(img_scale=(250, 120), canvas=cfg.canvas),
                  validate=False, log=None).run()
        tcfg = ttiny()
        tloop.ALDriver(tcfg, TTrainConfig(**tkw), TALConfig(**akw),
                       tloop.ALPaths(voc07=mini_voc, voc12=None, work_dir=twork),
                       pipeline=TPipelineConfig(img_scale=(250, 120), canvas=tcfg.canvas),
                       validate=False, log=None, device="cpu").run()

    assert events["port"] == events["jax"]
    kinds = [e[0] for e in events["jax"]]
    assert kinds.count("loader") == 3 and kinds.count("step") == 18
    assert [e[1] for e in events["jax"] if e[0] == "loader"] == [307, 308, 309]
    assert _train_log(twork) == _train_log(jwork)
    assert [lr for _, lr in _train_log(jwork)] == [0.01] * 7 + [0.001] * 2
    # the first run, 2 iterations an epoch: each epoch sets its lr, then
    # each warmup iteration k sets lr * (1 - (1 - k/5)(1 - 0.1)), and
    # iteration 5 sets the lr back
    lrs = [e[1] for e in events["jax"] if e[0] == "lr"]
    warm = [0.01 * (1 - (1 - k / 5) * (1 - 0.1)) for k in range(5)]
    assert lrs[:9] == [0.01, warm[0], warm[1], 0.01, warm[2], warm[3], 0.01, warm[4], 0.01]


def test_sweeps_match_jax_on_shared_weights(runs):
    """Both drivers' pool sweep (canvas cache, loaders, the scatter to
    pool order), acquisition and eval mAP from one set of weights with
    non-zero scores."""
    jwork, tdriver, jdriver = runs.jwork, runs.tdriver, runs.jdriver
    path = os.path.join(jwork, "model_save", "retinanet_meh_Cycle1_Epoch1_mycode.ckpt")
    with open(path, "rb") as f:
        variables = flax.serialization.msgpack_restore(f.read())
    head = variables["params"]["head"]["retina_cls"]
    head["kernel"] = np.asarray(head["kernel"]) * np.float32(CLS_SHARPEN)

    jloader = JEvalLoader(jdriver.pool, np.arange(len(jdriver.pool)), jdriver.pipeline,
                          batch_size=8, cache=jdriver._canvas_cache("pool", jdriver.pool))
    ju, jmc = jscore_pool(jdriver.model, variables, jdriver.cfg, jloader, len(jdriver.pool),
                          steps=jdriver._score_steps_cache())
    tdriver.model.load_state_dict(from_jax_variables(variables))
    tloader = EvalLoader(tdriver.pool, np.arange(len(tdriver.pool)), tdriver.pipeline,
                         batch_size=8, cache=tdriver._canvas_cache("pool", tdriver.pool))
    tu, tmc = tscore_pool(tdriver.model, tdriver.cfg, tloader, len(tdriver.pool),
                          device="cpu")
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


def test_cli_artifacts(runs):
    """What tests/test_al_loop.py::test_al_two_cycles checks, on the
    port CLI's run."""
    work, driver = runs.twork, runs.tdriver
    metrics = driver.metrics
    assert len(metrics) == 2
    assert all(np.isfinite(m["mAP"]) for m in metrics)
    with open(os.path.join(work, "metrics.json")) as f:
        assert json.load(f) == metrics
    x_l0, x_l1, unc1 = _npy(work, "X_L_0"), _npy(work, "X_L_1"), _npy(work, "Unc_1")
    assert len(x_l0) == 4
    assert len(x_l0) < len(x_l1) <= len(x_l0) + driver.al.x_s_size
    assert set(x_l0).issubset(set(x_l1))
    assert unc1.shape[0] == len(driver.pool)
    assert np.isfinite(unc1).all()
    ckpts = [f for f in os.listdir(driver.paths.save_dir) if "_mycode" in f]
    assert len(ckpts) == 2
    assert metrics[1]["n_labeled"] == len(x_l1)
    state = tckpt.load_checkpoint(tckpt.latest_path(driver.paths.save_dir))
    assert set(state) == set(driver.model.state_dict())
    assert os.path.exists(os.path.join(work, "code_snapshot.tar.gz"))


def test_al_resume_cycle(runs, tmp_path):
    """A port of tests/test_al_loop.py::test_al_resume_cycle through the
    CLI: --resume-cycle 1 on a finished run's work dir retrains cycle 1
    only."""
    work = runs.twork
    work2 = str(tmp_path / "work2")
    shutil.copytree(work, work2)
    x_l1 = _npy(work2, "X_L_1")
    with numerics_flags_kept():
        d2 = tcli.main(["--mini", "--cpu", "--voc07", runs.tdriver.paths.voc07, "--work-dir",
                        work2, "--resume-cycle", "1", "--no-validate"])
    assert {t["cycle"] for t in d2.timings} == {1}
    np.testing.assert_array_equal(_npy(work2, "X_L_1"), x_l1)
    assert len(x_l1) > 4


def test_mid_cycle_resume_bit_identical(runs, tmp_path, monkeypatch):
    """A port of tests/test_al_loop.py::test_mid_cycle_resume_bit_identical
    (port against port) on the `runs` fixture's uninterrupted CLI run: the
    same CLI, for cycle 0 alone and from the same initial weights, dies
    right after its first epoch snapshot (run 1 of 2), resumes with
    --resume-from, trains the second run only, and its cycle-0 checkpoint
    is bit-identical to the uninterrupted run's. A resume inside a run
    (the loader's epochs replayed) is held on the card by
    tests/test_torch_cuda.py::test_mid_cycle_resume_on_the_card, and the
    replay itself by tests/test_torch_data.py::test_burn_epochs_replays_the_stream."""
    work = str(tmp_path / "interrupted")
    argv = ["--mini", "--cpu", "--voc07", runs.tdriver.paths.voc07, "--work-dir", work,
            "--cycles", "1", "--no-validate"]
    real_save = tckpt.save_train_state

    def killer(save_dir, state, progress):
        real_save(save_dir, state, progress)
        raise KeyboardInterrupt("simulated preemption")

    monkeypatch.setattr(tloop.ALDriver, "_init_model", runs.port_init)
    with monkeypatch.context() as mp, numerics_flags_kept():
        mp.setattr(tckpt, "save_train_state", killer)
        with pytest.raises(KeyboardInterrupt):
            tcli.main(argv)
    with open(os.path.join(work, "model_save", "train_state.json")) as f:
        assert json.load(f)["run"] == 0
    with numerics_flags_kept():
        d2 = tcli.main(argv + ["--resume-from", "auto"])
    assert [t["phase"] for t in d2.timings if t["phase"] == "train_epoch"] == ["train_epoch"]

    pa, pb = (tckpt.load_checkpoint(tckpt.cycle_ckpt_path(d.paths.save_dir, d.name, 0, 1))
              for d in (runs.tdriver, d2))
    assert pa.keys() == pb.keys()
    for k in pa:
        assert torch.equal(pa[k], pb[k]), k


def test_pretrained_backbone_loads_torchvision_names(tmp_path):
    """--pretrained: a torchvision-named ResNet state_dict (fc and
    num_batches_tracked included, as torchvision saves it) loads into the
    backbone; one missing tensor raises."""
    cfg = ttiny()
    src = build_retinanet(cfg, device="cpu", seed=1)
    sd = {k: v.clone() for k, v in src.backbone.state_dict().items()}
    sd["fc.weight"], sd["bn1.num_batches_tracked"] = torch.zeros(3, 3), torch.tensor(0)
    path = str(tmp_path / "r50.pth")
    torch.save(sd, path)
    model = build_retinanet(cfg, device="cpu", seed=2)
    tcli.attach_pretrained_backbone(model, path)
    for k, v in src.backbone.state_dict().items():
        assert torch.equal(model.backbone.state_dict()[k], v), k
    del sd["conv1.weight"]
    torch.save({"state_dict": sd}, path)
    with pytest.raises(KeyError, match="conv1.weight"):
        tcli.attach_pretrained_backbone(model, path)


@pytest.mark.parametrize("cli,flags", [
    ("train", ["--int8-scoring"]),
    ("train", ["--dtype", "bfloat16"]), ("score_pool", ["--int8"]),
    ("score_pool", ["--dtype", "bfloat16"])])
def test_unported_cli_flags_raise(cli, flags):
    """The JAX CLIs' flags of modes the port does not have are parsed and
    refused with their ROADMAP item, never ignored: the RetinaNet AL CLI's
    and the pool scorer's."""
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 item"):
        if cli == "train":
            tcli.main(flags + ["--cpu", "--voc07", "unused", "--work-dir", "unused"])
        else:
            score_pool.main(flags + ["--cpu", "--voc07", "unused"])
