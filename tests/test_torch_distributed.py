"""The port's parallel/ package (aod_meh_hua_torch/parallel/) and the
distributed train step, driver and CLI built on it, on the CPU over gloo,
against the JAX package's parallel/ and the single-process port.

The pass condition is the JAX package's own (tests/test_distributed.py,
tests/test_parallel.py, tests/test_fsdp.py): a run on several ranks
trains and acquires as the single-process run does.

- The numpy and pure-Python copies (detect_launch_env, rank_indices,
  fsdp_spec) equal JAX's on JAX's cases.
- Two ranks' data-parallel train step equals the single-process port
  step and the JAX step on the global batch, for both families, MEH and
  (SSD) OHEM in play, on a batch whose positives are uneven across the
  ranks (a per-rank loss normaliser would give another gradient):
  losses to rtol 1e-4, parameters to 1e-4 of each tensor's max-abs
  after two steps. FSDP on 1x2 and on a 2x2 (data, fsdp) mesh (HSDP)
  equals data parallel to the same tolerance; an FSDP mid-cycle resume
  is bit-identical.
- The RetinaNet CLI's --mini --cpu run on two ranks, under torchrun's
  environment and through --num-devices 2, acquires the single-process
  run's X_L_1, its Unc_1 within rtol 1e-4, with only rank 0 writing; the
  sweeps' cls head is sharpened (tests/torch_dist_workers.py), since at
  random init every score is 0.

Every rank runs in a spawned process (tests/torch_dist_workers.py
run_ranks) on RANK_THREADS intra-op threads, with a process-group
timeout of seconds and a wall timeout; the JAX drivers' two-process CLIs
are left to their own tests.
"""

import dataclasses
import os
import subprocess
import sys
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from aod_meh_hua_tpu.engine import Batch as JBatch
from aod_meh_hua_tpu.engine.train import create_train_state as jcreate_state
from aod_meh_hua_tpu.engine.train import make_train_step as jmake_train_step
from aod_meh_hua_tpu.parallel import dist as jdist
from aod_meh_hua_tpu.parallel import launch as jlaunch
from aod_meh_hua_tpu.parallel import mesh as jmesh
from aod_meh_hua_tpu.utils.config import SSDConfig as JSSDConfig
from aod_meh_hua_tpu.utils.config import TrainConfig as JTrainConfig
from aod_meh_hua_tpu.utils.config import tiny_test_config as jtiny

import aod_meh_hua_torch.parallel as tpar
from aod_meh_hua_torch.al import loop as tloop
from aod_meh_hua_torch.al.uncertainty import score_pool as tscore_pool
from aod_meh_hua_torch.data.loader import TrainLoader
from aod_meh_hua_torch.data.pipeline import PipelineConfig
from aod_meh_hua_torch.data.voc import VOCDataset
from aod_meh_hua_torch.engine import checkpoint as tckpt
from aod_meh_hua_torch.engine import train as ttrain
from aod_meh_hua_torch.engine.batch import Batch as TBatch
from aod_meh_hua_torch.models.convert import from_jax_variables
from aod_meh_hua_torch.ops.assigner import anchor_targets
from aod_meh_hua_torch.parallel import launch as tlaunch
from aod_meh_hua_torch.tools import train_retinanet as tcli
from aod_meh_hua_torch.utils.config import ALConfig as TALConfig
from aod_meh_hua_torch.utils.config import SSDConfig as TSSDConfig
from aod_meh_hua_torch.utils.config import TrainConfig as TTrainConfig
from aod_meh_hua_torch.utils.config import tiny_test_config as ttiny

import torch_dist_workers as w
from torch_parity import (THIN_SSD, TINY, few_threads, jax_retinanet, jax_ssd,  # noqa: F401
                          mini_voc, numerics_flags_kept, train_batch)

pytestmark = pytest.mark.usefixtures("few_threads")

REPO = os.path.join(os.path.dirname(__file__), "..")
RTOL = 1e-4    # losses; parameters to RTOL of each tensor's max-abs
CLI_RTOL = 1e-4  # Unc_1 of the ranks' runs against the single-process run's
WALL_S = 120   # a spawned group's wall timeout


# --- the copies against JAX -----------------------------------------------------

ENVIRONS = [  # tests/test_parallel.py:277-330, and three more
    {"SLURM_PROCID": "3", "SLURM_NTASKS": "8", "SLURM_NODELIST": "nid[0012-0015,0020],login1"},
    {"SLURM_PROCID": "0", "SLURM_NTASKS": "2", "SLURM_NODELIST": "hostA,hostB",
     "MASTER_PORT": "1234"},
    {"OMPI_COMM_WORLD_RANK": "1", "OMPI_COMM_WORLD_SIZE": "4", "MASTER_ADDR": "10.0.0.5"},
    {"RANK": "2", "WORLD_SIZE": "4", "MASTER_ADDR": "h0", "MASTER_PORT": "29501"},
    {},
    {"SLURM_PROCID": "0", "SLURM_NTASKS": "2", "SLURM_NODELIST": "a", "RANK": "9",
     "WORLD_SIZE": "99"},
    {"SLURM_PROCID": "1", "SLURM_NTASKS": "2", "SLURM_STEP_NODELIST": "gpu[7-8]",
     "SLURM_NODELIST": "x", "MASTER_ADDR": "m0"},
    {"RANK": "0", "WORLD_SIZE": "1"},
    {"OMPI_COMM_WORLD_RANK": "0", "OMPI_COMM_WORLD_SIZE": "2"},
]


@pytest.mark.parametrize("env", ENVIRONS)
def test_detect_launch_env_matches_jax(env):
    assert tlaunch.detect_launch_env(env) == jlaunch.detect_launch_env(env)


@pytest.mark.parametrize("env,want", [
    ({"LOCAL_RANK": "3"}, 3), ({"SLURM_LOCALID": "1"}, 1),
    ({"OMPI_COMM_WORLD_LOCAL_RANK": "2"}, 2), ({}, 0),
    ({"LOCAL_RANK": "1", "SLURM_LOCALID": "5"}, 1)])
def test_local_rank(env, want):
    assert tlaunch.local_rank(env) == want


def test_rank_device_never_shares_a_card():
    """The CPU stays the CPU; a local rank past the visible cards raises
    (here there are none)."""
    assert tlaunch.rank_device("cpu", {"LOCAL_RANK": "3"}) == torch.device("cpu")
    with pytest.raises(RuntimeError, match="has no card"):
        tlaunch.rank_device("cuda", {"LOCAL_RANK": str(torch.cuda.device_count())})


@pytest.mark.parametrize("n,pid,count", [(10, 1, 3), (7, 0, 2), (7, 1, 2), (0, 0, 1),
                                         (5, 4, 8), (32, 3, 4)])
def test_rank_indices_match_jax(n, pid, count):
    got, want = tpar.rank_indices(n, pid, count), jdist.rank_indices(n, pid, count)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape,n,min_size", [
    ((3, 3, 64, 64), 2, 1), ((3, 3, 128, 64), 2, 1), ((64,), 2, 2 ** 15), ((), 2, 2 ** 15),
    ((3, 3, 5, 7), 2, 1), ((256, 64, 1, 1), 4, 2 ** 15), ((189, 256, 3, 3), 2, 1),
    ((2048, 512, 1, 1), 8, 2 ** 15)])
def test_fsdp_spec_matches_jax(shape, n, min_size):
    assert tpar.fsdp_spec(shape, n, min_size) == tuple(jmesh.fsdp_spec(shape, n, min_size))


def test_make_mesh_2d_checks_like_jax():
    with pytest.raises(ValueError) as want:
        jmesh.make_mesh_2d(2, 2, devices=jax.devices("cpu")[:1])
    with pytest.raises(ValueError) as got:
        tpar.make_mesh_2d(2, 2, devices=1)
    assert str(got.value) == str(want.value)


def test_exported_names_match_jax():
    import aod_meh_hua_tpu.parallel as jpar

    public = lambda m: {n for n in vars(m) if not n.startswith("_")} - {  # noqa: E731
        "mesh", "dist", "launch"}
    assert public(jpar) == public(tpar)


# --- launch ----------------------------------------------------------------------

@pytest.fixture
def no_launcher(monkeypatch):
    for key in ("RANK", "WORLD_SIZE", "SLURM_PROCID", "SLURM_NTASKS", "OMPI_COMM_WORLD_RANK",
                "OMPI_COMM_WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT", "LOCAL_RANK"):
        monkeypatch.delenv(key, raising=False)


def test_init_distributed_single_process(no_launcher):
    info = tpar.init_distributed(num_processes=1, process_id=0, device="cpu")
    assert info == {"process_index": 0, "process_count": 1, "local_devices": 1,
                    "global_devices": 1}
    assert not dist.is_initialized()


@pytest.mark.parametrize("kwargs,err", [
    # JAX's test_init_distributed_explicit_failure_is_loud
    (dict(coordinator_address="localhost:1", num_processes=2, process_id=5), ValueError),
    (dict(num_processes=2), ValueError),
    # nobody listens there: the store's connect gives up at the timeout
    (dict(num_processes=2, process_id=1), RuntimeError)])
def test_init_distributed_explicit_failure_is_loud(no_launcher, kwargs, err):
    """An explicit multi-process launch that cannot start raises within
    its timeout; it never carries on alone."""
    if "coordinator_address" not in kwargs and "process_id" in kwargs:
        kwargs = dict(kwargs, coordinator_address=f"127.0.0.1:{tlaunch.free_port()}")
    with pytest.raises(err):
        tpar.init_distributed(**kwargs, backend="gloo", timeout=1, device="cpu")
    assert not dist.is_initialized()


def test_nccl_needs_a_card(no_launcher):
    with pytest.raises(ValueError, match="NCCL needs a card"):
        tpar.init_distributed(f"127.0.0.1:{tlaunch.free_port()}", 1, 0, backend="nccl",
                              device="cpu")


def test_collectives_alone(tmp_path):
    x = np.arange(5.0)
    np.testing.assert_array_equal(tpar.allgather_sum(x), x)
    assert tpar.collect_objects(str(tmp_path), "t", {"a": 1}) == [{"a": 1}]
    tpar.barrier("alone")
    np.testing.assert_array_equal(jdist.allgather_sum(x), tpar.allgather_sum(x))


def test_collectives_on_two_ranks(two_ranks):
    """allgather_sum merges the ranks' slices into the whole vector;
    collect_objects gives every rank every rank's object, in rank order."""
    r0, r1 = two_ranks.collectives
    want = np.arange(7) * 1.5 + 0.25
    for r in (r0, r1):
        np.testing.assert_array_equal(r["sum"], want)
        assert r["objects"] == [{"rank": 0}, {"rank": 1}]
    np.testing.assert_array_equal(np.sort(np.concatenate([r0["idx"], r1["idx"]])), np.arange(7))
    # place_like cuts a rank's shard locally; gather_to_host puts 3 + 2 rows back
    full = torch.arange(15.0).reshape(5, 3)
    assert r0["is_dtensor"] and torch.equal(r0["shard"], full[:3])
    assert torch.equal(r1["shard"], full[3:])
    for r in (r0, r1):
        assert torch.equal(r["gathered"], full)


# --- the train step across ranks ---------------------------------------------------

FAMILIES = {
    # (JAX cfg, port cfg, JAX variables, batch seed, image scale, TrainConfig,
    # frozen stages); the batch seeds give positives uneven across two ranks,
    # and no exact IoU tie in the low-quality matches (tests/torch_parity.py);
    # the SSD reads unnormalised pixels (tests/test_torch_ssd.py's scale)
    "retinanet": lambda: (jtiny(**TINY), ttiny(**TINY), jax_retinanet(**TINY), 0, 1.0,
                          dict(batch_size=4), 1),
    "ssd": lambda: (JSSDConfig(**THIN_SSD), TSSDConfig(**THIN_SSD), jax_ssd(seed=5), 3, 60.0,
                    dict(batch_size=4, lr=0.01), 0),
}
STEPS = 2
GLOBAL_B = 4
CLIP = 1e-3  # a global gradient norm far below the tiny model's


def _per_image_positives(cfg, arrays):
    anchors = torch.from_numpy(np.concatenate(
        cfg.build_anchor_generator().grid_anchors(cfg.featmap_sizes())).astype(np.float32))
    _, boxes, labels, gt_valid, av, _ = (torch.from_numpy(np.asarray(a)) for a in arrays)
    t = anchor_targets(anchors, av, boxes, labels.long(), gt_valid,
                       num_classes=cfg.num_classes, target_means=cfg.target_means,
                       target_stds=cfg.target_stds, pos_iou_thr=cfg.pos_iou_thr,
                       neg_iou_thr=cfg.neg_iou_thr, min_pos_iou=cfg.min_pos_iou,
                       gt_max_assign_all=cfg.gt_max_assign_all)
    return t.num_pos.tolist()


@pytest.fixture(scope="module")
def cases():
    """Per family: the global batch, the initial port weights, the JAX
    steps' aux and parameters, and the single-process port steps'."""
    out = {}
    for fam, make in FAMILIES.items():
        jc, tc, (jm, variables), seed, scale, tcfg, frozen = make()
        arrays = train_batch(jc, seed=seed, b=GLOBAL_B)
        arrays = (arrays[0] * np.float32(scale),) + arrays[1:]
        state, tx = jcreate_state(jm, jax.tree_util.tree_map(jnp.asarray, variables),
                                  JTrainConfig(**tcfg), frozen_stages=frozen)
        state = jax.device_put(state, jax.devices()[0])
        jstep = jmake_train_step(jm, jc, tx)
        init = from_jax_variables(variables)
        model = w.build(tc, init)
        tstep = ttrain.make_train_step(
            model, tc, ttrain.create_train_state(model, TTrainConfig(**tcfg), frozen), "cpu")
        jax_steps, port_steps = [], []
        for _ in range(STEPS):
            state, aux = jstep(state, JBatch(*(jnp.asarray(a) for a in arrays)))
            jax_steps.append(({k: float(v) for k, v in aux.items()}, from_jax_variables(
                {"params": jax.device_get(state.params),
                 "batch_stats": variables.get("batch_stats", {})})))
            aux = tstep(TBatch(*arrays))
            port_steps.append(({k: float(v) for k, v in aux.items()},
                               {k: v.clone() for k, v in model.state_dict().items()}))
        spec = dict(cfg=tc, init=init, arrays=arrays, tcfg=TTrainConfig(**tcfg),
                    frozen_stages=frozen, steps=STEPS)
        out[fam] = SimpleNamespace(spec=spec, jax=jax_steps, port=port_steps,
                                   positives=_per_image_positives(tc, arrays))
    # the Retina case under a gradient clip that binds, the port alone
    # (test_torch_train.py holds the clip to optax's)
    spec = dict(out["retinanet"].spec, tcfg=TTrainConfig(batch_size=GLOBAL_B, grad_clip=CLIP))
    out["clip"] = SimpleNamespace(spec=spec, port=_port_steps(spec))
    # without the MEH branch (use_meh=False), from the port's own init
    cfg = ttiny(**TINY, use_meh=False)
    spec = dict(out["retinanet"].spec, cfg=cfg,
                init=w.build(cfg, None).state_dict())
    out["no_meh"] = SimpleNamespace(spec=spec, port=_port_steps(spec))
    return out


def _port_steps(spec):
    """STEPS single-process port steps of a spec: (aux, state dict) each."""
    model = w.build(spec["cfg"], spec["init"])
    tstep = ttrain.make_train_step(model, spec["cfg"], ttrain.create_train_state(
        model, spec["tcfg"], spec["frozen_stages"]), "cpu")
    return [({k: float(v) for k, v in tstep(TBatch(*spec["arrays"])).items()},
             {k: v.clone() for k, v in model.state_dict().items()}) for _ in range(STEPS)]


@pytest.fixture(scope="module")
def voc(tmp_path_factory):
    return mini_voc(tmp_path_factory.mktemp("distvoc"))


def _driver_spec(voc07, work, **over):
    """The --mini driver (tiny config, its pipeline) on two ranks under
    --fsdp 2, one cycle of two runs of one epoch of one step, a snapshot
    per epoch."""
    cfg = ttiny()
    args = (cfg, TTrainConfig(outer_epoch=1, epoch_ratio=(1,), ckpt_interval=1),
            TALConfig(cycles=(0,), x_l_0_size=2, x_s_size=2, x_l_repeat=1, score_batch_size=8),
            tloop.ALPaths(voc07=voc07, voc12=None, work_dir=work))
    kwargs = dict(pipeline=PipelineConfig(img_scale=(250, 120), canvas=cfg.canvas,
                                          device_normalize=True),
                  validate=False, log=None, device="cpu", num_devices=2, fsdp=2,
                  distributed=True)
    return dict(args=args, kwargs=kwargs, **over)


@pytest.fixture(scope="module")
def two_ranks(cases, voc, tmp_path_factory):
    """One group of two ranks runs: the collectives; both families' steps,
    data parallel and FSDP on a 1x2 mesh; and the FSDP driver uninterrupted,
    killed after its first snapshot, and resumed from it."""
    tmp = tmp_path_factory.mktemp("two_ranks")
    meshes = ("dp", (1, 2))
    steps = [(w.train_steps, (dict(cases[f].spec, mesh=m),))
             for f in (*FAMILIES, "clip", "no_meh") for m in meshes]
    whole, killed = str(tmp / "whole"), str(tmp / "killed")
    drivers = [(w.driver_run, (spec,)) for spec in (
        _driver_spec(voc, whole), _driver_spec(voc, killed, kill_after_snapshot=True),
        _driver_spec(voc, killed, run={"resume_from": os.path.join(killed, "model_save")}))]
    runs = w.run_ranks(w.programs, 2, str(tmp / "out"),
                       [(w.collectives, (str(tmp),))] + steps + drivers, timeout=WALL_S)
    keys = [(f, m) for f in (*FAMILIES, "clip", "no_meh") for m in ("dp", "1x2")]
    return SimpleNamespace(
        collectives=[r[0] for r in runs],
        steps={k: [r[1 + i] for r in runs] for i, k in enumerate(keys)},
        drivers=[r[1 + len(keys):] for r in runs], dirs=(whole, killed))


@pytest.fixture(scope="module")
def four_ranks(cases, tmp_path_factory):
    """RetinaNet on a 2x2 (data, fsdp) mesh: HSDP."""
    spec = dict(cases["retinanet"].spec, mesh=(2, 2))
    return w.run_ranks(w.train_steps, 4, str(tmp_path_factory.mktemp("four_ranks")), spec,
                       timeout=WALL_S)


def _assert_steps_equal(got, want, what, exact_num_pos=True):
    for i, ((gaux, gsd), (waux, wsd)) in enumerate(zip(got, want)):
        assert set(gaux) == set(waux)
        for k in waux:
            if k == "num_pos" and exact_num_pos:
                assert gaux[k] == waux[k], f"{what}, step {i}: num_pos"
            np.testing.assert_allclose(gaux[k], waux[k], rtol=RTOL,
                                       err_msg=f"{what}, step {i}: {k}")
        assert set(gsd) == set(wsd)
        for k, v in wsd.items():
            np.testing.assert_allclose(gsd[k].numpy(), v.numpy(), rtol=0,
                                       atol=RTOL * float(v.abs().max()) + 1e-12,
                                       err_msg=f"{what}, step {i}: {k}")


@pytest.mark.parametrize("family", list(FAMILIES))
def test_uneven_positives_across_ranks(cases, family):
    """The halves of the batch hold different positive counts, so the
    step's equality below needs the global normaliser."""
    pos = cases[family].positives
    half = GLOBAL_B // 2
    assert sum(pos[:half]) != sum(pos[half:]), pos
    assert abs(sum(pos[:half]) - sum(pos[half:])) >= 0.2 * sum(pos), pos


@pytest.mark.parametrize("family", list(FAMILIES))
def test_single_process_step_matches_jax(cases, family):
    c = cases[family]
    _assert_steps_equal(c.port, c.jax, f"{family} port vs JAX")


@pytest.mark.parametrize("family", list(FAMILIES))
def test_dp_step_matches_single_process_and_jax(cases, two_ranks, family):
    """Both ranks report the global aux and hold the same weights, equal
    to the single-process port's and JAX's on the global batch."""
    c = cases[family]
    r0, r1 = two_ranks.steps[(family, "dp")]
    for a, b in zip(r0, r1):
        assert a[0] == b[0]
        for k in a[1]:
            assert torch.equal(a[1][k], b[1][k]), k
    _assert_steps_equal(r0, c.port, f"{family} DP vs single process")
    _assert_steps_equal(r0, c.jax, f"{family} DP vs JAX")
    assert r0[-1][0]["loss_meh"] > 0 and r0[-1][0]["num_pos"] == sum(c.positives)


@pytest.mark.parametrize("family,mesh", [("retinanet", "1x2"), ("ssd", "1x2"),
                                         ("retinanet", "2x2")])
def test_fsdp_step_matches_dp(two_ranks, four_ranks, family, mesh):
    """ZeRO-3 on one data group of two (1x2) and HSDP on two of two (2x2,
    the fsdp peers holding the same rows): the gathered weights and the
    aux equal the data-parallel step's."""
    ranks = two_ranks.steps[(family, "1x2")] if mesh == "1x2" else four_ranks
    dp = two_ranks.steps[(family, "dp")][0]
    for r in ranks:
        _assert_steps_equal(r, dp, f"{family} FSDP {mesh} vs DP")


@pytest.mark.parametrize("mesh", ["dp", "1x2"])
def test_grad_clip_on_the_global_gradient(cases, two_ranks, mesh):
    """Clipping runs after the reduction, on the global gradient (under
    FSDP from the shards' squares summed over the group), counting the
    frozen parameters' gradients: the single-process clipped step."""
    _assert_steps_equal(two_ranks.steps[("clip", mesh)][0], cases["clip"].port,
                        f"clipped step, {mesh}")
    unclipped = cases["retinanet"].port[0][1]
    moved = max(float((cases["clip"].port[0][1][k] - v).abs().max()) for k, v in
                cases["retinanet"].spec["init"].items())
    assert moved < max(float((unclipped[k] - v).abs().max()) for k, v in
                       cases["retinanet"].spec["init"].items())


@pytest.mark.parametrize("mesh", ["dp", "1x2"])
def test_no_meh_step_across_ranks(cases, two_ranks, mesh):
    """use_meh=False: no lambda branch on any rank, every trainable
    parameter still gets its gradient from the one backward (the flat
    all-reduce needs the same set on every rank): the single-process
    step."""
    assert not any("retina_L" in k for k in cases["no_meh"].spec["init"])
    _assert_steps_equal(two_ranks.steps[("no_meh", mesh)][0], cases["no_meh"].port,
                        f"use_meh=False, {mesh}")


def test_dp_step_sums_over_rows_not_ranks(cases):
    """The trap in numbers: the data-parallel loss is the global batch's,
    not the mean of the ranks' own losses (each over its own positives)."""
    c = cases["retinanet"]
    model = w.build(c.spec["cfg"], c.spec["init"])
    loss_fn, anchors = ttrain.make_loss_fn(model, c.spec["cfg"])
    dtypes = (torch.float32, torch.float32, torch.long, torch.bool, torch.bool, torch.int32)
    with torch.no_grad():
        per_rank = [float(loss_fn(TBatch(*(torch.as_tensor(np.asarray(a)[rows], dtype=t)
                                           for a, t in zip(c.spec["arrays"], dtypes))),
                                  torch.from_numpy(anchors))[0])
                    for rows in (slice(0, 2), slice(2, 4))]
    loss = c.port[0][0]["loss"]
    assert abs(np.mean(per_rank) - loss) > 10 * RTOL * loss, (per_rank, loss)


# --- the driver and the CLI ------------------------------------------------------------

def test_fsdp_mid_cycle_resume_bit_identical(two_ranks):
    """ZeRO-3 (--fsdp 2 on two ranks): an uninterrupted cycle, and the
    same cycle killed right after its first epoch snapshot and resumed
    from it (the snapshot gathered on save, re-sharded on load), end in
    the same cycle checkpoint, bit for bit (JAX
    tests/test_fsdp.py::test_fsdp_mid_cycle_resume_bit_identical)."""
    for ranks in two_ranks.drivers:
        assert [r["killed"] for r in ranks] == [False, True, False]
        assert ranks[0]["steps"] == ranks[2]["steps"] > 0
    pa, pb = (tckpt.load_checkpoint(tckpt.cycle_ckpt_path(os.path.join(d, "model_save"),
                                                          "retinanet_meh", 0, 1))
              for d in two_ranks.dirs)
    assert pa.keys() == pb.keys()
    for k in pa:
        assert torch.equal(pa[k], pb[k]), k


@pytest.mark.parametrize("written_as", ["by_name", "sgd_state_dict"])
def test_train_state_snapshot_momentum_by_name(voc, tmp_path, written_as):
    """A single-process snapshot holds the momentum by parameter name, as
    a sharded run's does, and a fresh optimizer takes it back bit for bit;
    an older snapshot's SGD state_dict (its state keyed by position)
    gives the same buffers."""
    spec = _driver_spec(voc, str(tmp_path))
    kwargs = dict(spec["kwargs"], num_devices=None, fsdp=1, distributed=False)
    driver = tloop.ALDriver(*spec["args"], **kwargs)
    driver._fresh_model(0)
    rng = np.random.RandomState(3)
    for _ in range(2):
        for group in driver.optimizer.param_groups:
            for p in group["params"]:
                p.grad = torch.from_numpy(rng.randn(*p.shape).astype(np.float32))
        driver.optimizer.step()
    want = {n: driver.optimizer.state[p]["momentum_buffer"].clone()
            for n, p in zip(driver._param_names(),
                            [p for g in driver.optimizer.param_groups for p in g["params"]])}
    snap = driver._train_state()
    assert set(snap) == {"model", "momentum", "step"} and set(snap["momentum"]) == set(want)
    if written_as == "sgd_state_dict":
        snap = {"model": snap["model"], "optimizer": driver.optimizer.state_dict(), "step": 0}
    driver._fresh_model(0)
    driver._load_optimizer(snap)
    params = dict(driver.model.named_parameters())
    for n, buf in want.items():
        assert torch.equal(driver.optimizer.state[params[n]]["momentum_buffer"], buf), n


@pytest.mark.parametrize("over,match", [
    (dict(num_devices=2), "one device per process"),
    (dict(fsdp=2), "fsdp > 1 requires num_devices > 1"),
    (dict(num_devices=2, fsdp=2), "one device per process")])
def test_driver_validation(over, match, tmp_path):
    spec = _driver_spec("unused", str(tmp_path))
    kwargs = dict(spec["kwargs"], **dict(dict(num_devices=None, fsdp=1, distributed=False),
                                         **over))
    with pytest.raises(ValueError, match=match):
        tloop.ALDriver(*spec["args"], **kwargs)


def test_loader_rows_are_the_global_batch(voc, monkeypatch):
    """Each rank's TrainLoader yields its block of the single-process
    batch, bit for bit, over a repeat and a short tail, and decodes only
    the images of its own rows."""
    from aod_meh_hua_torch.data import loader as loader_module

    cfg = ttiny()
    pool = VOCDataset(os.path.join(voc, "ImageSets/Main/trainval.txt"), voc)
    pipe = PipelineConfig(img_scale=(250, 120), canvas=cfg.canvas, device_normalize=True)
    x_l = np.arange(7)
    loads = []
    real_load = loader_module.load_image
    monkeypatch.setattr(loader_module, "load_image",
                        lambda path: loads.append(path) or real_load(path))

    def epoch(rows):
        loads.clear()
        ld = TrainLoader(pool, x_l, cfg, pipe, batch_size=4, repeat=2, seed=5,
                         prefetch=False, num_workers=0, rows=rows)
        return list(ld), len(loads)

    whole, n_whole = epoch((0, 1))
    parts = [epoch((r, 2)) for r in range(2)]
    assert n_whole == 14 and all(n < n_whole for _, n in parts), (n_whole, parts)
    for b, (o, full) in enumerate(whole):
        for r, (batches, _) in enumerate(parts):
            o_r, part = batches[b]
            assert o_r == o
            for x, y in zip(part, full):
                np.testing.assert_array_equal(x, np.asarray(y)[2 * r:2 * r + 2])


def test_score_pool_refuses_a_mesh_of_ranks():
    """The mesh argument is never ignored: a mesh of one rank runs as is,
    one of more raises."""
    cfg = ttiny()
    cfg = dataclasses.replace(cfg, hua=dataclasses.replace(cfg.hua, pool="Random"))
    rng = np.random.RandomState(0)
    with pytest.raises(ValueError, match="rank_indices"):
        tscore_pool(None, cfg, [], 3, rng=rng, device="cpu", mesh=SimpleNamespace(size=lambda: 2))
    unc, _ = tscore_pool(None, cfg, [], 3, rng=rng, device="cpu",
                         mesh=SimpleNamespace(size=lambda: 1))
    np.testing.assert_array_equal(np.sort(unc), np.arange(3))


def test_num_devices_more_than_cards_raises(tmp_path):
    """--num-devices on the card never shares a card or falls back to the
    CPU: with fewer cards than ranks it raises before any rank starts."""
    with pytest.raises(RuntimeError, match="visible cards"):
        tcli.main(["--voc07", "unused", "--work-dir", str(tmp_path),
                   "--num-devices", str(torch.cuda.device_count() + 2)])


CLI = ["--mini", "--cpu"]


@pytest.fixture(scope="module")
def single_cli(voc, tmp_path_factory):
    """The single-process --mini --cpu run, with the sweeps sharpened."""
    work = str(tmp_path_factory.mktemp("cli_single"))
    with numerics_flags_kept():
        w.sharpened_cli_main(CLI + ["--voc07", voc, "--work-dir", work])
    return work


def _cli_matches(single, work):
    x1, x2 = (np.load(os.path.join(d, "X_L_1.npy")) for d in (single, work))
    np.testing.assert_array_equal(x2, x1)
    u1, u2 = (np.load(os.path.join(d, "Unc_1.npy")) for d in (single, work))
    assert (u1 > 0).sum() >= 4, u1  # the sweep scored objects
    np.testing.assert_array_equal(u2 > 0, u1 > 0)
    np.testing.assert_allclose(u2, u1, rtol=CLI_RTOL, atol=0)
    # only rank 0 writes: one log line per epoch, as alone
    for name in ("train_log.jsonl",):
        with open(os.path.join(single, name)) as f, open(os.path.join(work, name)) as g:
            assert len(g.readlines()) == len(f.readlines())
    assert sorted(os.listdir(os.path.join(work, "canvas_cache"))) == [
        "pool_r0", "pool_r1", "val_r0", "val_r1"]
    assert len([f for f in os.listdir(os.path.join(work, "model_save"))
                if "_mycode" in f]) == 2


def test_cli_under_a_launcher_acquires_the_single_process_set(voc, single_cli, tmp_path):
    """Two ranks under torchrun's variables (RANK, WORLD_SIZE,
    MASTER_ADDR, MASTER_PORT, LOCAL_RANK)."""
    work = str(tmp_path / "cli_launcher")
    w.run_ranks(w.sharpened_cli_main, 2, str(tmp_path / "out"),
                CLI + ["--voc07", voc, "--work-dir", work], launcher_env=True, timeout=WALL_S)
    _cli_matches(single_cli, work)


def test_cli_num_devices_starts_the_ranks(voc, single_cli, tmp_path):
    """--num-devices 2 without a launcher: the CLI spawns the two local
    ranks itself (run in a subprocess with a timeout; the ranks run the
    sharpened main, as the CLI passes on its module's `main`)."""
    work = str(tmp_path / "cli_num_devices")
    code = ("import sys; sys.path.insert(0, 'tests'); import torch_dist_workers as w; "
            "from aod_meh_hua_torch.tools import train_retinanet as t; "
            "t.main = w.sharpened_cli_main; w.sharpened_cli_main(sys.argv[1:])")
    env = dict(os.environ, OMP_NUM_THREADS=str(w.RANK_THREADS))
    r = subprocess.run([sys.executable, "-c", code] + CLI + [
        "--voc07", voc, "--work-dir", work, "--num-devices", "2"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=WALL_S)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "process 0/2" in r.stdout and "process 1/2" in r.stdout
    _cli_matches(single_cli, work)
