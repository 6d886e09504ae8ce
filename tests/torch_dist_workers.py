"""Rank programs of tests/test_torch_distributed.py and the launcher that
runs them: `run_ranks` starts `world` spawned processes on the CPU, each
joins a gloo group and calls one of the functions below, and returns
their results in rank order. Kept apart from the test file so that a
rank imports torch and the port only, never JAX."""

from __future__ import annotations

import functools
import os
import time
from typing import Any, Callable, List

import numpy as np
import torch

from aod_meh_hua_torch.tools.train_retinanet import main as cli_main

RANK_THREADS = 2      # torch's intra-op threads per rank (tests/torch_parity.py's)
GROUP_TIMEOUT_S = 30  # the process group's: a lost rank fails the others in seconds


def _entry(fn: Callable, rank: int, world: int, port: int, out_dir: str, env: dict,
           args: tuple) -> None:
    torch.set_num_threads(RANK_THREADS)
    os.environ.update(env)
    from aod_meh_hua_torch.parallel import init_distributed

    if env:  # a launcher's environment: the program joins the group itself
        result = fn(*args)
    else:
        init_distributed(f"127.0.0.1:{port}", world, rank, backend="gloo",
                         timeout=GROUP_TIMEOUT_S, device="cpu")
        result = fn(rank, world, *args)
    torch.save(result, os.path.join(out_dir, f"rank{rank}.pt"))
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()


def run_ranks(fn: Callable, world: int, out_dir: str, *args, launcher_env: bool = False,
              timeout: float = 120.0) -> List[Any]:
    """fn(rank, world, *args) in `world` ranks (or, with launcher_env,
    fn(*args) under torchrun's variables, the program joining the group
    itself); their results in rank order. Fails when a rank fails or any
    is still running after `timeout` seconds, which it then kills."""
    import torch.multiprocessing as mp

    from aod_meh_hua_torch.parallel.launch import free_port

    port = free_port()
    os.makedirs(out_dir, exist_ok=True)
    ctx = mp.get_context("spawn")
    procs = []
    for r in range(world):
        env = {"RANK": str(r), "WORLD_SIZE": str(world), "LOCAL_RANK": str(r),
               "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port)} if launcher_env else {}
        procs.append(ctx.Process(target=_entry, args=(fn, r, world, port, out_dir, env, args)))
    for p in procs:
        p.start()
    deadline = time.time() + timeout
    try:
        for p in procs:
            p.join(max(deadline - time.time(), 0.1))
    finally:
        hung = [r for r, p in enumerate(procs) if p.is_alive()]
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(5)
    assert not hung, f"ranks {hung} still running after {timeout} s"
    codes = [p.exitcode for p in procs]
    assert codes == [0] * world, f"rank exit codes {codes}"
    return [torch.load(os.path.join(out_dir, f"rank{r}.pt"), weights_only=False)
            for r in range(world)]


# --- rank programs ---------------------------------------------------------------

def collectives(rank: int, world: int, work_dir: str) -> dict:
    from aod_meh_hua_torch.parallel import (allgather_sum, barrier, collect_objects,
                                            rank_indices)

    n = 7
    x = np.zeros(n)
    idx = rank_indices(n, rank, world)
    x[idx] = idx * 1.5 + 0.25
    barrier("test")
    # a sharded tensor whose rows do not divide by the ranks, gathered back
    from torch.distributed.tensor import DTensor, Shard, distribute_tensor

    from aod_meh_hua_torch.parallel import gather_to_host, make_mesh
    from aod_meh_hua_torch.parallel.mesh import place_like

    full = torch.arange(15.0).reshape(5, 3)
    ref = distribute_tensor(torch.zeros(5, 3), make_mesh(world, device_type="cpu"), [Shard(0)])
    placed = place_like(full, ref)
    return {"sum": allgather_sum(x), "objects": collect_objects(work_dir, "t", {"rank": rank}),
            "idx": idx, "shard": placed.to_local(), "gathered": gather_to_host({"t": placed})["t"],
            "is_dtensor": isinstance(placed, DTensor)}


def build(cfg, init):
    from aod_meh_hua_torch.models.detector import build_retinanet
    from aod_meh_hua_torch.models.ssd_detector import build_ssd

    model = (build_ssd if cfg.family == "ssd" else build_retinanet)(cfg, device="cpu")
    if init is not None:
        model.load_state_dict(init)
    return model


def train_steps(rank: int, world: int, spec: dict) -> list:
    """spec: cfg, init (state dict), arrays (the global Batch's arrays),
    tcfg, frozen_stages, steps, mesh ("dp" or (n_data, n_fsdp)). Returns
    each step's aux and the gathered full state dict after it."""
    from aod_meh_hua_torch.engine.batch import Batch
    from aod_meh_hua_torch.engine.train import create_train_state, make_train_step
    from aod_meh_hua_torch.parallel import (gather_to_host, make_mesh, make_mesh_2d,
                                            replicate, shard_batch, shard_params_fsdp)

    cfg = spec["cfg"]
    model = build(cfg, spec["init"])
    if spec["mesh"] == "dp":
        mesh = make_mesh(world, device_type="cpu")
        replicate(model, mesh)
    else:
        mesh = make_mesh_2d(*spec["mesh"], device_type="cpu")
        shard_params_fsdp(model, mesh)
    opt = create_train_state(model, spec["tcfg"], frozen_stages=spec["frozen_stages"])
    step = make_train_step(model, cfg, opt, device="cpu", mesh=mesh)
    batch = shard_batch(Batch(*spec["arrays"]), mesh)
    out = []
    for _ in range(spec["steps"]):
        aux = step(batch)
        out.append(({k: float(v) for k, v in aux.items()}, gather_to_host(model)))
    return out


def driver_run(rank: int, world: int, spec: dict) -> dict:
    """One ALDriver run across the ranks (spec: the driver's configs and
    paths, its keyword arguments, run()'s, and `kill_after_snapshot`:
    every rank dies right after the first train-state snapshot, rank 0
    once it has written it). Returns whether it was killed, and the
    steps its model took."""
    from aod_meh_hua_torch.al import loop
    from aod_meh_hua_torch.engine import checkpoint

    driver = loop.ALDriver(*spec["args"], **spec["kwargs"])
    if not spec.get("kill_after_snapshot"):
        driver.run(**spec.get("run", {}))
        return {"killed": False, "steps": driver.step}
    real_save, real_state = checkpoint.save_train_state, driver._train_state

    def save_and_die(save_dir, state, progress):
        real_save(save_dir, state, progress)
        raise KeyboardInterrupt("simulated preemption")

    def gather_and_die():
        real_state()  # the gather is collective: rank 0 waits on it
        raise KeyboardInterrupt("simulated preemption")

    if rank == 0:
        checkpoint.save_train_state = save_and_die
    else:
        driver._train_state = gather_and_die
    try:
        driver.run(**spec.get("run", {}))
    except KeyboardInterrupt:
        return {"killed": True}
    finally:
        checkpoint.save_train_state = real_save
    raise AssertionError("the run was not killed")


def two_stage_steps(rank: int, world: int, spec: dict, mesh: bool = True) -> dict:
    """A two-stage family's train steps (spec: cfg, init (state dict),
    arrays (the global Batch's arrays, or Fast R-CNN's ProposalBatch's),
    draws (per step, the global
    batch's uniforms by stage)), data parallel over the ranks; with
    mesh=False the one-process step on the whole batch. Returns each
    step's aux, Dynamic R-CNN's state after each step, and the state dict
    after the last."""
    from aod_meh_hua_torch.engine.batch import Batch
    from aod_meh_hua_torch.engine.train import create_train_state
    from aod_meh_hua_torch.engine.two_stage import make_two_stage_train_step
    from aod_meh_hua_torch.models.two_stage import build_two_stage
    from aod_meh_hua_torch.parallel import gather_to_host, make_mesh, replicate, shard_batch
    from aod_meh_hua_torch.utils.config import TrainConfig

    from aod_meh_hua_torch.engine.rpn_only import ProposalBatch

    cfg = spec["cfg"]
    model = build_two_stage(cfg, device="cpu")
    model.load_state_dict(spec["init"])
    grid = None
    kind = ProposalBatch if len(spec["arrays"]) == len(ProposalBatch._fields) else Batch
    batch = kind(*(torch.from_numpy(np.asarray(a)) for a in spec["arrays"]))
    if mesh:
        grid = make_mesh(world, device_type="cpu")
        replicate(model, grid)
        batch = shard_batch(batch, grid)
    step = make_two_stage_train_step(model, cfg, create_train_state(model, TrainConfig()),
                                     device="cpu", mesh=grid)
    auxes, dynamic = [], []
    for draws in spec["draws"]:
        aux = step(batch, uniforms=lambda stage, n, k, d=draws: d[stage])
        auxes.append({k: float(v) for k, v in aux.items()})
        if cfg.family == "dynamic_rcnn":
            dynamic.append({k: v.clone() for k, v in model.dynamic.state_dict().items()})
    return {"aux": auxes, "dynamic": dynamic, "state": gather_to_host(model)}


def two_stage_eval(rank: int, world: int, spec: dict) -> dict:
    """tools/train_detector.py evaluate, sharded over the ranks (spec:
    cfg, init, the VOC root, the pipeline's mini flag, batch size)."""
    from aod_meh_hua_torch.data.voc import VOC_CLASSES, VOCDataset
    from aod_meh_hua_torch.models.two_stage import build_two_stage
    from aod_meh_hua_torch.tools.train_detector import evaluate, pipeline_for

    cfg = spec["cfg"]
    model = build_two_stage(cfg, device="cpu")
    model.load_state_dict(spec["init"])
    val = VOCDataset(os.path.join(spec["voc"], "ImageSets/Main/test.txt"), spec["voc"],
                     test_mode=True, classes=VOC_CLASSES[:cfg.num_classes])
    return evaluate(model, cfg, val, pipeline_for(cfg, True), spec["batch"], "cpu", rank,
                    world, spec["voc"])


def programs(rank: int, world: int, calls: list) -> list:
    """Several rank programs in turn, in one group: [(fn, args), ...] ->
    [fn(rank, world, *args), ...] (one spawn for all of them)."""
    return [fn(rank, world, *args) for fn, args in calls]


# --- the CLI with a sharpened sweep ------------------------------------------------

SHARPEN = 150.0  # the cls head's factor at sweep time (tests/torch_parity.py sharpen's)


def sharpened_cli_main(argv) -> None:
    """The RetinaNet CLI's main (`cli_main`, bound when this module was
    imported) with its sweeps' cls head scaled by SHARPEN (at random
    init every pool score is 0) and the driver's process group given
    GROUP_TIMEOUT_S. Training is untouched. Importable, so that a
    spawned rank can run it: with train_retinanet.main patched to it,
    --num-devices starts ranks that run it too."""
    from unittest import mock

    from aod_meh_hua_torch.al import loop

    real = loop.score_pool

    def sharpened(model, cfg, loader, n, **kwargs):
        with torch.no_grad():
            model.head.retina_cls.weight.mul_(SHARPEN)
        return real(model, cfg, loader, n, **kwargs)

    with mock.patch.object(loop, "score_pool", sharpened), \
            mock.patch.object(loop, "init_distributed",
                              functools.partial(loop.init_distributed, timeout=GROUP_TIMEOUT_S)):
        cli_main(argv)


def trainer_on_one_card(argv) -> list:
    """tools/train_detector.py's main as one of several ranks sharing the
    one card: LOCAL_RANK 0 on every rank (as hosts of one card each) and
    the group over gloo (NCCL refuses two ranks on one card), with
    GROUP_TIMEOUT_S. Returns the metrics."""
    from unittest import mock

    import aod_meh_hua_torch.parallel as parallel
    from aod_meh_hua_torch.tools import train_detector

    os.environ["LOCAL_RANK"] = "0"
    with mock.patch.object(parallel, "init_distributed", functools.partial(
            parallel.init_distributed, backend="gloo", timeout=GROUP_TIMEOUT_S)):
        return train_detector.main(argv)[2]
