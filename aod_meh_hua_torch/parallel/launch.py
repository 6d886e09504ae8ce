"""Multi-process launch on torch.distributed.

Port of aod_meh_hua_tpu/parallel/launch.py (`_first_slurm_host` and
`detect_launch_env` are copies of :23-77; `init_distributed` is :80-128
on `torch.distributed.init_process_group`), the counterpart of mmcv's
init_dist with the pytorch/slurm/mpi launchers that the reference
selects with --launcher (tools/train_RetinaNet.py:68,117-123;
dist_params backend='nccl', configs/_base_/Config_RetinaNet.py:9).

The port runs one device per process: rank r's device is the card of
its local rank (`local_rank`), or the CPU. So a process has one local
device, and the global device count is the world size.
"""

from __future__ import annotations

import datetime
import os
import re
from typing import Optional

import torch
import torch.distributed as dist

# the process-group timeout of a launch that names none: a collective or
# a barrier that waits longer on a lost rank raises
DEFAULT_TIMEOUT_S = 1800.0


def _first_slurm_host(nodelist: str) -> str:
    """First hostname of a slurm nodelist without shelling to scontrol:
    'nid[0012-0015,0020],other' -> 'nid0012'; 'host1,host2' -> 'host1'."""
    head = nodelist.split(",")[0]
    m = re.match(r"([^\[]+)\[([^\]\-,]+)", nodelist)
    if m:
        return m.group(1) + m.group(2)
    return head


def detect_launch_env(environ=None) -> dict:
    """(coordinator_address, num_processes, process_id) from the cluster
    launcher's environment, the analog of mmcv init_dist's 'pytorch' /
    'slurm' / 'mpi' launchers. Checked in order:

    * slurm:   SLURM_PROCID / SLURM_NTASKS / SLURM_NODELIST (coordinator
               = first host; port from MASTER_PORT or 29500, mmcv's
               _init_dist_slurm default)
    * OpenMPI: OMPI_COMM_WORLD_RANK / OMPI_COMM_WORLD_SIZE + MASTER_ADDR
    * pytorch: RANK / WORLD_SIZE / MASTER_ADDR / MASTER_PORT

    Returns {} when no launcher environment is present. Explicit
    arguments always win over this."""
    env = os.environ if environ is None else environ
    port = env.get("MASTER_PORT", "29500")
    if "SLURM_PROCID" in env and "SLURM_NTASKS" in env:
        nodelist = env.get("SLURM_STEP_NODELIST") or env.get("SLURM_NODELIST")
        host = env.get("MASTER_ADDR") or (
            _first_slurm_host(nodelist) if nodelist else None)
        out = {
            "num_processes": int(env["SLURM_NTASKS"]),
            "process_id": int(env["SLURM_PROCID"]),
        }
        if host:
            out["coordinator_address"] = f"{host}:{port}"
        return out
    if "OMPI_COMM_WORLD_RANK" in env and "OMPI_COMM_WORLD_SIZE" in env:
        out = {
            "num_processes": int(env["OMPI_COMM_WORLD_SIZE"]),
            "process_id": int(env["OMPI_COMM_WORLD_RANK"]),
        }
        if env.get("MASTER_ADDR"):
            out["coordinator_address"] = f"{env['MASTER_ADDR']}:{port}"
        return out
    if "RANK" in env and "WORLD_SIZE" in env:
        out = {
            "num_processes": int(env["WORLD_SIZE"]),
            "process_id": int(env["RANK"]),
        }
        if env.get("MASTER_ADDR"):
            out["coordinator_address"] = f"{env['MASTER_ADDR']}:{port}"
        return out
    return {}


def local_rank(environ=None) -> int:
    """This process's index among the ranks of its host, from the same
    launchers (torchrun's LOCAL_RANK, slurm's SLURM_LOCALID, OpenMPI's
    OMPI_COMM_WORLD_LOCAL_RANK); 0 when none is set."""
    env = os.environ if environ is None else environ
    for key in ("LOCAL_RANK", "SLURM_LOCALID", "OMPI_COMM_WORLD_LOCAL_RANK"):
        if key in env:
            return int(env[key])
    return 0


def rank_device(device="cuda", environ=None) -> torch.device:
    """The one device of this rank: `device` itself when it is the CPU or
    names a card's index, else the card of the local rank. A local rank
    past the visible cards raises: ranks never share a card unless the
    caller names it."""
    dev = torch.device(device)
    if dev.type != "cuda" or dev.index is not None:
        return dev
    index = local_rank(environ)
    count = torch.cuda.device_count()
    if index >= count:
        raise RuntimeError(f"local rank {index} has no card: {count} visible; start at most "
                           f"{count} ranks per host, or name the card")
    return torch.device("cuda", index)


def init_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    *,
    backend: Optional[str] = None,
    timeout: float = DEFAULT_TIMEOUT_S,
    device="cuda",
) -> dict:
    """Join the process group (a tcp:// rendezvous at the coordinator,
    which rank 0 hosts). Fields not passed are filled from the launcher's
    environment (detect_launch_env). Returns a summary dict with the JAX
    package's keys.

    backend: "nccl" or "gloo"; by default NCCL when the rank's device is
    a card (rank_device(device)), gloo on the CPU. timeout (seconds)
    bounds every collective and barrier, so a lost rank fails the others.

    An explicitly requested multi-process launch that fails to
    initialise raises, as in JAX :107-128: it never falls back to one
    process or to another backend (a misconfigured coordinator must not
    train on 1/N of the data). With nothing requested and no launcher
    environment, the process runs alone and no group is made."""
    auto = detect_launch_env()
    coordinator_address = coordinator_address or auto.get("coordinator_address")
    if num_processes is None:
        num_processes = auto.get("num_processes")
    if process_id is None:
        process_id = auto.get("process_id")
    if dist.is_initialized():
        return _summary()
    if not (coordinator_address or (num_processes or 1) > 1 or process_id):
        return _summary()
    what = (f"init_distributed(coordinator={coordinator_address!r}, "
            f"num_processes={num_processes}, process_id={process_id})")
    if not coordinator_address or num_processes is None or process_id is None:
        raise ValueError(f"{what}: a multi-process launch needs all three")
    if not 0 <= process_id < num_processes:
        raise ValueError(f"{what}: process_id out of range")
    dev = rank_device(device)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError(f"{what}: NCCL needs a card, the rank's device is {dev}")
    kwargs = {}
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        if backend == "nccl":
            kwargs["device_id"] = dev  # NCCL binds its communicator to the card now
    try:
        dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                                world_size=num_processes, rank=process_id,
                                timeout=datetime.timedelta(seconds=timeout), **kwargs)
    except (RuntimeError, ValueError) as e:  # DistStoreError is a RuntimeError
        raise RuntimeError(f"{what} on {backend} failed: {e}") from e
    return _summary()


def _summary() -> dict:
    n = dist.get_world_size() if dist.is_initialized() else 1
    return {
        "process_index": dist.get_rank() if dist.is_initialized() else 0,
        "process_count": n,
        "local_devices": 1,
        "global_devices": n,
    }


def launcher_requested(args) -> bool:
    """Whether a CLI's ranks come from outside: --distributed or an
    explicit coordinator / process count, or a launcher's environment."""
    return bool(getattr(args, "distributed", False) or getattr(args, "coordinator", None)
                or getattr(args, "num_processes", None) is not None or detect_launch_env())


def free_port() -> int:
    """A TCP port on localhost that no process is listening on now."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_entry(main, argv, env) -> None:
    os.environ.update(env)
    main(argv)


def spawn_local_ranks(main, argv, num_ranks: int, cpu: bool) -> None:
    """Run main(argv) in num_ranks processes of this host (spawn), with
    torchrun's environment: rank r on card r, or all on the CPU. Waits
    for every rank; when one fails, ends the others and raises. More
    ranks than visible cards raises before any starts."""
    import torch.multiprocessing as mp

    if not cpu and num_ranks > torch.cuda.device_count():
        raise RuntimeError(f"{num_ranks} ranks, {torch.cuda.device_count()} visible cards: "
                           "one card per rank (or --cpu)")
    port = free_port()
    ctx = mp.get_context("spawn")
    procs = []
    for r in range(num_ranks):
        env = {"RANK": str(r), "WORLD_SIZE": str(num_ranks), "LOCAL_RANK": str(r),
               "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port)}
        procs.append(ctx.Process(target=_rank_entry, args=(main, list(argv), env)))
    for p in procs:
        p.start()
    try:
        while any(p.is_alive() for p in procs):
            for p in procs:
                p.join(0.5)
                if p.exitcode not in (None, 0):
                    raise RuntimeError(f"rank {procs.index(p)} exited with {p.exitcode}")
        bad = [(r, p.exitcode) for r, p in enumerate(procs) if p.exitcode != 0]
        if bad:
            raise RuntimeError(f"ranks failed (rank, exit code): {bad}")
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
            p.join(10)
