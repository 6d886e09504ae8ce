"""Cross-process collection for multi-process runs.

Port of aod_meh_hua_tpu/parallel/dist.py (`rank_indices` is a copy of
:24-27), whose parity targets are the reference's multi_gpu_test
(mmdet/apis/test.py:197-315): a rank-sliced loader (DistributedSampler,
shuffle=False), then the results collected either through a shared-FS
pickle directory (collect_results_cpu, :242) or an all_gather of
pickled bytes (collect_results_gpu, :285-315).

The pool and eval sweeps are embarrassingly parallel per rank; the only
cross-process traffic is one collective at the end: dense score vectors
ride an all_reduce (allgather_sum), ragged detection lists ride
all_gather_object (collect_objects). With no process group each is the
identity.
"""

from __future__ import annotations

import datetime
from typing import Any, List, Optional

import numpy as np
import torch
import torch.distributed as dist


def rank_indices(n: int, process_id: int, process_count: int) -> np.ndarray:
    """Strided rank slice of [0, n): keeps the orientation mix balanced
    across ranks (the DistributedSampler analog, shuffle=False)."""
    return np.arange(process_id, n, process_count, dtype=np.int64)


def _world() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def _collective_device() -> torch.device:
    """Where a collective's tensor must live: the rank's card under NCCL,
    the host under gloo."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def allgather_sum(x: np.ndarray) -> np.ndarray:
    """Sum a dense per-image vector across processes, in float64. Each
    rank fills only its slice (zeros elsewhere), so the sum is the
    concatenation in dataset order."""
    if _world() == 1:
        return x
    t = torch.from_numpy(np.ascontiguousarray(x, dtype=np.float64)).to(_collective_device())
    dist.all_reduce(t, op=dist.ReduceOp.SUM)
    return t.cpu().numpy()


def barrier(tag: str = "barrier", timeout_s: Optional[float] = None) -> None:
    """Wait for every rank. Under gloo a monitored barrier, which names
    the ranks that did not arrive within timeout_s (default: the process
    group's timeout); under NCCL the group's barrier, bounded by the
    group's timeout. `tag` names the barrier in the error."""
    if _world() == 1:
        return
    if dist.get_backend() == "gloo":
        kwargs = {} if timeout_s is None else {"timeout": datetime.timedelta(seconds=timeout_s)}
        try:
            dist.monitored_barrier(**kwargs)
        except RuntimeError as e:
            raise RuntimeError(f"barrier {tag!r}: {e}") from e
    else:
        dist.barrier(device_ids=[torch.cuda.current_device()])


def collect_objects(work_dir: str, tag: str, obj: Any) -> List[Any]:
    """Every rank's `obj`, in rank order, on every rank: all_gather_object,
    the collect_results_gpu analog (JAX :72-99 exchanges pickles through
    `work_dir` instead; the port needs no shared file system, and keeps
    the signature, as it does `tag`)."""
    if _world() == 1:
        return [obj]
    out: List[Any] = [None] * _world()
    dist.all_gather_object(out, obj)
    return out
