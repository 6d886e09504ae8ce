"""Pool scoring: run the score step over the whole pool.

Port of aod_meh_hua_tpu/al/uncertainty.py:26-104 (`score_num_objects`, a
numpy copy of :26-31, and `score_pool`), which mirrors the reference's
apis/test.py:19-70 (Random = a permutation; Entropy_* = a
sweep of the pool) and :90-135 (single_gpu_uncertainty). Scores scatter
back to dataset order, so the result indexes like the reference's
uncertainty vector. Across ranks each process sweeps its own slice (a
loader over parallel.rank_indices) and the ranks' vectors meet in
parallel.allgather_sum (apis/test.py:197-315).
"""

from __future__ import annotations

import time
from typing import Dict, Iterable, Optional, Tuple

import numpy as np
import torch

from ..engine.batch import EvalBatch
from ..engine.score import make_score_step
from ..utils.config import RetinaNetConfig
from ..utils.device import resolve_device


def score_num_objects(dataset, indices) -> np.ndarray:
    """cal_numObj (reference apis/test.py:73-88): each image's GT object
    count as its acquisition score (an oracle scorer). A copy of
    aod_meh_hua_tpu/al/uncertainty.py:26-31."""
    return np.array([len(dataset.get_ann_info(int(i))["labels"]) for i in indices],
                    dtype=np.float64)


def _upload(a, device: torch.device) -> torch.Tensor:
    """Host array -> device tensor; from pinned memory without blocking
    the host when the device is a card."""
    t = a if isinstance(a, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(a))
    if device.type == "cuda" and t.device.type == "cpu":
        t = t.pin_memory()
    return t.to(device, non_blocking=True)


def score_pool(
    model,
    cfg: RetinaNetConfig,
    loader: Iterable[Tuple[str, EvalBatch, np.ndarray]],
    num_images: int,
    rng: Optional[np.random.RandomState] = None,
    device="cuda",
    generator: Optional[torch.Generator] = None,
    progress: bool = False,
    steps: Optional[Dict[str, object]] = None,
    mesh=None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Score every pool image. `loader` is any iterable of (orientation,
    EvalBatch, indices) triples, EvalLoader's contract; `indices` maps
    each row to its dataset index and `batch.valid` marks padding rows.
    Returns (uncertainty [N], max_conf [N]) in dataset order, float64.
    With hua.mi_mode="sampled", every batch draws from `generator` (on
    `device`; the JAX package passes its key to every batch); the step
    raises without one.

    Batch k+1 is uploaded before batch k's scores are read back.

    progress: print the count and rate every 512 images (JAX's).
    steps: {orientation: make_score_step(...)} to reuse; built when None.
    mesh: the JAX argument splits each batch over the mesh's devices; a
    port process holds one device, so a mesh of one rank runs as is and
    a larger one raises (slice the pool across ranks instead: a loader
    over parallel.rank_indices, merged with parallel.allgather_sum).
    """
    if mesh is not None and mesh.size() > 1:
        raise ValueError(f"score_pool runs on this process's one device; the mesh spans "
                         f"{mesh.size()} ranks: give each rank a loader over its "
                         "parallel.rank_indices and merge with parallel.allgather_sum")
    if cfg.hua.pool == "Random":
        if rng is None:
            raise ValueError("the Random pool needs an rng")
        return rng.permutation(num_images).astype(np.float64), np.zeros(num_images)

    dev = resolve_device(device)
    if steps is None:
        steps = {o: make_score_step(model, cfg.for_orientation(o), device=dev)
                 for o in ("landscape", "portrait")}
    unc = np.zeros(num_images, np.float64)
    mconf = np.zeros(num_images, np.float64)
    t0, n_done = time.time(), 0

    def stage(item):
        if item is None:
            return None
        orientation, batch, idx = item
        up = EvalBatch(_upload(batch.images, dev), _upload(batch.img_shapes, dev),
                       _upload(batch.scale_factors, dev), np.asarray(batch.valid))
        return orientation, up, np.asarray(idx)

    it = iter(loader)
    cur = stage(next(it, None))
    while cur is not None:
        orientation, batch, idx = cur
        u, mc = steps[orientation](batch, generator)
        cur = stage(next(it, None))  # upload k+1 while k computes
        u = u.cpu().numpy()[: len(idx)]
        mc = mc.cpu().numpy()[: len(idx)]
        valid = batch.valid[: len(idx)]
        unc[idx[valid]] = u[valid]
        mconf[idx[valid]] = mc[valid]
        n_done += int(valid.sum())
        if progress and n_done % 512 < len(idx):
            rate = n_done / max(time.time() - t0, 1e-9)
            print(f"  scored {n_done}/{num_images} ({rate:.1f} img/s)")
    return unc, mconf
