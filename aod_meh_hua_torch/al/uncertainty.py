"""Pool scoring: run the score step over the whole pool.

Port of aod_meh_hua_tpu/al/uncertainty.py:26-104 (`score_num_objects`, a
numpy copy of :26-31, and `score_pool`), which mirrors the reference's
apis/test.py:19-70 (Random = a permutation; Entropy_* = a
sweep of the pool) and :90-135 (single_gpu_uncertainty). Scores scatter
back to dataset order, so the result indexes like the reference's
uncertainty vector.
"""

from __future__ import annotations

from typing import Iterable, Optional, Tuple

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
) -> Tuple[np.ndarray, np.ndarray]:
    """Score every pool image. `loader` is any iterable of (orientation,
    EvalBatch, indices) triples, EvalLoader's contract; `indices` maps
    each row to its dataset index and `batch.valid` marks padding rows.
    Returns (uncertainty [N], max_conf [N]) in dataset order, float64.
    With hua.mi_mode="sampled", every batch draws from `generator` (on
    `device`; the JAX package passes its key to every batch); the step
    raises without one.

    Batch k+1 is uploaded before batch k's scores are read back.
    """
    if cfg.hua.pool == "Random":
        if rng is None:
            raise ValueError("the Random pool needs an rng")
        return rng.permutation(num_images).astype(np.float64), np.zeros(num_images)

    dev = resolve_device(device)
    steps = {o: make_score_step(model, cfg.for_orientation(o), device=dev)
             for o in ("landscape", "portrait")}
    unc = np.zeros(num_images, np.float64)
    mconf = np.zeros(num_images, np.float64)

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
    return unc, mconf
