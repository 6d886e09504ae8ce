"""Baseline uncertainty scorers: deep-ensemble MI and MC-dropout MI.

Port of aod_meh_hua_tpu/al/baselines.py:32-119, which mirrors the
reference's mmdet/apis/CalEnsembleUnc.py:137-180 (independently trained
members; per-scale raw class logits -> sigmoid; the "entropy"
H = -sum_c s_c log s_c taken on the unnormalised sigmoid vector, kept
verbatim; epistemic = H(member mean) - mean member H; per image the mean
over each scale's anchors, then the mean over scales) and
CalMCDropoutUnc.py:137-199 (25 stochastic passes of a model with
Dropout2d(0.1) after every ReLU, the same MI across passes).

Each step accumulates two running sums, of the sigmoids and of the
entropies, so the members' or passes' outputs never coexist in memory
(the JAX MC step's lax.scan is a loop here, each pass drawing its
dropout masks from the caller's torch.Generator).

The log's clamp is the smallest normal float32, where the JAX package
clamps at 1e-38, below it: XLA flushes that constant to 0, and JAX's
score is NaN wherever a logit lies below about -87.3 (ROADMAP Queue 3).
Here the score stays finite whatever the device's denormal mode, and
equals JAX's wherever JAX's is finite.

The modules carry their weights, so where a JAX step takes
(variables_list, batch) or (variables, batch, key), the port's step is
built around the member modules or the MC model and takes (batch) or
(batch, generator).
"""

from __future__ import annotations

from typing import Callable, Iterable, Optional, Sequence, Tuple

import numpy as np
import torch

from ..engine.batch import EvalBatch, as_tensor, prepare_images
from ..utils.device import resolve_device

_TINY = torch.finfo(torch.float32).tiny


def _sig_entropy(logits: torch.Tensor) -> torch.Tensor:
    """The reference's -sum s log(s) over sigmoid outputs (unnormalised)."""
    s = torch.sigmoid(logits)
    return -(s * torch.log(s.clamp(min=_TINY))).sum(dim=-1)


def _scale_mean_epistemic(sum_sig: torch.Tensor, sum_h: torch.Tensor, n: int,
                          bounds) -> torch.Tensor:
    """epistemic per anchor -> mean per scale -> mean over scales [B]."""
    avg = sum_sig / n
    total = -(avg * torch.log(avg.clamp(min=_TINY))).sum(dim=-1)  # [B, A]
    epi = total - sum_h / n
    per_scale = [epi[:, s0:s1].mean(dim=1) for (s0, s1) in bounds]
    return torch.stack(per_scale, dim=1).mean(dim=1)


def _check_on(model: torch.nn.Module, dev: torch.device) -> None:
    param = next(model.parameters())
    if param.device.type != dev.type:
        raise ValueError(f"model is on {param.device}, the step on {dev}")


def _images(batch: EvalBatch, cfg, dev: torch.device) -> torch.Tensor:
    return prepare_images(as_tensor(batch.images, dev), as_tensor(batch.img_shapes, dev), cfg)


def make_ensemble_score_step(models: Sequence[torch.nn.Module], cfg,
                             device="cuda") -> Callable:
    """step(batch: EvalBatch) -> [B] ensemble MI on `device`, where every
    member lives: each member's raw cls logits (with_meh=False)."""
    dev = resolve_device(device)
    for m in models:
        _check_on(m, dev)
    bounds = cfg.level_bounds()

    @torch.no_grad()
    def step(batch: EvalBatch) -> torch.Tensor:
        images = _images(batch, cfg, dev)
        sum_sig = sum_h = None
        for model in models:
            cls = model(images, with_meh=False)[0]
            sig, h = torch.sigmoid(cls), _sig_entropy(cls)
            sum_sig = sig if sum_sig is None else sum_sig + sig
            sum_h = h if sum_h is None else sum_h + h
        return _scale_mean_epistemic(sum_sig, sum_h, len(models), bounds)

    return step


def make_mc_dropout_score_step(model: torch.nn.Module, cfg, num_passes: int = 25,
                               device="cuda") -> Callable:
    """step(batch: EvalBatch, generator) -> [B] MC-dropout MI on `device`.

    `model` is built with cfg.mc_dropout > 0 (dropout active in every
    forward); trained weights load into it unchanged, since dropout adds
    no parameter. Each pass draws its masks from `generator`, a
    torch.Generator on `device`; at cfg.mc_dropout 0 the passes are
    identical and the score is 0."""
    dev = resolve_device(device)
    _check_on(model, dev)
    bounds = cfg.level_bounds()

    @torch.no_grad()
    def step(batch: EvalBatch, generator: Optional[torch.Generator]) -> torch.Tensor:
        images = _images(batch, cfg, dev)
        sum_sig = sum_h = None
        for _ in range(num_passes):
            cls = model(images, with_meh=False, generator=generator)[0]
            sig, h = torch.sigmoid(cls), _sig_entropy(cls)
            sum_sig = sig if sum_sig is None else sum_sig + sig
            sum_h = h if sum_h is None else sum_h + h
        return _scale_mean_epistemic(sum_sig, sum_h, num_passes, bounds)

    return step


def _sweep(make_step: Callable, loader: Iterable[Tuple[str, EvalBatch, np.ndarray]],
           num_images: int, call: Callable) -> np.ndarray:
    """Scores of every pool image in dataset order (float64): one step per
    orientation, the padding rows of `batch.valid` dropped, as
    al/uncertainty.py score_pool scatters them."""
    steps = {}
    out = np.zeros(num_images)
    for orientation, batch, idx in loader:
        if orientation not in steps:
            steps[orientation] = make_step(orientation)
        idx = np.asarray(idx)
        u = call(steps[orientation], batch).cpu().numpy()[: len(idx)]
        valid = np.asarray(batch.valid)[: len(idx)]
        out[idx[valid]] = u[valid]
    return out


def score_pool_ensemble(models: Sequence[torch.nn.Module], cfg, loader, num_images: int,
                        device="cuda") -> np.ndarray:
    """The deep-ensemble sweep of the pool: [N] scores in dataset order."""
    return _sweep(lambda o: make_ensemble_score_step(models, cfg.for_orientation(o), device),
                  loader, num_images, lambda step, batch: step(batch))


def score_pool_mc_dropout(model: torch.nn.Module, cfg, loader, num_images: int,
                          generator: torch.Generator, num_passes: int = 25,
                          device="cuda") -> np.ndarray:
    """The MC-dropout sweep of the pool: [N] scores in dataset order. The
    batches draw their masks from `generator` in turn (the JAX sweep
    splits its key per batch)."""
    return _sweep(lambda o: make_mc_dropout_score_step(model, cfg.for_orientation(o),
                                                       num_passes, device),
                  loader, num_images, lambda step, batch: step(batch, generator))
