"""Fixed-shape random pos/neg sampling for two-stage training (torch),
batched.

Port of aod_meh_hua_tpu/ops/sampler.py (`SampleResult`, `_ranks`,
`random_sample_pos_neg` :24-74), which mirrors the reference's
mmdet/core/bbox/samplers/random_sampler.py:10 (up to num * pos_fraction
positives drawn uniformly, the remaining slots filled with uniformly
drawn negatives; base_sampler.sample's neg_pos_ub cap). One static
program: random priorities ranked within the positive and negative sets,
a fixed [num] slot array (positives first, then negatives, the
reference's target order) and a validity mask for the under-full case.

The uniform draws are arguments: the JAX function draws them from its
key (kp, kn = split(key)), the port's callers from an explicit
torch.Generator, and a test passes JAX's own draws in to hold the
selection equal index for index. Libra R-CNN's sampler
(`libra_sample_pos_neg`) comes with its family (ROADMAP Queue 1 item 15).
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class SampleResult(NamedTuple):
    inds: torch.Tensor     # [B, num] int64 indices into the candidates
    is_pos: torch.Tensor   # [B, num] bool
    valid: torch.Tensor    # [B, num] bool (False for unfilled slots)
    num_pos: torch.Tensor  # [B] int64


def _ranks(u: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Rank (0 = first drawn) of each True element of `mask` [B, N] by its
    uniform draw `u` [B, N], ties by index (a stable sort, as jnp.argsort);
    masked-out elements rank after every True one."""
    pri = torch.where(mask, u, torch.full((), float("inf"), dtype=u.dtype, device=u.device))
    order = torch.argsort(pri, dim=1, stable=True)
    rank = torch.empty_like(order)
    rank.scatter_(1, order, torch.arange(order.shape[1], device=u.device).expand_as(order))
    return rank


def random_sample_pos_neg(u_pos: torch.Tensor, u_neg: torch.Tensor, assigned: torch.Tensor,
                          valid: torch.Tensor, num: int, pos_fraction: float,
                          neg_pos_ub: int = -1) -> SampleResult:
    """assigned [B, N] in mmdet's encoding (-1 ignore, 0 background, g + 1
    gt g); valid [B, N] candidate validity; u_pos, u_neg [B, N] uniform
    draws in [0, 1) that rank the positives and the negatives. Returns a
    SampleResult of [B, num] slots. neg_pos_ub >= 0 caps the negatives at
    neg_pos_ub * max(1, num_pos)."""
    pos_mask = (assigned > 0) & valid
    neg_mask = (assigned == 0) & valid
    num_expected_pos = int(num * pos_fraction)

    pos_rank = _ranks(u_pos, pos_mask)
    sel_pos = pos_mask & (pos_rank < num_expected_pos)
    num_pos = pos_mask.sum(dim=1).clamp(max=num_expected_pos)

    num_neg = num - num_pos  # neg_pos_ub = -1: negatives fill the rest
    if neg_pos_ub >= 0:
        num_neg = torch.minimum(num_neg, neg_pos_ub * num_pos.clamp(min=1))
    neg_rank = _ranks(u_neg, neg_mask)
    sel_neg = neg_mask & (neg_rank < num_neg[:, None])

    big = 2 ** 30
    priority = torch.where(sel_pos, pos_rank,
                           torch.where(sel_neg, num + neg_rank, torch.full_like(neg_rank, big)))
    order = torch.argsort(priority, dim=1, stable=True)[:, :num]
    slot_ok = torch.gather(priority, 1, order) < big
    inds = torch.where(slot_ok, order, 0)
    return SampleResult(inds, torch.gather(sel_pos, 1, order) & slot_ok, slot_ok, num_pos)
