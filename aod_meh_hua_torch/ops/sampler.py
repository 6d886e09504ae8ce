"""Fixed-shape random pos/neg sampling for two-stage training (torch),
batched.

Port of aod_meh_hua_tpu/ops/sampler.py (`SampleResult`, `_ranks`,
`random_sample_pos_neg` :24-74; Libra R-CNN's `_group_ranks` and
`libra_sample_pos_neg` :76-166), whose random sampler mirrors the reference's
mmdet/core/bbox/samplers/random_sampler.py:10 (up to num * pos_fraction
positives drawn uniformly, the remaining slots filled with uniformly
drawn negatives; base_sampler.sample's neg_pos_ub cap). One static
program: random priorities ranked within the positive and negative sets,
a fixed [num] slot array (positives first, then negatives, the
reference's target order) and a validity mask for the under-full case.

The uniform draws are arguments: the JAX function draws them from its
key (kp, kn = split(key)), the port's callers from an explicit
torch.Generator, and a test passes JAX's own draws in to hold the
selection equal index for index. Libra R-CNN's sampler takes the seven
draws its JAX counterpart splits its key into.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

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


BIG_RANK = 2 ** 30


def _group_ranks(u: torch.Tensor, mask: torch.Tensor, group_id: torch.Tensor,
                 num_groups: int) -> torch.Tensor:
    """Rank (0 = first drawn) of each True element of `mask` [B, N] WITHIN
    its group (group_id [B, N] in [0, num_groups) where mask is True) by
    its draw `u`, ties by index; masked-out elements get BIG_RANK (JAX
    ops/sampler.py:76-89: a stable argsort, then each element's count of
    same-group elements before it in that order)."""
    pri = torch.where(mask, u, torch.full((), float("inf"), dtype=u.dtype, device=u.device))
    order = torch.argsort(pri, dim=1, stable=True)
    g_sorted = torch.where(torch.gather(mask, 1, order), torch.gather(group_id, 1, order),
                           torch.full_like(order, num_groups))
    onehot = torch.nn.functional.one_hot(g_sorted, num_groups + 1)
    before = torch.cumsum(onehot, dim=1) - onehot
    rank_sorted = torch.gather(before, 2, g_sorted[..., None])[..., 0]
    rank = torch.empty_like(order).scatter_(1, order, rank_sorted)
    return torch.where(mask, rank, torch.full_like(rank, BIG_RANK))


def libra_sample_pos_neg(u: Sequence[torch.Tensor], assigned: torch.Tensor,
                         valid: torch.Tensor, max_overlaps: torch.Tensor, num: int,
                         pos_fraction: float, num_gt: int, num_bins: int = 3) -> SampleResult:
    """Libra R-CNN's CombinedSampler as one static program (JAX
    ops/sampler.py:92-166; the reference's
    instance_balanced_pos_sampler.py:13 and iou_balanced_neg_sampler.py:9
    at floor_thr=-1, floor_fraction=0, num_bins=3).

    u: seven uniform draws [B, N] in JAX's split order (kp1, kp2, kp3,
    kp4, kn1, kn2, km = split(key, 7)). Positives: an equal share per gt
    instance (a rank within its gt's group under kp1, the first
    round(expected / num_gts) + 1 win; random extras under kp2 fill a
    shortfall, a random subset under kp3 cuts an overshoot). Negatives:
    binned by their max IoU into num_bins even intervals of [0, the
    largest max IoU of the valid candidates]; expected // num_bins drawn
    per bin under kn1, random leftovers under kn2 fill the rest (a
    candidate at the largest IoU falls past the last bin or into it, as
    the interval rounds: JAX's rounding under jit, below). The slots are
    ordered by kp4 (positives) and km (negatives). max_overlaps [B, N]:
    each candidate's max IoU over the valid gts, 0 for an invalid one."""
    kp1, kp2, kp3, kp4, kn1, kn2, km = u
    pos_mask = (assigned > 0) & valid
    neg_mask = (assigned == 0) & valid
    num_expected_pos = int(num * pos_fraction)

    # instance-balanced positives
    group = (assigned - 1).clamp(0, num_gt - 1)
    has_pos = torch.zeros(group.shape[0], num_gt, dtype=torch.long, device=group.device)
    has_pos.scatter_reduce_(1, group, pos_mask.long(), "amax")
    num_gts = has_pos.sum(dim=1).clamp(min=1)
    num_per_gt = (torch.round(num_expected_pos / num_gts.float()) + 1).long()
    g_rank = _group_ranks(kp1, pos_mask, group, num_gt)
    sel1 = pos_mask & (g_rank < num_per_gt[:, None])
    cnt1 = sel1.sum(dim=1)
    extra_rank = _ranks(kp2, pos_mask & ~sel1)
    sel_grown = sel1 | (pos_mask & ~sel1
                        & (extra_rank < (num_expected_pos - cnt1).clamp(min=0)[:, None]))
    shrink_rank = _ranks(kp3, sel1)
    sel_shrunk = sel1 & (shrink_rank < num_expected_pos)
    sel_pos = torch.where((cnt1 < num_expected_pos)[:, None], sel_grown, sel_shrunk)
    # take-all fast path: every positive fits the quota
    sel_pos = torch.where((pos_mask.sum(dim=1) <= num_expected_pos)[:, None], pos_mask, sel_pos)
    num_pos = sel_pos.sum(dim=1)

    # IoU-balanced negatives
    num_expected_neg = num - num_pos
    zero = torch.zeros((), dtype=max_overlaps.dtype, device=max_overlaps.device)
    max_iou = torch.where(valid, max_overlaps, zero).amax(dim=1)
    # JAX's step runs under jit, where XLA turns the division by the
    # constant num_bins into a product by its f32 reciprocal: at the
    # largest IoU that decides the bin edge, so the port multiplies too
    interval = max_iou.clamp(min=1e-12) * torch.tensor(
        1.0 / num_bins, dtype=max_iou.dtype, device=max_iou.device)
    bin_id = torch.floor(max_overlaps / interval[:, None]).long()
    in_bins = neg_mask & (bin_id >= 0) & (bin_id < num_bins)
    per_num = torch.div(num_expected_neg, num_bins, rounding_mode="floor")
    b_rank = _group_ranks(kn1, in_bins, bin_id.clamp(0, num_bins - 1), num_bins)
    sel_b = in_bins & (b_rank < per_num[:, None])
    cntb = sel_b.sum(dim=1)
    nx_rank = _ranks(kn2, neg_mask & ~sel_b)
    sel_neg = sel_b | (neg_mask & ~sel_b
                       & (nx_rank < (num_expected_neg - cntb).clamp(min=0)[:, None]))
    sel_neg = torch.where((neg_mask.sum(dim=1) <= num_expected_neg)[:, None], neg_mask, sel_neg)

    # pack into fixed slots, positives first
    pos_order = _ranks(kp4, sel_pos)
    neg_order = _ranks(km, sel_neg)
    priority = torch.where(sel_pos, pos_order,
                           torch.where(sel_neg, num + neg_order,
                                       torch.full_like(neg_order, BIG_RANK)))
    order = torch.argsort(priority, dim=1, stable=True)[:, :num]
    slot_ok = torch.gather(priority, 1, order) < BIG_RANK
    inds = torch.where(slot_ok, order, 0)
    return SampleResult(inds, torch.gather(sel_pos, 1, order) & slot_ok, slot_ok, num_pos)
