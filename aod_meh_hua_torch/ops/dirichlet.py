"""Dirichlet uncertainty in closed form: mutual information (epistemic),
expected entropy (aleatoric), entropy of the mean (total).

Port of aod_meh_hua_tpu/ops/dirichlet.py:32-52. For concentrations a
(S = sum a, p = a / S):

  E[H(sample)] = -sum_i p_i * (digamma(a_i + 1) - digamma(S + 1))
  H(E[sample]) = -sum_i p_i * log(p_i)
  MI           = H(E[sample]) - E[H(sample)]

This is the limit of the reference's 500-sample estimate
(Lambda_L2.py:519-525). `dirichlet_mi_sampled` keeps that estimate as a
seeded parity mode (aod_meh_hua_tpu/ops/dirichlet.py:55-85).
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class DirichletUncertainty(NamedTuple):
    epistemic: torch.Tensor  # mutual information
    aleatoric: torch.Tensor  # expected entropy
    total: torch.Tensor      # entropy of the expected distribution


def _xlogx(p: torch.Tensor) -> torch.Tensor:
    return torch.where(p > 0, p * torch.log(p.clamp(min=1e-38)), torch.zeros_like(p))


def dirichlet_mutual_information(alpha: torch.Tensor, eps: float = 1e-20) -> DirichletUncertainty:
    """Closed-form decomposition over the last axis of alpha [..., C]."""
    alpha = alpha.clamp(min=eps)
    s = alpha.sum(dim=-1, keepdim=True)
    p = alpha / s
    total = -_xlogx(p).sum(dim=-1)
    aleatoric = -(p * (torch.digamma(alpha + 1.0) - torch.digamma(s + 1.0))).sum(dim=-1)
    return DirichletUncertainty(total - aleatoric, aleatoric, total)


def _log_dirichlet(alpha: torch.Tensor, n: int, generator: torch.Generator) -> torch.Tensor:
    """log of n Dirichlet(alpha) draws, [n, ..., C], sampled in log space.

    torch's own sampler (torch._sample_dirichlet, under
    torch.distributions.Dirichlet) normalises gamma draws that underflow
    at small concentrations: alpha = 1e-8 gives the uniform point on
    every draw, where the mass sits at the vertices. Here
    log G(a) = log G(a + 1) + log(U) / a, U in (0, 1], which stays finite
    for every a > 0, and log p = log G - logsumexp(log G).
    """
    a = alpha.expand((n,) + alpha.shape)
    log_g = torch.log(torch._standard_gamma(a + 1.0, generator=generator))
    u = 1.0 - torch.rand(a.shape, generator=generator, dtype=a.dtype, device=a.device)
    log_g = log_g + torch.log(u) / a
    return log_g - torch.logsumexp(log_g, dim=-1, keepdim=True)


def dirichlet_mi_sampled(alpha: torch.Tensor, generator: torch.Generator,
                         num_samples: int = 500, chunk: int = 50,
                         eps: float = 1e-20) -> DirichletUncertainty:
    """Monte-Carlo decomposition over the last axis of alpha [..., C]:
    total = H(mean of the draws), aleatoric = mean of H(draw). Draws come
    `chunk` at a time from `generator` (on alpha's device), so chunk x
    alpha stays alive; the sample-mean distribution and the mean entropy
    accumulate across chunks, the two statistics the reference reduces to.
    """
    if num_samples % chunk:
        raise ValueError(f"num_samples {num_samples} is not a multiple of chunk {chunk}")
    alpha = alpha.clamp(min=eps)
    sum_p = torch.zeros_like(alpha)
    sum_h = torch.zeros(alpha.shape[:-1], dtype=alpha.dtype, device=alpha.device)
    for _ in range(num_samples // chunk):
        log_p = _log_dirichlet(alpha, chunk, generator)
        p = torch.exp(log_p)
        sum_p += p.sum(dim=0)
        sum_h -= (p * log_p).sum(dim=-1).sum(dim=0)
    total = -_xlogx(sum_p / num_samples).sum(dim=-1)
    aleatoric = sum_h / num_samples
    return DirichletUncertainty(total - aleatoric, aleatoric, total)
