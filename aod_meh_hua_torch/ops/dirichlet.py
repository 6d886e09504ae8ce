"""Dirichlet uncertainty in closed form: mutual information (epistemic),
expected entropy (aleatoric), entropy of the mean (total).

Port of aod_meh_hua_tpu/ops/dirichlet.py:32-52. For concentrations a
(S = sum a, p = a / S):

  E[H(sample)] = -sum_i p_i * (digamma(a_i + 1) - digamma(S + 1))
  H(E[sample]) = -sum_i p_i * log(p_i)
  MI           = H(E[sample]) - E[H(sample)]

This is the limit of the reference's 500-sample estimate
(Lambda_L2.py:519-525). The JAX package's seeded sampled mode is not in
the port yet (ROADMAP Queue 1).
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
