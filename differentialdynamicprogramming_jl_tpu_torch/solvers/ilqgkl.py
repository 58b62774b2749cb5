"""KL-divergence-constrained iLQG (GPS trust-region solver): options and
result types.

Counterpart of the head of
``differentialdynamicprogramming_jl_tpu/solvers/ilqgkl.py:38-76`` (reference
``iLQGkl``, ``src/iLQGkl.jl:25-252``). The fleet solver that uses them is
:func:`~.batch_kl.ilqgkl_batch_lanes`. The generic single-problem
``ilqg_kl`` is not part of this slice.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Optional, Tuple

import torch

from ..policy import GaussianPolicy


@dataclasses.dataclass(frozen=True)
class ILQGKLConfig:
    """Options of the reference ``iLQGkl`` (``src/iLQGkl.jl:25-42``). Field
    names and defaults follow the JAX package's ``ILQGKLConfig``."""

    kl_step: float = 1.0
    constrain_per_step: bool = False
    max_iter: int = 50
    tol_fun: float = 1e-7
    tol_grad: float = 1e-4
    eta_bracket: Tuple[float, float, float] = (1e-8, 1.0, 1e16)
    del0: float = 1e-4
    gd_alpha: float = 0.01          # ADAM step for per-timestep η
    verbosity: int = 0
    print_head: int = 10            # src/iLQGkl.jl:32
    print_period: int = 1           # src/iLQGkl.jl:33
    qp_max_iter: int = 100
    # retry-loop safety: the reference's scalar η-escalation loop has no
    # abort (src/iLQGkl.jl:111-121 commented out); the retry stops once η
    # exceeds the bracket maximum, and after retry_cap relaunches
    retry_cap: int = 200


class ILQGKLResult(NamedTuple):
    """Result of the generic single-problem solver (the JAX ``ilqg_kl``)."""

    x: torch.Tensor
    u: torch.Tensor
    policy: GaussianPolicy
    Vx: torch.Tensor
    Vxx: torch.Tensor
    cost: torch.Tensor
    trace: Any
    n_iters: torch.Tensor
    eta: torch.Tensor              # final η (scalar or (T,))
    eta_bracket: torch.Tensor
    divergence: torch.Tensor       # final measured KL (scalar mean or (T,))
    satisfied: torch.Tensor
    kl_violated: torch.Tensor      # reference final warning (src/iLQGkl.jl:248)
    pd_failed: Optional[torch.Tensor] = None  # a Σ went indefinite in the KL
    #                                           measurement (src/klutils.jl:84)


def ilqg_kl(*args, **kwargs):
    """The generic XLA-tier KL solver of the JAX package; a later slice."""
    raise NotImplementedError("ilqg_kl is not ported yet")
