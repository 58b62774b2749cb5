"""Solver options shared by the iLQG solvers.

Counterpart of the pure-Python head of
``differentialdynamicprogramming_jl_tpu/solvers/ilqg.py:32-97``. The generic
single-problem ``ilqg`` solver is not part of this slice.

Exit reasons: 0 running / iteration cap, 1 gradient norm < tol_grad
(``src/iLQG.jl:258-261``), 2 cost change < tol_fun (``src/iLQG.jl:306-309``),
3 λ > λmax (``src/iLQG.jl:319-322``), 4 max accepted iterations
(``src/iLQG.jl:334``), 5 initial rollout diverged (``src/iLQG.jl:205-210``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch


def default_alphas(lo: float = 0.0, hi: float = -3.0, num: int = 11):
    """Reference backtracking coefficients 10^linspace(0,-3,11)
    (``src/iLQG.jl:145``)."""
    return tuple(float(a) for a in np.power(10.0, np.linspace(lo, hi, num)))


@dataclasses.dataclass(frozen=True)
class ILQGConfig:
    """Solver options — kwargs of the reference ``iLQG``
    (``src/iLQG.jl:143-163``). Field names and defaults follow the JAX
    package's ``ILQGConfig``."""

    alphas: Tuple[float, ...] = default_alphas()
    # cost-change exit threshold (src/iLQG.jl:150); the working threshold is
    # max(tol_fun, 8·eps(dtype)·|cost|), see tol_fun_effective
    tol_fun: float = 1e-7
    tol_grad: float = 1e-4
    max_iter: int = 500
    lam: float = 1.0
    dlam: float = 1.0
    lam_factor: float = 1.6
    lam_max: float = 1e10
    lam_min: float = 1e-6
    reg_type: int = 1
    reduce_ratio_min: float = 0.0
    # 0: silent, 1: begin/exit messages, 2: iteration table (src/iLQG.jl:133)
    verbosity: int = 0
    print_head: int = 10
    qp_max_iter: int = 100
    backward: str = "scan"
    # total-iteration cap (accepted + rejected); None → max_iter + 128
    iter_cap: Optional[int] = None

    def cap(self) -> int:
        return self.iter_cap if self.iter_cap is not None else self.max_iter + 128


def tol_fun_effective(tol_fun: float, cost_total: torch.Tensor) -> torch.Tensor:
    """Cost-change exit threshold floored at the dtype's cost resolution:
    ``max(tol_fun, 8·eps·|cost|)``. In f32 the reference's ``dcost < 1e-7``
    absolute (``src/iLQG.jl:306``) is unreachable for any |cost| > ~0.1, so
    without the floor an f32 solve never takes the cost exit and instead
    escalates λ until it aborts."""
    eps = torch.finfo(cost_total.dtype).eps
    return torch.clamp_min(8.0 * eps * torch.abs(cost_total), tol_fun)
