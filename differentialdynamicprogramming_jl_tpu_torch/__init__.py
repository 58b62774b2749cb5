"""PyTorch / CUDA port of the DDP/iLQG framework, for NVIDIA Hopper (H100).

Sits beside the JAX package ``differentialdynamicprogramming_jl_tpu``, which
stays the reference, and keeps its module paths and public names. The port
covers two fleet paths on the pendcart model with in-kernel derivatives and
m = 1, with static control limits or none: the iLQG main path
:func:`ilqg_batch_lanes`, and the KL/GPS trust-region path
:func:`ilqgkl_batch_lanes` with :func:`gps_rollout_lanes`. Their four
kernels (backward pass with GPS mode, forward rollout, fused line search,
covariance propagation) are CUDA C++ under ``ops/hopper/csrc/``, built with
``nvcc`` at first use; each has a plain PyTorch version beside it, which
runs for CPU tensors.

Nothing in this package imports ``jax``.
"""

from .policy import GaussianPolicy, Derivs
from .solvers.ilqg import ILQGConfig, default_alphas, tol_fun_effective
from .solvers.batch import (ilqg_batch_lanes, ilqg_iteration_lanes,
                            mpc_rollout_lanes, BatchILQGResult, BatchTrace,
                            split_lims)
from .solvers.ilqgkl import ILQGKLConfig
from .solvers.batch_kl import (ilqgkl_batch_lanes, gps_rollout_lanes,
                               BatchKLResult, BatchKLTrace,
                               kl_div_wiki_lanes, calc_eta_lanes)
from .problem import Problem
from .models.pendcart import (PendCartSpec, pendcart_lanes,
                              pendcart_derivs_tiles, make_pendcart_problem,
                              default_x0, default_lims)

__version__ = "0.1.0"

__all__ = [
    "GaussianPolicy", "Derivs",
    "ILQGConfig", "default_alphas", "tol_fun_effective",
    "ilqg_batch_lanes", "ilqg_iteration_lanes", "mpc_rollout_lanes",
    "BatchILQGResult", "BatchTrace", "split_lims",
    "ILQGKLConfig", "ilqgkl_batch_lanes", "gps_rollout_lanes",
    "BatchKLResult", "BatchKLTrace", "kl_div_wiki_lanes", "calc_eta_lanes",
    "Problem",
    "PendCartSpec", "pendcart_lanes", "pendcart_derivs_tiles",
    "make_pendcart_problem", "default_x0", "default_lims",
]
