"""PyTorch / CUDA port of the DDP/iLQG framework, for NVIDIA Hopper (H100).

Sits beside the JAX package ``differentialdynamicprogramming_jl_tpu``, which
stays the reference, and keeps its module paths and public names. This slice
covers the fleet iLQG main path: :func:`ilqg_batch_lanes` on the pendcart
model with in-kernel derivatives, m = 1 and static control limits. Its three
kernels (backward pass, forward rollout, fused line search) are CUDA C++
under ``ops/hopper/csrc/``, built with ``nvcc`` at first use; each has a
plain PyTorch version beside it, which runs for CPU tensors.

Nothing in this package imports ``jax``.
"""

from .policy import GaussianPolicy, Derivs
from .solvers.ilqg import ILQGConfig, default_alphas, tol_fun_effective
from .solvers.batch import (ilqg_batch_lanes, ilqg_iteration_lanes,
                            mpc_rollout_lanes, BatchILQGResult, BatchTrace,
                            split_lims)
from .models.pendcart import (PendCartSpec, pendcart_lanes,
                              pendcart_derivs_tiles, default_x0, default_lims)

__version__ = "0.1.0"

__all__ = [
    "GaussianPolicy", "Derivs",
    "ILQGConfig", "default_alphas", "tol_fun_effective",
    "ilqg_batch_lanes", "ilqg_iteration_lanes", "mpc_rollout_lanes",
    "BatchILQGResult", "BatchTrace", "split_lims",
    "PendCartSpec", "pendcart_lanes", "pendcart_derivs_tiles",
    "default_x0", "default_lims",
]
