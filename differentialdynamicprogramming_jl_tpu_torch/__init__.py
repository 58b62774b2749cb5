"""PyTorch / CUDA port of the DDP/iLQG framework, for NVIDIA Hopper (H100).

Sits beside the JAX package ``differentialdynamicprogramming_jl_tpu``, which
stays the reference, and keeps its module paths and public names.

The generic tier — the reference's own front door — is plain PyTorch on the
inputs' device: :func:`ilqg` (any n and m, limits, full DDP, the α-sweep,
pre-rolled and resume entries, ``iter_callback``, verbosity), written
batch-first so that ``parallel.mesh.ilqg_batched`` solves many problems in
one call; :func:`boxqp`, :func:`boxqp_1d` and :func:`demo_qp`;
:func:`backward_pass`, :func:`forward_pass` and :func:`line_search`;
:func:`parallel_riccati` (``ILQGConfig(backward="parallel")``); and the
KL-constrained :func:`ilqg_kl` with the KL utilities of ``ops/kl.py``.

The port covers the fleet paths with in-kernel derivatives and control
limits that are static, per scenario or none: the iLQG main path
:func:`ilqg_batch_lanes` on the pendcart model (n=4, m=1) and on the LTI
family (the CUDA kernels at n=10, m=2), with its warm-start, pre-rolled and
resume entries and per-scenario model parameters (heterogeneous fleets,
``models.pendcart.pendcart_lanes_param``); the MPC serving loop
:func:`mpc_rollout_lanes` and its per-step hot path
:func:`ilqg_iteration_lanes`; the KL/GPS trust-region path
:func:`ilqgkl_batch_lanes` with :func:`gps_rollout_lanes` on both models;
the fleet scheduler :func:`ilqg_fleet` / :func:`ilqgkl_fleet`, which
compacts the scenarios still running between chunks, and its sharded
forms over ``parallel.mesh`` (``parallel.distributed`` runs several
processes on ``torch.distributed``);
and any lane model through
:func:`autodiff_derivs_tiles`, whose derivative expansion is made by
forward-mode autodiff (on the card for pendcart and the quadrotor,
``models/quadrotor.py``, n=6, m=2), first order or with the dynamics
Hessians of full DDP. The backward kernel also reads a packed-derivatives
stream made outside it (:func:`autodiff_packed_derivs`,
``models.pendcart.pendcart_packed_derivs``,
``models.linear.lti_packed_derivs``), which the fleet driver caches
across λ-retries. Their four kernels (backward pass with
GPS mode, forward rollout, fused line search, covariance propagation) and
the bandwidth probe are CUDA C++ under ``ops/hopper/csrc/``, built with
``nvcc`` at first use; each has a plain PyTorch version beside it, which
runs for CPU tensors.
Around them: the JAX package's demos (:mod:`.demos`, ``python -m
differentialdynamicprogramming_jl_tpu_torch.demos``), the pendcart's LQR
baseline, ``.npz`` checkpoints (:mod:`.utils.serialization`), per-phase
timing (:mod:`.utils.profiling`), optional plots (:mod:`.utils.plotting`),
and solver export as a recipe of the recorded solver call
(:func:`serialize_solver`, :mod:`.utils.aot`).
Inputs that are not tensors go to the CUDA card (:mod:`.device`).

Nothing in this package imports ``jax``.
"""

from .policy import GaussianPolicy, Trace, Derivs, sym
from .ops.boxqp import boxqp, boxqp_1d, demo_qp, BoxQPResult, QPTrace
from .ops.backward import backward_pass, BackwardOut, KLTerms
from .ops.forward import (forward_pass, line_search, forward_covariance,
                          Rollout)
from .ops.riccati_scan import parallel_riccati
from .ops.kl import (grad_kl, kl_div_gaussian, kl_div_wiki, entropy,
                     calc_eta, AdamState, adam_init, adam_update)
from .solvers.ilqg import (ilqg, ILQGConfig, ILQGResult, default_alphas,
                           tol_fun_effective)
from .solvers.batch import (ilqg_batch_lanes, ilqg_iteration_lanes,
                            mpc_rollout_lanes, BatchILQGResult, BatchTrace,
                            split_lims)
from .solvers.ilqgkl import ilqg_kl, ILQGKLConfig
from .solvers.fleet import (ilqg_fleet, ilqg_fleet_sharded, ilqgkl_fleet,
                            ilqgkl_fleet_sharded)
from .solvers.batch_kl import (ilqgkl_batch_lanes, gps_rollout_lanes,
                               BatchKLResult, BatchKLTrace,
                               kl_div_wiki_lanes, calc_eta_lanes)
from .problem import Problem, broadcast_derivs, make_autodiff_derivs
from .models.pendcart import (PendCartSpec, pendcart_lanes,
                              pendcart_derivs_tiles, make_pendcart_problem,
                              default_x0, default_lims)
from .models.linear import (LTISpec, random_lti, make_lti_problem,
                            lti_lanes, lti_derivs_tiles, SimpleLTVModel)
from .ops.hopper.autodiff_tiles import (autodiff_derivs_tiles,
                                        autodiff_packed_derivs)
from .utils.aot import (export_solver, serialize_solver, deserialize_solver,
                        save_solver, load_solver)

__version__ = "0.1.0"

__all__ = [
    "GaussianPolicy", "Trace", "Derivs", "sym",
    "boxqp", "boxqp_1d", "demo_qp", "BoxQPResult", "QPTrace",
    "backward_pass", "BackwardOut", "KLTerms",
    "forward_pass", "line_search", "Rollout",
    "grad_kl", "kl_div_gaussian", "kl_div_wiki", "entropy", "calc_eta",
    "AdamState", "adam_init", "adam_update",
    "parallel_riccati",
    "ilqg", "ILQGResult", "ilqg_kl",
    "ILQGConfig", "default_alphas", "tol_fun_effective",
    "ilqg_batch_lanes", "ilqg_iteration_lanes", "mpc_rollout_lanes",
    "BatchILQGResult", "BatchTrace", "split_lims",
    "ILQGKLConfig", "ilqgkl_batch_lanes", "gps_rollout_lanes",
    "BatchKLResult", "BatchKLTrace", "kl_div_wiki_lanes", "calc_eta_lanes",
    "ilqg_fleet", "ilqg_fleet_sharded", "ilqgkl_fleet",
    "ilqgkl_fleet_sharded",
    "Problem", "broadcast_derivs", "make_autodiff_derivs",
    "autodiff_derivs_tiles", "autodiff_packed_derivs",
    "PendCartSpec", "pendcart_lanes", "pendcart_derivs_tiles",
    "make_pendcart_problem", "default_x0", "default_lims",
    "LTISpec", "random_lti", "make_lti_problem", "lti_lanes",
    "lti_derivs_tiles", "SimpleLTVModel", "forward_covariance",
    "export_solver", "serialize_solver", "deserialize_solver",
    "save_solver", "load_solver",
]
