"""Iteration printing: the reference's verbosity surface, as host prints.

Counterpart of ``differentialdynamicprogramming_jl_tpu/utils/printing.py``,
with its text line for line: the iLQG iteration table with periodic headers
(``src/iLQG.jl:288-297``), the EXIT/SUCCESS messages
(``src/iLQG.jl:259,306,319``), the iLQGkl period table
(``src/iLQGkl.jl:151-159``), the fleet drivers' aggregate rows and the
boxQP progress lines
(``src/boxQP.jl:65-66,153-156,181-184``). Arguments may be tensors (read
with ``.item()``, a host sync each) or numbers; the solvers call these only
when their verbosity asks for them.
"""
from __future__ import annotations

import math

import torch

_ILQG_HEADER = ("iteration     cost        reduction   expected    "
                "gradient    log10(lam)")

_ILQGKL_HEADER = ("iteration     est. cost     reduction     expected    "
                  "gradient    log10(eta)  divergence    entropy")


def _num(v):
    return v.item() if isinstance(v, torch.Tensor) else v


def _log10(v) -> float:
    return math.log10(max(float(_num(v)), 1e-300))


def ilqg_begin():
    """``src/iLQG.jl:218``."""
    print("---------- begin iLQG ----------")


def ilqg_row(it, cost_old, dcost, expected, g_norm, lam, accept,
             print_head: int = 10):
    """One iteration row with a periodic header (``src/iLQG.jl:288-303``):
    accepted rows print the pre-update cost; rejected rows print NO STEP."""
    it = int(_num(it))
    if (it - 1) % print_head == 0:
        print(_ILQG_HEADER)
    kw = dict(i=it, d=float(_num(dcost)), e=float(_num(expected)),
              g=float(_num(g_norm)), l=_log10(lam))
    if bool(_num(accept)):
        print("{i:<12d}{c:<12.6g}{d:<12.3g}{e:<12.3g}{g:<12.3g}{l:<12.1f}"
              .format(c=float(_num(cost_old)), **kw))
    else:
        print("{i:<12d}NO STEP     {d:<12.3g}{e:<12.3g}{g:<12.3g}{l:<12.1f}"
              .format(**kw))


_ILQG_EXITS = [
    # reason 0: the iteration cap was reached before any termination
    # criterion fired
    "\nEXIT: iteration cap reached\n",
    "\nSUCCESS: gradient norm < tol_grad\n",
    "\nSUCCESS: cost change < tol_fun\n",
    "\nEXIT: lambda > lambda_max\n",
    "\nEXIT: Maximum iterations reached.\n",
    "\nEXIT: Initial control sequence caused divergence\n",
]


def ilqg_exit(reason, it, cost, g_norm, lam):
    """Exit messages (``src/iLQG.jl:259,306-309,319-322,334``) and the final
    one-line summary standing in for the reference's ``print_timing``
    (``src/iLQG.jl:343-366``)."""
    summary = (" iterations:   {i}\n final cost:   {c:<12.7g}\n"
               " final grad:   {g:<12.7g}\n final lambda: {l:<12.7e}\n"
               "=========== end iLQG ===========")
    msg = _ILQG_EXITS[min(max(int(_num(reason)), 0), 5)]
    print((msg + summary).format(i=int(_num(it)), c=float(_num(cost)),
                                 g=float(_num(g_norm)), l=float(_num(lam))))


def ilqg_cholesky_failed(diverge_idx):
    """``src/iLQG.jl:245`` (verbosity > 2)."""
    t = int(_num(diverge_idx))
    if t > 0:
        print(f"Cholesky failed at timestep {t}.")


def ilqgkl_row(it, cost_new, dcost, expected, g_norm, eta_mean, div_mean,
               ent, print_head: int = 10, print_period: int = 1):
    """``src/iLQGkl.jl:151-159``."""
    it = int(_num(it))
    if it % print_period != 0:
        return
    if (it - 1) % (print_head * print_period) == 0:
        print(_ILQGKL_HEADER)
    print("{i:<14d}{c:<14.6g}{d:<14.3g}{e:<14.3g}{g:<12.3g}{l:<12.2f}"
          "{v:<14.3g}{h:<12.3g}".format(
              i=it, c=float(_num(cost_new)), d=float(_num(dcost)),
              e=float(_num(expected)), g=float(_num(g_norm)),
              l=_log10(eta_mean), v=float(_num(div_mean)),
              h=float(_num(ent))))


def ilqgkl_exit(satisfied, eta_maxed, kl_violated):
    """``src/iLQGkl.jl:173-181,248``."""
    satisfied = bool(_num(satisfied))
    if satisfied:
        print("\nSUCCESS: abs(KL-divergence) < kl_step")
    if not satisfied and bool(_num(eta_maxed)):
        print("\nEXIT: eta > eta_max")
    if bool(_num(kl_violated)):
        print("WARNING: KL divergence too high when done")


def _log10_like(v) -> float:
    """log10(max(v, 1e-300)) in v's own precision, as JAX's
    ``jnp.log10(jnp.maximum(v, 1e-300))``: for an f32 value the floor
    rounds to 0, and a zero prints as -inf."""
    t = torch.as_tensor(v)
    return torch.log10(torch.clamp_min(t, 1e-300)).item()


def lanes_row(it, n_active, mean_cost, accept_frac, mean_lam, mean_g,
              print_head: int = 10):
    """Fleet-aggregate iteration row of the lane iLQG driver (JAX
    ``utils/printing.py:124-136``): the reference's per-problem table does
    not scale to thousands of scenarios; aggregates over the active ones
    do."""
    it = int(_num(it))
    if (it - 1) % print_head == 0:
        print("iteration   active      mean cost   accept      "
              "mean log10(lam)  mean grad")
    print("{i:<12d}{a:<12d}{c:<12.6g}{p:<12.3f}{l:<17.1f}{g:<12.3g}".format(
        i=it, a=int(_num(n_active)), c=float(_num(mean_cost)),
        p=float(_num(accept_frac)), l=_log10_like(mean_lam),
        g=float(_num(mean_g))))


def kl_lanes_row(it, n_active, mean_cost, mean_eta, mean_div, sat_frac,
                 print_head: int = 10):
    """Fleet-aggregate row of the lane iLQGkl driver (JAX
    ``utils/printing.py:139-150``; cf. the reference's period table,
    ``src/iLQGkl.jl:151-159``)."""
    it = int(_num(it))
    if (it - 1) % print_head == 0:
        print("iteration   active      est. cost   log10(eta)  "
              "divergence  satisfied")
    print("{i:<12d}{a:<12d}{c:<12.6g}{l:<12.2f}{v:<12.3g}{s:<12.3f}".format(
        i=it, a=int(_num(n_active)), c=float(_num(mean_cost)),
        l=_log10_like(mean_eta), v=float(_num(mean_div)),
        s=float(_num(sat_frac))))


_BOXQP_RESULTS = [
    "Hessian is not positive definite",          # result = -1
    "No descent direction found",                # result = 0
    "Maximum main iterations exceeded",          # result = 1
    "Maximum line-search iterations exceeded",   # result = 2
    "No bounds, returning Newton point",         # result = 3
    "Improvement smaller than tolerance",        # result = 4
    "Gradient norm smaller than tolerance",      # result = 5
    "All dimensions are clamped",                # result = 6
]


def boxqp_begin(n: int, value):
    """``src/boxQP.jl:65-66``."""
    print("==========\nStarting box-QP, dimension {n}, initial value: "
          "{v:.3f}".format(n=n, v=float(_num(value))))


def boxqp_row(it, value, gnorm, reduction, step_dec, nstep, n_clamped):
    """``src/boxQP.jl:153-156``, with the backtracking exponent
    (``linesearch stepDec^nstep``)."""
    print("iter {i:<4d} value {v:< 9.5g} |g| {g:<9.3g}  reduction {r:<9.3g}  "
          "linesearch {s:g}^{n:<2d}  n_clamped {c}".format(
              i=int(_num(it)), v=float(_num(value)), g=float(_num(gnorm)),
              r=float(_num(reduction)), s=float(step_dec),
              n=int(_num(nstep)), c=int(_num(n_clamped))))


def boxqp_result(result, iters, gnorm, value, nfactor):
    """``src/boxQP.jl:172-184`` result table."""
    msg = _BOXQP_RESULTS[min(max(int(_num(result)) + 1, 0), 7)]
    print(("RESULT: " + msg + ".\niterations {i}  gradient {g:<12.6g} "
           "final value {v:<12.6g}  factorizations {f}").format(
               i=int(_num(iters)), g=float(_num(gnorm)),
               v=float(_num(value)), f=int(_num(nfactor))))
