"""Box-constrained QP by projected Newton, batched over leading dimensions.

Counterpart of ``differentialdynamicprogramming_jl_tpu/ops/boxqp.py``
(reference ``src/boxQP.jl:29-188``): minimise ``0.5·x'Hx + x'g`` subject to
``lower <= x <= upper``, with the JAX package's fixed-shape design — the
active set is a boolean mask, the free-subspace Cholesky factor is that of
``free⊗free·H + diag(clamped)``, every ``break`` is a ``done`` flag — and its
deviation from the reference (exhausting ``max_iter`` returns 1).

:func:`boxqp` takes any leading batch dimensions and reproduces
``jax.vmap(boxqp)``: every QP runs its own iterations, and a QP that has
exited is frozen by ``torch.where`` while the others go on. The loops are
host loops; they read whether any QP is still running once every
``QP_CHECK`` turns (one host sync each), which gives the same result as
reading it every turn, because a frozen QP no longer changes.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..device import as_tensor, like, resolve
from . import _linalg as la

# turns of the outer and of the Armijo loop between reads of their `done`
QP_CHECK = 4


class BoxQPResult(NamedTuple):
    """Outputs of :func:`boxqp` (reference return tuple ``src/boxQP.jl:187``),
    each with the inputs' leading dimensions.

    - ``x``: solution ``(m,)``
    - ``result``: int32 code (``src/boxQP.jl:172-179``): -1 non-PD Hessian,
      0 no descent, 1 max iterations, 2 max line-search, 4 improvement < tol,
      5 gradient < tol, 6 all clamped. ``result >= 1`` is success.
    - ``chol``: lower Cholesky factor of the masked free-subspace Hessian
      ``(m, m)`` (identity rows/cols on clamped dims)
    - ``free``: boolean free-dimension mask ``(m,)``
    - ``iters``: iterations executed
    - ``value``: final objective value
    - ``gnorm``: final free-gradient norm
    - ``nfactor``: number of Cholesky factorizations
    """

    x: torch.Tensor
    result: torch.Tensor
    chol: torch.Tensor
    free: torch.Tensor
    iters: torch.Tensor
    value: torch.Tensor
    gnorm: torch.Tensor
    nfactor: torch.Tensor


class QPTrace(NamedTuple):
    """Per-iteration record of ``boxqp(record_trace=True)`` — the reference's
    ``QPTrace`` (``src/boxQP.jl:1-8``) as tensors of length ``max_iter``
    (entries past ``iters`` are zero)."""

    value: torch.Tensor       # (..., max_iter) objective value
    gnorm: torch.Tensor       # (..., max_iter) free-gradient norm
    n_clamped: torch.Tensor   # (..., max_iter) active-set size
    factorized: torch.Tensor  # (..., max_iter) bool: refactorized


class _QPState(NamedTuple):
    x: torch.Tensor
    value: torch.Tensor
    oldvalue: torch.Tensor
    clamped: torch.Tensor
    chol: torch.Tensor
    result: torch.Tensor
    done: torch.Tensor
    it: torch.Tensor
    gnorm: torch.Tensor
    nfactor: torch.Tensor
    ls_steps: torch.Tensor   # backtracking exponent of the LAST line search


def _masked_cholesky(H: torch.Tensor, free: torch.Tensor) -> torch.Tensor:
    """Cholesky factor of ``free⊗free·H + diag(~free)``, the fixed-shape
    equivalent of ``cholesky(H[free, free])`` (``src/boxQP.jl:111``); NaN
    where that is not PD."""
    mask = free[..., :, None] & free[..., None, :]
    Hm = torch.where(mask, H, 0.0) + torch.diag_embed((~free).to(H.dtype))
    return la.cholesky(Hm)


def boxqp(H, g, lower, upper, x0,
          max_iter: int = 100,
          min_grad: Optional[float] = None,
          min_rel_improve: Optional[float] = None,
          step_dec: float = 0.6,
          min_step: Optional[float] = None,
          armijo: float = 0.1,
          max_ls: int = 100,
          record_trace: bool = False,
          verbose: int = 0):
    """Solve box QPs: ``H`` (..., m, m), ``g``, ``lower``, ``upper``, ``x0``
    (..., m), broadcast against each other. Defaults match the reference
    (``src/boxQP.jl:29-43``): ``min_grad=1e-8``, ``min_rel_improve=1e-8``,
    ``min_step=1e-22`` — except on f32 inputs, where ``None`` selects the
    JAX package's f32 floors (1e-6 / 1e-6 / 1e-20). With
    ``record_trace=True`` returns ``(BoxQPResult, QPTrace)``. ``verbose``
    prints the reference's progress lines for every QP of the batch.

    ``H`` keeps its device if it is a tensor, else goes to the CUDA card;
    the other inputs follow it."""
    H = as_tensor(H)
    dtype = H.dtype
    g, lower, upper, x0 = (like(v, H) for v in (g, lower, upper, x0))
    m = g.shape[-1]
    lead = la.lead_shape(H.shape[:-2], g.shape[:-1],
                                  lower.shape[:-1], upper.shape[:-1],
                                  x0.shape[:-1])
    H = H.expand(lead + (m, m))
    g, lower, upper, x0 = (v.expand(lead + (m,))
                           for v in (g, lower, upper, x0))
    dev = H.device

    f32 = dtype == torch.float32
    if min_grad is None:
        min_grad = 1e-6 if f32 else 1e-8
    if min_rel_improve is None:
        min_rel_improve = 1e-6 if f32 else 1e-8
    if min_step is None:
        min_step = 1e-20 if f32 else 1e-22

    def qval(x):
        return (x * g).sum(-1) + 0.5 * (x * la.mv(H, x)).sum(-1)

    x = torch.clamp(x0, lower, upper)
    value0 = qval(x)
    if verbose > 0:
        from ..utils import printing as _pr
        for v in value0.reshape(-1).tolist():
            _pr.boxqp_begin(m, v)

    def zeros(dt=dtype, shape=lead):
        return torch.zeros(shape, dtype=dt, device=dev)

    s = _QPState(
        x=x, value=value0, oldvalue=zeros(), clamped=zeros(torch.bool,
                                                           lead + (m,)),
        chol=torch.eye(m, dtype=dtype, device=dev).expand(lead + (m, m)),
        result=zeros(torch.int32), done=zeros(torch.bool),
        it=torch.ones(lead, dtype=torch.int32, device=dev),
        gnorm=zeros(), nfactor=zeros(torch.int32),
        ls_steps=zeros(torch.int32))

    def step(s: _QPState, running: torch.Tensor) -> _QPState:
        # relative-improvement exit (src/boxQP.jl:78-81)
        stop4 = (s.it > 1) & ((s.oldvalue - s.value)
                              < min_rel_improve * torch.abs(s.oldvalue))
        oldvalue = s.value
        # gradient & clamped set (src/boxQP.jl:85-95)
        grad = g + la.mv(H, s.x)
        clamped = (((s.x == lower) & (grad > 0))
                   | ((s.x == upper) & (grad < 0)))
        free = ~clamped
        all_clamped = clamped.all(-1)
        # factorize only when the clamp set changed (src/boxQP.jl:103-117)
        changed = (s.it == 1) | (clamped != s.clamped).any(-1)
        chol = torch.where(changed[..., None, None],
                           _masked_cholesky(H, free), s.chol)
        nfactor = s.nfactor + changed.to(torch.int32)
        notpd = torch.isnan(chol).any(-1).any(-1)
        # free-gradient norm exit (src/boxQP.jl:120-124)
        gnorm = torch.linalg.vector_norm(grad * free, dim=-1)
        small_grad = gnorm < min_grad
        # Newton direction on free dims (src/boxQP.jl:126-129)
        grad_clamped = g + la.mv(H, s.x * clamped)
        newton = la.cho_solve(chol, grad_clamped * free)
        search = (-newton - s.x) * free
        sdotg = (search * grad).sum(-1)
        no_descent = sdotg >= 0   # src/boxQP.jl:133 (result stays 0)

        # Armijo backtracking with clamping (src/boxQP.jl:137-151)
        def ls_cond(stp, vc, fail, k):
            insufficient = (vc - oldvalue) / (stp * sdotg) < armijo
            return running & insufficient & (~fail) & (k < max_ls)

        xc = torch.clamp(s.x + search, lower, upper)
        ls = (torch.ones(lead, dtype=dtype, device=dev), xc, qval(xc),
              zeros(torch.bool), zeros(torch.int32))
        go = ls_cond(ls[0], ls[2], ls[3], ls[4])
        for j in range(max_ls):
            if j % QP_CHECK == 0 and not bool(go.any()):
                break
            stp = ls[0] * step_dec
            xc = torch.clamp(s.x + stp[..., None] * search, lower, upper)
            new = (stp, xc, qval(xc), stp < min_step, ls[4] + 1)
            ls = la.where_lanes(go, new, ls)
            go = ls_cond(ls[0], ls[2], ls[3], ls[4])
        _, xc, vc, ls_fail, nstep = ls

        # resolve exits in reference order
        exit_now = (stop4 | all_clamped | notpd | small_grad | no_descent
                    | ls_fail)
        code = torch.full(lead, 0, dtype=torch.int32, device=dev)
        for flag, val in ((ls_fail, 2), (no_descent, 0), (small_grad, 5),
                          (notpd, -1), (all_clamped, 6), (stop4, 4)):
            code = torch.where(flag, val, code)
        accept = ~(stop4 | all_clamped | notpd | small_grad | no_descent)
        keep = stop4
        return _QPState(
            x=torch.where(accept[..., None], xc, s.x),
            value=torch.where(accept, vc, s.value),
            oldvalue=oldvalue,
            clamped=torch.where(keep[..., None], s.clamped, clamped),
            chol=torch.where(keep[..., None, None], s.chol, chol),
            result=code, done=exit_now,
            it=s.it + accept.to(torch.int32),
            gnorm=torch.where(keep, s.gnorm, gnorm),
            nfactor=nfactor, ls_steps=nstep)

    if record_trace:
        tr = QPTrace(value=zeros(dtype, lead + (max_iter,)),
                     gnorm=zeros(dtype, lead + (max_iter,)),
                     n_clamped=zeros(torch.int32, lead + (max_iter,)),
                     factorized=zeros(torch.bool, lead + (max_iter,)))
        slots = torch.arange(max_iter, device=dev)
    for turn in range(max_iter):
        running = (~s.done) & (s.it <= max_iter)
        if turn % QP_CHECK == 0 and not bool(running.any()):
            break
        s_new = step(s, running)
        n_clamped = s_new.clamped.sum(-1, dtype=torch.int32)
        if verbose > 1:
            from ..utils import printing as _pr
            for b in running.reshape(-1).nonzero()[:, 0].tolist():
                at = np.unravel_index(b, lead) if lead else ()
                _pr.boxqp_row(s.it[at], s_new.value[at], s_new.gnorm[at],
                              s_new.oldvalue[at] - s_new.value[at], step_dec,
                              s_new.ls_steps[at], n_clamped[at])
        if record_trace:
            idx = torch.clamp(s.it - 1, max=max_iter - 1)
            hot = (slots == idx[..., None]) & running[..., None]
            tr = QPTrace(
                value=torch.where(hot, s_new.value[..., None], tr.value),
                gnorm=torch.where(hot, s_new.gnorm[..., None], tr.gnorm),
                n_clamped=torch.where(hot, n_clamped[..., None],
                                      tr.n_clamped),
                factorized=torch.where(
                    hot, (s_new.nfactor > s.nfactor)[..., None],
                    tr.factorized))
        s = la.where_lanes(running, s_new, s)

    # exhausted max_iter without another exit → result 1
    result = torch.where((~s.done) & (s.result == 0), 1, s.result).to(
        torch.int32)
    res = BoxQPResult(x=s.x, result=result, chol=s.chol, free=~s.clamped,
                      iters=s.it, value=s.value, gnorm=s.gnorm,
                      nfactor=s.nfactor)
    if verbose > 0:
        from ..utils import printing as _pr
        for r, i, gn, v, nf in zip(*(a.reshape(-1).tolist() for a in (
                res.result, res.iters, res.gnorm, res.value, res.nfactor))):
            _pr.boxqp_result(r, i, gn, v, nf)
    return (res, tr) if record_trace else res


def boxqp_1d(H, g, lower, upper) -> BoxQPResult:
    """Closed-form scalar box QP (m=1), batched: ``H`` (..., 1, 1), ``g``,
    ``lower``, ``upper`` (..., 1). Projected Newton reduces to one clamped
    division (the pendcart's per-step QPs, ``src/system_pendcart.jl:197``)."""
    h = H[..., 0, 0]
    g0 = g[..., 0]
    x = torch.clamp(-g0 / h, lower[..., 0], upper[..., 0])
    grad = g0 + h * x
    clamped = (((x == lower[..., 0]) & (grad > 0))
               | ((x == upper[..., 0]) & (grad < 0)))
    free = ~clamped
    pd = h > 0
    chol_val = torch.sqrt(torch.where(pd, torch.where(free, h, 1.0),
                                      float("nan")))
    value = x * g0 + 0.5 * x * h * x
    ones = torch.ones(x.shape, dtype=torch.int32, device=x.device)
    return BoxQPResult(
        x=x[..., None], result=torch.where(pd, 5, -1).to(torch.int32),
        chol=chol_val[..., None, None], free=free[..., None], iters=ones,
        value=value, gnorm=torch.abs(grad * free), nfactor=ones)


def demo_qp(n: int = 500, seed: int = 0, dtype=torch.float64, device=None,
            **kwargs):
    """Random PD box QP demo (reference ``demoQP``, ``src/boxQP.jl:190-199``):
    ``H = AAᵀ`` with A, g and x0 standard normal, box [-1, 1]. The draws come
    from ``numpy.random.default_rng(seed)`` in f64 (not JAX's ``PRNGKey``
    bits), then go to ``device`` (None: the CUDA card)."""
    rng = np.random.default_rng(seed)
    g = rng.standard_normal(n)
    A = rng.standard_normal((n, n))
    x0 = rng.standard_normal(n)
    dev = resolve(device)

    def t(a):
        return torch.tensor(a, dtype=dtype, device=dev)

    A = t(A)
    return boxqp(A @ A.T, t(g), -torch.ones(n, dtype=dtype, device=dev),
                 torch.ones(n, dtype=dtype, device=dev), t(x0), **kwargs)
