"""The port's generic iLQG solver (``solvers/ilqg.py``, ``ilqg_batched``)
against the JAX package's and ``tests/golden.npz``, in f64 on the CPU.

Tolerances: the golden's (``tests/test_golden.py``) where the golden is the
target; otherwise costs to rtol 1e-9 with exit reasons and iteration counts
equal. The pendcart's ``"zoh"`` derivatives come from
``torch.linalg.matrix_exp``, which is not ``jax.scipy.linalg.expm``: those
solves are held by outcome (cost, reason, iterations) at the same rtol.
``ilqg_batched``'s lanes are held to ``ilqg`` on each lane alone bit for
bit: the same operations on the same lane's data.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import differentialdynamicprogramming_jl_tpu as J
from differentialdynamicprogramming_jl_tpu.models import linear as jl
from differentialdynamicprogramming_jl_tpu.models import pendcart as jpc
from differentialdynamicprogramming_jl_tpu.parallel.mesh import (
    ilqg_batched as j_ilqg_batched)
from differentialdynamicprogramming_jl_tpu_torch import convert
from differentialdynamicprogramming_jl_tpu_torch.models import linear as tl
from differentialdynamicprogramming_jl_tpu_torch.models import pendcart as tpc
from differentialdynamicprogramming_jl_tpu_torch.parallel.mesh import (
    ilqg_batched)
from differentialdynamicprogramming_jl_tpu_torch.solvers.ilqg import (
    ILQGConfig, ilqg)
from generic_parity import same_lines

HERE = os.path.dirname(__file__)
F64 = torch.float64
RTOL = 1e-9
PC_T = 40
PC_CFG = J.ILQGConfig(alphas=J.default_alphas(0.2, -3.0, 6), reg_type=2,
                      lam_max=1e15, tol_fun=1e-8, tol_grad=1e-8, max_iter=60)
PC_LIMS = np.array([[-10.0, 10.0]])


def _lti(T=30, n=4, key=0):
    spec = jl.random_lti(jax.random.PRNGKey(key), n=n, m=2, T=T,
                         dtype=jnp.float64)
    return spec, convert.lti_spec_from_jax(spec, F64, "cpu")


def _same_outcome(j, t, rtol=RTOL):
    np.testing.assert_allclose(t.cost.sum().item(), float(jnp.sum(j.cost)),
                               rtol=rtol)
    assert int(t.reason) == int(j.reason)
    assert int(t.n_iters) == int(j.n_iters)
    assert int(t.n_accepted) == int(j.n_accepted)


def test_generic_inputs_file_matches_jax():
    """tools_torch/generic_inputs.npz holds JAX's random_lti specs and the
    n=50 golden QP bit for bit (tools_torch/make_generic_inputs.py)."""
    import sys
    sys.path.insert(0, os.path.join(HERE, "..", "tools_torch"))
    from make_generic_inputs import spec_arrays
    f = np.load(os.path.join(HERE, "..", "tools_torch",
                             "generic_inputs.npz"))
    want = spec_arrays()
    for name, a in want.items():
        np.testing.assert_array_equal(f[name], a, err_msg=name)
        assert f[name].dtype == a.dtype, name


def test_linear_golden():
    """tests/test_golden.py::test_linear_golden in the port, from the
    committed spec."""
    gold = np.load(os.path.join(HERE, "golden.npz"))
    f = np.load(os.path.join(HERE, "..", "tools_torch",
                             "generic_inputs.npz"))
    spec = tl.LTISpec(*(torch.tensor(f[f"lti_golden_{k}"])
                        for k in tl.LTISpec._fields))
    res = ilqg(tl.make_lti_problem(spec, 400), spec.x0, spec.u0,
               cfg=ILQGConfig(max_iter=100))
    np.testing.assert_allclose(res.cost.sum().item(), gold["linear_cost"],
                               rtol=1e-8)
    np.testing.assert_allclose(res.u.abs().sum().item(),
                               gold["linear_u_abs"], rtol=1e-6)
    np.testing.assert_allclose(res.u.sum().item(), gold["linear_u_sum"],
                               atol=1e-6)


def test_pendcart_golden():
    """tests/test_golden.py::test_pendcart_golden in the port ("zoh",
    T=300, ±10)."""
    gold = np.load(os.path.join(HERE, "golden.npz"))
    prob = tpc.make_pendcart_problem(tpc.PendCartSpec(), derivs="zoh",
                                     dtype=F64, device="cpu")
    cfg = convert.config_from_jax(dataclasses.replace(PC_CFG, max_iter=300))
    res = ilqg(prob, tpc.default_x0(F64, device="cpu"),
               torch.zeros((300, 1), dtype=F64),
               lims=torch.tensor(PC_LIMS), cfg=cfg)
    np.testing.assert_allclose(res.cost.sum().item(), gold["pendcart_cost"],
                               rtol=1e-6)
    np.testing.assert_allclose(res.x[-1, 0].item(), gold["pendcart_angle"],
                               rtol=1e-4)
    np.testing.assert_allclose(res.u.abs().sum().item(),
                               gold["pendcart_u_abs"], rtol=1e-4)
    assert res.cost.shape == (301,)      # the (T+1,) traj_cost contract


@pytest.mark.parametrize("autodiff", [False, True])
def test_lti_matches_jax(autodiff):
    spec, tspec = _lti()
    j = J.ilqg(jl.make_lti_problem(spec, 30, use_autodiff=autodiff),
               spec.x0, spec.u0, cfg=J.ILQGConfig(max_iter=100))
    t = ilqg(tl.make_lti_problem(tspec, 30, use_autodiff=autodiff),
             tspec.x0, tspec.u0, cfg=ILQGConfig(max_iter=100))
    _same_outcome(j, t)
    for name in ("lam", "cost", "grad_norm"):
        np.testing.assert_allclose(getattr(t.trace, name).numpy(),
                                   np.asarray(getattr(j.trace, name)),
                                   rtol=1e-7, atol=1e-12, err_msg=name)
    np.testing.assert_array_equal(t.trace.accepted.numpy(),
                                  np.asarray(j.trace.accepted))
    np.testing.assert_allclose(t.policy.K.numpy(), np.asarray(j.policy.K),
                               rtol=1e-6, atol=1e-9)


def test_lti_limits_matches_jax():
    """m=2 with limits: the box QP at every step, warm-started."""
    spec, tspec = _lti()
    lims = np.array([[-0.05, 0.05], [-0.03, 0.04]])
    j = J.ilqg(jl.make_lti_problem(spec, 30), spec.x0, spec.u0,
               lims=jnp.asarray(lims), cfg=J.ILQGConfig(max_iter=100))
    t = ilqg(tl.make_lti_problem(tspec, 30), tspec.x0, tspec.u0,
             lims=torch.tensor(lims), cfg=ILQGConfig(max_iter=100))
    _same_outcome(j, t)
    assert bool((t.u.abs() <= 0.05).all())


@pytest.mark.parametrize("scheme", ["euler", "autodiff", "zoh"])
def test_pendcart_matches_jax(scheme):
    jp = jpc.make_pendcart_problem(jpc.PendCartSpec(), derivs=scheme,
                                   dtype=jnp.float64)
    tp = tpc.make_pendcart_problem(tpc.PendCartSpec(), derivs=scheme,
                                   dtype=F64, device="cpu")
    j = J.ilqg(jp, jpc.default_x0(jnp.float64), jnp.zeros((PC_T, 1)),
               lims=jnp.asarray(PC_LIMS), cfg=PC_CFG)
    t = ilqg(tp, tpc.default_x0(F64, device="cpu"),
             torch.zeros((PC_T, 1), dtype=F64), lims=torch.tensor(PC_LIMS),
             cfg=convert.config_from_jax(PC_CFG))
    _same_outcome(j, t)
    assert t.cost.shape == (PC_T + 1,)


def test_full_ddp_matches_jax():
    """Second-order dynamics terms by autodiff (``second_order=True``)."""
    jb = jpc.make_pendcart_problem(jpc.PendCartSpec(), derivs="autodiff",
                                   dtype=jnp.float64)
    tb = tpc.make_pendcart_problem(tpc.PendCartSpec(), derivs="autodiff",
                                   dtype=F64, device="cpu")
    jp = J.Problem(dynamics=jb.dynamics, cost=jb.cost,
                   traj_cost=jb.traj_cost, second_order=True)
    tp = dataclasses.replace(tb, second_order=True)
    j = J.ilqg(jp, jpc.default_x0(jnp.float64), jnp.zeros((PC_T, 1)),
               lims=jnp.asarray(PC_LIMS), cfg=PC_CFG)
    t = ilqg(tp, tpc.default_x0(F64, device="cpu"),
             torch.zeros((PC_T, 1), dtype=F64), lims=torch.tensor(PC_LIMS),
             cfg=convert.config_from_jax(PC_CFG))
    _same_outcome(j, t)
    d = tp.make_derivs()(t.x, t.u)
    assert d.fxx.shape == (PC_T, 4, 4, 4)


def test_nan_u0_gives_reason_5():
    spec, tspec = _lti()
    u0 = np.asarray(spec.u0).copy()
    u0[3, 0] = np.nan
    j = J.ilqg(jl.make_lti_problem(spec, 30), spec.x0, jnp.asarray(u0),
               cfg=J.ILQGConfig(max_iter=100))
    t = ilqg(tl.make_lti_problem(tspec, 30), tspec.x0, torch.tensor(u0),
             cfg=ILQGConfig(max_iter=100))
    assert int(j.reason) == int(t.reason) == 5
    assert int(t.n_iters) == 0


def test_resume_split_equals_uninterrupted():
    """A JAX solve stopped after 3 accepted iterations, carried across as
    numpy (``convert.ilqg_result_from_jax``) and resumed in the port from
    its trajectory (pre-rolled x0 + cost0) and counters, ends where JAX's
    uninterrupted solve ends."""
    spec, tspec = _lti()
    prob_j = jl.make_lti_problem(spec, 30)
    whole = J.ilqg(prob_j, spec.x0, spec.u0, cfg=J.ILQGConfig(max_iter=100))
    first = J.ilqg(prob_j, spec.x0, spec.u0, cfg=J.ILQGConfig(max_iter=3))
    assert int(first.reason) == 4 and int(whole.n_accepted) > 3
    part = convert.ilqg_result_from_jax(first, F64, "cpu")
    t = ilqg(tl.make_lti_problem(tspec, 30), part.x, part.u,
             cfg=ILQGConfig(max_iter=100), cost0=part.cost, lam0=part.lam,
             dlam0=part.dlam, accepted0=part.n_accepted)
    np.testing.assert_allclose(t.cost.sum().item(),
                               float(jnp.sum(whole.cost)), rtol=RTOL)
    assert int(t.reason) == int(whole.reason)
    assert int(t.n_accepted) == int(whole.n_accepted)
    assert int(first.n_iters) + int(t.n_iters) == int(whole.n_iters)
    np.testing.assert_allclose(t.lam.item(), float(whole.lam), rtol=1e-12)


def test_parallel_backward_matches_jax():
    spec, tspec = _lti()
    j = J.ilqg(jl.make_lti_problem(spec, 30), spec.x0, spec.u0,
               cfg=J.ILQGConfig(max_iter=100, backward="parallel"))
    t = ilqg(tl.make_lti_problem(tspec, 30), tspec.x0, tspec.u0,
             cfg=ILQGConfig(max_iter=100, backward="parallel"))
    _same_outcome(j, t)
    s = ilqg(tl.make_lti_problem(tspec, 30), tspec.x0, tspec.u0,
             cfg=ILQGConfig(max_iter=100))
    np.testing.assert_allclose(t.cost.sum().item(), s.cost.sum().item(),
                               rtol=1e-9)


def test_iter_callback_called_each_iteration():
    spec, tspec = _lti()
    calls = []
    t = ilqg(tl.make_lti_problem(tspec, 30), tspec.x0, tspec.u0,
             cfg=ILQGConfig(max_iter=100),
             iter_callback=lambda it, x, u, c, acc: calls.append(
                 (int(it), x.shape, u.shape, bool(acc))))
    assert len(calls) == int(t.n_iters)
    assert [c[0] for c in calls] == list(range(1, len(calls) + 1))
    assert calls[0][1:3] == ((30, 4), (30, 2))
    assert sum(c[3] for c in calls) == int(t.n_accepted)


@pytest.mark.parametrize("verbosity,cap", [(2, None), (1, 3)])
def test_verbosity_lines_match_jax(capfd, verbosity, cap):
    spec, tspec = _lti()
    kw = dict(verbosity=verbosity, max_iter=100, print_head=5, iter_cap=cap)
    j = J.ilqg(jl.make_lti_problem(spec, 30), spec.x0, spec.u0,
               cfg=J.ILQGConfig(**kw))
    jax.block_until_ready(j.u)
    jax.effects_barrier()
    jout = capfd.readouterr().out
    ilqg(tl.make_lti_problem(tspec, 30), tspec.x0, tspec.u0,
         cfg=ILQGConfig(**kw))
    tout = capfd.readouterr().out
    assert "end iLQG" in tout
    same_lines(tout, jout)


def _pc_batch(B=4, seed=0):
    rng = np.random.default_rng(seed)
    x0 = np.tile(np.asarray(jpc.default_x0(jnp.float64)), (B, 1))
    x0[:, 0] += 0.2 * rng.standard_normal(B)
    return x0


def test_ilqg_batched_lanes_equal_single_solves_and_jax():
    """Lane b of one batched call is ``ilqg`` on lane b alone, bit for bit,
    and agrees with JAX's vmapped ``ilqg_batched`` (per-scenario limits) on
    every lane's cost. These swing-ups end at the f64 noise floor of their
    cost (the last accepted change is a few ulps of it), where the last bits
    decide between exit 2 (that change accepted) and exit 3 (rejected until
    λ > λmax), so against JAX the exits are held to {2, 3}."""
    B = 4
    jcfg = PC_CFG
    x0 = _pc_batch(B)
    lims = np.stack([[[-10.0, 10.0]], [[-8.0, 8.0]], [[-10.0, 10.0]],
                     [[-6.0, 9.0]]])
    jp = jpc.make_pendcart_problem(jpc.PendCartSpec(), derivs="euler",
                                   dtype=jnp.float64)
    tp = tpc.make_pendcart_problem(tpc.PendCartSpec(), derivs="euler",
                                   dtype=F64, device="cpu")
    j = j_ilqg_batched(jp, jnp.asarray(x0), jnp.zeros((B, PC_T, 1)),
                       lims=jnp.asarray(lims), cfg=jcfg)
    cfg = convert.config_from_jax(jcfg)
    t = ilqg_batched(tp, torch.tensor(x0), torch.zeros((B, PC_T, 1),
                                                       dtype=F64),
                     lims=torch.tensor(lims), cfg=cfg)
    np.testing.assert_allclose(t.cost.sum(-1).numpy(),
                               np.asarray(j.cost.sum(-1)), rtol=RTOL)
    assert set(t.reason.tolist()) <= {2, 3}
    assert set(np.asarray(j.reason).tolist()) <= {2, 3}
    assert len(set(t.n_iters.tolist())) > 1
    for b in range(B):
        one = ilqg(tp, torch.tensor(x0[b]), torch.zeros((PC_T, 1),
                                                        dtype=F64),
                   lims=torch.tensor(lims[b]), cfg=cfg)
        for name in ("x", "u", "cost", "n_iters", "reason", "lam", "dlam"):
            assert torch.equal(getattr(one, name), getattr(t, name)[b]), \
                (b, name)
        assert torch.equal(one.trace.cost, t.trace.cost[b])
        assert torch.equal(one.policy.K, t.policy.K[b])


def test_ilqg_batched_resume_entries():
    """Pre-rolled (B, T, n) starts with per-lane cost0 and resume
    counters: lane b equals the single resumed solve."""
    B = 3
    tp = tpc.make_pendcart_problem(tpc.PendCartSpec(), derivs="euler",
                                   dtype=F64, device="cpu")
    cfg = convert.config_from_jax(dataclasses.replace(PC_CFG, max_iter=4))
    first = ilqg_batched(tp, torch.tensor(_pc_batch(B, 1)),
                         torch.zeros((B, PC_T, 1), dtype=F64),
                         lims=torch.tensor(PC_LIMS), cfg=cfg)
    cfg2 = convert.config_from_jax(PC_CFG)
    t = ilqg_batched(tp, first.x, first.u, lims=torch.tensor(PC_LIMS),
                     cfg=cfg2, cost0=first.cost, lam0=first.lam,
                     dlam0=first.dlam, accepted0=first.n_accepted)
    for b in range(B):
        one = ilqg(tp, first.x[b], first.u[b], lims=torch.tensor(PC_LIMS),
                   cfg=cfg2, cost0=first.cost[b], lam0=first.lam[b],
                   dlam0=first.dlam[b], accepted0=first.n_accepted[b])
        assert torch.equal(one.u, t.u[b]) and torch.equal(one.reason,
                                                          t.reason[b])


def test_device_rule():
    """CPU tensors stay on the CPU; numpy inputs go to the card, which this
    machine lacks, so they raise instead of falling back."""
    _, tspec = _lti()
    prob = tl.make_lti_problem(tspec, 30)
    res = ilqg(prob, tspec.x0, tspec.u0, cfg=ILQGConfig(max_iter=3))
    assert res.u.device.type == "cpu" and res.trace.lam.device.type == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            ilqg(prob, tspec.x0.numpy(), tspec.u0.numpy())
