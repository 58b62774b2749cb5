"""The port's KL utilities (``ops/kl.py``) and KL-constrained solver
(``solvers/ilqgkl.py::ilqg_kl``) against the JAX package's and
``tests/golden.npz``, in f64 on the CPU.

Tolerances: the golden's (``tests/test_golden.py``) for the golden
problems; 1e-12 for the closed-form utilities (the same formulas; einsum
and slogdet may round differently); costs to rtol 1e-9 with iteration
counts and flags equal for the solver against JAX."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import differentialdynamicprogramming_jl_tpu as J
from differentialdynamicprogramming_jl_tpu.models import linear as jl
from differentialdynamicprogramming_jl_tpu.ops import kl as jkl
from differentialdynamicprogramming_jl_tpu_torch import convert
from differentialdynamicprogramming_jl_tpu_torch.models import linear as tl
from differentialdynamicprogramming_jl_tpu_torch.ops import kl as tkl
from differentialdynamicprogramming_jl_tpu_torch.ops.forward import (
    forward_pass)
from differentialdynamicprogramming_jl_tpu_torch.policy import (
    GaussianPolicy)
from differentialdynamicprogramming_jl_tpu_torch.solvers.ilqgkl import (
    ILQGKLConfig, ilqg_kl)
from generic_parity import same_lines

HERE = os.path.dirname(__file__)
F64 = torch.float64
TOL = 1e-12


def rand_policy(seed, T=6, n=3, m=2):
    rng = np.random.default_rng(seed)
    A = 0.3 * rng.standard_normal((T, m, m))
    sigma = A @ np.swapaxes(A, -1, -2) + 0.5 * np.eye(m)
    return dict(K=0.3 * rng.standard_normal((T, m, n)),
                k=0.3 * rng.standard_normal((T, m)), sigma=sigma,
                sigma_inv=np.linalg.inv(sigma))


def _both(pol):
    return (J.GaussianPolicy(**{k: jnp.asarray(v) for k, v in pol.items()}),
            convert.policy_from_jax(type("P", (), pol), F64, "cpu"))


def _close(t, j, tol=TOL):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=tol, atol=tol)


def test_grad_kl_matches_jax():
    jp, tp = _both(rand_policy(0))
    j, t = J.grad_kl(jp), tkl.grad_kl(tp)
    for name in j._fields:
        _close(getattr(t, name), getattr(j, name))


def test_kl_divergences_and_entropy_match_jax():
    T, n, m = 6, 3, 2
    jn, tn = _both(rand_policy(1, T, n, m))
    jp, tp = _both(rand_policy(2, T, n, m))
    rng = np.random.default_rng(3)
    x_new, x_old = rng.standard_normal((T, n)), rng.standard_normal((T, n))
    u_new = rng.standard_normal((T, m))
    A = rng.standard_normal((T, n + m, n + m))
    sig = A @ np.swapaxes(A, -1, -2) + np.eye(n + m)
    a = [jnp.asarray(v) for v in (x_new, x_old, sig)]
    b = [torch.tensor(v) for v in (x_new, x_old, sig)]
    _close(tkl.kl_div_wiki(*b, tn, tp), J.kl_div_wiki(*a, jn, jp))
    _close(tkl.kl_div_gaussian(b[0], b[1], torch.tensor(u_new), b[2], tn, tp),
           J.kl_div_gaussian(a[0], a[1], jnp.asarray(u_new), a[2], jn, jp))
    _close(tkl.entropy(tn), J.entropy(jn))
    assert float(tkl.kl_div_wiki(*b, tn, tn).abs().max()) < 1e-10


def test_pd_ok_matches_jax():
    S = np.stack([np.eye(2), np.diag([1.0, -1.0]), np.diag([-1.0, -2.0]),
                  np.array([[1.0, np.nan], [np.nan, 1.0]])])
    np.testing.assert_array_equal(tkl.pd_ok(torch.tensor(S)).numpy(),
                                  np.asarray(jkl.pd_ok(jnp.asarray(S))))
    assert tkl.pd_ok(torch.tensor(S)).tolist() == [True, False, False, False]


@pytest.mark.parametrize("div", [0.5, 1.05, 3.0, "per_step"])
def test_calc_eta_and_geom_match_jax(div):
    if div == "per_step":
        d = np.array([0.2, 0.95, 4.0, 1.0])
        eb = np.stack([np.full(4, 1e-8), np.array([0.5, 1.0, 2.0, 3.0]),
                       np.full(4, 1e16)])
    else:
        d, eb = np.float64(div), np.array([1e-3, 1.0, 1e4])
    je, js = J.calc_eta(jnp.asarray(d), jnp.asarray(eb), 1.0)
    te, ts = tkl.calc_eta(torch.tensor(d), torch.tensor(eb), 1.0)
    _close(te, je)
    assert bool(js) == bool(ts)
    _close(tkl.geom(torch.tensor(eb)), jkl.geom(jnp.asarray(eb)))


def test_adam_matches_jax():
    rng = np.random.default_rng(4)
    theta, g = rng.standard_normal(5), rng.standard_normal(5)
    js = J.adam_init((5,), jnp.float64)
    ts = tkl.adam_init((5,), F64, "cpu")
    jt, tt = jnp.asarray(theta), torch.tensor(theta)
    for it in range(1, 4):
        jt, js = J.adam_update(js, jt, jnp.asarray(g * it), it, alpha=0.1)
        tt, ts = tkl.adam_update(ts, tt, torch.tensor(g * it), it, alpha=0.1)
    _close(tt, jt)
    _close(ts.m, js.m)
    _close(ts.v, js.v)


def _kl_problem(T=60, n=4):
    """The golden ilqg_kl setup (tests/test_golden.py), from the committed
    spec file: LTI n=4, m=2, a pre-roll of u0."""
    f = np.load(os.path.join(HERE, "..", "tools_torch",
                             "generic_inputs.npz"))
    spec = tl.LTISpec(*(torch.tensor(f[f"lti_kl_{k}"])
                        for k in tl.LTISpec._fields))
    prob = tl.make_lti_problem(spec, T)
    model = tl.SimpleLTVModel.from_lti(spec.A, spec.B, T)
    ro = forward_pass(prob, spec.x0, spec.u0)
    traj = GaussianPolicy.zeros(T, n, 2, F64, device="cpu")._replace(k=ro.u)
    return prob, model, ro, traj


def test_ilqg_kl_scalar_golden():
    gold = np.load(os.path.join(HERE, "golden.npz"))
    prob, model, ro, traj = _kl_problem()
    res = ilqg_kl(prob, ro.x, traj, model, ro.cost,
                  cfg=ILQGKLConfig(kl_step=2.0, max_iter=30))
    np.testing.assert_allclose(res.cost.sum().item(), gold["ilqgkl_cost"],
                               rtol=1e-9)
    np.testing.assert_allclose(res.eta.item(), gold["ilqgkl_eta"],
                               rtol=1e-9)
    np.testing.assert_allclose(res.divergence.item(),
                               gold["ilqgkl_divergence"], rtol=1e-8)
    assert int(res.n_iters) == int(gold["ilqgkl_iters"])
    assert bool(res.satisfied) == bool(gold["ilqgkl_satisfied"])
    assert not bool(res.pd_failed)


def test_ilqg_kl_per_step_golden():
    gold = np.load(os.path.join(HERE, "golden.npz"))
    prob, model, ro, traj = _kl_problem()
    res = ilqg_kl(prob, ro.x, traj, model, ro.cost,
                  cfg=ILQGKLConfig(kl_step=1e-5, max_iter=15,
                                   constrain_per_step=True, gd_alpha=0.3))
    np.testing.assert_allclose(res.cost.sum().item(),
                               gold["ilqgkl_ps_cost"], rtol=1e-9)
    np.testing.assert_allclose(res.eta.mean().item(),
                               gold["ilqgkl_ps_eta_mean"], rtol=1e-8)
    np.testing.assert_allclose(res.divergence.mean().item(),
                               gold["ilqgkl_ps_div_mean"], rtol=1e-7)
    assert int(res.n_iters) == int(gold["ilqgkl_ps_iters"])
    assert bool(res.satisfied) == bool(gold["ilqgkl_ps_satisfied"])


def _vs_jax(T, cfg_kw, lims=None, callback=None):
    spec = jl.random_lti(jax.random.PRNGKey(2), n=4, m=2, T=T,
                         dtype=jnp.float64)
    jp = jl.make_lti_problem(spec, T)
    jro = J.forward_pass(jp, spec.x0, spec.u0, lims=lims)
    jtraj = J.GaussianPolicy.zeros(T, 4, 2, jnp.float64)._replace(k=jro.u)
    j = J.ilqg_kl(jp, jro.x, jtraj, jl.SimpleLTVModel.from_lti(
        spec.A, spec.B, T), jro.cost, lims=lims, cfg=J.ILQGKLConfig(**cfg_kw))
    tspec = convert.lti_spec_from_jax(spec, F64, "cpu")
    tp = tl.make_lti_problem(tspec, T)
    tlims = None if lims is None else torch.tensor(np.asarray(lims))
    tro = forward_pass(tp, tspec.x0, tspec.u0, lims=tlims)
    ttraj = GaussianPolicy.zeros(T, 4, 2, F64, device="cpu")._replace(
        k=tro.u)
    t = ilqg_kl(tp, tro.x, ttraj, tl.SimpleLTVModel.from_lti(
        tspec.A, tspec.B, T), tro.cost,
        lims=tlims, cfg=ILQGKLConfig(**cfg_kw), iter_callback=callback)
    return j, t


@pytest.mark.parametrize("per_step", [False, True])
def test_ilqg_kl_with_limits_matches_jax(per_step):
    kw = dict(kl_step=0.5, max_iter=12) if not per_step else dict(
        kl_step=0.05, max_iter=8, constrain_per_step=True, gd_alpha=0.3)
    j, t = _vs_jax(20, kw, lims=jnp.asarray([[-0.3, 0.3], [-0.2, 0.25]]))
    np.testing.assert_allclose(t.cost.sum().item(), float(jnp.sum(j.cost)),
                               rtol=1e-9)
    np.testing.assert_allclose(t.eta.numpy(), np.asarray(j.eta), rtol=1e-9)
    assert int(t.n_iters) == int(j.n_iters)
    for name in ("satisfied", "kl_violated", "pd_failed"):
        assert bool(getattr(t, name)) == bool(getattr(j, name)), name
    np.testing.assert_allclose(t.trace.divergence.numpy(),
                               np.asarray(j.trace.divergence), rtol=1e-7,
                               atol=1e-12)


def test_ilqg_kl_callback_and_verbosity_match_jax(capfd):
    calls = []
    kw = dict(kl_step=0.5, max_iter=12, verbosity=2, print_head=4)
    j, t = _vs_jax(20, kw, callback=lambda it, x, u, c: calls.append(it))
    jax.block_until_ready(j.u)
    jax.effects_barrier()
    out = capfd.readouterr().out
    assert calls == list(range(1, int(t.n_iters) + 1))
    # the JAX lines were printed first (JAX solved first), then the port's
    lines = out.splitlines()
    half = len(lines) // 2
    assert "divergence" in out
    same_lines("\n".join(lines[half:]), "\n".join(lines[:half]))


def test_ilqg_kl_indefinite_prev_sigma_sets_pd_failed():
    """An indefinite previous Σ (Julia's logdet DomainError) aborts with
    pd_failed, as in JAX."""
    prob, model, ro, traj = _kl_problem()
    bad = traj.sigma.clone()
    bad[5] = torch.diag(torch.tensor([1.0, -1.0], dtype=F64))
    res = ilqg_kl(prob, ro.x, traj._replace(sigma=bad), model, ro.cost,
                  cfg=ILQGKLConfig(kl_step=2.0, max_iter=5))
    assert bool(res.pd_failed) and not bool(res.satisfied)
    assert int(res.n_iters) == 1
