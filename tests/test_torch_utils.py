"""The port's host utilities against the JAX package's, on the CPU: the
pendcart LQR baseline (``models/pendcart.py``: ``care``, ``lqr`` and
``linearized_upright`` bit for bit, the same NumPy and SciPy;
``simulate_pendcart`` at T=50 in f64 to 1e-12 relative), the ``.npz``
checkpoints of ``utils/serialization.py`` (round trips, and a policy and a
warm start written by either package loaded by the other),
``utils/profiling.py``'s ``ilqg_profiled`` against the port's ``ilqg``
(cost to 1e-6, as the JAX package's own test holds its loop), and the
plots of ``utils/plotting.py``."""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from differentialdynamicprogramming_jl_tpu.models import pendcart as jpc
from differentialdynamicprogramming_jl_tpu.policy import (
    GaussianPolicy as JPolicy)
from differentialdynamicprogramming_jl_tpu.utils import serialization as jser
from differentialdynamicprogramming_jl_tpu_torch.models import linear as tl
from differentialdynamicprogramming_jl_tpu_torch.models import pendcart as tpc
from differentialdynamicprogramming_jl_tpu_torch.policy import GaussianPolicy
from differentialdynamicprogramming_jl_tpu_torch.solvers.ilqg import (
    ILQGConfig, ILQGResult, ilqg)
from differentialdynamicprogramming_jl_tpu_torch.utils import plotting
from differentialdynamicprogramming_jl_tpu_torch.utils import serialization as ser
from differentialdynamicprogramming_jl_tpu_torch.utils.profiling import (
    ilqg_profiled)

F64 = torch.float64


@pytest.fixture(scope="module")
def small_solve():
    spec = tl.random_lti(0, n=4, m=2, T=30, dtype=F64, device="cpu")
    prob = tl.make_lti_problem(spec, 30)
    res = ilqg(prob, spec.x0, spec.u0, cfg=ILQGConfig(max_iter=8))
    return spec, prob, res


def _leaves(tree):
    """The tensors of a result tree, None dropped."""
    return [a for a in torch.utils._pytree.tree_leaves(tree)
            if a is not None]


def _same(a: torch.Tensor, b: torch.Tensor) -> bool:
    return (a.dtype == b.dtype and a.shape == b.shape
            and torch.equal(torch.nan_to_num(a, nan=1234.5),
                            torch.nan_to_num(b, nan=1234.5))
            and torch.equal(torch.isnan(a), torch.isnan(b)))


# ---------------------------------------------------------------------------
# the LQR baseline
# ---------------------------------------------------------------------------

def test_lqr_baseline_bit_equal_to_jax():
    spec, jspec = tpc.PendCartSpec(), jpc.PendCartSpec()
    A, B = tpc.linearized_upright(spec)
    jA, jB = jpc.linearized_upright(jspec)
    np.testing.assert_array_equal(A, jA)
    np.testing.assert_array_equal(B, jB)
    Q, R = np.diag(spec.Q), np.array([[spec.R]])
    np.testing.assert_array_equal(tpc.care(A, B, Q, R),
                                  jpc.care(jA, jB, Q, R))
    L = tpc.lqr(A, B, Q, R)
    np.testing.assert_array_equal(L, jpc.lqr(jA, jB, Q, R))
    assert L.shape == (1, 4) and np.all(np.isfinite(L))


@pytest.mark.parametrize("lims_val", [10.0, None])
def test_simulate_pendcart_matches_jax(lims_val):
    """The clamped-LQG closed loop over T=50 steps in f64, with the ±10
    box and without one: states, controls and per-step costs (with the
    terminal term) to 1e-12 relative."""
    spec = tpc.PendCartSpec()
    A, B = tpc.linearized_upright(spec)
    L = tpc.lqr(A, B, np.diag(spec.Q), np.array([[spec.R]]))
    lims = None if lims_val is None else [[-lims_val, lims_val]]
    xs, us, cost = tpc.simulate_pendcart(
        tpc.default_x0(F64, "cpu"), L, spec, 50,
        None if lims is None else torch.tensor(lims, dtype=F64), F64)
    jx, ju, jc = jpc.simulate_pendcart(
        jpc.default_x0(jnp.float64), L, jpc.PendCartSpec(), 50,
        None if lims is None else jnp.array(lims), jnp.float64)
    assert xs.shape == (50, 4) and us.shape == (50, 1)
    assert cost.shape == (51,) and xs.device.type == "cpu"
    for a, b in ((xs, jx), (us, ju), (cost, jc)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-12,
                                   atol=1e-12)
    if lims_val is not None:
        assert float(us.abs().max()) <= lims_val


# ---------------------------------------------------------------------------
# serialization
# ---------------------------------------------------------------------------

def test_serialization_policy_roundtrip(tmp_path, small_solve):
    _, _, res = small_solve
    p = str(tmp_path / "policy.npz")
    ser.save_policy(p, res.policy)
    back = ser.load_policy(p, device="cpu")
    assert isinstance(back, GaussianPolicy)
    for a, b in zip(res.policy, back):
        assert _same(a, b)


def test_serialization_pytree_roundtrip(tmp_path, small_solve):
    """The whole ILQGResult (a GaussianPolicy and a Trace inside, a None
    leaf) survives a round trip bit for bit; without ``like`` the leaves
    come back as a flat list."""
    _, _, res = small_solve
    p = str(tmp_path / "result.npz")
    ser.save_pytree(p, res)
    back = ser.load_pytree(p, like=res, device="cpu")
    assert isinstance(back, ILQGResult)
    assert isinstance(back.policy, GaussianPolicy)
    la, lb = _leaves(res), _leaves(back)
    assert len(la) == len(lb)
    assert all(_same(a, b) for a, b in zip(la, lb))
    flat = ser.load_pytree(p, device="cpu")
    assert len(flat) == len(la)
    with pytest.raises(ValueError, match="leaves"):
        ser.load_pytree(p, like=res.policy, device="cpu")


def test_serialization_warm_start_roundtrip(tmp_path, small_solve):
    _, prob, res = small_solve
    p = str(tmp_path / "warm.npz")
    ser.save_warm_start(p, res.x, res.u, res.cost)
    x, u, cost = ser.load_warm_start(p, device="cpu")
    assert _same(x, res.x) and _same(u, res.u) and _same(cost, res.cost)
    # and it warm-starts the solver (pre-rolled entry)
    res2 = ilqg(prob, x, u, cfg=ILQGConfig(max_iter=3), cost0=cost)
    assert float(res2.cost.sum()) <= float(res.cost.sum()) + 1e-9


def test_serialization_files_cross_packages(tmp_path, small_solve):
    """A policy and a warm start written by the JAX package load in the
    port, and the port's load in the JAX package, bit for bit; and the
    JAX package's pytree file loads here as its flat leaves."""
    _, _, res = small_solve
    # JAX → port
    jpol = JPolicy(*(jnp.asarray(a.numpy()) for a in res.policy))
    jser.save_policy(str(tmp_path / "jpol.npz"), jpol)
    jser.save_warm_start(str(tmp_path / "jws.npz"), jnp.asarray(
        res.x.numpy()), jnp.asarray(res.u.numpy()),
        jnp.asarray(res.cost.numpy()))
    pol = ser.load_policy(str(tmp_path / "jpol.npz"), device="cpu")
    assert all(_same(a, b) for a, b in zip(pol, res.policy))
    ws = ser.load_warm_start(str(tmp_path / "jws.npz"), device="cpu")
    assert all(_same(a, b) for a, b in zip(ws, (res.x, res.u, res.cost)))
    jser.save_pytree(str(tmp_path / "jtree.npz"), jpol)
    flat = ser.load_pytree(str(tmp_path / "jtree.npz"), device="cpu")
    assert all(_same(a, b) for a, b in zip(flat, res.policy))
    back = ser.load_pytree(str(tmp_path / "jtree.npz"), like=res.policy,
                           device="cpu")
    assert isinstance(back, GaussianPolicy)
    # port → JAX
    ser.save_policy(str(tmp_path / "tpol.npz"), res.policy)
    ser.save_warm_start(str(tmp_path / "tws.npz"), res.x, res.u, res.cost)
    jp = jser.load_policy(str(tmp_path / "tpol.npz"))
    for a, b in zip(jp, res.policy):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    for a, b in zip(jser.load_warm_start(str(tmp_path / "tws.npz")),
                    (res.x, res.u, res.cost)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


# ---------------------------------------------------------------------------
# profiling
# ---------------------------------------------------------------------------

def test_ilqg_profiled_matches_solver(capsys, small_solve):
    spec, prob, _ = small_solve
    cfg = ILQGConfig(max_iter=20)
    x, u, tm = ilqg_profiled(prob, spec.x0, spec.u0, cfg=cfg, verbose=True)
    res = ilqg(prob, spec.x0, spec.u0, cfg=cfg)
    assert x.shape == res.x.shape and u.shape == res.u.shape
    cost_prof = float(prob.trajectory_cost(x, u).sum())
    assert abs(cost_prof - float(res.cost.sum())) < 1e-6
    assert tm["iters"] >= 1
    for k in ("derivs", "backward", "forward"):
        assert tm[k] > 0.0
    assert tm["derivs"] + tm["backward"] + tm["forward"] <= tm["total"]
    out = capsys.readouterr().out
    assert "time [%]" in out and "per iteration" in out


# ---------------------------------------------------------------------------
# plotting
# ---------------------------------------------------------------------------

def test_plotting_writes_files(tmp_path, small_solve):
    """Both plots, from CPU tensors: the linear demo's panels from a solve,
    and the pendcart's from the clamped-LQG baseline beside a solve."""
    assert plotting.plotting_available()
    _, _, res = small_solve
    lin = str(tmp_path / "lin.png")
    plotting.plot_linear(res, path=lin)
    assert os.path.getsize(lin) > 0
    spec = tpc.PendCartSpec()
    A, B = tpc.linearized_upright(spec)
    L = tpc.lqr(A, B, np.diag(spec.Q), np.array([[spec.R]]))
    lims = torch.tensor([[-10.0, 10.0]], dtype=F64)
    x00, u00, _ = tpc.simulate_pendcart(tpc.default_x0(F64, "cpu"), L, spec,
                                        30, lims, F64)
    prob = tpc.make_pendcart_problem(spec, derivs="euler", dtype=F64,
                                     device="cpu")
    pres = ilqg(prob, tpc.default_x0(F64, "cpu"),
                torch.zeros((30, 1), dtype=F64), lims=lims,
                cfg=ILQGConfig(max_iter=3))
    pc = str(tmp_path / "pc.png")
    plotting.plot_pendcart(x00, u00, pres, path=pc)
    assert os.path.getsize(pc) > 0
