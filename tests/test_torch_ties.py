"""JAX's derivative rules at ties, in the port, on the CPU.

The JAX package differentiates a user's model with JAX's rules; the port
takes the same rules for abs, the clamps, maximum and minimum
(``ops/tie_rules.py`` for the plain versions, ``csrc/autodiff.cuh`` for
K1's Dual and Jet passes), where PyTorch's own differ at a tie.

- The table: every op of the lowering's set at its special points (ties of
  maximum/minimum, a clamp or clamp_min/clamp_max on its bound, ±0 for abs,
  relu and sqrt, 0 for pow at each exponent PyTorch's kernel special-cases),
  first order and a nested second order, ``torch.func.jvp`` under
  ``jax_ties`` against ``jax.jvp``, bit for bit. pow keeps PyTorch's rule:
  at 0 the two differ only where JAX's product 0·0⁻¹ gives a NaN and where
  PyTorch's value at -0 is its own (``test_pow_at_zero``).
- ``make_autodiff_derivs`` (the generic tier: ``jacfwd`` over ``grad``)
  against JAX's at the same tie points.
- The tie model (``tools_torch/ties.py``: the pendcart with u clamped to
  the solver's ±5 in its dynamics and 0.1·|u| in its cost, started at
  u0 = 0): its fleet through the port's plain path against JAX's
  ``ilqg_batch_lanes(interpret=True)`` (B=8, T=6, k_t=1) at
  ``test_torch_m3_fleet.py``'s tolerances, which PyTorch's rules miss;
  its generic f64 solve against JAX's ``ilqg``; and its
  ``Autodiff<Lowered>`` compiled on the host against the plain tiles at
  the ties.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import jvp

import differentialdynamicprogramming_jl_tpu as J
from differentialdynamicprogramming_jl_tpu.models import pendcart as jpc
from differentialdynamicprogramming_jl_tpu.ops.pallas.autodiff_tiles import (
    autodiff_derivs_tiles as jax_autodiff_tiles)
from differentialdynamicprogramming_jl_tpu.ops.pallas.forward_kernel import (
    LanesModel as JLanesModel)
from differentialdynamicprogramming_jl_tpu.problem import (
    make_autodiff_derivs as jax_make_autodiff_derivs)
from differentialdynamicprogramming_jl_tpu_torch import convert
from differentialdynamicprogramming_jl_tpu_torch.models import pendcart as tpc
from differentialdynamicprogramming_jl_tpu_torch.ops.hopper import lower
from differentialdynamicprogramming_jl_tpu_torch.ops.hopper.autodiff_tiles \
    import autodiff_derivs_tiles
from differentialdynamicprogramming_jl_tpu_torch.ops.hopper.forward_kernel \
    import LanesModel
from differentialdynamicprogramming_jl_tpu_torch.ops.tie_rules import (
    jax_ties)
from differentialdynamicprogramming_jl_tpu_torch.problem import (
    Problem, make_autodiff_derivs)
from differentialdynamicprogramming_jl_tpu_torch.solvers.batch import (
    ilqg_batch_lanes)
from differentialdynamicprogramming_jl_tpu_torch.solvers.ilqg import ilqg
from tools_torch import ties

F32 = np.float32

# ---------------------------------------------------------------------------
# the table of rules
# ---------------------------------------------------------------------------

# name -> (torch function, jnp function, points): each point a special
# point of the op (a tie, a bound, ±0); the choosers take traced operands on
# both sides (v·v against v meets at 0 and 1)
TABLE = {
    "abs": (torch.abs, jnp.abs, [0.0, -0.0, 1.5, -2.0]),
    "Tensor.abs": (lambda v: v.abs(), jnp.abs, [0.0, -0.0]),
    "abs()": (lambda v: abs(v), jnp.abs, [0.0, -0.0]),
    "clamp": (lambda v: torch.clamp(v, -1.0, 1.0),
              lambda v: jnp.clip(v, -1.0, 1.0), [-1.0, 1.0, 0.0, 2.0, -3.0]),
    "clamp lo == hi": (lambda v: torch.clamp(v, 1.0, 1.0),
                       lambda v: jnp.clip(v, 1.0, 1.0), [1.0, 0.0, 2.0]),
    "clip": (lambda v: torch.clip(v, -1.0, 1.0),
             lambda v: jnp.clip(v, -1.0, 1.0), [-1.0, 1.0]),
    "clamp(min=)": (lambda v: torch.clamp(v, min=0.0),
                    lambda v: jnp.clip(v, 0.0, None), [0.0, -0.0, 1.0]),
    "clamp(max=)": (lambda v: v.clamp(max=0.5),
                    lambda v: jnp.clip(v, None, 0.5), [0.5, 0.0, 1.0]),
    "clamp(tensor bounds)": (
        lambda v: torch.clamp(v, torch.full_like(v, -1.0),
                              torch.full_like(v, 1.0)),
        lambda v: jnp.clip(v, jnp.full_like(v, -1.0), jnp.full_like(v, 1.0)),
        [-1.0, 1.0, 0.0, 2.0, -3.0]),
    # bounds that move with v: a tie on lo at -1, on hi at 0 and 1
    "clamp(traced bounds)": (
        lambda v: torch.clamp(v, min=0.5 * v - 0.5, max=v * v),
        lambda v: jnp.clip(v, 0.5 * v - 0.5, v * v),
        [-1.0, 1.0, 0.0, 0.5, 2.0, -3.0]),
    "clamp_min(tensor)": (lambda v: torch.clamp_min(v, v * v),
                          lambda v: jnp.maximum(v * v, v), [1.0, 0.0, 0.5]),
    "clamp_min": (lambda v: torch.clamp_min(v, 0.5),
                  lambda v: jnp.maximum(v, 0.5), [0.5, 0.0, 1.0]),
    "clamp_max": (lambda v: v.clamp_max(0.5),
                  lambda v: jnp.minimum(v, 0.5), [0.5, 0.0, 1.0]),
    "maximum": (lambda v: torch.maximum(v * v, v),
                lambda v: jnp.maximum(v * v, v), [1.0, 0.0, 2.0, 0.5]),
    "minimum": (lambda v: torch.minimum(v * v, v),
                lambda v: jnp.minimum(v * v, v), [1.0, 0.0, 2.0, 0.5]),
    "max(a, b)": (lambda v: torch.max(v, 0.5 * v + 0.5),
                  lambda v: jnp.maximum(v, 0.5 * v + 0.5), [1.0, 3.0]),
    "relu": (torch.relu, jax.nn.relu, [0.0, -0.0, 1.0]),
    "sqrt": (torch.sqrt, jnp.sqrt, [0.0, -0.0, 4.0]),
}
POW = (0.0, 1.0, 0.5, -0.5, -1.0, 2.0, 3.0, -2.0)
for _e in POW:
    TABLE[f"pow {_e}"] = (lambda v, e=_e: v ** e, lambda v, e=_e: v ** e,
                          [0.0, -0.0, 2.0])
# pow at 0, where the packages differ (JAX: jac = e·x^(e-1), so 0·0⁻¹ is
# NaN at e = 0, and along a second direction at e = 1; PyTorch's rule is 0
# at e = 0, and its sqrt and rsqrt of -0 are -0 and -inf where XLA's pow
# gives +0 and +inf): the port keeps PyTorch's values, and with them its
# rule, so these entries hold each package's number
POW_AT_ZERO = {
    # (exponent, "+0" or "-0", order): (the port's, JAX's)
    (0.0, "+0", 1): (0.0, np.nan), (0.0, "-0", 1): (0.0, np.nan),
    (0.0, "+0", 2): (0.0, np.nan), (0.0, "-0", 2): (0.0, np.nan),
    (1.0, "+0", 2): (0.0, np.nan), (1.0, "-0", 2): (0.0, np.nan),
    (0.5, "-0", 0): (-0.0, 0.0), (0.5, "-0", 1): (-np.inf, np.inf),
    (-0.5, "-0", 0): (-np.inf, np.inf),
}


def _zero(p):
    """"+0" or "-0" for a zero point, else None."""
    return None if p != 0 else ("-0" if np.signbit(p) else "+0")


def _orders(tf, jf, pts):
    """Value, first and nested second tangent of each package, at f32
    points with tangents in [0.7, 1.3] (so that a rule's rounding shows)."""
    x = torch.tensor(pts, dtype=torch.float32)
    t = torch.tensor(np.linspace(0.7, 1.3, len(pts)), dtype=torch.float32)
    xj, tj = jnp.asarray(x.numpy()), jnp.asarray(t.numpy())
    with jax_ties():
        v, d1 = jvp(tf, (x,), (t,))
        d2 = jvp(lambda z: jvp(tf, (z,), (t,))[1], (x,), (t,))[1]
    rv, rd1 = jax.jvp(jf, (xj,), (tj,))
    rd2 = jax.jvp(lambda z: jax.jvp(jf, (z,), (tj,))[1], (xj,), (tj,))[1]
    return ([a.numpy() for a in (v, d1, d2)],
            [np.asarray(a) for a in (rv, rd1, rd2)])


@pytest.mark.parametrize("name", sorted(TABLE))
def test_rules_match_jax(name):
    """Values, first and second tangents bit-equal to jax.jvp's (NaN where
    both are NaN, the sign of a zero ignored), outside POW_AT_ZERO."""
    tf, jf, pts = TABLE[name]
    ours, ref = _orders(tf, jf, pts)
    e = float(name.split()[1]) if name.startswith("pow ") else None
    for order, (a, b) in enumerate(zip(ours, ref)):
        keep = [i for i, p in enumerate(pts)
                if (e, _zero(p), order) not in POW_AT_ZERO]
        np.testing.assert_array_equal(a[keep], b[keep],
                                      err_msg=f"{name} order {order}")


def test_pow_at_zero():
    """pow at ±0: the entries where the packages differ, each package's
    number as POW_AT_ZERO records it."""
    for (e, z, order), (port, jx) in POW_AT_ZERO.items():
        tf, jf, _ = TABLE[f"pow {e}"]
        ours, ref = _orders(tf, jf, [-0.0 if z == "-0" else 0.0])
        for got, want in ((ours[order][0], port), (ref[order][0], jx)):
            np.testing.assert_array_equal(np.float32(got), np.float32(want),
                                          err_msg=f"pow {e} at {z}")
            assert np.signbit(got) == np.signbit(want) or np.isnan(want)


def test_torch_rules_outside_the_mode():
    """Outside jax_ties PyTorch's own rules hold (|x|' = 0 at 0, a clamp's
    derivative 1 on its bound), and the mode leaves every value's bits."""
    x = torch.tensor([0.0, 1.0, -0.0])
    one = torch.ones(3)
    assert jvp(torch.abs, (x,), (one,))[1].tolist() == [0.0, 1.0, 0.0]
    assert jvp(lambda v: torch.clamp(v, -1.0, 1.0), (x,),
               (one,))[1].tolist() == [1.0, 1.0, 1.0]
    with jax_ties():
        assert jvp(torch.abs, (x,), (one,))[1].tolist() == [1.0, 1.0, 1.0]
        v = jvp(lambda z: torch.clamp(z, 0.0, 1.0), (x,), (one,))
    assert v[1].tolist() == [0.5, 0.5, 0.5]
    assert torch.equal(v[0], torch.clamp(x, 0.0, 1.0))
    assert torch.signbit(v[0]).tolist() == torch.signbit(
        torch.clamp(x, 0.0, 1.0)).tolist()


# ---------------------------------------------------------------------------
# the generic tier's autodiff
# ---------------------------------------------------------------------------

def _generic_fns(xp):
    """Dynamics and cost on vectors with every tie op, in ``xp``."""
    torch_like = xp is torch

    def clip(v, lo, hi):
        return xp.clamp(v, lo, hi) if torch_like else xp.clip(v, lo, hi)

    def stack(vs):
        return xp.stack(vs, -1)

    def dynamics(x, u, t):
        return stack([x[..., 0] + 0.1 * clip(u[..., 0], -1.0, 1.0),
                      x[..., 1] + 0.1 * xp.maximum(x[..., 0], x[..., 1])
                      * xp.abs(u[..., 1])])

    def cost(x, u, t):
        return (xp.abs(u[..., 0]) + (clip(x[..., 0], 0.0, None)) ** 2
                + xp.minimum(x[..., 1], u[..., 1]) ** 2
                + 0.5 * (u[..., 0] ** 2 + x[..., 1] * u[..., 1]))

    return dynamics, cost


def test_make_autodiff_derivs_matches_jax():
    """fx, fu, cx, cu, cxx, cxu, cuu (and full DDP's fxx, fxu, fuu) of the
    generic tier's autodiff against JAX's make_autodiff_derivs in f64 at
    points on every tie: |u| at 0, the clamp on its bounds, the choosers
    at a tie; 1e-12 relative."""
    x = np.array([[0.0, 0.0], [1.0, 1.0], [0.0, -2.0], [2.0, 0.5]])
    u = np.array([[0.0, 0.0], [1.0, 1.0], [-1.0, -0.0], [0.3, 0.5]])
    ours = make_autodiff_derivs(*_generic_fns(torch), second_order=True)(
        torch.from_numpy(x)[None], torch.from_numpy(u)[None])
    ref = jax_make_autodiff_derivs(*_generic_fns(jnp), second_order=True)(
        jnp.asarray(x), jnp.asarray(u))
    for name in ("fx", "fu", "cx", "cu", "cxx", "cxu", "cuu", "fxx", "fxu",
                 "fuu"):
        np.testing.assert_allclose(getattr(ours, name)[0].numpy(),
                                   np.asarray(getattr(ref, name)),
                                   rtol=1e-12, atol=1e-15, err_msg=name)
    assert ours.cu[0, 0, 0].item() == 1.0     # |u|' at 0, JAX's 1
    assert ours.fu[0, 2, 0, 0].item() == 0.05  # the clamp on its bound, ½


# ---------------------------------------------------------------------------
# the tie model
# ---------------------------------------------------------------------------

B, T = 8, 6
JSPEC = jpc.PendCartSpec()
SPEC = convert.spec_from_jax(JSPEC)
CFG = J.ILQGConfig(alphas=J.default_alphas(0.2, -3.0, 3), reg_type=2,
                   max_iter=3, iter_cap=5)


def _models():
    return (ties.tie_lanes(torch, LanesModel, tpc.pendcart_lanes(SPEC)),
            ties.tie_lanes(jnp, JLanesModel, jpc.pendcart_lanes(JSPEC)))


def _x0s():
    """Near the top, with speeds that take the full ±5 to hold within T."""
    rng = np.random.default_rng(9)
    return np.stack([np.pi - 0.6 + 0.2 * rng.standard_normal(B),
                     30.0 * rng.standard_normal(B), np.zeros(B),
                     30.0 * rng.standard_normal(B)], axis=1).astype(F32)


def test_tie_fleet_matches_jax():
    """The tie model's fleet from u0 = 0 (every first expansion at |u|'s
    tie; the box QP saturates controls onto the clamp's bound) through
    the port's plain path against JAX's ilqg_batch_lanes in interpret
    mode with JAX's autodiff tiles: cost to rtol 2e-4, reasons and accepted
    counts equal, u to rtol 1e-3 (test_torch_m3_fleet.py's). Under
    PyTorch's rules the first gains differ and this fails."""
    x0s, u0s = _x0s(), np.zeros((B, T, 1), F32)
    tm, jm = _models()
    ref = convert.result_to_numpy(J.ilqg_batch_lanes(
        jm, None, jnp.asarray(x0s), jnp.asarray(u0s), lims=ties.LIMS,
        cfg=CFG, derivs_tiles=jax_autodiff_tiles(jm), kt_backward=1,
        kt_forward=1, interpret=True))
    out = convert.result_to_numpy(ilqg_batch_lanes(
        tm, None, torch.from_numpy(x0s), torch.from_numpy(u0s),
        lims=ties.LIMS, cfg=convert.config_from_jax(CFG),
        derivs_tiles=autodiff_derivs_tiles(tm)))
    np.testing.assert_allclose(out["cost_total"], ref["cost_total"],
                               rtol=2e-4)
    for name in ("reason", "n_accepted"):
        np.testing.assert_array_equal(out[name], ref[name], err_msg=name)
    np.testing.assert_allclose(out["u"], ref["u"], rtol=1e-3, atol=1e-5)
    assert (out["n_accepted"] >= 1).any()
    assert (np.abs(out["u"]) == ties.LIM).any()


def test_tie_generic_matches_jax():
    """The tie model in the generic tier (make_autodiff_derivs + ilqg, f64,
    u0 = 0, ±5) against JAX's ilqg: costs to rtol 1e-9, exit reasons and
    iteration counts equal (test_torch_generic_ilqg.py's)."""
    jb = jpc.make_pendcart_problem(JSPEC, derivs="autodiff",
                                   dtype=jnp.float64)
    tb = tpc.make_pendcart_problem(tpc.PendCartSpec(), derivs="autodiff",
                                   dtype=torch.float64, device="cpu")

    def problem(base, xp, cls):
        def clip(u):
            return (xp.clamp(u, -ties.LIM, ties.LIM) if xp is torch
                    else xp.clip(u, -ties.LIM, ties.LIM))

        return cls(dynamics=lambda x, u, t: base.dynamics(x, clip(u), t),
                   cost=lambda x, u, t: base.cost(x, u, t)
                   + ties.L1 * xp.abs(u[..., 0]))

    Tg = 40
    cfg = J.ILQGConfig(alphas=J.default_alphas(0.2, -3.0, 6), reg_type=2,
                       tol_fun=1e-8, tol_grad=1e-8, max_iter=30)
    lims = np.array([[-ties.LIM, ties.LIM]])
    x0 = np.array([np.pi - 0.6, 3.0, 0.0, -40.0])
    j = J.ilqg(problem(jb, jnp, J.Problem), jnp.asarray(x0),
               jnp.zeros((Tg, 1)), lims=jnp.asarray(lims), cfg=cfg)
    t = ilqg(problem(tb, torch, Problem), torch.from_numpy(x0),
             torch.zeros((Tg, 1), dtype=torch.float64),
             lims=torch.tensor(lims), cfg=convert.config_from_jax(cfg))
    np.testing.assert_allclose(t.cost.sum().item(), float(jnp.sum(j.cost)),
                               rtol=1e-9)
    assert int(t.reason) == int(j.reason)
    assert int(t.n_iters) == int(j.n_iters)
    assert int(t.n_accepted) == int(j.n_accepted)
    assert bool((t.u.abs() == ties.LIM).any())


def test_tie_autodiff_lowered_on_the_host(tmp_path):
    """The tie model's Autodiff<Lowered> (csrc/autodiff.cuh's Dual and Jet
    rules), compiled on the host, against the plain autodiff tiles at u on
    its ties (0, ±5) and off them: fx, fu, cx, cu, the cost Hessian and
    the V′ contraction to 1e-5 relative (glibc's sin/cos against
    PyTorch's), and JAX's values at the ties: cu = ∂c/∂u + 0.1 at u = 0 and
    fu halved on the bound."""
    from test_torch_lower import B as HB, _host_autodiff, _rows
    tm, _ = _models()
    low = lower.lower(tm)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((4, HB)).astype(F32)
    u = np.resize(np.array([0.0, ties.LIM, -ties.LIM, -0.0, 1.3], F32),
                  (1, HB))
    V = rng.standard_normal((4, HB)).astype(F32)
    out, _ = _host_autodiff(tmp_path, "ties", low, x, u, np.zeros(0), V)
    d = autodiff_derivs_tiles(tm, second_order=True)(_rows(x), _rows(u), 0)
    free = autodiff_derivs_tiles(tpc.pendcart_lanes(SPEC))(_rows(x),
                                                          _rows(u), 0)
    n, m = 4, 1
    ref = ([d["fx"][i][j] for i in range(n) for j in range(n)]
           + [d["fu"][i][j] for i in range(n) for j in range(m)]
           + list(d["cx"]) + list(d["cu"]))
    ref = np.stack([r.expand(HB).numpy() for r in ref], axis=1)
    k = ref.shape[1]
    np.testing.assert_allclose(out[:, :k], ref, rtol=1e-5, atol=1e-6)
    on = np.abs(u[0]) == ties.LIM
    for a in range(n):
        np.testing.assert_array_equal(
            d["fu"][a][0].expand(HB).numpy()[on],
            0.5 * free["fu"][a][0].expand(HB).numpy()[on])
    zero = u[0] == 0
    np.testing.assert_allclose(
        d["cu"][0].expand(HB).numpy()[zero],
        free["cu"][0].expand(HB).numpy()[zero] + ties.L1,
        rtol=1e-6)
