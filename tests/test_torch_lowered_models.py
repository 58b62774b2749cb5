"""Models written only in Python, on the paths that lower them on the card,
against the JAX package on the CPU.

On CPU tensors a model without a descriptor runs the port's plain
versions (``tests/test_torch_lower.py`` holds the lowering itself); here
those paths meet JAX's kernels in interpret mode at B=8, T=6, k_t=2:

- K3 and K2 with an angle-wrapping ``diff`` on the quadrotor, against
  JAX's ``forward_lanes``/``linesearch_lanes``;
- KL on the quadrotor (``ilqgkl_batch_lanes``), by outcome.

``params`` through the autodiff tiles and the fleet solve of
``pendcart_lanes_param`` with them are held against JAX in
``tests/test_torch_lower.py``, which keeps each file's time short.

Inputs are made in numpy f64 from seeded Generators and cast to f32 for
both packages.
"""
import dataclasses
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from differentialdynamicprogramming_jl_tpu.models import quadrotor as jq
from differentialdynamicprogramming_jl_tpu.ops.pallas.autodiff_tiles import (
    autodiff_derivs_tiles as jax_autodiff_tiles)
from differentialdynamicprogramming_jl_tpu.ops.pallas.forward_kernel import (
    forward_lanes as jax_forward_lanes, linesearch_lanes as jax_linesearch)
from differentialdynamicprogramming_jl_tpu.policy import (
    GaussianPolicy as JPolicy)
from differentialdynamicprogramming_jl_tpu.solvers import batch_kl as jkl
from differentialdynamicprogramming_jl_tpu.solvers.ilqgkl import (
    ILQGKLConfig as JKLConfig)
from differentialdynamicprogramming_jl_tpu_torch import convert
from differentialdynamicprogramming_jl_tpu_torch.models import quadrotor as tq
from differentialdynamicprogramming_jl_tpu_torch.ops.hopper.autodiff_tiles \
    import autodiff_derivs_tiles
from differentialdynamicprogramming_jl_tpu_torch.ops.hopper.backward_kernel \
    import backward_lanes
from differentialdynamicprogramming_jl_tpu_torch.ops.hopper.forward_kernel \
    import forward_lanes, linesearch_lanes
from differentialdynamicprogramming_jl_tpu_torch.solvers import batch_kl as tkl

B, T = 8, 6
JQSPEC = jq.QuadrotorSpec()
QSPEC = convert.quadrotor_spec_from_jax(JQSPEC)


def bare(model, **kw):
    """The model with its descriptor removed: Python functions only."""
    return dataclasses.replace(model, device=None, **kw)


def torch_wrap(x, x_old):
    """Angle wrapping of the attitude θ (state 4) into [-π, π)."""
    d = [x[i] - x_old[i] for i in range(6)]
    d[4] = torch.remainder(d[4] + math.pi, 2 * math.pi) - math.pi
    return d


def jax_wrap(x, x_old):
    d = [x[i] - x_old[i] for i in range(6)]
    d[4] = jnp.remainder(d[4] + math.pi, 2 * math.pi) - math.pi
    return d


def _lanes(a):
    return jnp.asarray(convert.stream_to_lanes(a))


# ---------------------------------------------------------------------------
# diff in K3 and K2
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def quad_stream():
    """A rolled-out quadrotor [x, u, c] stream whose stored attitude is
    shifted by 2π on half the lanes (the same attitude to a wrapping diff),
    the backward pass's gains on the unshifted stream, and line-search
    selectors with half the lanes allowed to accept."""
    rng = np.random.default_rng(2)
    model = bare(tq.quadrotor_lanes(QSPEC))
    x0 = (np.asarray(tq.default_x0(device="cpu"))[:, None]
          + 0.3 * rng.standard_normal((6, B))
          * np.array([1, 0, 1, 0, 0.5, 0])[:, None]).astype(np.float32)
    u0 = (QSPEC.u_hover + 0.2 * rng.standard_normal((T, 2, B))).astype(
        np.float32)
    gains0 = np.concatenate([u0, np.zeros((T, 12, B), np.float32)], axis=1)
    ro = forward_lanes(torch.zeros(T, 9, B), torch.from_numpy(gains0),
                       torch.from_numpy(x0), torch.ones(1, B), model=model,
                       lims=QSPEC.lims, emit_traj=True)
    bwd = backward_lanes(ro.traj, torch.ones(B), n=6, m=2, reg_type=2,
                         lims=QSPEC.lims,
                         derivs_tiles=autodiff_derivs_tiles(model),
                         emit="gains")
    traj = ro.traj.numpy().copy()
    traj[:, 4, ::2] += np.float32(2 * np.pi)
    allow = (np.arange(B) % 2 == 0).astype(np.float32)
    sel = np.stack([bwd.stats[0].numpy(), bwd.stats[1].numpy(),
                    ro.totals[0].numpy(), allow])
    return x0, traj, bwd.out.numpy(), sel


def test_forward_with_diff_matches_jax(quad_stream):
    """K3 (A=3, with the α-0 trajectory) with the wrapping diff: the port's
    plain version against JAX's kernel; without the diff the shifted lanes
    roll out elsewhere."""
    x0, traj, gains, _ = quad_stream
    alphas = np.broadcast_to(np.float32([1.0, 0.5, 0.1])[:, None],
                             (3, B)).copy()
    jm = dataclasses.replace(jq.quadrotor_lanes(JQSPEC), diff=jax_wrap)
    ref = jax_forward_lanes(
        _lanes(traj), _lanes(gains), _lanes(x0), _lanes(alphas), model=jm,
        lims=JQSPEC.lims, gk=0, gK=2, emit_traj=True, k_t=2, interpret=True)
    args = [torch.from_numpy(a) for a in (traj, gains, x0, alphas)]
    model = bare(tq.quadrotor_lanes(QSPEC), diff=torch_wrap)
    out = forward_lanes(*args, model=model, lims=QSPEC.lims, gk=0, gK=2,
                        emit_traj=True)
    for name in ("totals", "terminal", "traj"):
        np.testing.assert_allclose(
            getattr(out, name).numpy(),
            convert.stream_from_lanes(getattr(ref, name), B),
            rtol=1e-5, atol=1e-5, err_msg=name)
    plain = forward_lanes(*args, model=bare(tq.quadrotor_lanes(QSPEC)),
                          lims=QSPEC.lims, gk=0, gK=2)
    moved = (plain.totals != out.totals).any(dim=0).numpy()
    assert moved[::2].all() and not moved[1::2].any()


def test_linesearch_with_diff_matches_jax(quad_stream):
    x0, traj, gains, sel = quad_stream
    alphas = (1.0, 0.5, 0.1)
    jm = dataclasses.replace(jq.quadrotor_lanes(JQSPEC), diff=jax_wrap)
    ref = jax_linesearch(
        _lanes(traj), _lanes(gains), _lanes(x0), _lanes(sel), model=jm,
        alphas=alphas, reduce_ratio_min=0.0, lims=JQSPEC.lims, gk=0, gK=2,
        emit_echo=False, k_t=2, interpret=True)
    model = bare(tq.quadrotor_lanes(QSPEC), diff=torch_wrap)
    out = linesearch_lanes(*[torch.from_numpy(a)
                             for a in (traj, gains, x0, sel)],
                           model=model, alphas=alphas, lims=QSPEC.lims,
                           gk=0, gK=2)
    ls, rls = out.ls.numpy(), convert.stream_from_lanes(ref.ls, B)
    # the decisions are equal; dcost and ratio carry the totals' 1e-5 as
    # absolute error (test_torch_forward.py)
    np.testing.assert_array_equal(ls[:2], rls[:2])
    np.testing.assert_allclose(ls[4], rls[4], rtol=1e-5, atol=1e-5)
    tol = 1e-5 * np.abs(sel[2]).max()
    np.testing.assert_allclose(ls[2:4], rls[2:4], rtol=1e-5, atol=2 * tol)
    np.testing.assert_allclose(out.traj.numpy(),
                               convert.stream_from_lanes(ref.traj, B),
                               rtol=1e-5, atol=1e-5)
    assert (ls[1] > 0.5).any()


# ---------------------------------------------------------------------------
# solves
# ---------------------------------------------------------------------------

def _quad_kl_inputs(Bn=B, Tn=T, seed=3):
    """Pre-rolled quadrotor trajectories (K3's plain version at α=1 with
    k := u0 around hover), the previous policy (K = 0, Σ = I, k = the
    pre-roll's u) and fx along them from the autodiff tiles, as numpy f32:
    what chip_smoke's quad-kl phase feeds both paths."""
    rng = np.random.default_rng(seed)
    model = tq.quadrotor_lanes(QSPEC)
    x0 = (np.asarray(tq.default_x0(device="cpu"))[None, :]
          + 0.3 * rng.standard_normal((Bn, 6))
          * np.array([1, 0, 1, 0, 0.5, 0])).astype(np.float32)
    u0 = (QSPEC.u_hover + 0.3 * rng.standard_normal((Bn, Tn, 2))).astype(
        np.float32)
    gains = torch.cat([torch.from_numpy(u0).permute(1, 2, 0),
                       torch.zeros(Tn, 12, Bn)], dim=1).contiguous()
    ro = forward_lanes(torch.zeros(Tn, 9, Bn), gains,
                       torch.from_numpy(x0.T.copy()), torch.ones(1, Bn),
                       model=model, lims=None, emit_traj=True)
    x = ro.traj[:, :6].permute(2, 0, 1).contiguous()
    u = ro.traj[:, 6:8].permute(2, 0, 1).contiguous()
    d = autodiff_derivs_tiles(model)(
        [ro.traj[:, i] for i in range(6)],
        [ro.traj[:, 6 + j] for j in range(2)], 0)
    fx = torch.stack([torch.stack([v.expand(Tn, Bn) for v in row], -1)
                      for row in d["fx"]], -2).permute(2, 0, 1, 3)
    eye = np.broadcast_to(np.eye(2, dtype=np.float32), (Bn, Tn, 2, 2))
    policy = dict(K=np.zeros((Bn, Tn, 2, 6), np.float32), k=u.numpy(),
                  sigma=eye.copy(), sigma_inv=eye.copy())
    return dict(x=x.numpy(), policy=policy, fx=fx.contiguous().numpy(),
                cost0=ro.totals[0].numpy())


def test_quadrotor_kl_matches_jax():
    """ilqgkl_batch_lanes on the quadrotor (scalar η, no limits; kl_step 3,
    which 7 of the 8 lanes satisfy, where the measured divergence of these
    inputs is 2.7-3.5 at every η the bracket tries): the port with the model lowered off the CPU (here its plain
    versions) against JAX's KL fleet with autodiff tiles; costs within
    1e-5, η and the measured divergence within 1e-4 (the dual bracket and
    the KL divergence of a GPS recursion at η near its bracket's floor),
    the satisfied share, done flags and iteration counts equal."""
    inp = _quad_kl_inputs()
    jcfg = JKLConfig(kl_step=3.0, max_iter=3)
    jm = jq.quadrotor_lanes(JQSPEC)
    jprev = JPolicy(**{k: jnp.asarray(v) for k, v in inp["policy"].items()})
    ref = convert.result_to_numpy(jkl.ilqgkl_batch_lanes(
        jm, jax_autodiff_tiles(jm), jnp.asarray(inp["x"]), jprev,
        jnp.asarray(inp["fx"]), jnp.asarray(inp["cost0"]), cfg=jcfg, kt=2,
        interpret=True))
    tm = bare(tq.quadrotor_lanes(QSPEC))
    out = convert.result_to_numpy(tkl.ilqgkl_batch_lanes(
        tm, autodiff_derivs_tiles(tm), torch.from_numpy(inp["x"]),
        convert.policy_from_jax(jprev, device="cpu"),
        torch.from_numpy(inp["fx"]), torch.from_numpy(inp["cost0"]),
        cfg=convert.kl_config_from_jax(jcfg)))
    np.testing.assert_allclose(out["cost_total"], ref["cost_total"],
                               rtol=1e-5)
    for name in ("satisfied", "pd_failed", "done", "n_iters"):
        np.testing.assert_array_equal(out[name], ref[name], err_msg=name)
    for name in ("eta", "divergence"):
        np.testing.assert_allclose(out[name], ref[name], rtol=1e-4,
                                   err_msg=name)
    assert 0 < out["satisfied"].sum() < B
