"""Full DDP on the fleet tier: second-order derivative tiles and K1's
second-order contractions, the port against the JAX package.

- ``autodiff_derivs_tiles(second_order=True)`` on pendcart and the
  quadrotor against JAX's, every key, 2e-5 (PyTorch's forward-mode
  autodiff against JAX's, f32);
- ``pendcart_derivs_tiles_so`` against the autodiff tiles (as
  ``tests/test_autodiff_tiles.py:39``) and against JAX's analytic ones;
- K1 with second-order tiles (the plain version) against JAX's
  ``backward_lanes`` in interpret mode (B=8, T=10, k_t=2), and the
  first-order tiles more than 5× further than the second-order ones from
  the generic full-DDP backward pass (as ``tests/test_pallas_kernels.py:258``);
- ``ilqg_batch_lanes`` with ``pendcart_derivs_tiles_so`` against JAX's:
  costs to rtol 1e-4, equal reasons and accepted counts.

Inputs are made in numpy f64 with a seeded Generator and cast to f32.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import differentialdynamicprogramming_jl_tpu as J
from differentialdynamicprogramming_jl_tpu.models import pendcart as jpc
from differentialdynamicprogramming_jl_tpu.models import quadrotor as jq
from differentialdynamicprogramming_jl_tpu.ops.pallas import (
    backward_kernel as jbk)
from differentialdynamicprogramming_jl_tpu.ops.pallas.autodiff_tiles import (
    autodiff_derivs_tiles as jax_ad_tiles)
from differentialdynamicprogramming_jl_tpu_torch import convert
from differentialdynamicprogramming_jl_tpu_torch.models import pendcart as tpc
from differentialdynamicprogramming_jl_tpu_torch.models import quadrotor as tq
from differentialdynamicprogramming_jl_tpu_torch.ops.backward import (
    backward_pass)
from differentialdynamicprogramming_jl_tpu_torch.ops.hopper import (
    backward_kernel as bk)
from differentialdynamicprogramming_jl_tpu_torch.ops.hopper.autodiff_tiles \
    import autodiff_derivs_tiles
from differentialdynamicprogramming_jl_tpu_torch.problem import (
    make_autodiff_derivs)
from differentialdynamicprogramming_jl_tpu_torch.solvers.batch import (
    ilqg_batch_lanes)

B, T = 8, 10
LIMS = ((-5.0, 5.0),)
SPEC = jpc.PendCartSpec()
TSPEC = convert.spec_from_jax(SPEC)
SO_KEYS = ("fx", "fu", "cx", "cu", "cxx", "cxu", "cuu", "fxx", "fxu", "fuu")


def _leaves(d):
    return [np.asarray(v) for v in jax.tree_util.tree_leaves(
        {k: d[k] for k in SO_KEYS})]


def _xu(name, seed=0):
    """Per-dimension (B,) inputs as numpy f32 lists."""
    rng = np.random.default_rng(seed)
    if name == "pendcart":
        x = np.array([np.pi - 0.6, 0, 0, 0])[:, None] + np.array(
            [0.5, 1.0, 0.3, 0.5])[:, None] * rng.standard_normal((4, B))
        u = rng.uniform(-6, 6, (1, B))
    else:
        x = np.array([1.0, 0, 0, 0, 0.3, 0])[:, None] + 0.3 * (
            rng.standard_normal((6, B)))
        u = 2.4525 + rng.standard_normal((2, B))
    return list(x.astype(np.float32)), list(u.astype(np.float32))


def _models(name):
    if name == "pendcart":
        return jpc.pendcart_lanes(SPEC), tpc.pendcart_lanes(TSPEC)
    return (jq.quadrotor_lanes(jq.QuadrotorSpec()), tq.quadrotor_lanes(
        convert.quadrotor_spec_from_jax(jq.QuadrotorSpec())))


@pytest.mark.parametrize("name", ["pendcart", "quadrotor"])
def test_autodiff_tiles_second_order_match_jax(name):
    jm, tm = _models(name)
    x, u = _xu(name)
    ref = jax_ad_tiles(jm, second_order=True)(
        [jnp.asarray(v) for v in x], [jnp.asarray(v) for v in u],
        jnp.int32(3))
    tiles = autodiff_derivs_tiles(tm, second_order=True)
    assert tiles.device.autodiff and tiles.device.second_order
    out = tiles([torch.from_numpy(v) for v in x],
                [torch.from_numpy(v) for v in u], 3)
    n, m = tm.n, tm.m
    assert len(out["fxx"]) == n and len(out["fxu"][0]) == n
    assert len(out["fxu"][0][0]) == m and len(out["fuu"][0][0]) == m
    for i, (a, b) in enumerate(zip(_leaves(out), _leaves(ref))):
        np.testing.assert_allclose(a, b, rtol=2e-5, atol=2e-5,
                                   err_msg=str(i))


def test_pendcart_so_tiles_match_autodiff_and_jax():
    x, u = _xu("pendcart", seed=1)
    xt = [torch.from_numpy(v) for v in x]
    ut = [torch.from_numpy(v) for v in u]
    so = tpc.pendcart_derivs_tiles_so(TSPEC)
    assert so.device.second_order and not so.device.autodiff
    assert so.device.model_id == 1
    out = so(xt, ut, 3)
    ad = autodiff_derivs_tiles(tpc.pendcart_lanes(TSPEC),
                               second_order=True)(xt, ut, 3)
    ref = jpc.pendcart_derivs_tiles_so(SPEC)(
        [jnp.asarray(v) for v in x], [jnp.asarray(v) for v in u],
        jnp.int32(3))
    for i, (a, b, c) in enumerate(zip(_leaves(out), _leaves(ad),
                                      _leaves(ref))):
        np.testing.assert_allclose(a, b, rtol=2e-5, atol=2e-5,
                                   err_msg=str(i))
        np.testing.assert_allclose(a, c, rtol=2e-6, atol=2e-6,
                                   err_msg=str(i))


def _stream(seed=0):
    rng = np.random.default_rng(seed)
    x = (np.array([np.pi - 0.6, 0.0, 0.0, 0.0])[None, :, None]
         + np.array([0.5, 1.0, 0.3, 0.5])[None, :, None]
         * rng.standard_normal((T, 4, B)))
    u = rng.uniform(-6.0, 6.0, (T, 1, B))
    return np.concatenate([x, u, np.zeros((T, 1, B))],
                          axis=1).astype(np.float32)


def test_backward_second_order_matches_jax():
    """K1's second-order contractions (JAX :466-481) with the analytic and
    the autodiff second-order tiles, in "gains" and "full", against JAX's
    kernel with its analytic second-order tiles."""
    st = _stream()
    lam = np.linspace(0.0, 2.0, B).astype(np.float32)
    ref = jbk.backward_lanes(
        jnp.asarray(convert.stream_to_lanes(st)),
        jnp.asarray(convert.stream_to_lanes(lam)), n=4, m=1, reg_type=2,
        lims=LIMS, k_t=2, derivs_tiles=jpc.pendcart_derivs_tiles_so(SPEC),
        interpret=True)
    ro = convert.stream_from_lanes(ref.out, B)
    rs = convert.stream_from_lanes(ref.stats, B)
    tiles = {"analytic": (tpc.pendcart_derivs_tiles_so(TSPEC), 1e-5),
             "autodiff": (autodiff_derivs_tiles(tpc.pendcart_lanes(TSPEC),
                                                second_order=True), 1e-4)}
    for name, (tl_, tol) in tiles.items():
        for emit in ("gains", "full"):
            out = bk.backward_lanes(torch.from_numpy(st),
                                    torch.from_numpy(lam), n=4, m=1,
                                    reg_type=2, lims=LIMS, derivs_tiles=tl_,
                                    emit=emit)
            S = out.out.shape[1]
            np.testing.assert_allclose(out.out.numpy(), ro[:, :S], rtol=tol,
                                       atol=tol, err_msg=f"{name} {emit}")
            np.testing.assert_array_equal(out.stats[2:].numpy(), rs[2:])
            np.testing.assert_allclose(out.stats[:2].numpy(), rs[:2],
                                       rtol=tol, atol=tol)
    # the Hessian terms change the result
    first = bk.backward_lanes(torch.from_numpy(st), torch.from_numpy(lam),
                              n=4, m=1, reg_type=2, lims=LIMS,
                              derivs_tiles=tpc.pendcart_derivs_tiles(TSPEC))
    assert np.abs(first.out.numpy() - ro).max() > 1e-2


def test_first_order_tiles_are_worse_than_second_order():
    """Against the generic full-DDP backward pass (ops/backward.py fed
    autodiff fxx/fxu/fuu, f64), the second-order tiles agree to 3e-4 and
    the first-order tiles are more than 5× further off
    (tests/test_pallas_kernels.py:258-310)."""
    st = _stream(seed=2)
    st[:, 4] *= 0.3                         # inside the limits: no clamp
    lam = np.full(B, 0.5, np.float32)
    prob = tpc.make_pendcart_problem(TSPEC, "euler", dtype=torch.float64,
                                     device="cpu")
    x = torch.from_numpy(np.transpose(st[:, :4], (2, 0, 1))).double()
    u = torch.from_numpy(np.transpose(st[:, 4:5], (2, 0, 1))).double()
    d2 = make_autodiff_derivs(prob.dynamics, prob.cost,
                              second_order=True)(x, u)
    ref = backward_pass(d2, u, lam=torch.from_numpy(lam).double(),
                        reg_type=1)
    lay = bk.OutLayout(4, 1)

    def err(tiles):
        o = bk.backward_lanes(torch.from_numpy(st), torch.from_numpy(lam),
                              n=4, m=1, reg_type=1, lims=None,
                              derivs_tiles=tiles).out.double()
        k = o[:, lay.k].T[..., None]
        K = o[:, lay.K:lay.K + 4].permute(2, 0, 1)[:, :, None]
        Vx = o[:, lay.Vx:lay.Vx + 4].permute(2, 0, 1)
        return max((k - ref.policy.k).abs().max().item(),
                   (K - ref.policy.K).abs().max().item(),
                   (Vx - ref.Vx).abs().max().item())

    e2 = err(tpc.pendcart_derivs_tiles_so(TSPEC))
    e1 = err(tpc.pendcart_derivs_tiles(TSPEC))
    assert e2 < 3e-4, e2
    assert e1 > 5 * e2, (e1, e2)


def test_fleet_second_order_matches_jax():
    """ilqg_batch_lanes with pendcart_derivs_tiles_so (full DDP on the
    fleet tier) at the shapes of tests/test_torch_batch.py."""
    rng = np.random.default_rng(0)
    x0s = (np.array([np.pi - 0.6, 0, 0, 0])[None, :]
           + 0.1 * rng.standard_normal((B, 4))).astype(np.float32)
    u0s = (0.1 * rng.standard_normal((B, 6, 1))).astype(np.float32)
    jcfg = J.ILQGConfig(alphas=J.default_alphas(0.2, -3.0, 3), reg_type=2,
                        max_iter=2, iter_cap=3)
    ref = convert.result_to_numpy(J.ilqg_batch_lanes(
        jpc.pendcart_lanes(SPEC), None, jnp.asarray(x0s), jnp.asarray(u0s),
        lims=LIMS, cfg=jcfg, derivs_tiles=jpc.pendcart_derivs_tiles_so(SPEC),
        kt_backward=2, kt_forward=2, interpret=True))
    out = convert.result_to_numpy(ilqg_batch_lanes(
        tpc.pendcart_lanes(TSPEC), None, torch.from_numpy(x0s),
        torch.from_numpy(u0s), lims=LIMS, cfg=convert.config_from_jax(jcfg),
        derivs_tiles=tpc.pendcart_derivs_tiles_so(TSPEC)))
    np.testing.assert_allclose(out["cost_total"], ref["cost_total"],
                               rtol=1e-4)
    for name in ("reason", "n_accepted", "n_iters"):
        np.testing.assert_array_equal(out[name], ref[name], err_msg=name)
    np.testing.assert_allclose(out["policy"]["K"], ref["policy"]["K"],
                               rtol=1e-4, atol=1e-5)


def test_second_order_without_instance_raises_off_cpu():
    """On tensors off the CPU (the meta device, which needs no card)
    second-order tiles run a second-order instance or raise. PendCartSO
    runs "gains" and "full" without GPS mode and "policy" in it, the LTI's
    autodiff tiles (Autodiff<LTI, true>) the same: those reach the launch,
    which refuses meta tensors. GPS "full" and "policy" without GPS mode
    have no second-order instance and raise. Nothing falls back to a
    first-order instance."""
    from differentialdynamicprogramming_jl_tpu_torch.models import linear
    meta = dict(device="meta")
    pso = tpc.pendcart_derivs_tiles_so(TSPEC)
    traj = torch.zeros((T, 6, B), **meta)
    gps = dict(prev=torch.zeros((T, 6, B), **meta),
               eta=torch.ones((T, B), **meta))
    spec = linear.random_lti(0, n=10, m=2, T=T, device="cpu")
    lso = autodiff_derivs_tiles(linear.lti_lanes(spec), second_order=True)
    ltraj = torch.zeros((T, 13, B), **meta)
    lgps = dict(prev=torch.zeros((T, 2 + 20 + 4, B), **meta),
                eta=torch.ones((T, B), **meta))
    cases = [(pso, traj, 4, 1, "full", gps, False),
             (pso, traj, 4, 1, "policy", {}, False),
             (pso, traj, 4, 1, "policy", gps, True),
             (lso, ltraj, 10, 2, "gains", {}, True),
             (lso, ltraj, 10, 2, "policy", lgps, True)]
    for tiles, tr, n, m, emit, kw, built in cases:
        with pytest.raises(ValueError if built else NotImplementedError,
                           match=("no kernel for tensors on meta" if built
                                  else "second-order")):
            bk.backward_lanes(tr, torch.zeros(B, **meta), n=n, m=m,
                              reg_type=1, lims=None, derivs_tiles=tiles,
                              emit=emit, **kw)
    assert (1, 4, 1, False, False) in bk.CUDA_BACKWARD_SO
