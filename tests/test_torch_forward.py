"""K3 (multi-α rollout) and K2 (fused line search): the port's plain
versions against the JAX Pallas kernels in interpret mode.

Inputs are made once in numpy f64 with a seeded Generator and cast to f32;
the JAX side gets them in its lane layout (``convert.stream_to_lanes``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from differentialdynamicprogramming_jl_tpu.models import pendcart as jpc
from differentialdynamicprogramming_jl_tpu.ops.pallas.forward_kernel import (
    forward_lanes as jax_forward_lanes, linesearch_lanes as jax_linesearch)
from differentialdynamicprogramming_jl_tpu_torch import convert
from differentialdynamicprogramming_jl_tpu_torch.models import pendcart as tpc
from differentialdynamicprogramming_jl_tpu_torch.ops.hopper import lower
from differentialdynamicprogramming_jl_tpu_torch.ops.hopper.backward_kernel \
    import backward_lanes_ref
from differentialdynamicprogramming_jl_tpu_torch.ops.hopper.forward_kernel \
    import (LanesModel, forward_lanes, forward_lanes_ref, linesearch_lanes,
            linesearch_lanes_ref)
from differentialdynamicprogramming_jl_tpu_torch.solvers.ilqg import (
    default_alphas)

B, T = 8, 13
LIMS = ((-5.0, 5.0),)
ALPHAS = default_alphas(0.2, -3.0, 4)
SPEC = tpc.PendCartSpec()


@pytest.fixture(scope="module")
def data():
    """A rolled-out [x, u, c] stream, the backward pass's gains on it, and
    line-search selectors with half the lanes allowed to accept."""
    rng = np.random.default_rng(0)
    x0 = (np.array([np.pi - 0.6, 0, 0, 0])[:, None]
          + np.array([0.2, 0, 0, 0])[:, None] * rng.standard_normal((4, B)))
    x0 = x0.astype(np.float32)
    u0 = (0.4 * rng.standard_normal((T, 1, B))).astype(np.float32)
    gains0 = np.concatenate([u0, np.zeros((T, 4, B), np.float32)], axis=1)
    ro = forward_lanes_ref(torch.zeros(T, 5, B), torch.from_numpy(gains0),
                           torch.from_numpy(x0), torch.ones(1, B),
                           model=tpc.pendcart_lanes(SPEC), lims=LIMS,
                           emit_traj=True)
    traj = ro.traj.numpy()
    bwd = backward_lanes_ref(ro.traj, torch.ones(B), n=4, m=1, reg_type=2,
                             lims=LIMS,
                             derivs_tiles=tpc.pendcart_derivs_tiles(SPEC),
                             emit="gains")
    gains = bwd.out.numpy()
    allow = (np.arange(B) % 2 == 0).astype(np.float32)
    sel = np.stack([bwd.stats[0].numpy(), bwd.stats[1].numpy(),
                    ro.totals[0].numpy(), allow])
    return x0, traj, gains, sel


def _lanes(a):
    return jnp.asarray(convert.stream_to_lanes(a))


@pytest.mark.parametrize("A,emit", [(4, False), (1, True)])
def test_forward_matches_jax(data, A, emit):
    x0, traj, gains, _ = data
    alphas = np.broadcast_to(
        np.asarray(ALPHAS[:A], np.float32)[:, None], (A, B)).copy()
    if A == 1:
        alphas[0] = np.linspace(0.0, 1.0, B)
    ref = jax_forward_lanes(
        _lanes(traj[:, :5]), _lanes(gains), _lanes(x0), _lanes(alphas),
        model=jpc.pendcart_lanes(jpc.PendCartSpec()), lims=LIMS, gk=0, gK=1,
        emit_traj=emit, k_t=4, interpret=True)
    out = forward_lanes(torch.from_numpy(traj), torch.from_numpy(gains),
                        torch.from_numpy(x0), torch.from_numpy(alphas),
                        model=tpc.pendcart_lanes(SPEC), lims=LIMS, gk=0,
                        gK=1, emit_traj=emit)
    for name in ("totals", "terminal"):
        np.testing.assert_allclose(
            getattr(out, name).numpy(),
            convert.stream_from_lanes(getattr(ref, name), B),
            rtol=1e-5, atol=1e-5, err_msg=name)
    if emit:
        np.testing.assert_allclose(out.traj.numpy(),
                                   convert.stream_from_lanes(ref.traj, B),
                                   rtol=1e-5, atol=1e-5)
    else:
        assert out.traj is None


@pytest.mark.parametrize("A,emit", [(4, False), (1, True)])
def test_forward_unclamped_matches_jax(A, emit):
    """lims=None: no clamp (JAX forward_kernel.py:117-121); the port clamps
    to ±inf, which returns every value unchanged. Controls of ±8 make the
    ±5 limits bind, so the unclamped rollout differs from the clamped one."""
    rng = np.random.default_rng(1)
    x0 = (np.array([np.pi - 0.6, 0, 0, 0])[:, None]
          + np.array([0.2, 0, 0, 0])[:, None] * rng.standard_normal((4, B))
          ).astype(np.float32)
    u0 = (8.0 * rng.standard_normal((T, 1, B))).astype(np.float32)
    gains0 = np.concatenate([u0, np.zeros((T, 4, B), np.float32)], axis=1)
    traj0 = np.zeros((T, 5, B), np.float32)
    alphas = np.broadcast_to(np.asarray(ALPHAS[:A], np.float32)[:, None],
                             (A, B)).copy()
    ref = jax_forward_lanes(
        _lanes(traj0), _lanes(gains0), _lanes(x0), _lanes(alphas),
        model=jpc.pendcart_lanes(jpc.PendCartSpec()), lims=None,
        emit_traj=emit, k_t=4, interpret=True)
    args = [torch.from_numpy(a) for a in (traj0, gains0, x0, alphas)]
    out = forward_lanes(*args, model=tpc.pendcart_lanes(SPEC), lims=None,
                        emit_traj=emit)
    np.testing.assert_allclose(out.totals.numpy(),
                               convert.stream_from_lanes(ref.totals, B),
                               rtol=1e-5)
    if emit:
        np.testing.assert_allclose(out.traj.numpy(),
                                   convert.stream_from_lanes(ref.traj, B),
                                   rtol=1e-5, atol=1e-5)
        assert np.abs(out.traj[:, 4].numpy()).max() > 5.0
    clamped = forward_lanes(*args, model=tpc.pendcart_lanes(SPEC), lims=LIMS)
    assert not torch.equal(clamped.totals, out.totals)


@pytest.mark.parametrize("rr_min", [0.0, 0.6])
def test_linesearch_matches_jax(data, rr_min):
    x0, traj, gains, sel = data
    ref = jax_linesearch(
        _lanes(traj), _lanes(gains), _lanes(x0), _lanes(sel),
        model=jpc.pendcart_lanes(jpc.PendCartSpec()), alphas=ALPHAS,
        reduce_ratio_min=rr_min, lims=LIMS, gk=0, gK=1, emit_echo=False,
        k_t=4, interpret=True)
    out = linesearch_lanes(torch.from_numpy(traj), torch.from_numpy(gains),
                           torch.from_numpy(x0), torch.from_numpy(sel),
                           model=tpc.pendcart_lanes(SPEC), alphas=ALPHAS,
                           reduce_ratio_min=rr_min, lims=LIMS, gk=0, gK=1)
    ls, rls = out.ls.numpy(), convert.stream_from_lanes(ref.ls, B)
    # al_sel and any_ok are decisions: equal. The totals agree to 1e-5;
    # dcost = cost_old - total cancels totals of ~50 down to ~1, so dcost
    # and ratio = dcost/expected carry 1e-5 of the totals as absolute error
    np.testing.assert_array_equal(ls[:2], rls[:2])
    np.testing.assert_allclose(ls[4], rls[4], rtol=1e-5, atol=1e-5)
    tol = 1e-5 * np.abs(sel[2]).max()
    np.testing.assert_allclose(ls[2:4], rls[2:4], rtol=1e-5, atol=2 * tol)
    np.testing.assert_allclose(out.traj.numpy(),
                               convert.stream_from_lanes(ref.traj, B),
                               rtol=1e-5, atol=1e-5)
    accepted = (ls[1] > 0.5) & (sel[3] > 0.5)
    assert accepted.any() and not accepted.all()
    # rejected lanes retrace their stream with α=0, bit for bit
    np.testing.assert_array_equal(out.traj.numpy()[..., ~accepted],
                                  traj[..., ~accepted])


def test_wrappers_are_the_plain_versions_on_cpu(data):
    x0, traj, gains, sel = data
    args = [torch.from_numpy(a) for a in (traj, gains, x0)]
    model = tpc.pendcart_lanes(SPEC)
    before = (forward_lanes.launches, linesearch_lanes.launches)
    a = linesearch_lanes(*args, torch.from_numpy(sel), model=model,
                         alphas=ALPHAS, lims=LIMS)
    b = linesearch_lanes_ref(*args, torch.from_numpy(sel), model=model,
                             alphas=ALPHAS, reduce_ratio_min=0.0, lims=LIMS)
    assert (forward_lanes.launches, linesearch_lanes.launches) == before
    torch.testing.assert_close(a.traj, b.traj, rtol=0, atol=0)
    torch.testing.assert_close(a.ls, b.ls, rtol=0, atol=0, equal_nan=True)


def test_model_without_descriptor_raises_off_cpu(data, monkeypatch):
    """A LanesModel made of Python functions has no device descriptor: the
    kernel path lowers it (ops/hopper/lower.py), and only for CUDA tensors.
    On other tensors it raises before any lowering instead of running the
    plain version."""
    x0, traj, gains, _ = data
    m = tpc.pendcart_lanes(SPEC)
    bare = LanesModel(n=4, m=1, dynamics=m.dynamics, cost=m.cost,
                      terminal=m.terminal)

    def no_lowering(model):
        raise AssertionError("lowered for tensors that are not on a card")

    monkeypatch.setattr(lower, "lower", no_lowering)
    meta = [torch.empty(a.shape, device="meta") for a in (traj, gains, x0)]
    with pytest.raises(ValueError, match="no kernel for tensors on meta"):
        forward_lanes(*meta, torch.empty((1, B), device="meta"), model=bare,
                      lims=LIMS)



def test_wrappers_refuse_mismatched_streams(data):
    x0, traj, gains, sel = (torch.from_numpy(a) for a in data)
    model = tpc.pendcart_lanes(SPEC)
    with pytest.raises(ValueError, match="forward_lanes"):
        forward_lanes(traj, gains[:-1], x0, torch.ones(1, B), model=model,
                      lims=LIMS)
    with pytest.raises(ValueError, match="linesearch_lanes"):
        linesearch_lanes(traj, gains, x0[:, :-1], sel, model=model,
                         alphas=ALPHAS, lims=LIMS)
