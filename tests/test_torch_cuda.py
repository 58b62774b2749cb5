"""The port's CUDA kernels against their plain PyTorch versions, on a card.

This file imports neither JAX nor the JAX package, so it also runs on a
machine that has only PyTorch and the CUDA toolkit:

    python -m pytest tests/test_torch_cuda.py --noconftest -q

Every test here needs a CUDA card (the kernels have no CPU mode) and skips
without one. Shapes are small; ``chip_smoke.py`` checks the main path's
shapes. Tolerance 1e-5: kernel and plain version run the same f32
operations in the same order (nvcc --fmad=false); only the card's
sinf/cosf and PyTorch's elementwise sin/cos may differ in the last ulp.
"""
import numpy as np
import pytest
import torch

from differentialdynamicprogramming_jl_tpu_torch.models import pendcart as tpc
from differentialdynamicprogramming_jl_tpu_torch.ops.hopper import (
    backward_kernel as bk, covariance_kernel as ck, forward_kernel as fk)
from differentialdynamicprogramming_jl_tpu_torch.ops.hopper.pack import (
    from_streams, to_streams)
from differentialdynamicprogramming_jl_tpu_torch.policy import GaussianPolicy
from differentialdynamicprogramming_jl_tpu_torch.solvers.batch import (
    ilqg_batch_lanes)
from differentialdynamicprogramming_jl_tpu_torch.solvers.batch_kl import (
    ilqgkl_batch_lanes)
from differentialdynamicprogramming_jl_tpu_torch.solvers.ilqg import (
    ILQGConfig, default_alphas)
from differentialdynamicprogramming_jl_tpu_torch.solvers.ilqgkl import (
    ILQGKLConfig)

B, T = 200, 40          # B not a multiple of the block: the mask b < B
LIMS = ((-5.0, 5.0),)
ALPHAS = default_alphas(0.2, -3.0, 6)
SPEC = tpc.PendCartSpec()


pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda", 0)


def _rollout(dev, seed=0):
    rng = np.random.default_rng(seed)
    x0 = (np.array([np.pi - 0.6, 0, 0, 0])[:, None]
          + np.array([0.2, 0, 0, 0])[:, None] * rng.standard_normal((4, B)))
    u0 = 2.0 * rng.standard_normal((T, 1, B))
    x0 = torch.tensor(x0, dtype=torch.float32, device=dev)
    gains0 = torch.cat([torch.tensor(u0, dtype=torch.float32, device=dev),
                        torch.zeros((T, 4, B), device=dev)], dim=1)
    al = torch.tensor(rng.uniform(0, 1, (1, B)), dtype=torch.float32,
                      device=dev)
    return x0, gains0, al


def test_forward_kernel_matches_plain(dev):
    x0, gains0, al = _rollout(dev)
    model = tpc.pendcart_lanes(SPEC)
    traj0 = torch.zeros((T, 5, B), device=dev)
    ladder = torch.tensor(ALPHAS, device=dev)[:, None].expand(6, B)
    for alphas, emit in ((ladder.contiguous(), False), (al, True)):
        n0 = fk.forward_lanes.launches
        k = fk.forward_lanes(traj0, gains0, x0, alphas, model=model,
                             lims=LIMS, emit_traj=emit)
        assert fk.forward_lanes.launches == n0 + 1
        p = fk.forward_lanes_ref(traj0, gains0, x0, alphas, model=model,
                                 lims=LIMS, emit_traj=emit)
        torch.testing.assert_close(k.totals, p.totals, rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(k.terminal, p.terminal, rtol=1e-5,
                                   atol=1e-5)
        if emit:
            torch.testing.assert_close(k.traj, p.traj, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("reg_type", [1, 2])
@pytest.mark.parametrize("emit", ["gains", "full"])
@pytest.mark.parametrize("R", [1.0, -1e-3])
def test_backward_kernel_matches_plain(dev, reg_type, emit, R):
    x0, gains0, al = _rollout(dev)
    traj = fk.forward_lanes(torch.zeros((T, 5, B), device=dev), gains0, x0,
                            al, model=tpc.pendcart_lanes(SPEC), lims=LIMS,
                            emit_traj=True).traj
    lam = torch.linspace(0.0, 3.0, B, device=dev)
    tiles = tpc.pendcart_derivs_tiles(tpc.PendCartSpec(R=R))
    k = bk.backward_lanes(traj, lam, n=4, m=1, reg_type=reg_type, lims=LIMS,
                          derivs_tiles=tiles, emit=emit)
    p = bk.backward_lanes_ref(traj, lam, n=4, m=1, reg_type=reg_type,
                              lims=LIMS, derivs_tiles=tiles, emit=emit)
    S = bk.OutLayout(4, 1, emit).S
    nq = S - 1 if emit == "full" else S
    torch.testing.assert_close(k.out[:, :nq], p.out[:, :nq], rtol=1e-5,
                               atol=1e-5)
    if emit == "full":
        # Quu⁻¹: with R = -1e-3, Quu = cuu + fuᵀVxx·fu cancels to ~1e-6, so
        # an ulp of its terms moves Quu⁻¹ by ~1e-5 relative
        torch.testing.assert_close(k.out[:, nq], p.out[:, nq], rtol=1e-3,
                                   atol=1e-5)
    torch.testing.assert_close(k.stats[:2], p.stats[:2], rtol=1e-5,
                               atol=1e-5)
    assert torch.equal(k.stats[2:], p.stats[2:])


def test_linesearch_kernel_matches_plain_and_retraces(dev):
    x0, gains0, al = _rollout(dev)
    model = tpc.pendcart_lanes(SPEC)
    ro = fk.forward_lanes(torch.zeros((T, 5, B), device=dev), gains0, x0, al,
                          model=model, lims=LIMS, emit_traj=True)
    bo = bk.backward_lanes(ro.traj, torch.ones(B, device=dev), n=4, m=1,
                           reg_type=2, lims=LIMS,
                           derivs_tiles=tpc.pendcart_derivs_tiles(SPEC),
                           emit="gains")
    allow = (torch.arange(B, device=dev) % 2 == 0).float()
    sel = torch.stack([bo.stats[0], bo.stats[1], ro.totals[0], allow])
    for rr_min in (0.0, 0.6):
        k = fk.linesearch_lanes(ro.traj, bo.out, x0, sel, model=model,
                                alphas=ALPHAS, reduce_ratio_min=rr_min,
                                lims=LIMS)
        p = fk.linesearch_lanes_ref(ro.traj, bo.out, x0, sel, model=model,
                                    alphas=ALPHAS, reduce_ratio_min=rr_min,
                                    lims=LIMS)
        torch.testing.assert_close(k.traj, p.traj, rtol=1e-5, atol=1e-5)
        assert torch.equal(k.ls[:2], p.ls[:2])
        torch.testing.assert_close(k.ls[2:], p.ls[2:], rtol=1e-5, atol=1e-4)
        rej = (k.ls[1] < 0.5) | (allow < 0.5)
        assert rej.any()
        # α=0 on rejected lanes retraces the K3 stream bit for bit
        assert torch.equal(k.traj[..., rej], ro.traj[..., rej])


def test_solver_on_card_matches_cpu(dev):
    x0, _, _ = _rollout(dev)
    x0s = x0.T.contiguous()[:16]
    u0s = torch.zeros((16, T, 1), device=dev)
    cfg = ILQGConfig(alphas=ALPHAS, reg_type=2, lam_max=1e15)
    kw = dict(lims=LIMS, cfg=cfg, max_steps=8,
              derivs_tiles=tpc.pendcart_derivs_tiles(SPEC))
    g = ilqg_batch_lanes(tpc.pendcart_lanes(SPEC), None, x0s, u0s, **kw)
    c = ilqg_batch_lanes(tpc.pendcart_lanes(SPEC), None, x0s.cpu(),
                         u0s.cpu(), **kw)
    assert g.cost_total.device.type == "cuda"
    # costs agree; reasons 0 and 2 are not compared lane by lane: near the
    # cost exit's f32 noise floor (8·eps·|cost|) an ulp decides between
    # "converged" and "still running at max_steps"
    torch.testing.assert_close(g.cost_total.cpu(), c.cost_total, rtol=1e-4,
                               atol=0)
    assert set(g.reason.tolist()) <= {0, 2}
    assert set(c.reason.tolist()) <= {0, 2}


def _pre_roll(dev, lims=None):
    """A K3 rollout of the KL path's pre-roll (k := u0, u_nom := 0, α=1)."""
    x0, gains0, _ = _rollout(dev)
    return fk.forward_lanes(torch.zeros((T, 5, B), device=dev), gains0, x0,
                            torch.ones((1, B), device=dev),
                            model=tpc.pendcart_lanes(SPEC), lims=lims,
                            emit_traj=True)


def test_forward_kernel_unclamped_matches_plain(dev):
    x0, gains0, al = _rollout(dev)
    gains0 = 4.0 * gains0                  # controls far beyond ±5
    traj0 = torch.zeros((T, 5, B), device=dev)
    kw = dict(model=tpc.pendcart_lanes(SPEC), lims=None, emit_traj=True)
    k = fk.forward_lanes(traj0, gains0, x0, al, **kw)
    p = fk.forward_lanes_ref(traj0, gains0, x0, al, **kw)
    torch.testing.assert_close(k.totals, p.totals, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(k.traj, p.traj, rtol=1e-5, atol=1e-5)
    assert k.traj[:, 4].abs().max() > 5.0


@pytest.mark.parametrize("r1", ["identity", "spd"])
def test_covariance_kernel_matches_plain(dev, r1):
    """Same f32 operations in the same order, no transcendentals: the
    kernel should give the plain version's bits; held to 1e-6 of each
    slot's scale."""
    traj = _pre_roll(dev).traj
    fx = tpc.make_pendcart_problem(SPEC, derivs="euler", device=dev).derivs(
        from_streams(traj[:, :4], (4,)), from_streams(traj[:, 4:5], (1,))).fx
    fx_s = to_streams(fx)
    r1v = (ck.identity_r1(4) if r1 == "identity" else
           tuple(tuple(1.0 + (i == j) + 0.1 * (i + j) for j in range(4))
                 for i in range(4)))
    n0 = ck.covariance_lanes.launches
    k = ck.covariance_lanes(fx_s, n=4, r1=r1v)
    assert ck.covariance_lanes.launches == n0 + 1
    p = ck.covariance_lanes_ref(fx_s, n=4, r1=r1v)
    scale = p.abs().amax(dim=(0, 2), keepdim=True)
    assert torch.isfinite(k).all()
    assert ((k - p).abs() <= 1e-6 * scale).all()
    assert torch.equal(k, p)


def _gps_inputs(dev, per_step):
    rng = np.random.default_rng(3)
    prev = np.concatenate([rng.standard_normal((T, 1, B)),
                           0.5 * rng.standard_normal((T, 4, B)),
                           rng.uniform(0.5, 2.0, (T, 1, B))], axis=1)
    eta = (10.0 ** rng.uniform(0, 1, (T, B)) if per_step
           else np.ones((T, B)))
    eta[::7, ::5] = 0.0                    # counts as 1
    return (torch.tensor(prev, dtype=torch.float32, device=dev),
            torch.tensor(eta, dtype=torch.float32, device=dev))


@pytest.mark.parametrize("per_step", [False, True])
@pytest.mark.parametrize("lims", [None, LIMS])
@pytest.mark.parametrize("emit", ["policy", "full"])
def test_backward_kernel_gps_matches_plain(dev, per_step, lims, emit):
    traj = _pre_roll(dev).traj
    prev, eta = _gps_inputs(dev, per_step)
    kw = dict(n=4, m=1, reg_type=1, lims=lims,
              derivs_tiles=tpc.pendcart_derivs_tiles(SPEC), prev=prev,
              eta=eta, emit=emit)
    lam = torch.zeros(B, device=dev)
    k = bk.backward_lanes(traj, lam, **kw)
    p = bk.backward_lanes_ref(traj, lam, **kw)
    lay = bk.OutLayout(4, 1, emit)
    torch.testing.assert_close(k.out[:, :lay.quui], p.out[:, :lay.quui],
                               rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(k.out[:, lay.quui], p.out[:, lay.quui],
                               rtol=1e-3, atol=1e-5)
    torch.testing.assert_close(k.stats[:2], p.stats[:2], rtol=1e-5,
                               atol=1e-5)
    assert torch.equal(k.stats[2:], p.stats[2:])


@pytest.mark.parametrize("reg_type", [1, 2])
@pytest.mark.parametrize("R", [1.0, -0.05])
def test_backward_kernel_unconstrained_matches_plain(dev, reg_type, R):
    traj = _pre_roll(dev).traj
    lam = torch.logspace(-3, 4, B, device=dev)
    kw = dict(n=4, m=1, reg_type=reg_type, lims=None,
              derivs_tiles=tpc.pendcart_derivs_tiles(tpc.PendCartSpec(R=R)),
              emit="gains")
    k = bk.backward_lanes(traj, lam, **kw)
    p = bk.backward_lanes_ref(traj, lam, **kw)
    # with the concave R, QuuF = Quu + λ·(…) crosses 0 across the λ range;
    # near the crossing k = -Qu/QuuF amplifies an ulp of QuuF's terms
    # (measured 2e-4 relative on an H100)
    rtol = 1e-5 if R > 0 else 1e-3
    torch.testing.assert_close(k.out, p.out, rtol=rtol, atol=1e-5)
    assert torch.equal(k.stats[2:], p.stats[2:])
    n_latch = int((k.stats[2] > 0.5).sum())
    assert (n_latch == 0) if R > 0 else (0 < n_latch < B)


def test_kl_solve_on_card_matches_cpu(dev):
    """The KL solve through K1 (GPS, policy), K3 and K4 on the card against
    the plain versions on the CPU: same outcome flags, costs to 1e-4."""
    ro = _pre_roll(dev)
    Bs = 16
    x = from_streams(ro.traj[:, :4], (4,))[:Bs].contiguous()
    u = from_streams(ro.traj[:, 4:5], (1,))[:Bs].contiguous()
    fx = tpc.make_pendcart_problem(SPEC, derivs="euler", device=dev).derivs(
        x, u).fx
    prev = GaussianPolicy.zeros(T, 4, 1, device=dev)
    prev = GaussianPolicy(*(a.expand((Bs,) + a.shape).contiguous()
                            for a in prev))._replace(k=u)
    cfg = ILQGKLConfig(kl_step=0.05, max_iter=4)
    args = (tpc.pendcart_lanes(SPEC), tpc.pendcart_derivs_tiles(SPEC))
    counts = [f.launches for f in (bk.backward_lanes, fk.forward_lanes,
                                   ck.covariance_lanes)]
    g = ilqgkl_batch_lanes(*args, x, prev, fx, ro.totals[0, :Bs], cfg=cfg)
    assert all(f.launches > c for f, c in zip(
        (bk.backward_lanes, fk.forward_lanes, ck.covariance_lanes), counts))
    c = ilqgkl_batch_lanes(*args, x.cpu(), GaussianPolicy(
        *(a.cpu() for a in prev)), fx.cpu(), ro.totals[0, :Bs].cpu(),
        cfg=cfg)
    assert g.cost_total.device.type == "cuda"
    for name in ("satisfied", "pd_failed", "n_iters"):
        assert torch.equal(getattr(g, name).cpu(), getattr(c, name)), name
    torch.testing.assert_close(g.cost_total.cpu(), c.cost_total, rtol=1e-4,
                               atol=0)
    torch.testing.assert_close(g.eta.cpu(), c.eta, rtol=1e-4, atol=0)


# ---- the LTI model ⟨10,2⟩: the m=2 box-QP enumeration, the unconstrained
#      m=2 Cholesky solve and the LTI model functions. No transcendentals:
#      kernel and plain version run the same IEEE f32 operations in the same
#      order and should agree bit for bit; held to 1e-5 all the same.

LTI_LIMS = ((-0.6, 0.6), (-0.6, 0.6))


def _lti(dev, seed=0):
    from differentialdynamicprogramming_jl_tpu_torch.models import linear
    spec = linear.random_lti(seed, n=10, m=2, T=T, device=dev)
    rng = np.random.default_rng(seed)
    x0 = torch.tensor(np.linspace(0.5, 2.0, B)[None, :]
                      + 0.3 * rng.standard_normal((10, B)),
                      dtype=torch.float32, device=dev)
    gains0 = torch.cat([torch.tensor(2.0 * rng.standard_normal((T, 2, B)),
                                     dtype=torch.float32, device=dev),
                        torch.zeros((T, 20, B), device=dev)], dim=1)
    al = torch.tensor(rng.uniform(0, 1, (1, B)), dtype=torch.float32,
                      device=dev)
    return (spec, linear.lti_lanes(spec), linear.lti_derivs_tiles(spec), x0,
            gains0, al)


def test_lti_forward_kernel_matches_plain(dev):
    _, model, _, x0, gains0, al = _lti(dev)
    traj0 = torch.zeros((T, 12, B), device=dev)
    ladder = torch.tensor(ALPHAS, device=dev)[:, None].expand(6, B)
    for lims in (LTI_LIMS, None):
        for alphas, emit in ((ladder.contiguous(), False), (al, True)):
            n0 = fk.forward_lanes.launches
            k = fk.forward_lanes(traj0, gains0, x0, alphas, model=model,
                                 lims=lims, emit_traj=emit)
            assert fk.forward_lanes.launches == n0 + 1
            p = fk.forward_lanes_ref(traj0, gains0, x0, alphas, model=model,
                                     lims=lims, emit_traj=emit)
            torch.testing.assert_close(k.totals, p.totals, rtol=1e-5,
                                       atol=1e-5)
            if emit:
                torch.testing.assert_close(k.traj, p.traj, rtol=1e-5,
                                           atol=1e-5)


@pytest.mark.parametrize("reg_type", [1, 2])
@pytest.mark.parametrize("emit", ["gains", "full", "policy"])
@pytest.mark.parametrize("lims", [LTI_LIMS, ((-0.05, 0.05), (-0.02, 0.08)),
                                  None])
def test_lti_backward_kernel_matches_plain(dev, reg_type, emit, lims):
    _, model, tiles, x0, gains0, al = _lti(dev)
    traj = fk.forward_lanes(torch.zeros((T, 12, B), device=dev), gains0, x0,
                            al, model=model, lims=LTI_LIMS,
                            emit_traj=True).traj
    lam = torch.logspace(-6, 2, B, device=dev)
    kw = dict(n=10, m=2, reg_type=reg_type, lims=lims, derivs_tiles=tiles,
              emit=emit)
    k = bk.backward_lanes(traj, lam, **kw)
    p = bk.backward_lanes_ref(traj, lam, **kw)
    torch.testing.assert_close(k.out, p.out, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(k.stats[:2], p.stats[:2], rtol=1e-5,
                               atol=1e-5)
    assert torch.equal(k.stats[2:], p.stats[2:])
    if lims is not None:
        # the box QP puts k on a limit of each control on some steps
        u = traj[:-1, 10:12]
        lo = torch.tensor([lo for lo, _ in lims], device=dev)[:, None]
        hi = torch.tensor([hi for _, hi in lims], device=dev)[:, None]
        on = (k.out[:-1, :2] == lo - u) | (k.out[:-1, :2] == hi - u)
        assert on[:, 0].any() and on[:, 1].any()


def test_lti_latch_matches_plain(dev):
    """R negative definite: the unconstrained solve latches on the lanes
    whose λ·BᵀB cannot lift Quu; identical flags in both versions."""
    spec, _, _, x0, gains0, al = _lti(dev)
    from differentialdynamicprogramming_jl_tpu_torch.models import linear
    model = linear.lti_lanes(spec)
    tiles = linear.lti_derivs_tiles(spec._replace(R=-spec.R))
    traj = fk.forward_lanes(torch.zeros((T, 12, B), device=dev), gains0, x0,
                            al, model=model, lims=LTI_LIMS,
                            emit_traj=True).traj
    lam = torch.logspace(-6, 2, B, device=dev)
    kw = dict(n=10, m=2, reg_type=2, lims=None, derivs_tiles=tiles,
              emit="full")
    k = bk.backward_lanes(traj, lam, **kw)
    p = bk.backward_lanes_ref(traj, lam, **kw)
    assert torch.equal(k.stats[2:], p.stats[2:])
    assert 0 < int((k.stats[2] > 0.5).sum()) < B
    torch.testing.assert_close(k.out, p.out, rtol=1e-4, atol=1e-5)


def test_lti_linesearch_kernel_matches_plain_and_retraces(dev):
    _, model, tiles, x0, gains0, al = _lti(dev)
    ro = fk.forward_lanes(torch.zeros((T, 12, B), device=dev), gains0, x0, al,
                          model=model, lims=LTI_LIMS, emit_traj=True)
    bo = bk.backward_lanes(ro.traj, torch.ones(B, device=dev), n=10, m=2,
                           reg_type=2, lims=LTI_LIMS, derivs_tiles=tiles,
                           emit="gains")
    allow = (torch.arange(B, device=dev) % 2 == 0).float()
    sel = torch.stack([bo.stats[0], bo.stats[1], ro.totals[0], allow])
    kw = dict(model=model, alphas=ALPHAS, lims=LTI_LIMS)
    k = fk.linesearch_lanes(ro.traj, bo.out, x0, sel, **kw)
    p = fk.linesearch_lanes_ref(ro.traj, bo.out, x0, sel,
                                reduce_ratio_min=0.0, **kw)
    torch.testing.assert_close(k.traj, p.traj, rtol=1e-5, atol=1e-5)
    assert torch.equal(k.ls[:2], p.ls[:2])
    rej = (k.ls[1] < 0.5) | (allow < 0.5)
    assert rej.any()
    assert torch.equal(k.traj[..., rej], ro.traj[..., rej])


def test_lti_other_sizes_raise_on_card(dev):
    """The hand-written LTI is built at ⟨10,2⟩ and ⟨10,3⟩; at another size
    the LTI's lane objects carry no descriptor, so K3, K1 (LoweredTiles)
    and K2 run the lowering, each bit-equal to its plain version; a
    hand-written descriptor at another size, and m above the ceiling
    plan.MAX_CONTROLS, raise instead of running the plain version."""
    from differentialdynamicprogramming_jl_tpu_torch.models import linear
    spec = linear.random_lti(1, n=4, m=2, T=T, device=dev)
    model, tiles = linear.lti_lanes(spec), linear.lti_derivs_tiles(spec)
    assert model.device is None and tiles.device is None
    rng = np.random.default_rng(1)
    f32 = dict(dtype=torch.float32, device=dev)
    x0 = torch.tensor(rng.standard_normal((4, B)), **f32)
    gains0 = torch.cat([torch.tensor(rng.standard_normal((T, 2, B)), **f32),
                        torch.zeros((T, 8, B), **f32)], dim=1)
    al = torch.ones((1, B), **f32)
    k, p = (f(torch.zeros((T, 7, B), **f32), gains0, x0, al, model=model,
              lims=LTI_LIMS, emit_traj=True)
            for f in (fk.forward_lanes, fk.forward_lanes_ref))
    assert torch.equal(k.traj, p.traj) and torch.equal(k.totals, p.totals)
    lam = torch.logspace(-6, 2, B, device=dev)
    kw = dict(n=4, m=2, reg_type=2, lims=LTI_LIMS, derivs_tiles=tiles,
              emit="gains")
    a, b = bk.backward_lanes(k.traj, lam, **kw), bk.backward_lanes_ref(
        k.traj, lam, **kw)
    _slots_close(a.out, b.out)
    sel = torch.stack([a.stats[0], a.stats[1], k.totals[0],
                       (torch.arange(B, device=dev) % 2).float()])
    k2, p2 = (f(k.traj, a.out, x0, sel, model=model, alphas=ALPHAS,
                reduce_ratio_min=0.0, lims=LTI_LIMS)
              for f in (fk.linesearch_lanes, fk.linesearch_lanes_ref))
    assert torch.equal(k2.ls[:2], p2.ls[:2])
    hand = fk.LanesModel(n=4, m=2, dynamics=model.dynamics, cost=model.cost,
                         device=linear.device_model(spec))
    with pytest.raises(NotImplementedError, match="no CUDA kernel"):
        fk.forward_lanes(k.traj, gains0, x0, al, model=hand, lims=LTI_LIMS)
    spec33 = linear.random_lti(1, n=4, m=33, T=T, device=dev)
    with pytest.raises(NotImplementedError, match="MAX_CONTROLS"):
        fk.forward_lanes(torch.zeros((T, 38, B), **f32),
                         torch.zeros((T, 165, B), **f32), x0, al,
                         model=linear.lti_lanes(spec33), lims=None)


def test_lti_solver_on_card_matches_cpu(dev):
    spec, model, tiles, _, _, _ = _lti(dev)
    x0s = torch.ones((16, 10), device=dev) * torch.linspace(
        0.5, 2.0, 16, device=dev)[:, None]
    u0s = spec.u0.expand(16, T, 2).contiguous()
    cfg = ILQGConfig(alphas=ALPHAS, reg_type=2, lam_max=1e15, max_iter=50)
    kw = dict(lims=LTI_LIMS, cfg=cfg, derivs_tiles=tiles)
    g = ilqg_batch_lanes(model, None, x0s, u0s, **kw)
    c = ilqg_batch_lanes(model, None, x0s.cpu(), u0s.cpu(), **kw)
    assert g.cost_total.device.type == "cuda"
    torch.testing.assert_close(g.cost_total.cpu(), c.cost_total, rtol=1e-4,
                               atol=0)
    assert torch.equal(g.reason.cpu(), c.reason)


# ---- the KL/GPS path on the LTI model ⟨10,2⟩: K1 in GPS mode with "policy"
#      emission, K4 at n=10, and the probe K5. No transcendentals: kernel and
#      plain version should agree bit for bit.


def _lti_gps_inputs(dev, per_step, seed=5):
    """A previous policy with every KL term non-zero (Σ⁻¹ positive
    definite) and η scalar or per step, zeros counting as 1."""
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((T, B, 2, 2))
    Si = np.einsum("tbij,tbkj->tbik", A, A) + 0.5 * np.eye(2)
    prev = np.concatenate([rng.standard_normal((T, 2, B)),
                           0.5 * rng.standard_normal((T, 20, B)),
                           np.moveaxis(Si.reshape(T, B, 4), 1, 2)], axis=1)
    eta = (10.0 ** rng.uniform(-1, 1, (T, B)) if per_step
           else np.full((T, B), 0.3))
    eta[::7, ::5] = 0.0
    return (torch.tensor(prev, dtype=torch.float32, device=dev),
            torch.tensor(eta, dtype=torch.float32, device=dev))


@pytest.mark.parametrize("per_step", [False, True])
@pytest.mark.parametrize("lims", [LTI_LIMS, None])
@pytest.mark.parametrize("emit", ["policy", "full", "gains"])
def test_lti_backward_kernel_gps_matches_plain(dev, per_step, lims, emit):
    _, model, tiles, x0, gains0, al = _lti(dev)
    traj = fk.forward_lanes(torch.zeros((T, 12, B), device=dev), gains0, x0,
                            al, model=model, lims=LTI_LIMS,
                            emit_traj=True).traj
    prev, eta = _lti_gps_inputs(dev, per_step)
    kw = dict(n=10, m=2, reg_type=1, lims=lims, derivs_tiles=tiles,
              prev=prev, eta=eta, emit=emit)
    lam = torch.zeros(B, device=dev)
    n0 = bk.backward_lanes.launches
    k = bk.backward_lanes(traj, lam, **kw)
    assert bk.backward_lanes.launches == n0 + 1
    p = bk.backward_lanes_ref(traj, lam, **kw)
    torch.testing.assert_close(k.out, p.out, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(k.stats[:2], p.stats[:2], rtol=1e-5,
                               atol=1e-5)
    assert torch.equal(k.stats[2:], p.stats[2:])
    assert k.out.shape == (T, bk.OutLayout(10, 2, emit).S, B)


def test_covariance_kernel_n10_is_bit_identical(dev):
    spec, _, _, _, _, _ = _lti(dev)
    rng = np.random.default_rng(6)
    F = (np.asarray(spec.A.cpu(), np.float64)[None, None]
         + 0.05 * rng.standard_normal((T, B, 10, 10)))
    fx = torch.tensor(np.moveaxis(F.reshape(T, B, 100), 1, 2),
                      dtype=torch.float32, device=dev).contiguous()
    r1 = tuple(tuple(1.0 + (i == j) + 0.01 * (i + j) for j in range(10))
               for i in range(10))
    n0 = ck.covariance_lanes.launches
    k = ck.covariance_lanes(fx, n=10, r1=r1)
    assert ck.covariance_lanes.launches == n0 + 1
    p = ck.covariance_lanes_ref(fx, n=10, r1=r1)
    assert torch.isfinite(k).all()
    assert torch.equal(k, p)


def _k4_fx(n, T, B, seed, offset=0, dev=None):
    """A (T, n², B) fx stream around 0.9·I from a numpy seed; with
    ``offset``, a view that many floats into a larger buffer."""
    rng = np.random.default_rng(seed)
    F = 0.9 * np.eye(n) + 0.1 * rng.standard_normal((T, B, n, n))
    a = torch.tensor(np.moveaxis(F.reshape(T, B, n * n), 1, 2),
                     dtype=torch.float32, device=dev)
    if not offset:
        return a.contiguous()
    buf = torch.zeros(a.numel() + offset, device=dev)
    v = buf[offset:].view(a.shape)
    v.copy_(a)
    return v


@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("T", ["1", "2", "tc+1"])
@pytest.mark.parametrize("B", [37, 4090])
@pytest.mark.parametrize("r1", ["identity", "spd"])
@pytest.mark.parametrize("n", [4, 6, 10])
def test_covariance_kernel_is_bit_identical(dev, n, r1, B, T, offset):
    """K4 at every instance against its plain version, bit for bit: B not a
    multiple of the block's 32 (and at 37 not of 4: 4-byte copies), T with
    no step, one step and one past a chunk, and a stream view a float off
    the 16-byte grid."""
    from differentialdynamicprogramming_jl_tpu_torch.ops.hopper import plan
    Tk = _ring_T(T, plan.covariance_plan(n, 10_000, B).tc)
    fx = _k4_fx(n, Tk, B, seed=n + Tk, offset=offset, dev=dev)
    r1v = (ck.identity_r1(n) if r1 == "identity" else
           tuple(tuple(1.0 + (i == j) + 0.01 * (i + j) for j in range(n))
                 for i in range(n)))
    n0 = ck.covariance_lanes.launches
    k = ck.covariance_lanes(fx, n=n, r1=r1v)
    assert ck.covariance_lanes.launches == n0 + 1
    assert torch.isfinite(k).all()
    assert torch.equal(k, ck.covariance_lanes_ref(fx, n=n, r1=r1v))


def test_covariance_kernel_propagates_nan_and_inf(dev):
    fx = _k4_fx(6, 9, 40, seed=3, dev=dev)
    fx[2, 5, 3], fx[4, 0, 7], fx[1, 1, 39] = (float("nan"), float("inf"),
                                              float("-inf"))
    k = ck.covariance_lanes(fx, n=6)
    p = ck.covariance_lanes_ref(fx, n=6, r1=ck.identity_r1(6))
    assert torch.isnan(k).any() and torch.isinf(k).any()
    assert torch.equal(torch.isnan(k), torch.isnan(p))
    assert torch.equal(k.nan_to_num(), p.nan_to_num())


@pytest.mark.parametrize("n", [3, 5])
def test_covariance_other_sizes_raise_on_card(dev, n):
    """K4 at an n the kernel library does not hold (4, 6, 10) is built at
    its first launch and is bit-equal to its plain version; beyond the
    largest n it takes (plan.COV_MAX_N) a CUDA tensor raises, naming the
    limit, instead of running the plain version."""
    from differentialdynamicprogramming_jl_tpu_torch.ops.hopper import plan
    fx = _k4_fx(n, 9, B, seed=n, dev=dev)
    n0 = ck.covariance_lanes.launches
    k = ck.covariance_lanes(fx, n=n)
    assert ck.covariance_lanes.launches == n0 + 1
    assert torch.equal(k, ck.covariance_lanes_ref(fx, n=n,
                                                  r1=ck.identity_r1(n)))
    big = plan.COV_MAX_N + 1
    with pytest.raises(NotImplementedError, match="COV_MAX_N"):
        ck.covariance_lanes(torch.zeros((2, big * big, 4), device=dev),
                            n=big)
    assert ck.covariance_lanes.launches == n0 + 1


@pytest.mark.parametrize("mode", ["copy", "light", "full"])
def test_probe_kernel_is_bit_identical(dev, mode):
    from differentialdynamicprogramming_jl_tpu_torch.ops.hopper import (
        probe_kernel as pk)
    x = torch.randn((T, 47, B), generator=torch.Generator().manual_seed(7)
                    ).to(dev)
    n0 = pk.probe_lanes.launches
    k = pk.probe_lanes(x, mode)
    assert pk.probe_lanes.launches == n0 + 1
    assert torch.equal(k, pk.probe_lanes_ref(x, mode))


def test_lti_kl_solve_on_card_matches_cpu(dev):
    """The KL solve on the LTI model through K1 (GPS, policy), K3 and K4 on
    the card against the plain versions on the CPU."""
    from differentialdynamicprogramming_jl_tpu_torch.models import linear
    spec, model, tiles, _, _, _ = _lti(dev)
    Bs = 16
    x0s = torch.ones((10, Bs), device=dev) * torch.linspace(
        0.5, 2.0, Bs, device=dev)
    u0 = spec.u0.expand(Bs, T, 2).contiguous()
    gains0 = torch.cat([to_streams(u0), torch.zeros((T, 20, Bs),
                                                    device=dev)], dim=1)
    ro = fk.forward_lanes(torch.zeros((T, 12, Bs), device=dev), gains0, x0s,
                          torch.ones((1, Bs), device=dev), model=model,
                          lims=None, emit_traj=True)
    x = from_streams(ro.traj[:, :10], (10,)).contiguous()
    prev = GaussianPolicy.zeros(T, 10, 2, device=dev)
    prev = GaussianPolicy(*(a.expand((Bs,) + a.shape).contiguous()
                            for a in prev))._replace(k=u0)
    fx = linear.SimpleLTVModel.from_lti(spec.A, spec.B, T).fx.expand(
        Bs, T, 10, 10).contiguous()
    cfg = ILQGKLConfig(kl_step=1.0, max_iter=6)
    counts = [f.launches for f in (bk.backward_lanes, fk.forward_lanes,
                                   ck.covariance_lanes)]
    g = ilqgkl_batch_lanes(model, tiles, x, prev, fx, ro.totals[0], cfg=cfg)
    assert all(f.launches > c for f, c in zip(
        (bk.backward_lanes, fk.forward_lanes, ck.covariance_lanes), counts))
    c = ilqgkl_batch_lanes(model, tiles, x.cpu(), GaussianPolicy(
        *(a.cpu() for a in prev)), fx.cpu(), ro.totals[0].cpu(), cfg=cfg)
    assert g.policy.K.shape == (Bs, T, 2, 10)
    for name in ("satisfied", "pd_failed", "n_iters"):
        assert torch.equal(getattr(g, name).cpu(), getattr(c, name)), name
    torch.testing.assert_close(g.cost_total.cpu(), c.cost_total, rtol=1e-4,
                               atol=0)
    torch.testing.assert_close(g.eta.cpu(), c.eta, rtol=1e-4, atol=0)


# ---------------------------------------------------------------------------
# the quadrotor ⟨6,2⟩ (K3, K2, K1 Autodiff<Quadrotor>) and K1
# Autodiff<PendCart>: derivatives made in the kernel by forward-mode
# autodiff. K1 is held per slot, by the error over the slot's largest
# magnitude, to 1e-5 on at least 99% of the elements: the thrust box (0, 5)
# meets the m=2 box QP's near-ties, where the two versions may pick
# candidates an ulp apart in objective (k then ~sqrt(ulp) apart).
# ---------------------------------------------------------------------------

def _quad(dev, seed=0):
    from differentialdynamicprogramming_jl_tpu_torch.models import quadrotor
    from differentialdynamicprogramming_jl_tpu_torch.ops.hopper import (
        autodiff_tiles)
    spec = quadrotor.QuadrotorSpec()
    model = quadrotor.quadrotor_lanes(spec)
    rng = np.random.default_rng(seed)
    x0 = torch.tensor(np.array([1.0, 0, 0, 0, 0.3, 0])[:, None]
                      + np.array([0.3, 0, 0.3, 0, 0.15, 0])[:, None]
                      * rng.standard_normal((6, B)), dtype=torch.float32,
                      device=dev)
    gains0 = torch.cat([torch.tensor(spec.u_hover + 1.5 * rng.standard_normal(
        (T, 2, B)), dtype=torch.float32, device=dev),
        torch.zeros((T, 12, B), device=dev)], dim=1)
    al = torch.tensor(rng.uniform(0, 1, (1, B)), dtype=torch.float32,
                      device=dev)
    traj = fk.forward_lanes(torch.zeros((T, 8, B), device=dev), gains0, x0,
                            al, model=model, lims=spec.lims,
                            emit_traj=True).traj
    return (spec, model, autodiff_tiles.autodiff_derivs_tiles(model), x0,
            gains0, al, traj)


def _slots_close(a, b, tol=1e-5, share=0.01):
    d = (a.double() - b.double()).abs()
    scale = b.double().abs().amax(dim=(0, 2), keepdim=True).clamp_min(1e-30)
    assert torch.isfinite(a).all()
    assert ((d / scale) > tol).double().mean().item() <= share


def test_quad_forward_kernel_matches_plain(dev):
    spec, model, _, x0, gains0, al, _ = _quad(dev)
    traj0 = torch.zeros((T, 8, B), device=dev)
    ladder = torch.tensor(ALPHAS, device=dev)[:, None].expand(6, B)
    for alphas, emit in ((ladder.contiguous(), False), (al, True)):
        n0 = fk.forward_lanes.launches
        k = fk.forward_lanes(traj0, gains0, x0, alphas, model=model,
                             lims=spec.lims, emit_traj=emit)
        assert fk.forward_lanes.launches == n0 + 1
        p = fk.forward_lanes_ref(traj0, gains0, x0, alphas, model=model,
                                 lims=spec.lims, emit_traj=emit)
        torch.testing.assert_close(k.totals, p.totals, rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(k.terminal, p.terminal, rtol=1e-5,
                                   atol=1e-5)
        if emit:
            torch.testing.assert_close(k.traj, p.traj, rtol=1e-5, atol=1e-5)
            assert (k.traj[:, 6:8] >= 0).all() and (k.traj[:, 6:8] <= 5).all()


@pytest.mark.parametrize("reg_type", [1, 2])
@pytest.mark.parametrize("emit", ["gains", "full"])
def test_quad_backward_kernel_matches_plain(dev, reg_type, emit):
    spec, _, tiles, _, _, _, traj = _quad(dev)
    lam = torch.logspace(-6, 2, B, device=dev)
    kw = dict(n=6, m=2, reg_type=reg_type, lims=spec.lims,
              derivs_tiles=tiles, emit=emit)
    n0 = bk.backward_lanes.launches
    k = bk.backward_lanes(traj, lam, **kw)
    assert bk.backward_lanes.launches == n0 + 1
    p = bk.backward_lanes_ref(traj, lam, **kw)
    _slots_close(k.out, p.out)
    torch.testing.assert_close(k.stats[:2], p.stats[:2], rtol=1e-4,
                               atol=1e-5)
    assert torch.equal(k.stats[2:], p.stats[2:])
    # the box QP puts k on a limit of each rotor on some steps
    u = traj[:-1, 6:8]
    on = (k.out[:-1, :2] == 0.0 - u) | (k.out[:-1, :2] == 5.0 - u)
    assert on[:, 0].any() and on[:, 1].any()


def test_quad_linesearch_kernel_matches_plain_and_retraces(dev):
    spec, model, tiles, x0, _, _, traj = _quad(dev)
    bo = bk.backward_lanes(traj, torch.ones(B, device=dev), n=6, m=2,
                           reg_type=2, lims=spec.lims, derivs_tiles=tiles,
                           emit="gains")
    tot = fk.forward_lanes(traj, torch.zeros((T, 14, B), device=dev), x0,
                           torch.zeros((1, B), device=dev), model=model,
                           lims=spec.lims).totals[0]
    allow = (torch.arange(B, device=dev) % 2 == 0).float()
    sel = torch.stack([bo.stats[0], bo.stats[1], tot, allow])
    kw = dict(model=model, alphas=ALPHAS, lims=spec.lims)
    k = fk.linesearch_lanes(traj, bo.out, x0, sel, **kw)
    p = fk.linesearch_lanes_ref(traj, bo.out, x0, sel, reduce_ratio_min=0.0,
                                **kw)
    torch.testing.assert_close(k.traj, p.traj, rtol=1e-5, atol=1e-5)
    assert torch.equal(k.ls[:2], p.ls[:2])
    rej = (k.ls[1] < 0.5) | (allow < 0.5)
    assert torch.equal(k.traj[..., rej], traj[..., rej])


@pytest.mark.parametrize("emit", ["gains", "full"])
def test_pendcart_autodiff_kernel_matches_analytic_and_plain(dev, emit):
    """K1 Autodiff<PendCart> against the analytic pendcart K1 on the same
    trajectory (the AD expansion is a few ulps from the hand-written one)
    and against its own plain version."""
    from differentialdynamicprogramming_jl_tpu_torch.ops.hopper import (
        autodiff_tiles)
    x0, gains0, al = _rollout(dev)
    model = tpc.pendcart_lanes(SPEC)
    traj = fk.forward_lanes(torch.zeros((T, 5, B), device=dev), gains0, x0,
                            al, model=model, lims=LIMS, emit_traj=True).traj
    lam = torch.logspace(-6, 2, B, device=dev)
    kw = dict(n=4, m=1, reg_type=2, lims=LIMS, emit=emit)
    ad = autodiff_tiles.autodiff_derivs_tiles(model)
    k = bk.backward_lanes(traj, lam, derivs_tiles=ad, **kw)
    a = bk.backward_lanes(traj, lam, derivs_tiles=tpc.pendcart_derivs_tiles(
        SPEC), **kw)
    p = bk.backward_lanes_ref(traj, lam, derivs_tiles=ad, **kw)
    _slots_close(k.out, a.out, tol=1e-4, share=0.0)
    _slots_close(k.out, p.out, share=0.0)
    assert torch.equal(k.stats[2:], a.stats[2:])
    assert torch.equal(k.stats[2:], p.stats[2:])


def test_autodiff_without_instance_raises_on_card(dev):
    """The LTI's autodiff tiles (with its descriptor) have no GPS "gains"
    instance, nor has the quadrotor "policy" emission without GPS mode:
    each raises, and nothing runs the plain version or an analytic
    instance in its place. The LTI's "gains" without GPS mode runs its
    Autodiff<LTI> instance."""
    from differentialdynamicprogramming_jl_tpu_torch.models import linear
    from differentialdynamicprogramming_jl_tpu_torch.ops.hopper import (
        autodiff_tiles)
    spec = linear.random_lti(0, n=10, m=2, T=T, device=dev)
    tiles = autodiff_tiles.autodiff_derivs_tiles(linear.lti_lanes(spec))
    traj = torch.zeros((T, 13, B), device=dev)
    gps = dict(prev=torch.zeros((T, 2 + 20 + 4, B), device=dev),
               eta=torch.ones((T, B), device=dev))
    n0 = bk.backward_lanes.launches
    with pytest.raises(NotImplementedError, match="emit='gains'"):
        bk.backward_lanes(traj, torch.ones(B, device=dev), n=10, m=2,
                          reg_type=2, lims=LTI_LIMS, derivs_tiles=tiles,
                          emit="gains", **gps)
    qspec, _, qtiles, _, _, _, qtraj = _quad(dev)
    with pytest.raises(NotImplementedError, match="policy"):
        bk.backward_lanes(qtraj, torch.ones(B, device=dev), n=6, m=2,
                          reg_type=2, lims=qspec.lims, derivs_tiles=qtiles,
                          emit="policy")
    assert bk.backward_lanes.launches == n0
    bk.backward_lanes(traj, torch.ones(B, device=dev), n=10, m=2,
                      reg_type=2, lims=LTI_LIMS, derivs_tiles=tiles)
    assert bk.backward_lanes.launches == n0 + 1


def _same_bits(a, b):
    """Equal bit for bit where finite, NaN where the other is NaN."""
    nan = torch.isnan(b)
    return (torch.equal(torch.isnan(a), nan)
            and torch.equal(a[~nan].view(torch.int32),
                            b[~nan].view(torch.int32)))


def _every_source(name, dev):
    """(tiles, n, m, limits, params rows or None, the modes) of one source
    of the new K1 instances: the modes the fleet entries launch, (emission,
    GPS mode)."""
    from differentialdynamicprogramming_jl_tpu_torch.models import (
        linear, quadrotor)
    from differentialdynamicprogramming_jl_tpu_torch.ops.hopper.autodiff_tiles \
        import autodiff_derivs_tiles
    from differentialdynamicprogramming_jl_tpu_torch.ops.hopper.forward_kernel \
        import LanesModel
    entries = (("gains", False), ("full", False), ("policy", True))
    so = name.endswith("_so")
    if name.startswith("lti"):
        m = int(name.split("_")[1])
        spec = linear.random_lti(0, n=10, m=m, T=T, device=dev)
        return (autodiff_derivs_tiles(linear.lti_lanes(spec),
                                      second_order=so), 10, m,
                ((-0.6, 0.6),) * m, None, entries)
    if name.startswith("param"):
        return (autodiff_derivs_tiles(tpc.pendcart_lanes_param(SPEC),
                                      second_order=so), 4, 1, LIMS,
                np.stack([np.linspace(0.3, 0.5, B),
                          np.linspace(0.5, 1.5, B)]), entries[:2])
    gps = (("policy", True),)
    if name == "quad_ad_so":
        qspec = quadrotor.QuadrotorSpec()
        return (autodiff_derivs_tiles(quadrotor.quadrotor_lanes(qspec),
                                      second_order=True), 6, 2, qspec.lims,
                None, gps)
    lanes = tpc.pendcart_lanes(SPEC)
    if name == "pendcart_so":
        tiles = tpc.pendcart_derivs_tiles_so(SPEC)
    elif name == "user_so":
        tiles = bk.DerivsTiles(fn=tpc.pendcart_derivs_tiles_so(SPEC).fn)
        gps = (("full", True), ("policy", True))
    elif name == "lowered_so":
        tiles = autodiff_derivs_tiles(LanesModel(
            n=4, m=1, dynamics=lanes.dynamics, cost=lanes.cost,
            terminal=lanes.terminal), second_order=True)
        gps = (("full", True), ("policy", True))
    else:
        tiles = autodiff_derivs_tiles(lanes, second_order=so)
    return tiles, 4, 1, LIMS, None, gps


EVERY_SOURCE = ("lti_2", "lti_3", "lti_2_so", "lti_3_so", "param",
                "param_so", "pendcart_ad", "pendcart_ad_so", "pendcart_so",
                "quad_ad_so", "lowered_so", "user_so")


@pytest.mark.parametrize("name", EVERY_SOURCE)
def test_every_source_instance_matches_plain(dev, name):
    """Each K1 instance of a public derivative source that the fleet
    entries reach (Autodiff<LTI> ⟨10,2⟩/⟨10,3⟩ first and second order,
    Autodiff<PendCartParam>, the GPS "policy" of the pendcart's autodiff
    and full-DDP sources and of Autodiff<Quadrotor, true>, and the lowered
    models' and a user's second-order tiles in GPS mode) equals the plain
    version on the same CUDA tensors bit for bit, out and stats, at T=9
    with a ragged B, limits that bind and η with zeros; one launch each."""
    tiles, n, m, lims, par, modes = _every_source(name, dev)
    Tn = 9
    rng = np.random.default_rng(len(name))
    x = rng.standard_normal((Tn, n, B))
    if n == 4:
        x[:, 0] += np.pi - 0.6
    if n == 6:
        x[:, 0] += 1.0
    u = (2.0 * rng.standard_normal((Tn, m, B))
         + (2.4525 if n == 6 else 0.0))
    traj = torch.tensor(np.concatenate([x, u, np.zeros((Tn, 1, B))], 1),
                        dtype=torch.float32, device=dev)
    lam = torch.tensor(10.0 ** rng.uniform(-4, 1, B), dtype=torch.float32,
                       device=dev)
    S = m + m * n + m * m
    prev = np.concatenate([rng.standard_normal((Tn, m, B)),
                           0.1 * rng.standard_normal((Tn, m * n, B)),
                           (2.0 * np.eye(m)).reshape(1, m * m, 1)
                           * np.ones((Tn, 1, B))], 1)
    eta = rng.uniform(0.5, 2.0, (Tn, B))
    eta[:, ::7] = 0.0
    gps_kw = dict(prev=torch.tensor(prev, dtype=torch.float32, device=dev),
                  eta=torch.tensor(eta, dtype=torch.float32, device=dev))
    assert gps_kw["prev"].shape[1] == S
    kw = {}
    if par is not None:
        kw["params"] = torch.tensor(par, dtype=torch.float32, device=dev)
    for emit, gps in modes:
        args = dict(n=n, m=m, reg_type=2, lims=lims, derivs_tiles=tiles,
                    emit=emit, **kw, **(gps_kw if gps else {}))
        n0 = bk.backward_lanes.launches
        k = bk.backward_lanes(traj, lam, **args)
        assert bk.backward_lanes.launches == n0 + 1
        p = bk.backward_lanes_ref(traj, lam, **args)
        assert _same_bits(k.out, p.out), (name, emit, gps)
        assert _same_bits(k.stats, p.stats), (name, emit, gps)
        assert torch.isfinite(k.out[:, :m]).all()


def test_quad_solver_on_card_matches_cpu(dev):
    spec, model, tiles, x0, _, _, _ = _quad(dev)
    Bs, Ts = 16, 12
    x0s = x0[:, :Bs].T.contiguous()
    u0s = torch.full((Bs, Ts, 2), spec.u_hover, device=dev)
    cfg = ILQGConfig(alphas=ALPHAS, reg_type=2, lam_max=1e15, max_iter=8)
    kw = dict(lims=spec.lims, cfg=cfg, derivs_tiles=tiles)
    g = ilqg_batch_lanes(model, None, x0s, u0s, **kw)
    c = ilqg_batch_lanes(model, None, x0s.cpu(), u0s.cpu(), **kw)
    assert g.cost_total.device.type == "cuda"
    torch.testing.assert_close(g.cost_total.cpu(), c.cost_total, rtol=1e-4,
                               atol=0)
    assert torch.equal(g.reason.cpu(), c.reason)
    assert torch.equal(g.n_accepted.cpu(), c.n_accepted)
    assert (g.u >= 0).all() and (g.u <= spec.u_max).all()


# ---------------------------------------------------------------------------
# heterogeneous fleets: per-scenario parameters and limits, K2 in place, and
# the MPC loop
# ---------------------------------------------------------------------------

def _hetero(dev, seed=3):
    """Per-scenario [l, d] (the ranges of tests/test_param_fleet.py) as a
    (2, B) stream, per-scenario limits ±U(0.8, 6.0) as (2, B), and a
    PendCartParam K3 rollout through them."""
    rng = np.random.default_rng(seed)
    par = torch.tensor(np.stack([rng.uniform(0.25, 0.55, B),
                                 rng.uniform(0.5, 1.5, B)]),
                       dtype=torch.float32, device=dev)
    hi = rng.uniform(0.8, 6.0, B)
    lanes = torch.tensor(np.stack([-hi, hi]), dtype=torch.float32,
                         device=dev)
    x0, gains0, al = _rollout(dev, seed)
    model = tpc.pendcart_lanes_param(SPEC)
    traj = fk.forward_lanes(torch.zeros((T, 5, B), device=dev), gains0, x0,
                            al, par, lanes, model=model, emit_traj=True).traj
    return par, lanes, x0, gains0, al, model, traj


def test_param_kernels_match_plain(dev):
    """PendCartParam K3, K1 (gains, full) and K2 with per-scenario [l, d]
    and limits against their plain versions; the limits are each lane's."""
    par, lanes, x0, gains0, al, model, traj = _hetero(dev)
    tiles = tpc.pendcart_derivs_tiles_param(SPEC)
    ladder = torch.tensor(ALPHAS, device=dev)[:, None].expand(6, B)
    for alphas, emit in ((ladder.contiguous(), False), (al, True)):
        kw = dict(model=model, emit_traj=emit)
        n0 = fk.forward_lanes.launches
        k = fk.forward_lanes(torch.zeros((T, 5, B), device=dev), gains0, x0,
                             alphas, par, lanes, **kw)
        assert fk.forward_lanes.launches == n0 + 1
        p = fk.forward_lanes_ref(torch.zeros((T, 5, B), device=dev), gains0,
                                 x0, alphas, par, lanes, lims=None, **kw)
        torch.testing.assert_close(k.totals, p.totals, rtol=1e-5, atol=1e-5)
        if emit:
            torch.testing.assert_close(k.traj, p.traj, rtol=1e-5, atol=1e-5)
            assert (k.traj[:, 4].abs() <= lanes[1]).all()
            assert (k.traj[:, 4].abs() == lanes[1]).any()
    lam = torch.linspace(0.0, 3.0, B, device=dev)
    for emit in ("gains", "full"):
        kw = dict(n=4, m=1, reg_type=2, lims=None, derivs_tiles=tiles,
                  params=par, lims_lanes=lanes, emit=emit)
        k = bk.backward_lanes(traj, lam, **kw)
        p = bk.backward_lanes_ref(traj, lam, **kw)
        torch.testing.assert_close(k.out, p.out, rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(k.stats[:2], p.stats[:2], rtol=1e-5,
                                   atol=1e-5)
        assert torch.equal(k.stats[2:], p.stats[2:])
    bo = bk.backward_lanes(traj, lam, n=4, m=1, reg_type=2, lims=None,
                           derivs_tiles=tiles, params=par, lims_lanes=lanes,
                           emit="gains")
    tot = fk.forward_lanes(torch.zeros((T, 5, B), device=dev), gains0, x0, al,
                           par, lanes, model=model).totals[0]
    allow = (torch.arange(B, device=dev) % 2 == 0).float()
    sel = torch.stack([bo.stats[0], bo.stats[1], tot, allow])
    kw = dict(model=model, alphas=ALPHAS, lims=None)
    k = fk.linesearch_lanes(traj, bo.out, x0, sel, par, lanes, **kw)
    p = fk.linesearch_lanes_ref(traj, bo.out, x0, sel, par, lanes,
                                reduce_ratio_min=0.0, **kw)
    torch.testing.assert_close(k.traj, p.traj, rtol=1e-5, atol=1e-5)
    assert torch.equal(k.ls[:2], p.ls[:2])
    rej = (k.ls[1] < 0.5) | (allow < 0.5)
    assert torch.equal(k.traj[..., rej], traj[..., rej])


def test_homogeneous_rows_are_bit_identical_to_static(dev):
    """Every params row the spec's (l, d), every lims_lanes row ±5: the
    PendCartParam instances and the per-scenario limits give the static
    pendcart instances' bits, in K3, K1 and K2."""
    x0, gains0, al = _rollout(dev)
    par = torch.tensor([[SPEC.l], [SPEC.d]], device=dev).expand(2, B)
    par = par.contiguous()
    lanes = torch.tensor([[-5.0], [5.0]], device=dev).expand(2, B)
    lanes = lanes.contiguous()
    fixed, param = tpc.pendcart_lanes(SPEC), tpc.pendcart_lanes_param(SPEC)
    z = torch.zeros((T, 5, B), device=dev)
    ref = fk.forward_lanes(z, gains0, x0, al, model=fixed, lims=LIMS,
                           emit_traj=True)
    for args, model in (((par, lanes), param), ((None, lanes), fixed),
                        ((par, None), param)):
        lims = None if args[1] is not None else LIMS
        out = fk.forward_lanes(z, gains0, x0, al, *args, model=model,
                               lims=lims, emit_traj=True)
        assert torch.equal(out.traj, ref.traj)
        assert torch.equal(out.totals, ref.totals)
    lam = torch.linspace(0.0, 3.0, B, device=dev)
    for emit in ("gains", "full"):
        r = bk.backward_lanes(ref.traj, lam, n=4, m=1, reg_type=2, lims=LIMS,
                              derivs_tiles=tpc.pendcart_derivs_tiles(SPEC),
                              emit=emit)
        o = bk.backward_lanes(ref.traj, lam, n=4, m=1, reg_type=2, lims=None,
                              derivs_tiles=tpc.pendcart_derivs_tiles_param(
                                  SPEC), params=par, lims_lanes=lanes,
                              emit=emit)
        assert torch.equal(o.out, r.out) and torch.equal(o.stats, r.stats)
    allow = (torch.arange(B, device=dev) % 2 == 0).float()
    sel = torch.stack([r.stats[0], r.stats[1], ref.totals[0], allow])
    g = r.out[:, :5].contiguous()
    a = fk.linesearch_lanes(ref.traj, g, x0, sel, model=fixed, alphas=ALPHAS,
                            lims=LIMS)
    b = fk.linesearch_lanes(ref.traj, g, x0, sel, par, lanes, model=param,
                            alphas=ALPHAS)
    assert torch.equal(a.traj, b.traj) and torch.equal(a.ls, b.ls)


@pytest.mark.parametrize("n_alphas", [6, 4])
@pytest.mark.parametrize("hetero", [False, True])
def test_linesearch_in_place_is_bit_equal_to_fresh(dev, hetero, n_alphas):
    """K2 in place (no __restrict__ on the aliased stream) writes the fresh
    launch's bits into the input stream and returns it, with the headline's
    6-α ladder and the MPC tier's 4-α one."""
    if hetero:
        par, lanes, x0, _, _, model, traj = _hetero(dev)
        tiles = tpc.pendcart_derivs_tiles_param(SPEC)
    else:
        x0, gains0, al = _rollout(dev)
        par = lanes = None
        model, tiles = tpc.pendcart_lanes(SPEC), tpc.pendcart_derivs_tiles(SPEC)
        traj = fk.forward_lanes(torch.zeros((T, 5, B), device=dev), gains0,
                                x0, al, model=model, lims=LIMS,
                                emit_traj=True).traj
    lims = None if hetero else LIMS
    bo = bk.backward_lanes(traj, torch.ones(B, device=dev), n=4, m=1,
                           reg_type=2, lims=lims, derivs_tiles=tiles,
                           params=par, lims_lanes=lanes, emit="gains")
    tot = traj[:, 5].sum(dim=0)
    sel = torch.stack([bo.stats[0], bo.stats[1], tot, torch.ones_like(tot)])
    alphas = ALPHAS if n_alphas == 6 else default_alphas(0.2, -3.0, 4)
    kw = dict(model=model, alphas=alphas, lims=lims)
    fresh = fk.linesearch_lanes(traj, bo.out, x0, sel, par, lanes, **kw)
    plain = fk.linesearch_lanes_ref(traj, bo.out, x0, sel, par, lanes,
                                    reduce_ratio_min=0.0, **kw)
    torch.testing.assert_close(fresh.traj, plain.traj, rtol=1e-5, atol=1e-5)
    assert torch.equal(fresh.ls[:2], plain.ls[:2])
    buf = traj.clone()
    n0 = fk.linesearch_lanes.launches
    inp = fk.linesearch_lanes(buf, bo.out, buf[0, :4], sel, par, lanes,
                              in_place=True, **kw)
    assert fk.linesearch_lanes.launches == n0 + 1
    assert inp.traj.data_ptr() == buf.data_ptr()
    assert torch.equal(buf, fresh.traj) and torch.equal(inp.ls, fresh.ls)
    assert not torch.equal(fresh.traj, traj)
    # a stream with more slots than [x, u, c] is never aliased (JAX :611)
    wide = torch.cat([traj, torch.zeros((T, 1, B), device=dev)], dim=1)
    out = fk.linesearch_lanes(wide, bo.out, x0, sel, par, lanes,
                              in_place=True, **kw)
    assert out.traj.data_ptr() != wide.data_ptr()
    assert torch.equal(out.traj, fresh.traj)


def test_lti_per_scenario_limits_match_plain_and_static(dev):
    """LTI ⟨10,2⟩ with a per-scenario box on each control: K1 (the m=2
    enumeration reading each lane's box), K3 and K2 against their plain
    versions; rows all ±0.6 give the static instances' bits."""
    _, model, tiles, x0, gains0, al = _lti(dev)
    rng = np.random.default_rng(5)
    lanes = torch.tensor(np.stack([-rng.uniform(0.3, 0.9, B),
                                   rng.uniform(0.3, 0.9, B),
                                   -rng.uniform(0.3, 0.9, B),
                                   rng.uniform(0.3, 0.9, B)]),
                         dtype=torch.float32, device=dev)
    z = torch.zeros((T, 12, B), device=dev)
    k = fk.forward_lanes(z, gains0, x0, al, None, lanes, model=model,
                         emit_traj=True)
    p = fk.forward_lanes_ref(z, gains0, x0, al, None, lanes, model=model,
                             lims=None, emit_traj=True)
    torch.testing.assert_close(k.traj, p.traj, rtol=1e-5, atol=1e-5)
    traj = k.traj
    lam = torch.logspace(-6, 2, B, device=dev)
    for emit in ("gains", "full"):
        kw = dict(n=10, m=2, reg_type=2, lims=None, derivs_tiles=tiles,
                  lims_lanes=lanes, emit=emit)
        kb = bk.backward_lanes(traj, lam, **kw)
        pb = bk.backward_lanes_ref(traj, lam, **kw)
        # the m=2 near-ties (module docstring of test_torch_lti_kernels):
        # at most 1% of the elements part by more than 1e-5
        far = ~torch.isclose(kb.out, pb.out, rtol=1e-5, atol=1e-5)
        assert far.float().mean() <= 0.01
        assert torch.equal(kb.stats[2:], pb.stats[2:])
    u = traj[:-1, 10:12]
    kk = kb.out[:-1, :2]
    on = (kk == lanes[0::2] - u) | (kk == lanes[1::2] - u)
    assert on[:, 0].any() and on[:, 1].any()
    sel = torch.stack([kb.stats[0], kb.stats[1], k.totals[0],
                       torch.ones(B, device=dev)])
    kl = fk.linesearch_lanes(traj, kb.out, x0, sel, None, lanes, model=model,
                             alphas=ALPHAS)
    pl = fk.linesearch_lanes_ref(traj, kb.out, x0, sel, None, lanes,
                                 model=model, alphas=ALPHAS,
                                 reduce_ratio_min=0.0, lims=None)
    torch.testing.assert_close(kl.traj, pl.traj, rtol=1e-5, atol=1e-5)
    # homogeneous rows ≡ static limits, bit for bit
    same = torch.tensor([[-0.6], [0.6], [-0.6], [0.6]],
                        device=dev).expand(4, B).contiguous()
    s = bk.backward_lanes(traj, lam, n=10, m=2, reg_type=2, lims=LTI_LIMS,
                          derivs_tiles=tiles, emit="full")
    o = bk.backward_lanes(traj, lam, n=10, m=2, reg_type=2, lims=None,
                          derivs_tiles=tiles, lims_lanes=same, emit="full")
    assert torch.equal(s.out, o.out) and torch.equal(s.stats, o.stats)


def test_mpc_rollout_on_card_matches_cpu(dev):
    """mpc_rollout_lanes (warm-started bounded re-solves, K2 fresh) on CUDA
    tensors against CPU tensors, and ilqg_iteration_lanes (K2 in place)."""
    from differentialdynamicprogramming_jl_tpu_torch.solvers.batch import (
        ilqg_iteration_lanes, mpc_rollout_lanes)
    x0, _, _ = _rollout(dev)
    Bs = 16
    x0s = x0.T.contiguous()[:Bs]
    rng = np.random.default_rng(9)
    u0s = torch.tensor(0.1 * rng.standard_normal((Bs, T, 1)),
                       dtype=torch.float32, device=dev)
    cfg = ILQGConfig(alphas=default_alphas(0.2, -3.0, 4), reg_type=2,
                     lam_max=1e15, max_iter=5, iter_cap=9)
    prob = tpc.make_pendcart_problem(SPEC, "euler", device=dev)
    model, tiles = tpc.pendcart_lanes(SPEC), tpc.pendcart_derivs_tiles(SPEC)
    lims = ((-10.0, 10.0),)
    g = mpc_rollout_lanes(model, None, x0s, u0s,
                          lambda x, u: prob.dynamics(x, u, 0), 3, lims=lims,
                          cfg=cfg, derivs_tiles=tiles)
    prob_c = tpc.make_pendcart_problem(SPEC, "euler", device="cpu")
    c = mpc_rollout_lanes(model, None, x0s.cpu(), u0s.cpu(),
                          lambda x, u: prob_c.dynamics(x, u, 0), 3,
                          lims=lims, cfg=cfg, derivs_tiles=tiles)
    assert g[2].shape == (3, Bs, 4) and g[4].shape == (3, Bs)
    torch.testing.assert_close(g[4].cpu(), c[4], rtol=1e-3, atol=0)
    torch.testing.assert_close(g[2].cpu(), c[2], rtol=1e-3, atol=1e-4)
    # the MPC step on the plan: K2 in place, fleet cost never rises
    step = ilqg_iteration_lanes(model, None, lims, cfg, derivs_tiles=tiles)
    gains = torch.cat([to_streams(g[1]), torch.zeros((T, 4, Bs), device=dev)],
                      dim=1)
    ro = fk.forward_lanes(torch.zeros((T, 5, Bs), device=dev), gains,
                          g[0].T.contiguous(), torch.ones((1, Bs), device=dev),
                          model=model, lims=lims, emit_traj=True)
    traj, tot = ro.traj, ro.totals[0]
    lam = torch.full((Bs,), cfg.lam, device=dev)
    for _ in range(3):
        ptr = traj.data_ptr()
        traj, tot_n, lam = step(traj, tot, lam)
        assert traj.data_ptr() == ptr
        assert (tot_n <= tot + 1e-4 * tot.abs()).all()
        tot = tot_n


# ---------------------------------------------------------------------------
# The ring-fed K1, K2, K3 and K5 (ops/hopper/plan.py, csrc/ring.cuh) at
# ragged shapes: B = 1 and 37 take the 4-byte copies and a partial last
# block, 200 the 16-byte ones; T = 2 is shorter than a chunk, 40 spans
# chunks, tc+1 is one step past the first chunk. Pendcart and PendCartParam
# K1/K2/K3 are bit-identical to their plain versions on the card, K2 in
# place to K2 fresh, and K5 to its plain version, everywhere.

RING_MODELS = ("pendcart", "param", "lti", "quad")
BIT_EXACT = ("pendcart", "param")


def _ring_T(T, tc):
    return tc + 1 if T == "tc+1" else int(T)


def _ring_case(name, dev, B, T, seed=11):
    """(model, tiles, lims, lanes, params, x0 (n, B), traj) of one instance,
    traj a K3 rollout of random controls."""
    from differentialdynamicprogramming_jl_tpu_torch.models import (
        linear, quadrotor)
    from differentialdynamicprogramming_jl_tpu_torch.ops.hopper import (
        autodiff_tiles)
    rng = np.random.default_rng(seed)
    f32 = dict(dtype=torch.float32, device=dev)
    par = lanes = None
    if name in ("pendcart", "param"):
        x0 = (np.array([np.pi - 0.6, 0, 0, 0])[:, None]
              + np.array([0.2, 0.2, 0, 0])[:, None]
              * rng.standard_normal((4, B)))
        u = 2.0 * rng.standard_normal((T, 1, B))
        if name == "param":
            model = tpc.pendcart_lanes_param(SPEC)
            tiles = tpc.pendcart_derivs_tiles_param(SPEC)
            par = torch.tensor(np.stack([rng.uniform(0.25, 0.55, B),
                                         rng.uniform(0.5, 1.5, B)]), **f32)
            hi = rng.uniform(0.8, 6.0, B)
            lanes = torch.tensor(np.stack([-hi, hi]), **f32)
            lims = None
        else:
            model, tiles = tpc.pendcart_lanes(SPEC), tpc.pendcart_derivs_tiles(
                SPEC)
            lims = LIMS
    elif name == "lti":
        spec = linear.random_lti(seed, n=10, m=2, T=T, device=dev)
        model, tiles = linear.lti_lanes(spec), linear.lti_derivs_tiles(spec)
        x0 = (np.linspace(0.5, 2.0, B)[None, :]
              + 0.3 * rng.standard_normal((10, B)))
        u = 2.0 * rng.standard_normal((T, 2, B))
        lims = LTI_LIMS
    else:
        spec = quadrotor.QuadrotorSpec()
        model = quadrotor.quadrotor_lanes(spec)
        tiles = autodiff_tiles.autodiff_derivs_tiles(model)
        x0 = (np.array([1.0, 0, 0, 0, 0.3, 0])[:, None]
              + np.array([0.3, 0, 0.3, 0, 0.15, 0])[:, None]
              * rng.standard_normal((6, B)))
        u = spec.u_hover + 1.5 * rng.standard_normal((T, 2, B))
        lims = spec.lims
    n, m = model.n, model.m
    x0 = torch.tensor(x0, **f32)
    gains0 = torch.cat([torch.tensor(u, **f32),
                        torch.zeros((T, m * n, B), device=dev)], dim=1)
    traj = fk.forward_lanes(torch.zeros((T, n + m, B), device=dev), gains0,
                            x0, torch.ones((1, B), device=dev), par, lanes,
                            model=model, lims=lims, emit_traj=True).traj
    return model, tiles, lims, lanes, par, x0, traj


def _ring_prev(n, m, T, B, dev, seed=12):
    """A previous policy with Σ⁻¹ positive definite and η with zeros."""
    rng = np.random.default_rng(seed)
    G = rng.standard_normal((T, B, m, m))
    Si = np.einsum("tbij,tbkj->tbik", G, G) + 0.5 * np.eye(m)
    prev = np.concatenate([rng.standard_normal((T, m, B)),
                           0.5 * rng.standard_normal((T, m * n, B)),
                           np.moveaxis(Si.reshape(T, B, m * m), 1, 2)],
                          axis=1)
    eta = 10.0 ** rng.uniform(-1, 1, (T, B))
    eta[::3, ::2] = 0.0
    return (torch.tensor(prev, dtype=torch.float32, device=dev),
            torch.tensor(eta, dtype=torch.float32, device=dev))


@pytest.mark.parametrize("T", ["2", "40", "tc+1"])
@pytest.mark.parametrize("B", [1, 37, 200])
@pytest.mark.parametrize("name", RING_MODELS)
def test_ring_kernels_match_plain_at_ragged_shapes(dev, name, B, T):
    from differentialdynamicprogramming_jl_tpu_torch.ops.hopper import plan
    model = _ring_case(name, dev, B, 2)[0]
    n, m = model.n, model.m
    # K1: gains and full; GPS policy where an instance has GPS mode
    for gps in (False, True) if name in ("pendcart", "lti") else (False,):
        Tk = _ring_T(T, plan.backward_plan(n, m, gps, "gains", 10_000,
                                           B).tc)
        _, tiles, lims, lanes, par, _, traj = _ring_case(name, dev, B, Tk)
        lam = torch.logspace(-3, 1, B, device=dev)
        prev, eta = _ring_prev(n, m, Tk, B, dev) if gps else (None, None)
        for emit in ("policy",) if gps else ("gains", "full"):
            kw = dict(n=n, m=m, reg_type=1 if gps else 2, lims=lims,
                      derivs_tiles=tiles, params=par, lims_lanes=lanes,
                      prev=prev, eta=eta, emit=emit)
            n0 = bk.backward_lanes.launches
            k = bk.backward_lanes(traj, lam, **kw)
            assert bk.backward_lanes.launches == n0 + 1
            p = bk.backward_lanes_ref(traj, lam, **kw)
            assert k.out.shape == (Tk, bk.OutLayout(n, m, emit).S, B)
            assert torch.equal(k.stats[2:], p.stats[2:])
            if name in BIT_EXACT and not gps:
                assert torch.equal(k.out, p.out)
                assert torch.equal(k.stats, p.stats)
            elif name == "quad":
                _slots_close(k.out, p.out)
            else:
                torch.testing.assert_close(k.out, p.out, rtol=1e-5,
                                           atol=1e-5)
                torch.testing.assert_close(k.stats[:2], p.stats[:2],
                                           rtol=1e-5, atol=1e-5)
    # K2: fresh against plain, in place against fresh
    for A in (1, 4, 6, 8):
        Tk = _ring_T(T, plan.linesearch_plan(n, m, A, 10_000, B).tc)
        _, tiles, lims, lanes, par, x0, traj = _ring_case(name, dev, B, Tk)
        bo = bk.backward_lanes(traj, torch.ones(B, device=dev), n=n, m=m,
                               reg_type=2, lims=lims, derivs_tiles=tiles,
                               params=par, lims_lanes=lanes, emit="gains")
        allow = (torch.arange(B, device=dev) % 3 != 1).float()
        sel = torch.stack([bo.stats[0], bo.stats[1], traj[:, -1].sum(0),
                           allow])
        kw = dict(model=model, alphas=default_alphas(0.2, -3.0, A),
                  reduce_ratio_min=0.0, lims=lims)
        n0 = fk.linesearch_lanes.launches
        fresh = fk.linesearch_lanes(traj, bo.out, x0, sel, par, lanes, **kw)
        assert fk.linesearch_lanes.launches == n0 + 1
        p = fk.linesearch_lanes_ref(traj, bo.out, x0, sel, par, lanes, **kw)
        assert torch.equal(fresh.ls[:2], p.ls[:2])
        if name in BIT_EXACT:
            assert torch.equal(fresh.traj, p.traj)
            assert torch.equal(fresh.ls, p.ls)
        else:
            torch.testing.assert_close(fresh.traj, p.traj, rtol=1e-5,
                                       atol=1e-5)
        buf = traj.clone()
        inp = fk.linesearch_lanes(buf, bo.out, buf[0, :n], sel, par, lanes,
                                  in_place=True, **kw)
        assert inp.traj.data_ptr() == buf.data_ptr()
        assert torch.equal(buf, fresh.traj) and torch.equal(inp.ls, fresh.ls)
    # K3: per-scenario α for A candidates beside its producer warps, with
    # and without the emitted stream
    for A in (1, 4, 6, 8):
        Tk = _ring_T(T, plan.forward_plan(n, m, A, 10_000, B).tc)
        _, tiles, lims, lanes, par, x0, traj = _ring_case(name, dev, B, Tk)
        gains = bk.backward_lanes(traj, torch.ones(B, device=dev), n=n, m=m,
                                  reg_type=2, lims=lims, derivs_tiles=tiles,
                                  params=par, lims_lanes=lanes,
                                  emit="gains").out
        rng = np.random.default_rng(13)
        alphas = torch.tensor(rng.uniform(0.0, 1.0, (A, B)),
                              dtype=torch.float32, device=dev)
        for emit in (False, True):
            kw = dict(model=model, lims=lims, emit_traj=emit)
            n0 = fk.forward_lanes.launches
            k = fk.forward_lanes(traj, gains, x0, alphas, par, lanes, **kw)
            assert fk.forward_lanes.launches == n0 + 1
            p = fk.forward_lanes_ref(traj, gains, x0, alphas, par, lanes,
                                     **kw)
            pairs = [(k.totals, p.totals), (k.terminal, p.terminal)] + (
                [(k.traj, p.traj)] if emit else [])
            for a, b in pairs:
                if name in BIT_EXACT:
                    assert torch.equal(a, b)
                else:
                    torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("T", ["1", "2", "tc+1"])
@pytest.mark.parametrize("B", [1, 37, 200])
@pytest.mark.parametrize("mode", ["copy", "light", "full"])
def test_probe_kernel_is_bit_identical_at_ragged_shapes(dev, mode, B, T):
    from differentialdynamicprogramming_jl_tpu_torch.ops.hopper import (
        plan, probe_kernel as pk)
    Tk = _ring_T(T, plan.probe_plan("light", 10_000, B).tc)
    x = torch.randn((Tk, pk.S_IN, B),
                    generator=torch.Generator().manual_seed(17)).to(dev)
    n0 = pk.probe_lanes.launches
    k = pk.probe_lanes(x, mode)
    assert pk.probe_lanes.launches == n0 + 1
    assert torch.equal(k, pk.probe_lanes_ref(x, mode))
    # a view whose rows start off the 16-byte grid takes the 4-byte copies
    xs = torch.randn((Tk * pk.S_IN * B + 1,),
                     generator=torch.Generator().manual_seed(18)).to(dev)
    xv = xs[1:].view(Tk, pk.S_IN, B)
    assert torch.equal(pk.probe_lanes(xv, mode), pk.probe_lanes_ref(xv, mode))


# ---- the generic tier on the card: plain PyTorch in f64, no kernel of the
#      port. Numpy inputs go to the card; the card's result is held against
#      the same call on CPU tensors.

def test_generic_numpy_inputs_land_on_the_card(dev):
    from differentialdynamicprogramming_jl_tpu_torch.models import (
        linear as tl)
    from differentialdynamicprogramming_jl_tpu_torch.ops.boxqp import boxqp
    from differentialdynamicprogramming_jl_tpu_torch.solvers.ilqg import ilqg
    spec = tl.random_lti(0, n=4, m=2, T=30, dtype=torch.float64,
                         device="cpu")
    prob = tl.make_lti_problem(tl.LTISpec(*(a.to(dev) for a in spec)), 30)
    res = ilqg(prob, spec.x0.numpy(), spec.u0.numpy(),
               cfg=ILQGConfig(max_iter=20))
    assert res.u.device.type == "cuda" and res.u.dtype == torch.float64
    qp = boxqp(np.eye(3), np.ones(3), -np.ones(3), np.ones(3), np.zeros(3))
    assert qp.x.device.type == "cuda"


def test_generic_ilqg_card_matches_cpu(dev):
    from differentialdynamicprogramming_jl_tpu_torch.models import (
        linear as tl)
    from differentialdynamicprogramming_jl_tpu_torch.solvers.ilqg import ilqg
    spec = tl.random_lti(0, n=4, m=2, T=40, dtype=torch.float64,
                         device="cpu")
    lims = torch.tensor([[-0.05, 0.05], [-0.03, 0.04]], dtype=torch.float64)
    out = {}
    for to in ("cpu", dev):
        sp = tl.LTISpec(*(a.to(to) for a in spec))
        for backward in ("scan", "parallel"):
            out[(str(to), backward)] = ilqg(
                tl.make_lti_problem(sp, 40), sp.x0, sp.u0,
                lims=lims.to(to) if backward == "scan" else None,
                cfg=ILQGConfig(max_iter=50, backward=backward))
    for backward in ("scan", "parallel"):
        c, g = out[("cpu", backward)], out[(str(dev), backward)]
        torch.testing.assert_close(g.cost.sum().cpu(), c.cost.sum(),
                                   rtol=1e-9, atol=0)
        assert int(g.reason) == int(c.reason)
        assert int(g.n_iters) == int(c.n_iters)


def test_generic_ilqg_kl_card_matches_cpu(dev):
    from differentialdynamicprogramming_jl_tpu_torch.models import (
        linear as tl)
    from differentialdynamicprogramming_jl_tpu_torch.ops.forward import (
        forward_pass)
    from differentialdynamicprogramming_jl_tpu_torch.solvers.ilqgkl import (
        ilqg_kl)
    spec = tl.random_lti(1, n=4, m=2, T=30, dtype=torch.float64,
                         device="cpu")
    out = {}
    for to in ("cpu", dev):
        sp = tl.LTISpec(*(a.to(to) for a in spec))
        prob = tl.make_lti_problem(sp, 30)
        ro = forward_pass(prob, sp.x0, sp.u0)
        traj = GaussianPolicy.zeros(30, 4, 2, torch.float64,
                                    device=to)._replace(k=ro.u)
        for per_step in (False, True):
            out[(str(to), per_step)] = ilqg_kl(
                prob, ro.x, traj, tl.SimpleLTVModel.from_lti(sp.A, sp.B, 30),
                ro.cost, cfg=ILQGKLConfig(kl_step=0.5, max_iter=10,
                                          constrain_per_step=per_step))
    for per_step in (False, True):
        c, g = out[("cpu", per_step)], out[(str(dev), per_step)]
        torch.testing.assert_close(g.cost.sum().cpu(), c.cost.sum(),
                                   rtol=1e-9, atol=0)
        assert int(g.n_iters) == int(c.n_iters)
        assert bool(g.satisfied) == bool(c.satisfied)


def test_generic_boxqp_card_matches_cpu(dev):
    from differentialdynamicprogramming_jl_tpu_torch.ops.boxqp import (
        boxqp, demo_qp)
    g, c = demo_qp(60, device=dev), demo_qp(60, device="cpu")
    assert int(g.result) == int(c.result) >= 1
    torch.testing.assert_close(g.value.cpu(), c.value, rtol=1e-9, atol=0)
    rng = np.random.default_rng(0)
    A = rng.standard_normal((8, 5, 5))
    args = [A @ np.swapaxes(A, -1, -2), rng.standard_normal((8, 5)),
            -0.3 * np.ones((8, 5)), 0.3 * np.ones((8, 5)), np.zeros((8, 5))]
    gb = boxqp(*(torch.tensor(a, device=dev) for a in args))
    cb = boxqp(*(torch.tensor(a) for a in args))
    assert torch.equal(gb.result.cpu(), cb.result)
    torch.testing.assert_close(gb.x.cpu(), cb.x, rtol=1e-9, atol=1e-12)


# ---- K1's packed-derivatives and second-order (full DDP) instances

def _packed_case(name, dev, Bc=B, Tc=T):
    """(n, m, lims, packed stream (Tc, D+m, Bc), trajectory) of a model on
    a rollout of its own: pendcart ⟨4,1⟩, quadrotor ⟨6,2⟩ (autodiff
    generator), LTI ⟨10,2⟩."""
    from differentialdynamicprogramming_jl_tpu_torch.models import (
        linear, quadrotor)
    from differentialdynamicprogramming_jl_tpu_torch.ops.hopper import (
        autodiff_tiles)
    rng = np.random.default_rng(5)
    if name == "pendcart":
        n, m, lims, model = 4, 1, LIMS, tpc.pendcart_lanes(SPEC)
        gen = tpc.pendcart_packed_derivs(SPEC)
        x0 = np.array([np.pi - 0.6, 0, 0, 0])[:, None] + np.array(
            [0.2, 0, 0, 0])[:, None] * rng.standard_normal((4, Bc))
        u0 = 2.0 * rng.standard_normal((Tc, 1, Bc))
    elif name == "quad":
        qs = quadrotor.QuadrotorSpec()
        n, m, lims, model = 6, 2, qs.lims, quadrotor.quadrotor_lanes(qs)
        gen = autodiff_tiles.autodiff_packed_derivs(model)
        x0 = np.array([1.0, 0, 0, 0, 0.3, 0])[:, None] + np.array(
            [0.3, 0, 0.3, 0, 0.15, 0])[:, None] * rng.standard_normal((6, Bc))
        u0 = qs.u_hover + 1.5 * rng.standard_normal((Tc, 2, Bc))
    else:
        spec = linear.random_lti(0, n=10, m=2, T=Tc, device=dev)
        n, m, lims, model = 10, 2, LTI_LIMS, linear.lti_lanes(spec)
        gen = linear.lti_packed_derivs(spec)
        x0 = np.linspace(0.5, 2.0, Bc)[None, :] + 0.3 * rng.standard_normal(
            (10, Bc))
        u0 = 2.0 * rng.standard_normal((Tc, 2, Bc))
    f = dict(dtype=torch.float32, device=dev)
    gains0 = torch.cat([torch.tensor(u0, **f),
                        torch.zeros((Tc, m * n, Bc), **f)], dim=1)
    al = torch.tensor(rng.uniform(0, 1, (1, Bc)), **f)
    traj = fk.forward_lanes(torch.zeros((Tc, n + m, Bc), **f), gains0,
                            torch.tensor(x0, **f), al, model=model,
                            lims=lims, emit_traj=True).traj
    return n, m, lims, gen(traj[:, :n], traj[:, n:n + m]), traj


@pytest.mark.parametrize("Bc,Tc", [(B, T), (37, 2), (1, 17)])
@pytest.mark.parametrize("emit", ["gains", "full"])
@pytest.mark.parametrize("name", ["pendcart", "quad", "lti"])
def test_packed_kernel_matches_plain(dev, name, emit, Bc, Tc):
    """K1 on the packed stream (Packed<N, M>) against its plain version, at
    ragged B and T (the ring's chunk edges), and the pendcart's against K1
    with in-kernel tiles on the same trajectory."""
    n, m, lims, dp, traj = _packed_case(name, dev, Bc, Tc)
    lam = torch.logspace(-6, 2, Bc, device=dev)
    kw = dict(n=n, m=m, reg_type=2, lims=lims, derivs_tiles=None, emit=emit)
    n0 = bk.backward_lanes.launches
    k = bk.backward_lanes(dp, lam, **kw)
    assert bk.backward_lanes.launches == n0 + 1
    p = bk.backward_lanes_ref(dp, lam, **kw)
    _slots_close(k.out, p.out, tol=1e-4 if emit == "full" else 1e-5)
    torch.testing.assert_close(k.stats[:2], p.stats[:2], rtol=1e-4,
                               atol=1e-5)
    assert torch.equal(k.stats[2:], p.stats[2:])
    if name == "pendcart":
        a = bk.backward_lanes(traj, lam, **dict(
            kw, derivs_tiles=tpc.pendcart_derivs_tiles(SPEC)))
        _slots_close(k.out, a.out, tol=1e-4 if emit == "full" else 1e-5,
                     share=0.0)


@pytest.mark.parametrize("lims", [None, LIMS])
def test_packed_gps_kernel_matches_plain(dev, lims):
    """Packed<4, 1> in GPS mode, "full" emission: backward_pass_pallas's
    GPS parity route."""
    n, m, _, dp, _ = _packed_case("pendcart", dev)
    rng = np.random.default_rng(3)
    prev = torch.tensor(np.concatenate([
        rng.standard_normal((T, 1, B)), 0.5 * rng.standard_normal((T, 4, B)),
        rng.uniform(0.5, 2.0, (T, 1, B))], axis=1), dtype=torch.float32,
        device=dev)
    eta = torch.tensor(10.0 ** rng.uniform(-0.3, 1, (T, B)),
                       dtype=torch.float32, device=dev)
    kw = dict(n=4, m=1, reg_type=1, lims=lims, derivs_tiles=None,
              emit="full", prev=prev, eta=eta)
    lam = torch.zeros(B, device=dev)
    k = bk.backward_lanes(dp, lam, **kw)
    p = bk.backward_lanes_ref(dp, lam, **kw)
    _slots_close(k.out, p.out, tol=1e-4)
    assert torch.equal(k.stats[2:], p.stats[2:])


@pytest.mark.parametrize("emit", ["gains", "full"])
@pytest.mark.parametrize("name", ["pendcart_so", "pendcart_ad_so", "quad_so"])
def test_second_order_kernel_matches_plain(dev, name, emit):
    """The full-DDP instances (PendCartSO, Autodiff<PendCart, true>,
    Autodiff<Quadrotor, true>) against their plain versions, and the
    pendcart's analytic and autodiff Hessians against each other."""
    from differentialdynamicprogramming_jl_tpu_torch.ops.hopper import (
        autodiff_tiles)
    lam = torch.logspace(-6, 2, B, device=dev)
    if name == "quad_so":
        spec, model, _, _, _, _, traj = _quad(dev)
        n, m, lims = 6, 2, spec.lims
        tiles = autodiff_tiles.autodiff_derivs_tiles(model, second_order=True)
    else:
        x0, gains0, al = _rollout(dev)
        model = tpc.pendcart_lanes(SPEC)
        traj = fk.forward_lanes(torch.zeros((T, 5, B), device=dev), gains0,
                                x0, al, model=model, lims=LIMS,
                                emit_traj=True).traj
        n, m, lims = 4, 1, LIMS
        tiles = (tpc.pendcart_derivs_tiles_so(SPEC) if name == "pendcart_so"
                 else autodiff_tiles.autodiff_derivs_tiles(
                     model, second_order=True))
    kw = dict(n=n, m=m, reg_type=2, lims=lims, derivs_tiles=tiles, emit=emit)
    k = bk.backward_lanes(traj, lam, **kw)
    p = bk.backward_lanes_ref(traj, lam, **kw)
    _slots_close(k.out, p.out, tol=1e-4 if emit == "full" else 1e-5)
    assert torch.equal(k.stats[2:], p.stats[2:])
    if name == "pendcart_ad_so":
        a = bk.backward_lanes(traj, lam, **dict(
            kw, derivs_tiles=tpc.pendcart_derivs_tiles_so(SPEC)))
        _slots_close(k.out, a.out, tol=1e-4, share=0.0)


def test_packed_and_second_order_without_instance_raise_on_card(dev):
    """Packed GPS at ⟨6,2⟩, the packed stream in policy emission and the
    second-order tiles in GPS mode have no instance: each raises
    NotImplementedError, and nothing runs in its place."""
    n, m, lims, dp, traj = _packed_case("quad", dev)
    n0 = bk.backward_lanes.launches
    gps = dict(prev=torch.zeros((T, m + m * n + m * m, B), device=dev),
               eta=torch.ones((T, B), device=dev))
    with pytest.raises(NotImplementedError, match="packed"):
        bk.backward_lanes(dp, torch.ones(B, device=dev), n=n, m=m,
                          reg_type=1, lims=lims, emit="full", **gps)
    with pytest.raises(NotImplementedError, match="packed"):
        bk.backward_lanes(dp, torch.ones(B, device=dev), n=n, m=m,
                          reg_type=1, lims=lims, emit="policy")
    x0, gains0, al = _rollout(dev)
    ptraj = fk.forward_lanes(torch.zeros((T, 5, B), device=dev), gains0, x0,
                             al, model=tpc.pendcart_lanes(SPEC), lims=LIMS,
                             emit_traj=True).traj
    with pytest.raises(NotImplementedError, match="second-order"):
        bk.backward_lanes(ptraj, torch.ones(B, device=dev), n=4, m=1,
                          reg_type=1, lims=LIMS, emit="policy",
                          derivs_tiles=tpc.pendcart_derivs_tiles_so(SPEC),
                          prev=torch.zeros((T, 6, B), device=dev),
                          eta=torch.ones((T, B), device=dev))
    assert bk.backward_lanes.launches == n0


@pytest.mark.parametrize("kind", ["packed", "second_order"])
def test_packed_and_full_ddp_solvers_on_card_match_cpu(dev, kind):
    """The fleet solve with pendcart_packed_derivs, and with
    pendcart_derivs_tiles_so, on the card against the same solve on CPU
    tensors, by outcome."""
    Bs, Ts = 32, 30
    rng = np.random.default_rng(2)
    x0 = torch.tensor(np.array([np.pi - 0.6, 0, 0, 0])[None, :]
                      + 0.1 * rng.standard_normal((Bs, 4)),
                      dtype=torch.float32)
    u0 = torch.zeros((Bs, Ts, 1))
    cfg = ILQGConfig(alphas=ALPHAS, reg_type=2, max_iter=8)
    model = tpc.pendcart_lanes(SPEC)
    kw = (dict(packed_derivs=tpc.pendcart_packed_derivs(SPEC))
          if kind == "packed"
          else dict(packed_derivs=None,
                    derivs_tiles=tpc.pendcart_derivs_tiles_so(SPEC)))
    pk = kw.pop("packed_derivs")
    g = ilqg_batch_lanes(model, pk, x0.to(dev), u0.to(dev), lims=LIMS,
                         cfg=cfg, **kw)
    c = ilqg_batch_lanes(model, pk, x0, u0, lims=LIMS, cfg=cfg, **kw)
    torch.testing.assert_close(g.cost_total.cpu(), c.cost_total, rtol=1e-3,
                               atol=1e-4)
    assert (g.reason.cpu() == c.reason).float().mean() >= 0.9


# ---------------------------------------------------------------------------
# LTI ⟨10,3⟩ (m > 2): K1 with the masked projected-Newton box QP and its
# warm start, the unrolled 3×3 Cholesky without limits and in GPS mode; K2
# and K3 at m=3. B = 37 takes the 4-byte copies and a partial block, 4090
# the 16-byte ones and a partial block; T = 2 is shorter than a chunk, tc+1
# one step past the first (K1 takes T ≥ 2; T = 1 is refused before any
# launch). No transcendentals: held to 1e-5, the latch exactly.

LTI3_BOX = ((-0.6, 0.6),) * 3


def _lti3(dev, B, T, seed=13, offset=0):
    """(model, tiles, x0 (10, B), traj) of the m=3 LTI fleet's spec: traj a
    K3 rollout of random controls, with ``offset`` a view that many floats
    into a larger buffer."""
    from differentialdynamicprogramming_jl_tpu_torch.models import linear
    spec = linear.random_lti(0, n=10, m=3, T=T, device=dev)
    model, tiles = linear.lti_lanes(spec), linear.lti_derivs_tiles(spec)
    rng = np.random.default_rng(seed)
    f32 = dict(dtype=torch.float32, device=dev)
    x0 = torch.tensor(np.linspace(0.5, 2.0, B)[None, :]
                      + 0.3 * rng.standard_normal((10, B)), **f32)
    gains0 = torch.cat([torch.tensor(2.0 * rng.standard_normal((T, 3, B)),
                                     **f32),
                        torch.zeros((T, 30, B), **f32)], dim=1)
    traj = fk.forward_lanes(torch.zeros((T, 13, B), **f32), gains0, x0,
                            torch.ones((1, B), **f32), model=model,
                            lims=LTI3_BOX, emit_traj=True).traj
    if offset:
        buf = torch.zeros(traj.numel() + offset, **f32)
        view = buf[offset:].view(traj.shape)
        view.copy_(traj)
        traj = view
    return model, tiles, x0, traj


@pytest.mark.parametrize("T", ["1", "2", "tc+1"])
@pytest.mark.parametrize("B", [37, 4090])
@pytest.mark.parametrize("lims", ["box", "none"])
@pytest.mark.parametrize("emit", ["gains", "full", "policy"])
@pytest.mark.parametrize("gps", [False, True])
def test_lti3_backward_kernel_matches_plain(dev, gps, emit, lims, B, T):
    from differentialdynamicprogramming_jl_tpu_torch.ops.hopper import plan
    box = LTI3_BOX if lims == "box" else None
    Tk = _ring_T(T, plan.backward_plan(10, 3, gps, emit, 10_000, B).tc)
    model, tiles, _, traj = _lti3(dev, B, Tk)
    lam = torch.logspace(-6, 2, B, device=dev)
    prev, eta = _ring_prev(10, 3, Tk, B, dev) if gps else (None, None)
    kw = dict(n=10, m=3, reg_type=1 if gps else 2, lims=box,
              derivs_tiles=tiles, prev=prev, eta=eta, emit=emit)
    n0 = bk.backward_lanes.launches
    if Tk < 2:
        with pytest.raises(ValueError):
            bk.backward_lanes(traj, lam, **kw)
        assert bk.backward_lanes.launches == n0
        return
    k = bk.backward_lanes(traj, lam, **kw)
    assert bk.backward_lanes.launches == n0 + 1
    p = bk.backward_lanes_ref(traj, lam, **kw)
    assert k.out.shape == (Tk, bk.OutLayout(10, 3, emit).S, B)
    assert torch.equal(k.stats[2:], p.stats[2:])
    torch.testing.assert_close(k.out, p.out, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(k.stats[:2], p.stats[:2], rtol=1e-5,
                               atol=1e-5)
    if box is not None and not gps:
        # the box QP puts k on a limit on some steps
        kk, u = k.out[:-1, :3], traj[:-1, 10:13]
        assert ((kk == -0.6 - u) | (kk == 0.6 - u)).any()


@pytest.mark.parametrize("qp_iters", [0, 1, 8])
def test_lti3_backward_kernel_qp_iters_offset_and_latch(dev, qp_iters):
    """The box QP's iteration count; a stream a float off the 16-byte grid
    (the 4-byte copies); R negative definite, so that lanes latch, with and
    without the box. Quu⁻¹ of an indefinite Quu goes through the 1e-30
    pivot guard to ±inf and NaN, in the same places in both versions."""
    from differentialdynamicprogramming_jl_tpu_torch.models import linear
    Bc, Tc = 200, 40
    _, tiles, _, traj = _lti3(dev, Bc, Tc, offset=1)
    assert traj.data_ptr() % 16 != 0
    lam = torch.logspace(-6, 2, Bc, device=dev)
    spec = linear.random_lti(0, n=10, m=3, T=Tc, device=dev)
    latch = linear.lti_derivs_tiles(spec._replace(R=-spec.R))
    for tl_, box in ((tiles, LTI3_BOX), (latch, LTI3_BOX), (latch, None)):
        kw = dict(n=10, m=3, reg_type=2, lims=box, derivs_tiles=tl_,
                  emit="full", qp_iters=qp_iters)
        k = bk.backward_lanes(traj, lam, **kw)
        p = bk.backward_lanes_ref(traj, lam, **kw)
        assert torch.equal(k.stats[2:], p.stats[2:])
        q = bk.OutLayout(10, 3, "full").quui
        torch.testing.assert_close(k.out[:, :q], p.out[:, :q], rtol=1e-4,
                                   atol=1e-5)
        torch.testing.assert_close(k.out[:, q:], p.out[:, q:], rtol=1e-3,
                                   atol=1e-5, equal_nan=True)
        if tl_ is latch:
            assert 0 < int((k.stats[2] > 0.5).sum()) < Bc


def test_lti3_kernels_propagate_nan(dev):
    Bc, Tc = 37, 12
    model, tiles, x0, traj = _lti3(dev, Bc, Tc)
    traj[5, 2, 3] = float("nan")
    traj[7, 11, 20] = float("nan")        # a control
    kw = dict(n=10, m=3, reg_type=2, lims=LTI3_BOX, derivs_tiles=tiles,
              emit="gains")
    lam = torch.ones(Bc, device=dev)
    k = bk.backward_lanes(traj, lam, **kw)
    p = bk.backward_lanes_ref(traj, lam, **kw)
    assert torch.isnan(p.out).any()
    assert torch.equal(torch.isnan(k.out), torch.isnan(p.out))
    assert torch.equal(k.stats[2:], p.stats[2:])
    torch.testing.assert_close(k.out.nan_to_num(), p.out.nan_to_num(),
                               rtol=1e-5, atol=1e-5)
    gains = k.out.nan_to_num()
    al = torch.ones((1, Bc), device=dev)
    x0n = x0.clone()
    x0n[4, 9] = float("nan")
    kf = fk.forward_lanes(traj, gains, x0n, al, model=model, lims=LTI3_BOX,
                          emit_traj=True)
    pf = fk.forward_lanes_ref(traj, gains, x0n, al, model=model,
                              lims=LTI3_BOX, emit_traj=True)
    assert torch.isnan(pf.traj).any()
    assert torch.equal(torch.isnan(kf.traj), torch.isnan(pf.traj))
    assert torch.equal(torch.isnan(kf.totals), torch.isnan(pf.totals))


@pytest.mark.parametrize("T", ["1", "2", "tc+1"])
@pytest.mark.parametrize("B", [37, 4090])
@pytest.mark.parametrize("lims", ["box", "none"])
def test_lti3_forward_and_linesearch_match_plain(dev, lims, B, T):
    from differentialdynamicprogramming_jl_tpu_torch.ops.hopper import plan
    box = LTI3_BOX if lims == "box" else None
    for A in (1, 6):
        Tk = _ring_T(T, plan.forward_plan(10, 3, A, 10_000, B).tc)
        model, tiles, x0, traj = _lti3(dev, B, max(Tk, 2))
        traj = traj[:Tk].contiguous()
        gains = bk.backward_lanes_ref(traj if Tk >= 2 else torch.cat(
            [traj, traj]), torch.ones(B, device=dev), n=10, m=3, reg_type=2,
            lims=LTI3_BOX, derivs_tiles=tiles, emit="gains").out[:Tk]
        gains = gains.contiguous()
        rng = np.random.default_rng(A)
        alphas = torch.tensor(rng.uniform(0.0, 1.0, (A, B)),
                              dtype=torch.float32, device=dev)
        for emit in (False, True):
            kw = dict(model=model, lims=box, emit_traj=emit)
            n0 = fk.forward_lanes.launches
            k = fk.forward_lanes(traj, gains, x0, alphas, **kw)
            assert fk.forward_lanes.launches == n0 + 1
            p = fk.forward_lanes_ref(traj, gains, x0, alphas, **kw)
            torch.testing.assert_close(k.totals, p.totals, rtol=1e-5,
                                       atol=1e-5)
            if emit:
                torch.testing.assert_close(k.traj, p.traj, rtol=1e-5,
                                           atol=1e-5)
        Tl = _ring_T(T, plan.linesearch_plan(10, 3, A, 10_000, B).tc)
        model, tiles, x0, traj = _lti3(dev, B, max(Tl, 2))
        traj = traj[:Tl].contiguous()
        bo = bk.backward_lanes_ref(traj if Tl >= 2 else torch.cat(
            [traj, traj]), torch.ones(B, device=dev), n=10, m=3, reg_type=2,
            lims=LTI3_BOX, derivs_tiles=tiles, emit="gains")
        gains = bo.out[:Tl].contiguous()
        allow = (torch.arange(B, device=dev) % 3 != 1).float()
        sel = torch.stack([bo.stats[0], bo.stats[1], traj[:, -1].sum(0),
                           allow])
        kw = dict(model=model, alphas=default_alphas(0.2, -3.0, A),
                  reduce_ratio_min=0.0, lims=box)
        n0 = fk.linesearch_lanes.launches
        fresh = fk.linesearch_lanes(traj, gains, x0, sel, **kw)
        assert fk.linesearch_lanes.launches == n0 + 1
        p = fk.linesearch_lanes_ref(traj, gains, x0, sel, **kw)
        assert torch.equal(fresh.ls[:2], p.ls[:2])
        torch.testing.assert_close(fresh.traj, p.traj, rtol=1e-5, atol=1e-5)
        buf = traj.clone()
        inp = fk.linesearch_lanes(buf, gains, buf[0, :10], sel,
                                  in_place=True, **kw)
        assert inp.traj.data_ptr() == buf.data_ptr()
        assert torch.equal(buf, fresh.traj) and torch.equal(inp.ls, fresh.ls)


def test_m_above_max_m_refused_on_card(dev):
    """m = 33 > plan.MAX_CONTROLS: the entries refuse it before anything is
    lowered, built or launched. The kernel library is built for m ≤ MAX_M
    = 4: its C launchers return ERR_ARGS (-2) for m = 5 rather than drop
    the controls past MAX_M (a larger m runs from a library generated for
    it); m = 4 at n = 10 (no instance) returns ERR_MODEL (-1)."""
    from differentialdynamicprogramming_jl_tpu_torch.models import linear
    from differentialdynamicprogramming_jl_tpu_torch.ops.hopper import (
        _build, plan)
    Tc, Bc = 4, 8
    spec = linear.random_lti(0, n=10, m=33, T=Tc, device=dev)
    # no descriptor at <10,33>: the tiles' launch refuses m before lowering
    with pytest.raises(NotImplementedError, match="MAX_CONTROLS"):
        bk.backward_lanes(torch.zeros((Tc, 44, Bc), device=dev),
                          torch.ones(Bc, device=dev), n=10, m=33, reg_type=1,
                          lims=((-1.0, 1.0),) * 33,
                          derivs_tiles=linear.lti_derivs_tiles(spec))
    lib = _build.library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    for m in (5, 4):
        n = 10
        dm = linear.device_model(linear.random_lti(0, n=n, m=m, T=Tc,
                                                   device=dev))
        traj = torch.zeros((Tc, n + m + 1, Bc), device=dev)
        gains = torch.zeros((Tc, m + m * n, Bc), device=dev)
        out = torch.zeros((Tc, n + m + 1, Bc), device=dev)
        x0 = torch.zeros((n, Bc), device=dev)
        tot = torch.zeros((1, Bc), device=dev)
        lim = fk.lims_host(((-1.0, 1.0),) * m, m)
        model = (lim.ctypes.data, None, None, 0, dm.model_id, n, m,
                 dm.consts.ctypes.data, dm.consts.size)
        p = plan.forward_plan(n, min(m, 3), 1, Tc, Bc, True)
        rc = lib.ddp_forward_lanes(
            traj.data_ptr(), n + m + 1, gains.data_ptr(), m + m * n, 0, m,
            x0.data_ptr(), tot.data_ptr(), 1, tot.data_ptr(), tot.data_ptr(),
            out.data_ptr(), Tc, Bc, *model, *p.launcher_args(), dev.index,
            stream)
        assert rc == (-2 if m == 5 else -1), rc
        lam = torch.ones(Bc, device=dev)
        S = bk.OutLayout(n, m, "gains").S
        bout = torch.zeros((Tc, S, Bc), device=dev)
        st = torch.zeros((4, Bc), device=dev)
        pb = plan.backward_plan(n, min(m, 3), False, "gains", Tc, Bc)
        rc = lib.ddp_backward_lanes(
            traj.data_ptr(), n + m + 1, lam.data_ptr(), None, None,
            bout.data_ptr(), S, st.data_ptr(), Tc, Bc, 0, 2, 1, *model,
            0, 0, 8, *pb.launcher_args(), dev.index, stream)
        assert rc == (-2 if m == 5 else -1), rc


# ---------------------------------------------------------------------------
# models written only in Python: lowered into libraries of their own
# (ops/hopper/lower.py, csrc/lowered.cuh)
# ---------------------------------------------------------------------------

def _wrap_diff(x, x_old):
    """Angle wrapping of the quadrotor's attitude θ (state 4)."""
    import math
    d = [x[i] - x_old[i] for i in range(6)]
    d[4] = torch.remainder(d[4] + math.pi, 2 * math.pi) - math.pi
    return d


def _bare(model, **kw):
    import dataclasses
    return dataclasses.replace(model, device=None, **kw)


def test_lowered_quadrotor_is_bit_equal_to_hand_written(dev):
    """The quadrotor with its descriptor removed runs K3, K2 and K1 (gains,
    full, GPS full and policy, second order) from its lowering: the same
    f32 operations as the hand-written Quadrotor / Autodiff<Quadrotor>
    instances, so the same bits."""
    from differentialdynamicprogramming_jl_tpu_torch.ops.hopper import (
        autodiff_tiles)
    spec, model, tiles, x0, gains0, al, traj = _quad(dev)
    low = _bare(model)
    ladder = torch.tensor(ALPHAS, device=dev)[:, None].expand(6, B)
    for alphas, emit in ((ladder.contiguous(), False), (al, True)):
        a, b = (fk.forward_lanes(torch.zeros((T, 8, B), device=dev), gains0,
                                 x0, alphas, model=m, lims=spec.lims,
                                 emit_traj=emit) for m in (model, low))
        assert torch.equal(a.totals, b.totals)
        assert emit is False or torch.equal(a.traj, b.traj)
    lam = torch.logspace(-6, 2, B, device=dev)
    kw = dict(n=6, m=2, reg_type=2, lims=spec.lims)
    gains = bk.backward_lanes(traj, lam, derivs_tiles=tiles, emit="gains",
                              **kw).out
    sel = torch.stack([torch.full((B,), -1.0, device=dev),
                       torch.full((B,), 0.5, device=dev),
                       torch.full((B,), 1e3, device=dev),
                       (torch.arange(B, device=dev) % 2).float()])
    a, b = (fk.linesearch_lanes(traj, gains, x0, sel, model=m,
                                alphas=ALPHAS, lims=spec.lims)
            for m in (model, low))
    assert torch.equal(a.traj, b.traj) and torch.equal(a.ls, b.ls)
    rng = np.random.default_rng(9)
    prev = torch.tensor(np.concatenate(
        [rng.standard_normal((T, 2, B)), 0.3 * rng.standard_normal(
            (T, 12, B)), np.tile(np.array([2.0, 0.3, 0.3, 1.5])[None, :,
                                                               None],
                                 (T, 1, B))], axis=1), dtype=torch.float32,
        device=dev)
    eta = torch.full((T, B), 3.0, device=dev)
    cases = [dict(emit="gains"), dict(emit="full"),
             dict(emit="full", prev=prev, eta=eta),
             dict(emit="policy", prev=prev, eta=eta)]
    for so in (False, True):
        pair = [autodiff_tiles.autodiff_derivs_tiles(m, second_order=so)
                for m in (model, low)]
        for case in cases if not so else cases[:2]:
            n0 = bk.backward_lanes.launches
            a, b = (bk.backward_lanes(traj, lam, derivs_tiles=t, **kw, **case)
                    for t in pair)
            assert bk.backward_lanes.launches == n0 + 2
            assert torch.equal(a.out, b.out) and torch.equal(a.stats,
                                                             b.stats), case


def test_lowered_models_match_plain(dev):
    """A lowered PendCartParam (params) in K3, K2 and K1 through autodiff,
    a lowered LTI <10,2> in K1 (Autodiff<Lowered>, gains and full), and the
    quadrotor with a diff in K3 and K2, each against its plain version."""
    from differentialdynamicprogramming_jl_tpu_torch.ops.hopper import (
        autodiff_tiles)
    x0, gains0, al = _rollout(dev)
    pm = _bare(tpc.pendcart_lanes_param(SPEC))
    rng = np.random.default_rng(4)
    par = torch.tensor(np.stack([rng.uniform(0.25, 0.55, B),
                                 rng.uniform(0.5, 1.5, B)]),
                       dtype=torch.float32, device=dev)
    k = fk.forward_lanes(torch.zeros((T, 5, B), device=dev), gains0, x0, al,
                         par, model=pm, lims=LIMS, emit_traj=True)
    p = fk.forward_lanes_ref(torch.zeros((T, 5, B), device=dev), gains0, x0,
                             al, par, model=pm, lims=LIMS, emit_traj=True)
    torch.testing.assert_close(k.traj, p.traj, rtol=1e-5, atol=1e-5)
    kw = dict(n=4, m=1, reg_type=2, lims=LIMS, params=par,
              derivs_tiles=autodiff_tiles.autodiff_derivs_tiles(pm))
    lam = torch.logspace(-6, 2, B, device=dev)
    for emit in ("gains", "full"):
        _slots_close(bk.backward_lanes(k.traj, lam, emit=emit, **kw).out,
                     bk.backward_lanes_ref(k.traj, lam, emit=emit, **kw).out,
                     share=0.0)
    spec, lm, _, lx0, lgains0, lal = _lti(dev)
    low = _bare(lm)
    ltraj = fk.forward_lanes(torch.zeros((T, 12, B), device=dev), lgains0,
                             lx0, lal, model=lm, lims=LTI_LIMS,
                             emit_traj=True).traj
    lkw = dict(n=10, m=2, reg_type=2, lims=LTI_LIMS,
               derivs_tiles=autodiff_tiles.autodiff_derivs_tiles(low))
    for emit in ("gains", "full"):
        _slots_close(bk.backward_lanes(ltraj, lam, emit=emit, **lkw).out,
                     bk.backward_lanes_ref(ltraj, lam, emit=emit, **lkw).out)
    qspec, qm, qtiles, qx0, qgains0, qal, qtraj = _quad(dev)
    dm = _bare(qm, diff=_wrap_diff)
    shifted = qtraj.clone()
    shifted[:, 4, ::2] += 2 * np.pi
    k = fk.forward_lanes(shifted, qgains0, qx0, qal, model=dm,
                         lims=qspec.lims, emit_traj=True)
    p = fk.forward_lanes_ref(shifted, qgains0, qx0, qal, model=dm,
                             lims=qspec.lims, emit_traj=True)
    torch.testing.assert_close(k.traj, p.traj, rtol=1e-5, atol=1e-5)


def test_lowered_without_instance_raises_on_card(dev):
    """A lowered model's K1 has no "gains" emission in GPS mode, and a
    hand-written descriptor with a diff is refused: each raises, and
    nothing launches in its place."""
    from differentialdynamicprogramming_jl_tpu_torch.ops.hopper import (
        autodiff_tiles)
    spec, model, _, x0, gains0, al, traj = _quad(dev)
    tiles = autodiff_tiles.autodiff_derivs_tiles(_bare(model))
    n0 = (bk.backward_lanes.launches, fk.forward_lanes.launches)
    with pytest.raises(NotImplementedError, match="lowered"):
        bk.backward_lanes(traj, torch.ones(B, device=dev), n=6, m=2,
                          reg_type=1, lims=spec.lims, derivs_tiles=tiles,
                          emit="gains",
                          prev=torch.zeros((T, 18, B), device=dev),
                          eta=torch.ones((T, B), device=dev))
    import dataclasses
    with pytest.raises(ValueError, match="diff"):
        fk.forward_lanes(traj, gains0, x0, al, lims=spec.lims,
                         model=dataclasses.replace(model, diff=_wrap_diff))
    assert (bk.backward_lanes.launches, fk.forward_lanes.launches) == n0


def _exotic():
    """A model with per-scenario params and tanh, exp and sqrt in its
    dynamics and cost (no hand-written descriptor)."""
    def dynamics(x, u, t, par):
        a, k = par
        return [x[0] + 0.1 * x[1],
                x[1] + 0.1 * (torch.tanh(u[0] * a) - k * torch.sin(x[0])),
                x[2] + 0.05 * torch.exp(-x[2] * x[2]) * u[0]]

    def cost(x, u, t, par):
        return (torch.sqrt(1.0 + x[0] * x[0] + x[2] * x[2]) + 0.5 * x[1]
                * x[1] + par[0] * u[0] * u[0])

    return fk.LanesModel(n=3, m=1, dynamics=dynamics, cost=cost, n_params=2)


def test_lowered_exotic_matches_plain(dev):
    """The tanh, exp and sqrt rules compiled for the card (the device's
    tanhf, expf and sqrtf in Dual and Jet passes): a lowered model with
    params in K3, K1 (gains and full) and K2, each against its plain
    version."""
    from differentialdynamicprogramming_jl_tpu_torch.ops.hopper import (
        autodiff_tiles)
    model = _exotic()
    rng = np.random.default_rng(8)
    f32 = dict(dtype=torch.float32, device=dev)
    x0 = torch.tensor(rng.standard_normal((3, B)), **f32)
    par = torch.tensor(np.stack([rng.uniform(0.5, 1.5, B),
                                 rng.uniform(0.5, 2.0, B)]), **f32)
    gains0 = torch.cat([torch.tensor(2.0 * rng.standard_normal((T, 1, B)),
                                     **f32),
                        torch.zeros((T, 3, B), device=dev)], dim=1)
    al = torch.tensor(rng.uniform(0, 1, (1, B)), **f32)
    traj0 = torch.zeros((T, 5, B), device=dev)
    k, p = (f(traj0, gains0, x0, al, par, model=model, lims=LIMS,
              emit_traj=True) for f in (fk.forward_lanes,
                                        fk.forward_lanes_ref))
    torch.testing.assert_close(k.traj, p.traj, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(k.totals, p.totals, rtol=1e-5, atol=1e-5)
    traj = k.traj
    lam = torch.logspace(-6, 2, B, device=dev)
    kw = dict(n=3, m=1, reg_type=2, lims=LIMS, params=par,
              derivs_tiles=autodiff_tiles.autodiff_derivs_tiles(model))
    for emit in ("gains", "full"):
        n0 = bk.backward_lanes.launches
        a = bk.backward_lanes(traj, lam, emit=emit, **kw)
        assert bk.backward_lanes.launches == n0 + 1
        b = bk.backward_lanes_ref(traj, lam, emit=emit, **kw)
        _slots_close(a.out, b.out)
        torch.testing.assert_close(a.stats[:2], b.stats[:2], rtol=1e-5,
                                   atol=1e-5)
        assert torch.equal(a.stats[2:], b.stats[2:])
    sel = torch.stack([a.stats[0], a.stats[1], k.totals[0],
                       (torch.arange(B, device=dev) % 2).float()])
    gains = bk.backward_lanes(traj, lam, emit="gains", **kw).out
    k2, p2 = (f(traj, gains, x0, sel, par, model=model, alphas=ALPHAS,
                reduce_ratio_min=0.0, lims=LIMS) for f in (fk.linesearch_lanes,
                                     fk.linesearch_lanes_ref))
    torch.testing.assert_close(k2.traj, p2.traj, rtol=1e-5, atol=1e-5)
    assert torch.equal(k2.ls[:2], p2.ls[:2])


# ---------------------------------------------------------------------------
# a user's derivative tiles lowered into K1 (LoweredTiles) and models that
# read t (ops/hopper/lower.py, csrc/lowered.cuh)
# ---------------------------------------------------------------------------

def _tracking():
    import os
    import sys
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..",
                                    "tools_torch"))
    import tracking
    return tracking


def _user(tiles, n_params=0):
    """A user's tiles: the function alone, no device descriptor."""
    return bk.DerivsTiles(fn=getattr(tiles, "fn", tiles), n_params=n_params)


def _lti_traj(dev, model, x0, gains0, al):
    return fk.forward_lanes(torch.zeros((T, 12, B), device=dev), gains0, x0,
                            al, model=model, lims=LTI_LIMS,
                            emit_traj=True).traj


@pytest.mark.parametrize("name", ["lti", "lti_gps", "track", "so", "param"])
def test_lowered_tiles_match_plain(dev, name):
    """Each LoweredTiles instance group against K1's plain version on the
    same CUDA tensors: the user's LTI tiles (gains, full; GPS full and
    policy, per-step η), the tracking LTI's tiles reading t, the
    pendcart's second-order tiles (full DDP) and the tiles with params.
    The LTI tiles are bit for bit the hand-written LTI K1, the second-order
    ones PendCartSO."""
    lam = torch.logspace(-6, 2, B, device=dev)
    if name in ("lti", "lti_gps", "track"):
        spec, model, tiles, x0, gains0, al = _lti(dev)
        traj = _lti_traj(dev, model, x0, gains0, al)
        if name == "track":
            _, fn = _tracking().lti_track(torch, fk.LanesModel, spec.A,
                                          spec.B, spec.Q, spec.R, 0.01)
            user, hand = _user(fn), None
        else:
            user, hand = _user(tiles), tiles
        kw = dict(n=10, m=2, reg_type=2, lims=LTI_LIMS)
        cases = [dict(emit="gains"), dict(emit="full")]
        if name == "lti_gps":
            prev, eta = _lti_gps_inputs(dev, True)
            kw = dict(n=10, m=2, reg_type=1, lims=None)
            cases = [dict(emit=e, prev=prev, eta=eta)
                     for e in ("full", "policy")]
            lam = torch.zeros(B, device=dev)
    else:
        x0, gains0, al = _rollout(dev)
        rng = np.random.default_rng(6)
        par = torch.tensor(np.stack([rng.uniform(0.25, 0.55, B),
                                     rng.uniform(0.5, 1.5, B)]),
                           dtype=torch.float32, device=dev)
        model = (tpc.pendcart_lanes_param(SPEC) if name == "param"
                 else tpc.pendcart_lanes(SPEC))
        traj = fk.forward_lanes(torch.zeros((T, 5, B), device=dev), gains0,
                                x0, al, *((par,) if name == "param" else ()),
                                model=model, lims=LIMS, emit_traj=True).traj
        if name == "so":
            hand = tpc.pendcart_derivs_tiles_so(SPEC)
            user = _user(hand)
        else:
            hand = None
            user = _user(tpc.pendcart_derivs_tiles_param(SPEC), 2)
        kw = dict(n=4, m=1, reg_type=2, lims=LIMS,
                  **(dict(params=par) if name == "param" else {}))
        cases = [dict(emit="gains"), dict(emit="full")]
    for case in cases:
        n0 = bk.backward_lanes.launches
        a = bk.backward_lanes(traj, lam, derivs_tiles=user, **kw, **case)
        assert bk.backward_lanes.launches == n0 + 1
        b = bk.backward_lanes_ref(traj, lam, derivs_tiles=user, **kw, **case)
        _slots_close(a.out, b.out)
        torch.testing.assert_close(a.stats[:2], b.stats[:2], rtol=1e-5,
                                   atol=1e-5)
        assert torch.equal(a.stats[2:], b.stats[2:])
        if hand is not None:
            h = bk.backward_lanes(traj, lam, derivs_tiles=hand, **kw, **case)
            assert torch.equal(a.out, h.out) and torch.equal(a.stats,
                                                             h.stats), case


def test_time_varying_models_match_plain(dev):
    """Models that read t: the tracking LTI's lowered K3 and K2, and the
    tracking quadrotor's K3 and K1 Autodiff<Lowered> (gains, full), each
    against its plain version; the lowered LTI (no t) is bit for bit the
    hand-written LTI in K3 and K2."""
    from differentialdynamicprogramming_jl_tpu_torch.models import quadrotor
    from differentialdynamicprogramming_jl_tpu_torch.ops.hopper import (
        autodiff_tiles)
    tr = _tracking()
    spec, model, tiles, x0, gains0, al = _lti(dev)
    track, _ = tr.lti_track(torch, fk.LanesModel, spec.A, spec.B, spec.Q,
                            spec.R, 0.01)
    traj0 = torch.zeros((T, 12, B), device=dev)
    for m_ in (track, _bare(model)):
        k, p = (f(traj0, gains0, x0, al, model=m_, lims=LTI_LIMS,
                  emit_traj=True) for f in (fk.forward_lanes,
                                            fk.forward_lanes_ref))
        torch.testing.assert_close(k.traj, p.traj, rtol=1e-5, atol=1e-5)
    h = fk.forward_lanes(traj0, gains0, x0, al, model=model, lims=LTI_LIMS,
                         emit_traj=True)
    low = fk.forward_lanes(traj0, gains0, x0, al, model=_bare(model),
                           lims=LTI_LIMS, emit_traj=True)
    assert torch.equal(low.traj, h.traj) and torch.equal(low.totals,
                                                         h.totals)
    traj = h.traj
    lam = torch.logspace(-6, 2, B, device=dev)
    g = bk.backward_lanes(traj, lam, n=10, m=2, reg_type=2, lims=LTI_LIMS,
                          derivs_tiles=tiles, emit="gains").out
    sel = torch.stack([torch.full((B,), -1.0, device=dev),
                       torch.full((B,), 0.5, device=dev),
                       torch.full((B,), 1e3, device=dev),
                       (torch.arange(B, device=dev) % 2).float()])
    for m_ in (track, _bare(model)):
        k2, p2 = (f(traj, g, x0, sel, model=m_, alphas=ALPHAS,
                    reduce_ratio_min=0.0, lims=LTI_LIMS)
                  for f in (fk.linesearch_lanes, fk.linesearch_lanes_ref))
        torch.testing.assert_close(k2.traj, p2.traj, rtol=1e-5, atol=1e-5)
        assert torch.equal(k2.ls[:2], p2.ls[:2])
    k2h = fk.linesearch_lanes(traj, g, x0, sel, model=model, alphas=ALPHAS,
                              reduce_ratio_min=0.0, lims=LTI_LIMS)
    assert torch.equal(k2.traj, k2h.traj) and torch.equal(k2.ls, k2h.ls)
    qspec = quadrotor.QuadrotorSpec()
    qm = tr.quad_track(torch, fk.LanesModel, qspec)
    _, _, _, qx0, qgains0, qal, _ = _quad(dev)
    k, p = (f(torch.zeros((T, 8, B), device=dev), qgains0, qx0, qal,
              model=qm, lims=qspec.lims, emit_traj=True)
            for f in (fk.forward_lanes, fk.forward_lanes_ref))
    torch.testing.assert_close(k.traj, p.traj, rtol=1e-5, atol=1e-5)
    kw = dict(n=6, m=2, reg_type=2, lims=qspec.lims,
              derivs_tiles=autodiff_tiles.autodiff_derivs_tiles(qm))
    for emit in ("gains", "full"):
        a = bk.backward_lanes(k.traj, lam, emit=emit, **kw)
        b = bk.backward_lanes_ref(k.traj, lam, emit=emit, **kw)
        _slots_close(a.out, b.out)
        assert torch.equal(a.stats[2:], b.stats[2:])


def test_lowered_tiles_without_instance_raise_on_card(dev):
    """A user's first-order tiles have no GPS "gains" instance, and
    second-order tiles none in GPS mode: each raises naming the table, and
    nothing launches in its place."""
    x0, gains0, al = _rollout(dev)
    traj = fk.forward_lanes(torch.zeros((T, 5, B), device=dev), gains0, x0,
                            al, model=tpc.pendcart_lanes(SPEC), lims=LIMS,
                            emit_traj=True).traj
    gps = dict(prev=torch.zeros((T, 6, B), device=dev),
               eta=torch.ones((T, B), device=dev))
    n0 = bk.backward_lanes.launches
    for tiles, emit in ((tpc.pendcart_derivs_tiles(SPEC), "gains"),
                        (tpc.pendcart_derivs_tiles_so(SPEC), "full")):
        with pytest.raises(NotImplementedError, match="user's lowered tiles"):
            bk.backward_lanes(traj, torch.zeros(B, device=dev), n=4, m=1,
                              reg_type=1, lims=LIMS,
                              derivs_tiles=_user(tiles), emit=emit, **gps)
    assert bk.backward_lanes.launches == n0


def test_tiles_lti_solve_is_the_hand_written_on_card(dev):
    """The LTI fleet with a Python-only model (K2, K3 Lowered) and the
    user's tiles (K1 LoweredTiles) against the hand-written solve on the
    card, bit for bit."""
    spec, model, tiles, x0, gains0, al = _lti(dev)
    cfg = ILQGConfig(alphas=ALPHAS, reg_type=2, lam_max=1e15, max_iter=10)
    u0 = spec.u0[None].expand(B, T, 2).contiguous()
    a, b = (ilqg_batch_lanes(m_, None, x0.T.contiguous(), u0, lims=LTI_LIMS,
                             cfg=cfg, derivs_tiles=t_)
            for m_, t_ in ((_bare(model), _user(tiles)), (model, tiles)))
    for f in ("cost_total", "reason", "n_accepted", "u"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    assert torch.equal(a.policy.K, b.policy.K)


@pytest.mark.parametrize("B", [37, 200])
@pytest.mark.parametrize("name", RING_MODELS)
def test_ring_kernels_past_eight_candidates(dev, name, B):
    """K2 and K3 with ladders longer than a block's candidate warps (A =
    9, 11, 16, 40): K2 in ⌈A/8⌉ rounds of one launch, K3 in ⌈A/8⌉
    launches; against their plain versions (bit for bit on the pendcart
    instances; K2's decisions bit for bit the accept rule on K3's totals,
    its stream the plain re-roll at its α elsewhere), K2 in place ≡ fresh.
    On every other lane k is negated (an ascent direction, so the smaller α
    of later rounds roll lower totals), and the old total cost is the
    lowest of the first round's totals (dV = [-1, 0], so a candidate passes
    where its total is lower): every accepted α comes from a later round.
    A 65-α ladder is refused."""
    from differentialdynamicprogramming_jl_tpu_torch.ops.hopper import plan
    model = _ring_case(name, dev, B, 2)[0]
    n, m = model.n, model.m
    late = 0
    for A in (9, 11, 16, 40):
        Tk = _ring_T("tc+1", plan.linesearch_plan(n, m, A, 10_000, B).tc)
        _, tiles, lims, lanes, par, x0, traj = _ring_case(name, dev, B, Tk)
        bo = bk.backward_lanes(traj, torch.ones(B, device=dev), n=n, m=m,
                               reg_type=2, lims=lims, derivs_tiles=tiles,
                               params=par, lims_lanes=lanes, emit="gains")
        allow = (torch.arange(B, device=dev) % 3 != 1).float()
        bo.out[:, :m, 1::2] *= -1.0
        alphas = default_alphas(0.2, -3.0, A)
        lad = torch.tensor(alphas, device=dev)[:, None].expand(A, B)
        # the kernel's candidate totals: K2's pass 1 rolls each candidate
        # with K3's operations, so the same bits
        ktot = fk.forward_lanes(traj, bo.out, x0, lad.contiguous(), par,
                                lanes, model=model, lims=lims).totals
        sel = torch.stack([-torch.ones(B, device=dev),
                           torch.zeros(B, device=dev), ktot[:8].amin(0),
                           allow])
        kw = dict(model=model, alphas=alphas, reduce_ratio_min=0.0,
                  lims=lims)
        n0 = fk.linesearch_lanes.launches
        fresh = fk.linesearch_lanes(traj, bo.out, x0, sel, par, lanes, **kw)
        assert fk.linesearch_lanes.launches == n0 + 1
        al_sel, found, dc, rt, al_eff = fk._accept(ktot, sel, alphas, 0.0)
        assert torch.equal(fresh.ls[:4], torch.stack([al_sel, found.float(),
                                                      dc, rt]))
        if name in BIT_EXACT:
            p = fk.linesearch_lanes_ref(traj, bo.out, x0, sel, par, lanes,
                                        **kw)
            assert torch.equal(fresh.traj, p.traj)
            assert torch.equal(fresh.ls, p.ls)
        else:
            # the plain re-roll at the kernel's α (near ties of the old
            # total may decide apart between the two versions)
            p = fk.forward_lanes_ref(traj, bo.out, x0, al_eff[None], par,
                                     lanes, model=model, lims=lims,
                                     emit_traj=True)
            torch.testing.assert_close(fresh.traj, p.traj, rtol=1e-5,
                                       atol=1e-5)
        taken = fresh.ls[1] > 0.5
        late += int(taken.sum())
        assert bool((fresh.ls[0][taken] < np.float32(alphas[7])).all())
        buf = traj.clone()
        inp = fk.linesearch_lanes(buf, bo.out, buf[0, :n], sel, par, lanes,
                                  in_place=True, **kw)
        assert torch.equal(buf, fresh.traj) and torch.equal(inp.ls, fresh.ls)
        al = torch.tensor(np.random.default_rng(A).uniform(0.0, 1.0, (A, B)),
                          dtype=torch.float32, device=dev)
        for emit in (False, True):
            n0 = fk.forward_lanes.launches
            k = fk.forward_lanes(traj, bo.out, x0, al, par, lanes,
                                 model=model, lims=lims, emit_traj=emit)
            assert fk.forward_lanes.launches == n0 + -(-A // 8)
            q = fk.forward_lanes_ref(traj, bo.out, x0, al, par, lanes,
                                     model=model, lims=lims, emit_traj=emit)
            pairs = [(k.totals, q.totals), (k.terminal, q.terminal)] + (
                [(k.traj, q.traj)] if emit else [])
            for a, b in pairs:
                if name in BIT_EXACT:
                    assert torch.equal(a, b)
                else:
                    torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
    assert late > 0, "no lane took a candidate past the first round"
    with pytest.raises(ValueError, match="65 alphas"):
        fk.linesearch_lanes(traj, bo.out, x0, sel, par, lanes, model=model,
                            alphas=default_alphas(0.2, -3.0, 65), lims=lims)


def test_default_ladder_solve_on_card_matches_cpu(dev):
    """ILQGConfig()'s 11-α ladder (K3's sweep in two launches, K2 in two
    rounds) through the fleet solver on the card against CPU tensors, as
    test_solver_on_card_matches_cpu holds the 6-α ladder's."""
    x0, _, _ = _rollout(dev)
    x0s = x0.T.contiguous()[:16]
    u0s = torch.zeros((16, T, 1), device=dev)
    cfg = ILQGConfig(reg_type=2, lam_max=1e15)
    assert len(cfg.alphas) == 11
    kw = dict(lims=LIMS, cfg=cfg, max_steps=8,
              derivs_tiles=tpc.pendcart_derivs_tiles(SPEC))
    n0 = fk.forward_lanes.launches
    g = ilqg_batch_lanes(tpc.pendcart_lanes(SPEC), None, x0s, u0s, **kw)
    assert fk.forward_lanes.launches - n0 >= 2     # the sweep: 8 and 3
    c = ilqg_batch_lanes(tpc.pendcart_lanes(SPEC), None, x0s.cpu(),
                         u0s.cpu(), **kw)
    torch.testing.assert_close(g.cost_total.cpu(), c.cost_total, rtol=1e-4,
                               atol=0)
    # near the cost exit's f32 noise floor an ulp decides between 2
    # (converged) and 0 (still running at max_steps); other exits agree
    assert torch.equal(torch.where(g.reason.cpu() == 2, 0, g.reason.cpu()),
                       torch.where(c.reason == 2, 0, c.reason))


def test_aot_lane_tier_roundtrip_on_card(dev):
    """A lane-tier solve exported and served on the card: the same bits,
    a BatchILQGResult; a wrong B refused."""
    from differentialdynamicprogramming_jl_tpu_torch.solvers.batch import (
        BatchILQGResult)
    from differentialdynamicprogramming_jl_tpu_torch.utils.aot import (
        deserialize_solver, serialize_solver)
    x0, _, _ = _rollout(dev)
    cfg = ILQGConfig(alphas=ALPHAS, reg_type=2, lam_max=1e15, max_iter=5)
    model, tiles = tpc.pendcart_lanes(SPEC), tpc.pendcart_derivs_tiles(SPEC)

    def solve(x0s, u0s):
        return ilqg_batch_lanes(model, None, x0s, u0s, lims=LIMS, cfg=cfg,
                                derivs_tiles=tiles)

    x0s, u0s = x0.T.contiguous(), torch.zeros((B, T, 1), device=dev)
    direct = solve(x0s, u0s)
    blob = serialize_solver(solve, x0s, u0s)
    serve = deserialize_solver(blob)
    served = serve(x0s, u0s)
    assert isinstance(served, BatchILQGResult)
    for f in ("cost_total", "reason", "n_accepted", "u", "x"):
        assert torch.equal(getattr(direct, f), getattr(served, f)), f
    assert torch.equal(direct.policy.K, served.policy.K)
    with pytest.raises(ValueError, match="shape mismatch"):
        serve(x0s[:-1].contiguous(), u0s[:-1].contiguous())


def test_demo_fleet_on_card(dev):
    """demo_fleet at a small B on the card (the lane path, its kernels
    launched) against the same lane solve on CPU tensors."""
    from differentialdynamicprogramming_jl_tpu_torch import demos
    counts = [w.launches for w in (bk.backward_lanes, fk.linesearch_lanes,
                                   fk.forward_lanes)]
    g = demos.demo_fleet(B=64, T=50, max_iter=5, device=dev)
    assert all(w.launches > c for w, c in zip(
        (bk.backward_lanes, fk.linesearch_lanes, fk.forward_lanes), counts))
    x0s, u0s = demos._fleet_inputs(64, 50, torch.float32, "cpu")
    c = ilqg_batch_lanes(tpc.pendcart_lanes(SPEC), None, x0s, u0s,
                         lims=LIMS, cfg=demos._fleet_cfg(5),
                         derivs_tiles=tpc.pendcart_derivs_tiles(SPEC))
    assert (g.reason.cpu() == c.reason).float().mean() >= 0.9
    rel = (g.cost_total.cpu() - c.cost_total).abs() / c.cost_total.abs()
    assert (rel <= 1e-3).float().mean() >= 0.9


# ---------------------------------------------------------------------------
# the op set's later ops, K4 at any n, the packed K1 at any size
# ---------------------------------------------------------------------------

def _opset():
    import os
    import sys
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
    from tools_torch import opset
    return opset.opset_lanes(fk.LanesModel)


def test_lowered_opset_is_bit_equal_to_plain(dev):
    """The op-set model (tools_torch/opset.py: pow at 2, 3, ½, -1, -2 and
    1.5, abs, log, relu, minimum, maximum, the clamps, comparisons of
    values and of t, logic, where): K3, K1 Autodiff<Lowered> first order
    (Dual) and second order (Jet, full DDP), K1 in GPS mode, and K2, each
    bit-equal to its plain version on the card."""
    from differentialdynamicprogramming_jl_tpu_torch.ops.hopper import (
        autodiff_tiles)
    model = _opset()
    rng = np.random.default_rng(17)
    f32 = dict(dtype=torch.float32, device=dev)
    lims = ((-3.0, 3.0), (-3.0, 3.0))
    x0 = torch.tensor(rng.standard_normal((3, B)), **f32)
    gains0 = torch.cat([torch.tensor(1.5 * rng.standard_normal((T, 2, B)),
                                     **f32),
                        torch.zeros((T, 6, B), **f32)], dim=1)
    al = torch.ones((1, B), **f32)
    k, p = (f(torch.zeros((T, 6, B), **f32), gains0, x0, al, model=model,
              lims=lims, emit_traj=True)
            for f in (fk.forward_lanes, fk.forward_lanes_ref))
    assert torch.equal(k.traj, p.traj) and torch.equal(k.totals, p.totals)
    traj = k.traj
    lam = torch.logspace(-6, 2, B, device=dev)
    for so in (False, True):
        tiles = autodiff_tiles.autodiff_derivs_tiles(model, second_order=so)
        for emit in ("gains", "full"):
            kw = dict(n=3, m=2, reg_type=2, lims=lims, derivs_tiles=tiles,
                      emit=emit)
            a = bk.backward_lanes(traj, lam, **kw)
            b = bk.backward_lanes_ref(traj, lam, **kw)
            assert torch.equal(a.out, b.out), (so, emit)
            assert torch.equal(a.stats, b.stats), (so, emit)
    tiles = autodiff_tiles.autodiff_derivs_tiles(model)
    a_ = rng.standard_normal((T, B, 2, 2))
    si = np.einsum("tbij,tbkj->tbik", a_, a_) + 0.5 * np.eye(2)
    prev = torch.tensor(np.concatenate([
        rng.standard_normal((T, 2, B)), 0.5 * rng.standard_normal((T, 6, B)),
        np.moveaxis(si.reshape(T, B, 4), 1, 2)], axis=1), **f32)
    eta = torch.tensor(10.0 ** rng.uniform(-1, 1, (T, B)), **f32)
    kw = dict(n=3, m=2, reg_type=1, lims=None, derivs_tiles=tiles,
              emit="policy", prev=prev, eta=eta)
    a, b = (f(traj, torch.zeros(B, **f32), **kw)
            for f in (bk.backward_lanes, bk.backward_lanes_ref))
    assert torch.equal(a.out, b.out) and torch.equal(a.stats, b.stats)
    gains = bk.backward_lanes(traj, lam, n=3, m=2, reg_type=2, lims=lims,
                              derivs_tiles=tiles, emit="gains")
    sel = torch.stack([gains.stats[0], gains.stats[1], k.totals[0],
                       (torch.arange(B, device=dev) % 2).float()])
    k2, p2 = (f(traj, gains.out, x0, sel, model=model, alphas=ALPHAS,
                reduce_ratio_min=0.0, lims=lims)
              for f in (fk.linesearch_lanes, fk.linesearch_lanes_ref))
    assert torch.equal(k2.traj, p2.traj) and torch.equal(k2.ls, p2.ls)


def test_pow_forms_are_torch_pow_on_card(dev):
    """x ** e as the lowering emits it (powc_) against torch.pow on CUDA
    tensors, at the exponents PyTorch's kernel special-cases and at two
    that go to powf: tools_torch/opset.py's pow model, one state an
    exponent, its K3 trajectory bit-equal to the plain rollout's slot by
    slot."""
    import os
    import sys
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
    from tools_torch import opset
    model = opset.pow_lanes(fk.LanesModel)
    n = model.n
    rng = np.random.default_rng(19)
    f32 = dict(dtype=torch.float32, device=dev)
    x0 = torch.tensor(rng.uniform(-1.0, 1.0, (n, B)), **f32)
    gains0 = torch.zeros((T, 1 + n, B), **f32)
    k, p = (f(torch.zeros((T, n + 2, B), **f32), gains0, x0,
              torch.ones((1, B), **f32), model=model, lims=None,
              emit_traj=True)
            for f in (fk.forward_lanes, fk.forward_lanes_ref))
    assert torch.isfinite(k.traj).all()
    for i, e in enumerate(opset.POW_EXPONENTS):
        assert torch.equal(k.traj[:, i], p.traj[:, i]), e


@pytest.mark.parametrize("n", [1, 2, 3, 5, 8, 12, 16, 17, 21, 32, 64])
def test_covariance_any_n_is_bit_identical(dev, n):
    """K4 at n from 1 to COV_MAX_N, each built at its first launch with the
    plan derived from n (the ring design up to COV_RING_MAX_N, Σ in device
    memory beyond): bit-equal to its plain version with an SPD R1, at a T
    that spans several ring chunks and a ragged B."""
    rng = np.random.default_rng(n)
    A = rng.standard_normal((n, n))
    r1 = tuple(tuple(float(np.float32(v)) for v in row)
               for row in A @ A.T + 0.5 * np.eye(n))
    fx = _k4_fx(n, 11, 77, seed=n, dev=dev)
    n0 = ck.covariance_lanes.launches
    k = ck.covariance_lanes(fx, n=n, r1=r1)
    assert ck.covariance_lanes.launches == n0 + 1
    assert torch.isfinite(k).all()
    assert torch.equal(k, ck.covariance_lanes_ref(fx, n=n, r1=r1))


@pytest.mark.parametrize("emit", ["gains", "full"])
@pytest.mark.parametrize("n, m", [(8, 2), (5, 4)])
def test_packed_any_size_matches_plain(dev, n, m, emit):
    """K1 on the packed stream at sizes the kernel library does not hold
    (Packed<8,2>, and m = MAX_M at Packed<5,4>), built at their first
    launch, against the plain version; the GPS mode there raises."""
    from differentialdynamicprogramming_jl_tpu_torch.models import linear
    spec = linear.random_lti(2, n=n, m=m, T=T, device=dev)
    rng = np.random.default_rng(n + m)
    f32 = dict(dtype=torch.float32, device=dev)
    lims = ((-0.6, 0.6),) * m
    gains0 = torch.cat([torch.tensor(rng.standard_normal((T, m, B)), **f32),
                        torch.zeros((T, m * n, B), **f32)], dim=1)
    traj = fk.forward_lanes(
        torch.zeros((T, n + m + 1, B), **f32), gains0,
        torch.tensor(np.linspace(0.5, 2.0, B)[None, :]
                     + 0.3 * rng.standard_normal((n, B)), **f32),
        torch.ones((1, B), **f32), model=linear.lti_lanes(spec), lims=lims,
        emit_traj=True).traj
    dp = linear.lti_packed_derivs(spec)(traj[:, :n], traj[:, n:n + m])
    lam = torch.logspace(-6, 2, B, device=dev)
    kw = dict(n=n, m=m, reg_type=2, lims=lims, derivs_tiles=None, emit=emit)
    n0 = bk.backward_lanes.launches
    a = bk.backward_lanes(dp, lam, **kw)
    assert bk.backward_lanes.launches == n0 + 1
    b = bk.backward_lanes_ref(dp, lam, **kw)
    _slots_close(a.out, b.out, tol=1e-4 if emit == "full" else 1e-5)
    torch.testing.assert_close(a.stats[:2], b.stats[:2], rtol=1e-4,
                               atol=1e-5)
    assert torch.equal(a.stats[2:], b.stats[2:])
    if emit == "full":
        prev = torch.zeros((T, m + m * n + m * m, B), **f32)
        with pytest.raises(NotImplementedError, match="GPS"):
            bk.backward_lanes(dp, lam, prev=prev, eta=torch.ones((T, B),
                                                                  **f32),
                              **dict(kw, reg_type=1, lims=None))


# ---------------------------------------------------------------------------
# many controls: libraries generated for their own m above the kernel
# library's MAX_M (csrc/common.cuh DDP_MAX_M), up to plan.MAX_CONTROLS
# ---------------------------------------------------------------------------

def _controls():
    import importlib
    return importlib.import_module("tools_torch.controls")


def _controls_models(n, m, dev):
    from differentialdynamicprogramming_jl_tpu_torch.models import linear
    spec = linear.random_lti(1, n=n, m=m, T=T, device=dev)
    tiles = linear.lti_derivs_tiles(spec)
    return (spec, linear.lti_lanes(spec), tiles,
            _controls().so_tiles(bk.DerivsTiles, tiles, n, m))


@pytest.fixture(scope="module")
def controls_built():
    """Every library of the many-controls tests, one nvcc each, all at
    once: per size the LTI's lowered model (K2/K3) and its tiles' t1,
    t1_gps and second-order t1_so groups, and the packed K1 at ⟨6,5⟩ and
    ⟨10,8⟩; prints each build's seconds and ptxas lines."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    dev = torch.device("cuda", 0)
    import chip_smoke
    from differentialdynamicprogramming_jl_tpu_torch.ops.hopper import (
        _build, lower)
    jobs, labels = [], []
    for n, m in _controls().SIZES:
        _, model, tiles, so = _controls_models(n, m, dev)
        lt = lower.lower_tiles(tiles, n, m).struct()
        for struct, group in ((lower.lower(model).struct(True), "fwd"),
                              (lt, "t1"), (lt, "t1_gps"),
                              (lower.lower_tiles(so, n, m).struct(),
                               "t1_so")):
            jobs.append((_build.lowered_source(struct, group),
                         _build.LOWERED_HEADERS, "lowered"))
            labels.append(f"<{n},{m}> {group}")
    for n, m in ((6, 5), (10, 8)):
        jobs.append(_build.packed_job(n, m))
        labels.append(f"packed <{n},{m}>")
    for label, b in zip(labels, _build.build_generated(jobs, "controls")):
        print(f"{label}: {b.seconds:.1f} s")
        for line in chip_smoke.ptxas_summary(b.log):
            print(f"  {line}")
    return True


@pytest.mark.parametrize("n, m", [(6, 5), (10, 8), (16, 16)])
def test_many_controls_match_plain(dev, controls_built, n, m):
    """An LTI at m > MAX_M without a descriptor: K3 (sweep, rollout), K1
    LoweredTiles (gains, full and policy with a ±0.6 box; GPS full and
    policy with per-step η; second-order tiles, gains and full) and K2 at
    A = 6 and A = 11, each bit for bit its plain version on the card. The
    horizon shrinks with the size (the plain K1 at <16,16> is ≈70k torch
    operations a step); K1's ring turns over several chunks at each."""
    _, model, tiles, so = _controls_models(n, m, dev)
    T = {(6, 5): 40, (10, 8): 17, (16, 16): 9}[(n, m)]
    x0, gains0 = _controls().lti_inputs(n, m, T, B, n + m, dev)
    lims = ((-0.6, 0.6),) * m
    f32 = dict(dtype=torch.float32, device=dev)
    ladder = torch.tensor(ALPHAS, **f32)[:, None].expand(6, B).contiguous()
    traj0 = torch.zeros((T, n + m + 1, B), **f32)
    for al, emit in ((ladder, False), (torch.ones((1, B), **f32), True)):
        n0 = fk.forward_lanes.launches
        k = fk.forward_lanes(traj0, gains0, x0, al, model=model, lims=lims,
                             emit_traj=emit)
        assert fk.forward_lanes.launches == n0 + 1
        p = fk.forward_lanes_ref(traj0, gains0, x0, al, model=model,
                                 lims=lims, emit_traj=emit)
        assert torch.equal(k.totals, p.totals) and torch.equal(k.terminal,
                                                               p.terminal)
    assert torch.equal(k.traj, p.traj)
    traj = k.traj
    lam = torch.logspace(-6, 2, B, device=dev)
    import chip_smoke
    prev, eta = chip_smoke.gps_inputs(np.random.default_rng(n * m), T, B,
                                      n, m, dev)
    cases = [dict(emit=e, derivs_tiles=tiles, reg_type=2, lims=lims)
             for e in ("gains", "full", "policy")]
    cases += [dict(emit=e, derivs_tiles=tiles, reg_type=1, lims=None,
                   prev=prev, eta=eta) for e in ("full", "policy")]
    cases += [dict(emit=e, derivs_tiles=so, reg_type=2, lims=lims)
              for e in ("gains", "full")]
    for case in cases:
        n0 = bk.backward_lanes.launches
        a = bk.backward_lanes(traj, lam, n=n, m=m, **case)
        assert bk.backward_lanes.launches == n0 + 1
        b = bk.backward_lanes_ref(traj, lam, n=n, m=m, **case)
        what = (case["emit"], "prev" in case, case["derivs_tiles"] is so)
        assert torch.equal(a.out, b.out), what
        assert torch.equal(a.stats, b.stats), what
    g = bk.backward_lanes(traj, lam, n=n, m=m, emit="gains",
                          derivs_tiles=tiles, reg_type=2, lims=lims)
    sel = torch.stack([g.stats[0], g.stats[1], k.totals[0],
                       (torch.arange(B, device=dev) % 2).float()])
    for alphas in (ALPHAS, default_alphas(0.2, -3.0, 11)):
        n0 = fk.linesearch_lanes.launches
        k2 = fk.linesearch_lanes(traj, g.out, x0, sel, model=model,
                                 alphas=alphas, reduce_ratio_min=0.0,
                                 lims=lims)
        assert fk.linesearch_lanes.launches == n0 + 1
        p2 = fk.linesearch_lanes_ref(traj, g.out, x0, sel, model=model,
                                     alphas=alphas, reduce_ratio_min=0.0,
                                     lims=lims)
        assert torch.equal(k2.traj, p2.traj) and torch.equal(k2.ls, p2.ls)


@pytest.mark.parametrize("n, m", [(6, 5), (10, 8)])
def test_packed_many_controls_match_plain(dev, controls_built, n, m):
    """Packed<6,5> and Packed<10,8> in gains and full emission, generated
    for their own m, bit for bit the plain version."""
    from differentialdynamicprogramming_jl_tpu_torch.models import linear
    spec, model, _, _ = _controls_models(n, m, dev)
    x0, gains0 = _controls().lti_inputs(n, m, T, B, n + m, dev)
    lims = ((-0.6, 0.6),) * m
    traj = fk.forward_lanes(torch.zeros((T, n + m + 1, B), device=dev),
                            gains0, x0, torch.ones((1, B), device=dev),
                            model=model, lims=lims, emit_traj=True).traj
    dp = linear.lti_packed_derivs(spec)(traj[:, :n], traj[:, n:n + m])
    lam = torch.logspace(-6, 2, B, device=dev)
    for emit in ("gains", "full"):
        kw = dict(n=n, m=m, reg_type=2, lims=lims, derivs_tiles=None,
                  emit=emit)
        n0 = bk.backward_lanes.launches
        a = bk.backward_lanes(dp, lam, **kw)
        assert bk.backward_lanes.launches == n0 + 1
        b = bk.backward_lanes_ref(dp, lam, **kw)
        assert torch.equal(a.out, b.out) and torch.equal(a.stats, b.stats)


def test_many_controls_solvers_on_card(dev, controls_built):
    """ilqg_batch_lanes, mpc_rollout_lanes and ilqgkl_batch_lanes (K4 at
    n=6, K1's GPS policy at m=5) at ⟨6,5⟩ on CUDA tensors run the generated
    libraries (their launch counters move; no plain version runs on the
    card) and agree with the same calls on CPU tensors: costs to 1e-3
    relative on every lane."""
    from differentialdynamicprogramming_jl_tpu_torch.models import linear
    from differentialdynamicprogramming_jl_tpu_torch.solvers.batch import (
        mpc_rollout_lanes)
    n, m, Bs, Ts = 6, 5, 16, 12
    out = {}
    for where in (dev, "cpu"):
        spec = linear.random_lti(1, n=n, m=m, T=Ts, device=where)
        model, tiles = linear.lti_lanes(spec), linear.lti_derivs_tiles(spec)
        x0s = torch.ones((Bs, n), device=where) * torch.linspace(
            0.5, 2.0, Bs, device=where)[:, None]
        u0s = spec.u0.expand(Bs, Ts, m).contiguous()
        lims = ((-0.6, 0.6),) * m
        cfg = ILQGConfig(alphas=ALPHAS, reg_type=2, max_iter=4)
        counts = [c.launches for c in (bk.backward_lanes,
                                       fk.linesearch_lanes,
                                       fk.forward_lanes)]
        r = ilqg_batch_lanes(model, None, x0s, u0s, lims=lims, cfg=cfg,
                             derivs_tiles=tiles)
        x, u, xs, us, costs = mpc_rollout_lanes(
            model, None, x0s, u0s,
            lambda x_, u_: x_ @ spec.A.T + u_ @ spec.B.T, 2, lims=lims,
            cfg=cfg, derivs_tiles=tiles)
        f32 = dict(dtype=torch.float32, device=where)
        ro = fk.forward_lanes(
            torch.zeros((Ts, n + m + 1, Bs), **f32),
            torch.cat([to_streams(u0s), torch.zeros((Ts, m * n, Bs), **f32)],
                      dim=1), x0s.T.contiguous(), torch.ones((1, Bs), **f32),
            model=model, lims=None, emit_traj=True)
        eye = torch.eye(m, **f32).expand(Bs, Ts, m, m)
        pol = GaussianPolicy(
            K=torch.zeros((Bs, Ts, m, n), **f32),
            k=from_streams(ro.traj[:, n:n + m], (m,)).contiguous(),
            sigma=eye, sigma_inv=eye)
        kl = ilqgkl_batch_lanes(
            model, tiles, from_streams(ro.traj[:, :n], (n,)).contiguous(),
            pol, spec.A.expand(Bs, Ts, n, n), ro.totals[0],
            cfg=ILQGKLConfig(kl_step=100.0, max_iter=3))
        moved = [c.launches > c0 for c, c0 in zip(
            (bk.backward_lanes, fk.linesearch_lanes, fk.forward_lanes),
            counts)]
        assert all(moved) == (where != "cpu"), (where, moved)
        out[str(where)] = (r.cost_total.cpu(), costs.cpu(),
                           kl.cost_total.cpu())
    for g, c in zip(out[str(dev)], out["cpu"]):
        torch.testing.assert_close(g, c, rtol=1e-3, atol=0)


def test_m_above_ceiling_refused_before_build(dev, monkeypatch):
    """m = 33: K1, K2 and K3 on CUDA tensors raise naming the ceiling and
    never reach a build or a lowering."""
    from differentialdynamicprogramming_jl_tpu_torch.models import linear
    from differentialdynamicprogramming_jl_tpu_torch.ops.hopper import (
        _build, lower)

    def refuse(*a, **k):
        raise AssertionError("built or lowered")

    for mod, name in ((_build, "build_generated"), (lower, "lower"),
                      (lower, "lower_tiles")):
        monkeypatch.setattr(mod, name, refuse)
    n, m = 4, 33
    spec = linear.random_lti(1, n=n, m=m, T=T, device=dev)
    f32 = dict(dtype=torch.float32, device=dev)
    traj = torch.zeros((T, n + m + 1, B), **f32)
    gains = torch.zeros((T, m + m * n, B), **f32)
    x0 = torch.zeros((n, B), **f32)
    lims = ((-1.0, 1.0),) * m
    with pytest.raises(NotImplementedError, match="MAX_CONTROLS"):
        bk.backward_lanes(traj, torch.ones(B, **f32), n=n, m=m, reg_type=2,
                          lims=lims, derivs_tiles=linear.lti_derivs_tiles(
                              spec))
    with pytest.raises(NotImplementedError, match="MAX_CONTROLS"):
        fk.forward_lanes(traj, gains, x0, torch.ones((1, B), **f32),
                         model=linear.lti_lanes(spec), lims=lims)
    with pytest.raises(NotImplementedError, match="MAX_CONTROLS"):
        fk.linesearch_lanes(traj, gains, x0, torch.zeros((4, B), **f32),
                            model=linear.lti_lanes(spec), alphas=ALPHAS,
                            reduce_ratio_min=0.0, lims=lims)


def test_tie_model_is_bit_equal_to_plain(dev):
    """The tie model (tools_torch/ties.py: u clamped to ±5 in the dynamics,
    0.1·|u| in the cost) at u on its ties: K1 Autodiff<Lowered> (Dual and
    Jet passes, JAX's rules) bit for bit the plain autodiff tiles, which
    JAX's rules give |u|' = 1 at 0 and the clamp ½ on its bound."""
    import importlib
    ties = importlib.import_module("tools_torch.ties")
    model = ties.tie_lanes(torch, fk.LanesModel, tpc.pendcart_lanes(SPEC))
    from differentialdynamicprogramming_jl_tpu_torch.ops.hopper import (
        autodiff_tiles)
    x0, gains0, al = _rollout(dev)
    traj = fk.forward_lanes(torch.zeros((T, 5, B), device=dev), gains0, x0,
                            al, model=model, lims=LIMS, emit_traj=True).traj
    # put the controls on the ties: 0 and ±5 on alternate steps
    u = traj[:, 4]
    u[0::3] = 0.0
    u[1::3] = ties.LIM
    u[2::6] = -ties.LIM
    lam = torch.logspace(-6, 2, B, device=dev)
    tiles = autodiff_tiles.autodiff_derivs_tiles(model)
    for emit in ("gains", "full"):
        kw = dict(n=4, m=1, reg_type=2, lims=LIMS, derivs_tiles=tiles,
                  emit=emit)
        a = bk.backward_lanes(traj, lam, **kw)
        b = bk.backward_lanes_ref(traj, lam, **kw)
        assert torch.equal(a.out, b.out) and torch.equal(a.stats, b.stats)


# ---- sizes past the lane design: the wide K1, K2 and K3 past their ring --
# (tools_torch/wide.py); each bit for bit its plain version


@pytest.mark.parametrize("n, m, gps, emit", [
    (n, m, gps, emit) for (n, m), modes in __import__(
        "tools_torch.wide", fromlist=["CHECKS"]).CHECKS.items()
    for gps, emit in modes])
def test_wide_k1_is_bit_equal_to_plain(dev, n, m, gps, emit):
    """K1's wide design (one warp a scenario, plan tc = 0) at the smallest
    sizes where the plan takes it, from the LTI tiles (the stream formed
    with torch), ±0.6 and reg_type 2 without GPS mode, per-step η and
    reg_type 1 in it, B = 37 (a block's last warps idle), T = 3."""
    from differentialdynamicprogramming_jl_tpu_torch.models import linear
    from tools_torch import wide
    Tw, Bw = 3, 37
    assert bk.backward_plan(n, m, gps, emit, Tw, Bw).tc == 0
    spec = linear.random_lti(1, n=n, m=m, T=Tw, device=dev)
    traj, lam, prev, eta = wide.k1_inputs(n, m, Tw, Bw, 7, dev)
    kw = dict(n=n, m=m, derivs_tiles=linear.lti_derivs_tiles(spec),
              emit=emit, reg_type=1 if gps else 2,
              lims=None if gps else ((-wide.BOX, wide.BOX),) * m)
    if gps:
        kw.update(prev=prev, eta=eta)
    n0 = bk.backward_lanes.wide_launches
    a = bk.backward_lanes(traj, lam, **kw)
    assert bk.backward_lanes.wide_launches == n0 + 1
    b = bk.backward_lanes_ref(traj, lam, **kw)
    assert torch.equal(a.out, b.out) and torch.equal(a.stats, b.stats)


@pytest.mark.parametrize("n, m", [(54, 21), (64, 32)])
def test_wide_k1_matches_cpu_plain(dev, n, m):
    """The wide K1 at the humanoid's size and at the ceiling ("gains",
    ±0.6, the m > 2 box QP), T = 2, against the plain version on CPU
    tensors: bit for bit (the LTI has no transcendental functions, and the
    plain version's square roots are correctly rounded)."""
    from differentialdynamicprogramming_jl_tpu_torch.models import linear
    from tools_torch import wide
    Tw, Bw = 2, 8
    traj, lam, _, _ = wide.k1_inputs(n, m, Tw, Bw, 11, dev)
    kw = dict(n=n, m=m, reg_type=2, lims=((-wide.BOX, wide.BOX),) * m,
              emit="gains")
    a = bk.backward_lanes(traj, lam, derivs_tiles=linear.lti_derivs_tiles(
        linear.random_lti(0, n=n, m=m, T=Tw, device=dev)), **kw)
    b = bk.backward_lanes_ref(traj.cpu(), lam.cpu(),
                              derivs_tiles=linear.lti_derivs_tiles(
                                  linear.random_lti(0, n=n, m=m, T=Tw,
                                                    device="cpu")), **kw)
    assert torch.equal(a.out.cpu(), b.out)
    assert torch.equal(a.stats.cpu(), b.stats)


@pytest.mark.parametrize("n, m", [(54, 21), (64, 32)])
def test_k2_k3_past_their_ring_are_bit_equal(dev, n, m):
    """K3 (the 6-α sweep, the emitting rollout) and K2 (A = 6 and 11) on
    the lowered LTI where two ring stages do not fit a block: ⟨54,21⟩
    (random_lti) with one stage, ⟨64,32⟩ (wide.sparse_lti, fast to lower
    and build) with x_old, u_nom and k in the ring and K read from device
    memory; T = 2, B = 37, ±0.6; bit for bit the plain versions."""
    from differentialdynamicprogramming_jl_tpu_torch.models import linear
    from differentialdynamicprogramming_jl_tpu_torch.ops.hopper import plan
    from tools_torch import wide
    Tw, Bw = 2, 37
    assert plan.k23_direct(n, m) == ((n, m) == (64, 32))
    spec = (linear.random_lti(1, n=n, m=m, T=Tw, device=dev)
            if (n, m) == wide.HUMANOID else
            wide.sparse_lti(linear.LTISpec, n, m, Tw, dev))
    model = linear.lti_lanes(spec)
    traj, gains, x0, sel = wide.k23_inputs(n, m, Tw, Bw, 3, dev)
    lims = ((-wide.BOX, wide.BOX),) * m
    for A, emit in ((6, False), (1, True)):
        al = torch.rand((A, Bw), device=dev)
        k, p = (f(traj, gains, x0, al, model=model, lims=lims,
                  emit_traj=emit)
                for f in (fk.forward_lanes, fk.forward_lanes_ref))
        assert torch.equal(k.totals, p.totals)
        assert torch.equal(k.terminal, p.terminal)
        if emit:
            assert torch.equal(k.traj, p.traj)
    for alphas in (ALPHAS, default_alphas(0.2, -3.0, 11)):
        k, p = (f(traj, gains, x0, sel, model=model, alphas=alphas,
                  reduce_ratio_min=0.0, lims=lims)
                for f in (fk.linesearch_lanes, fk.linesearch_lanes_ref))
        assert torch.equal(k.traj, p.traj) and torch.equal(k.ls, p.ls)
