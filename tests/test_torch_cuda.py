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
    backward_kernel as bk, forward_kernel as fk)
from differentialdynamicprogramming_jl_tpu_torch.solvers.batch import (
    ilqg_batch_lanes)
from differentialdynamicprogramming_jl_tpu_torch.solvers.ilqg import (
    ILQGConfig, default_alphas)

B, T = 200, 40          # B not a multiple of the block: the mask b < B
LIMS = ((-5.0, 5.0),)
ALPHAS = default_alphas(0.2, -3.0, 6)
SPEC = tpc.PendCartSpec()


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
