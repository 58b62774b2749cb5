"""m > 2 controls: the port's plain versions against the JAX package.

- ``_boxqp_masked`` (K1's m > 2 box QP) against JAX's function called on
  jnp arrays (no Pallas): m ∈ {3, 4, 5}, 0, 1 and 8 iterations, H positive
  definite, indefinite, nearly rank one (where clipped Newton steps stall
  and the "no descent" test fires), and NaN in g;
- ``_logdet_tiles`` and ``kl_div_wiki_lanes`` at m ∈ {3, 4};
- K1 through ``backward_pass_pallas`` (the packed stream, the plain version
  on CPU tensors) against JAX's in interpret mode at n=6, m ∈ {3, 4}, T=7,
  B=8, a ±0.05 box, reg_type 1 (as ``tests/test_pallas_kernels.py:
  224-252``), and in GPS mode at m=3 without limits;
- K3 and K2 at n=4, m=3 against JAX's kernels in interpret mode;
- the CUDA instance tables: unbuilt (n, m) of a hand-written descriptor,
  and any m above the ceiling ``plan.MAX_CONTROLS``, refused before any
  launch (on the meta device, which needs no card).

Inputs are made in numpy from seeded Generators and cast to f32; specs go
through ``convert.lti_spec_from_jax``. One JAX call structure per shape.

Tolerances. The box QP: bit for bit (x, L, the free set, ok). JAX's eager
operations on the host and the plain version run the same f32 operations
in the same order, each rounded once; the plain Cholesky takes its square
roots rounded to nearest (``_sqrt_rn``), as XLA's are. K1: rtol
1e-5, atol 1e-5 on k, K, Vx, Vxx, Σ and dV (XLA contracts some products
into multiply-adds in the interpreted kernel); the latch exactly. K3, K2:
rtol 1e-5, atol 1e-6; the line search's decisions exactly.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.linalg import expm

from differentialdynamicprogramming_jl_tpu.models import linear as jl
from differentialdynamicprogramming_jl_tpu.ops.pallas import (
    backward_kernel as jbk)
from differentialdynamicprogramming_jl_tpu.ops.pallas.forward_kernel import (
    forward_lanes as jax_forward_lanes, linesearch_lanes as jax_linesearch)
from differentialdynamicprogramming_jl_tpu.policy import (
    Derivs as JDerivs, GaussianPolicy as JPolicy)
from differentialdynamicprogramming_jl_tpu.solvers import batch_kl as jkl
from differentialdynamicprogramming_jl_tpu_torch import convert
from differentialdynamicprogramming_jl_tpu_torch.models import linear as tl
from differentialdynamicprogramming_jl_tpu_torch.ops.hopper import (
    backward_kernel as bk, forward_kernel as fk)
from differentialdynamicprogramming_jl_tpu_torch.policy import Derivs
from differentialdynamicprogramming_jl_tpu_torch.solvers import batch_kl as tkl
from differentialdynamicprogramming_jl_tpu_torch.solvers.ilqg import (
    default_alphas)

B, T = 8, 7
BOX = 0.05
ALPHAS = default_alphas(0.2, -3.0, 4)


# ---- the box QP ---------------------------------------------------------

def _qp_case(kind, m, seed, Bq=256):
    """(H, g, lo, hi, x0) of Bq problems, each (Bq, ...) f32."""
    rng = np.random.default_rng(seed)
    G = rng.standard_normal((Bq, m, m))
    Gt = np.swapaxes(G, 1, 2)
    g = rng.standard_normal((Bq, m))
    if kind == "indefinite":
        H = G + Gt
    elif kind == "stalls":
        # nearly rank one: the Newton step on the free set is long and its
        # clipped candidates can all be worse than the current point
        v = rng.standard_normal((Bq, m, 1))
        H = (10.0 * v @ np.swapaxes(v, 1, 2) + 1e-3 * np.eye(m)
             + 0.01 * G @ Gt)
        g = 5.0 * g
    else:
        H = G @ Gt + 0.1 * np.eye(m)
    if kind == "nan":
        g[::5, 1] = np.nan
    lo = -rng.uniform(0.05, 0.5, (Bq, m))
    hi = rng.uniform(0.05, 0.5, (Bq, m))
    x0 = rng.uniform(-1.0, 1.0, (Bq, m))
    return tuple(a.astype(np.float32) for a in (H, g, lo, hi, x0))


def _qp_run(fn, to, case, m, iters):
    H, g, lo, hi, x0 = case
    col = lambda a, i: to(np.ascontiguousarray(a[:, i]))
    x, free, L, ok = fn([[to(np.ascontiguousarray(H[:, i, j]))
                          for j in range(m)] for i in range(m)],
                        [col(g, i) for i in range(m)],
                        [col(lo, i) for i in range(m)],
                        [col(hi, i) for i in range(m)],
                        [col(x0, i) for i in range(m)], m, iters)
    low = [np.asarray(L[i][j]) for i in range(m) for j in range(i + 1)]
    return (np.stack([np.asarray(v) for v in x]),
            np.stack([np.asarray(v) for v in free]), np.stack(low),
            np.asarray(ok))


@pytest.mark.parametrize("iters", [0, 1, 8])
@pytest.mark.parametrize("m", [3, 4, 5])
@pytest.mark.parametrize("kind", ["pd", "indefinite", "stalls", "nan"])
def test_boxqp_masked_matches_jax(kind, m, iters):
    case = _qp_case(kind, m, seed=10 * m + iters)
    rx, rf, rL, rok = _qp_run(jbk._boxqp_masked, jnp.asarray, case, m, iters)
    ox, of, oL, ook = _qp_run(bk._boxqp_masked, torch.from_numpy, case, m,
                              iters)
    np.testing.assert_array_equal(of, rf)
    np.testing.assert_array_equal(ook, rok)
    np.testing.assert_array_equal(ox, rx)
    np.testing.assert_array_equal(oL, rL)
    H, g, lo, hi, _ = case
    pd = np.all(np.linalg.eigvalsh(H.astype(np.float64)) > 0, axis=-1)
    if kind == "pd":
        # the box binds: some coordinate of the solution on a bound
        assert np.any((ox == lo.T) | (ox == hi.T))
    if kind == "indefinite":
        assert not rok.all() and rok.any()
    if kind == "stalls" and iters > 0:
        # positive definite H, factorisations fine, yet no descent at the
        # last iteration while the free gradient is far from 0
        assert np.any(pd & ~rok)
    if kind == "nan":
        # a NaN objective takes no candidate (NaN < v is False): the lane
        # keeps its start, clipped, and no test fails on it
        bad = np.isnan(g).any(axis=1)
        x0c = np.clip(case[4], lo, hi).T
        assert bad.any() and np.array_equal(ox[:, bad], x0c[:, bad])


# ---- the KL measurement ----------------------------------------------------

def _spd_stream(rng, m, Tn=T):
    G = rng.standard_normal((Tn, B, m, m))
    S = np.einsum("tbij,tbkj->tbik", G, G) + 0.3 * np.eye(m)
    return np.moveaxis(S.reshape(Tn, B, m * m), 1, 2).astype(np.float32)


@pytest.mark.parametrize("m", [3, 4])
def test_logdet_and_kl_match_jax(m):
    n = 4
    rng = np.random.default_rng(m)
    S = _spd_stream(rng, m)
    S[2, :, 3] = -5.0                 # an indefinite entry: ok is False
    rl, rok = jkl._logdet_tiles(jnp.asarray(S), m)
    ol, ook = tkl._logdet_tiles(torch.from_numpy(S), m)
    np.testing.assert_array_equal(ook.numpy(), np.asarray(rok))
    assert not ook.all() and ook.any()
    np.testing.assert_allclose(ol.numpy(), np.asarray(rl), rtol=1e-5,
                               atol=1e-6)
    f = np.float32
    args = (rng.standard_normal((T, n, B)).astype(f),
            _spd_stream(rng, n),
            rng.standard_normal((T, m, B)).astype(f),
            rng.standard_normal((T, m * n, B)).astype(f), _spd_stream(rng, m),
            rng.standard_normal((T, m, B)).astype(f),
            rng.standard_normal((T, m * n, B)).astype(f), _spd_stream(rng, m))
    rk, rpd = jkl.kl_div_wiki_lanes(*map(jnp.asarray, args), n=n, m=m)
    ok, opd = tkl.kl_div_wiki_lanes(*map(torch.from_numpy, args), n=n, m=m)
    np.testing.assert_array_equal(opd.numpy(), np.asarray(rpd))
    np.testing.assert_allclose(ok.numpy(), np.asarray(rk), rtol=1e-5,
                               atol=1e-5)


# ---- K1 --------------------------------------------------------------------

def _lti_spec(n, m, seed, R=0.05, Tn=T):
    rng = np.random.default_rng(seed)
    Mm = rng.standard_normal((n, n))
    f = jnp.float32
    return jl.LTISpec(A=jnp.asarray(expm(0.3 * (Mm - Mm.T)), f),
                      B=jnp.asarray(0.3 * rng.standard_normal((n, m)), f),
                      Q=jnp.asarray(0.5 * np.eye(n), f),
                      R=jnp.asarray(R * np.eye(m), f),
                      x0=jnp.ones((n,), f), u0=jnp.zeros((Tn, m), f))


def _lti_derivs(spec, n, m, seed):
    """The LTI expansion along a random (x, u): fx = A, fu = B, cx = Q·x,
    cu = R·u, cxx = Q, cxu = 0, cuu = R; numpy (B, T, ...) f32, and u."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, T, n))
    u = 0.1 * rng.standard_normal((B, T, m))
    A, Bm, Q, R = (np.asarray(a, np.float64) for a in
                   (spec.A, spec.B, spec.Q, spec.R))
    tile = lambda a: np.broadcast_to(a, (B, T) + a.shape)
    d = dict(fx=tile(A), fu=tile(Bm), cx=x @ Q, cu=u @ R, cxx=tile(Q),
             cxu=np.zeros((B, T, n, m)), cuu=tile(R))
    return ({k: np.ascontiguousarray(v, np.float32) for k, v in d.items()},
            u.astype(np.float32))


def _bwd_both(d, u, lam, **kw):
    ref = jbk.backward_pass_pallas(
        JDerivs(**{k: jnp.asarray(v) for k, v in d.items()}), jnp.asarray(u),
        jnp.asarray(lam), k_t=1, interpret=True, **kw)
    if "traj_prev" in kw:
        kw["traj_prev"] = convert.policy_from_jax(kw["traj_prev"],
                                                  device="cpu")
        kw["eta"] = torch.from_numpy(np.asarray(kw["eta"]))
    out = bk.backward_pass_pallas(
        Derivs(**{k: torch.from_numpy(v) for k, v in d.items()}),
        torch.from_numpy(u), torch.from_numpy(lam), **kw)
    return ref, out


def _bwd_close(ref, out):
    for name in ("k", "K", "sigma", "sigma_inv"):
        np.testing.assert_allclose(
            getattr(out.policy, name).numpy(),
            np.asarray(getattr(ref.policy, name)), rtol=1e-5, atol=1e-5,
            err_msg=name)
    for name in ("Vx", "Vxx", "dV"):
        np.testing.assert_allclose(getattr(out, name).numpy(),
                                   np.asarray(getattr(ref, name)), rtol=1e-5,
                                   atol=1e-5, err_msg=name)
    np.testing.assert_array_equal(out.diverged.numpy(),
                                  np.asarray(ref.diverged))
    np.testing.assert_array_equal(out.diverge_idx.numpy(),
                                  np.asarray(ref.diverge_idx))


@pytest.mark.parametrize("R", [0.05, -0.5])
@pytest.mark.parametrize("m", [3, 4])
def test_backward_masked_qp_matches_jax(m, R):
    """K1 with a ±0.05 box at m > 2: the masked projected-Newton box QP,
    warm-started from the next step's k, and K on its free subspace. R < 0
    makes Quu indefinite where λ cannot lift it, so lanes latch."""
    n = 6
    spec = _lti_spec(n, m, seed=m, R=R)
    d, u = _lti_derivs(spec, n, m, seed=m + 1)
    lam = np.geomspace(0.01, 1.0, B).astype(np.float32)
    lims = np.array([[-BOX, BOX]] * m, np.float32)
    ref, out = _bwd_both(d, u, lam, reg_type=1, lims=lims, use_limits=True)
    _bwd_close(ref, out)
    # the limits bind: u + k on a bound of some control, steps before T-1
    k = out.policy.k.numpy()[:, :-1]
    on = (k == np.float32(-BOX) - u[:, :-1]) | (k == np.float32(BOX)
                                                  - u[:, :-1])
    assert on.any() and not on.all()
    if R < 0:
        assert 0 < int(out.diverged.sum()) < B


def test_backward_gps_m3_matches_jax():
    """K1 in GPS mode at m=3 without limits: the unrolled 3×3 Cholesky of
    the KL-augmented Quu."""
    n, m = 6, 3
    spec = _lti_spec(n, m, seed=7)
    d, u = _lti_derivs(spec, n, m, seed=8)
    rng = np.random.default_rng(9)
    G = rng.standard_normal((B, T, m, m))
    Si = np.einsum("btij,btkj->btik", G, G) + 0.5 * np.eye(m)
    f = np.float32
    prev = JPolicy(K=jnp.asarray(0.3 * rng.standard_normal((B, T, m, n)), f),
                   k=jnp.asarray(rng.standard_normal((B, T, m)), f),
                   sigma=jnp.asarray(np.linalg.inv(Si), f),
                   sigma_inv=jnp.asarray(Si, f))
    eta = jnp.asarray(10.0 ** rng.uniform(-0.5, 1.0, B), f)
    ref, out = _bwd_both(d, u, np.zeros(B, f), reg_type=1, traj_prev=prev,
                         eta=eta)
    _bwd_close(ref, out)
    assert not out.diverged.any()


# ---- K3 and K2 ----------------------------------------------------------

N3, M3 = 4, 3
LIMS3 = ((-0.05, 0.05), (-0.02, 0.08), (-0.1, 0.03))


def _lanes(a):
    return jnp.asarray(convert.stream_to_lanes(a))


def _rollout_inputs(seed=3):
    rng = np.random.default_rng(seed)
    f = np.float32
    x0 = rng.standard_normal((N3, B)).astype(f)
    traj = np.concatenate([rng.standard_normal((T, N3, B)),
                           0.1 * rng.standard_normal((T, M3, B)),
                           np.zeros((T, 1, B))], axis=1).astype(f)
    gains = np.concatenate(
        [0.3 * rng.standard_normal((T, M3, B)),
         0.5 * rng.standard_normal((T, M3 * N3, B))], axis=1).astype(f)
    return x0, traj, gains


@pytest.mark.parametrize("A,emit,lims", [(4, False, LIMS3), (1, True, LIMS3),
                                         (1, True, None)])
def test_forward_m3_matches_jax(A, emit, lims):
    spec = _lti_spec(N3, M3, seed=11)
    x0, traj, gains = _rollout_inputs()
    alphas = np.broadcast_to(np.float32(ALPHAS[:A])[:, None], (A, B)).copy()
    ref = jax_forward_lanes(
        _lanes(traj), _lanes(gains), _lanes(x0), _lanes(alphas),
        model=jl.lti_lanes(spec), lims=lims, gk=0, gK=M3, emit_traj=emit,
        k_t=2, interpret=True)
    out = fk.forward_lanes(
        *(torch.from_numpy(a) for a in (traj, gains, x0, alphas)),
        model=tl.lti_lanes(convert.lti_spec_from_jax(spec, device="cpu")),
        lims=lims, emit_traj=emit)
    np.testing.assert_allclose(out.totals.numpy(),
                               convert.stream_from_lanes(ref.totals, B),
                               rtol=1e-5, atol=1e-6)
    if emit:
        o = out.traj.numpy()
        np.testing.assert_allclose(o, convert.stream_from_lanes(ref.traj, B),
                                   rtol=1e-5, atol=1e-6)
        if lims is not None:
            # each control's clamp binds on some step
            u = o[:, N3:N3 + M3]
            for mi, (lo, hi) in enumerate(lims):
                assert np.any((u[:, mi] == np.float32(lo))
                              | (u[:, mi] == np.float32(hi)))


def test_linesearch_m3_matches_jax():
    spec = _lti_spec(N3, M3, seed=11)
    tspec = convert.lti_spec_from_jax(spec, device="cpu")
    tmodel = tl.lti_lanes(tspec)
    x0, _, _ = _rollout_inputs()
    gains0 = np.concatenate([np.full((T, M3, B), 0.1, np.float32),
                             np.zeros((T, M3 * N3, B), np.float32)], axis=1)
    ro = fk.forward_lanes(torch.zeros((T, N3 + M3, B)),
                          torch.from_numpy(gains0), torch.from_numpy(x0),
                          torch.ones((1, B)), model=tmodel, lims=LIMS3,
                          emit_traj=True)
    bo = bk.backward_lanes(ro.traj, torch.ones(B), n=N3, m=M3, reg_type=2,
                           lims=LIMS3, derivs_tiles=tl.lti_derivs_tiles(tspec),
                           emit="gains")
    traj, gains = ro.traj.numpy(), bo.out.numpy()
    allow = (np.arange(B) % 2 == 0).astype(np.float32)
    sel = np.stack([bo.stats[0].numpy(), bo.stats[1].numpy(),
                    ro.totals[0].numpy(), allow])
    ref = jax_linesearch(
        _lanes(traj), _lanes(gains), _lanes(x0), _lanes(sel),
        model=jl.lti_lanes(spec), alphas=ALPHAS, reduce_ratio_min=0.0,
        lims=LIMS3, gk=0, gK=M3, emit_echo=False, k_t=2, interpret=True)
    out = fk.linesearch_lanes(*(torch.from_numpy(a) for a in
                                (traj, gains, x0, sel)),
                              model=tmodel, alphas=ALPHAS,
                              reduce_ratio_min=0.0, lims=LIMS3)
    ls, rls = out.ls.numpy(), convert.stream_from_lanes(ref.ls, B)
    np.testing.assert_array_equal(ls[:2], rls[:2])
    np.testing.assert_allclose(ls[4], rls[4], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(out.traj.numpy(),
                               convert.stream_from_lanes(ref.traj, B),
                               rtol=1e-5, atol=1e-6)
    accepted = (ls[1] > 0.5) & (allow > 0.5)
    assert accepted.any() and not accepted.all()


# ---- what the card refuses -----------------------------------------------

@pytest.mark.parametrize("n,m", [(10, 5), (4, 3), (10, 4), (4, 17),
                                 (4, 33)])
def test_unbuilt_m_refused_before_launch(n, m):
    """On tensors off the CPU (the meta device, which needs no card) the
    hand-written LTI's descriptor at an (n, m) with no CUDA instance raises
    NotImplementedError from the instance tables before the kernel library
    is touched; no table holds an m above the kernel library's MAX_M. The
    LTI's own lane objects carry no descriptor at these sizes (the card
    runs their lowering, built for the model's own m), and above the
    ceiling plan.MAX_CONTROLS both routes raise, naming it, before
    anything is lowered or built."""
    from differentialdynamicprogramming_jl_tpu_torch.ops.hopper import plan
    import dataclasses
    spec = tl.random_lti(0, n=n, m=m, T=T, device="cpu")
    hand = tl.device_model(spec)
    meta = dict(device="meta")
    traj = torch.zeros((T, n + m + 1, B), **meta)
    n0 = bk.backward_lanes.launches
    tiles = tl.lti_derivs_tiles(spec)
    lanes = tl.lti_lanes(spec)
    assert tiles.device is None and lanes.device is None
    above = m > plan.MAX_CONTROLS
    for how, dt, model in (
            ("no CUDA kernel", bk.DerivsTiles(fn=tiles.fn, device=hand),
             dataclasses.replace(lanes, device=hand)),
            ("MAX_CONTROLS", tiles, lanes)):
        if how == "MAX_CONTROLS" and not above:
            continue
        how = "MAX_CONTROLS" if above else how
        with pytest.raises(NotImplementedError, match=how):
            bk.backward_lanes(traj, torch.zeros(B, **meta), n=n, m=m,
                              reg_type=1, lims=((-1.0, 1.0),) * m,
                              derivs_tiles=dt)
        with pytest.raises(NotImplementedError, match=how):
            fk.forward_lanes(traj, torch.zeros((T, m + m * n, B), **meta),
                             torch.zeros((n, B), **meta),
                             torch.ones((1, B), **meta), model=model,
                             lims=((-1.0, 1.0),) * m)
    assert bk.backward_lanes.launches == n0
    tables = (list(bk.CUDA_BACKWARD) + list(bk.CUDA_BACKWARD_SO)
              + list(fk.CUDA_MODELS))
    assert max(key[2] for key in tables) <= fk.MAX_M
    assert max(m_ for _, m_, _ in bk.CUDA_PACKED) <= fk.MAX_M
    assert (2, 10, 3, False, False) in bk.CUDA_BACKWARD
    assert (2, 10, 3, False, True) in bk.CUDA_BACKWARD
    assert (2, 10, 3) in fk.CUDA_MODELS
