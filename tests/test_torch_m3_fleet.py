"""m = 3 controls through the port's drivers, on the CPU.

- ``ilqg_batch_lanes`` on an LTI at n=4, m=3, T=6, B=8 with a ±0.05 box
  against JAX's ``ilqg_batch_lanes(interpret=True)`` (as
  ``tests/test_batch_driver.py:137-165``): cost to rtol 2e-4, reasons and
  accepted counts equal, the box binding;
- ``ilqgkl_batch_lanes`` at n=4, m=3 against JAX's: η, satisfied, the
  measured KL and the cost, with ``test_torch_kl.py``'s outcome tolerances;
- ``ilqg_fleet`` and ``ilqgkl_fleet`` bit-equal to their lock-step calls,
  and ``ilqg_batch_sharded`` / ``ilqg_fleet_sharded`` in two gloo processes
  (a file store, no port) bit-equal to the unsharded call of each shard's
  rows; ``gps_rollout_lanes``, ``ilqgkl_batch_sharded`` and
  ``ilqgkl_fleet_sharded`` on a two-shard CPU mesh; ``mpc_rollout_lanes``
  and ``ilqg_iteration_lanes`` at m=3;
- the fleet drivers' aggregate rows (``verbosity > 1``): the text of
  ``lanes_row`` and ``kl_lanes_row`` against JAX's under capfd, and the
  rows the two drivers print.

Inputs are made in numpy from seeded Generators and cast to f32. JAX is
imported only inside the tests that compare with it, so that the sharded
test's children, which import this module, never load it.
"""
import os
import subprocess
import sys

import numpy as np
import torch
from scipy.linalg import expm

from differentialdynamicprogramming_jl_tpu_torch.models import linear as tl
from differentialdynamicprogramming_jl_tpu_torch.ops.hopper import (
    forward_kernel as fk)
from differentialdynamicprogramming_jl_tpu_torch.ops.hopper.pack import (
    from_streams, to_streams)
from differentialdynamicprogramming_jl_tpu_torch.parallel import (
    distributed as D, mesh as M)
from differentialdynamicprogramming_jl_tpu_torch.policy import GaussianPolicy
from differentialdynamicprogramming_jl_tpu_torch.solvers import fleet
from differentialdynamicprogramming_jl_tpu_torch.solvers.batch import (
    ilqg_batch_lanes, ilqg_iteration_lanes, mpc_rollout_lanes)
from differentialdynamicprogramming_jl_tpu_torch.solvers.batch_kl import (
    ilqgkl_batch_lanes)
from differentialdynamicprogramming_jl_tpu_torch.solvers.ilqg import (
    ILQGConfig, default_alphas)
from differentialdynamicprogramming_jl_tpu_torch.solvers.ilqgkl import (
    ILQGKLConfig)
from differentialdynamicprogramming_jl_tpu_torch.utils import printing

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
N, M3, T, B = 4, 3, 6, 8
BOX = 0.05
LIMS = ((-BOX, BOX),) * M3
TIMEOUT = 120
# tests/test_batch_driver.py:150-151, with a longer budget
CFG = dict(alphas=default_alphas(0.2, -3.0, 3), reg_type=1, max_iter=8,
           iter_cap=9)
# the KL tier at m=3: scalar η, a bound that two of the eight lanes meet,
# every iterate at η ≥ 0.4
KLCFG = dict(kl_step=5.0, max_iter=4)


def _arrays(seed=3):
    """The LTI spec (A, B, Q, R as numpy f32), x0s (B, n) and u0s
    (B, T, m)."""
    rng = np.random.default_rng(seed)
    Mm = rng.standard_normal((N, N))
    f = np.float32
    spec = dict(A=expm(0.3 * (Mm - Mm.T)).astype(f),
                B=(0.3 * rng.standard_normal((N, M3))).astype(f),
                Q=(0.5 * np.eye(N)).astype(f), R=(0.05 * np.eye(M3)).astype(f))
    x0s = (np.ones((B, N)) * np.linspace(0.5, 2.0, B)[:, None]).astype(f)
    u0s = (0.3 * rng.standard_normal((B, T, M3))).astype(f)
    return spec, x0s, u0s


def _tspec(spec):
    return tl.LTISpec(**{k: torch.from_numpy(v) for k, v in spec.items()},
                      x0=torch.ones(N), u0=torch.zeros((T, M3)))


def _jspec(spec):
    import jax.numpy as jnp
    from differentialdynamicprogramming_jl_tpu.models import linear as jl
    return jl.LTISpec(**{k: jnp.asarray(v) for k, v in spec.items()},
                      x0=jnp.ones((N,), jnp.float32),
                      u0=jnp.zeros((T, M3), jnp.float32))


def _solve(spec, x0s, u0s, **kw):
    tspec = _tspec(spec)
    return ilqg_batch_lanes(tl.lti_lanes(tspec), None,
                            torch.from_numpy(x0s), torch.from_numpy(u0s),
                            lims=LIMS, cfg=ILQGConfig(**CFG),
                            derivs_tiles=tl.lti_derivs_tiles(tspec), **kw)


def test_batch_lanes_m3_matches_jax():
    import jax.numpy as jnp
    from differentialdynamicprogramming_jl_tpu.models import linear as jl
    from differentialdynamicprogramming_jl_tpu.solvers.batch import (
        ilqg_batch_lanes as jax_batch)
    from differentialdynamicprogramming_jl_tpu.solvers.ilqg import (
        ILQGConfig as JConfig)
    spec, x0s, u0s = _arrays()
    js = _jspec(spec)
    ref = jax_batch(jl.lti_lanes(js), None, jnp.asarray(x0s),
                    jnp.asarray(u0s), lims=LIMS, cfg=JConfig(**CFG),
                    derivs_tiles=jl.lti_derivs_tiles(js), kt_backward=2,
                    kt_forward=2, interpret=True)
    out = _solve(spec, x0s, u0s)
    np.testing.assert_allclose(out.cost_total.numpy(),
                               np.asarray(ref.cost_total), rtol=2e-4)
    for name in ("reason", "n_accepted", "n_iters"):
        np.testing.assert_array_equal(getattr(out, name).numpy(),
                                      np.asarray(getattr(ref, name)),
                                      err_msg=name)
    np.testing.assert_allclose(out.u.numpy(), np.asarray(ref.u), rtol=1e-3,
                               atol=1e-5)
    u = out.u.numpy()
    assert np.all(np.abs(u) <= np.float32(BOX))
    assert np.any(np.abs(u) == np.float32(BOX))       # the box binds
    assert (out.n_accepted > 0).all()


def _kl_inputs(spec, seed=5):
    """The KL tier's inputs at m=3: a pre-roll by the plain K3 (k := u0,
    α=1, no limits), the zero-gain unit-Σ previous policy with k = u, fx
    and cost0, as tensors."""
    rng = np.random.default_rng(seed)
    tspec = _tspec(spec)
    x0 = torch.tensor(np.ones((B, N)) * np.linspace(0.5, 2.0, B)[:, None]
                      + 0.1 * rng.standard_normal((B, N)),
                      dtype=torch.float32)
    u0 = torch.tensor(0.3 * rng.standard_normal((B, T, M3)),
                      dtype=torch.float32)
    gains = torch.cat([to_streams(u0), torch.zeros((T, M3 * N, B))], dim=1)
    ro = fk.forward_lanes_ref(torch.zeros((T, N + M3 + 1, B)), gains,
                              x0.T.contiguous(), torch.ones((1, B)),
                              model=tl.lti_lanes(tspec), lims=None,
                              emit_traj=True)
    eye = torch.eye(M3).expand(B, T, M3, M3).contiguous()
    prev = GaussianPolicy(K=torch.zeros((B, T, M3, N)),
                          k=from_streams(ro.traj[:, N:N + M3], (M3,)),
                          sigma=eye, sigma_inv=eye.clone())
    fx = torch.from_numpy(spec["A"]).expand(B, T, N, N).contiguous()
    return (from_streams(ro.traj[:, :N], (N,)), prev, fx, ro.totals[0])


def _kl_solve(spec, inputs, cfg=KLCFG, **kw):
    tspec = _tspec(spec)
    return ilqgkl_batch_lanes(tl.lti_lanes(tspec), tl.lti_derivs_tiles(tspec),
                              *inputs, cfg=ILQGKLConfig(**cfg), **kw)


def test_kl_batch_lanes_m3_matches_jax():
    import jax.numpy as jnp
    from differentialdynamicprogramming_jl_tpu.models import linear as jl
    from differentialdynamicprogramming_jl_tpu.policy import (
        GaussianPolicy as JPolicy)
    from differentialdynamicprogramming_jl_tpu.solvers import batch_kl as jkl
    from differentialdynamicprogramming_jl_tpu.solvers.ilqgkl import (
        ILQGKLConfig as JKLConfig)
    from differentialdynamicprogramming_jl_tpu_torch import convert
    from test_torch_kl import check_outcomes
    spec, _, _ = _arrays()
    inputs = _kl_inputs(spec)
    x, prev, fx, cost0 = inputs
    js = _jspec(spec)
    ref = jkl.ilqgkl_batch_lanes(
        jl.lti_lanes(js), jl.lti_derivs_tiles(js), jnp.asarray(x.numpy()),
        JPolicy(*(jnp.asarray(a.numpy()) for a in prev)),
        jnp.asarray(fx.numpy()), jnp.asarray(cost0.numpy()),
        cfg=JKLConfig(**KLCFG), kt=2, interpret=True)
    out = _kl_solve(spec, inputs)
    r, o = convert.result_to_numpy(ref), convert.result_to_numpy(out)
    check_outcomes(r, o)
    assert 0 < o["satisfied"].sum() < B
    for name in ("K", "sigma", "sigma_inv"):
        a, b = o["policy"][name], r["policy"][name]
        np.testing.assert_allclose(a, b, rtol=1e-4,
                                   atol=1e-4 * np.abs(b).max(), err_msg=name)


FIELDS = ("cost_total", "reason", "n_accepted", "n_iters", "x", "u", "Vx",
          "Vxx", "lam", "dlam", "g_norm")
KL_FIELDS = ("cost_total", "x", "u", "eta", "divergence", "satisfied",
             "n_iters", "pd_failed")


def _same(a, b, fields):
    for name in fields:
        assert torch.equal(getattr(a, name), getattr(b, name)), name
    for name in a.policy._fields:
        assert torch.equal(getattr(a.policy, name),
                           getattr(b.policy, name)), name


def test_fleets_m3_match_lockstep():
    """chunk_iters=2, growth 2 (iLQG) and chunks of 2 iterations (KL):
    every field of every lane as the lock-step call gives it."""
    spec, x0s, u0s = _arrays()
    tspec = _tspec(spec)
    kw = dict(lims=LIMS, cfg=ILQGConfig(**CFG),
              derivs_tiles=tl.lti_derivs_tiles(tspec))
    args = (tl.lti_lanes(tspec), None, torch.from_numpy(x0s),
            torch.from_numpy(u0s))
    ref = ilqg_batch_lanes(*args, **kw)
    fl = fleet.ilqg_fleet(*args, chunk_iters=2, chunk_growth=2.0, **kw)
    assert len(set(ref.n_iters.tolist())) > 1      # lanes stop apart
    _same(fl, ref, FIELDS)
    inputs = _kl_inputs(spec)
    kl_args = (tl.lti_lanes(tspec), tl.lti_derivs_tiles(tspec)) + inputs
    kcfg = ILQGKLConfig(**KLCFG)
    kref = ilqgkl_batch_lanes(*kl_args, cfg=kcfg)
    kfl = fleet.ilqgkl_fleet(*kl_args, cfg=kcfg, chunk_iters=2,
                             chunk_growth=1.0)
    _same(kfl, kref, KL_FIELDS)


def test_gps_and_sharded_kl_m3():
    """The KL tier's other entries at m=3: two outer iterations of
    gps_rollout_lanes, the first equal to one ilqgkl_batch_lanes call; and
    ilqgkl_batch_sharded / ilqgkl_fleet_sharded on a two-shard CPU mesh,
    each shard's rows those of the unsharded call of its rows."""
    from differentialdynamicprogramming_jl_tpu_torch.solvers.batch_kl import (
        gps_rollout_lanes)
    spec, _, _ = _arrays()
    tspec = _tspec(spec)
    model, tiles = tl.lti_lanes(tspec), tl.lti_derivs_tiles(tspec)
    x, prev, fx, cost0 = _kl_inputs(spec)
    cfg = ILQGKLConfig(**KLCFG)
    one = ilqgkl_batch_lanes(model, tiles, x, prev, fx, cost0, cfg=cfg)
    xg, pol, per = gps_rollout_lanes(model, tiles, x, prev, cost0,
                                     lambda x_, u_: fx, 2, cfg=cfg)
    assert torch.equal(per[0][0], one.cost_total)
    assert torch.equal(per[1][0], one.eta)
    assert xg.shape == (B, T, N) and pol.K.shape == (B, T, M3, N)
    assert torch.isfinite(per[0]).all()
    mesh = M.make_mesh(2, device="cpu")
    kl_args = (model, tiles, x, prev, fx, cost0)
    sharded = M.ilqgkl_batch_sharded(*kl_args, cfg=cfg, mesh=mesh)
    fl = fleet.ilqgkl_fleet_sharded(*kl_args, cfg=cfg, chunk_iters=2,
                                    mesh=mesh)
    half = B // 2
    for j in range(2):
        rows = slice(j * half, (j + 1) * half)
        ref = ilqgkl_batch_lanes(model, tiles, x[rows],
                                 GaussianPolicy(*(a[rows] for a in prev)),
                                 fx[rows], cost0[rows], cfg=cfg)
        for res in (sharded, fl):
            for name in KL_FIELDS:
                assert torch.equal(getattr(res, name)[rows],
                                   getattr(ref, name)), name
            assert torch.equal(res.policy.K[rows], ref.policy.K)


def test_mpc_and_iteration_m3():
    """The MPC entries at m=3: two receding-horizon steps on a plant that is
    the model, controls inside the box; one ilqg_iteration_lanes step on a
    K3 stream, the same as the first iteration of the lock-step solver's
    K1 and K2 (λ aside)."""
    spec, x0s, u0s = _arrays()
    tspec = _tspec(spec)
    model, tiles = tl.lti_lanes(tspec), tl.lti_derivs_tiles(tspec)
    A, Bm = torch.from_numpy(spec["A"]), torch.from_numpy(spec["B"])
    cfg = ILQGConfig(**CFG)
    x, u, xs, us, costs = mpc_rollout_lanes(
        model, None, torch.from_numpy(x0s), torch.from_numpy(u0s),
        lambda x_, u_: x_ @ A.T + u_ @ Bm.T, 2, lims=LIMS, cfg=cfg,
        derivs_tiles=tiles)
    assert us.shape == (2, B, M3) and u.shape == (B, T, M3)
    assert torch.isfinite(costs).all() and (us.abs() <= BOX).all()
    step = ilqg_iteration_lanes(model, None, LIMS, cfg, derivs_tiles=tiles)
    ro = fk.forward_lanes(torch.zeros((T, N + M3, B)), torch.cat(
        [to_streams(torch.from_numpy(u0s)), torch.zeros((T, M3 * N, B))], 1),
        torch.from_numpy(x0s).T.contiguous(), torch.ones((1, B)),
        model=model, lims=LIMS, emit_traj=True)
    traj, tot, lam = step(ro.traj.clone(), ro.totals[0],
                          torch.full((B,), cfg.lam))
    assert traj.shape == (T, N + M3 + 1, B) and torch.isfinite(tot).all()
    assert (traj[:, N:N + M3].abs() <= BOX).all()
    assert (tot <= ro.totals[0]).all()


def _worker(rank: int, world: int, store: str, out: str) -> None:
    """One process of the gloo group: its half of the rows on one CPU
    shard, saved for the parent."""
    D.init_distributed(f"file://{store}", num_processes=world,
                       process_id=rank)
    try:
        mesh = M.make_mesh(1, device="cpu")
        spec, x0s, u0s = _arrays()
        tspec = _tspec(spec)
        rows = slice(rank * B // world, (rank + 1) * B // world)
        kw = dict(lims=LIMS, cfg=ILQGConfig(**CFG),
                  derivs_tiles=tl.lti_derivs_tiles(tspec), mesh=mesh)
        args = (tl.lti_lanes(tspec), None, torch.from_numpy(x0s[rows]),
                torch.from_numpy(u0s[rows]))
        batch, stats = M.ilqg_batch_sharded(*args, reduce_stats=True, **kw)
        fl = fleet.ilqg_fleet_sharded(*args, chunk_iters=2, chunk_growth=2.0,
                                      **kw)
        assert "jax" not in sys.modules
        got = {f"{name}.{f}": getattr(r, f).numpy() for name, r in
               (("batch", batch), ("fleet", fl)) for f in FIELDS}
        got.update({f"{name}.K": r.policy.K.numpy() for name, r in
                    (("batch", batch), ("fleet", fl))})
        np.savez(out, stats=stats.numpy(), **got)
    finally:
        torch.distributed.destroy_process_group()


def test_sharded_m3_two_processes_match_one(tmp_path):
    """Two gloo processes, each solving half the rows: ilqg_batch_sharded
    and ilqg_fleet_sharded give each process's rows as the unsharded call
    of those rows does, bit for bit; the stats are the sums over the whole
    fleet."""
    code = ("import sys; sys.path.insert(0, {here!r}); "
            "from test_torch_m3_fleet import _worker; "
            "_worker({rank}, 2, {store!r}, {out!r})")
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    store = str(tmp_path / "store")
    outs = [str(tmp_path / f"rank{r}.npz") for r in range(2)]
    procs = [subprocess.Popen(
        [sys.executable, "-c", code.format(here=HERE, rank=r, store=store,
                                           out=outs[r])],
        cwd=str(tmp_path), env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(2)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]
    spec, x0s, u0s = _arrays()
    full = _solve(spec, x0s, u0s)
    for rank, path in enumerate(outs):
        got = np.load(path)
        rows = slice(rank * B // 2, (rank + 1) * B // 2)
        ref = _solve(spec, x0s[rows], u0s[rows])
        for name in ("batch", "fleet"):
            for f in FIELDS:
                np.testing.assert_array_equal(got[f"{name}.{f}"],
                                              getattr(ref, f).numpy(),
                                              err_msg=f"{name}.{f}")
            np.testing.assert_array_equal(got[f"{name}.K"],
                                          ref.policy.K.numpy())
        solved = int(((full.reason == 1) | (full.reason == 2)).sum())
        np.testing.assert_allclose(got["stats"][0],
                                   full.cost_total.sum().item(), rtol=1e-6)
        assert list(got["stats"][1:]) == [int(full.n_iters.sum()), solved]


ROWS = [  # it, active, cost, accept / eta, log10 argument, grad / divergence
    (1, 8, 12.345678, 0.625, 0.001, 0.0321),
    (2, 5, 3.5e-7, 1.0, 0.0, 1.5e5),
    (11, 1, 1.25e4, 0.0, 1e15, 2.5e-12),
]


def test_lanes_rows_match_jax(capfd):
    """The fleet-aggregate rows (JAX utils/printing.py:124-150) with the
    same f32 values: the same text, header rows and a zero's -inf
    included."""
    import jax
    import jax.numpy as jnp
    from differentialdynamicprogramming_jl_tpu.utils import printing as jpr
    f32 = np.float32
    for it, n_act, c, p, l, g in ROWS:
        jpr.lanes_row(jnp.int32(it), jnp.int32(n_act), jnp.float32(c),
                      jnp.float32(p), jnp.float32(l), jnp.float32(g))
        jpr.kl_lanes_row(jnp.int32(it), jnp.int32(n_act), jnp.float32(c),
                         jnp.float32(l), jnp.float32(g), jnp.float32(p))
    jax.effects_barrier()
    want = capfd.readouterr().out
    for it, n_act, c, p, l, g in ROWS:
        printing.lanes_row(torch.tensor(it), torch.tensor(n_act),
                           torch.tensor(f32(c)), torch.tensor(f32(p)),
                           torch.tensor(f32(l)), torch.tensor(f32(g)))
        printing.kl_lanes_row(torch.tensor(it), torch.tensor(n_act),
                              torch.tensor(f32(c)), torch.tensor(f32(l)),
                              torch.tensor(f32(g)), torch.tensor(f32(p)))
    got = capfd.readouterr().out
    assert got == want
    assert "-inf" in got and got.count("iteration") == 4


def test_drivers_print_rows_m3(capsys):
    """verbosity 2: ilqg_batch_lanes and ilqgkl_batch_lanes print a header
    and one aggregate row an iteration, the row's active count that of the
    scenarios not yet done."""
    spec, x0s, u0s = _arrays()
    res = _solve(spec, x0s, u0s, max_steps=4)
    cfg = dict(CFG, verbosity=2)
    tspec = _tspec(spec)
    ilqg_batch_lanes(tl.lti_lanes(tspec), None, torch.from_numpy(x0s),
                     torch.from_numpy(u0s), lims=LIMS, cfg=ILQGConfig(**cfg),
                     derivs_tiles=tl.lti_derivs_tiles(tspec), max_steps=4)
    lines = capsys.readouterr().out.splitlines()
    iters = int(res.n_iters.max())
    assert lines[0].startswith("iteration   active      mean cost")
    assert len(lines) == 1 + iters
    active = [int(r.split()[1]) for r in lines[1:]]
    assert active == [int((res.n_iters >= i).sum())
                      for i in range(1, iters + 1)]
    kres = _kl_solve(spec, _kl_inputs(spec), dict(KLCFG, verbosity=2))
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("iteration   active      est. cost")
    assert len(lines) == 1 + int(kres.n_iters.max())
