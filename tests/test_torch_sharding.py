"""The port's sharded entries and its multi-process layer
(``parallel/mesh.py``, ``parallel/distributed.py``) on the CPU:

- two processes in one gloo group (``init_distributed`` on a file store in
  ``tmp_path``, so no port is needed), each with two CPU shards: every
  sharded entry's rows against the one-process unsharded call of each
  shard's rows, and the fields a lane's solve gives in any batch against
  one call of all rows; ``reduce_stats`` against the sums over both
  processes' rows; the ``distribute_batch`` / ``local_slice`` round
  trip. The children import
  torch and the port only, never JAX, and each is joined with a timeout of
  TIMEOUT s that fails the test;
- a four-shard mesh in one process against the unsharded calls;
- ``ilqg_sharded`` against JAX's ``ilqg_sharded`` over its eight virtual
  devices on the same f64 inputs, as ``tests/test_sharding.py:31-41`` calls
  it.

Rows are compared bit for bit. A lane's trajectory, costs, counts and η do
not depend on the batch it is solved in (the solvers' glue sums over T in
one fixed order, ``ops/hopper/pack.py::mean_t``); its Vx, Vxx and policy do
(see ``PER_LANE``), so those are held to the unsharded call of the shard's
own rows. The statistics are sums over the lanes in another association
than a one-process sum: costs to rtol 1e-6, counts exactly.

This module imports JAX only inside the test that compares with it, so that
the children can import it.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from differentialdynamicprogramming_jl_tpu_torch.models import pendcart as tpc
from differentialdynamicprogramming_jl_tpu_torch.ops.forward import (
    forward_pass)
from differentialdynamicprogramming_jl_tpu_torch.parallel import (
    distributed as D, mesh as M)
from differentialdynamicprogramming_jl_tpu_torch.policy import GaussianPolicy
from differentialdynamicprogramming_jl_tpu_torch.solvers import fleet
from differentialdynamicprogramming_jl_tpu_torch.solvers.batch import (
    ilqg_batch_lanes)
from differentialdynamicprogramming_jl_tpu_torch.solvers.batch_kl import (
    ilqgkl_batch_lanes)
from differentialdynamicprogramming_jl_tpu_torch.solvers.ilqg import (
    ILQGConfig, default_alphas)
from differentialdynamicprogramming_jl_tpu_torch.solvers.ilqgkl import (
    ILQGKLConfig)

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
B, T, TKL = 8, 10, 10
TIMEOUT = 120
SPEC = tpc.PendCartSpec()
LIMS = ((-5.0, 5.0),)
CFG = ILQGConfig(alphas=default_alphas(0.2, -3.0, 6), reg_type=2,
                 lam_max=1e15, max_iter=30)
KLCFG = ILQGKLConfig(kl_step=0.5, max_iter=8, gd_alpha=0.05)
GCFG = ILQGConfig(alphas=default_alphas(0.2, -3.0, 6), reg_type=2,
                  lam_max=1e15, max_iter=4)
ILQG_FIELDS = ("x", "u", "cost", "cost_total", "n_iters", "n_accepted",
               "reason", "lam", "Vx", "Vxx")
KL_FIELDS = ("x", "u", "cost_total", "eta", "divergence", "satisfied",
             "n_iters", "bracket")


def _inputs():
    """The fleet's rows, from numpy seeds: the iLQG x0 (spread 0.4 on angle
    and cart) and u0; the KL pre-roll, previous policy, fx and cost0; the
    generic tier's f64 x0s (Euler pendcart, T=10)."""
    rng = np.random.default_rng(0)
    x0 = torch.tensor(np.array([np.pi - 0.6, 0, 0, 0])[None, :]
                      + 0.4 * rng.standard_normal((B, 4))
                      * np.array([1, 1, 0, 0]), dtype=torch.float32)
    u0 = torch.zeros((B, T, 1))
    prob = tpc.make_pendcart_problem(SPEC, derivs="euler", device="cpu")
    kx0 = torch.tensor(np.array([np.pi - 0.6, 0, 0, 0])[None, :]
                       + 0.1 * rng.standard_normal((B, 4)),
                       dtype=torch.float32)
    ku0 = torch.tensor(0.2 * rng.standard_normal((B, TKL, 1)),
                       dtype=torch.float32)
    ro = forward_pass(prob, kx0, ku0)
    prev = GaussianPolicy(*(a.expand((B,) + a.shape).contiguous() for a in
                            GaussianPolicy.zeros(TKL, 4, 1, device="cpu")))
    kl = (ro.x, prev._replace(k=ro.u), prob.derivs(ro.x, ro.u).fx,
          ro.cost.sum(-1))
    gx = torch.tensor(np.array([np.pi, 0, 0, 0])[None, :]
                      + 0.2 * rng.standard_normal((B, 4))
                      * np.array([1, 0, 0, 0]), dtype=torch.float64)
    return x0, u0, kl, gx


def _generic_problem():
    return tpc.make_pendcart_problem(SPEC, derivs="euler",
                                     dtype=torch.float64, device="cpu")


def _solve_all(mesh, x0, u0, kl, gx):
    """Every sharded entry on these rows: {name: (result, stats or None)}."""
    model, tiles = tpc.pendcart_lanes(SPEC), tpc.pendcart_derivs_tiles(SPEC)
    kw = dict(lims=LIMS, cfg=CFG, derivs_tiles=tiles, mesh=mesh)
    kl_args = (model, tiles) + tuple(kl)
    gu = torch.zeros((gx.shape[0], T, 1), dtype=torch.float64)
    return dict(
        batch=M.ilqg_batch_sharded(model, None, x0, u0, reduce_stats=True,
                                   **kw),
        fleet=(fleet.ilqg_fleet_sharded(model, None, x0, u0, chunk_iters=2,
                                        chunk_growth=2.0, **kw), None),
        kl=M.ilqgkl_batch_sharded(*kl_args, cfg=KLCFG, mesh=mesh,
                                  reduce_stats=True),
        kl_fleet=(fleet.ilqgkl_fleet_sharded(*kl_args, cfg=KLCFG,
                                             chunk_iters=5, mesh=mesh), None),
        generic=M.ilqg_sharded(_generic_problem(), gx, gu,
                               lims=[[-10.0, 10.0]], cfg=GCFG, mesh=mesh,
                               reduce_stats=True))


def _references(x0, u0, kl, gx, shards=1):
    """The unsharded calls of the same rows, one call for each of
    ``shards`` equal blocks of rows, joined."""
    model, tiles = tpc.pendcart_lanes(SPEC), tpc.pendcart_derivs_tiles(SPEC)
    kw = dict(lims=LIMS, cfg=CFG, derivs_tiles=tiles)

    def solve(x0, u0, kl, gx):
        kl_args = (model, tiles) + tuple(kl)
        gu = torch.zeros((gx.shape[0], T, 1), dtype=torch.float64)
        return dict(
            batch=ilqg_batch_lanes(model, None, x0, u0,
                                   max_steps=CFG.cap() - 1, **kw),
            fleet=fleet.ilqg_fleet(model, None, x0, u0, chunk_iters=2,
                                   chunk_growth=2.0, **kw),
            kl=ilqgkl_batch_lanes(*kl_args, cfg=KLCFG),
            kl_fleet=fleet.ilqgkl_fleet(*kl_args, cfg=KLCFG, chunk_iters=5),
            generic=M.ilqg_batched(_generic_problem(), gx, gu,
                                   lims=[[-10.0, 10.0]], cfg=GCFG))

    n = B // shards
    parts = [solve(x0[j * n:(j + 1) * n], u0[j * n:(j + 1) * n],
                   tuple(GaussianPolicy(*(a[j * n:(j + 1) * n] for a in v))
                         if isinstance(v, GaussianPolicy)
                         else v[j * n:(j + 1) * n] for v in kl),
                   gx[j * n:(j + 1) * n]) for j in range(shards)]
    return {name: M.concat_results([p[name] for p in parts], "cpu")
            for name in parts[0]}


FIELDS = dict(batch=ILQG_FIELDS, fleet=ILQG_FIELDS, kl=KL_FIELDS,
              kl_fleet=KL_FIELDS, generic=("x", "u", "cost", "n_iters",
                                           "reason", "lam"))
# what a lane's solve gives whatever batch it is in: the lock-step solver
# replays the final backward pass of a lane done before the batch's last
# iteration on its accepted trajectory, and of a lane done on it on its
# last entry (JAX solvers/batch.py:583-593), so Vx, Vxx and the policy
# depend on which lanes share a shard
PER_LANE = ("x", "u", "cost", "cost_total", "n_iters", "n_accepted",
            "reason", "lam", "eta", "divergence", "satisfied", "bracket")


def _stats(name, r):
    """What reduce_stats sums, for the lanes of result r (JAX
    mesh.py:131-139, :181-185, :262-266)."""
    if name == "kl":
        return [r.cost_total.sum().item(), int(r.n_iters.sum()),
                int(r.satisfied.sum())]
    solved = int(((r.reason == 1) | (r.reason == 2)).sum())
    cost = r.cost.sum() if name == "generic" else r.cost_total.sum()
    return [cost.item(), int(r.n_iters.sum()), solved]


def _rows(res, sl=slice(None)):
    """The compared fields of each result, as numpy, rows ``sl``."""
    out = {}
    for name, (r, st) in res.items():
        for f in FIELDS[name]:
            out[f"{name}.{f}"] = getattr(r, f)[sl].numpy()
        out[f"{name}.K"] = r.policy.K[sl].numpy()
        if st is not None:
            out[f"{name}.stats"] = st.numpy()
    return out


def _worker(rank: int, world: int, store: str, out: str) -> None:
    """One process of the gloo group: solve its half of the rows on a mesh
    of two CPU shards and save them, with the round trips' checks."""
    D.init_distributed(f"file://{store}", num_processes=world,
                       process_id=rank)
    try:
        assert D.is_multiprocess()
        assert torch.distributed.get_backend() == "gloo"
        mesh = M.make_mesh(2, device="cpu")
        assert (mesh.rank, mesh.world_size) == (rank, world)
        assert D.global_mesh().devices == (torch.device("cpu"),)
        x0, u0, kl, gx = _inputs()
        rows = slice(rank * B // world, (rank + 1) * B // world)
        shards = D.distribute_batch(x0[rows].numpy(), mesh)
        assert len(shards) == 2 and all(s.shape[0] == B // world // 2
                                        for s in shards)
        np.testing.assert_array_equal(D.local_slice(shards),
                                      x0[rows].numpy())
        rep = D.replicate(np.arange(3.0), mesh)
        assert len(rep) == 2 and all(torch.equal(r, rep[0]) for r in rep)
        mine = _solve_all(mesh, D.distribute_batch(x0[rows], mesh),
                          u0[rows],
                          tuple(GaussianPolicy(*(a[rows] for a in v))
                                if isinstance(v, GaussianPolicy) else
                                v[rows] for v in kl), gx[rows])
        assert "jax" not in sys.modules
        np.savez(out, **_rows(mine))
    finally:
        torch.distributed.destroy_process_group()


def test_two_processes_match_one(tmp_path):
    """Two gloo processes, each solving half the rows on two CPU shards:
    each process's rows are the one-process calls' rows, and the stats are
    the sums over the whole fleet, the same on both."""
    code = ("import sys; sys.path.insert(0, {here!r}); "
            "from test_torch_sharding import _worker; "
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
    inp = _inputs()
    ref = _references(*inp, shards=4)
    whole = _rows({name: (r, None) for name, r in
                   _references(*inp).items()})
    full = {name: _stats(name, ref[name]) for name in ("batch", "kl",
                                                       "generic")}
    for rank, path in enumerate(outs):
        got = np.load(path)
        rows = slice(rank * B // 2, (rank + 1) * B // 2)
        want = _rows({name: (r, None) for name, r in ref.items()}, rows)
        for key, v in want.items():
            np.testing.assert_array_equal(got[key], v, err_msg=key)
            if key.split(".")[1] in PER_LANE:
                np.testing.assert_array_equal(got[key], whole[key][rows],
                                              err_msg=key)
        for name in ("batch", "kl", "generic"):
            st = got[f"{name}.stats"]
            np.testing.assert_allclose(st[0], full[name][0], rtol=1e-6)
            assert list(st[1:]) == full[name][1:], (name, st, full[name])


def test_four_shards_in_one_process():
    """make_mesh(4, device="cpu"): four shards in this process, no process
    group; rows and stats against the unsharded calls (stats summed over
    the shards, in shard order)."""
    mesh = M.make_mesh(4, device="cpu")
    assert mesh.group is None and len(mesh.devices) == 4
    inp = _inputs()
    have = _rows(_solve_all(mesh, *inp))
    ref = _references(*inp, shards=4)
    want = _rows({name: (r, None) for name, r in ref.items()})
    whole = _rows({name: (r, None) for name, r in
                   _references(*inp).items()})
    for key, v in want.items():
        np.testing.assert_array_equal(have[key], v, err_msg=key)
        if key.split(".")[1] in PER_LANE:
            np.testing.assert_array_equal(have[key], whole[key], err_msg=key)
    for name in ("batch", "kl", "generic"):
        st, full = have[f"{name}.stats"], _stats(name, ref[name])
        np.testing.assert_allclose(st[0], full[0], rtol=1e-6)
        assert list(st[1:]) == full[1:], (name, st, full)
    with pytest.raises(AssertionError, match="divide"):
        M.ilqg_batch_sharded(tpc.pendcart_lanes(SPEC), None, inp[0][:6],
                             inp[1][:6], lims=LIMS, cfg=CFG, mesh=mesh,
                             derivs_tiles=tpc.pendcart_derivs_tiles(SPEC))


def test_ilqg_sharded_matches_jax():
    """tests/test_sharding.py:31-41's call on the port: random_lti(PRNGKey(0),
    n=6, m=2, T=60) in f64, B=16, max_iter 20, JAX over its eight virtual
    devices and the port over eight CPU shards; u to atol 1e-9, costs to
    rtol 1e-9 (the generic tier's parity tolerance), reasons equal."""
    import jax
    import jax.numpy as jnp
    from differentialdynamicprogramming_jl_tpu import ILQGConfig as JCFG
    from differentialdynamicprogramming_jl_tpu.models import linear as jl
    from differentialdynamicprogramming_jl_tpu.parallel import mesh as jm
    from differentialdynamicprogramming_jl_tpu_torch import convert
    from differentialdynamicprogramming_jl_tpu_torch.models import (
        linear as tl)
    Tn, Bn = 60, 16
    spec = jl.random_lti(jax.random.PRNGKey(0), n=6, m=2, T=Tn,
                         dtype=jnp.float64)
    x0s = jnp.tile(spec.x0, (Bn, 1)) * jnp.linspace(0.5, 2.0, Bn)[:, None]
    u0s = jnp.tile(spec.u0, (Bn, 1, 1))
    ref, jst = jm.ilqg_sharded(jl.make_lti_problem(spec, Tn), x0s, u0s,
                               cfg=JCFG(max_iter=20), mesh=jm.make_mesh(),
                               reduce_stats=True)
    tspec = convert.lti_spec_from_jax(spec, torch.float64, "cpu")
    out, st = M.ilqg_sharded(
        tl.make_lti_problem(tspec, Tn), torch.tensor(np.asarray(x0s)),
        torch.tensor(np.asarray(u0s)), cfg=ILQGConfig(max_iter=20),
        mesh=M.make_mesh(8, device="cpu"), reduce_stats=True)
    np.testing.assert_allclose(out.u.numpy(), np.asarray(ref.u), atol=1e-9)
    np.testing.assert_allclose(out.cost.sum(-1).numpy(),
                               np.asarray(jnp.sum(ref.cost, -1)), rtol=1e-9)
    np.testing.assert_array_equal(out.reason.numpy(), np.asarray(ref.reason))
    np.testing.assert_allclose(st.numpy(), np.asarray(jst), rtol=1e-9)


@pytest.mark.parametrize("module, name", [
    ("mesh", "make_mesh"), ("mesh", "ilqg_sharded"),
    ("mesh", "ilqg_batch_sharded"), ("mesh", "ilqgkl_batch_sharded"),
    ("distributed", "init_distributed"), ("distributed", "global_mesh"),
    ("distributed", "distribute_batch"), ("distributed", "replicate"),
    ("distributed", "local_slice")])
def test_entries_take_jax_signatures(module, name):
    """Every parameter of JAX's function is one of the port's, in JAX's
    order and kind, with JAX's default where it is a plain value."""
    import importlib
    import inspect
    jmod = importlib.import_module(
        f"differentialdynamicprogramming_jl_tpu.parallel.{module}")
    tmod = M if module == "mesh" else D
    jp = inspect.signature(getattr(jmod, name)).parameters
    tp = inspect.signature(getattr(tmod, name)).parameters
    assert list(jp) == [p for p in tp if p in jp], (list(jp), list(tp))
    for p in jp:
        assert tp[p].kind == jp[p].kind, p
        if isinstance(jp[p].default, (int, float, str, bool, type(None))):
            assert tp[p].default == jp[p].default, p
