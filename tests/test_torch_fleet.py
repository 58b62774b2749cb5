"""The port's iLQG fleet scheduler (``solvers/fleet.py::ilqg_fleet``) on the
CPU, with the plain versions of the kernels:

- against the port's lock-step ``ilqg_batch_lanes`` with ``chunk_iters=2``
  at JAX's tolerances (``tests/test_fleet.py:34-44``), and bit for bit:
  static limits, ``PendCartParam`` with per-scenario ``params`` and limits,
  and ``pendcart_packed_derivs``; on a fleet whose scenarios finish at
  different iterations, so that the compaction and the replay of lanes
  that end on a chunk's last step are both run;
- the stitched trace against lock-step's trace (rows 1..n_iters);
- ``_stitch_traces`` against JAX's on random numpy inputs;
- one call of JAX's ``ilqg_fleet`` (interpret mode, k_t=2, ≈20 s here) on
  the port's inputs, compared by outcome, and its ``verbose`` lines
  against the port's, text for text.

Bit-equality holds on the CPU: the solvers' glue keeps a lane's bits
independent of the batch it is solved in (``ops/hopper/pack.py::mean_t``;
``torch.mean`` over T picks its summation order from the shape, on the CPU
as on the card), and these inputs meet no other op whose result depends on
a lane's position. Inputs are made in numpy f64 from a seeded Generator and
cast to f32.
"""
import numpy as np
import pytest
import torch

from differentialdynamicprogramming_jl_tpu_torch.models import pendcart as tpc
from differentialdynamicprogramming_jl_tpu_torch.solvers import fleet
from differentialdynamicprogramming_jl_tpu_torch.solvers.batch import (
    BatchTrace, ilqg_batch_lanes)
from differentialdynamicprogramming_jl_tpu_torch.solvers.ilqg import (
    ILQGConfig, default_alphas)

B, T = 8, 6
SPEC = tpc.PendCartSpec()
LIMS = ((-5.0, 5.0),)
# JAX's fleet test settings (tests/test_fleet.py:28-29)
CFG = ILQGConfig(alphas=default_alphas(0.2, -3.0, 3), reg_type=2,
                 max_iter=6, iter_cap=10)
# a fleet whose scenarios stop at 2 to 13 iterations: x0 spread 0.4 on angle
# and cart position, as tools/bench_fleet.py's, at T=10 and max_iter 30
HT = 10
HCFG = ILQGConfig(alphas=default_alphas(0.2, -3.0, 6), reg_type=2,
                  lam_max=1e15, max_iter=30)


def _inputs(spread=0.1, seed=0):
    """tests/test_fleet.py's inputs, drawn in numpy: x0 = default_x0 +
    spread·N(0,1), u0 = 0.1·N(0,1)."""
    rng = np.random.default_rng(seed)
    x0s = (np.array([np.pi - 0.6, 0, 0, 0])[None, :]
           + spread * rng.standard_normal((B, 4)))
    u0s = 0.1 * rng.standard_normal((B, T, 1))
    return (torch.tensor(x0s, dtype=torch.float32),
            torch.tensor(u0s, dtype=torch.float32))


def _hetero_inputs():
    rng = np.random.default_rng(0)
    x0s = (np.array([np.pi - 0.6, 0, 0, 0])[None, :]
           + 0.4 * rng.standard_normal((B, 4)) * np.array([1, 1, 0, 0]))
    return (torch.tensor(x0s, dtype=torch.float32),
            torch.zeros((B, HT, 1), dtype=torch.float32))


def _jax_tolerances(fl, ref):
    """tests/test_fleet.py:34-44."""
    np.testing.assert_allclose(fl.cost_total.numpy(), ref.cost_total.numpy(),
                               rtol=2e-4)
    np.testing.assert_array_equal(fl.reason.numpy(), ref.reason.numpy())
    np.testing.assert_array_equal(fl.n_accepted.numpy(),
                                  ref.n_accepted.numpy())
    np.testing.assert_allclose(fl.u.numpy(), ref.u.numpy(), atol=1e-4)
    assert np.all(fl.n_iters.numpy() >= ref.n_iters.numpy())


def _bits(fl, ref):
    for name in ("cost_total", "reason", "n_accepted", "n_iters", "x", "u",
                 "Vx", "Vxx", "lam", "dlam", "g_norm"):
        assert torch.equal(getattr(fl, name), getattr(ref, name)), name
    for name in ref.policy._fields:
        assert torch.equal(getattr(fl.policy, name),
                           getattr(ref.policy, name)), name


def _case(kind):
    """(model, packed_derivs, x0s, u0s, keywords) of one fleet case."""
    if kind == "param":
        rng = np.random.default_rng(5)
        x0s, u0s = _hetero_inputs()
        params = np.stack([rng.uniform(0.25, 0.55, B),
                           rng.uniform(0.5, 1.5, B)], axis=1)
        h = np.linspace(0.8, 6.0, B)
        lims = np.stack([-h, h], axis=-1)[:, None, :]
        return (tpc.pendcart_lanes_param(SPEC), None, x0s, u0s, dict(
            lims=torch.tensor(lims, dtype=torch.float32), cfg=HCFG,
            derivs_tiles=tpc.pendcart_derivs_tiles_param(SPEC),
            params=torch.tensor(params, dtype=torch.float32)))
    x0s, u0s = _hetero_inputs()
    if kind == "packed":
        return (tpc.pendcart_lanes(SPEC), tpc.pendcart_packed_derivs(SPEC),
                x0s, u0s, dict(lims=LIMS, cfg=HCFG))
    return (tpc.pendcart_lanes(SPEC), None, x0s, u0s,
            dict(lims=LIMS, cfg=HCFG, derivs_tiles=tpc.pendcart_derivs_tiles(
                SPEC)))


@pytest.mark.parametrize("kind", ["static", "param", "packed"])
def test_fleet_matches_lockstep(kind, capsys):
    """chunk_iters=2, growth 2: the chunks cover iterations 1-2, 3-6, 7-14;
    lanes finish inside chunks and on their last step, and later chunks
    hold fewer lanes."""
    model, packed, x0s, u0s, kw = _case(kind)
    ref = ilqg_batch_lanes(model, packed, x0s, u0s, **kw)
    fl = fleet.ilqg_fleet(model, packed, x0s, u0s, chunk_iters=2,
                          chunk_growth=2.0, verbose=True, **kw)
    _jax_tolerances(fl, ref)
    _bits(fl, ref)
    n_it = ref.n_iters.numpy()
    running = [int(line.split(":")[1].split("/")[0]) for line in
               capsys.readouterr().out.splitlines() if "fleet chunk" in line]
    assert running[0] < B and running[-1] == 0, running
    # a lane done on the last step of a chunk while the fleet goes on
    assert np.isin(n_it, (2, 6)).any() and n_it.max() > 6, n_it


def test_fleet_on_jax_settings_matches_lockstep():
    """tests/test_fleet.py's own case: B=8, T=6, max_iter 6, iter_cap 10."""
    x0s, u0s = _inputs()
    kw = dict(lims=LIMS, cfg=CFG, derivs_tiles=tpc.pendcart_derivs_tiles(SPEC))
    model = tpc.pendcart_lanes(SPEC)
    ref = ilqg_batch_lanes(model, None, x0s, u0s, **kw)
    fl = fleet.ilqg_fleet(model, None, x0s, u0s, chunk_iters=2, **kw)
    _jax_tolerances(fl, ref)
    _bits(fl, ref)


@pytest.mark.parametrize("pad", [1, 32])
def test_fleet_padding_is_invisible(pad, monkeypatch):
    """Compacted batches padded to LANE_PAD or cut to exactly k: the same
    result (pad lanes re-solve a scenario and are not scattered back)."""
    monkeypatch.setattr(fleet, "LANE_PAD", pad)
    model, packed, x0s, u0s, kw = _case("static")
    ref = ilqg_batch_lanes(model, packed, x0s, u0s, **kw)
    _bits(fleet.ilqg_fleet(model, packed, x0s, u0s, chunk_iters=3,
                           chunk_growth=1.5, **kw), ref)


def test_fleet_stops_at_the_iteration_cap():
    """Lanes still running at lock-step's iteration cap stop there, as in
    lock-step: no chunk runs a lane past cfg.cap() - 1 iterations."""
    model, packed, x0s, u0s, kw = _case("static")
    kw["cfg"] = ILQGConfig(alphas=HCFG.alphas, reg_type=2, lam_max=1e15,
                           max_iter=30, iter_cap=6)
    ref = ilqg_batch_lanes(model, packed, x0s, u0s, **kw)
    assert (ref.reason == 0).any() and int(ref.n_iters.max()) == 5
    fl = fleet.ilqg_fleet(model, packed, x0s, u0s, chunk_iters=2,
                          chunk_growth=2.0, **kw)
    _bits(fl, ref)


def test_fleet_trace_stitching():
    """record_trace=True: rows 1..n_iters of the stitched trace are
    lock-step's, bit for bit (tests/test_fleet.py:84-114)."""
    model, packed, x0s, u0s, kw = _case("static")
    ref = ilqg_batch_lanes(model, packed, x0s, u0s, record_trace=True, **kw)
    fl = fleet.ilqg_fleet(model, packed, x0s, u0s, chunk_iters=2,
                          chunk_growth=2.0, record_trace=True, **kw)
    n_it = ref.n_iters.numpy()
    assert n_it.max() > 2
    for f in BatchTrace._fields:
        a = getattr(fl.trace, f).numpy()
        b = getattr(ref.trace, f).numpy()
        assert a.shape == b.shape == (B, HCFG.cap())
        for i in range(B):
            np.testing.assert_array_equal(a[i, :n_it[i] + 1],
                                          b[i, :n_it[i] + 1],
                                          err_msg=f"{f}, scenario {i}")


def test_stitch_traces_matches_jax():
    from differentialdynamicprogramming_jl_tpu.solvers.fleet import (
        _stitch_traces as jax_stitch)
    rng = np.random.default_rng(7)
    Bn, cap, kp, fields = 12, 9, 8, ("a", "b", "c")
    idx = np.sort(rng.choice(Bn, 5, replace=False))
    prior = rng.integers(0, cap, len(idx))
    sub_iters = rng.integers(0, cap, len(idx))
    sub = rng.standard_normal((len(fields), kp, cap)).astype(np.float32)
    start = {f: rng.standard_normal((Bn, cap)).astype(np.float32)
             for f in fields}
    mine = {f: v.copy() for f, v in start.items()}
    theirs = {f: v.copy() for f, v in start.items()}
    fleet._stitch_traces(mine, sub, idx, prior, sub_iters, cap, fields)
    jax_stitch(theirs, sub, idx, prior, sub_iters, cap, fields)
    for f in fields:
        np.testing.assert_array_equal(mine[f], theirs[f])
        assert not np.array_equal(mine[f], start[f])


def test_fleet_matches_jax_fleet(capsys):
    """One call of JAX's ilqg_fleet (Pallas kernels in interpret mode) on
    the port's inputs, on tests/test_fleet.py's settings: outcomes at that
    test's tolerances, and the verbose lines, text for text."""
    import jax.numpy as jnp
    from differentialdynamicprogramming_jl_tpu.models import pendcart as jpc
    from differentialdynamicprogramming_jl_tpu.solvers.fleet import (
        ilqg_fleet as jax_fleet)
    from differentialdynamicprogramming_jl_tpu.solvers.ilqg import (
        ILQGConfig as JCFG, default_alphas as jalphas)
    x0s, u0s = _inputs(spread=0.3)
    jcfg = JCFG(alphas=jalphas(0.2, -3.0, 3), reg_type=2, max_iter=6,
                iter_cap=10)
    jspec = jpc.PendCartSpec()
    ref = jax_fleet(jpc.pendcart_lanes(jspec), None, jnp.asarray(x0s.numpy()),
                    jnp.asarray(u0s.numpy()), lims=LIMS, cfg=jcfg,
                    derivs_tiles=jpc.pendcart_derivs_tiles(jspec),
                    chunk_iters=2, kt_backward=2, kt_forward=2,
                    interpret=True, verbose=True)
    jax_lines = capsys.readouterr().out
    out = fleet.ilqg_fleet(tpc.pendcart_lanes(SPEC), None, x0s, u0s,
                           lims=LIMS, cfg=CFG,
                           derivs_tiles=tpc.pendcart_derivs_tiles(SPEC),
                           chunk_iters=2, kt_backward=2, kt_forward=2,
                           interpret=True, verbose=True)
    assert capsys.readouterr().out == jax_lines
    assert "fleet chunk 1:" in jax_lines
    np.testing.assert_allclose(out.cost_total.numpy(),
                               np.asarray(ref.cost_total), rtol=2e-4)
    for name in ("reason", "n_accepted", "n_iters"):
        np.testing.assert_array_equal(getattr(out, name).numpy(),
                                      np.asarray(getattr(ref, name)),
                                      err_msg=name)
    np.testing.assert_allclose(out.u.numpy(), np.asarray(ref.u), atol=1e-4)
    np.testing.assert_allclose(out.x.numpy(), np.asarray(ref.x), atol=1e-4)


@pytest.mark.parametrize("name", ["ilqg_fleet", "ilqgkl_fleet",
                                  "ilqg_fleet_sharded",
                                  "ilqgkl_fleet_sharded"])
def test_fleet_entries_take_jax_signatures(name):
    """Every parameter of JAX's entry is one of the port's, in JAX's order,
    kind and default (the TPU keywords are taken and have no effect)."""
    import inspect
    from differentialdynamicprogramming_jl_tpu.solvers import fleet as jfleet
    jp = inspect.signature(getattr(jfleet, name)).parameters
    tp = inspect.signature(getattr(fleet, name)).parameters
    assert list(jp) == [p for p in tp if p in jp], (list(jp), list(tp))
    for p in jp:
        assert tp[p].kind == jp[p].kind, p
        if p not in ("cfg", "mesh"):
            assert tp[p].default == jp[p].default, p
