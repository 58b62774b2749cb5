"""The KL solver's resume entry and the KL fleet scheduler of the port, on
the CPU with the plain versions of the kernels:

- ``ilqgkl_batch_lanes`` cut by ``max_steps=2`` and resumed from its
  result (``bracket0``, ``delta0_in``, ``adam0_in``, ``it0``) equals one
  uninterrupted solve, bit for bit, with scalar and per-step η;
- the resume entry against JAX's (``_ilqgkl_batch_lanes_jit``,
  ``solvers/batch_kl.py:223-241``, Pallas kernels in interpret mode, one
  call structure) on the same resume state, by outcome at the KL tests'
  tolerances (``tests/test_torch_kl.py``: rtol 1e-4; XLA on the host
  contracts multiply-adds, so the packages part in the last bits);
- ``ilqgkl_fleet`` against the port's lock-step solve in both η modes with
  JAX's configs (``tests/test_fleet_kl.py:45-53``), bit for bit, and on a
  fleet whose lanes stop at different iterations, one of them on a chunk's
  last step. JAX's own ``ilqgkl_fleet`` is not called: it costs 27-37 s a
  mode here, and JAX's test holds it bit for bit to JAX's lock-step.

Inputs follow tests/test_fleet_kl.py: x0 = default_x0 + 0.1·N(0,1), u0 =
0.2·N(0,1), drawn in numpy from a seed, rolled out by the generic tier's
``forward_pass`` (Euler pendcart, f32); the previous policy is the zero
policy with k = the rollout's u.
"""
import numpy as np
import pytest
import torch

from differentialdynamicprogramming_jl_tpu_torch.models import pendcart as tpc
from differentialdynamicprogramming_jl_tpu_torch.ops.forward import (
    forward_pass)
from differentialdynamicprogramming_jl_tpu_torch.policy import GaussianPolicy
from differentialdynamicprogramming_jl_tpu_torch.solvers.batch_kl import (
    ilqgkl_batch_lanes)
from differentialdynamicprogramming_jl_tpu_torch.solvers.fleet import (
    ilqgkl_fleet)
from differentialdynamicprogramming_jl_tpu_torch.solvers.ilqgkl import (
    ILQGKLConfig)

B, T = 8, 10
SPEC = tpc.PendCartSpec()
RESULT = ("cost_total", "eta", "divergence", "satisfied", "kl_violated",
          "n_iters", "pd_failed", "done", "x", "u", "cost", "bracket",
          "delta", "adam")


def _cfg(per_step, **kw):
    """tests/test_fleet_kl.py:45-50."""
    base = dict(kl_step=0.02 if per_step else 1.0, max_iter=6,
                constrain_per_step=per_step,
                gd_alpha=0.3 if per_step else 0.05)
    base.update(kw)
    return ILQGKLConfig(**base)


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(0)
    x0 = (np.array([np.pi - 0.6, 0, 0, 0])[None, :]
          + 0.1 * rng.standard_normal((B, 4)))
    u0 = 0.2 * rng.standard_normal((B, T, 1))
    prob = tpc.make_pendcart_problem(SPEC, derivs="euler", device="cpu")
    ro = forward_pass(prob, torch.tensor(x0, dtype=torch.float32),
                      torch.tensor(u0, dtype=torch.float32))
    prev = GaussianPolicy(*(a.expand((B,) + a.shape).contiguous() for a in
                            GaussianPolicy.zeros(T, 4, 1, device="cpu")))
    prev = prev._replace(k=ro.u)
    return (tpc.pendcart_lanes(SPEC), tpc.pendcart_derivs_tiles(SPEC),
            ro.x, prev, prob.derivs(ro.x, ro.u).fx, ro.cost.sum(-1))


def _same(a, b, fields=RESULT):
    for name in fields:
        assert torch.equal(getattr(a, name), getattr(b, name)), name
    for name in a.policy._fields:
        assert torch.equal(getattr(a.policy, name),
                           getattr(b.policy, name)), name


def _resume(args, cfg, first, steps=None):
    return ilqgkl_batch_lanes(
        *args, cfg=cfg, bracket0=first.bracket, delta0_in=first.delta,
        adam0_in=first.adam if cfg.constrain_per_step else None, it0=2,
        max_steps=steps)


@pytest.mark.parametrize("per_step", [False, True])
def test_resume_equals_one_solve(inputs, per_step):
    """Lanes still running after 2 steps continue in a resumed call to the
    uninterrupted solve's bits; lanes done by then keep the first call's."""
    cfg = _cfg(per_step, kl_step=0.05 if per_step else 0.5, max_iter=8)
    ref = ilqgkl_batch_lanes(*inputs, cfg=cfg)
    first = ilqgkl_batch_lanes(*inputs, cfg=cfg, it0=0, max_steps=2)
    assert not first.done.all() and int(ref.n_iters.max()) > 2
    rest = _resume(inputs, cfg, first)
    done = first.done

    def pick(a, b):
        return torch.where(done.view((-1,) + (1,) * (a.ndim - 1)), a, b)

    for name in ("cost_total", "eta", "divergence", "satisfied", "n_iters",
                 "x", "u", "bracket", "done"):
        assert torch.equal(pick(getattr(first, name), getattr(rest, name)),
                           getattr(ref, name)), name
    if per_step:
        assert torch.equal(pick(first.adam, rest.adam), ref.adam)
    # the resumed call's n_iters is global: it counts on from it0
    assert int(rest.n_iters[~done].min()) > 2


def test_resume_matches_jax(inputs):
    """The port's resume entry against JAX's on the same resume state (the
    port's first two per-step iterations): one JAX call structure."""
    import jax.numpy as jnp
    from differentialdynamicprogramming_jl_tpu.models import pendcart as jpc
    from differentialdynamicprogramming_jl_tpu.policy import (
        GaussianPolicy as JPolicy)
    from differentialdynamicprogramming_jl_tpu.solvers.batch_kl import (
        _ilqgkl_batch_lanes_jit)
    from differentialdynamicprogramming_jl_tpu.solvers.ilqgkl import (
        ILQGKLConfig as JKLConfig)
    from differentialdynamicprogramming_jl_tpu_torch import convert
    cfg = _cfg(True, max_iter=5)
    first = ilqgkl_batch_lanes(*inputs, cfg=cfg, it0=0, max_steps=2)
    out = convert.result_to_numpy(_resume(inputs, cfg, first))
    _, _, x, prev, fx, cost0 = inputs
    j = lambda a: jnp.asarray(a.numpy())  # noqa: E731
    jspec = jpc.PendCartSpec()
    ref = convert.result_to_numpy(_ilqgkl_batch_lanes_jit(
        jpc.pendcart_lanes(jspec), jpc.pendcart_derivs_tiles(jspec), j(x),
        JPolicy(*map(j, prev)), j(fx), j(cost0),
        cfg=JKLConfig(kl_step=cfg.kl_step, max_iter=cfg.max_iter,
                      constrain_per_step=True, gd_alpha=cfg.gd_alpha),
        kt=4, bracket0=j(first.bracket), delta0_in=j(first.delta),
        adam0_in=j(first.adam), it0=jnp.int32(2), max_steps=jnp.int32(5),
        interpret=True))
    assert ref["n_iters"].min() > 2
    for name in ("satisfied", "pd_failed", "done", "n_iters"):
        np.testing.assert_array_equal(out[name], ref[name], err_msg=name)
    for name in ("cost_total", "eta", "divergence"):
        np.testing.assert_allclose(out[name], ref[name], rtol=1e-4,
                                   err_msg=name)
    for name in ("bracket", "adam"):
        np.testing.assert_allclose(out[name], ref[name], rtol=1e-4,
                                   atol=1e-6, err_msg=name)
    for name in ("K", "sigma", "sigma_inv"):
        np.testing.assert_allclose(out["policy"][name], ref["policy"][name],
                                   rtol=1e-4, atol=1e-5, err_msg=name)


@pytest.mark.parametrize("per_step", [False, True])
def test_kl_fleet_matches_lockstep(inputs, per_step, capsys):
    """tests/test_fleet_kl.py's case, bit for bit."""
    cfg = _cfg(per_step)
    ref = ilqgkl_batch_lanes(*inputs, cfg=cfg)
    fl = ilqgkl_fleet(*inputs, cfg=cfg, chunk_iters=2, chunk_growth=2.0,
                      verbose=True)
    _same(fl, ref)
    assert int(ref.n_iters.max()) > 2
    assert capsys.readouterr().out.splitlines()[0] == (
        f"  kl-fleet chunk 1: {int((ref.n_iters > 2).sum())}/{B} "
        f"running (2/{cfg.max_iter} iters)")


def test_kl_fleet_compacts(inputs, capsys):
    """Scalar η at kl_step 0.5: lanes stop at 5 and 8 iterations; with
    chunk_iters=5 the second chunk runs the two stragglers alone, after the
    others ended on the first chunk's last step."""
    cfg = _cfg(False, kl_step=0.5, max_iter=8)
    ref = ilqgkl_batch_lanes(*inputs, cfg=cfg)
    fl = ilqgkl_fleet(*inputs, cfg=cfg, chunk_iters=5, chunk_growth=2.0,
                      verbose=True)
    _same(fl, ref)
    n_it = ref.n_iters.numpy()
    assert set(n_it.tolist()) == {5, 8}, n_it
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == f"  kl-fleet chunk 1: {int((n_it == 8).sum())}/{B} " \
        "running (5/8 iters)", lines
