"""The port's box QP (``ops/boxqp.py``) against the JAX package's on the
same numpy-seeded inputs, in f64 on the CPU: every result code, the trace,
the f32 floors, the closed-form m=1 solve, batches and the verbose lines.

Values and solutions are held to 1e-12: the two packages run the same
projected-Newton steps, and only LAPACK's Cholesky and the reductions'
order can differ in the last bits. Result codes, iteration and
factorisation counts and free masks must be equal."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import differentialdynamicprogramming_jl_tpu as J
from differentialdynamicprogramming_jl_tpu_torch.ops import boxqp as tbq
from differentialdynamicprogramming_jl_tpu_torch.utils import printing
from generic_parity import same_lines

TOL = 1e-12


def rand_qp(seed, n, shift=0.1):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((n, n))
    return (A @ A.T + shift * np.eye(n), rng.standard_normal(n),
            rng.standard_normal(n))


def _case(name):
    """(H, g, lower, upper, x0, kwargs, expected result)."""
    eye3, box = np.eye(3), (-np.ones(3), np.ones(3))
    H8, g8, x8 = rand_qp(3, 8)
    if name == "non_pd":
        return (np.diag([1.0, -1.0, 1.0]), np.ones(3), *box, np.zeros(3),
                {}, -1)
    if name == "max_iter":
        return H8, 5 * g8, -0.3 * np.ones(8), 0.3 * np.ones(8), x8, \
            dict(max_iter=1), 1
    if name == "max_ls":
        # an Armijo fraction no step can meet: backtracking runs into
        # min_step
        return H8, g8, -np.ones(8), np.ones(8), x8, \
            dict(armijo=2.0, min_step=1e-3), 2
    if name == "improvement":
        return H8, 5 * g8, -0.3 * np.ones(8), 0.3 * np.ones(8), x8, \
            dict(min_rel_improve=0.9), 4
    if name == "gradient":
        return 2.0 * eye3, np.array([0.5, -0.25, 0.1]), *box, np.zeros(3), \
            {}, 5
    if name == "all_clamped":
        return eye3, np.array([10.0, -10.0, 10.0]), *box, np.zeros(3), {}, 6
    raise KeyError(name)


CASES = ("non_pd", "max_iter", "max_ls", "improvement", "gradient",
         "all_clamped")


def _jax(H, g, lo, hi, x0, **kw):
    return J.boxqp(*(jnp.asarray(a) for a in (H, g, lo, hi, x0)), **kw)


def _torch(H, g, lo, hi, x0, dtype=torch.float64, **kw):
    return tbq.boxqp(*(torch.tensor(np.asarray(a), dtype=dtype)
                       for a in (H, g, lo, hi, x0)), **kw)


def _same(j, t, tol=TOL):
    for name in ("result", "iters", "nfactor", "free"):
        np.testing.assert_array_equal(np.asarray(getattr(j, name)),
                                      getattr(t, name).numpy(), name)
    for name in ("x", "value", "gnorm", "chol"):
        np.testing.assert_allclose(getattr(t, name).numpy(),
                                   np.asarray(getattr(j, name)),
                                   rtol=tol, atol=tol, err_msg=name)


@pytest.mark.parametrize("name", CASES)
def test_result_codes_match_jax(name):
    H, g, lo, hi, x0, kw, code = _case(name)
    j, t = _jax(H, g, lo, hi, x0, **kw), _torch(H, g, lo, hi, x0, **kw)
    assert int(j.result) == code
    _same(j, t)


def test_golden_boxqp_cases():
    """tests/test_golden.py's box QPs (n50 from the committed input file)
    against golden.npz at that test's tolerances."""
    import os
    here = os.path.dirname(__file__)
    gold = np.load(os.path.join(here, "golden.npz"))
    inp = np.load(os.path.join(here, "..", "tools_torch",
                               "generic_inputs.npz"))
    eye3, box = np.eye(3), (-np.ones(3), np.ones(3))
    cases = {
        "n50": (inp["qp_n50_H"], inp["qp_n50_g"], -np.ones(50), np.ones(50),
                np.zeros(50)),
        "all_clamped": (eye3, np.array([10., -10., 10.]), *box, np.zeros(3)),
        "interior": (2.0 * eye3, np.array([0.5, -0.25, 0.1]), *box,
                     np.zeros(3)),
        "non_pd": (np.diag([1.0, -1.0, 1.0]), np.ones(3), *box, np.zeros(3)),
    }
    for case, args in cases.items():
        t = _torch(*args)
        np.testing.assert_allclose(t.value.item(),
                                   gold[f"boxqp_{case}_value"], atol=1e-10)
        assert int(t.result) == int(gold[f"boxqp_{case}_result"]), case
        np.testing.assert_allclose(t.x.sum().item(),
                                   gold[f"boxqp_{case}_x_sum"], atol=1e-8)


def test_record_trace_matches_jax():
    H, g, x0 = rand_qp(5, 10)
    lo, hi = -0.2 * np.ones(10), 0.2 * np.ones(10)
    j, jt = _jax(H, 3 * g, lo, hi, x0, record_trace=True, max_iter=12)
    t, tt = _torch(H, 3 * g, lo, hi, x0, record_trace=True, max_iter=12)
    _same(j, t)
    assert int(j.iters) > 2
    for name in ("n_clamped", "factorized"):
        np.testing.assert_array_equal(np.asarray(getattr(jt, name)),
                                      getattr(tt, name).numpy())
    for name in ("value", "gnorm"):
        np.testing.assert_allclose(getattr(tt, name).numpy(),
                                   np.asarray(getattr(jt, name)),
                                   rtol=TOL, atol=TOL)


@pytest.mark.parametrize("explicit", [False, True])
def test_f32_floors_match_jax(explicit):
    """f32 inputs with the tolerances left at None take the f32 floors
    (1e-6 / 1e-6 / 1e-20), and explicit ones are honoured, in both
    packages: equal result codes and iteration counts, solutions to f32
    rounding. (Explicit tolerances below f32 resolution, the reference's
    1e-8, make the exit a matter of the last bit's rounding, so the
    explicit case uses coarser ones.)"""
    kw = dict(min_grad=1e-3, min_rel_improve=1e-4, min_step=1e-10) \
        if explicit else {}
    for seed in range(4):
        H, g, x0 = rand_qp(10 + seed, 6)
        args = [np.asarray(a, np.float32) for a in (
            H, g, -0.5 * np.ones(6), 0.5 * np.ones(6), x0)]
        j = _jax(*args, **kw)
        t = _torch(*args, dtype=torch.float32, **kw)
        assert t.x.dtype == torch.float32
        assert int(j.result) == int(t.result), seed
        assert int(j.iters) == int(t.iters), seed
        np.testing.assert_allclose(t.x.numpy(), np.asarray(j.x), atol=1e-5)


def test_boxqp_1d_matches_jax():
    rng = np.random.default_rng(7)
    h = np.concatenate([np.abs(rng.standard_normal(14)) + 0.1,
                        [-1.0, 0.0]])
    g = 3.0 * rng.standard_normal(16)
    lo, hi = -np.ones(16), np.ones(16)
    j = jax.vmap(J.boxqp_1d)(jnp.asarray(h)[:, None, None],
                             jnp.asarray(g)[:, None], jnp.asarray(lo)[:, None],
                             jnp.asarray(hi)[:, None])
    t = tbq.boxqp_1d(torch.tensor(h)[:, None, None], torch.tensor(g)[:, None],
                     torch.tensor(lo)[:, None], torch.tensor(hi)[:, None])
    assert set(np.asarray(j.result).tolist()) == {-1, 5}
    for name in ("result", "free", "iters", "nfactor"):
        np.testing.assert_array_equal(np.asarray(getattr(j, name)),
                                      getattr(t, name).numpy())
    for name in ("x", "value", "gnorm", "chol"):
        np.testing.assert_array_equal(np.asarray(getattr(j, name)),
                                      getattr(t, name).numpy())


def test_batched_equals_per_problem_and_jax():
    """One batched call reproduces ``jax.vmap(boxqp)`` and the per-problem
    calls: each QP runs its own iterations, frozen once it exits (batched
    and single matrix products may round differently, hence 1e-12)."""
    Hs, gs, x0s = zip(*(rand_qp(20 + b, 5) for b in range(12)))
    Hs = np.stack(Hs)
    Hs[3] = -np.eye(5)                      # a non-PD problem in the batch
    gs, x0s = 2.0 * np.stack(gs), np.stack(x0s)
    lo, hi = -0.4 * np.ones((12, 5)), 0.4 * np.ones((12, 5))
    j = jax.vmap(J.boxqp)(*(jnp.asarray(a) for a in (Hs, gs, lo, hi, x0s)))
    t = _torch(Hs, gs, lo, hi, x0s)
    _same(j, t)
    assert len(set(np.asarray(j.iters).tolist())) > 1
    for b in range(12):
        one = _torch(Hs[b], gs[b], lo[b], hi[b], x0s[b])
        _same(type(one)(*(a[b].numpy() for a in t)), one)


def test_demo_qp_runs():
    """The reference's demo scale (n=500, its own numpy draws)."""
    out = tbq.demo_qp(n=500, device="cpu")
    assert int(out.result) >= 1
    assert bool((out.x >= -1).all() and (out.x <= 1).all())


def test_verbose_lines_match_jax(capfd):
    H, g, x0 = rand_qp(4, 4)
    args = (H + 0.4 * np.eye(4), g, -0.3 * np.ones(4), 0.3 * np.ones(4),
            np.zeros(4))
    j = _jax(*args, verbose=2)
    jax.block_until_ready(j.x)
    jax.effects_barrier()
    jout = capfd.readouterr().out
    t = _torch(*args, verbose=2)
    tout = capfd.readouterr().out
    assert printing._BOXQP_RESULTS[int(t.result) + 1] in tout
    same_lines(tout, jout)
