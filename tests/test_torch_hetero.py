"""Heterogeneous fleets in the port (plain versions, CPU) against the JAX
package with its Pallas kernels in interpret mode: per-scenario model
parameters (the parametrised pendcart, ``params = [l, d]``) and
per-scenario control limits, in the kernels K1/K2/K3, the iLQG fleet and
the KL fleet.

Shapes are the JAX tests' own (``tests/test_param_fleet.py``,
``tests/test_heterogeneous_lims.py``): B ≤ 8, T ≤ 10, k_t = 2. Inputs are
made once in numpy f64 from a seeded Generator and cast to f32 for both
packages; the parameter and limit ranges are those tests' ones.

Tolerances. Solver outcomes: costs rtol 1e-4 (LTI 2e-4, as
``test_torch_lti_batch.py``), reasons and accepted counts equal.
Kernels: the port's kernel tests' constants, rtol 1e-5 and atol 1e-5 on
every slot, exact on diverged/diverge_idx and the line search's decisions;
XLA on the host contracts multiply-adds, so the two differ in the last
bits. JAX's parametrised pendcart forms -g/l and 1-h·d per lane in f32, as
the port does, so the port's param fleet is compared with that model. Bit
equality is asserted only port against port: homogeneous per-scenario rows
against the static path.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.linalg import expm

import differentialdynamicprogramming_jl_tpu as J
from differentialdynamicprogramming_jl_tpu.models import linear as jl
from differentialdynamicprogramming_jl_tpu.models import pendcart as jpc
from differentialdynamicprogramming_jl_tpu.ops.pallas.backward_kernel import (
    backward_lanes as jax_backward_lanes)
from differentialdynamicprogramming_jl_tpu.ops.pallas.forward_kernel import (
    forward_lanes as jax_forward_lanes, linesearch_lanes as jax_linesearch)
from differentialdynamicprogramming_jl_tpu.policy import (
    GaussianPolicy as JPolicy)
from differentialdynamicprogramming_jl_tpu.solvers import batch_kl as jkl
from differentialdynamicprogramming_jl_tpu.solvers.ilqgkl import (
    ILQGKLConfig as JKLConfig)
from differentialdynamicprogramming_jl_tpu_torch import convert
from differentialdynamicprogramming_jl_tpu_torch.models import linear as tl
from differentialdynamicprogramming_jl_tpu_torch.models import pendcart as tpc
from differentialdynamicprogramming_jl_tpu_torch.ops.hopper import (
    backward_kernel as bk, forward_kernel as fk)
from differentialdynamicprogramming_jl_tpu_torch.ops.hopper.autodiff_tiles \
    import autodiff_derivs_tiles
from differentialdynamicprogramming_jl_tpu_torch.solvers import batch_kl as tkl
from differentialdynamicprogramming_jl_tpu_torch.solvers.batch import (
    ilqg_batch_lanes)
from test_torch_kl import check_outcomes, check_policy, kl_inputs

B, T = 8, 6
JSPEC = jpc.PendCartSpec()
SPEC = convert.spec_from_jax(JSPEC)
JCFG = J.ILQGConfig(alphas=J.default_alphas(0.2, -3.0, 3), reg_type=2,
                    max_iter=2, iter_cap=3)
CFG = convert.config_from_jax(JCFG)
KT = dict(kt_backward=2, kt_forward=2, interpret=True)


def _pend(Bn=B, Tn=T, seed=0):
    rng = np.random.default_rng(seed)
    x0s = (np.array([np.pi - 0.6, 0, 0, 0])[None, :]
           + 0.1 * rng.standard_normal((Bn, 4)))
    u0s = 0.3 * rng.standard_normal((Bn, Tn, 1))
    params = np.stack([rng.uniform(0.25, 0.55, Bn),
                       rng.uniform(0.5, 1.5, Bn)], axis=1)
    return (x0s.astype(np.float32), u0s.astype(np.float32),
            params.astype(np.float32))


def _hetero_lims(Bn=B, lo=0.8, hi=6.0):
    """±h per lane with h = linspace(lo, hi) (tests/test_heterogeneous_lims.py
    takes 0.8..6.0)."""
    h = np.linspace(lo, hi, Bn)
    return np.stack([-h, h], axis=-1)[:, None, :].astype(np.float32)


def _t(a):
    return None if a is None else torch.from_numpy(a)


def _check(ref, out, rtol=1e-4):
    np.testing.assert_allclose(out["cost_total"], ref["cost_total"],
                               rtol=rtol)
    for name in ("reason", "n_accepted", "n_iters"):
        np.testing.assert_array_equal(out[name], ref[name], err_msg=name)
    np.testing.assert_allclose(out["u"], ref["u"], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(out["x"], ref["x"], rtol=1e-4, atol=1e-5)


# ---------------------------------------------------------------------------
# the fleet solver
# ---------------------------------------------------------------------------

# the param fleet's settings (tests/test_param_fleet.py: B=4, T=10,
# iter_cap 5)
PB, PT = 4, 10
PCFG = J.ILQGConfig(alphas=J.default_alphas(0.2, -3.0, 3), reg_type=2,
                    max_iter=3, iter_cap=5)


def _jax_param_fleet(x0s, u0s, params, lims):
    """JAX's parametrised pendcart fleet with per-scenario (B, 1, 2) limits.
    Every fleet case of this module at (PB, PT) goes through this one JAX
    structure, so that JAX traces its solver once for them: a static box
    is given as rows all equal to it, which JAX's own
    test_dynamic_lims_bitexact_vs_static holds bit-identical to the static
    path."""
    return convert.result_to_numpy(J.ilqg_batch_lanes(
        jpc.pendcart_lanes_param(JSPEC), None, jnp.asarray(x0s),
        jnp.asarray(u0s), lims=jnp.asarray(lims), cfg=PCFG,
        derivs_tiles=jpc.pendcart_derivs_tiles_param(JSPEC),
        params=jnp.asarray(params), **KT))


@pytest.mark.parametrize("lims", ["static", "per_scenario"])
def test_param_fleet_matches_jax(lims):
    """pendcart_lanes_param with per-scenario [l, d] against JAX's param
    fleet, with static ±5 limits or per-scenario ones."""
    x0s, u0s, params = _pend(Bn=PB, Tn=PT)
    rows = (_hetero_lims(PB, 5.0, 5.0) if lims == "static"
            else _hetero_lims(PB))
    ref = _jax_param_fleet(x0s, u0s, params, rows)
    out = convert.result_to_numpy(ilqg_batch_lanes(
        tpc.pendcart_lanes_param(SPEC), None, _t(x0s), _t(u0s),
        lims=((-5.0, 5.0),) if lims == "static" else _t(rows),
        cfg=convert.config_from_jax(PCFG),
        derivs_tiles=tpc.pendcart_derivs_tiles_param(SPEC),
        params=_t(params)))
    _check(ref, out)
    np.testing.assert_allclose(out["policy"]["K"], ref["policy"]["K"],
                               rtol=1e-4, atol=1e-5)


def _lti_spec(seed=3, Tn=T):
    rng = np.random.default_rng(seed)
    Mm = rng.standard_normal((4, 4))
    f = jnp.float32
    return jl.LTISpec(A=jnp.asarray(expm(0.3 * (Mm - Mm.T)), f),
                      B=jnp.asarray(0.3 * rng.standard_normal((4, 2)), f),
                      Q=jnp.asarray(0.5 * np.eye(4), f),
                      R=jnp.asarray(0.05 * np.eye(2), f),
                      x0=jnp.ones((4,), f),
                      u0=jnp.asarray(0.1 * rng.standard_normal((Tn, 2)), f))


def _lti_lims():
    """A box per lane and control, tight enough to bind at these states.
    Lanes that converge at once sit on the cost exit's f32 noise floor,
    where an ulp decides between reasons 0 and 2 in either package; this
    seed's lanes keep clear of it."""
    rng = np.random.default_rng(8)
    lo = -rng.uniform(0.05, 0.3, (B, 2))
    hi = rng.uniform(0.1, 0.4, (B, 2))
    return np.stack([lo, hi], axis=-1).astype(np.float32)


def _lti_inputs(spec):
    x0s = (np.ones((B, 4)) * np.linspace(0.5, 2.0, B)[:, None]).astype(
        np.float32)
    u0s = np.tile(3.0 * np.asarray(spec.u0), (B, 1, 1)).astype(np.float32)
    return x0s, u0s


@pytest.mark.parametrize("m", [1, 2])
def test_heterogeneous_lims_match_jax(m):
    """Per-scenario (B, m, 2) limits on the fleet: pendcart (m=1, the clamp)
    and LTI n=4 (m=2, the 9-set enumeration on each lane's box) against
    JAX; every control stays in its own lane's box. The pendcart boxes are
    ±0.1..0.8, narrow enough to bind at these states. The port's pendcart
    folds -g/l and 1-h·d in f32, as JAX's parametrised pendcart does per
    lane and unlike JAX's fixed one (f64), so its reference is JAX's
    parametrised fleet with every params row the spec's (l, d)."""
    if m == 1:
        x0s, u0s, _ = _pend(Bn=PB, Tn=PT)
        lims = _hetero_lims(PB, lo=0.1, hi=0.8)
        spec_rows = np.tile(np.float32([JSPEC.l, JSPEC.d]), (PB, 1))
        ref = _jax_param_fleet(x0s, u0s, spec_rows, lims)
        out = ilqg_batch_lanes(
            tpc.pendcart_lanes(SPEC), None, _t(x0s), _t(u0s), lims=_t(lims),
            cfg=convert.config_from_jax(PCFG),
            derivs_tiles=tpc.pendcart_derivs_tiles(SPEC))
        rtol = 1e-4
    else:
        spec = _lti_spec()
        x0s, u0s = _lti_inputs(spec)
        lims = _lti_lims()
        jcfg = J.ILQGConfig(alphas=J.default_alphas(0.2, -3.0, 3),
                            reg_type=2, max_iter=3, iter_cap=4)
        ref = J.ilqg_batch_lanes(
            jl.lti_lanes(spec), None, jnp.asarray(x0s), jnp.asarray(u0s),
            lims=jnp.asarray(lims), cfg=jcfg,
            derivs_tiles=jl.lti_derivs_tiles(spec), **KT)
        tspec = convert.lti_spec_from_jax(spec, device="cpu")
        out = ilqg_batch_lanes(
            tl.lti_lanes(tspec), None, _t(x0s), _t(u0s), lims=_t(lims),
            cfg=convert.config_from_jax(jcfg),
            derivs_tiles=tl.lti_derivs_tiles(tspec))
        rtol = 2e-4
    out = convert.result_to_numpy(out)
    if m == 2:
        ref = convert.result_to_numpy(ref)
    _check(ref, out, rtol)
    u = out["u"]
    assert (u >= lims[:, None, :, 0]).all() and (u <= lims[:, None, :, 1]).all()
    # the boxes bind, and differ between lanes
    on = (u == lims[:, None, :, 0]) | (u == lims[:, None, :, 1])
    assert on.any() and not np.all(lims == lims[:1])


@pytest.mark.parametrize("model", ["pendcart", "lti"])
def test_homogeneous_lims_are_the_static_path(model):
    """Every per-scenario row the same box: the fleet solve is the static
    limits' solve bit for bit (JAX test_dynamic_lims_bitexact_vs_static),
    at m=1 and at m=2."""
    if model == "pendcart":
        x0s, u0s, _ = _pend()
        box = ((-5.0, 5.0),)
        m_, tiles = tpc.pendcart_lanes(SPEC), tpc.pendcart_derivs_tiles(SPEC)
        cfg = CFG
    else:
        tspec = convert.lti_spec_from_jax(_lti_spec(), device="cpu")
        x0s, u0s = _lti_inputs(_lti_spec())
        box = ((-0.2, 0.3), (-0.1, 0.25))
        m_, tiles = tl.lti_lanes(tspec), tl.lti_derivs_tiles(tspec)
        cfg = convert.config_from_jax(J.ILQGConfig(
            alphas=J.default_alphas(0.2, -3.0, 3), reg_type=2, max_iter=3,
            iter_cap=4))
    rows = torch.tensor(box, dtype=torch.float32).expand(B, len(box), 2)
    kw = dict(cfg=cfg, derivs_tiles=tiles, record_trace=True)
    a = ilqg_batch_lanes(m_, None, _t(x0s), _t(u0s), lims=box, **kw)
    b = ilqg_batch_lanes(m_, None, _t(x0s), _t(u0s), lims=rows, **kw)
    for name in ("x", "u", "cost_total", "reason", "n_accepted", "Vxx"):
        assert torch.equal(getattr(a, name), getattr(b, name)), name
    assert torch.equal(a.policy.K, b.policy.K)
    assert torch.equal(a.trace.cost, b.trace.cost)


def test_param_rows_of_the_spec_are_the_fixed_model():
    """Every params row the spec's (l, d): the parametrised pendcart is the
    fixed model bit for bit, per-lane -g/l and 1-h·d included."""
    x0s, u0s, _ = _pend()
    params = torch.tensor([[SPEC.l, SPEC.d]], dtype=torch.float32).expand(
        B, 2)
    kw = dict(lims=((-5.0, 5.0),), cfg=CFG)
    a = ilqg_batch_lanes(tpc.pendcart_lanes(SPEC), None, _t(x0s), _t(u0s),
                         derivs_tiles=tpc.pendcart_derivs_tiles(SPEC), **kw)
    b = ilqg_batch_lanes(tpc.pendcart_lanes_param(SPEC), None, _t(x0s),
                         _t(u0s), params=params,
                         derivs_tiles=tpc.pendcart_derivs_tiles_param(SPEC),
                         **kw)
    for name in ("x", "u", "cost_total", "reason", "Vx", "Vxx"):
        assert torch.equal(getattr(a, name), getattr(b, name)), name


# ---------------------------------------------------------------------------
# the kernels
# ---------------------------------------------------------------------------

KB, KTN = 8, 10


def _lanes(a):
    return jnp.asarray(convert.stream_to_lanes(a))


@pytest.fixture(scope="module")
def kernel_inputs():
    """A PendCartParam rollout stream (T=10, B=8) with per-scenario [l, d]
    and limits [U(0.2, 0.6), U(0.8, 6.0)], which exclude u=0 so that K1's
    clamp binds, and the (P, B) / (2m, B) streams."""
    rng = np.random.default_rng(7)
    x0 = (np.array([np.pi - 0.6, 0, 0, 0])[:, None]
          + 0.3 * rng.standard_normal((4, KB))).astype(np.float32)
    u = (2.0 * rng.standard_normal((KTN, 1, KB))).astype(np.float32)
    par = np.stack([rng.uniform(0.25, 0.55, KB),
                    rng.uniform(0.5, 1.5, KB)]).astype(np.float32)
    lanes = np.stack([rng.uniform(0.2, 0.6, KB),
                      rng.uniform(0.8, 6.0, KB)]).astype(np.float32)
    gains0 = np.concatenate([u, np.zeros((KTN, 4, KB), np.float32)], axis=1)
    ro = fk.forward_lanes(torch.zeros((KTN, 5, KB)), _t(gains0), _t(x0),
                          torch.ones(1, KB), _t(par), _t(lanes),
                          model=tpc.pendcart_lanes_param(SPEC),
                          emit_traj=True)
    lam = np.linspace(0.0, 2.0, KB).astype(np.float32)
    return dict(x0=x0, gains0=gains0, par=par, lanes=lanes,
                traj=ro.traj.numpy(), tot=ro.totals[0].numpy(), lam=lam)


@pytest.fixture(scope="module")
def jax_k1_full(kernel_inputs):
    """JAX's K1 in full emission on the kernel inputs: (out, stats)."""
    d = kernel_inputs
    ref = jax_backward_lanes(
        _lanes(d["traj"]), _lanes(d["lam"]), n=4, m=1, reg_type=2,
        lims=None, k_t=2, derivs_tiles=jpc.pendcart_derivs_tiles_param(JSPEC),
        params=_lanes(d["par"]), lims_lanes=_lanes(d["lanes"]), emit="full",
        interpret=True)
    return (convert.stream_from_lanes(ref.out, KB),
            convert.stream_from_lanes(ref.stats, KB))


@pytest.mark.parametrize("emit", ["gains", "full"])
def test_backward_params_lims_match_jax(kernel_inputs, jax_k1_full, emit):
    """K1 with params and lims_lanes (JAX backward_kernel.py:365,820-830).
    Every emission leads with the same k, K slots (OutLayout), so the
    gains emission is held to JAX's full emission's first slots."""
    d = kernel_inputs
    out = bk.backward_lanes(
        _t(d["traj"]), _t(d["lam"]), n=4, m=1, reg_type=2, lims=None,
        derivs_tiles=tpc.pendcart_derivs_tiles_param(SPEC), params=_t(
            d["par"]), lims_lanes=_t(d["lanes"]), emit=emit)
    ro, rs = jax_k1_full
    ro = ro[:, :out.out.shape[1]]
    np.testing.assert_allclose(out.out.numpy(), ro, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(out.stats[2:].numpy(), rs[2:])
    np.testing.assert_allclose(out.stats[:2].numpy(), rs[:2], rtol=1e-5,
                               atol=1e-5)
    # k lands on a lane's own limit on some steps
    u = d["traj"][:-1, 4]
    k = out.out[:-1, 0].numpy()
    on = np.isclose(u + k, d["lanes"][1], atol=1e-5) | np.isclose(
        u + k, d["lanes"][0], atol=1e-5)
    assert on.any()


def test_forward_and_linesearch_params_lims_match_jax(kernel_inputs):
    """K3 (an α ladder) and K2 with params and lims_lanes (JAX
    forward_kernel.py:285-294, :576-585)."""
    d = kernel_inputs
    al = np.tile(np.asarray(J.default_alphas(0.2, -3.0, 3), np.float32)[:,
                                                                       None],
                 (1, KB))
    jm, tm = jpc.pendcart_lanes_param(JSPEC), tpc.pendcart_lanes_param(SPEC)
    par, lanes = _lanes(d["par"]), _lanes(d["lanes"])
    ref = jax_forward_lanes(_lanes(d["traj"][:, :5]), _lanes(d["gains0"]),
                            _lanes(d["x0"]), _lanes(al), par, lanes,
                            model=jm, k_t=2, interpret=True)
    out = fk.forward_lanes(_t(d["traj"]), _t(d["gains0"]), _t(d["x0"]),
                           _t(al), _t(d["par"]), _t(d["lanes"]), model=tm)
    np.testing.assert_allclose(out.totals.numpy(),
                               convert.stream_from_lanes(ref.totals, KB),
                               rtol=1e-5, atol=1e-5)
    bo = bk.backward_lanes(
        _t(d["traj"]), _t(d["lam"]), n=4, m=1, reg_type=2, lims=None,
        derivs_tiles=tpc.pendcart_derivs_tiles_param(SPEC),
        params=_t(d["par"]), lims_lanes=_t(d["lanes"]), emit="gains")
    allow = (np.arange(KB) % 2 == 0).astype(np.float32)
    sel = np.stack([bo.stats[0].numpy(), bo.stats[1].numpy(), d["tot"],
                    allow])
    alphas = J.default_alphas(0.2, -3.0, 3)
    ref = jax_linesearch(_lanes(d["traj"]), _lanes(bo.out.numpy()),
                         _lanes(d["x0"]), _lanes(sel), par, lanes, model=jm,
                         alphas=alphas, emit_echo=False, k_t=2,
                         interpret=True)
    out = fk.linesearch_lanes(_t(d["traj"]), bo.out, _t(d["x0"]), _t(sel),
                              _t(d["par"]), _t(d["lanes"]), model=tm,
                              alphas=alphas)
    np.testing.assert_allclose(out.traj.numpy(),
                               convert.stream_from_lanes(ref.traj, KB),
                               rtol=1e-5, atol=1e-5)
    rl = convert.stream_from_lanes(ref.ls, KB)
    np.testing.assert_array_equal(out.ls[:2].numpy(), rl[:2])
    np.testing.assert_allclose(out.ls[2:].numpy(), rl[2:], rtol=1e-5,
                               atol=1e-5)
    u = out.traj[:, 4].numpy()
    assert ((u >= d["lanes"][0]) & (u <= d["lanes"][1])).all()


# ---------------------------------------------------------------------------
# the KL fleet, and what stays out
# ---------------------------------------------------------------------------

def test_kl_per_scenario_lims_match_jax():
    """ilqgkl_batch_lanes with (B, 1, 2) limits: K1 in GPS mode and K3 read
    each lane's box (JAX batch_kl.py:197,323,333,404)."""
    inp = kl_inputs(B=B, T=4)
    lims = _hetero_lims()
    jcfg = JKLConfig(kl_step=0.05, max_iter=3)
    jprev = JPolicy(**{k: jnp.asarray(v) for k, v in inp["policy"].items()})
    ref = convert.result_to_numpy(jkl.ilqgkl_batch_lanes(
        jpc.pendcart_lanes(JSPEC), jpc.pendcart_derivs_tiles(JSPEC),
        jnp.asarray(inp["x"]), jprev, jnp.asarray(inp["fx"]),
        jnp.asarray(inp["cost0"]), lims=jnp.asarray(lims), cfg=jcfg, kt=2,
        interpret=True))
    out = convert.result_to_numpy(tkl.ilqgkl_batch_lanes(
        tpc.pendcart_lanes(SPEC), tpc.pendcart_derivs_tiles(SPEC),
        _t(inp["x"]), convert.policy_from_jax(jprev, device="cpu"),
        _t(inp["fx"]), _t(inp["cost0"]), lims=_t(lims),
        cfg=convert.kl_config_from_jax(jcfg)))
    check_outcomes(ref, out)
    check_policy(ref, out)
    assert (np.abs(out["u"][..., 0]) <= lims[:, 0, 1:2] + 1e-6).all()


def test_params_need_a_parametrised_model_and_stay_off_autodiff():
    x0s, u0s, params = _pend()
    with pytest.raises(ValueError, match="params"):
        ilqg_batch_lanes(tpc.pendcart_lanes_param(SPEC), None, _t(x0s),
                         _t(u0s), cfg=CFG,
                         derivs_tiles=tpc.pendcart_derivs_tiles_param(SPEC))
    with pytest.raises(ValueError, match="params"):
        bk.backward_lanes(torch.zeros((T, 6, B)), torch.ones(B), n=4, m=1,
                          derivs_tiles=tpc.pendcart_derivs_tiles(SPEC),
                          params=torch.ones((2, B)))
    # autodiff tiles take the params and keep the hand-written descriptor,
    # marked autodiff: off the CPU K1 runs their Autodiff<PendCartParam>
    # instance (the launch refuses meta tensors), never the analytic
    # instance in its place; in GPS mode, which the KL entries reach
    # without params, it has none and raises
    ad = autodiff_derivs_tiles(tpc.pendcart_lanes_param(SPEC))
    assert ad.n_params == 2 and ad.device.model_id == 4
    assert ad.device.autodiff
    meta = dict(device="meta")
    args = (torch.zeros((T, 6, B), **meta), torch.ones(B, **meta))
    with pytest.raises(ValueError, match="no kernel for tensors on meta"):
        bk.backward_lanes(*args, n=4, m=1, derivs_tiles=ad,
                          params=torch.ones((2, B), **meta))
    with pytest.raises(NotImplementedError, match="no CUDA kernel"):
        bk.backward_lanes(*args, n=4, m=1, derivs_tiles=ad,
                          params=torch.ones((2, B), **meta),
                          prev=torch.zeros((T, 6, B), **meta),
                          eta=torch.ones((T, B), **meta), emit="policy")
