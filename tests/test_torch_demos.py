"""The port's demos (``differentialdynamicprogramming_jl_tpu_torch/demos.py``)
on the CPU: the JAX package's ``tests/test_demos.py`` at its shapes, and
``main``'s registry, help and exit codes. Each demo's inner solve against
the JAX package's is in ``test_torch_demos_parity.py``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from differentialdynamicprogramming_jl_tpu import demos as jdemos
from differentialdynamicprogramming_jl_tpu.models import pendcart as jpc
from differentialdynamicprogramming_jl_tpu_torch import demos

F32 = torch.float32


# ---------------------------------------------------------------------------
# the JAX package's tests/test_demos.py
# ---------------------------------------------------------------------------

def test_demo_mpc_vmap_tier():
    x, errs = demos.demo_mpc(B=2, T=12, mpc_steps=2, inner_iters=1,
                             tier="vmap", verbose=False, device="cpu")
    assert x.shape == (2, 4)
    assert bool(torch.isfinite(x).all())
    assert len(errs) == 2


def test_demo_mpc_lanes_tier():
    """The receding-horizon loop on the lane path (warm_start entry), the
    kernels' plain versions on the CPU."""
    x, errs = demos.demo_mpc(B=2, T=6, mpc_steps=2, inner_iters=1,
                             tier="lanes", verbose=False, device="cpu")
    assert x.shape == (2, 4)
    assert bool(torch.isfinite(x).all())


def _jax_test_states(B, T, seed, dtype, device):
    """``tests/test_demos.py``'s initial states (JAX ``demo_mpc``'s
    ``PRNGKey`` draw), on which its tracking gate was calibrated."""
    z = np.asarray(jax.random.normal(jax.random.PRNGKey(seed), (B, 4),
                                     jnp.float32))
    x = (np.asarray(jpc.default_x0(jnp.float32))[None, :]
         + np.float32(0.2) * z * np.asarray([1, 1, 0, 0], np.float32))
    return (torch.tensor(x, dtype=dtype, device=device),
            torch.zeros((B, T, 1), dtype=dtype, device=device))


def test_mpc_warm_start_tracking_quality(monkeypatch):
    """The JAX test's quality gate (vmap tier, B=3, T=120, 30 steps, 2
    inner iterations; mean |angle err| 0.436 → 0.191 rad there), on the
    JAX test's own initial states: the gate was calibrated on them. The
    port's NumPy-seeded fleet of the same size starts partly in the
    hanging basin, where the JAX package's loop makes no progress either
    (0.675 → 0.681 rad, both packages)."""
    monkeypatch.setattr(demos, "_mpc_inputs", _jax_test_states)
    x, errs = demos.demo_mpc(B=3, T=120, mpc_steps=30, inner_iters=2,
                             tier="vmap", verbose=False, device="cpu")
    assert bool(torch.isfinite(x).all())
    assert errs[-1] < 0.30, f"MPC tracking regressed: {errs[0]:.3f} -> " \
                            f"{errs[-1]:.3f} rad (gate 0.30)"
    assert errs[-1] < 0.65 * errs[0], (
        f"MPC made no progress toward upright: {errs[0]:.3f} -> "
        f"{errs[-1]:.3f} rad")


def test_demo_fleet_small():
    res = demos.demo_fleet(B=2, T=30, max_iter=3, dtype=F32, device="cpu")
    assert bool(torch.isfinite(res.cost).all())


# ---------------------------------------------------------------------------
# main
# ---------------------------------------------------------------------------

def test_main_registry_help_and_exit_codes(capsys):
    """The JAX package's registry and default tour, ``--help`` (exit 0)
    and an unknown name (exit 2, nothing run)."""
    assert demos.main(["--help"]) == 0
    port = capsys.readouterr().out
    assert jdemos.main(["--help"]) == 0
    jax_help = capsys.readouterr().out
    line = [ln for ln in jax_help.splitlines() if "available" in ln]
    assert line and line[0] in port
    tour = [ln for ln in jax_help.splitlines() if "default" in ln][0]
    assert " ".join(demos.TOUR) in tour
    assert list(demos.REGISTRY) == line[0].split(": ")[1].split(", ")
    assert demos.main(["linear", "nope"]) == 2
    err = capsys.readouterr()
    assert "nope" in err.err and "Running" not in err.out


def test_main_runs_on_the_card(monkeypatch):
    """main runs the demos at their defaults, on the card: without one it
    raises (the device rule), naming the CPU route."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        demos.main(["boxqp"])
