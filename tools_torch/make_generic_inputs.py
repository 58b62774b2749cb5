#!/usr/bin/env python3
"""Write ``tools_torch/generic_inputs.npz``: the JAX package's inputs and
outcomes that ``chip_smoke.py``'s generic phases compare the port with on
the card, whose machine has no JAX.

Run from the root of a checkout, with JAX on the CPU::

    python3 tools_torch/make_generic_inputs.py

Contents (all f64 unless said):

- ``lti_golden_*``: ``random_lti(PRNGKey(0), n=10, m=2, T=400)``'s A, B, Q,
  R, x0 and u0 (``tests/test_golden.py::test_linear_golden``);
- ``lti_kl_*``: the same at n=4, m=2, T=60 (the golden ``ilqg_kl`` cases);
- ``lti_demo_*``: the same at n=10, m=2, T=1000 (``demos.demo_linear``);
- ``qp_n50_H``, ``qp_n50_g``: the golden n=50 box QP
  (``tests/test_golden.py::_boxqp_cases``);
- ``demo_linear_{cost,n_iters,reason}`` and
  ``demo_linear_parallel_{cost,n_iters,reason}``: JAX's CPU outcome of
  ``ilqg`` on ``lti_demo`` with ``ILQGConfig()``, and with
  ``ILQGConfig(backward="parallel")``: the total cost, the iterations and
  the exit reason.

``tests/test_torch_generic_ilqg.py`` rebuilds the spec and QP arrays and
checks them against this file bit for bit.
"""
from __future__ import annotations

import os
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
OUT = ROOT / "tools_torch" / "generic_inputs.npz"
SPECS = {"lti_golden": (10, 2, 400), "lti_kl": (4, 2, 60),
         "lti_demo": (10, 2, 1000)}


def spec_arrays() -> dict:
    """The spec and QP arrays, from the JAX package on the CPU."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from differentialdynamicprogramming_jl_tpu.models.linear import random_lti
    out = {}
    for name, (n, m, T) in SPECS.items():
        spec = random_lti(jax.random.PRNGKey(0), n=n, m=m, T=T,
                          dtype=jnp.float64)
        for field in spec._fields:
            out[f"{name}_{field}"] = np.asarray(getattr(spec, field))
    A = np.asarray(jax.random.normal(jax.random.PRNGKey(0), (50, 50),
                                     jnp.float64))
    out["qp_n50_H"] = A @ A.T + 0.1 * np.eye(50)
    out["qp_n50_g"] = np.asarray(jax.random.normal(jax.random.PRNGKey(1),
                                                   (50,), jnp.float64))
    return out


def main() -> int:
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    sys.path.insert(0, str(ROOT))
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    import numpy as np
    from differentialdynamicprogramming_jl_tpu.models.linear import (
        LTISpec, make_lti_problem)
    from differentialdynamicprogramming_jl_tpu.solvers.ilqg import (
        ILQGConfig, ilqg)

    out = spec_arrays()
    T = SPECS["lti_demo"][2]
    spec = LTISpec(*(jnp.asarray(out[f"lti_demo_{f}"])
                     for f in LTISpec._fields))
    prob = make_lti_problem(spec, T)
    for tag, cfg in (("demo_linear", ILQGConfig()),
                     ("demo_linear_parallel", ILQGConfig(
                         backward="parallel"))):
        res = ilqg(prob, spec.x0, spec.u0, cfg=cfg)
        out[f"{tag}_cost"] = np.float64(jnp.sum(res.cost))
        out[f"{tag}_n_iters"] = np.int64(res.n_iters)
        out[f"{tag}_reason"] = np.int64(res.reason)
        print(f"{tag}: cost {float(out[f'{tag}_cost'])!r}, n_iters "
              f"{int(out[f'{tag}_n_iters'])}, reason "
              f"{int(out[f'{tag}_reason'])}")
    np.savez(OUT, **out)
    print(f"wrote {OUT.relative_to(ROOT)} ({OUT.stat().st_size} bytes)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
