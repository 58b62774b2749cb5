"""The pendcart whose derivatives meet ties, written once for both packages.

:func:`tie_lanes` takes the array module ``xp`` (``torch`` or
``jax.numpy``), the package's ``LanesModel`` class and the package's own
pendcart lane model, and returns a lane model without a device descriptor:
the pendcart whose dynamics clamp u to ±``LIM`` (the solver's own limits)
and whose running cost adds ``L1``·|u|. Started at u = 0, every first
backward pass differentiates |u| at 0, and every control the box QP
saturates sits on the clamp's bound, the two ties where PyTorch's rules and
JAX's differ (|x|' at 0: 0 against 1; a clamp on its bound: 1 against ½).
The port takes JAX's (``ops/tie_rules.py``, ``csrc/autodiff.cuh``), so
its fleet and the JAX package's agree here.

:func:`tie_count` counts the steps of a (T, S, B) trajectory stream whose
control sits at a tie.

Nothing here imports JAX.
"""
from __future__ import annotations

LIM = 5.0     # the clamp in the dynamics, and the solver's limits, ±LIM
L1 = 0.1      # the weight of |u| in the running cost
LIMS = ((-LIM, LIM),)


def tie_lanes(xp, lanes_cls, base):
    """The tie model over ``base``, the package's ``pendcart_lanes``."""
    torch_like = hasattr(xp, "clamp")

    def clip(v):
        return xp.clamp(v, -LIM, LIM) if torch_like else xp.clip(v, -LIM, LIM)

    def dynamics(x, u, t):
        return base.dynamics(x, [clip(u[0])], t)

    def cost(x, u, t):
        return base.cost(x, u, t) + L1 * xp.abs(u[0])

    return lanes_cls(n=4, m=1, dynamics=dynamics, cost=cost,
                     terminal=base.terminal)


def tie_count(traj) -> dict:
    """The steps of a (T, S, B) torch trajectory stream (slot 4 the
    control) whose control is 0 (|u|'s tie) or ±LIM (the clamp's)."""
    u = traj[:, 4]
    return dict(zero=int((u == 0).sum()), bound=int((u.abs() == LIM).sum()),
                steps=int(u.numel()))
