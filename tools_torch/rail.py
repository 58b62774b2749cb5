"""The pendcart on a finite rail, written once for both packages.

:func:`rail_lanes` takes the array module ``xp`` (``torch`` or
``jax.numpy``), the package's ``LanesModel`` class and the package's own
pendcart lane model, and returns a lane model without a device descriptor:
the pendcart's dynamics and terminal cost, and its running cost (state order
θ, θ̇, p, ṗ) plus

- 100·max(|p| - 1.5, 0)²: the cart past the rail's end at ±1.5;
- 0.1·log(1 + (ṗ/2)²): a Cauchy loss on the cart's speed;
- ½(|u| - 4)² where |u| > 4: a soft band before the hard limit ±5.

It uses abs, clamp (jnp.clip), pow, log, a comparison and where, so on the
card it runs through the lowering's op set (``ops/hopper/lower.py``). The
cost meets no tie where the packages' rules differ: at p = 0 the clamp's
operand is -1.5 (derivative 0 in both), and at |u| = 5 the band's branch
has |u|' = ±1.

:func:`leaves_rail` is the share of lanes whose cart passes the rail's end
at some step of a (B, T, n) trajectory.

Nothing here imports JAX.
"""
from __future__ import annotations

RAIL = 1.5          # the rail's end, |p|
RAIL_WEIGHT = 100.0
SPEED_SCALE = 2.0   # the Cauchy loss's scale on ṗ
SPEED_WEIGHT = 0.1
BAND = 4.0          # the soft band's start, |u|


def rail_lanes(xp, lanes_cls, base):
    """The rail model over ``base``, the package's ``pendcart_lanes``."""
    torch_like = hasattr(xp, "clamp")

    def past(v):
        return (xp.clamp(v, min=0.0) if torch_like
                else xp.clip(v, 0.0, None))

    def cost(x, u, t):
        over = past(xp.abs(x[2]) - RAIL)
        c = base.cost(x, u, t) + RAIL_WEIGHT * over ** 2
        c = c + SPEED_WEIGHT * xp.log(1.0 + (x[3] / SPEED_SCALE) ** 2)
        return c + xp.where(xp.abs(u[0]) > BAND,
                            0.5 * (xp.abs(u[0]) - BAND) ** 2,
                            xp.zeros_like(u[0]))

    return lanes_cls(n=4, m=1, dynamics=base.dynamics, cost=cost,
                     terminal=base.terminal)


def leaves_rail(x) -> float:
    """The share of lanes of a (B, T, n) trajectory (a torch tensor) whose
    |p| passes RAIL at some step."""
    return float((x[:, :, 2].abs() > RAIL).any(dim=1).float().mean())
