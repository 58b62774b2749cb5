"""JAX's derivative rules where PyTorch's differ: abs, the clamps, maximum
and minimum.

The JAX package differentiates a user's model with JAX's rules, and the
port's three autodiff routes (K1's plain autodiff tiles,
``ops/hopper/autodiff_tiles.py``, the packed generator built on them, and
the generic tier's ``problem.make_autodiff_derivs``) give the same
derivatives. JAX's rules (``jax/_src/lax/lax.py``) differ from PyTorch's
in these ops:

- ``abs``: the tangent is ``select(x >= 0, t, -t)``, +t at +0 and -0
  (PyTorch: t·sgn(x), 0 at 0);
- ``maximum(x, y)`` / ``minimum(x, y)``: ``tx·wx + ty·wy`` with the
  balanced weights ``w = (x == z) / (1 + (y == z))`` of the result z: ½
  each at a tie, else 1 for the operand taken and 0 for the other
  (PyTorch: ``ty + w·(tx - ty)``, which rounds);
- ``clamp(x, lo, hi)`` is ``jnp.clip``, ``minimum(maximum(x, lo), hi)``:
  the tangent ``(t·w1)·w2`` with the balanced weights of each step, ½ on
  a bound and ¼ where lo == hi, and a tensor bound's own tangent takes
  the other half; ``clamp_min`` is the maximum alone and ``clamp_max``
  the minimum alone (PyTorch: 1 on the bound);
- ``relu`` is JAX's custom rule, 0 at 0, as PyTorch's: unchanged.

:class:`jax_ties` is a ``TorchFunctionMode`` that the autodiff routes enter
around a user's functions only. In it each of these ops returns PyTorch's
own value ``v`` with the tangent of a carrier ``a``, an expression in
ordinary differentiable ops whose tangent is JAX's rule: ``v - (a° - a)``
(° detached), where ``a° - a`` is exactly +0 for a finite ``a``, so that
every value keeps its bits (-0 included), ``vmap``, nested ``jvp`` (the
Jet passes), ``grad`` and ``jacfwd`` over ``grad`` compose, and every
tangent is JAX's, its rounding included. ``abs`` needs no carrier: its
value is ``where(x >= 0, x, -x) + 0``. Where a carrier is not finite (an
infinite or NaN operand that the result takes), the tangent is 0.
``csrc/autodiff.cuh`` has the same rules for K1's Dual and Jet passes.
"""
from __future__ import annotations

import torch
from torch.overrides import TorchFunctionMode


def _balanced(x, z, y):
    """JAX's ``_balanced_eq(x, z, y)``: 1 where x is the result z and y is
    not, ½ where both are, 0 where x is not; detached, in z's dtype."""
    one = torch.ones_like(z)
    return (torch.where(x == z, one, torch.zeros_like(z))
            / torch.where(y == z, one + one, one)).detach()


def _carry(v: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """v's value with a's tangent."""
    v, ad = v.detach(), a.detach()
    return torch.where(torch.isfinite(ad), v - (ad - a), v)


def _abs(x):
    return torch.where(x >= 0, x, -x) + 0.0


def _clamp(fn, x, lo, hi, args, kwargs):
    """``fn(x, *args, **kwargs)`` (a clamp with bounds lo, hi, each a
    number, a float tensor or None) with the tangent of JAX's clip, whose
    steps are maximum(lo, x) and minimum(hi, ·): (t·w1)·w2 for number
    bounds, and a tensor bound's own tangent times its weight added at its
    step."""
    a, r = x, x.detach()
    for b, pick in ((lo, torch.maximum), (hi, torch.minimum)):
        if b is None:
            continue
        bd = b.detach() if torch.is_tensor(b) else torch.full_like(r, b)
        z = pick(r, bd)
        a = a * _balanced(r, z, bd)
        if torch.is_tensor(b):
            a = a + b * _balanced(bd, z, r)
        r = z
    return _carry(fn(x, *args, **kwargs), a)


def _chooser(fn, x, y):
    """``fn(x, y)`` (maximum or minimum) with JAX's tangent tx·wx + ty·wy."""
    v = fn(x, y)
    z, xd, yd = v.detach(), x.detach(), y.detach()
    return _carry(v, x * _balanced(xd, z, yd) + y * _balanced(yd, z, xd))


_ABS = {torch.abs, torch.absolute, torch.Tensor.abs, torch.Tensor.absolute,
        torch.Tensor.__abs__}
# each clamp form and the names of its positional bounds
_CLAMPS = {torch.clamp: ("min", "max"), torch.clip: ("min", "max"),
           torch.Tensor.clamp: ("min", "max"),
           torch.Tensor.clip: ("min", "max"),
           torch.clamp_min: ("min",), torch.Tensor.clamp_min: ("min",),
           torch.clamp_max: ("max",), torch.Tensor.clamp_max: ("max",)}
_CHOOSERS = {torch.maximum, torch.minimum, torch.Tensor.maximum,
             torch.Tensor.minimum, torch.max, torch.min, torch.Tensor.max,
             torch.Tensor.min}


def _float_tensor(x) -> bool:
    return isinstance(x, torch.Tensor) and x.is_floating_point()


def _bound(b) -> bool:
    return b is None or _float_tensor(b) or (
        isinstance(b, (int, float)) and not isinstance(b, bool))


class jax_ties(TorchFunctionMode):
    """Within it, abs, clamp/clip, clamp_min and clamp_max with number or
    float tensor bounds, and maximum/minimum of two float tensors (``torch.max``/``min`` of two
    tensors too) take JAX's derivative rules; every value, and every other
    call, is PyTorch's."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if args and _float_tensor(args[0]):
            x = args[0]
            if func in _ABS and len(args) == 1 and not kwargs:
                return _abs(x)
            names = _CLAMPS.get(func)
            if names is not None and len(args) - 1 <= len(names):
                bounds = dict(zip(names, args[1:]), **kwargs)
                if set(bounds) <= set(names) and all(
                        _bound(b) for b in bounds.values()):
                    return _clamp(func, x, bounds.get("min"),
                                  bounds.get("max"), args[1:], kwargs)
            if func in _CHOOSERS and len(args) == 2 and not kwargs \
                    and _float_tensor(args[1]):
                return _chooser(func, x, args[1])
        return func(*args, **kwargs)
