"""Stream layout of the Hopper kernels.

Counterpart of ``differentialdynamicprogramming_jl_tpu/ops/pallas/pack.py``
(and of ``ops/pallas/backward_kernel.py::pack_backward_inputs``).
The TPU lane layout ``(T, s, nB, 8, 128)`` puts the scenario batch on (8, 128)
vector tiles. On the card one thread owns one scenario, so the same data is a
**stream** ``(T, s, B)`` with the scenario axis contiguous: at every (t, slot)
neighbouring threads read neighbouring addresses. A lane array reshaped to
``(T, s, nB·1024)`` and cut to ``B`` is exactly this stream
(:func:`~differentialdynamicprogramming_jl_tpu_torch.convert.stream_from_lanes`).

Small matrices are flattened row-major into the slot axis ``s``, as on the
TPU. B is not padded: each kernel masks ``b < B`` itself. The TPU's VMEM
block budget and ``clamp_k_t`` (timesteps per grid step) have no meaning
here — a kernel walks the whole horizon inside one thread — and are not
ported.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from ...policy import Derivs


# the fields of the packed derivative stack, in slot order
DERIV_FIELDS = ("fx", "fu", "cx", "cu", "cxx", "cxu", "cuu")


@dataclasses.dataclass(frozen=True)
class DerivLayout:
    """Slot offsets of the packed derivative stack (row-major flattening of
    the fields of :class:`~...policy.Derivs`, first order only, in
    :data:`DERIV_FIELDS` order): fx (n·n), fu (n·m), cx, cu, cxx (n·n),
    cxu (n·m), cuu (m·m), D slots in all."""

    n: int
    m: int

    def shape(self, field: str) -> tuple:
        """A field's per-step shape."""
        n, m = self.n, self.m
        return dict(fx=(n, n), fu=(n, m), cx=(n,), cu=(m,), cxx=(n, n),
                    cxu=(n, m), cuu=(m, m))[field]

    def offset(self, field: str) -> int:
        """A field's first slot; ``"D"`` gives the slot count."""
        i = len(DERIV_FIELDS) if field == "D" else DERIV_FIELDS.index(field)
        return sum(math.prod(self.shape(f)) for f in DERIV_FIELDS[:i])

    fx = property(lambda self: self.offset("fx"))
    fu = property(lambda self: self.offset("fu"))
    cx = property(lambda self: self.offset("cx"))
    cu = property(lambda self: self.offset("cu"))
    cxx = property(lambda self: self.offset("cxx"))
    cxu = property(lambda self: self.offset("cxu"))
    cuu = property(lambda self: self.offset("cuu"))
    D = property(lambda self: self.offset("D"))


def to_streams(a: torch.Tensor) -> torch.Tensor:
    """(B, T, ...) batch-major → contiguous (T, s, B) stream, s = prod of the
    per-scenario trailing dims (row-major)."""
    B, T = a.shape[0], a.shape[1]
    return a.reshape(B, T, -1).permute(1, 2, 0).contiguous()


def from_streams(a: torch.Tensor, shape=()) -> torch.Tensor:
    """(T, s, B) stream → (B, T, *shape) batch-major."""
    T, B = a.shape[0], a.shape[2]
    return a.permute(2, 0, 1).reshape((B, T) + tuple(shape))


def vec_to_streams(v: torch.Tensor) -> torch.Tensor:
    """(B,) → (B,): per-scenario vectors are already stream-shaped; kept for
    symmetry with the TPU layout's ``vec_to_lanes``."""
    return v.contiguous()


def vec_from_streams(a: torch.Tensor) -> torch.Tensor:
    """(B,) → (B,), see :func:`vec_to_streams`."""
    return a


def mean_t(a: torch.Tensor) -> torch.Tensor:
    """Mean over the time axis (dim 0) of a (T, ...) tensor, summed in one
    fixed pairwise order by elementwise adds. A lane's result then has the
    same bits whatever the batch around it: ``torch.mean(a, dim=0)`` picks
    its summation order from the tensor's shape (on the card and on the
    CPU), so a scenario compacted into a smaller batch by the fleet
    scheduler, or solved in another shard, would change in its last
    bits."""
    T = a.shape[0]
    while a.shape[0] > 1:
        h = a.shape[0] // 2
        s = a[:h] + a[h:2 * h]
        a = torch.cat([s, a[2 * h:]]) if a.shape[0] % 2 else s
    return a[0] / T


def pack_derivs(d: Derivs, B: int) -> torch.Tensor:
    """Batch-major :class:`~...policy.Derivs` ((B, T, ...) leaves, first
    order) → the packed ``(T, D, B)`` stream in :class:`DerivLayout` order
    (JAX ``pack.py:126``)."""
    T = d.fx.shape[1]
    return to_streams(torch.cat(
        [getattr(d, f).reshape(B, T, -1) for f in DERIV_FIELDS], dim=-1))


def pack_backward_inputs(derivs: Derivs, u: torch.Tensor,
                         B: int) -> torch.Tensor:
    """Batch-major ``Derivs`` and controls ``u`` (B, T, m) → K1's packed
    input ``(T, D+m, B)`` f32: the derivative stack with u appended (JAX
    ``backward_kernel.py:715``)."""
    return torch.cat([pack_derivs(derivs, B), to_streams(u)], dim=1).to(
        torch.float32)


def _flat(v) -> list:
    """A tile field (a tensor, or nested lists of them) → its row-major
    list of tensors."""
    if isinstance(v, (list, tuple)):
        return [e for row in v for e in _flat(row)]
    return [v]


def packed_from_tiles(tiles, n: int, m: int):
    """A packed-derivatives generator ``(x_s (T, n, B), u_s (T, m, B)) →
    (T, D+m, B)`` from a derivative-tile function: the tiles evaluated
    once on whole (T, B) slices (their operations are elementwise, so each
    element has the bits of a per-step evaluation), stacked in
    :class:`DerivLayout` order with u appended. ``t`` is the step index as
    a (T, 1) int32 tensor, as the JAX generators pass it (``jnp.arange``),
    so that ``t * h`` has the f32 bits of K1's per-step tiles."""
    def packed(x_s: torch.Tensor, u_s: torch.Tensor) -> torch.Tensor:
        T = u_s.shape[0]
        x = [x_s[:, i] for i in range(n)]
        u = [u_s[:, mi] for mi in range(m)]
        t = torch.arange(T, dtype=torch.int32, device=u_s.device)[:, None]
        return stack_tiles(tiles(x, u, t), u, n, m)

    return packed


def stack_tiles(d: dict, u: list, n: int, m: int) -> torch.Tensor:
    """The first-order fields of a tiles' result ``d`` on (T, B) slices and
    the controls ``u`` (m slices), stacked into the (T, D+m, B) stream in
    :class:`DerivLayout` order."""
    slots = [v for f in DERIV_FIELDS for v in _flat(d[f])] + u
    assert len(slots) == DerivLayout(n, m).D + m
    shape = u[0].shape
    return torch.stack([s.expand(shape) for s in slots], dim=1)
