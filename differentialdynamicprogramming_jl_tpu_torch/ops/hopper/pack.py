"""Stream layout of the Hopper kernels.

Counterpart of ``differentialdynamicprogramming_jl_tpu/ops/pallas/pack.py``.
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

import torch


@dataclasses.dataclass(frozen=True)
class DerivLayout:
    """Slot offsets of the packed derivative stack (row-major flattening of
    the fields of :class:`~..policy.Derivs`, first order only)."""

    n: int
    m: int

    @property
    def fx(self) -> int: return 0

    @property
    def fu(self) -> int: return self.n * self.n

    @property
    def cx(self) -> int: return self.fu + self.n * self.m

    @property
    def cu(self) -> int: return self.cx + self.n

    @property
    def cxx(self) -> int: return self.cu + self.m

    @property
    def cxu(self) -> int: return self.cxx + self.n * self.n

    @property
    def cuu(self) -> int: return self.cxu + self.n * self.m

    @property
    def D(self) -> int: return self.cuu + self.m * self.m


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
