"""The bandwidth-floor probe (K5).

Counterpart of ``tools/probe_kernel_cost.py::make``, the JAX package's probe
that separates memory cost from compute cost at the backward kernel's stream
shapes: three kernels over one ``(T, 47, B)`` stream, walked from t = T-1
down to 0, each writing a ``(T, 27, B)`` stream.

- ``"copy"``: the first 27 input slots of each step, copied (traffic only);
- ``"light"``: a running sum ``acc = acc + x[t, i % 47]·mult`` over 60
  terms a step, written to all 27 output slots;
- ``"full"``: the same with 600 terms a step.

The TPU probe never initialised its two scratch values (the running sum and
the multiplier, ``probe_kernel_cost.py:47-50``); here they are fixed to 0
and 1. The JAX probe walks its time blocks in reverse but the steps inside
a block forward (a TPU tiling detail); here every step is taken in reverse,
so the running sums of the two packages differ in order.

:func:`probe_lanes` gives a CPU tensor to :func:`probe_lanes_ref`, the plain
PyTorch version (vectorised over B, Python loop over t and the terms), and a
CUDA tensor to the kernel in ``csrc/probe.cu`` with its launch plan
(:func:`.plan.probe_plan`), or raises. Launches are counted in
``probe_lanes.launches``.
"""
from __future__ import annotations

import torch

from . import _build
from .forward_kernel import launch_args
from .plan import probe_plan

S_IN, S_OUT = 47, 27          # the JAX probe's DU and S
MODES = {"copy": 0, "light": 60, "full": 600}   # multiply-add terms a step
MULT = 1.0                    # the multiplier of the running sum


def probe_lanes_ref(x: torch.Tensor, mode: str) -> torch.Tensor:
    """Plain version of :func:`probe_lanes` (same arguments)."""
    T, _, B = x.shape
    if mode == "copy":
        return x[:, :S_OUT].clone()
    idx = torch.tensor([i % S_IN for i in range(MODES[mode])],
                       device=x.device)
    out = torch.empty((T, S_OUT, B), dtype=x.dtype, device=x.device)
    acc = torch.zeros((B,), dtype=x.dtype, device=x.device)
    for t in range(T - 1, -1, -1):
        terms = x[t, idx] * MULT            # each term rounded as the kernel's
        for i in range(len(idx)):
            acc = acc + terms[i]
        out[t] = acc
    return out


def probe_lanes(x: torch.Tensor, mode: str) -> torch.Tensor:
    """Run one probe kernel over ``x`` (T, 47, B) f32; returns (T, 27, B).
    ``mode``: ``"copy"``, ``"light"`` or ``"full"``."""
    if mode not in MODES:
        raise ValueError(f"mode={mode!r}: one of {tuple(MODES)}")
    T, S, B = x.shape
    if S != S_IN or T < 1:
        raise ValueError(f"probe_lanes: x {tuple(x.shape)}, expected "
                         f"(T, {S_IN}, B)")
    if x.device.type == "cpu":
        return probe_lanes_ref(x, mode)
    lib, dev, stream = launch_args("probe_lanes", x)
    out = torch.empty((T, S_OUT, B), dtype=torch.float32, device=x.device)
    plan = probe_plan(mode, T, B)
    rc = lib.ddp_probe_lanes(x.data_ptr(), out.data_ptr(), T, S_IN, S_OUT, B,
                             list(MODES).index(mode), MULT,
                             *plan.launcher_args(), dev, stream)
    _build.check(lib, rc, "probe_lanes")
    probe_lanes.launches += 1
    return out


probe_lanes.launches = 0
