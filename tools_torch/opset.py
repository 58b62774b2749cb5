"""A small lane model that uses every op the lowering gained beyond the
arithmetic and sin, cos, tanh, exp and sqrt (``ops/hopper/lower.py``): pow
at every exponent PyTorch's kernel special-cases and at 1.5, abs, log,
relu, minimum, maximum, the clamps, every comparison of values and of the
step t, logic on booleans, where, and a boolean made a float. Its dynamics
and cost have nonzero first and second derivatives through each op at
ordinary points, so K1's Dual and Jet passes (``Autodiff<Lowered>``), K2
and K3 all run every rule. ``tests/test_torch_lower.py``,
``tests/test_torch_cuda.py`` and ``chip_smoke.py``'s ops phase hold it
against the plain versions. Nothing here imports JAX.
"""
from __future__ import annotations

import torch


def opset_lanes(lanes_cls):
    """The op-set model, a ``lanes_cls`` (the port's LanesModel): pow at
    the exponents PyTorch special-cases (2, 3, 0.5, -1, -2) and at 1.5,
    abs, log, relu, minimum, maximum, clamp with both bounds, min only and
    max only, clamp_min, clamp_max, every comparison of values and of t,
    logic on booleans (logical_* and Python's &, |, ~), where, and a
    boolean made a float."""
    def dynamics(x, u, t):
        return [x[0] + 0.1 * x[1],
                x[1] + 0.1 * (torch.clamp(u[0], -2.0, 2.0)
                              - 0.5 * torch.relu(x[2])),
                x[2] + 0.05 * torch.maximum(u[1], -x[2])
                - 0.02 * torch.minimum(x[0], 0.5 * x[1])]

    def cost(x, u, t):
        a = torch.abs(x[0])
        c = (x[0] ** 2 + 0.1 * x[1] ** 3 + (a + 1.0) ** 0.5
             + (1.0 + x[2] ** 2) ** -1 + 0.3 * (2.0 + torch.abs(x[1])) ** -2
             + 0.2 * a ** 1.5 + 0.1 * torch.log(1.0 + (u[0] / 2.0) ** 2))
        c = (c + 3.0 * torch.clamp(a - 0.8, min=0.0) ** 2
             + 0.1 * torch.clamp(x[1], max=0.5)
             + 0.2 * torch.clamp_min(x[2], -0.3)
             + 0.3 * torch.clamp_max(u[1], 1.0))
        band = ((torch.abs(u[1]) > 1.0) & ~(u[1] <= -2.5)) | (x[0] >= 2.0)
        c = c + torch.where(band, 0.5 * (torch.abs(u[1]) - 1.0) ** 2,
                            torch.zeros_like(u[1]))
        c = c + torch.where(torch.logical_and(
            x[1] < x[2], torch.logical_not(x[0] == 0.25)), 0.1 * x[1],
            0.2 * x[2])
        t = torch.as_tensor(t)
        late = torch.logical_or(t >= 4, t == 1) & (t != 2)
        c = c + torch.where(late, 0.5 * u[0] ** 2, u[0] ** 2)
        return (c + 0.1 * (x[2] > 0.0).float()
                + torch.where(torch.ne(u[0], 0.0), 0.01 * u[1], u[0]))

    def terminal(x):
        return x[0] ** 2 + torch.abs(x[1]) + torch.relu(x[2] - 0.5)

    return lanes_cls(n=3, m=2, dynamics=dynamics, cost=cost,
                     terminal=terminal)


# the exponents PyTorch's pow kernel special-cases on a CUDA tensor (2, 3,
# ½, -1, -2, -½) and three that go to powf
POW_EXPONENTS = (2.0, 3.0, 0.5, -1.0, -2.0, -0.5, 1.5, 0.3)


def pow_lanes(lanes_cls, exponents=POW_EXPONENTS):
    """A model whose state i steps to ½x_i + 0.01·(1 + x_i²) ** e_i, one
    state an exponent (bounded for |x_i| ≤ 1): its K3 trajectory holds the
    lowering's pow (powc_) to torch.pow on the same inputs, slot by
    slot."""
    def dynamics(x, u, t):
        return [0.5 * x[i] + 0.01 * (1.0 + x[i] * x[i]) ** e + 0.0 * u[0]
                for i, e in enumerate(exponents)]

    def cost(x, u, t):
        return x[0] * x[0] + u[0] * u[0]

    return lanes_cls(n=len(exponents), m=1, dynamics=dynamics, cost=cost)
