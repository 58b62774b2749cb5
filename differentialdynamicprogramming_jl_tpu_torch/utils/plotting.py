"""Optional matplotlib plotting — counterpart of
``differentialdynamicprogramming_jl_tpu/utils/plotting.py``, the
reference's Requires.jl-conditional Plots hooks
(``src/DifferentialDynamicProgramming.jl:11-37``): plotting activates only
if matplotlib is importable; the core never depends on it. Tensors are
moved to the host and drawn with the ``Agg`` backend into PNG files."""
from __future__ import annotations

import numpy as np
import torch


def plotting_available() -> bool:
    try:
        import matplotlib  # noqa: F401
        return True
    except ImportError:
        print("Install matplotlib to plot demo results")
        return False


def _np(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def _pyplot():
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def plot_linear(res, path: str = "demo_linear.png"):
    """State/control/cost panels (reference ``plotstuff_linear``,
    ``src/DifferentialDynamicProgramming.jl:14-21``)."""
    plt = _pyplot()
    fig, ax = plt.subplots(2, 2, figsize=(10, 7))
    ax[0, 0].plot(_np(res.x))
    ax[0, 0].set_title("State trajectories")
    ax[0, 1].plot(_np(res.cost), "k", lw=2)
    ax[0, 1].set_title("Cost")
    ax[1, 0].plot(_np(res.u))
    ax[1, 0].set_title("Control signals")
    tr_cost = _np(res.trace.cost)
    n = int(res.n_iters)
    ax[1, 1].plot(tr_cost[:n + 1])
    ax[1, 1].set_title("Total cost per iteration")
    for a in ax.flat:
        a.set_xlabel("Time step")
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)
    print(f"saved {path}")


def plot_pendcart(x00, u00, res, path: str = "demo_pendcart.png"):
    """Simulation-vs-optimized panels (reference ``plotstuff_pendcart``,
    ``src/DifferentialDynamicProgramming.jl:22-35``)."""
    plt = _pyplot()
    x00, u00 = _np(x00), _np(u00)
    x, u = _np(res.x), _np(res.u)
    fig, ax = plt.subplots(2, 3, figsize=(13, 7))
    for i in range(4):
        a = ax[i // 2, i % 2]
        a.plot(x00[:, i], label="LQG simulation")
        a.plot(x[:, i], label="iLQG optimized")
        a.set_title(f"x{i + 1}")
        a.legend()
    ax[0, 2].plot(u00, label="LQG")
    ax[0, 2].plot(u, label="optimized")
    ax[0, 2].set_title("Control signal")
    ax[0, 2].legend()
    n = int(res.n_iters)
    ax[1, 2].loglog(np.arange(1, n + 1), _np(res.trace.cost)[1:n + 1])
    ax[1, 2].set_title("Total cost per iteration")
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)
    print(f"saved {path}")
