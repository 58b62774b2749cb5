"""Checkpoint / warm-start serialization.

Counterpart of ``differentialdynamicprogramming_jl_tpu/utils/serialization.py``.
The reference has no checkpointing; its moral equivalent is warm starting —
pre-rolled ``x0`` + ``cost`` kwargs (``src/iLQG.jl:85-87,193-197``) and
``traj_prev`` re-centering in the GPS loop (``src/demo_linear.jl:124-130``).
Any result tree of the port (GaussianPolicy, trajectories, ILQGResult,
BatchILQGResult, solver state) round-trips to a single ``.npz`` file, so MPC
fleets can checkpoint and resume warm starts across processes and hosts.

The files have the JAX package's keys: ``leaf_i`` and ``__treedef__`` for a
tree, ``K``, ``k``, ``sigma``, ``sigma_inv`` for a policy, ``x``, ``u``,
``cost`` for a warm start, so a policy or a warm start written by one
package loads in the other. Loading never unpickles
(``np.load(..., allow_pickle=False)``) and puts the tensors on ``device``
(None: the CUDA card).
"""
from __future__ import annotations

import json
from typing import Any, List

import numpy as np
import torch

from ..device import resolve
from ..policy import GaussianPolicy


def _flatten(tree: Any, leaves: List) -> str:
    """Append ``tree``'s leaves to ``leaves`` in the JAX package's order
    (NamedTuple fields, tuple and list items, dict values by sorted key;
    None holds no leaf); returns a description of the structure."""
    if tree is None:
        return "None"
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        kids = [_flatten(v, leaves) for v in tree]
        return f"{type(tree).__name__}({', '.join(kids)})"
    if isinstance(tree, (tuple, list)):
        kids = [_flatten(v, leaves) for v in tree]
        return f"{type(tree).__name__}[{', '.join(kids)}]"
    if isinstance(tree, dict):
        kids = [f"{k}: {_flatten(tree[k], leaves)}" for k in sorted(tree)]
        return "{" + ", ".join(kids) + "}"
    leaves.append(tree)
    return "*"


def _unflatten(like: Any, leaves) -> Any:
    """``like``'s structure with its leaves taken in order from the
    iterator ``leaves``."""
    if like is None:
        return None
    if isinstance(like, tuple) and hasattr(like, "_fields"):
        return type(like)(*[_unflatten(v, leaves) for v in like])
    if isinstance(like, (tuple, list)):
        return type(like)(_unflatten(v, leaves) for v in like)
    if isinstance(like, dict):
        return {k: _unflatten(like[k], leaves) for k in sorted(like)}
    return next(leaves)


def _host(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _load(path: str) -> np.lib.npyio.NpzFile:
    return np.load(path, allow_pickle=False)


def _tensor(a: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.array(a)).to(resolve(device))


def save_pytree(path: str, tree: Any) -> None:
    """Serialize a tree of tensors (NamedTuples, tuples, lists, dicts) to
    ``path`` (.npz): its leaves as ``leaf_i`` and, as JSON in
    ``__treedef__``, their count and a description of the structure. The
    structure is rebuilt by :func:`load_pytree` against a matching ``like``
    tree, or the leaves come back as a flat list."""
    leaves: List = []
    desc = _flatten(tree, leaves)
    arrays = {f"leaf_{i}": _host(leaf) for i, leaf in enumerate(leaves)}
    arrays["__treedef__"] = np.frombuffer(
        json.dumps({"n_leaves": len(leaves), "treedef": desc}).encode(),
        dtype=np.uint8)
    np.savez(path, **arrays)


def load_pytree(path: str, like: Any = None, device=None):
    """Load a tree saved by :func:`save_pytree` onto ``device`` (None: the
    CUDA card).

    ``like``: a tree of the same structure (its leaf values are ignored)
    whose NamedTuples are rebuilt. Without it, returns the flat leaf list.
    """
    data = _load(path)
    meta = json.loads(bytes(data["__treedef__"]).decode())
    leaves = [_tensor(data[f"leaf_{i}"], device)
              for i in range(meta["n_leaves"])]
    if like is None:
        return leaves
    it = iter(leaves)
    tree = _unflatten(like, it)
    if next(it, None) is not None:
        raise ValueError(f"{path}: {meta['n_leaves']} leaves, more than "
                         "the structure of `like` holds")
    return tree


def save_policy(path: str, policy: GaussianPolicy) -> None:
    """Save a (possibly batched) :class:`GaussianPolicy`."""
    np.savez(path, K=_host(policy.K), k=_host(policy.k),
             sigma=_host(policy.sigma), sigma_inv=_host(policy.sigma_inv))


def load_policy(path: str, device=None) -> GaussianPolicy:
    """Load a policy saved by :func:`save_policy` (or by the JAX package's)
    onto ``device`` (None: the CUDA card)."""
    data = _load(path)
    return GaussianPolicy(K=_tensor(data["K"], device),
                          k=_tensor(data["k"], device),
                          sigma=_tensor(data["sigma"], device),
                          sigma_inv=_tensor(data["sigma_inv"], device))


def save_warm_start(path: str, x, u, cost) -> None:
    """Save a pre-rolled trajectory for warm starting (the reference's
    pre-rolled ``x0``+``cost`` convention, ``src/iLQG.jl:193-197``)."""
    np.savez(path, x=_host(x), u=_host(u), cost=_host(cost))


def load_warm_start(path: str, device=None):
    """``(x, u, cost)`` saved by :func:`save_warm_start` (or by the JAX
    package's), on ``device`` (None: the CUDA card)."""
    data = _load(path)
    return tuple(_tensor(data[k], device) for k in ("x", "u", "cost"))
