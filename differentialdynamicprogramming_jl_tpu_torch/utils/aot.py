"""Solver export — build once, serve from bytes, without the closure.

Counterpart of ``differentialdynamicprogramming_jl_tpu/utils/aot.py``. The
JAX package traces and lowers a solver with ``jax.export`` and serializes
the program. The port's solvers are host loops that read flags back every
iteration and launch hand-written CUDA kernels through ctypes, which
``torch.export`` captures neither of, so the artifact here is a *recipe*:
the solver entry that ``fn`` calls, and how to rebuild its arguments.

How: :func:`export_solver` calls ``fn(*example_args)`` once with recording
on. The public solver entries (``ilqg``, ``ilqg_kl``, ``ilqg_batched``,
``ilqg_batch_lanes``, ``ilqgkl_batch_lanes``, ``ilqg_fleet``,
``ilqgkl_fleet``) record their own call through :func:`recorded`; the
package's model and tile factories tag what they return with their name and
arguments through :func:`factory`. ``fn`` must call exactly one recorded
entry, at its top level, and return that entry's result.

What the artifact holds: bytes of an ``.npz`` (no pickle: every member is
a plain array, loaded with ``allow_pickle=False``) with a JSON recipe in
``__recipe__`` and the constant tensors in ``const_i``. The recipe names
the entry, says which of its arguments are the example tensors (matched by
identity) with their shapes and dtypes, and encodes every other argument:
``ILQGConfig``/``ILQGKLConfig`` and the specs by their fields, limits and
keywords as JSON, tensors as constants (with their device), and models,
tiles, problems and derivative generators as the factory calls that made
them (``pendcart_lanes(PendCartSpec(...))``, ``autodiff_derivs_tiles(
quadrotor_lanes(...))``, ``make_lti_problem(LTISpec(...), T)``, ...). It
also holds the package version and the kernel instances the export run
launched: the launches of each kernel wrapper and the device descriptor
(model id, n, m, autodiff, second order) of each model and tiles argument.

What it refuses (TypeError at export, saying what can be exported): a
``fn`` that calls no recorded entry, or more than one, or returns anything
but that entry's result; an argument the recipe cannot rebuild — a model,
tiles, problem or callback the package's factories did not make (a user's
own Python ``LanesModel`` or ``DerivsTiles``), or any other object; an
example argument that is not a tensor.

Serving: :func:`deserialize_solver` rebuilds the models once and returns a
callable that takes tensors of the example shapes and dtypes (else
``ValueError`` naming the shape mismatch) and calls the recorded entry,
returning its native result type (``ILQGResult``, ``BatchILQGResult``,
...). Shapes and dtypes are fixed at export, one artifact per deployment
shape, as with ``jax.export``. Kernels are built at their first launch in
the serving process, as in any other.

Usage::

    solve = lambda x0s, u0s: ilqg_batch_lanes(model, None, x0s, u0s, ...)
    blob = serialize_solver(solve, x0s, u0s)          # build machine
    Path("solver.bin").write_bytes(blob)

    serve = deserialize_solver(Path("solver.bin").read_bytes())
    res = serve(x0s, u0s)                             # serving process
"""
from __future__ import annotations

import contextvars
import dataclasses
import functools
import importlib
import io
import json
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

__all__ = [
    "register_serialization",
    "export_solver",
    "serialize_solver",
    "deserialize_solver",
    "save_solver",
    "load_solver",
]

FORMAT = 1
_PKG = __name__.rsplit(".", 2)[0]
# the modules whose entries and factories register themselves on import
_MODULES = ("solvers.ilqg", "solvers.ilqgkl", "solvers.batch",
            "solvers.batch_kl", "solvers.fleet", "parallel.mesh",
            "models.pendcart", "models.linear", "models.quadrotor",
            "ops.hopper.autodiff_tiles")
# the value types a recipe rebuilds from their fields
_TYPES = ("models.pendcart.PendCartSpec", "models.quadrotor.QuadrotorSpec",
          "models.linear.LTISpec", "models.linear.SimpleLTVModel",
          "solvers.ilqg.ILQGConfig",
          "solvers.ilqgkl.ILQGKLConfig", "policy.GaussianPolicy")
# the kernel wrappers whose launches the recipe counts
_WRAPPERS = (("ops.hopper.backward_kernel", "backward_lanes"),
             ("ops.hopper.forward_kernel", "linesearch_lanes"),
             ("ops.hopper.forward_kernel", "forward_lanes"),
             ("ops.hopper.covariance_kernel", "covariance_lanes"))
EXPORTABLE = ("fn must call exactly one of the recorded solver entries "
              "(ilqg, ilqg_kl, ilqg_batched, ilqg_batch_lanes, "
              "ilqgkl_batch_lanes, ilqg_fleet, ilqgkl_fleet) and return "
              "its result; its arguments may be the example tensors, other "
              "tensors, ILQGConfig/ILQGKLConfig, specs, limits and keywords, "
              "and models, tiles, problems and derivative generators made by "
              "the package's factories")

_ENTRIES: Dict[str, Callable] = {}
_FACTORIES: Dict[str, Callable] = {}
# the calls a running export has recorded (None: not exporting), and how
# deep in recorded entries the current call is
_RECORD: contextvars.ContextVar = contextvars.ContextVar("ddp_aot_record",
                                                         default=None)
_DEPTH: contextvars.ContextVar = contextvars.ContextVar("ddp_aot_depth",
                                                        default=0)
_TAG = "_ddp_recipe"


def _name(fn: Callable) -> str:
    return f"{fn.__module__[len(_PKG) + 1:]}.{fn.__qualname__}"


def recorded(fn: Callable) -> Callable:
    """Make a public solver entry exportable: while :func:`export_solver`
    runs, a call to it from ``fn``'s top level is recorded with its bound
    arguments and its result. Calls the entry makes itself are not. Its
    parameters are named (no ``*args``, ``**kwargs`` or positional-only
    ones), so that a recipe calls it by keyword."""
    import inspect
    sig = inspect.signature(fn)
    assert all(p.kind in (p.POSITIONAL_OR_KEYWORD, p.KEYWORD_ONLY)
               for p in sig.parameters.values()), fn
    name = _name(fn)

    @functools.wraps(fn)
    def entry(*args, **kwargs):
        rec = _RECORD.get()
        depth = _DEPTH.get()
        token = _DEPTH.set(depth + 1)
        try:
            out = fn(*args, **kwargs)
        finally:
            _DEPTH.reset(token)
        if rec is not None and depth == 0:
            bound = sig.bind(*args, **kwargs)
            rec.append((name, dict(bound.arguments), out))
        return out

    _ENTRIES[name] = entry
    return entry


def factory(fn: Callable) -> Callable:
    """Tag what a model, tiles or problem factory returns with the call
    that made it, so that a recipe can make it again."""
    name = _name(fn)

    @functools.wraps(fn)
    def make(*args, **kwargs):
        obj = fn(*args, **kwargs)
        object.__setattr__(obj, _TAG, (name, args, kwargs))
        return obj

    _FACTORIES[name] = make
    return make


def register_serialization() -> None:
    """Import the modules whose solver entries and factories register
    themselves (idempotent), so that a recipe can name and rebuild them."""
    for mod in _MODULES:
        importlib.import_module(f"{_PKG}.{mod}")


def _type(path: str):
    if path not in _TYPES:
        raise ValueError(f"recipe: unknown type {path!r}")
    mod, cls = path.rsplit(".", 1)
    return getattr(importlib.import_module(f"{_PKG}.{mod}"), cls)


def _type_path(obj) -> Optional[str]:
    mod = type(obj).__module__
    if not mod.startswith(_PKG + "."):
        return None
    path = f"{mod[len(_PKG) + 1:]}.{type(obj).__qualname__}"
    return path if path in _TYPES and type(obj) is _type(path) else None


class _Encoder:
    """A call's arguments as JSON, with the tensors that are not example
    arguments collected as constants."""

    def __init__(self, examples: Sequence[torch.Tensor]):
        self.examples = examples
        self.consts: List[np.ndarray] = []
        self.devices: List[str] = []
        self.descriptors: List[dict] = []

    def __call__(self, v: Any, where: str) -> Any:
        if isinstance(v, np.generic):
            v = v.item()
        if v is None or isinstance(v, (bool, int, float, str)):
            return v
        if isinstance(v, torch.Tensor):
            for i, e in enumerate(self.examples):
                if v is e:
                    return {"arg": i}
            return self.const(v.detach().cpu().numpy(), str(v.device))
        if isinstance(v, np.ndarray) and v.dtype != object:
            return self.const(v, "numpy")
        if isinstance(v, torch.dtype):
            return {"dtype": str(v).replace("torch.", "")}
        if isinstance(v, torch.device):
            return {"device": str(v)}
        tag = getattr(v, _TAG, None)
        if tag is not None:
            name, args, kwargs = tag
            dm = getattr(v, "device", None)
            if dm is not None and hasattr(dm, "model_id"):
                self.descriptors.append(dict(
                    arg=where, factory=name, model_id=dm.model_id,
                    autodiff=dm.autodiff, second_order=dm.second_order,
                    **({"n": v.n, "m": v.m} if hasattr(v, "n") else {})))
            return {"factory": name,
                    "args": [self(a, f"{where}.{name}[{i}]")
                             for i, a in enumerate(args)],
                    "kwargs": {k: self(a, f"{where}.{name}.{k}")
                               for k, a in kwargs.items()}}
        path = _type_path(v)
        if path is not None:
            if dataclasses.is_dataclass(v):
                fields = {f.name: self(getattr(v, f.name), f"{where}.{f.name}")
                          for f in dataclasses.fields(v)}
            else:
                fields = {k: self(a, f"{where}.{k}")
                          for k, a in zip(v._fields, v)}
            return {"type": path, "fields": fields}
        if isinstance(v, (tuple, list)):
            return {"tuple" if isinstance(v, tuple) else "list":
                    [self(a, f"{where}[{i}]") for i, a in enumerate(v)]}
        if isinstance(v, dict) and all(isinstance(k, str) for k in v):
            return {"dict": {k: self(a, f"{where}.{k}")
                             for k, a in v.items()}}
        raise TypeError(
            f"export_solver: argument {where} ({type(v).__name__}) cannot be "
            f"rebuilt from a recipe: {EXPORTABLE}")

    def const(self, a: np.ndarray, device: str) -> dict:
        """A constant array, and where it lives (a device, or "numpy")."""
        self.consts.append(a)
        self.devices.append(device)
        return {"const": len(self.consts) - 1}


def _decode(v: Any, args: Sequence, consts: List[torch.Tensor]) -> Any:
    if not isinstance(v, dict):
        return v
    if "arg" in v:
        return args[v["arg"]]
    if "const" in v:
        return consts[v["const"]]
    if "dtype" in v:
        return getattr(torch, v["dtype"])
    if "device" in v:
        return torch.device(v["device"])
    if "factory" in v:
        fn = _FACTORIES.get(v["factory"])
        if fn is None:
            raise ValueError(f"recipe: unknown factory {v['factory']!r}")
        return fn(*[_decode(a, args, consts) for a in v["args"]],
                  **{k: _decode(a, args, consts)
                     for k, a in v["kwargs"].items()})
    if "type" in v:
        cls = _type(v["type"])
        return cls(**{k: _decode(a, args, consts)
                      for k, a in v["fields"].items()})
    if "tuple" in v:
        return tuple(_decode(a, args, consts) for a in v["tuple"])
    if "list" in v:
        return [_decode(a, args, consts) for a in v["list"]]
    if "dict" in v:
        return {k: _decode(a, args, consts) for k, a in v["dict"].items()}
    raise ValueError(f"recipe: unknown node {sorted(v)}")


def _launches() -> Dict[str, int]:
    out = {}
    for mod, name in _WRAPPERS:
        w = getattr(importlib.import_module(f"{_PKG}.{mod}"), name)
        out[name] = w.launches
    return out


def _spec(t: torch.Tensor) -> dict:
    return {"shape": list(t.shape), "dtype": str(t.dtype).replace("torch.",
                                                                  "")}


class Exported:
    """An exported solver: the recipe (JSON-able) and its constants."""

    def __init__(self, recipe: dict, consts: List[np.ndarray]):
        self.recipe = recipe
        self.consts = consts

    def serialize(self) -> bytes:
        buf = io.BytesIO()
        arrays = {f"const_{i}": c for i, c in enumerate(self.consts)}
        arrays["__recipe__"] = np.frombuffer(
            json.dumps(self.recipe).encode(), dtype=np.uint8)
        np.savez(buf, **arrays)
        return buf.getvalue()

    @staticmethod
    def deserialize(blob: bytes) -> "Exported":
        with np.load(io.BytesIO(bytes(blob)), allow_pickle=False) as data:
            recipe = json.loads(bytes(data["__recipe__"]).decode())
            if recipe.get("format") != FORMAT:
                raise ValueError(f"solver artifact format "
                                 f"{recipe.get('format')}, expected {FORMAT}")
            consts = [np.array(data[f"const_{i}"])
                      for i in range(len(recipe["const_devices"]))]
        return Exported(recipe, consts)

    def call(self) -> Callable:
        """The served solver (see :func:`deserialize_solver`)."""
        register_serialization()
        r = self.recipe
        entry = _ENTRIES.get(r["entry"])
        if entry is None:
            raise ValueError(f"recipe: unknown solver entry {r['entry']!r}")
        consts = [c if d == "numpy" else torch.from_numpy(c).to(d)
                  for c, d in zip(self.consts, r["const_devices"])]
        specs = r["examples"]
        n = len(specs)
        # the models, tiles and problems, made once (their factories'
        # caches keep the kernels' lowering and build across calls)
        static = {k: _decode(v, [None] * n, consts)
                  for k, v in r["arguments"].items() if not _has_arg(v)}

        def serve(*args):
            if len(args) != n:
                raise ValueError(f"solver artifact: {len(args)} arguments, "
                                 f"the export took {n}")
            for i, (a, s) in enumerate(zip(args, specs)):
                if not isinstance(a, torch.Tensor) or _spec(a) != s:
                    got = _spec(a) if isinstance(a, torch.Tensor) else \
                        type(a).__name__
                    raise ValueError(
                        f"solver artifact: argument {i} shape mismatch: "
                        f"got {got}, exported for {s}")
            return entry(**{k: static[k] if k in static
                            else _decode(v, args, consts)
                            for k, v in r["arguments"].items()})

        return serve


def _has_arg(v: Any) -> bool:
    if isinstance(v, dict):
        return "arg" in v or any(_has_arg(a) for a in v.values())
    if isinstance(v, list):
        return any(_has_arg(a) for a in v)
    return False


def export_solver(fn: Callable, *example_args) -> Exported:
    """Run ``fn(*example_args)`` once and record the solver call it makes
    (see the module docstring for what can be exported). ``example_args``
    are tensors; the artifact pins their shapes and dtypes."""
    register_serialization()
    for i, a in enumerate(example_args):
        if not isinstance(a, torch.Tensor):
            raise TypeError(f"export_solver: example argument {i} is a "
                            f"{type(a).__name__}, not a tensor")
    rec: list = []
    token = _RECORD.set(rec)
    before = _launches()
    try:
        out = fn(*example_args)
    finally:
        _RECORD.reset(token)
    after = _launches()
    if len(rec) != 1:
        raise TypeError(f"export_solver: fn called {len(rec)} recorded "
                        f"solver entries; {EXPORTABLE}")
    name, arguments, result = rec[0]
    if out is not result:
        raise TypeError(f"export_solver: fn returned something other than "
                        f"the result of {name}; {EXPORTABLE}")
    enc = _Encoder(example_args)
    encoded = {k: enc(v, k) for k, v in arguments.items()}
    from .. import __version__
    recipe = dict(
        format=FORMAT, package=_PKG, version=__version__, entry=name,
        arguments=encoded, examples=[_spec(a) for a in example_args],
        const_devices=enc.devices,
        kernels=dict(launches={k: after[k] - before[k] for k in after},
                     instances=enc.descriptors))
    return Exported(recipe, enc.consts)


def serialize_solver(fn: Callable, *example_args) -> bytes:
    """:func:`export_solver` + serialize to bytes (an ``.npz``: the JSON
    recipe and the constant tensors)."""
    return export_solver(fn, *example_args).serialize()


def deserialize_solver(blob: bytes) -> Callable:
    """Rebuild a serialized solver: its models once, then a callable that
    checks its inputs' shapes and dtypes against the export (ValueError on
    a mismatch) and calls the recorded entry, returning its native result.
    Nothing of the closure that was exported is needed here."""
    return Exported.deserialize(blob).call()


def save_solver(path, fn: Callable, *example_args) -> None:
    """Serialize ``fn`` and write the artifact to ``path``."""
    with open(path, "wb") as f:
        f.write(serialize_solver(fn, *example_args))


def load_solver(path) -> Callable:
    """Load an artifact written by :func:`save_solver`."""
    with open(path, "rb") as f:
        return deserialize_solver(f.read())
