"""Lowering of a Python lane model into the Hopper kernels.

A :class:`~.forward_kernel.LanesModel` without a device descriptor
(``device=None``) is written only as Python functions on ``(B,)`` tensors.
The JAX package lowers such functions into its TPU kernels through Mosaic;
this module does the same for the CUDA kernels:

- **Tracing.** ``dynamics``, ``cost``, ``terminal`` and ``diff`` are traced
  with ``make_fx`` on fake ``(B,)`` f32 tensors (per-scenario parameter rows
  are inputs too where ``n_params > 0``, and ``t`` is an input, a 0-dim
  int64 tensor). Python control flow on a value cannot be traced, as under
  ``jax.jit``.
- **Emission.** One C++ struct in the model interface of
  ``csrc/common.cuh``, its functions templates over the scalar type ``S``
  (float in K2/K3, ``Dual``/``Jet`` in K1's ``Autodiff<Lowered>``,
  ``csrc/autodiff.cuh``). Every traced operation is emitted in traced
  order, without algebraic simplification (``0 + x``, ``x * 1``, a dead
  ``zeros_like`` and ``rsub``'s operand order stay), and division stays
  division, as the plain versions divide.
- **Constants.** Python scalars, fill values and 0-dim tensor constants are
  rounded to f32, as PyTorch rounds them where they meet an f32 tensor, and
  go in order of first use into the struct's ``Consts`` descriptor. So the
  emitted source, and the digest of the library built from it, depend on
  the graphs' structure only: two quadrotor specs share one build, an LTI
  with another zero pattern gets its own.

What raises ``NotImplementedError`` here: an operation outside the op set
(:data:`OPS`; ``diff`` also has :data:`REMAINDER`, since no kernel
differentiates it), a value that is not an f32 scalar or ``(B,)`` tensor, a
function whose graph reads ``t``, and a function that cannot be traced.

The lowering runs only for a launch on CUDA tensors, once per model object
(:func:`lower`); CPU tensors run the plain versions and never come here.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Dict, List, Tuple

import numpy as np
import torch

from . import _build

# the model id of every lowered struct (csrc/lowered.cuh): the hand-written
# models are 1-4, the packed stream 0
LOWERED_ID = 5

aten = torch.ops.aten

# the op set of dynamics, cost and terminal: aten overload -> its C++ form
# over the operands {0}, {1}; each unary function has a Dual and a Jet rule
# in csrc/autodiff.cuh
OPS = {
    aten.add.Tensor: "{0} + {1}", aten.add.Scalar: "{0} + {1}",
    aten.sub.Tensor: "{0} - {1}", aten.sub.Scalar: "{0} - {1}",
    aten.rsub.Scalar: "{1} - {0}", aten.rsub.Tensor: "{1} - {0}",
    aten.mul.Tensor: "{0} * {1}", aten.mul.Scalar: "{0} * {1}",
    aten.div.Tensor: "{0} / {1}", aten.div.Scalar: "{0} / {1}",
    aten.neg.default: "-{0}",
    aten.sin.default: "sinf({0})", aten.cos.default: "cosf({0})",
    aten.tanh.default: "tanhf({0})", aten.exp.default: "expf({0})",
    aten.sqrt.default: "sqrtf({0})",
}
# the ops only diff may use: it runs at S = float in K2 and K3 and is never
# differentiated. Python's remainder (PyTorch's and jnp's: fmod, then the
# divisor added where the signs differ), emitted as two statements
REMAINDER = (aten.remainder.Scalar, aten.remainder.Tensor)
# copies: the value of their first operand
COPIES = (aten.clone.default, aten._to_copy.default, aten.detach.default,
          aten.alias.default, aten.lift_fresh_copy.default)
# constant factories: (the fill value's position in args, or the literal)
FACTORIES = {aten.zeros_like.default: 0.0, aten.ones_like.default: 1.0,
             aten.new_zeros.default: 0.0, aten.new_ones.default: 1.0,
             aten.zeros.default: 0.0, aten.ones.default: 1.0,
             aten.full_like.default: 1, aten.new_full.default: 2,
             aten.full.default: 1, aten.scalar_tensor.default: 0}


@dataclasses.dataclass(frozen=True)
class Op:
    """One traced operation: its aten overload, its operands (references,
    see :class:`Fn`; anything else is structural, e.g. a size) and keyword
    arguments, and its C++ expression (none for a remainder)."""
    target: object
    args: tuple
    kwargs: dict
    expr: str = ""


@dataclasses.dataclass(frozen=True)
class Fn:
    """A traced function: its operations and its outputs. A reference is
    ``("x"|"u"|"xo"|"p", i)`` (an input: state, control, diff's x_old, a
    parameter row), ``("v", j)`` (operation j's value), ``("k", slot,
    tensor)`` (a constant of the descriptor; ``tensor`` where it was a
    0-dim tensor) or ``("lit", value)`` (a factory's structural 0 or 1)."""
    ops: Tuple[Op, ...]
    outs: tuple
    state: Tuple[str, ...]     # which refs carry S: "x", "u" (or nothing)


@dataclasses.dataclass(frozen=True, eq=False)
class Lowered:
    """A lowered lane model: its traced functions, the f32 constants of its
    descriptor (dynamics, cost and terminal first, then diff's), and the
    C++ struct that K1-K3 instantiate (:meth:`struct`)."""
    n: int
    m: int
    n_params: int
    fns: Dict[str, Fn]
    consts: np.ndarray
    n_consts_model: int        # the slots of dynamics, cost and terminal
    # group -> (library, descriptor), loaded at a group's first launch
    _groups: dict = dataclasses.field(default_factory=dict, repr=False)

    @property
    def has_diff(self) -> bool:
        return "diff" in self.fns

    def consts_for(self, with_diff: bool) -> np.ndarray:
        """The descriptor of the struct with or without diff."""
        return (self.consts if with_diff and self.has_diff
                else self.consts[:self.n_consts_model]).copy()

    def struct(self, with_diff: bool) -> str:
        """The C++ struct ``Lowered`` (model interface, common.cuh); K1's
        libraries take it without diff, which K1 never calls, so that a
        model and its diff variant share them."""
        return _emit(self, with_diff and self.has_diff)

    def interpret(self, name: str, x=(), u=(), par=(), xo=()):
        """Run function ``name``'s operations with torch on tensors: the
        lowering's own semantics (the f32 constants in place of the traced
        ones), for holding it against the model's functions."""
        env = dict(x=list(x), u=list(u), p=list(par), xo=list(xo))
        fn = self.fns[name]
        vals: List = []

        def get(a):
            if not isinstance(a, tuple) or not a or not isinstance(
                    a[0], str):
                return a
            kind = a[0]
            if kind == "v":
                return vals[a[1]]
            if kind == "k":
                v = float(self.consts[a[1]])
                return torch.tensor(v, dtype=torch.float32) if a[2] else v
            if kind == "lit":
                return a[1]
            return env[kind][a[1]]

        for op in fn.ops:
            vals.append(op.target(*map(get, op.args), **op.kwargs))
        outs = [get(o) for o in fn.outs]
        return outs if name in ("dynamics", "diff") else outs[0]

    def group(self, group: str):
        """(library, f32 descriptor) of one instance group (``_build.
        LOWERED_GROUPS``): built and loaded at its first launch, then
        kept, so that a launch does not emit the struct again."""
        if group not in self._groups:
            with_diff = group == "fwd"
            self._groups[group] = (
                _build.lowered_library(self.struct(with_diff), group),
                self.consts_for(with_diff))
        return self._groups[group]


# ---------------------------------------------------------------------------
# tracing
# ---------------------------------------------------------------------------

def _signature(model, name: str):
    """The inputs of function ``name`` as (kind, count) in call order, and
    a caller from the flat inputs to the model's function."""
    n, m, P = model.n, model.m, model.n_params
    fn = getattr(model, name)

    def rows(a, i, k):
        return list(a[i:i + k])

    if name in ("dynamics", "cost"):
        kinds = [("x", n), ("u", m), ("t", 1), ("p", P)]

        def call(*a):
            par = (rows(a, n + m + 1, P),) if P else ()
            return fn(rows(a, 0, n), rows(a, n, m), a[n + m], *par)
    elif name == "terminal":
        kinds = [("x", n), ("p", P)]

        def call(*a):
            return fn(rows(a, 0, n), *((rows(a, n, P),) if P else ()))
    else:
        kinds = [("x", n), ("xo", n)]

        def call(*a):
            return fn(rows(a, 0, n), rows(a, n, n))
    return kinds, call


def _trace(model, name: str, consts: List[float]) -> Fn:
    from torch.fx.experimental.proxy_tensor import make_fx

    kinds, call = _signature(model, name)
    B = 8
    example = []
    for kind, count in kinds:
        for _ in range(count):
            example.append(torch.zeros((), dtype=torch.int64) if kind == "t"
                           else torch.zeros(B, dtype=torch.float32))
    try:
        gm = make_fx(call, tracing_mode="fake")(*example)
    except Exception as e:   # noqa: BLE001 - any trace failure is reported
        raise NotImplementedError(
            f"lowering {name}: the function cannot be traced into kernel "
            f"code ({type(e).__name__}: {str(e).splitlines()[0]}); Python "
            "control flow on tensor values, .item() and float() of a "
            "tensor have no lowering, as under jax.jit") from e
    refs = {}
    placeholders = [nd for nd in gm.graph.nodes if nd.op == "placeholder"]
    it = iter(placeholders)
    for kind, count in kinds:
        for i in range(count):
            nd = next(it)
            if kind == "t":
                if nd.users:
                    raise NotImplementedError(
                        f"lowering {name}: the function reads t (the step "
                        "index); models that read t have no lowering yet")
                continue
            refs[nd] = (kind, i)

    ops: List[Op] = []
    in_diff = name == "diff"

    def const(v, tensor=False):
        consts.append(float(np.float32(v)))
        return ("k", len(consts) - 1, tensor)

    def operand(a):
        if isinstance(a, torch.fx.Node):
            return refs[a]
        if isinstance(a, bool) or not isinstance(a, (int, float)):
            return a
        return const(a)

    for nd in gm.graph.nodes:
        if nd.op in ("placeholder", "output"):
            continue
        if nd.op == "get_attr":
            val = getattr(gm, nd.target)
            if not (isinstance(val, torch.Tensor) and val.dim() == 0
                    and val.dtype == torch.float32):
                raise NotImplementedError(
                    f"lowering {name}: tensor constant {nd.target} "
                    f"{tuple(val.shape)} {val.dtype}; only 0-dim f32 "
                    "constants lower")
            refs[nd] = const(val.item(), tensor=True)
            continue
        tgt = nd.target
        meta = nd.meta.get("val")
        if not (isinstance(meta, torch.Tensor)
                and meta.dtype == torch.float32
                and tuple(meta.shape) in ((), (B,))):
            raise NotImplementedError(
                f"lowering {name}: {tgt} gives "
                f"{getattr(meta, 'dtype', None)} "
                f"{tuple(getattr(meta, 'shape', ()))}; the kernels take f32 "
                "scalars and (B,) lane tensors only")
        if tgt in COPIES:
            src = nd.args[0]
            if tgt == aten.lift_fresh_copy.default:
                refs[nd] = refs[src]
                continue
            ops.append(Op(tgt, (refs[src],) + tuple(nd.args[1:]),
                          dict(nd.kwargs), _c(refs[src])))
        elif tgt in FACTORIES:
            fill = FACTORIES[tgt]
            args = [refs[a] if isinstance(a, torch.fx.Node) else a
                    for a in nd.args]
            if isinstance(fill, float):
                ref = ("lit", fill)
            else:
                ref = const(nd.args[fill])
                args[fill] = ref
            ops.append(Op(tgt, tuple(args), dict(nd.kwargs), _c(ref)))
        elif tgt in OPS or (in_diff and tgt in REMAINDER):
            extra = {k: v for k, v in nd.kwargs.items()
                     if not (k == "alpha" and v == 1)}
            if extra:
                raise NotImplementedError(
                    f"lowering {name}: {tgt} with {extra} has no lowering")
            args = tuple(operand(a) for a in nd.args)
            ops.append(Op(tgt, args, {}, OPS[tgt].format(*map(_c, args))
                          if tgt in OPS else ""))
        else:
            raise NotImplementedError(
                f"lowering {name}: aten op {tgt} is not in the lowering's "
                "op set (add, sub, rsub, mul, div, neg, sin, cos, tanh, "
                "exp, sqrt, constant factories, copies"
                + (", remainder" if in_diff else "") + ")")
        refs[nd] = ("v", len(ops) - 1)
    (out_node,) = [nd for nd in gm.graph.nodes if nd.op == "output"]
    outs = out_node.args[0]
    outs = list(outs) if isinstance(outs, (list, tuple)) else [outs]
    outs = tuple(operand(o) for o in outs)
    expect = model.n if name in ("dynamics", "diff") else 1
    if len(outs) != expect:
        raise NotImplementedError(
            f"lowering {name}: {len(outs)} outputs, expected {expect}")
    return Fn(ops=tuple(ops), outs=outs,
              state=() if name == "diff" else ("x", "u"))


@functools.lru_cache(maxsize=64)
def lower(model) -> Lowered:
    """The lowering of ``model``'s Python functions, once per model object.
    Raises NotImplementedError for what cannot be lowered (see the module
    docstring)."""
    consts: List[float] = []
    fns = {"dynamics": _trace(model, "dynamics", consts),
           "cost": _trace(model, "cost", consts)}
    if model.terminal is not None:
        fns["terminal"] = _trace(model, "terminal", consts)
    n_model = len(consts)
    if model.diff is not None:
        fns["diff"] = _trace(model, "diff", consts)
    return Lowered(n=model.n, m=model.m, n_params=model.n_params, fns=fns,
                   consts=np.asarray(consts, np.float32),
                   n_consts_model=n_model)


# ---------------------------------------------------------------------------
# emission
# ---------------------------------------------------------------------------

def _c(ref) -> str:
    """A reference as a C++ expression."""
    kind = ref[0]
    if kind == "v":
        return f"v{ref[1]}"
    if kind == "k":
        return f"k[{ref[1]}]"
    if kind == "lit":
        return f"{ref[1]:.1f}f"
    return f"{kind}[{ref[1]}]"


def _carries_s(fn: Fn) -> List[bool]:
    """Per operation: whether its value depends on x or u (type S), or only
    on constants and parameters (float)."""
    s: List[bool] = []

    def dep(a):
        return isinstance(a, tuple) and a and (
            a[0] in fn.state or (a[0] == "v" and s[a[1]]))

    for op in fn.ops:
        s.append(op.target not in FACTORIES and any(map(dep, op.args)))
    return s


def _body(fn: Fn, indent: str) -> List[str]:
    lines = []
    for j, op in enumerate(fn.ops):
        if op.target in REMAINDER:
            a, b = (_c(v) for v in op.args[:2])
            lines += [f"{indent}float v{j} = fmodf({a}, {b});",
                      f"{indent}if (v{j} != 0.0f && (({b} < 0.0f) != "
                      f"(v{j} < 0.0f))) v{j} = v{j} + {b};"]
        else:
            lines.append(f"{indent}const auto v{j} = {op.expr};")
    return lines


def _out(fn: Fn, ref, s: List[bool]) -> str:
    """An output as type S: a float-valued one lifted."""
    is_s = ref[0] in fn.state or (ref[0] == "v" and s[ref[1]])
    return _c(ref) if is_s else f"lift<S>({_c(ref)})"


def _emit(low: Lowered, with_diff: bool) -> str:
    n, m, P = low.n, low.m, low.n_params
    nk = len(low.consts) if with_diff else low.n_consts_model
    ind = "    "
    L = [
        "// A lane model lowered from its traced Python functions "
        "(ops/hopper/lower.py):",
        "// each aten operation in traced order, constants in k[] in order "
        "of first use.",
        "struct Lowered {",
        f"  static constexpr int N = {n};",
        f"  static constexpr int M = {m};",
        f"  static constexpr int ID = {LOWERED_ID};",
        f"  static constexpr int N_CONSTS = {nk};",
        f"  static constexpr int N_PARAMS = {P};",
        "  static constexpr bool HAS_DIFF = "
        f"{'true' if with_diff else 'false'};",
        "  struct Consts {",
        f"    float c[{max(nk, 1)}];",
        "  };",
        "",
        f"  float k[{max(nk, 1)}];",
    ]
    if P:
        L.append(f"  float p[{P}];")
    L += ["",
          "  __device__ __forceinline__ explicit Lowered(const Consts& mc) {",
          "    for (int i = 0; i < N_CONSTS; ++i) k[i] = mc.c[i];",
          "  }"]
    if P:
        L += ["  __device__ __forceinline__ Lowered(const Consts& mc,",
              "                                   const float (&par)[N_PARAMS]) {",
              "    for (int i = 0; i < N_CONSTS; ++i) k[i] = mc.c[i];",
              "    for (int i = 0; i < N_PARAMS; ++i) p[i] = par[i];",
              "  }"]
    L += ["",
          "  // a value that depends on no input, as the scalar type",
          "  template <class S>",
          "  __device__ __forceinline__ static S lift(float c) { return S{c}; }",
          ""]
    dyn = low.fns["dynamics"]
    s = _carries_s(dyn)
    L += ["  template <class S>",
          "  __device__ __forceinline__ void dynamics(const S (&x)[N], "
          "const S (&u)[M],",
          "                                           S (&xn)[N]) const {"]
    L += _body(dyn, ind)
    L += [f"{ind}xn[{i}] = {_out(dyn, o, s)};" for i, o in enumerate(dyn.outs)]
    L += ["  }", ""]
    cost = low.fns["cost"]
    s = _carries_s(cost)
    L += ["  template <class S>",
          "  __device__ __forceinline__ S cost(const S (&x)[N], "
          "const S (&u)[M]) const {"]
    L += _body(cost, ind)
    L += [f"{ind}return {_out(cost, cost.outs[0], s)};", "  }", ""]
    L += ["  template <class S>",
          "  __device__ __forceinline__ S terminal(const S (&x)[N]) const {"]
    term = low.fns.get("terminal")
    if term is None:
        L.append(f"{ind}return lift<S>(0.0f);")
    else:
        s = _carries_s(term)
        L += _body(term, ind)
        L.append(f"{ind}return {_out(term, term.outs[0], s)};")
    L += ["  }"]
    if with_diff:
        diff = low.fns["diff"]
        L += ["",
              "  __device__ __forceinline__ void diff(const float (&x)[N], "
              "const float (&xo)[N],",
              "                                       float (&dx)[N]) const {"]
        L += _body(diff, ind)
        L += [f"{ind}dx[{i}] = {_c(o)};" for i, o in enumerate(diff.outs)]
        L += ["  }"]
    L += ["};", ""]
    return "\n".join(L)
