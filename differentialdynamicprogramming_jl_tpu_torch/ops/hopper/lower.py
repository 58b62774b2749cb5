"""Lowering of Python lane models and derivative tiles into the Hopper
kernels.

A :class:`~.forward_kernel.LanesModel` without a device descriptor
(``device=None``) is written only as Python functions on ``(B,)`` tensors,
and so is a user's :class:`~.backward_kernel.DerivsTiles` without one. The
JAX package lowers such functions into its TPU kernels through Mosaic;
this module does the same for the CUDA kernels:

- **Tracing.** ``dynamics``, ``cost``, ``terminal`` and ``diff`` are traced
  with ``make_fx`` on fake ``(B,)`` f32 tensors (per-scenario parameter rows
  are inputs too where ``n_params > 0``), and so is a tiles function
  ``fn(x, u, t, *par)`` (:func:`lower_tiles`). ``t``, the step index, is an
  input, a 0-dim int32 tensor, as the plain versions and JAX's kernels pass
  it (:func:`~.forward_kernel.step_indices`). Python control flow on a
  value cannot be traced, as under ``jax.jit``.
- **Emission.** One C++ struct in the model interface of
  ``csrc/common.cuh``: ``Lowered``, the model's functions as templates over
  the scalar type ``S`` (float in K2/K3, ``Dual``/``Jet`` in K1's
  ``Autodiff<Lowered>``, ``csrc/autodiff.cuh``), or ``LoweredTiles``, the
  tiles as K1's analytic expansion (``derivs``, and ``derivs_so``/``vh``
  for second-order tiles, with the accessors). Every traced operation is
  emitted in traced order, without algebraic simplification (``0 + x``,
  ``x * 1``, a dead ``zeros_like`` and ``rsub``'s operand order stay), and
  division stays division, as the plain versions divide.
- **t.** The struct's functions take ``int t``, the logical step. Where
  torch promotes it (``t * h``, ``torch.sin(t)``, ``t.float()``) it is
  converted, so ``(float)t * k[i]`` is the f32 product of the trace. In
  ``Dual``/``Jet`` it is a constant without a tangent. An integer-valued
  result (``t + 1`` kept as an integer) lowers as integer arithmetic for
  add, sub, mul and neg; any other integer operation raises.
- **Constants.** Python scalars, fill values and 0-dim tensor constants are
  rounded to f32, as PyTorch rounds them where they meet an f32 tensor, and
  go in order of first use into the struct's ``Consts`` descriptor. So the
  emitted source, and the digest of the library built from it, depend on
  the graphs' structure only: two quadrotor specs share one build, an LTI
  with another zero pattern gets its own. A tile entry that depends on no
  input (``A[i][j] * ones_like(x)``) is folded into the descriptor where
  its operations are exact ones (add, sub, mul, div, neg, copies); a
  ``zeros_like`` or ``ones_like`` entry is the literal 0 or 1.

- **The op set** (:data:`OPS`, :data:`POW`, :data:`CLAMP`, :data:`WHERE`,
  :data:`COMPARE`, :data:`LOGIC`): the arithmetic, sin, cos, tanh, exp,
  sqrt, abs, log, pow with a constant exponent, relu, minimum, maximum,
  the clamps with scalar bounds, and ``where`` on a boolean; booleans come
  from comparisons (of f32 values, or of an integer such as t with an int)
  and logic on them, and a boolean made a float is 0 or 1. Each value is
  what PyTorch's CUDA kernel computes, and each derivative in K1 PyTorch's
  forward-mode rule (``csrc/autodiff.cuh``), but for abs, the clamps,
  maximum and minimum, which take JAX's rules, as the JAX package's
  kernels and the plain versions (``ops/tie_rules.py``) do: |x|' is 1 at
  ±0, a clamp's derivative ½ on its bound, a chooser's ½ each at a tie.

What raises ``NotImplementedError`` here: an operation outside the op set
(``diff`` also has :data:`REMAINDER`, since no kernel differentiates it), a
value that is not an f32 scalar, an int32 scalar, a boolean or a ``(B,)``
tensor of them, an integer operation other than add, sub, mul, neg and
comparisons, an integer- or boolean-valued output, tiles without the
first-order fields or with only some of ``fxx``, ``fxu``, ``fuu``, a tile
entry that is not a tensor, and a function that cannot be traced.

The lowering runs only for a launch on CUDA tensors, once per model or
tiles object (:func:`lower`, :func:`lower_tiles`); CPU tensors run the
plain versions and never come here.
"""
from __future__ import annotations

import dataclasses
import functools
import math
import re
from typing import Dict, List, Tuple

import numpy as np
import torch

from . import _build

# the model ids of the lowered structs (csrc/lowered.cuh): a model's
# Lowered, and a user's derivative tiles' LoweredTiles; the hand-written
# models are 1-4, the packed stream 0
LOWERED_ID = 5
LOWERED_TILES_ID = 6
# a model whose dynamics and cost hold more than NOINLINE_OPS operations
# between them has them emitted __noinline__, so that each of K2's and
# K3's four kernels calls one compiled copy rather than inlining its own:
# the LTI at ⟨54,21⟩ (8050 operations in its dynamics) took 228 s of nvcc
# inlined, ⟨64,32⟩ 430 s. Below it (every model before, ⟨16,16⟩'s 1136
# included) the functions stay __forceinline__ and their code as it was
NOINLINE_OPS = 4096

aten = torch.ops.aten

# the op set of dynamics, cost and terminal: aten overload -> its C++ form
# over the operands {0}, {1}, {2}; each function has a Dual and a Jet rule
# in csrc/autodiff.cuh (a constant operand enters them as a constant)
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
    aten.abs.default: "fabsf({0})", aten.log.default: "logf({0})",
    aten.relu.default: "relu_({0})",
    aten.minimum.default: "minimum_({0}, {1})",
    aten.maximum.default: "maximum_({0}, {1})",
    aten.clamp_min.default: "clamp_min_({0}, {1})",
    aten.clamp_max.default: "clamp_max_({0}, {1})",
}
# pow with a constant exponent e (pow.Tensor_Scalar; torch.square too): the
# exponent is part of the emitted source, since PyTorch's kernel and its
# rule branch on it (csrc/autodiff.cuh powc_); clamp with scalar bounds,
# either absent; where on a boolean condition (where_)
POW = aten.pow.Tensor_Scalar
CLAMP = aten.clamp.default
WHERE = aten.where.self
# the boolean values: comparisons (of f32 values, or of the int t with an
# int), and logic on booleans (Python's &, | and ~ trace to bitwise ops)
COMPARE = {aten.gt.Scalar: ">", aten.gt.Tensor: ">", aten.ge.Scalar: ">=",
           aten.ge.Tensor: ">=", aten.lt.Scalar: "<", aten.lt.Tensor: "<",
           aten.le.Scalar: "<=", aten.le.Tensor: "<=", aten.eq.Scalar: "==",
           aten.eq.Tensor: "==", aten.ne.Scalar: "!=", aten.ne.Tensor: "!="}
LOGIC = {aten.logical_and.default: "({0} && {1})",
         aten.logical_or.default: "({0} || {1})",
         aten.logical_not.default: "(!{0})",
         aten.bitwise_and.Tensor: "({0} && {1})",
         aten.bitwise_or.Tensor: "({0} || {1})",
         aten.bitwise_not.default: "(!{0})"}
# the op set's names, for the message of what does not lower
OP_SET = ("add, sub, rsub, mul, div, neg, sin, cos, tanh, exp, sqrt, abs, "
          "log, pow with a constant exponent, relu, minimum, maximum, clamp "
          "with scalar bounds, where, comparisons, logical and, or, not")
# the ops only diff may use: it runs at S = float in K2 and K3 and is never
# differentiated. Python's remainder (PyTorch's and jnp's: fmod, then the
# divisor added where the signs differ), emitted as two statements
REMAINDER = (aten.remainder.Scalar, aten.remainder.Tensor)
# the integer arithmetic that lowers (on t and values made from it): a
# result that torch keeps as an integer
INT_OPS = (aten.add.Tensor, aten.add.Scalar, aten.sub.Tensor,
           aten.sub.Scalar, aten.rsub.Scalar, aten.rsub.Tensor,
           aten.mul.Tensor, aten.mul.Scalar, aten.neg.default)
# ops whose result is exact on every device (a correctly rounded f32, a
# selection or a boolean): a tile entry made of them alone, from constants
# alone, is folded at lowering time
EXACT = {aten.add.Tensor, aten.add.Scalar, aten.sub.Tensor, aten.sub.Scalar,
         aten.rsub.Scalar, aten.rsub.Tensor, aten.mul.Tensor,
         aten.mul.Scalar, aten.div.Tensor, aten.div.Scalar, aten.neg.default,
         aten.abs.default, aten.relu.default, aten.minimum.default,
         aten.maximum.default, aten.clamp_min.default,
         aten.clamp_max.default, WHERE, CLAMP, *COMPARE, *LOGIC}
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
    parameter row), ``("t", 0)`` (the step index, an int), ``("v", j)``
    (operation j's value), ``("k", slot, tensor)`` (a constant of the
    descriptor; ``tensor`` where it was a 0-dim tensor), ``("lit", value)``
    (a factory's structural 0 or 1) or ``("int", value)`` (an integer
    operand of integer arithmetic or of a comparison with t). ``ints``
    holds the operations whose value is an integer, ``bools`` those whose
    value is a boolean (a comparison, logic on booleans, a copy of one)."""
    ops: Tuple[Op, ...]
    outs: tuple
    state: Tuple[str, ...]     # which refs carry S: "x", "u" (or nothing)
    ints: frozenset = frozenset()
    bools: frozenset = frozenset()


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

    def interpret(self, name: str, x=(), u=(), par=(), xo=(), t=None):
        """Run function ``name``'s operations with torch on tensors: the
        lowering's own semantics (the f32 constants in place of the traced
        ones), for holding it against the model's functions. ``t``: the
        step index (an int32 tensor; 0 by default)."""
        outs = _run(self.fns[name], self.consts, dict(
            x=list(x), u=list(u), p=list(par), xo=list(xo), t=[_t(t)]))
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

B_TRACE = 8     # the lanes of the fake tensors a function is traced on


def _t(t=None) -> torch.Tensor:
    """The step index as the traces and the plain versions take it."""
    return (torch.zeros((), dtype=torch.int32) if t is None
            else torch.as_tensor(t, dtype=torch.int32))


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


def _f32_literal(v: float) -> str:
    """An f32 value as a C++ float literal that parses to it exactly."""
    return f"{float(np.float32(v))!r}f"


def _graph(call, kinds, name: str, consts: List[float],
           in_diff: bool = False):
    """Trace ``call`` on the inputs ``kinds`` and translate its graph:
    (ops, output references, the integer-valued operations, the
    boolean-valued operations)."""
    from torch.fx.experimental.proxy_tensor import make_fx

    B = B_TRACE
    example = []
    for kind, count in kinds:
        for _ in range(count):
            example.append(_t() if kind == "t"
                           else torch.zeros(B, dtype=torch.float32))
    try:
        gm = make_fx(call, tracing_mode="fake")(*example)
    except NotImplementedError:
        raise
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
            refs[next(it)] = (kind, i)

    ops: List[Op] = []
    ints, bools = set(), set()

    def is_int(ref):
        return ref[0] in ("t", "int") or (ref[0] == "v" and ref[1] in ints)

    def is_bool(ref):
        return isinstance(ref, tuple) and ref[:1] == ("v",) and ref[1] in bools

    def const(v, tensor=False):
        consts.append(float(np.float32(v)))
        return ("k", len(consts) - 1, tensor)

    def operand(a, integer=False):
        if isinstance(a, torch.fx.Node):
            return refs[a]
        if isinstance(a, bool) or not isinstance(a, (int, float)):
            return a
        return ("int", a) if integer else const(a)

    def cf(a):
        """An operand of an f32 operation: an integer or a boolean
        converted, as torch promotes it."""
        return (f"static_cast<float>({_c(a)})"
                if isinstance(a, tuple) and a and isinstance(a[0], str)
                and (is_int(a) or is_bool(a)) else _c(a))

    def fail(tgt, what):
        raise NotImplementedError(f"lowering {name}: {tgt} {what}")

    def translate(tgt, nd):
        """(operands, C++ expression) of an op of the set."""
        args = nd.args
        if tgt == POW:
            e = args[1]
            if not isinstance(e, (int, float)) or isinstance(e, bool) \
                    or not math.isfinite(e):
                fail(tgt, f"with exponent {e!r}; the exponent must be a "
                          "finite Python number")
            x = refs[args[0]]
            ef = float(np.float32(e))
            # the rule's exponents e - 1 and e - 2 in double, as its Scalar
            # arithmetic forms them, then rounded
            return (x, ef), (f"powc_({cf(x)}, {_f32_literal(ef)}, "
                             f"{_f32_literal(float(e) - 1.0)}, "
                             f"{_f32_literal(float(e) - 2.0)})")
        if tgt == CLAMP:
            x = refs[args[0]]
            if any(isinstance(a, torch.fx.Node) for a in args[1:]):
                fail(tgt, "with tensor bounds has no lowering")
            lo, hi = (list(args[1:3]) + [None, None])[:2]
            lo = None if lo is None else const(lo)
            hi = None if hi is None else const(hi)
            expr = (f"clamp_({cf(x)}, {_c(lo)}, {_c(hi)})" if lo and hi
                    else f"clamp_min_({cf(x)}, {_c(lo)})" if lo
                    else f"clamp_max_({cf(x)}, {_c(hi)})" if hi
                    else cf(x))
            return (x, lo, hi), expr
        if tgt in COMPARE:
            a, b = (refs[v] if isinstance(v, torch.fx.Node) else v
                    for v in args[:2])
            if is_bool(a) or is_bool(b):
                fail(tgt, "of booleans has no lowering")
            if not isinstance(b, tuple):     # a Python number
                b = (("int", b) if is_int(a) and isinstance(b, int)
                     and not isinstance(b, bool) else const(b))
            op = COMPARE[tgt]
            if is_int(a) and is_int(b):
                return (a, b), f"({_c(a)} {op} {_c(b)})"
            return (a, b), f"(val_({cf(a)}) {op} val_({cf(b)}))"
        if tgt in LOGIC:
            a = tuple(refs[v] for v in args)
            if not all(map(is_bool, a)):
                fail(tgt, "on values that are not booleans has no lowering")
            return a, LOGIC[tgt].format(*map(_c, a))
        if tgt == WHERE:
            c, a, b = (refs[v] for v in args)
            if not is_bool(c):
                fail(tgt, "needs a boolean condition")
            return (c, a, b), f"where_({_c(c)}, {cf(a)}, {cf(b)})"
        return None

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
        integer = (isinstance(meta, torch.Tensor) and meta.dtype == torch.int32
                   and meta.dim() == 0)
        boolean = (isinstance(meta, torch.Tensor) and meta.dtype == torch.bool
                   and tuple(meta.shape) in ((), (B,)))
        if not (integer or boolean or (isinstance(meta, torch.Tensor)
                                       and meta.dtype == torch.float32
                                       and tuple(meta.shape) in ((), (B,)))):
            raise NotImplementedError(
                f"lowering {name}: {tgt} gives "
                f"{getattr(meta, 'dtype', None)} "
                f"{tuple(getattr(meta, 'shape', ()))}; the kernels take f32 "
                "scalars, (B,) lane tensors, booleans and the int32 step "
                "index only")
        if boolean and tgt not in COMPARE and tgt not in LOGIC \
                and tgt not in COPIES:
            raise NotImplementedError(
                f"lowering {name}: {tgt} gives a boolean; booleans come from "
                "comparisons and logic on booleans")
        if integer and tgt not in INT_OPS + COPIES:
            raise NotImplementedError(
                f"lowering {name}: {tgt} gives an integer value; integer "
                "arithmetic lowers for add, sub, mul and neg (t + 1, 2 * t), "
                "convert t to float for anything else")
        if tgt in COPIES:
            src = refs[nd.args[0]]
            if tgt == aten.lift_fresh_copy.default:
                refs[nd] = src
                continue
            ops.append(Op(tgt, (src,) + tuple(nd.args[1:]), dict(nd.kwargs),
                          _c(src) if integer or boolean else cf(src)))
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
        elif (tgt in OPS or tgt in (POW, CLAMP, WHERE) or tgt in COMPARE
              or tgt in LOGIC or (in_diff and tgt in REMAINDER)):
            extra = {k: v for k, v in nd.kwargs.items()
                     if not (k == "alpha" and v == 1)}
            if extra:
                raise NotImplementedError(
                    f"lowering {name}: {tgt} with {extra} has no lowering")
            special = translate(tgt, nd)
            if special is not None:
                args, expr = special
            else:
                args = tuple(operand(a, integer) for a in nd.args)
                expr = (OPS[tgt].format(*map(_c if integer else cf, args))
                        if tgt in OPS else "")
            ops.append(Op(tgt, args, {}, expr))
        else:
            raise NotImplementedError(
                f"lowering {name}: aten op {tgt} is not in the lowering's "
                f"op set ({OP_SET}, constant factories, copies"
                + (", remainder" if in_diff else "") + ")")
        if integer:
            ints.add(len(ops) - 1)
        if boolean:
            bools.add(len(ops) - 1)
        refs[nd] = ("v", len(ops) - 1)
    (out_node,) = [nd for nd in gm.graph.nodes if nd.op == "output"]
    outs = out_node.args[0]
    outs = list(outs) if isinstance(outs, (list, tuple)) else [outs]
    outs = tuple(operand(o) for o in outs)
    for o in outs:
        if is_int(o) or is_bool(o):
            raise NotImplementedError(
                f"lowering {name}: an output is the "
                f"{'integer' if is_int(o) else 'boolean'} {_c(o)}; the "
                "kernels take f32 outputs")
    return tuple(ops), outs, frozenset(ints), frozenset(bools)


def _trace(model, name: str, consts: List[float]) -> Fn:
    kinds, call = _signature(model, name)
    ops, outs, ints, bools = _graph(call, kinds, name, consts,
                                    in_diff=name == "diff")
    expect = model.n if name in ("dynamics", "diff") else 1
    if len(outs) != expect:
        raise NotImplementedError(
            f"lowering {name}: {len(outs)} outputs, expected {expect}")
    return Fn(ops=ops, outs=outs,
              state=() if name == "diff" else ("x", "u"), ints=ints,
              bools=bools)


def _run(fn: Fn, consts: np.ndarray, env: dict, live=None) -> list:
    """``fn``'s operations (those of ``live``, or all) with torch on the
    inputs ``env`` (kind → list), the descriptor's f32 constants in place
    of the traced ones."""
    vals: List = []

    def get(a):
        if not isinstance(a, tuple) or not a or not isinstance(a[0], str):
            return a
        kind = a[0]
        if kind == "v":
            return vals[a[1]]
        if kind == "k":
            v = float(consts[a[1]])
            return torch.tensor(v, dtype=torch.float32) if a[2] else v
        if kind in ("lit", "int"):
            return a[1]
        return env[kind][a[1]]

    for j, op in enumerate(fn.ops):
        vals.append(op.target(*map(get, op.args), **op.kwargs)
                    if live is None or live[j] else None)
    return [get(o) for o in fn.outs]


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
# a user's derivative tiles: K1's analytic expansion
# ---------------------------------------------------------------------------

# the second-order fields of full DDP's tiles, after the first-order ones
# (pack.DERIV_FIELDS)
SO_FIELDS = ("fxx", "fxu", "fuu")


def tile_shapes(n: int, m: int) -> Dict[str, tuple]:
    """Each tile field's nested-list shape, as K1's plain version indexes
    it (``fxu[a][j][mi]``, ``fuu[a][mi][mj]``)."""
    return dict(fx=(n, n), fu=(n, m), cx=(n,), cu=(m,), cxx=(n, n),
                cxu=(n, m), cuu=(m, m), fxx=(n, n, n), fxu=(n, n, m),
                fuu=(n, m, m))


def _nested(v, shape, where: str) -> list:
    """A field's nested lists → row-major flat list, its shape checked."""
    if not shape:
        return [v]
    if not isinstance(v, (list, tuple)) or len(v) != shape[0]:
        raise NotImplementedError(
            f"lowering tiles: {where} is not a list of {shape[0]}")
    return [e for i, w in enumerate(v)
            for e in _nested(w, shape[1:], f"{where}[{i}]")]


@dataclasses.dataclass(frozen=True, eq=False)
class LoweredTiles:
    """A user's derivative tiles, lowered: the traced function (its outputs
    the values of the per-step Derivs slots), each entry's source per field
    (row-major, in ``fields`` order: ``("lit", v)``, ``("k", slot)`` of
    the descriptor or ``("d", slot)`` of Derivs), the f32 descriptor and
    the C++ struct ``LoweredTiles`` that K1 instantiates
    (:meth:`struct`)."""
    n: int
    m: int
    n_params: int
    second_order: bool
    fn: Fn
    fields: Tuple[str, ...]
    entries: Dict[str, tuple]
    consts: np.ndarray
    _groups: dict = dataclasses.field(default_factory=dict, repr=False)

    def interpret(self, x, u, t=None, par=()):
        """The tiles' fields from the lowering's own semantics (torch on
        tensors, the descriptor's constants), as nested lists like the
        tiles function's: a literal or descriptor entry as a float, a
        Derivs slot as its tensor."""
        vals = _run(self.fn, self.consts, dict(
            x=list(x), u=list(u), p=list(par), t=[_t(t)]),
            _needs(self.fn, self.fn.outs))
        shapes = tile_shapes(self.n, self.m)
        return {f: _unflat([
            src[1] if src[0] == "lit" else float(self.consts[src[1]])
            if src[0] == "k" else vals[src[1]] for src in self.entries[f]],
            shapes[f]) for f in self.fields}

    def struct(self) -> str:
        """The C++ struct ``LoweredTiles`` (model interface, common.cuh)."""
        return _emit_tiles(self)

    def group(self, group: str):
        """(library, f32 descriptor) of one instance group (``_build.
        LOWERED_GROUPS``), built and loaded at its first launch, then
        kept."""
        if group not in self._groups:
            self._groups[group] = (
                _build.lowered_library(self.struct(), group),
                self.consts.copy())
        return self._groups[group]


def _unflat(flat: list, shape: tuple):
    if len(shape) <= 1:
        return flat if shape else flat[0]
    k = len(flat) // shape[0]
    return [_unflat(flat[i * k:(i + 1) * k], shape[1:])
            for i in range(shape[0])]


def _needs(fn: Fn, roots) -> List[bool]:
    """Per operation: whether a value of ``roots`` depends on it."""
    live = [False] * len(fn.ops)
    stack = [r for r in roots if isinstance(r, tuple) and r[0] == "v"]
    while stack:
        j = stack.pop()[1]
        if live[j]:
            continue
        live[j] = True
        stack += [a for a in fn.ops[j].args
                  if isinstance(a, tuple) and a and a[0] == "v"]
    return live


def _foldable(fn: Fn, ref) -> bool:
    """Whether ``ref`` depends on no input and only on exact operations."""
    if not isinstance(ref, tuple) or not ref or not isinstance(ref[0], str):
        return True
    if ref[0] in ("k", "lit", "int"):
        return True
    if ref[0] != "v":
        return False
    op = fn.ops[ref[1]]
    return op.target in FACTORIES or (
        (op.target in EXACT or op.target in COPIES)
        and all(_foldable(fn, a) for a in op.args))


@functools.lru_cache(maxsize=64)
def lower_tiles(tiles, n: int, m: int) -> LoweredTiles:
    """The lowering of a user's derivative tiles ``tiles.fn(x, u, t,
    *par)`` at state size n and control size m, once per tiles object.
    Tiles that return ``fxx``, ``fxu`` and ``fuu`` are second order.
    Raises NotImplementedError for what cannot be lowered (see the module
    docstring)."""
    P = tiles.n_params
    shapes = tile_shapes(n, m)
    kinds = [("x", n), ("u", m), ("t", 1), ("p", P)]
    first = ("fx", "fu", "cx", "cu", "cxx", "cxu", "cuu")
    found = {}

    def call(*a):
        par = (list(a[n + m + 1:n + m + 1 + P]),) if P else ()
        d = tiles.fn(list(a[:n]), list(a[n:n + m]), a[n + m], *par)
        missing = [f for f in first if f not in d]
        so = [f for f in SO_FIELDS if f in d]
        if missing or len(so) not in (0, len(SO_FIELDS)):
            raise NotImplementedError(
                "lowering tiles: the tiles return "
                f"{sorted(d)}; K1 needs {list(first)} and, for full DDP, "
                f"all of {list(SO_FIELDS)}")
        found["fields"] = first + tuple(so)
        flat = []
        for f in found["fields"]:
            for j, v in enumerate(_nested(d[f], shapes[f], f)):
                if not isinstance(v, torch.Tensor):
                    raise NotImplementedError(
                        f"lowering tiles: entry {j} of {f} is "
                        f"{type(v).__name__}, not a tensor (make a constant "
                        "entry c * ones_like(x[0]))")
                flat.append(v)
        return flat

    consts: List[float] = []
    ops, outs, ints, bools = _graph(call, kinds, "tiles", consts)
    fn = Fn(ops=ops, outs=outs, state=(), ints=ints, bools=bools)
    fields = found["fields"]
    # each entry: a literal, a folded or descriptor constant, or a slot of
    # the step's Derivs (one per distinct runtime value)
    lit = {}          # a factory of 0 or 1 (zeros_like, ones_like), copied
    for j, op in enumerate(ops):
        fill = FACTORIES.get(op.target)
        if isinstance(fill, float):
            lit[("v", j)] = fill
        elif op.target in COPIES and op.args[0] in lit:
            lit[("v", j)] = lit[op.args[0]]
    folded = {}
    dummy = dict(x=[torch.zeros(())] * n, u=[torch.zeros(())] * m,
                 p=[torch.zeros(())] * P, t=[_t()])
    runtime: List[tuple] = []
    entries, i = {}, 0
    for f in fields:
        srcs = []
        for _ in range(int(np.prod(shapes[f]))):
            ref = outs[i]
            i += 1
            if ref[0] == "lit" or ref in lit:
                srcs.append(("lit", ref[1] if ref[0] == "lit" else lit[ref]))
            elif ref[0] == "k":
                srcs.append(("k", ref[1]))
            elif ref[0] == "v" and _foldable(fn, ref):
                if ref not in folded:
                    # its value, from any inputs (only factories read them)
                    (v,) = _run(Fn(ops, (ref,), ()), np.asarray(
                        consts, np.float32), dummy, _needs(fn, [ref]))
                    consts.append(float(np.float32(float(v))))
                    folded[ref] = len(consts) - 1
                srcs.append(("k", folded[ref]))
            else:
                if ref not in runtime:
                    runtime.append(ref)
                srcs.append(("d", runtime.index(ref)))
        entries[f] = tuple(srcs)
    fn, entries, consts = _compact(Fn(ops, tuple(runtime), (), ints, bools),
                                   entries, consts)
    return LoweredTiles(n=n, m=m, n_params=P,
                        second_order=len(fields) > len(first), fn=fn,
                        fields=fields, entries=entries, consts=consts)


def _compact(fn: Fn, entries: dict, consts: List[float]):
    """The descriptor cut to the constants that the live operations and
    the entries read, renumbered in order of first use: a folded entry
    leaves its operands' constants unread."""
    live = _needs(fn, fn.outs)
    order: Dict[int, int] = {}

    def use(slot):
        return order.setdefault(slot, len(order))

    def remap(a):
        return (("k", use(a[1]), a[2]) if isinstance(a, tuple) and a
                and a[0] == "k" else a)

    ops = []
    for j, op in enumerate(fn.ops):
        if not live[j]:
            ops.append(op)       # never run nor emitted
            continue
        args = tuple(map(remap, op.args))
        ops.append(dataclasses.replace(op, args=args, expr=re.sub(
            r"k\[(\d+)\]", lambda g: f"k[{use(int(g.group(1)))}]",
            op.expr)))
    entries = {f: tuple(("k", use(v)) if kind == "k" else (kind, v)
                        for kind, v in srcs) for f, srcs in entries.items()}
    kept = np.zeros(len(order), np.float32)
    for old, new in order.items():
        kept[new] = consts[old]
    return dataclasses.replace(fn, ops=tuple(ops)), entries, kept


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
    if kind == "int":
        return str(int(ref[1]))
    if kind == "t":
        return "t"
    return f"{kind}[{ref[1]}]"


def _carries_s(fn: Fn) -> List[bool]:
    """Per operation: whether its value depends on x or u (type S), or only
    on constants, parameters and t (float, or int)."""
    s: List[bool] = []

    def dep(a):
        return isinstance(a, tuple) and a and (
            a[0] in fn.state or (a[0] == "v" and s[a[1]]))

    for j, op in enumerate(fn.ops):
        s.append(j not in fn.bools and op.target not in FACTORIES
                 and any(map(dep, op.args)))
    return s


def _body(fn: Fn, indent: str, live=None) -> List[str]:
    lines = []
    for j, op in enumerate(fn.ops):
        if live is not None and not live[j]:
            continue
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


def _descriptor(name: str, nk: int, P: int) -> List[str]:
    """The descriptor and parameter members and the constructors."""
    L = ["  struct Consts {",
         f"    float c[{max(nk, 1)}];",
         "  };",
         ""]
    if name == "Lowered":
        L.append(f"  float k[{max(nk, 1)}];")
        init, body = "", ["    for (int i = 0; i < N_CONSTS; ++i) "
                          "k[i] = mc.c[i];"]
    else:
        # the descriptor read in place: every index is a compile-time
        # constant, so each read is a uniform operand (as lti.cuh reads A)
        L.append(f"  const float (&k)[{max(nk, 1)}];")
        init, body = " : k(mc.c)", []
    if P:
        L.append(f"  float p[{P}];")
    pad = " " * (len(name) + 29)
    L += ["",
          f"  __device__ __forceinline__ explicit {name}(const Consts& mc)"
          f"{init} {{"] + body + ["  }"]
    if P:
        L += [f"  __device__ __forceinline__ {name}(const Consts& mc,",
              f"{pad}const float (&par)[N_PARAMS]){init} {{"] + body + [
              "    for (int i = 0; i < N_PARAMS; ++i) p[i] = par[i];",
              "  }"]
    return L


def _head(name: str, n: int, m: int, model_id: int, nk: int, P: int,
          flags: List[str], comment: List[str]) -> List[str]:
    return comment + [
        f"struct {name} {{",
        f"  static constexpr int N = {n};",
        f"  static constexpr int M = {m};",
        f"  static constexpr int ID = {model_id};",
        f"  static constexpr int N_CONSTS = {nk};",
        f"  static constexpr int N_PARAMS = {P};",
    ] + [f"  static constexpr bool {f};" for f in flags]


def _emit(low: Lowered, with_diff: bool) -> str:
    n, m, P = low.n, low.m, low.n_params
    nk = len(low.consts) if with_diff else low.n_consts_model
    ind = "    "
    L = _head("Lowered", n, m, LOWERED_ID, nk, P,
              [f"HAS_DIFF = {'true' if with_diff else 'false'}"], [
                  "// A lane model lowered from its traced Python functions "
                  "(ops/hopper/lower.py):",
                  "// each aten operation in traced order, constants in k[] "
                  "in order of first use."])
    L += _descriptor("Lowered", nk, P)
    L += ["",
          "  // a value that depends on no input, as the scalar type",
          "  template <class S>",
          "  __device__ __forceinline__ static S lift(float c) { return S{c}; }",
          ""]
    dyn = low.fns["dynamics"]
    s = _carries_s(dyn)
    cost = low.fns["cost"]
    dyn_body, cost_body = _body(dyn, ind), _body(cost, ind)
    spec = ("__noinline__" if len(dyn_body) + len(cost_body) > NOINLINE_OPS
            else "__forceinline__")
    L += ["  template <class S>",
          f"  __device__ {spec} void dynamics(const S (&x)[N], "
          "const S (&u)[M],",
          "                                           int t, S (&xn)[N]) "
          "const {"]
    L += dyn_body
    L += [f"{ind}xn[{i}] = {_out(dyn, o, s)};" for i, o in enumerate(dyn.outs)]
    L += ["  }", ""]
    s = _carries_s(cost)
    L += ["  template <class S>",
          f"  __device__ {spec} S cost(const S (&x)[N], "
          "const S (&u)[M], int t) const {"]
    L += cost_body
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


# the accessors of common.cuh: field → (signature's index names, the
# linear index of an entry in the field's row-major list)
ACCESSORS = {"fx": ("int i, int j", "i * N + j"),
             "fu": ("int i, int mi", "i * M + mi"),
             "cx": ("int i", "i"), "cu": ("int mi", "mi"),
             "cxx": ("int i, int j", "i * N + j"),
             "cxu": ("int i, int mi", "i * M + mi"),
             "cuu": ("int mi, int mj", "mi * M + mj")}


def _src(src) -> str:
    """A tile entry's C++ value: a literal, a descriptor constant or a slot
    of the step's Derivs."""
    kind, v = src
    return (f"{v:.1f}f" if kind == "lit" else f"k[{v}]" if kind == "k"
            else f"d.{'hv' if kind == 'hv' else 'v'}[{v}]")


def _switch(entries: tuple, index: str, ind: str, cases=None) -> List[str]:
    """A switch over an accessor's compile-time index (folded once K1's
    loops are unrolled), entry e at case ``cases[e]`` (default e); the
    literal zeros fall to its default."""
    L = [f"{ind}switch ({index}) {{"]
    for e, src in enumerate(entries):
        if src != ("lit", 0.0):
            L.append(f"{ind}  case {e if cases is None else cases[e]}: "
                     f"return {_src(src)};")
    return L + [f"{ind}  default: return 0.0f;", f"{ind}}}"]


def _emit_tiles(low: LoweredTiles) -> str:
    n, m, P = low.n, low.m, low.n_params
    so = low.second_order
    nk = len(low.consts)
    ind = "    "
    L = _head("LoweredTiles", n, m, LOWERED_TILES_ID, nk, P,
              ["PACKED = false",
               f"SECOND_ORDER = {'true' if so else 'false'}"], [
                  "// A user's derivative tiles lowered from their traced "
                  "Python function",
                  "// (ops/hopper/lower.py) as K1's analytic expansion: each "
                  "aten operation",
                  "// in traced order, constants in k[] (entries that depend "
                  "on no input",
                  "// folded), the step's other entries in Derivs::v."])
    L += _descriptor("LoweredTiles", nk, P)
    nhv = n * n + n * m + m * m
    L += ["",
          "  struct Derivs {",
          f"    float v[{max(len(low.fn.outs), 1)}];"]
    if so:
        L.append(f"    float hv[{nhv}];   // Σ_a Vx[a]·∂²f_a: x×x, x×u, u×u")
    L += ["  };", "",
          "  __device__ __forceinline__ void derivs(const float (&x)[N], "
          "const float (&u)[M],",
          "                                         int t, Derivs& d) const {"]
    L += _body(low.fn, ind, _needs(low.fn, low.fn.outs))
    L += [f"{ind}d.v[{i}] = {_c(r)};" for i, r in enumerate(low.fn.outs)]
    L += ["  }"]
    if so:
        # the V′ contraction of each second-order entry, a from 0 (K1's
        # plain version's order), the zero entries multiplied too
        fxx, fxu, fuu = (low.entries[f] for f in SO_FIELDS)

        def f2(a, i, j):
            if i < n and j < n:
                return fxx[(a * n + i) * n + j]
            if i < n:
                return fxu[(a * n + i) * m + (j - n)]
            return fuu[(a * m + (i - n)) * m + (j - n)]

        pairs = ([(i, j) for i in range(n) for j in range(n)]
                 + [(i, n + mi) for i in range(n) for mi in range(m)]
                 + [(n + mi, n + mj) for mi in range(m) for mj in range(m)])
        L += ["",
              "  __device__ __forceinline__ void derivs_so(const float (&x)[N], "
              "const float (&u)[M],",
              "                                            int t, const float "
              "(&Vx)[N], Derivs& d) const {",
              f"{ind}derivs(x, u, t, d);"]
        for h, (i, j) in enumerate(pairs):
            terms = [f"Vx[{a}] * {_src(f2(a, i, j))}" for a in range(n)]
            L.append(f"{ind}{{")
            L.append(f"{ind}  float s = {terms[0]};")
            L += [f"{ind}  s = s + {tm};" for tm in terms[1:]]
            L += [f"{ind}  d.hv[{h}] = s;", f"{ind}}}"]
        L += ["  }", "",
              "  // vh(d, i, j) at z = (x, u): the pairs K1 reads",
              "  __device__ __forceinline__ float vh(const Derivs& d, int i, "
              "int j) const {"]
        L += _switch(tuple(("hv", h) for h in range(len(pairs))),
                     "i * (N + M) + j", ind,
                     [i * (n + m) + j for i, j in pairs])
        L += ["  }"]
    for f in ("fx", "fu", "cx", "cu", "cxx", "cxu", "cuu"):
        args, index = ACCESSORS[f]
        L += ["",
              f"  __device__ __forceinline__ float {f}(const Derivs& d, "
              f"{args}) const {{"]
        L += _switch(low.entries[f], index, ind)
        L += ["  }"]
    L += ["};", ""]
    return "\n".join(L)
