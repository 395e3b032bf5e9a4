"""User-defined semirings and Python-callable epilogues, compiled for the
card: a torch.fx trace of the callable, a small IR, and two backends of it.

The counterpart of Pallas tracing ``sr.map_op`` / ``sr.reduce_op`` into
``gemm_hls_tpu/ops/pallas_vpu.py::_vpu_kernel`` (:56-91) and an ``epilogue``
callable into ``pallas_mxu.py::_kernel``'s store (:103-105).  A CUDA kernel
runs only what was compiled into it, so a callable is translated here into
C++ and built at first use into a library of its own
(``_build.generated_library``), keyed by the generated text:

* :func:`lower` traces ``fn`` with ``torch.fx.symbolic_trace`` (a bare
  builtin such as ``torch.maximum`` is first wrapped in a function of its
  arity), maps every node onto the op table ``OPS``, and finds each
  value's dtype by running the IR on one-element tensors of the inputs'
  dtypes, so the types follow PyTorch's promotion exactly;
* :func:`evaluate` runs the IR with torch ops (the CPU tests hold it against
  the callable and, through the plain versions, against the JAX package);
* :func:`semiring_source` / :func:`epilogue_source` emit a translation
  unit: a B3 functor ``step(acc, a, b) = reduce(acc, map(a, b))`` for
  ``csrc/simt_gemm.cuh``'s tile, or an epilogue functor for the store of
  the B1 / B2 route the route rule gives the call (``csrc/gen_ops.cuh``
  holds the arithmetic they use).

Refused with NotImplementedError, before any build: an op outside the
table; an op that reduces, reshapes, indexes or mixes elements (a kernel
applies the callable per element of a tile, which differs from the
whole-row result); Python control flow on values (fx raises on it); a
tensor constant closed over; true division of integers; a semiring whose
map or reduce leaves the accumulator's dtype.
"""

from __future__ import annotations

import dataclasses
import hashlib
import math
import operator
import weakref
from typing import Callable

import torch
import torch.fx
import torch.nn.functional as F

from gemm_hls_tpu_torch import _build
from gemm_hls_tpu_torch.config import dtype_name

ITEM = "ROADMAP B coverage item 5"

# Operand limit of a generated epilogue (``e0`` .. ``e3`` of its entry).
MAX_OPERANDS = 4

# Value dtypes a functor computes in, and their C types (16-bit floats are
# held in float and rounded after each op).
_CTYPES = {torch.float64: "double", torch.float32: "float",
           torch.bfloat16: "float", torch.float16: "float",
           torch.int32: "int", torch.bool: "bool"}
_ROUND = {torch.bfloat16: "g_rbf", torch.float16: "g_rhf"}

# Kernel input types: C type and common.cuh's DType name.
_IN_TYPES = {torch.float32: ("float", "kF32"), torch.bfloat16: ("__nv_bfloat16", "kBF16"),
             torch.float16: ("__half", "kF16"), torch.int8: ("signed char", "kI8"),
             torch.int32: ("int", "kI32"), torch.float64: ("double", "kF64"),
             torch.int16: ("short", "kI16"), torch.uint8: ("unsigned char", "kU8"),
             torch.uint16: ("unsigned short", "kU16"),
             torch.uint32: ("unsigned int", "kU32"), torch.int64: ("long long", "kI64")}


def refuse(what: str, why: str) -> NotImplementedError:
    return NotImplementedError(f"{what}: {why} ({ITEM}: generated functors)")


# ---------------------------------------------------------------------------
# The op table: name -> (torch implementation for the evaluator).  Each op
# takes IR values and Python scalars; ``attrs`` holds its static options.
# ---------------------------------------------------------------------------

def _clamp(x, lo=None, hi=None):
    return torch.clamp(x, lo, hi)


def _pow(x, c):
    return torch.pow(x, c)


def _cast(x, dtype):
    return x.to(dtype)


OPS = {
    "add": torch.add, "sub": torch.sub, "mul": torch.mul, "div": torch.div,
    "neg": torch.neg, "abs": torch.abs,
    "minimum": torch.minimum, "maximum": torch.maximum, "clamp": _clamp,
    "relu": torch.relu,
    "gt": torch.gt, "lt": torch.lt, "ge": torch.ge, "le": torch.le,
    "eq": torch.eq, "ne": torch.ne, "where": torch.where,
    "exp": torch.exp, "expm1": torch.expm1, "log": torch.log,
    "log1p": torch.log1p, "sqrt": torch.sqrt, "rsqrt": torch.rsqrt,
    "tanh": torch.tanh, "sigmoid": torch.sigmoid, "silu": F.silu,
    "gelu": lambda x: F.gelu(x), "gelu_tanh": lambda x: F.gelu(x, approximate="tanh"),
    "softplus": lambda x: F.softplus(x), "logaddexp": torch.logaddexp,
    "pow": _pow, "square": torch.square,
    "and": torch.bitwise_and, "or": torch.bitwise_or, "xor": torch.bitwise_xor,
    "not": torch.bitwise_not, "shl": torch.bitwise_left_shift,
    "shr": torch.bitwise_right_shift, "cast": _cast,
}

# fx targets -> op.  call_function targets are objects, call_method ones
# strings (the Tensor method's name).
_BINARY = {
    "add": (operator.add, torch.add, "add", "__add__", "__radd__"),
    "sub": (operator.sub, torch.sub, torch.subtract, "sub", "subtract"),
    "mul": (operator.mul, torch.mul, torch.multiply, "mul", "multiply"),
    "div": (operator.truediv, torch.div, torch.true_divide, torch.divide, "div",
            "true_divide", "divide"),
    "minimum": (torch.minimum, "minimum"), "maximum": (torch.maximum, "maximum"),
    "gt": (operator.gt, torch.gt, torch.greater, "gt", "greater"),
    "lt": (operator.lt, torch.lt, torch.less, "lt", "less"),
    "ge": (operator.ge, torch.ge, torch.greater_equal, "ge", "greater_equal"),
    "le": (operator.le, torch.le, torch.less_equal, "le", "less_equal"),
    "eq": (operator.eq, torch.eq, "eq"), "ne": (operator.ne, torch.ne, torch.not_equal, "ne"),
    "logaddexp": (torch.logaddexp, "logaddexp"),
    "and": (operator.and_, torch.bitwise_and, "bitwise_and"),
    "or": (operator.or_, torch.bitwise_or, "bitwise_or"),
    "xor": (operator.xor, torch.bitwise_xor, "bitwise_xor"),
    "shl": (operator.lshift, torch.bitwise_left_shift, "bitwise_left_shift"),
    "shr": (operator.rshift, torch.bitwise_right_shift, "bitwise_right_shift"),
}
_UNARY = {
    "neg": (operator.neg, torch.neg, torch.negative, "neg", "negative"),
    "abs": (operator.abs, torch.abs, torch.absolute, "abs", "absolute"),
    "relu": (torch.relu, F.relu, "relu"),
    "exp": (torch.exp, "exp"), "expm1": (torch.expm1, "expm1"),
    "log": (torch.log, "log"), "log1p": (torch.log1p, "log1p"),
    "sqrt": (torch.sqrt, "sqrt"), "rsqrt": (torch.rsqrt, "rsqrt"),
    "tanh": (torch.tanh, F.tanh, "tanh"),
    "sigmoid": (torch.sigmoid, F.sigmoid, "sigmoid"),
    "silu": (F.silu,), "square": (torch.square, "square"),
    "not": (operator.invert, torch.bitwise_not, "bitwise_not"),
}
_CASTS = {"float": torch.float32, "double": torch.float64, "half": torch.float16,
          "bfloat16": torch.bfloat16, "int": torch.int32, "bool": torch.bool}
# Ops that reduce, reshape, index or mix elements: named in their refusal.
_MIXING = {
    "sum", "amax", "amin", "mean", "prod", "softmax", "log_softmax", "logsumexp",
    "cumsum", "cumprod", "norm", "argmax", "argmin", "var", "std", "any", "all",
    "getitem", "view", "reshape", "expand", "expand_as", "transpose", "permute",
    "flip", "roll", "t", "squeeze", "unsqueeze", "flatten", "cat", "stack",
    "matmul", "mm", "bmm", "einsum", "size", "narrow", "index_select", "gather",
    "scatter", "repeat", "sort", "topk", "cummax", "cummin", "max", "min",
    "contiguous", "getattr", "layer_norm", "normalize", "dropout",
}


def _target_table():
    table = {}
    for op, targets in list(_BINARY.items()) + list(_UNARY.items()):
        for t in targets:
            table.setdefault(t, op)
    return table


_TARGETS = _target_table()


def _target_name(node) -> str:
    t = node.target
    if isinstance(t, str):
        return t
    return getattr(t, "__name__", str(t))


@dataclasses.dataclass(frozen=True)
class Program:
    """A traced callable: its inputs' dtypes, ops in order (op name, args,
    attrs; an arg is ("v", value index) or ("c", Python scalar)), each
    value's dtype (inputs first) and each op's compute dtype (a
    comparison's: its operands' promoted one); ``out`` is the result's
    value index."""

    dtypes: tuple
    ops: tuple
    vdtypes: tuple
    cdtypes: tuple
    out: int
    what: str

    @property
    def out_dtype(self):
        return self.vdtypes[self.out]


def _arg(a, env, what):
    if isinstance(a, torch.fx.Node):
        return ("v", env[a])
    if isinstance(a, bool) or isinstance(a, (int, float)):
        return ("c", a)
    raise refuse(what, f"an argument {a!r} of type {type(a).__name__}")


def _bind(args, kwargs, names, defaults=None):
    """Positional and keyword arguments as a dict over ``names``."""
    got = dict(defaults or {})
    for n, a in zip(names, args):
        got[n] = a
    got.update(kwargs)
    return got


def _normalize(node, env, what):
    """(op, args, attrs) of one fx node, or a refusal."""
    name = _target_name(node)
    op = _TARGETS.get(node.target)
    args, kw = list(node.args), dict(node.kwargs)
    if op is None and node.op == "call_method" and name in _CASTS:
        return "cast", [_arg(args[0], env, what)], {"dtype": _CASTS[name]}
    if op is None and name == "to":
        b = _bind(args, kw, ("self", "dtype"))
        if not isinstance(b.get("dtype"), torch.dtype) or set(b) - {"self", "dtype", "copy"}:
            raise refuse(what, "Tensor.to takes a dtype only here")
        return "cast", [_arg(b["self"], env, what)], {"dtype": b["dtype"]}
    if op is None and name == "type_as":
        return "cast", [_arg(args[0], env, what)], {"like": _arg(args[1], env, what)}
    if op is None and name in ("clamp", "clip", "clamp_min", "clamp_max"):
        names = ("input", "min") if name == "clamp_min" else (
            ("input", "max") if name == "clamp_max" else ("input", "min", "max"))
        b = _bind(args, kw, names)
        lo, hi = b.get("min"), b.get("max")
        if lo is None and hi is None:
            raise refuse(what, f"{name} without a bound")
        return "clamp", [_arg(b["input"], env, what),
                         None if lo is None else _arg(lo, env, what),
                         None if hi is None else _arg(hi, env, what)], {}
    if op is None and name in ("min", "max") and len(args) == 2 and not kw \
            and isinstance(args[1], torch.fx.Node):
        op = "minimum" if name == "min" else "maximum"
    if op is None and name == "where":
        if node.op == "call_method":  # x.where(condition, y)
            b = _bind(args, kw, ("self", "condition", "other"))
            args, kw = [b["condition"], b["self"], b["other"]], {}
        b = _bind(args, kw, ("condition", "input", "other"))
        if set(b) != {"condition", "input", "other"}:
            raise refuse(what, "torch.where takes its three-argument form here")
        return "where", [_arg(b[k], env, what) for k in ("condition", "input", "other")], {}
    if op is None and node.target is F.gelu:
        b = _bind(args, kw, ("input", "approximate"), {"approximate": "none"})
        if b["approximate"] not in ("none", "tanh"):
            raise refuse(what, f"gelu approximate={b['approximate']!r}")
        return ("gelu_tanh" if b["approximate"] == "tanh" else "gelu",
                [_arg(b["input"], env, what)], {})
    if op is None and node.target is F.softplus:
        b = _bind(args, kw, ("input", "beta", "threshold"), {"beta": 1, "threshold": 20})
        if b["beta"] != 1 or b["threshold"] != 20:
            raise refuse(what, "softplus takes its default beta 1 and threshold 20 here")
        return "softplus", [_arg(b["input"], env, what)], {}
    if op is None and (name in ("pow", "__pow__") or node.target in (operator.pow, torch.pow)):
        b = _bind(args, kw, ("input", "exponent"))
        e = b.get("exponent")
        if not isinstance(b.get("input"), torch.fx.Node) or isinstance(e, torch.fx.Node) \
                or not isinstance(e, (int, float)) or isinstance(e, bool):
            raise refuse(what, "pow takes a tensor base and a constant exponent here")
        return "pow", [_arg(b["input"], env, what), ("c", e)], {}
    if op is None:
        if name in _MIXING:
            raise refuse(what, f"op {name!r} reduces, reshapes, indexes or mixes "
                               f"elements: a kernel applies the callable per element "
                               f"of a tile")
        raise refuse(what, f"op {name!r} is not in the generated-functor op table")
    if op in _UNARY:
        if node.target is F.relu or node.target is F.silu:
            b = _bind(args, kw, ("input", "inplace"), {"inplace": False})
            if b["inplace"]:
                raise refuse(what, f"{name}(inplace=True)")
            args, kw = [b["input"]], {}
        if kw or len(args) != 1:
            raise refuse(what, f"{name} with arguments {args[1:]} {kw}")
        return op, [_arg(args[0], env, what)], {}
    b = _bind(args, kw, ("input", "other"))
    if b.pop("alpha", 1) != 1 or b.pop("rounding_mode", None) is not None:
        raise refuse(what, f"{name} with alpha or rounding_mode")
    if set(b) != {"input", "other"}:
        raise refuse(what, f"{name} with arguments {args} {kw}")
    return op, [_arg(b["input"], env, what), _arg(b["other"], env, what)], {}


def _wrap(fn: Callable, arity: int) -> Callable:
    """``fn`` as a Python function of ``arity`` named arguments (fx cannot
    trace a C builtin passed bare, nor read a varargs signature)."""
    names = [f"x{i}" for i in range(arity)]
    scope = {"fn": fn}
    exec(f"def traced({', '.join(names)}):\n    return fn({', '.join(names)})\n", scope)
    return scope["traced"]


def _run(ops, values, infer=False):
    """Run ``ops`` on ``values`` (the inputs' tensors), appending each
    result; returns the values and, with ``infer``, each op's compute dtype
    (a comparison's: its operands' promoted one)."""
    cdt = []
    for op, args, attrs in ops:
        xs = [None if a is None else (values[a[1]] if a[0] == "v" else a[1]) for a in args]
        kw = {}
        if op == "cast":
            like = attrs.get("like")
            kw["dtype"] = values[like[1]].dtype if like else attrs["dtype"]
        out = OPS[op](*xs, **kw)
        if infer:
            tens = [x for x in xs if x is not None]
            if op in ("gt", "lt", "ge", "le", "eq", "ne"):
                cdt.append(torch.result_type(*tens))
            else:
                cdt.append(out.dtype)
        values.append(out)
    return values, cdt


def lower(fn: Callable, in_dtypes, what: str = "callable") -> Program:
    """Trace ``fn`` (called with ``len(in_dtypes)`` tensors) into a
    :class:`Program`; raises NotImplementedError for anything the functor
    cannot express, before any build."""
    arity = len(in_dtypes)
    for d in in_dtypes:
        if d not in _CTYPES:
            raise refuse(what, f"a {dtype_name(d)} input")
    try:
        gm = torch.fx.symbolic_trace(_wrap(fn, arity))
    except torch.fx.proxy.TraceError as e:
        raise refuse(what, f"Python control flow on values cannot be traced ({e})") from None
    except (TypeError, RuntimeError, AttributeError, ValueError) as e:
        raise refuse(what, f"torch.fx cannot trace it ({type(e).__name__}: {e})") from None
    env, ops, out = {}, [], None
    for node in gm.graph.nodes:
        if node.op == "placeholder":
            env[node] = len(env)
        elif node.op in ("call_function", "call_method"):
            ops.append(_normalize(node, env, what))
            env[node] = arity + len(ops) - 1
        elif node.op == "get_attr":
            raise refuse(what, f"a tensor constant ({node.target}) closed over")
        elif node.op == "output":
            res = node.args[0]
            if not isinstance(res, torch.fx.Node):
                raise refuse(what, f"the result {res!r} is not one tensor")
            out = env[res]
        else:
            raise refuse(what, f"fx node {node.op} {node.target}")
    try:
        values, cdt = _run(ops, [torch.ones(1, dtype=d) for d in in_dtypes], infer=True)
    except (RuntimeError, TypeError) as e:
        raise refuse(what, f"torch refuses it on {[dtype_name(d) for d in in_dtypes]} "
                           f"inputs ({e})") from None
    vdt = tuple(v.dtype for v in values)
    for (op, _, _), d in zip(ops, vdt[arity:]):
        if d not in _CTYPES:
            raise refuse(what, f"op {op} yields {dtype_name(d)}")
    for op, args, _ in ops:
        if op == "div" and any(a is not None and a[0] == "v" and not vdt[a[1]].is_floating_point
                               for a in args):
            raise refuse(what, "true division of an integer value (an integer "
                               "accumulator's division)")
    return Program(tuple(in_dtypes), tuple(ops), vdt, tuple(cdt), out, what)


def evaluate(prog: Program, *xs):
    """The IR run with torch ops on ``xs`` (the inputs, in order)."""
    if len(xs) != len(prog.dtypes):
        raise ValueError(f"{prog.what} takes {len(prog.dtypes)} inputs, got {len(xs)}")
    values, _ = _run(prog.ops, list(xs))
    return values[prog.out]


# ---------------------------------------------------------------------------
# C++ backend
# ---------------------------------------------------------------------------

def literal(v, dtype) -> str:
    """A Python scalar as a C constant of ``dtype``'s compute type: floats
    as hex literals cast to float (no double arithmetic in a float functor),
    exactly as torch casts a Python scalar to an op's compute type."""
    ct = _CTYPES[dtype]
    if ct == "bool":
        return "true" if v else "false"
    if ct == "int":
        v = int(v)
        if not -2**31 <= v < 2**31:
            raise refuse("constant", f"{v} does not fit the int32 accumulator")
        return "(-2147483647 - 1)" if v == -2**31 else f"({v})"
    v = float(v)
    if math.isnan(v):
        text = "NAN"
    elif math.isinf(v):
        text = "INFINITY" if v > 0 else "-INFINITY"
    else:
        text = v.hex()
    return f"static_cast<{ct}>({text})"


def _compute(dtype):
    """The dtype an op of this result dtype computes in (float for the
    16-bit floats)."""
    return torch.float32 if dtype in _ROUND else dtype


def _conv(expr: str, src, dst) -> str:
    """``expr`` of dtype ``src`` as ``dst``'s C type."""
    s, d = _CTYPES[src], _CTYPES[dst]
    if s == d:
        return expr
    if d == "bool":
        return f"({expr} != 0)"
    return f"static_cast<{d}>({expr})"


class _Emitter:
    """C++ statements of a :class:`Program`; ``mode`` "semiring" uses the
    built-in B3 functors' helpers (dadd / dsub / dmul), "epilogue" the
    stores' rounded ones (ep_add / ep_sub / ep_mul)."""

    def __init__(self, prog: Program, mode: str, prefix: str, inputs):
        self.p, self.mode, self.prefix = prog, mode, prefix
        self.names = list(inputs)  # C expression of each value
        self.lines = []

    def arg(self, a, cdt):
        if a[0] == "c":
            return literal(a[1], cdt)
        return _conv(self.names[a[1]], self.p.vdtypes[a[1]], cdt)

    def _arith(self, op, cdt, x, y=None):
        ct = _CTYPES[cdt]
        if ct == "bool":
            raise refuse(self.p.what, f"arithmetic {op} on bool values")
        fn = {"add": "add", "sub": "sub", "mul": "mul"}[op]
        return f"{'d' if self.mode == 'semiring' else 'ep_'}{fn}({x}, {y})"

    def expr(self, i, op, args):
        p = self.p
        out_dt = p.vdtypes[len(p.dtypes) + i]
        cdt = _compute(p.cdtypes[i])
        ct = _CTYPES[cdt]
        a = [None if x is None else self.arg(x, cdt) for x in args]
        if op in ("add", "sub", "mul"):
            return self._arith(op, cdt, *a)
        if op == "div":
            return f"g_div({a[0]}, {a[1]})"
        if op in ("neg", "abs"):
            if ct == "bool":
                raise refuse(p.what, f"{op} of bool values")
            return f"g_{op}({a[0]})"
        if op in ("minimum", "maximum"):
            if ct == "bool":
                return f"({a[0]} {'&&' if op == 'minimum' else '||'} {a[1]})"
            return f"d{op[:3]}({a[0]}, {a[1]})"
        if op == "clamp":
            e = a[0]
            if a[1] is not None:
                e = f"dmax({e}, {a[1]})"
            if a[2] is not None:
                e = f"dmin({e}, {a[2]})"
            return e
        if op == "relu":
            return f"dmax({a[0]}, {literal(0, cdt)})"
        if op in ("gt", "lt", "ge", "le", "eq", "ne"):
            sym = {"gt": ">", "lt": "<", "ge": ">=", "le": "<=", "eq": "==", "ne": "!="}[op]
            return f"({a[0]} {sym} {a[1]})"
        if op == "where":
            cond = self.arg(args[0], torch.bool)
            return f"({cond} ? {a[1]} : {a[2]})"
        if op in ("exp", "tanh", "sigmoid"):
            return f"ep_{op}({a[0]})"
        if op in ("expm1", "log", "log1p", "sqrt", "rsqrt", "silu", "softplus"):
            return f"g_{op}({a[0]})"
        if op == "gelu":
            return f"g_gelu_erf({a[0]})"
        if op == "gelu_tanh":
            return f"ep_gelu_inline({a[0]})"
        if op == "logaddexp":
            return f"logaddexp({a[0]}, {a[1]})"
        if op == "square":
            return self._arith("mul", cdt, a[0], a[0])
        if op == "pow":
            return self._pow(cdt, a[0], args[1][1])
        if op in ("and", "or", "xor"):
            if ct == "bool":
                return f"({a[0]} {'&&' if op == 'and' else '||' if op == 'or' else '!='} {a[1]})"
            return f"({a[0]} {'&' if op == 'and' else '|' if op == 'or' else '^'} {a[1]})"
        if op == "not":
            return f"(!{a[0]})" if ct == "bool" else f"(~{a[0]})"
        if op in ("shl", "shr"):
            sh = args[1]
            if sh[0] != "c" or not 0 <= int(sh[1]) < 32:
                raise refuse(p.what, f"{op} by a value other than a constant 0-31")
            if op == "shl":
                return f"static_cast<int>(static_cast<unsigned>({a[0]}) << {int(sh[1])})"
            return f"({a[0]} >> {int(sh[1])})"
        if op == "cast":
            src = args[0]
            return _conv(self.arg(src, p.vdtypes[src[1]]), p.vdtypes[src[1]], _compute(out_dt))
        raise refuse(p.what, f"op {op} has no C form")  # pragma: no cover

    def _pow(self, cdt, x, c):
        ct = _CTYPES[cdt]
        if ct == "int":
            if c != int(c) or not 0 <= c <= 8:
                raise refuse(self.p.what, f"integer pow by {c}")
            e = literal(1, cdt)
            for _ in range(int(c)):
                e = self._arith("mul", cdt, e, x) if e != literal(1, cdt) else x
            return e
        if ct == "bool":
            raise refuse(self.p.what, "pow of bool values")
        one = literal(1, cdt)
        sq = self._arith("mul", cdt, x, x)
        special = {2: sq, 3: self._arith("mul", cdt, sq, x), 0.5: f"g_sqrt({x})",
                   -0.5: f"g_rsqrt({x})", 1: x, 0: one, -1: f"g_div({one}, {x})",
                   -2: f"g_div({one}, {sq})"}
        if c in special:
            return special[c]
        return f"g_pow({x}, {literal(c, cdt)})"

    def emit(self):
        p = self.p
        for i, (op, args, _) in enumerate(p.ops):
            out_dt = p.vdtypes[len(p.dtypes) + i]
            e = self.expr(i, op, args)
            if out_dt in _ROUND:
                e = f"{_ROUND[out_dt]}({e})"
            name = f"{self.prefix}{i}"
            self.lines.append(f"const {_CTYPES[out_dt]} {name} = {e};")
            self.names.append(name)
        return self.lines, self.names[p.out]


def _ident(text: str) -> str:
    return "gen_" + hashlib.sha256(text.encode()).hexdigest()[:16]


# ---------------------------------------------------------------------------
# B3: a user semiring
# ---------------------------------------------------------------------------

SEMIRING_ENTRY = "gen_semiring_gemm"


def lower_semiring(sr, acc_dtype):
    """(map program, reduce program) of ``sr`` on ``acc_dtype`` values."""
    what = f"semiring {sr.name!r}"
    mp = lower(sr.map_op, (acc_dtype, acc_dtype), f"{what} map")
    rp = lower(sr.reduce_op, (acc_dtype, acc_dtype), f"{what} reduce")
    for prog in (mp, rp):
        if prog.out_dtype != acc_dtype:
            raise refuse(prog.what, f"it yields {dtype_name(prog.out_dtype)} on a "
                                    f"{dtype_name(acc_dtype)} accumulator")
    return mp, rp


def semiring_source(sr, in_dtype, acc_dtype) -> str:
    """The translation unit of kernel B3 for ``sr`` on ``in_dtype`` inputs:
    the functor ``step(acc, a, b) = reduce(acc, map(a, b))`` with identity
    ``sr.identity_for(acc_dtype)`` on ``csrc/simt_gemm.cuh``'s tile, and
    ``extern "C" gen_semiring_gemm`` with ``semiring_gemm``'s arguments
    less the op code; a float64 accumulator on the float64 tile
    (``launch_simt_f64``)."""
    mp, rp = lower_semiring(sr, acc_dtype)
    act = _CTYPES[acc_dtype]
    m_lines, m_out = _Emitter(mp, "semiring", "m", ["a", "b"]).emit()
    r_lines, r_out = _Emitter(rp, "semiring", "r", ["acc", m_out]).emit()
    body = "\n".join(
        [f"struct Semiring {{",
         f"  static __device__ __forceinline__ {act} identity() {{ return "
         f"{literal(sr.identity_for(acc_dtype), acc_dtype)}; }}",
         f"  static __device__ __forceinline__ {act} step({act} acc, {act} a, {act} b) {{"]
        + [f"    {ln}" for ln in m_lines + r_lines]
        + [f"    return {r_out};", "  }", "};"])
    ns = _ident(body)
    in_ct, in_code = _IN_TYPES[in_dtype]
    # float64 runs on the tile of its own (launch_simt would reach it too).
    f64 = acc_dtype == torch.float64
    launch = "launch_simt_f64" if f64 else "launch_simt"
    targs = f"{ns}::Semiring" if f64 else f"{in_ct}, {act}, {ns}::Semiring"
    return f"""// Generated by gemm_hls_tpu_torch/ops/codegen.py: kernel B3 (csrc/simt_gemm.cuh's
// {'float64 ' if f64 else ''}tile) with the user semiring {sr.name!r} on {dtype_name(in_dtype)} inputs, a
// {dtype_name(acc_dtype)} accumulator.
#include "gen_ops.cuh"

namespace gemm_hls {{
namespace {ns} {{
{body}
}}  // namespace {ns}
}}  // namespace gemm_hls

using namespace gemm_hls;

extern "C" int {SEMIRING_ENTRY}(const void* a, const void* b, void* c, int64_t batch, int M,
                                 int N, int K, int64_t lda, int64_t ldb, int64_t sa, int64_t sb,
                                 int ta, int tb, int in_code, int out_code, void* stream) {{
  if (in_code != {in_code}) return kUnsupported;
  const Gemm g{{a, b, c, M, N, K, lda, ldb, sa, sb, ta, tb, 0, 0, out_code,
               EpArgs{{nullptr, nullptr, 0, kEpNone}}}};
  return {launch}<{targs}>(g, batch, static_cast<cudaStream_t>(stream));
}}
"""


# ---------------------------------------------------------------------------
# B1 / B2: a callable epilogue
# ---------------------------------------------------------------------------

EPILOGUE_ENTRY = "gen_epilogue_gemm"


def lower_epilogue(fn, acc_dtype, operand_dtypes, what="epilogue"):
    if len(operand_dtypes) > MAX_OPERANDS:
        raise refuse(what, f"{len(operand_dtypes)} operands; a generated epilogue "
                           f"reads at most {MAX_OPERANDS}")
    prog = lower(fn, (acc_dtype, *operand_dtypes), what)
    if prog.out_dtype == torch.float64 and acc_dtype != torch.float64:
        raise refuse(what, "float64 arithmetic in the epilogue of a "
                           f"{dtype_name(acc_dtype)}-accumulator GEMM")
    for d in prog.vdtypes:
        if d == torch.float64 and acc_dtype != torch.float64:
            raise refuse(what, "float64 values in the epilogue of a "
                               f"{dtype_name(acc_dtype)}-accumulator GEMM")
    return prog


# What of the layout each route compiles in (the rest it reads at run time).
_LAYOUT_NOTE = {
    "wgmma": lambda ta, tb: f"A {'(K, M)' if ta else '(M, K)'}, B {'(N, K)' if tb else '(K, N)'}",
    "dmma": lambda ta, tb: f"A {'(K, M)' if ta else '(M, K)'}, B {'(N, K)' if tb else '(K, N)'}",
    "wmma": lambda ta, tb: f"B's tile {'in K planes' if tb else 'row-major'}",
    "simt": lambda ta, tb: "any layout",
}


def _layout(route, in_dtype, transpose_a, transpose_b):
    """The (ta, tb) a route's library is compiled for: both for the engine
    and dmma; WMMA only whether a 16-bit B keeps its row-major tile (else
    tb); the CUDA cores neither (one library serves every layout)."""
    ta, tb = bool(transpose_a), bool(transpose_b)
    if route == "simt":
        return False, False
    if route == "wmma":
        return False, not (in_dtype.itemsize == 2 and not tb)
    return ta, tb


def epilogue_source(prog: Program, route: str, in_dtype, transpose_a: bool,
                    transpose_b: bool, tile=None) -> str:
    """The translation unit of one B1 / B2 route (``ops/mxu.py::mxu_route``:
    "wgmma", "wmma", "simt" or "dmma") for ``in_dtype`` inputs in one layout,
    with ``prog`` (``lower_epilogue``'s) as its store's epilogue functor, and
    ``extern "C" gen_epilogue_gemm`` with ``mxu_gemm``'s arguments, four
    operand pointers in place of two and no epilogue kind.  "dmma" takes
    its ``tile`` (``ops/mxu.py::dmma_tile``): "tma" (``dmma_tma.cuh``) or
    "cp_async" (``dmma_gemm.cuh``, also where none is named)."""
    acc = prog.dtypes[0]
    act = _CTYPES[acc]
    ops = prog.dtypes[1:]
    load_t = "double" if route == "dmma" else "float"
    out_dt = torch.int32 if prog.out_dtype == torch.bool else prog.out_dtype
    rt = _CTYPES[out_dt]
    names = ["acc"] + [f"c.o{i}" for i in range(len(ops))]
    lines, out = _Emitter(prog, "epilogue", "v", names).emit()
    if prog.out_dtype == torch.bool:
        out = f"static_cast<int>({out})"
    cols = " ".join(f"{_CTYPES[d]} o{i};" for i, d in enumerate(ops))
    loads = ", ".join(f"static_cast<{_CTYPES[d]}>(ep_load<{load_t}>(e[{i}], code, n))"
                      for i, d in enumerate(ops))
    body = "\n".join(
        ["struct Epilogue {",
         "  const void* e[4];",
         "  int code;  // DType of the operands as the kernel reads them",
         f"  struct Cols {{ {cols} }};",
         f"  __device__ __forceinline__ Cols load(int n) const {{ return Cols{{{loads}}}; }}",
         f"  __device__ __forceinline__ {rt} apply({act} acc, const Cols& c) const {{"]
        + [f"    {ln}" for ln in lines]
        + [f"    return {out};", "  }",
           f"  __device__ __forceinline__ {rt} operator()({act} acc, int n) const {{",
           "    return apply(acc, load(n));", "  }", "};"])
    ns = _ident(body)
    in_ct, in_code = _IN_TYPES[in_dtype]
    ta, tb = _layout(route, in_dtype, transpose_a, transpose_b)
    gemm = (f"const Gemm g{{a, b, c, M, N, K, lda, ldb, sa, sb, ta, tb, a_vec, b_vec, out_code,\n"
            f"               EpArgs{{nullptr, nullptr, 0, kEpNone}}}};")
    if route == "wgmma":
        include = "mxu_wgmma.cuh"
        launch = (f"if (batch < 1 || batch > INT_MAX) return kUnsupported;\n"
                  f"  const MxuWgCall call{{a, b, c, static_cast<int>(batch), M, N, K, lda, ldb, sa,"
                  f" sb, ta, tb,\n                       out_code, EpArgs{{nullptr, nullptr, 0, "
                  f"kEpNone}}}};\n"
                  f"  return launch_mxu_wg_ep<{in_ct}, {str(ta).lower()}, "
                  f"{str(not tb).lower()}>(call, ep, s);")
    elif route == "wmma":
        include = "mxu_tc.cuh"
        b_row = in_dtype.itemsize == 2 and not tb
        launch = f"{gemm}\n  return launch_tc_ep<{in_ct}, {str(b_row).lower()}>(g, batch, s, ep);"
    elif route == "dmma":
        tile = tile or "cp_async"
        if tile not in ("tma", "cp_async"):
            raise refuse(prog.what, f"float64 tile {tile!r}")
        include, fn = (("dmma_tma.cuh", "launch_dmma_tma_ep") if tile == "tma"
                       else ("dmma_gemm.cuh", "launch_dmma_ep"))
        launch = (f"{gemm}\n  return {fn}<{str(not ta).lower()}, "
                  f"{str(tb).lower()}>(g, batch, s, ep);")
    elif route == "simt":
        include = "simt_gemm.cuh"
        launch = (f"{gemm}\n  return launch_simt_ep<{in_ct}, {act}, PlusTimes<{act}>>"
                  f"(g, batch, s, ep);")
    else:
        raise refuse(prog.what, f"route {route!r} takes no generated epilogue")
    tile_note = f" ({tile} tile)" if route == "dmma" else ""
    return f"""// Generated by gemm_hls_tpu_torch/ops/codegen.py: kernels B1 / B2 on the
// {route!r} route{tile_note} for {dtype_name(in_dtype)} inputs ({_LAYOUT_NOTE[route](ta, tb)}), a
// {dtype_name(acc)} accumulator, and the Python callable epilogue {prog.what!r} on
// {len(ops)} per-column operand(s) at the store.
#include "{include}"
#include "gen_ops.cuh"

namespace gemm_hls {{
namespace {ns} {{
{body}
}}  // namespace {ns}
}}  // namespace gemm_hls

using namespace gemm_hls;

extern "C" int {EPILOGUE_ENTRY}(const void* a, const void* b, void* c, int64_t batch, int M,
                                 int N, int K, int64_t lda, int64_t ldb, int64_t sa, int64_t sb,
                                 int ta, int tb, int a_vec, int b_vec, int in_code, int out_code,
                                 const void* e0, const void* e1, const void* e2, const void* e3,
                                 int ep_code, void* stream) {{
  if (in_code != {in_code}) return kUnsupported;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const {ns}::Epilogue ep{{{{e0, e1, e2, e3}}, ep_code}};
  {launch}
}}
"""


# ---------------------------------------------------------------------------
# Handles: the lowered program of a callable, cached on the callable
# ---------------------------------------------------------------------------

# callable (or Semiring) -> {signature: lowered result}; weak keys, so a
# callable's programs go with it.  Builtins, which take no weak reference,
# are lowered anew each call (a millisecond).
_LOWERED = weakref.WeakKeyDictionary()


def _cached(key, sig, make):
    try:
        per = _LOWERED.setdefault(key, {})
    except TypeError:
        return make()
    if sig not in per:
        per[sig] = make()
    return per[sig]


@dataclasses.dataclass(frozen=True)
class GeneratedEpilogue:
    """What ``ops/epilogue.py::kernel_code`` returns for a callable: the
    callable, lowered at its launch for the route, types and layout the
    launch gives it (:func:`epilogue_kernel`)."""

    fn: Callable
    name: str


def semiring_spec(sr, in_dtype, acc_dtype):
    """(source, entry) of ``sr``'s B3 library for ``in_dtype`` inputs."""
    return (_cached(sr, (in_dtype, acc_dtype),
                    lambda: semiring_source(sr, in_dtype, acc_dtype)), SEMIRING_ENTRY)


def semiring_kernel(sr, in_dtype, acc_dtype):
    """``gen_semiring_gemm`` of ``sr`` for ``in_dtype`` inputs, built at
    first use (``_build.generated_library``)."""
    return _build.generated_library(*semiring_spec(sr, in_dtype, acc_dtype))


def epilogue_program(fn, acc_dtype, operand_dtypes, name="epilogue"):
    return _cached(fn, ("ep", acc_dtype, tuple(operand_dtypes)),
                   lambda: lower_epilogue(fn, acc_dtype, operand_dtypes,
                                          f"epilogue {name!r}"))


def epilogue_spec(fn, route, in_dtype, acc_dtype, operand_dtypes, transpose_a,
                  transpose_b, name="epilogue", tile=None):
    """(source, entry) of the callable ``fn``'s library on ``route`` for one
    input type and layout (and, on "dmma", one tile)."""
    prog = epilogue_program(fn, acc_dtype, operand_dtypes, name)
    ta, tb = _layout(route, in_dtype, transpose_a, transpose_b)
    src = _cached(fn, ("src", route, in_dtype, acc_dtype, tuple(operand_dtypes), ta, tb, tile),
                  lambda: epilogue_source(prog, route, in_dtype, ta, tb, tile))
    return src, EPILOGUE_ENTRY


def epilogue_kernel(fn, route, in_dtype, acc_dtype, operand_dtypes, transpose_a,
                    transpose_b, name="epilogue", tile=None):
    """``gen_epilogue_gemm`` of the callable ``fn`` on ``route`` for one
    input type and layout (and float64 tile), built at first use."""
    return _build.generated_library(*epilogue_spec(
        fn, route, in_dtype, acc_dtype, operand_dtypes, transpose_a, transpose_b, name, tile))
