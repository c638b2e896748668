"""muparser-compatible expression -> torch evaluator.

The reference evaluates user expressions (wave speed C, forcing F, initial
data U0/V0, boundary data G/DGDT, optional exact Solution) through deal.II's
``FunctionParser`` (muparser) at every quadrature point of every cell, every
step (see reference src/WaveTheta.cpp:164-172, initialised at
src/ParameterReader.cpp:166-172). Here the expression is parsed ONCE into an
AST (the same Pratt parser as tpuwave) and evaluated as whole-grid torch
operations, so evaluation costs a few elementwise passes per call.

Grammar (the muparser subset exercised by the 12 reference presets, plus a
safety margin):

    expr    := or
    or      := and ("||" and)*
    and     := cmp ("&&" cmp)*
    cmp     := add (("<"|"<="|">"|">="|"=="|"!=") add)?
    add     := mul (("+"|"-") mul)*
    mul     := unary (("*"|"/") unary)*
    unary   := ("-"|"+"|"!") unary | power
    power   := atom ("^" unary)?          # right-assoc; binds tighter than
                                          # unary minus: -x^2 == -(x^2)
    atom    := NUMBER | IDENT | IDENT "(" args ")" | "(" expr ")"

``if(cond, a, b)`` maps to ``torch.where`` (both branches evaluated — fine
for the preset grammar, which never guards singular branches). Comparisons
and logical ops produce booleans; arithmetic on booleans promotes to the
grid's float dtype.

Scalars (numbers, constants, and ``t`` when it is a Python float) become
0-d tensors of the grid's dtype and device before any torch function sees
them; plain ``+ - * /`` between Python numbers stays Python (f64) arithmetic,
as in tpuwave.

Constants may be written with symbolic pi: ``k=4.0*pi`` (reference
ParameterReader.cpp:237-294).
"""

from __future__ import annotations

import math
import re
from typing import Dict, List, Optional, Sequence

import torch

__all__ = [
    "Expression",
    "ExprError",
    "parse_value_with_pi",
    "parse_constants_with_pi",
]


class ExprError(ValueError):
    """Raised on tokenisation/parse errors, with position info."""


# ---------------------------------------------------------------------------
# Tokeniser
# ---------------------------------------------------------------------------

_TOKEN_RE = re.compile(
    r"""\s*(?:
        (?P<num>(?:\d+\.?\d*|\.\d+)(?:[eE][+-]?\d+)?)
      | (?P<ident>[A-Za-z_][A-Za-z_0-9]*)
      | (?P<op><=|>=|==|!=|&&|\|\||[-+*/^(),<>!])
    )""",
    re.VERBOSE,
)


def _tokenize(s: str) -> List[tuple]:
    tokens = []
    pos = 0
    while pos < len(s):
        m = _TOKEN_RE.match(s, pos)
        if m is None:
            if s[pos:].strip() == "":
                break
            raise ExprError(f"Unexpected character {s[pos]!r} at position {pos} in {s!r}")
        if m.lastgroup == "num":
            tokens.append(("num", float(m.group("num"))))
        elif m.lastgroup == "ident":
            tokens.append(("ident", m.group("ident")))
        else:
            tokens.append(("op", m.group("op")))
        pos = m.end()
    tokens.append(("end", None))
    return tokens


# ---------------------------------------------------------------------------
# Pratt parser -> AST (nested tuples)
# ---------------------------------------------------------------------------

_BINARY_BP = {
    "||": 10,
    "&&": 20,
    "==": 30, "!=": 30,
    "<": 40, "<=": 40, ">": 40, ">=": 40,
    "+": 50, "-": 50,
    "*": 60, "/": 60,
    "^": 80,
}
_RIGHT_ASSOC = {"^"}
_UNARY_BP = 70  # between mul and pow: -x^2 parses as -(x^2)


class _Parser:
    def __init__(self, tokens: List[tuple], src: str):
        self.tokens = tokens
        self.i = 0
        self.src = src

    def peek(self):
        return self.tokens[self.i]

    def next(self):
        tok = self.tokens[self.i]
        self.i += 1
        return tok

    def expect_op(self, op: str):
        kind, val = self.next()
        if kind != "op" or val != op:
            raise ExprError(f"Expected {op!r}, got {val!r} in {self.src!r}")

    def parse(self):
        node = self.parse_expr(0)
        kind, val = self.peek()
        if kind != "end":
            raise ExprError(f"Trailing input {val!r} in {self.src!r}")
        return node

    def parse_expr(self, min_bp: int):
        node = self.parse_prefix()
        while True:
            kind, val = self.peek()
            if kind != "op" or val not in _BINARY_BP:
                break
            bp = _BINARY_BP[val]
            if bp < min_bp:
                break
            self.next()
            next_bp = bp if val in _RIGHT_ASSOC else bp + 1
            rhs = self.parse_expr(next_bp)
            node = ("bin", val, node, rhs)
        return node

    def parse_prefix(self):
        kind, val = self.peek()
        if kind == "op" and val in ("-", "+", "!"):
            self.next()
            operand = self.parse_expr(_UNARY_BP)
            if val == "-":
                return ("neg", operand)
            if val == "!":
                return ("not", operand)
            return operand
        return self.parse_atom()

    def parse_atom(self):
        kind, val = self.next()
        if kind == "num":
            return ("num", val)
        if kind == "ident":
            pkind, pval = self.peek()
            if pkind == "op" and pval == "(":
                self.next()
                args = []
                if not (self.peek() == ("op", ")")):
                    args.append(self.parse_expr(0))
                    while self.peek() == ("op", ","):
                        self.next()
                        args.append(self.parse_expr(0))
                self.expect_op(")")
                return ("call", val, tuple(args))
            return ("var", val)
        if kind == "op" and val == "(":
            node = self.parse_expr(0)
            self.expect_op(")")
            return node
        raise ExprError(f"Unexpected token {val!r} in {self.src!r}")


# ---------------------------------------------------------------------------
# Evaluation
# ---------------------------------------------------------------------------

class _Ctx:
    """dtype and device of the grid an expression is evaluated on."""

    __slots__ = ("dtype", "device")

    def __init__(self, dtype=torch.float64, device=torch.device("cpu")):
        self.dtype = dtype
        self.device = device


#: constant folding runs on the host in f64 (tpuwave folds with x64 on)
_HOST = _Ctx()


def _as_num(v, ctx: _Ctx):
    """Promote booleans (from comparisons) for arithmetic use."""
    if isinstance(v, bool):
        return 1.0 if v else 0.0
    if isinstance(v, torch.Tensor) and v.dtype == torch.bool:
        return v.to(ctx.dtype)
    return v


def _t(v, ctx: _Ctx):
    """A tensor on the grid's device: scalars become 0-d tensors of the
    grid's dtype; tensors pass through."""
    if isinstance(v, torch.Tensor):
        return v
    if isinstance(v, bool):
        return torch.full((), v, dtype=torch.bool, device=ctx.device)
    return torch.full((), float(v), dtype=ctx.dtype, device=ctx.device)


def _num_t(v, ctx: _Ctx):
    return _t(_as_num(v, ctx), ctx)


def _bool_t(v, ctx: _Ctx):
    v = _t(v, ctx)
    return v if v.dtype == torch.bool else v != 0


_FUNCS_1 = {
    "sin": torch.sin, "cos": torch.cos, "tan": torch.tan,
    "asin": torch.asin, "acos": torch.acos, "atan": torch.atan,
    "sinh": torch.sinh, "cosh": torch.cosh, "tanh": torch.tanh,
    "asinh": torch.asinh, "acosh": torch.acosh, "atanh": torch.atanh,
    "exp": torch.exp, "log": torch.log, "ln": torch.log,
    "log2": torch.log2, "log10": torch.log10,
    "sqrt": torch.sqrt, "abs": torch.abs, "sign": torch.sign,
    "rint": torch.round, "floor": torch.floor, "ceil": torch.ceil,
}


def _pow(a, b, ctx: _Ctx):
    a, b = _as_num(a, ctx), _as_num(b, ctx)
    if not isinstance(a, torch.Tensor) and not isinstance(b, torch.Tensor):
        return a ** b
    return torch.pow(_t(a, ctx), _t(b, ctx))


_BIN_OPS = {
    "+": lambda a, b, c: _as_num(a, c) + _as_num(b, c),
    "-": lambda a, b, c: _as_num(a, c) - _as_num(b, c),
    "*": lambda a, b, c: _as_num(a, c) * _as_num(b, c),
    "/": lambda a, b, c: _as_num(a, c) / _as_num(b, c),
    "^": _pow,
    "<": lambda a, b, c: a < b,
    "<=": lambda a, b, c: a <= b,
    ">": lambda a, b, c: a > b,
    ">=": lambda a, b, c: a >= b,
    "==": lambda a, b, c: a == b,
    "!=": lambda a, b, c: a != b,
    "&&": lambda a, b, c: torch.logical_and(_bool_t(a, c), _bool_t(b, c)),
    "||": lambda a, b, c: torch.logical_or(_bool_t(a, c), _bool_t(b, c)),
}


_KNOWN_CALLS = frozenset({"if", "min", "max", "atan2", "pow"})


def _free_vars(node, out: set, calls: Optional[set] = None):
    tag = node[0]
    if tag == "var":
        out.add(node[1])
    elif tag == "bin":
        _free_vars(node[2], out, calls)
        _free_vars(node[3], out, calls)
    elif tag in ("neg", "not"):
        _free_vars(node[1], out, calls)
    elif tag == "call":
        if calls is not None:
            calls.add(node[1])
        for a in node[2]:
            _free_vars(a, out, calls)


def _eval(node, env: Dict[str, object], ctx: _Ctx = _HOST):
    tag = node[0]
    if tag == "num":
        return node[1]
    if tag == "var":
        try:
            return env[node[1]]
        except KeyError:
            raise ExprError(f"Unknown variable/constant {node[1]!r}")
    if tag == "neg":
        return -_as_num(_eval(node[1], env, ctx), ctx)
    if tag == "not":
        return torch.logical_not(_bool_t(_eval(node[1], env, ctx), ctx))
    if tag == "bin":
        return _BIN_OPS[node[1]](_eval(node[2], env, ctx),
                                 _eval(node[3], env, ctx), ctx)
    if tag == "call":
        name, args = node[1], node[2]
        vals = [_eval(a, env, ctx) for a in args]
        if name == "if":
            if len(vals) != 3:
                raise ExprError("if() takes exactly 3 arguments")
            return torch.where(_bool_t(vals[0], ctx), _num_t(vals[1], ctx),
                               _num_t(vals[2], ctx))
        if name in ("min", "max"):
            fn = torch.minimum if name == "min" else torch.maximum
            out = _num_t(vals[0], ctx)
            for v in vals[1:]:
                out = fn(out, _num_t(v, ctx))
            return out
        if name == "atan2":
            return torch.atan2(_num_t(vals[0], ctx), _num_t(vals[1], ctx))
        if name == "pow":
            return _pow(vals[0], vals[1], ctx)
        if name in _FUNCS_1:
            if len(vals) != 1:
                raise ExprError(f"{name}() takes exactly 1 argument")
            return _FUNCS_1[name](_num_t(vals[0], ctx))
        raise ExprError(f"Unknown function {name!r}")
    raise ExprError(f"Bad AST node {node!r}")


# ---------------------------------------------------------------------------
# Public API
# ---------------------------------------------------------------------------

class Expression:
    """A parsed muparser-style expression, evaluated with torch ops.

    Parameters mirror deal.II ``FunctionParser::initialize``
    (reference src/ParameterReader.cpp:166-172): the variable-name list
    (e.g. ``"x, y, t"``), the expression string, and a constants map.
    ``pi`` is always available.
    """

    def __init__(self, expression: str, constants: Optional[Dict[str, float]] = None,
                 variable_names: Sequence[str] = ("x", "y", "t")):
        if isinstance(variable_names, str):
            variable_names = [v.strip() for v in variable_names.split(",") if v.strip()]
        self.expression = expression
        self.variable_names = tuple(variable_names)
        self.constants = dict(constants or {})
        self.constants.setdefault("pi", math.pi)
        self.ast = _Parser(_tokenize(expression), expression).parse()

        used: set = set()
        called: set = set()
        _free_vars(self.ast, used, called)
        unknown = used - set(self.variable_names) - set(self.constants)
        if unknown:
            raise ExprError(
                f"Unknown symbols {sorted(unknown)} in expression {expression!r}")
        bad_calls = called - set(_FUNCS_1) - _KNOWN_CALLS
        if bad_calls:
            raise ExprError(
                f"Unknown functions {sorted(bad_calls)} in expression {expression!r}")
        self.used_variables = frozenset(used & set(self.variable_names))
        #: True iff 't' is declared AND actually used (cheap time invariance).
        self.time_dependent = "t" in self.used_variables

        # Constant folding: if no variables are used, the expression is a
        # single number — hot paths exploit this (F == 0 skips the load
        # vector entirely; G == 0 makes BCs static).
        self._const: Optional[float] = None
        if not self.used_variables:
            v = _as_num(_eval(self.ast, dict(self.constants)), _HOST)
            self._const = float(v)

    # -- introspection ------------------------------------------------------
    @property
    def constant_value(self) -> Optional[float]:
        """The value if this expression is a constant, else None."""
        return self._const

    @property
    def is_zero(self) -> bool:
        return self._const == 0.0

    # -- evaluation ---------------------------------------------------------
    def __call__(self, **env):
        full = dict(self.constants)
        full.update(env)
        return _eval(self.ast, full)

    def evaluate(self, x, y, t=None):
        """Evaluate at points (x, y) and scalar/tensor time t.

        ``x`` and ``y`` are tensors on the grid's device. Broadcasts the
        result against the broadcast shape of x, y and t (so pure-t or
        constant expressions still return per-point tensors, and a (k, 1)
        t against (1, n) points gives k rows of n values) and casts to x's
        dtype.
        """
        ctx = _Ctx(x.dtype, x.device)
        env = dict(self.constants)
        env.update(x=x, y=y)
        shape = torch.broadcast_shapes(x.shape, y.shape)
        if "t" in self.variable_names:
            env["t"] = _t(0.0 if t is None else t, ctx)
            shape = torch.broadcast_shapes(shape, env["t"].shape)
        out = _num_t(_eval(self.ast, env, ctx), ctx)
        return torch.broadcast_to(out.to(x.dtype), shape)

    def __repr__(self):
        return f"Expression({self.expression!r}, vars={self.variable_names})"


def parse_value_with_pi(value: str) -> float:
    """Parse a numeric string possibly using symbolic pi.

    Recognised forms (reference ParameterReader.cpp:237-265): ``pi``
    (case-insensitive), ``<number>*pi``, or a plain numeric literal.
    """
    value = value.strip()
    if value.lower() == "pi":
        return math.pi
    m = re.match(r"^\s*([0-9]*\.?[0-9]+)\s*\*\s*pi\s*$", value, re.IGNORECASE)
    if m:
        return float(m.group(1)) * math.pi
    return float(value)


def parse_constants_with_pi(s: str) -> Dict[str, float]:
    """Parse ``"k=4.0*pi, a=0.5"`` into a constants map.

    Mirrors reference ParameterReader.cpp:267-294: comma-separated
    ``key=value`` items; items without '=' are skipped.
    """
    out: Dict[str, float] = {}
    for item in s.split(","):
        if "=" not in item:
            continue
        key, val = item.split("=", 1)
        key = key.strip()
        if key:
            out[key] = parse_value_with_pi(val)
    return out
