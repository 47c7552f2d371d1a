"""Runtime gotran ``.ode`` ingestion: parse, then generate a torch cell
model and the CUDA node body its kernels run.

Port of ``fenicsx_beat_tpu/odefile.py`` with the same public names
(:class:`ParsedODE`, :func:`parse_ode`, :func:`generate_code`,
:func:`load_ode`), the same parser, the same gotran subset and the same
error messages.  Where the JAX module prints ``jax.numpy`` code, this one
prints two things from the same ordered sympy assignments:

- a **torch module** (:func:`generate_code`) with the gotranx contract
  (``init_state_values`` / ``init_parameter_values`` / ``state_index`` /
  ``parameter_index`` / ``rhs`` / ``forward_euler`` /
  ``generalized_rush_larsen``) and the hand-written port models' parameter
  convention (:func:`.models._common.unpack_params`): a parameter vector
  becomes Python floats, a node-aligned ``[NP, n]`` field row tensors.  It
  is the plain twin of the model's kernels;
- a **CUDA node body** (:func:`generate_cuda`): one ``__device__`` function
  per scheme (GRL1 and forward Euler) with the shape of
  ``csrc/fhn.cuh:fhn_node`` (a row pointer and stride, the storage rows of
  the voltage and of the row it swaps with, the injected ``V``, ``t``,
  ``dt`` and a parameter source).  ``csrc/ode_step.cu.in``,
  ``csrc/ode_node.cu.in`` and ``csrc/ode_multi.cu.in`` include it to make
  the model's B1, B1's per-node form and B7, which ``_build.py`` compiles
  with ``nvcc`` at the model's first step on a CUDA tensor.

Both printers are one :class:`_Printer`: every operation fully
parenthesized, in one order, integer powers as products and ``x**(1/2)``
as ``sqrt``, so the float32 twin and the kernel (built with
``-fmad=false``) round the same operations.  The C side prints float32
literals (``1.29999995e-01F``), the ``f`` functions (``expf``) and
``(c ? a : b)`` for ``Conditional``; relationals used as numbers become
``(c ? 1.0F : 0.0F)``; every gotran name gets the prefix ``g_``, so no name
collides with a C identifier or macro.

**Scheme.**  ``generalized_rush_larsen`` is GRL1 with the gotranx
linearization convention, as in the JAX module: the self-derivative of
each stated ``d<state>_dt`` with intermediates held fixed, the exponential
update where it is nonzero (guarded at ``|lin| > 1e-8``), forward Euler
where it vanishes or holds a ``Derivative``.

:func:`load_ode` registers the model's two steps with
:mod:`.ops.cuda_ode`, so the splitting solvers find their kernels by the
step function, as they find the hand-written models'.  The voltage is the
state named ``V`` or ``v``; a model with neither loads and steps on the
host but has no kernels.
"""

from __future__ import annotations

import ast
import types
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

__all__ = ["ParsedODE", "parse_ode", "generate_code", "generate_cuda", "load_ode", "ODES"]

# the gotran sources that ship with the port (the JAX demo's inline
# FitzHugh-Nagumo and the JAX tests' toy gate, copied)
ODES = Path(__file__).with_name("odes")

_DECLS = {"states", "parameters", "expressions"}
_RESERVED = {"states", "parameters", "t", "dt", "time"}


@dataclass
class ParsedODE:
    """Declaration-ordered parse of one gotran file."""

    name: str
    states: list[tuple[str, float]] = field(default_factory=list)
    parameters: list[tuple[str, float]] = field(default_factory=list)
    # (lhs name, ast expression, section label) in file order;
    # derivative assignments (``d<state>_dt``) are included
    assignments: list[tuple[str, ast.expr, str]] = field(default_factory=list)

    @property
    def state_names(self) -> list[str]:
        return [n for n, _ in self.states]

    @property
    def parameter_names(self) -> list[str]:
        return [n for n, _ in self.parameters]


def _literal_value(node: ast.expr, path: str) -> float:
    """Numeric value of a declaration default: a constant, ``-const``,
    or ``ScalarParam(value, unit=..., ...)``."""
    if (
        isinstance(node, ast.Call)
        and isinstance(node.func, ast.Name)
        and node.func.id == "ScalarParam"
    ):
        if not node.args:
            raise ValueError(f"{path}: ScalarParam with no value")
        node = node.args[0]
    try:
        v = ast.literal_eval(node)
    except (ValueError, SyntaxError) as e:
        raise ValueError(
            f"{path}: unsupported declaration value "
            f"{ast.dump(node)[:80]}"
        ) from e
    return float(v)


def parse_ode(source: str | Path, name: str | None = None) -> ParsedODE:
    """Parse gotran text or a ``.ode`` file path."""
    if isinstance(source, Path) or (
        isinstance(source, str) and "\n" not in source and source.endswith(".ode")
    ):
        path = str(source)
        text = Path(source).read_text()
        if name is None:
            name = Path(source).stem
    else:
        path = "<ode text>"
        text = str(source)
        name = name or "ode_model"

    tree = ast.parse(text)
    parsed = ParsedODE(name=name)
    seen: set[str] = set()
    section = ""
    for node in tree.body:
        if isinstance(node, ast.Expr) and isinstance(node.value, ast.Call):
            call = node.value
            fname = call.func.id if isinstance(call.func, ast.Name) else None
            if fname not in _DECLS:
                raise ValueError(
                    f"{path}:{node.lineno}: unknown declaration {fname!r}"
                )
            labels = [
                a.value
                for a in call.args
                if isinstance(a, ast.Constant) and isinstance(a.value, str)
            ]
            section = ", ".join(labels)
            target = (
                parsed.states if fname == "states"
                else parsed.parameters if fname == "parameters"
                else None
            )
            if target is None:
                continue  # expressions(...) is a group header only
            for kw in call.keywords:
                if kw.arg is None:
                    raise ValueError(f"{path}:{node.lineno}: **kwargs in {fname}")
                if kw.arg in seen:
                    raise ValueError(
                        f"{path}:{node.lineno}: duplicate declaration {kw.arg!r}"
                    )
                if kw.arg in _RESERVED or kw.arg.startswith("_"):
                    raise ValueError(
                        f"{path}:{node.lineno}: reserved name {kw.arg!r}"
                    )
                seen.add(kw.arg)
                target.append((kw.arg, _literal_value(kw.value, path)))
        elif isinstance(node, ast.Assign):
            if len(node.targets) != 1 or not isinstance(node.targets[0], ast.Name):
                raise ValueError(
                    f"{path}:{node.lineno}: only single-name assignments"
                )
            lhs = node.targets[0].id
            if lhs in seen:
                # tolerate byte-identical re-declarations (the reference's
                # ToRORd Land file repeats Aw/As verbatim at :683 and
                # :705 — a generation artifact); conflicting ones error
                prev = next(
                    (e for n_, e, _ in parsed.assignments if n_ == lhs), None
                )
                if prev is not None and ast.dump(prev) == ast.dump(node.value):
                    continue
                raise ValueError(f"{path}:{node.lineno}: reassignment of {lhs!r}")
            if lhs in _RESERVED or lhs.startswith("_"):
                raise ValueError(f"{path}:{node.lineno}: reserved name {lhs!r}")
            seen.add(lhs)
            parsed.assignments.append((lhs, node.value, section))
        else:
            raise ValueError(
                f"{path}:{node.lineno}: unsupported statement "
                f"{type(node).__name__}"
            )

    missing = [
        s for s in parsed.state_names if f"d{s}_dt" not in seen
    ]
    if missing:
        raise ValueError(f"{path}: states with no d<state>_dt: {missing}")
    return parsed


# ----------------------------------------------------------------------
# ast -> sympy
# ----------------------------------------------------------------------
def _sympy_funcs():
    import sympy as sp

    def conditional(c, a, b):
        return sp.Piecewise((a, c), (b, True))

    return {
        "exp": sp.exp, "log": sp.log, "sqrt": sp.sqrt, "floor": sp.floor,
        "Abs": sp.Abs, "Conditional": conditional,
        "Eq": sp.Eq, "Ne": sp.Ne, "Ge": sp.Ge, "Gt": sp.Gt,
        "Le": sp.Le, "Lt": sp.Lt,
        "And": sp.And, "Or": sp.Or, "Not": sp.Not,
    }


def _as_numeric(expr):
    """Gotran files use relationals as 0/1 masks in arithmetic (ToR-ORd
    Land: ``Gt(Zetas, 0)*Zetas``); sympy relationals don't multiply —
    lower them to an explicit indicator Piecewise."""
    import sympy as sp

    if expr is sp.true:
        return sp.Integer(1)
    if expr is sp.false:
        return sp.Integer(0)
    if isinstance(
        expr, (sp.core.relational.Relational, sp.logic.boolalg.BooleanFunction)
    ):
        return sp.Piecewise((1, expr), (0, True))
    return expr


def _to_sympy(node: ast.expr, symbols: dict, funcs: dict):
    import sympy as sp

    if isinstance(node, ast.Constant):
        v = node.value
        if isinstance(v, bool) or not isinstance(v, (int, float)):
            raise ValueError(f"unsupported constant {v!r}")
        return sp.Integer(v) if isinstance(v, int) else sp.Float(v)
    if isinstance(node, ast.Name):
        try:
            return symbols[node.id]
        except KeyError:
            raise ValueError(
                f"symbol {node.id!r} used before definition"
            ) from None
    if isinstance(node, ast.UnaryOp):
        val = _as_numeric(_to_sympy(node.operand, symbols, funcs))
        if isinstance(node.op, ast.USub):
            return -val
        if isinstance(node.op, ast.UAdd):
            return val
        raise ValueError(f"unsupported unary op {type(node.op).__name__}")
    if isinstance(node, ast.BinOp):
        a = _as_numeric(_to_sympy(node.left, symbols, funcs))
        b = _as_numeric(_to_sympy(node.right, symbols, funcs))
        op = type(node.op)
        if op is ast.Add:
            return a + b
        if op is ast.Sub:
            return a - b
        if op is ast.Mult:
            return a * b
        if op is ast.Div:
            return a / b
        if op is ast.Pow:
            return a ** b
        raise ValueError(f"unsupported operator {op.__name__}")
    if isinstance(node, ast.Call) and isinstance(node.func, ast.Name):
        fn = funcs.get(node.func.id)
        if fn is None:
            raise ValueError(f"unsupported function {node.func.id!r}")
        args = [_to_sympy(a, symbols, funcs) for a in node.args]
        return fn(*args)
    if isinstance(node, ast.Compare) and len(node.ops) == 1:
        a = _to_sympy(node.left, symbols, funcs)
        b = _to_sympy(node.comparators[0], symbols, funcs)
        rel = {
            ast.Lt: sp.Lt, ast.LtE: sp.Le, ast.Gt: sp.Gt,
            ast.GtE: sp.Ge, ast.Eq: sp.Eq, ast.NotEq: sp.Ne,
        }.get(type(node.ops[0]))
        if rel is None:
            raise ValueError("unsupported comparison")
        return rel(a, b)
    raise ValueError(f"unsupported expression {type(node).__name__}")




# ----------------------------------------------------------------------
# lowering: the ordered sympy assignments both outputs print
# ----------------------------------------------------------------------
@dataclass
class _Lowered:
    parsed: ParsedODE
    assignments: list  # (name, sympy expression), dependencies first
    lin: dict  # state -> its self-derivative (0 where the update is Euler)
    needed: set  # names the derivatives and self-derivatives reach
    booleans: set  # intermediates that hold a condition (a relational, And/Or/Not)
    uses_time: bool


def _lower(parsed: ParsedODE) -> _Lowered:
    import sympy as sp
    from sympy.core.relational import Relational

    funcs = _sympy_funcs()
    symbols: dict = {"time": sp.Symbol("t")}
    for n, _ in parsed.states + parsed.parameters:
        symbols[n] = sp.Symbol(n)

    # gotran permits forward references (ToR-ORd declares Ageo after its
    # first use): topologically order the assignment DAG, file-order-
    # stable among independents (gotranx does the same sort)
    ast_of = {lhs: e for lhs, e, _ in parsed.assignments}
    order: list[str] = []
    state_mark: dict[str, int] = {}  # 1 = in progress, 2 = done

    def visit(name: str):
        if state_mark.get(name) == 2:
            return
        if state_mark.get(name) == 1:
            raise ValueError(f"circular definition through {name!r}")
        state_mark[name] = 1
        for node in ast.walk(ast_of[name]):
            if isinstance(node, ast.Name) and node.id in ast_of:
                visit(node.id)
        state_mark[name] = 2
        order.append(name)

    for lhs, _, _ in parsed.assignments:
        visit(lhs)

    assignments = []
    for lhs in order:
        expr = _to_sympy(ast_of[lhs], symbols, funcs)
        symbols[lhs] = sp.Symbol(lhs)
        assignments.append((lhs, expr))
    deriv = dict(assignments)
    lin = {}
    for s in parsed.state_names:
        d = sp.diff(deriv[f"d{s}_dt"], symbols[s])
        lin[s] = sp.S.Zero if d.has(sp.Derivative) else d  # non-differentiable (floor etc.): Euler

    # what the steps need: the derivatives, the self-derivatives, and all
    # they reach through the intermediates
    needed = {f"d{s}_dt" for s in parsed.state_names} | set(parsed.state_names)
    todo = [e for e in lin.values()] + [deriv[n] for n in needed if n in deriv]
    while todo:
        for sym in todo.pop().free_symbols:
            if sym.name not in needed:
                needed.add(sym.name)
                if sym.name in deriv:
                    todo.append(deriv[sym.name])
    booleans: set[str] = set()
    for lhs, expr in assignments:
        if isinstance(expr, (Relational, sp.logic.boolalg.Boolean)) and not isinstance(expr, sp.Symbol) or (
            isinstance(expr, sp.Symbol) and expr.name in booleans
        ):
            booleans.add(lhs)
    return _Lowered(parsed, assignments, lin, needed, booleans, "t" in needed)


# ----------------------------------------------------------------------
# printing: one evaluation order for the torch twin and the CUDA body
# ----------------------------------------------------------------------
class _Printer:
    """Prints a lowered sympy expression fully parenthesized, left to
    right in the order of sympy's arguments.  The two targets differ only
    in their leaves (names, numbers, functions) and in how they select and
    combine booleans."""

    def __init__(self, names: dict[str, str], booleans: set[str]):
        self.names = names
        self.booleans = booleans  # the intermediates that hold a condition

    # -- leaves and combinators, per target ------------------------------
    def num(self, x: float) -> str:
        raise NotImplementedError

    def call(self, fn: str, *args: str) -> str:
        raise NotImplementedError

    def select(self, cond: str, a: str, b: str) -> str:
        raise NotImplementedError

    def logic(self, op: str, args: list[str]) -> str:
        raise NotImplementedError

    def boolean(self, value: bool) -> str:
        raise NotImplementedError

    # -- the shared walk ---------------------------------------------------
    def __call__(self, e, boolean: bool = False) -> str:
        """``e`` printed as a number, or as a condition when ``boolean``: a
        boolean name used as a number reads 1 or 0 (as jnp promotes it), a
        number used as a condition reads ``!= 0``."""
        import sympy as sp
        from sympy.core.relational import Relational

        if isinstance(e, sp.Symbol):
            name = self.names[e.name]
            if (e.name in self.booleans) == boolean:
                return name
            if boolean:
                return f"({name} != {self.num(0.0)})"
            return self.select(name, self.num(1.0), self.num(0.0))
        if e is sp.true or e is sp.false:
            return self.boolean(bool(e))
        if isinstance(e, Relational):
            op = {"==": "==", "!=": "!=", ">": ">", ">=": ">=", "<": "<", "<=": "<="}[e.rel_op]
            return f"({self(e.lhs)} {op} {self(e.rhs)})"
        if isinstance(e, (sp.And, sp.Or)):
            return self.logic("and" if isinstance(e, sp.And) else "or", [self(a, True) for a in e.args])
        if isinstance(e, sp.Not):
            return self.logic("not", [self(e.args[0], True)])
        if e is sp.nan:
            return self.num(float("nan"))
        if e.is_Number or isinstance(e, sp.NumberSymbol):
            return self.num(float(e))
        if isinstance(e, sp.Piecewise):
            pairs = list(e.args)
            if pairs[-1].cond is sp.true:
                out = self(pairs.pop().expr)
            else:
                out = self.num(float("nan"))  # no branch holds: JAX's piecewise gives nan
            for pair in reversed(pairs):
                out = self.select(self(pair.cond, True), self(pair.expr), out)
            return out
        if e.is_Add:
            out = ""
            for i, term in enumerate(e.args):
                neg = (term.is_Number and term < 0) or (
                    term.is_Mul and term.args[0].is_Number and term.args[0] < 0
                )
                s = self(-term if neg else term)
                out = (f"-{s}" if neg else s) if i == 0 else f"{out} {'-' if neg else '+'} {s}"
            return f"({out})"
        if e.is_Mul:
            coeff, factors = e.as_coeff_mul()
            num, den = [], []
            for f in factors:
                if f.is_Pow and f.exp.is_Number and f.exp < 0:
                    den.append(f.base ** (-f.exp))
                else:
                    num.append(f)
            parts = [self.num(float(abs(coeff)))] if abs(coeff) != 1 or not num else []
            s = "*".join(parts + [self(f) for f in num])
            if den:
                s += "/" + (self(den[0]) if len(den) == 1 else "(" + "*".join(self(d) for d in den) + ")")
            return f"(-{s})" if coeff < 0 else f"({s})"
        if e.is_Pow:
            base, x = e.base, e.exp
            if x.is_Integer and 0 < abs(int(x)) <= 16:
                prod = "(" + "*".join([self(base)] * abs(int(x))) + ")"
                return prod if x > 0 else f"({self.num(1.0)}/{prod})"
            if x == sp.Rational(1, 2):
                return self.call("sqrt", self(base))
            if x == -sp.Rational(1, 2):
                return f"({self.num(1.0)}/{self.call('sqrt', self(base))})"
            return self.call("pow", self(base), self(x))
        for cls, fn in ((sp.exp, "exp"), (sp.log, "log"), (sp.floor, "floor"), (sp.Abs, "fabs")):
            if isinstance(e, cls):
                return self.call(fn, self(e.args[0]))
        raise ValueError(f"{type(e).__name__} ({e}) is outside the printable gotran subset")


class _TorchPrinter(_Printer):
    def num(self, x: float) -> str:
        if not np.isfinite(x):
            return f"float({str(x)!r})"
        return repr(x) if x >= 0 else f"({x!r})"

    def call(self, fn: str, *args: str) -> str:
        return f"_rt.{'power' if fn == 'pow' else fn}({', '.join(args)})"

    def select(self, cond: str, a: str, b: str) -> str:
        return f"_w({cond}, {a}, {b})"

    def logic(self, op: str, args: list[str]) -> str:
        return f"_rt.l{op}({', '.join(args)})"

    def boolean(self, value: bool) -> str:
        return repr(value)


class _CudaPrinter(_Printer):
    def num(self, x: float) -> str:
        x32 = np.float32(x)  # the twin's float64 constant meets float32 rows rounded so
        if np.isnan(x32):
            return "NAN"
        if np.isinf(x32):
            return "INFINITY" if x32 > 0 else "(-INFINITY)"
        s = f"{float(x32):.9e}F"  # nine digits name every float32 exactly
        return s if x32 >= 0 else f"({s})"

    def call(self, fn: str, *args: str) -> str:
        return f"{fn}f({', '.join(args)})"

    def select(self, cond: str, a: str, b: str) -> str:
        return f"({cond} ? {a} : {b})"

    def logic(self, op: str, args: list[str]) -> str:
        if op == "not":
            return f"(!{args[0]})"
        return "(" + f" {'&&' if op == 'and' else '||'} ".join(args) + ")"

    def boolean(self, value: bool) -> str:
        return "true" if value else "false"


# ----------------------------------------------------------------------
# codegen: the torch module
# ----------------------------------------------------------------------
_HEADER = '''"""Generated from {name}.ode by fenicsx_beat_tpu_torch.odefile.

The gotranx module contract over torch: ``rhs``, ``forward_euler`` and
``generalized_rush_larsen`` take ``(S, n)`` states, a time (a float or a
0-d tensor) and a parameter vector (Python floats) or a node-aligned
``[NP, n]`` field (row tensors).  The plain twin of the model's CUDA
kernels.
"""
import numpy as np

from fenicsx_beat_tpu_torch.models import _gotran as _rt

'''

_INDEX_FNS = '''
def state_index(name: str) -> int:
    return _STATE_NAMES.index(name)


def parameter_index(name: str) -> int:
    return _PARAM_NAMES.index(name)


def init_state_values(**overrides) -> np.ndarray:
    unknown = set(overrides) - set(_STATE_NAMES)
    if unknown:
        raise KeyError(f"Unknown state name(s): {sorted(unknown)}")
    out = _STATE_INIT.copy()
    for k, v in overrides.items():
        out[state_index(k)] = v
    return out


def init_parameter_values(**overrides) -> np.ndarray:
    unknown = set(overrides) - set(_PARAM_NAMES)
    if unknown:
        raise KeyError(f"Unknown parameter name(s): {sorted(unknown)}")
    out = _PARAM_INIT.copy()
    for k, v in overrides.items():
        out[parameter_index(k)] = v
    return out

'''


def _torch_body(low: _Lowered, pr: _TorchPrinter) -> list[str]:
    parsed = low.parsed
    lines = [
        "    _p = _rt.unpack_params(parameters, states, _PARAM_NAMES)",
        "    _w = _rt.where_like(states)",
    ]
    if low.uses_time:
        lines.append("    t = _rt.time_like(t, states)")
    for i, n in enumerate(parsed.state_names):
        lines.append(f"    {n} = states[{i}]")
    for n in parsed.parameter_names:
        if n in low.needed:
            lines.append(f"    {n} = _p[{n!r}]")
    for lhs, expr in low.assignments:
        if lhs in low.needed:
            lines.append(f"    {lhs} = {pr(expr, lhs in low.booleans)}")
    return lines


def generate_code(parsed: ParsedODE, grl_eps: float = 1e-8) -> str:
    """Emit the torch module source for a :class:`ParsedODE`."""
    low = _lower(parsed)
    pr = _TorchPrinter({n: n for n in low.needed} | {"t": "t"}, low.booleans)
    states = parsed.state_names
    out = [_HEADER.format(name=parsed.name)]
    out.append(f"_STATE_NAMES = {tuple(states)!r}")
    out.append(f"_PARAM_NAMES = {tuple(parsed.parameter_names)!r}")
    out.append("_STATE_INIT = np.array([" + ", ".join(repr(v) for _, v in parsed.states) + "])")
    out.append("_PARAM_INIT = np.array([" + ", ".join(repr(v) for _, v in parsed.parameters) + "])")
    out.append(_INDEX_FNS)

    lines = ["def rhs(states, t, parameters):", '    """d(states)/dt, shape (num_states, n)."""']
    lines += _torch_body(low, pr)
    lines.append(f"    return _rt.rows([{', '.join(f'd{s}_dt' for s in states)}], states)")
    out.append("\n".join(lines) + "\n")

    lines = ["def forward_euler(states, t, parameters, dt, **kwargs):"]
    lines.append("    return states + dt * rhs(states, t, parameters)")
    out.append("\n".join(lines) + "\n")

    lines = [
        "def generalized_rush_larsen(states, t, parameters, dt, **kwargs):",
        '    """GRL1: exponential update where the self-derivative of the\n'
        "    stated d<state>_dt (intermediates held fixed) is nonzero,\n"
        '    explicit Euler elsewhere (gotranx convention)."""',
    ]
    lines += _torch_body(low, pr)
    for s in states:
        if low.lin[s] == 0:
            lines.append(f"    _new_{s} = {s} + dt * d{s}_dt")
        else:
            lines.append(f"    _lin_{s} = {pr(low.lin[s])}")
            lines.append(f"    _new_{s} = _rt.grl({s}, d{s}_dt, _lin_{s}, dt, {grl_eps!r}, _w)")
    lines.append(f"    return _rt.rows([{', '.join(f'_new_{s}' for s in states)}], states)")
    out.append("\n".join(lines) + "\n")
    return "\n".join(out)


# ----------------------------------------------------------------------
# codegen: the CUDA node body
# ----------------------------------------------------------------------
def voltage_name(names) -> str | None:
    """The state that holds the membrane voltage: ``V``, else ``v``."""
    return "V" if "V" in names else "v" if "v" in names else None


_CUDA_SIGNATURE = ("template <class Src>\n"
                   "__device__ __forceinline__ void {fn}(float* row, long long ld, int v_row, int swap_row, "
                   "float V, float t,\n    float dt, const Src& prm) {{")


def generate_cuda(parsed: ParsedODE, grl_eps: float = 1e-8) -> str:
    """Emit the CUDA node body of a :class:`ParsedODE` with a voltage state
    (``V`` or ``v``): ``fbt_ode::grl_node`` and ``fbt_ode::fe_node`` step
    one node in place, and ``fbt_ode::node<kScheme>`` picks one of them.

    Row ``k`` of the model is read from and written to storage row ``k``,
    except the voltage's (written to ``v_row``; its value is the injected
    ``V``, never read) and row 0's (at ``swap_row``): B1 passes
    ``v_row = kVRow, swap_row = 0``, B7 on ``make_multi_ode``'s storage
    ``v_row = 0, swap_row = kVRow``.  ``prm(k)`` is parameter ``k``
    (``fbt::ParamSet`` or ``fbt::StridedParams``, ``csrc/common.cuh``)."""
    low = _lower(parsed)
    states = parsed.state_names
    vname = voltage_name(states)
    if vname is None:
        raise ValueError(f"{parsed.name}: no state named V or v, so no kernel can inject the voltage")
    vi = states.index(vname)
    names = {n: f"g_{n}" for n in low.needed} | {"t": "t"}
    pr = _CudaPrinter(names, low.booleans)

    def storage(k: int) -> str:
        return "v_row" if k == vi else "swap_row" if k == 0 else str(k)

    def body(scheme: str) -> list[str]:
        lines = [_CUDA_SIGNATURE.format(fn=f"{scheme}_node")]
        for k, s in enumerate(states):
            lines.append(f"    const float g_{s} = " + ("V;" if k == vi else f"row[{storage(k)} * ld];"))
        for k, n in enumerate(parsed.parameter_names):
            if n in low.needed:
                lines.append(f"    const float g_{n} = prm({k});")
        for lhs, expr in low.assignments:
            if lhs in low.needed:
                b = lhs in low.booleans
                lines.append(f"    const {'bool' if b else 'float'} g_{lhs} = {pr(expr, b)};")
        for k, s in enumerate(states):
            upd = f"g_{s} + dt * g_d{s}_dt"
            if scheme == "grl" and low.lin[s] != 0:
                lines.append(f"    const float lin_{k} = {pr(low.lin[s])};")
                upd = (f"fabsf(lin_{k}) > {pr.num(grl_eps)} ? g_{s} + expm1f(dt * lin_{k}) * g_d{s}_dt / lin_{k}"
                       f" : {upd}")
            lines.append(f"    const float new_{k} = {upd};")
        for k in range(len(states)):
            lines.append(f"    row[{storage(k)} * ld] = new_{k};")
        if not low.uses_time:
            lines.append("    (void)t;")
        lines.append("}")
        return lines

    out = [
        f"// Generated from {parsed.name}.ode by fenicsx_beat_tpu_torch/odefile.py: the node",
        "// updates of its GRL1 and forward-Euler steps, in float32, each operation",
        "// in the order of the torch twin's (the module's generalized_rush_larsen",
        "// and forward_euler).",
        "#pragma once",
        "",
        "namespace fbt_ode {",
        "",
        f"constexpr int kNumStates = {len(states)};",
        f"constexpr int kNumParams = {len(parsed.parameters)};",
        f"constexpr int kVRow = {vi};  // the row of {vname}",
        "constexpr int kGrl = 0, kFe = 1;",
        "",
        *body("grl"),
        "",
        *body("fe"),
        "",
        "template <int kScheme, class Src>",
        "__device__ __forceinline__ void node(float* row, long long ld, int v_row, int swap_row, float V, float t,",
        "    float dt, const Src& prm) {",
        "    if constexpr (kScheme == kGrl) {",
        "        grl_node(row, ld, v_row, swap_row, V, t, dt, prm);",
        "    } else {",
        "        fe_node(row, ld, v_row, swap_row, V, t, dt, prm);",
        "    }",
        "}",
        "",
        "}  // namespace fbt_ode",
        "",
    ]
    return "\n".join(out)


# every module load_ode made, by name and generated source
_LOADED: dict[tuple[str, str], types.ModuleType] = {}


def load_ode(source: str | Path, name: str | None = None, device=None) -> types.ModuleType:
    """Parse and generate, then exec: returns a module object with the
    gotranx contract.  Attached: ``module.code`` (the torch source),
    ``module.cuda_source`` (the node body, None without a voltage state),
    ``num_states`` and ``num_parameters``.  The module's
    ``generalized_rush_larsen`` and ``forward_euler`` are registered with
    :mod:`.ops.cuda_ode` (:func:`~.ops.cuda_ode.ionic_model` finds their
    kernels); the kernels are built by ``nvcc`` at the first step on a
    CUDA tensor, or here when ``device`` names a CUDA device.  A source
    that generates the same module under the same name as an earlier load
    returns that module, its kernels and their launch counts: loading it
    again registers nothing."""
    import torch

    from ._build import load_model_library

    parsed = parse_ode(source, name=name)
    code = generate_code(parsed)
    mod = _LOADED.get((parsed.name, code))
    if mod is None:
        mod = _LOADED[parsed.name, code] = _make_module(parsed, code)
    if mod.cuda_source is not None and device is not None and torch.device(device).type == "cuda":
        load_model_library(mod.cuda_source)
    return mod


def _make_module(parsed: ParsedODE, code: str) -> types.ModuleType:
    from .ops import cuda_ode

    mod = types.ModuleType(parsed.name)
    mod.__dict__["__file__"] = f"<generated from {parsed.name}.ode>"
    exec(compile(code, mod.__file__, "exec"), mod.__dict__)
    mod.code = code
    mod.num_states = len(parsed.states)
    mod.num_parameters = len(parsed.parameters)
    mod.cuda_source = None
    if voltage_name(parsed.state_names) is not None:
        mod.cuda_source = generate_cuda(parsed)
        cuda_ode.register_model(mod, parsed.name)
    return mod
