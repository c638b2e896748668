"""Parameter-file handling: the ParameterReader equivalent.

Reads the same JSON schema as the reference (documented in its
README.md:133-155 and declared in src/ParameterReader.cpp:39-126), with the
same keys, defaults, and validation:

    Nel          "40" or "40, 50"     (elements per direction)
    Geometry     "[x0, x1] x [y0, y1]"
    R            polynomial degree (1 or 2)
    T, Dt        time interval / step
    Theta        theta-method parameter in [0, 1]
    Beta, Gamma  Newmark parameters in [0, 1]
    Save Solution / Enable Logging / Log Every / Print Every
    C, F, U0, V0, G, DGDT, Solution   function subsections with
        "Function constants" / "Function expression" / "Variable names"

``Solution`` is optional (errors are only tracked when present,
ParameterReader.cpp:153-158); every other function must be given. A minimal
deal.II ``.prm`` reader is provided as well since the reference's
ParameterHandler accepts both formats.
"""

from __future__ import annotations

import json
import re
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, Optional, Tuple

from tpuwave_torch.utils.expr import Expression, parse_constants_with_pi

__all__ = ["Params", "load_params", "ParamError"]


class ParamError(ValueError):
    pass


#: declared defaults (reference ParameterReader.cpp:39-105)
_DEFAULTS = {
    "Nel": "40",
    "Geometry": "[0.0, 1.0] x [0.0, 1.0]",
    "R": "1",
    "T": "1.0",
    "Theta": "0.5",
    "Beta": "0.25",
    "Gamma": "0.5",
    "Dt": "0.01",
    "Save Solution": "true",
    "Enable Logging": "true",
    "Log Every": "10",
    "Print Every": "10",
    # tpuwave extension (no reference counterpart): re-evaluate the wave
    # speed c(x, y, t) at the current time each step instead of freezing
    # it at t = 0 (the reference's FunctionParser default-time behaviour)
    "Time Dependent C": "false",
}

_FUNCTION_NAMES = ("C", "F", "U0", "V0", "G", "DGDT", "Solution")

_GEOM_RE = re.compile(
    r"\[\s*([-\d\.]+)\s*,\s*([-\d\.]+)\s*\]\s*x\s*\[\s*([-\d\.]+)\s*,\s*([-\d\.]+)\s*\]"
)


def _parse_bool(v) -> bool:
    if isinstance(v, bool):
        return v
    s = str(v).strip().lower()
    if s in ("true", "1", "yes"):
        return True
    if s in ("false", "0", "no"):
        return False
    raise ParamError(f"Invalid boolean value {v!r}")


@dataclass(frozen=True)
class Params:
    """Fully-parsed problem configuration (immutable)."""

    nel: Tuple[int, int]
    geometry: Tuple[Tuple[float, float], Tuple[float, float]]  # (p_min, p_max)
    r: int
    t_final: float
    theta: float
    beta: float
    gamma: float
    dt: float
    save_solution: bool
    enable_logging: bool
    log_every: int
    print_every: int
    c: Expression
    f: Expression
    u0: Expression
    v0: Expression
    g: Expression
    dgdt: Expression
    solution: Optional[Expression]
    source_path: Optional[str] = None
    #: resolved path of an explicitly-requested mesh file, or None. The
    #: reference declares "Mesh File Name" (ParameterReader.cpp:51-54) but
    #: never reads it back; tpuwave makes the parameter live as an opt-in:
    #: only a key PRESENT in the input activates the unstructured-import
    #: path (the declared default would point every run at a nonexistent
    #: ../mesh/mesh-square-40.msh).
    mesh_file: Optional[str] = None
    #: the import at ``mesh_file`` is the ``nel`` x ``geometry`` rectangle
    #: triangulation (models/general.py::recognised_rectangle sets it with
    #: those two); the structured engines run such Params
    mesh_recognised: bool = False
    #: tpuwave extension: re-evaluate c(x, y, t) each step (see _DEFAULTS)
    time_dependent_c: bool = False
    raw: Dict = field(default_factory=dict, hash=False, compare=False)

    @property
    def has_exact_solution(self) -> bool:
        return self.solution is not None

    @property
    def effective_log_every(self) -> int:
        """Enable Logging=false is equivalent to Log Every=0
        (reference ParameterReader.cpp:91-94 description + main usage)."""
        return self.log_every if self.enable_logging else 0


def _parse_geometry(s: str):
    m = _GEOM_RE.fullmatch(s.strip())
    if not m:
        raise ParamError(f"Invalid Geometry format in parameters: {s!r}")
    x_min, x_max, y_min, y_max = (float(m.group(i)) for i in range(1, 5))
    return ((x_min, y_min), (x_max, y_max))


def _parse_nel(s) -> Tuple[int, int]:
    tokens = [t for t in str(s).strip().split(",") if t.strip()]
    if len(tokens) == 1:
        n = int(tokens[0])
        nel = (n, n)
    elif len(tokens) == 2:
        nel = (int(tokens[0]), int(tokens[1]))
    else:
        raise ParamError(f"Invalid Nel format: {s!r}")
    if nel[0] < 1 or nel[1] < 1:
        raise ParamError(f"Nel must be >= 1, got {nel}")
    return nel


def _parse_function(sub: Dict, name: str) -> Optional[Expression]:
    expr = str(sub.get("Function expression", "")).strip()
    if not expr:
        if name == "Solution":
            return None
        raise ParamError(
            f"Function expression for '{name}' must be specified in the parameter file.")
    constants = parse_constants_with_pi(str(sub.get("Function constants", "")))
    var_names = str(sub.get("Variable names", "x, y, t"))
    return Expression(expr, constants, var_names)


def _range_check(name: str, val: float, lo: float, hi: Optional[float] = None):
    if val < lo or (hi is not None and val > hi):
        rng = f"[{lo}, {hi}]" if hi is not None else f">= {lo}"
        raise ParamError(f"Parameter {name}={val} out of range {rng}")


def _parse_prm(text: str) -> Dict:
    """Minimal deal.II .prm reader: 'set Key = value', 'subsection Name'/'end'."""
    data: Dict = {}
    stack = [data]
    for raw_line in text.splitlines():
        line = raw_line.split("#", 1)[0].strip()
        if not line:
            continue
        low = line.lower()
        if low.startswith("subsection "):
            name = line[len("subsection "):].strip()
            sub: Dict = {}
            stack[-1][name] = sub
            stack.append(sub)
        elif low == "end":
            if len(stack) == 1:
                raise ParamError("Unbalanced 'end' in .prm file")
            stack.pop()
        elif low.startswith("set "):
            body = line[4:]
            if "=" not in body:
                raise ParamError(f"Malformed .prm line: {raw_line!r}")
            key, val = body.split("=", 1)
            stack[-1][key.strip()] = val.strip()
        else:
            raise ParamError(f"Unrecognised .prm line: {raw_line!r}")
    return data


def load_params(path_or_dict, *, overrides: Optional[Dict] = None) -> Params:
    """Load a parameter file (JSON or PRM) or an in-memory dict.

    ``overrides`` merges on top of the file contents (used by the sweep
    harness to rewrite Nel/Dt/... without temp files).
    """
    source_path = None
    if isinstance(path_or_dict, (str, Path)):
        source_path = str(path_or_dict)
        text = Path(path_or_dict).read_text()
        if str(path_or_dict).endswith(".prm"):
            data = _parse_prm(text)
        else:
            try:
                data = json.loads(text)
            except json.JSONDecodeError as e:
                raise ParamError(f"Could not parse parameter file {path_or_dict}: {e}")
    else:
        data = dict(path_or_dict)

    if overrides:
        data = {**data, **overrides}

    def get(key):
        return data.get(key, _DEFAULTS[key])

    nel = _parse_nel(get("Nel"))
    geometry = _parse_geometry(str(get("Geometry")))
    r = int(get("R"))
    if r < 1:
        raise ParamError("R must be >= 1")
    if r > 2:
        raise ParamError("Only P1 and P2 simplex elements are supported (R in {1, 2})")
    t_final = float(get("T"))
    theta = float(get("Theta"))
    beta = float(get("Beta"))
    gamma = float(get("Gamma"))
    dt = float(get("Dt"))
    _range_check("T", t_final, 0.0)
    _range_check("Theta", theta, 0.0, 1.0)
    _range_check("Beta", beta, 0.0, 1.0)
    _range_check("Gamma", gamma, 0.0, 1.0)
    _range_check("Dt", dt, 0.0)

    mesh_file = None
    raw_mesh = data.get("Mesh File Name")
    if raw_mesh is not None and str(raw_mesh).strip():
        mesh_file = _resolve_mesh_file(str(raw_mesh).strip(), source_path)

    funcs = {}
    for name in _FUNCTION_NAMES:
        sub = data.get(name)
        if sub is None:
            if name == "Solution":
                funcs[name] = None
                continue
            raise ParamError(f"Missing function subsection '{name}' in parameter file.")
        funcs[name] = _parse_function(sub, name)

    return Params(
        nel=nel,
        geometry=geometry,
        r=r,
        t_final=t_final,
        theta=theta,
        beta=beta,
        gamma=gamma,
        dt=dt,
        save_solution=_parse_bool(get("Save Solution")),
        enable_logging=_parse_bool(get("Enable Logging")),
        log_every=int(get("Log Every")),
        print_every=max(1, int(get("Print Every"))),
        c=funcs["C"],
        f=funcs["F"],
        u0=funcs["U0"],
        v0=funcs["V0"],
        g=funcs["G"],
        dgdt=funcs["DGDT"],
        solution=funcs["Solution"],
        source_path=source_path,
        mesh_file=mesh_file,
        time_dependent_c=_parse_bool(get("Time Dependent C")),
        raw=data,
    )


def _resolve_mesh_file(name: str, source_path: Optional[str]) -> str:
    """Resolve a mesh path: as given (cwd-relative), then relative to the
    parameter file's directory. Missing files fail at load time so the CLI
    can report a friendly error (like the reference's parameter errors)."""
    p = Path(name)
    if p.exists():
        return str(p.resolve())     # absolute: survives later cwd changes
    if source_path is not None:
        q = Path(source_path).resolve().parent / name
        if q.exists():
            return str(q)
    raise ParamError(f"Mesh File Name points at a missing file: {name!r}")
