"""Host layer of the port (tpuwave_torch.utils / core / config) against
tpuwave's: parameter files, expressions, naming, and the import boundary.

Expression values are compared in f64 at rtol 1e-14 with an absolute
floor of 1e-14 x the field's max: the presets' tanh differences cancel to
~1e-16 of the field's scale, and XLA flushes subnormals to zero where
torch keeps them.
"""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests import torch_threads  # noqa: F401  (one torch thread)
from tpuwave.utils import params as jparams
from tpuwave_torch import config as tconfig
from tpuwave_torch.utils import params as tparams
from tpuwave_torch.utils.expr import Expression, ExprError

ROOT = Path(__file__).resolve().parent.parent
PRESETS = sorted(p.name for p in (ROOT / "parameters").glob("*.json"))
_SCALARS = ("nel", "geometry", "r", "t_final", "theta", "beta", "gamma",
            "dt", "save_solution", "enable_logging", "log_every",
            "print_every", "source_path", "mesh_file", "time_dependent_c",
            "raw", "has_exact_solution", "effective_log_every")
_EXPRS = ("c", "f", "u0", "v0", "g", "dgdt", "solution")


@pytest.mark.parametrize("preset", PRESETS)
def test_params_field_by_field(preset):
    path = str(ROOT / "parameters" / preset)
    pj, pt = jparams.load_params(path), tparams.load_params(path)
    for name in _SCALARS:
        assert getattr(pj, name) == getattr(pt, name), name
    for name in _EXPRS:
        ej, et = getattr(pj, name), getattr(pt, name)
        if ej is None:
            assert et is None, name
            continue
        for attr in ("expression", "variable_names", "constants", "ast",
                     "constant_value", "is_zero", "time_dependent",
                     "used_variables"):
            assert getattr(ej, attr) == getattr(et, attr), (name, attr)


@pytest.mark.parametrize("preset", PRESETS)
def test_expression_values_on_grid(preset):
    path = str(ROOT / "parameters" / preset)
    pj, pt = jparams.load_params(path), tparams.load_params(path)
    xs, ys = np.meshgrid(np.linspace(0.0, 1.0, 29),
                         np.linspace(-0.2, 1.1, 33))
    for name in _EXPRS:
        ej, et = getattr(pj, name), getattr(pt, name)
        if ej is None:
            continue
        for t in (0.0, 0.013, 0.37, 1.0):
            want = np.asarray(ej.evaluate(jnp.asarray(xs), jnp.asarray(ys),
                                          t))
            got = et.evaluate(torch.tensor(xs), torch.tensor(ys), t)
            assert got.dtype == torch.float64 and got.shape == xs.shape
            np.testing.assert_allclose(
                got.numpy(), want, rtol=1e-14,
                atol=1e-14 * float(np.abs(want).max()), err_msg=name)


def test_expression_float32_and_tensor_time():
    e = Expression("if(t<=TT && x<0.5, sin(k*t)*y^2, -cos(2*x))",
                   {"TT": 0.5, "k": 4.0})
    x = torch.linspace(0.0, 1.0, 7, dtype=torch.float32)
    y = torch.full((7,), 2.0, dtype=torch.float32)
    for t in (0.25, torch.tensor(0.25, dtype=torch.float32)):
        out = e.evaluate(x, y, t)
        assert out.dtype == torch.float32
        want = np.where(x.numpy() < 0.5, np.sin(1.0) * 4.0,
                        -np.cos(2 * x.numpy()))
        np.testing.assert_allclose(out.numpy(), want, rtol=1e-6)
    # pure-number subexpressions fold on the host
    assert Expression("sqrt(2)*pi").constant_value == pytest.approx(
        np.sqrt(2) * np.pi, rel=1e-15)
    with pytest.raises(ExprError):
        Expression("foo(x)")


def test_resolve_device_never_falls_back():
    assert tconfig.resolve_device("cpu") == torch.device("cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            tconfig.resolve_device("cuda")
    with pytest.raises(ValueError):
        tconfig.resolve_device("meta")


@pytest.mark.parametrize("name,default,want", [
    ("1", False, True), ("False", True, False), ("yes", True, True),
    (None, False, False)])
def test_env_flag_matches_tpuwave(monkeypatch, name, default, want):
    from tpuwave.config import env_flag_enabled as jflag
    if name is None:
        monkeypatch.delenv("TPUWAVE_TORCH_TEST_FLAG", raising=False)
    else:
        monkeypatch.setenv("TPUWAVE_TORCH_TEST_FLAG", name)
    got = tconfig.env_flag_enabled("TPUWAVE_TORCH_TEST_FLAG", default)
    assert got == jflag("TPUWAVE_TORCH_TEST_FLAG", default) == want


def test_naming_matches_tpuwave():
    from tpuwave.utils import naming as jn
    from tpuwave_torch.utils import naming as tn
    for x in (0.0, 0.5, 8e-5, 0.015625, 12.0):
        assert jn.clean_double(x) == tn.clean_double(x)
    args = ("res", "theta-x", 1, (640, 640), 8e-5, 0.05, "-theta0_5")
    assert jn.run_folder_name(*args) == tn.run_folder_name(*args)
    g = ((0.0, 0.0), (3.0, 1.0))
    assert jn.mesh_file_name("m", (180, 60), g) == \
        tn.mesh_file_name("m", (180, 60), g)

