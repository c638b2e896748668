"""The port's R = 2 theta engine and CLI with a time-dependent wave speed
against tpuwave's, on the CPU in f64, on one tpuwave engine (one XLA
compile; see test_torch_p2_varcoef_engine.py for the cases and
tolerances): theta 1/2, ``--precond chebyshev``, c^2 = 1 + 0.5 sin 2t,
Nel (6, 5), 3 steps.

* the engines step for step, and theta's carried K(t^n) scale planes;
* a tpuwave state after one step, carried across by
  ``models/convert.to_torch``, steps on in the port as in tpuwave;
* both CLIs on the same file (tpuwave's CLI runs that engine): equal
  CSVs, and the u, v, u_exact, points and cells of every VTU piece within
  1e-12 (tpuwave writes raw appended data where its native library is
  built, base64 otherwise; the port writes base64).
"""

import base64
import re

import numpy as np
import pytest
import torch

from tests import torch_threads  # noqa: F401  (one torch thread)
from tests.test_torch_p2_cli import check_cli_against_tpuwave
from tests.test_torch_p2_engine import CPU, _close, _run_both
from tests.test_torch_p2_varcoef_engine import PRESET, case_over, make_pair
from tpuwave_torch.models import convert

@pytest.fixture(scope="module")
def pair():
    """tpuwave's and the port's theta / time-dependent c / chebyshev
    engines (and their case), built once for the tests that step them."""
    return make_pair("tdep", "theta", "chebyshev")


def test_p2_theta_tdep_chebyshev_matches_tpuwave(pair):
    js, ts, case = pair
    assert ts._c_mode == js._c_mode == "tdep"
    sj, st, _ = _run_both(js, ts, case, 3)
    _close(st.k_payload.numpy(), np.asarray(sj.k_payload), rtol=1e-13)


def test_p2_tdep_state_hands_over_from_tpuwave(pair):
    """A tpuwave theta state after one step (u, v and the K(t^1) scale
    planes), carried across by convert.to_torch, steps on in the port as
    it does in tpuwave; the port rebuilds K(t^1) from the payload."""
    js, ts, case = pair
    dt = float(case["Dt"])
    sj, _ = js.step(js.initial_state(), dt)
    st = convert.to_torch(sj, CPU, torch.float64, canvas=ts._cshape)
    assert st.k_payload.shape == tuple(sj.k_payload.shape)
    t = dt
    for _ in range(2):
        t += dt
        sj, ij = js.step(sj, t)
        st, it = ts.step(st, t)
        assert it["iterations_1"] == int(ij["iterations_1"])
        assert it["iterations_2"] == int(ij["iterations_2"])
        for name in ("u", "v"):
            _close(ts.to_flat(getattr(st, name)).numpy(),
                   js.to_flat(getattr(sj, name)))
    _close(st.k_payload.numpy(), np.asarray(sj.k_payload), rtol=1e-13)


_VTK_DTYPES = {"Float64": "<f8", "Float32": "<f4", "Int32": "<i4",
               "Int64": "<i8", "UInt8": "u1"}


def read_vtu(path):
    """{name: array} of a .vtu piece, from either encoding: inline base64
    ("binary", UInt32 block headers) or raw appended data (UInt64
    headers)."""
    raw = path.read_bytes()
    cut = raw.find(b"<AppendedData")
    head = raw[:cut if cut >= 0 else len(raw)].decode("ascii")
    out = {}
    if cut >= 0:
        data = raw[raw.index(b"_", cut) + 1:]
        for tag in re.finditer(r"<DataArray ([^>]*)/>", head):
            a = dict(re.findall(r'(\w+)="([^"]*)"', tag.group(1)))
            off = int(a["offset"])
            n = int(np.frombuffer(data[off:off + 8], "<u8")[0])
            out[a["Name"]] = np.frombuffer(data[off + 8:off + 8 + n],
                                           _VTK_DTYPES[a["type"]])
        return out
    for tag in re.finditer(r"<DataArray ([^>]*)>\s*([A-Za-z0-9+/=]*)\s*"
                           r"</DataArray>", head):
        a = dict(re.findall(r'(\w+)="([^"]*)"', tag.group(1)))
        blob = base64.b64decode(tag.group(2))
        n = int(np.frombuffer(blob[:4], "<u4")[0])
        out[a["Name"]] = np.frombuffer(blob[4:4 + n],
                                       _VTK_DTYPES[a["type"]])
    return out


def test_p2_cli_tdep_theta_matches_tpuwave(tmp_path, capsys, pair):
    js = pair[0]
    check_cli_against_tpuwave(tmp_path, capsys, "theta", PRESET,
                              ("--precond", "chebyshev"),
                              case_over("tdep"), engine=js)
    rj, rt = tmp_path / "jax" / "res", tmp_path / "torch" / "res"
    pieces = sorted(p.relative_to(rj) for p in rj.rglob("*.vtu"))
    assert len(pieces) == 4       # t = 0 and the 3 steps
    for rel in pieces:
        vj, vt = read_vtu(rj / rel), read_vtu(rt / rel)
        for name in ("u", "v", "u_exact", "Points", "connectivity"):
            want = vj[name].astype(np.float64)
            got = vt[name].astype(np.float64)
            assert got.shape == want.shape, (rel, name)
            err = np.abs(got - want).max()
            assert err <= 1e-12 * max(1.0, np.abs(want).max()), \
                (rel, name, err)
