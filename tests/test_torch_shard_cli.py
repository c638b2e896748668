"""The port's CLIs and scalability sweep over CPU ranks (gloo).

* ``newmark --shard rows`` over 2 and 4 ranks and ``--shard blocks`` over
  4 (2 x 2), --precond mg on tests/test_fast_engine.py's driven and forced
  case: probe.csv, energy.csv and iterations.csv byte-equal to tpuwave's
  ``--shard rows`` run (its 8 virtual devices) and to the port's one-rank
  run, tpuwave's own criterion (tests/test_fast_engine.py:504-529);
* a 2-rank ``--distributed --vtu-pieces 0`` run writes each record's
  pieces from both ranks and rank 0's .pvtu naming both, only rank 0
  prints "Simulation completed", and its checkpoints hold the whole grid
  (the twin of tests/test_multihost.py);
* ``torch_scalability_sweep.py --virtual-devices 2 --devices 1 2
  --device cpu`` writes tpuwave's CSV schema with rows for 1 and 2 ranks,
  and a one-rank count longer than ``--dist-timeout`` leaves its idle
  rank waiting, not failed.
"""

import contextlib
import importlib.util
import io
import json
from pathlib import Path

import numpy as np
import pytest

from tests import torch_threads  # noqa: F401  (one torch thread)
from tests import torch_shard_ranks as ranks

ROOT = Path(__file__).resolve().parent.parent
WORLDS = (2, 4)
SUB = "newmark-case/run-R1-N16x16-dt0_01-T0_05-gamma0_5-beta0_25"
CSVS = ("probe.csv", "energy.csv", "iterations.csv")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Each world's rank-program output (console per rank), its run
    folders under <tmp>/w<n>/, and tpuwave's and the port's one-rank runs
    under <tmp>/tw and <tmp>/one."""
    tmp = tmp_path_factory.mktemp("shard_cli")
    case = ranks.standing_case(**{"Log Every": "1", "T": "0.05"})
    vtu = ranks.standing_case(**{"Nel": "8", "T": "0.03",
                                 "Save Solution": "true"})
    procs = {}
    for n in WORLDS:
        d = tmp / f"w{n}"
        d.mkdir()
        (d / "case.json").write_text(json.dumps(case))
        (d / "vtu.json").write_text(json.dumps(vtu))
        procs[n] = ranks.launch(n, ["cli", d / "out.json"])
    path = tmp / "case.json"
    path.write_text(json.dumps(case))
    from tpuwave.cli import newmark as jcli
    from tpuwave_torch.cli import newmark as tcli
    flags = ["--mesh-root", str(tmp / "mesh"), "--precond", "mg"]
    with contextlib.redirect_stdout(io.StringIO()):
        assert jcli.main([str(path), "--results-root", str(tmp / "tw"),
                          "--shard", "rows", *flags]) == 0
        assert tcli.main([str(path), "--results-root", str(tmp / "one"),
                          "--device", "cpu", *flags]) == 0
    out = {}
    for n, proc in procs.items():
        ranks.finish(proc)
        out[n] = json.loads((tmp / f"w{n}" / "out.json").read_text())
    yield tmp, out
    for p in procs.values():
        if p.poll() is None:
            p.kill()


@pytest.mark.parametrize("n", WORLDS)
def test_cli_shard_csvs_equal_tpuwave_and_one_rank(runs, n):
    tmp, out = runs
    names = ["rows"] + (["blocks"] if n == 4 else [])
    for name in names:
        for r in range(n):
            assert out[n][f"cli {name} rc {r}"] == 0
        assert f"Sharding: {name} over {n} device(s)" in \
            out[n][f"cli {name} out 0"]
        for r in range(1, n):
            assert out[n][f"cli {name} out {r}"] == ""
        for csv in CSVS:
            got = (tmp / f"w{n}" / name / SUB / csv).read_text()
            assert got == (tmp / "tw" / SUB / csv).read_text(), (name, csv)
            assert got == (tmp / "one" / SUB / csv).read_text(), (name, csv)


def test_distributed_vtu_pieces_from_both_ranks(runs):
    tmp, out = runs
    assert out[2]["cli vtu rc 0"] == out[2]["cli vtu rc 1"] == 0
    assert "Simulation completed" in out[2]["cli vtu out 0"]
    assert out[2]["cli vtu out 1"] == ""
    run = next((tmp / "w2" / "vtu").rglob("solution_0000.pvtu")).parent
    records = sorted(run.glob("solution_*.pvtu"))
    assert len(records) == 4
    for rec in records:
        text = rec.read_text()
        stem = rec.name[:-len(".pvtu")]
        for pid in (0, 1):
            assert f'Source="{stem}.{pid}.vtu"' in text
            assert (run / f"{stem}.{pid}.vtu").exists()
    ckpt = sorted(run.glob("checkpoint_*.npz"))[-1]
    with np.load(ckpt) as data:
        assert data["u"].shape == (9 * 9,)
        assert int(data["__timestep"]) == 2


def _sweep_main(tmp_path, argv):
    spec = importlib.util.spec_from_file_location(
        "torch_scalability_sweep",
        ROOT / "scripts" / "torch_scalability_sweep.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    with contextlib.chdir(tmp_path):
        return mod.main(argv)


def test_scalability_sweep_virtual_devices(tmp_path, capsys):
    rc = _sweep_main(tmp_path, [
        "--virtual-devices", "2", "--devices", "1", "2", "--device", "cpu",
        "--nel", "8", "--dt", "0.01", "--T", "0.02", "--repeats", "1",
        "--dtype", "f64", "--schemes", "theta-0.5", "newmark-0.00"])
    assert rc == 0
    rows = (tmp_path / "scalability-results-2.csv").read_text().splitlines()
    assert rows[0] == ("scheme,binary,nprocs,repeat,Nel,R,Dt,T,Theta,Beta,"
                       "Gamma,returncode,seconds")
    got = [r.split(",")[:3] for r in rows[1:]]
    assert got == [[s, "tpuwave_torch-fast", p] for p in ("1", "2")
                   for s in ("theta-0.5", "newmark-0.00")]


def test_scalability_idle_rank_outlasts_the_timeout(tmp_path, capsys):
    """A device count that leaves a rank out runs longer than the process
    group's timeout (1 s here): the idle rank waits it out."""
    timeout = 1.0
    rc = _sweep_main(tmp_path, [
        "--virtual-devices", "2", "--devices", "1", "--device", "cpu",
        "--dist-timeout", str(timeout), "--nel", "64", "--dt", "0.0005",
        "--T", "0.2", "--repeats", "2", "--dtype", "f64",
        "--schemes", "theta-1.0"])
    assert rc == 0
    rows = (tmp_path / "scalability-results-1.csv").read_text().splitlines()
    assert [r.split(",")[2] for r in rows[1:]] == ["1", "1"]
    # the timed repeats alone (the warm run comes on top) outlast it
    assert sum(float(r.split(",")[-1]) for r in rows[1:]) > timeout
