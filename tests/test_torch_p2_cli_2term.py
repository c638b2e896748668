"""The port's ``newmark --solver 2term --precond mg`` CLI at R = 2 against
tpuwave's, on the CPU in f64: a driven preset (oscillating boundary) at
Nel 8, 10 steps, Log Every 1 (the velocity is reconstructed at every log
point), with the checks of test_torch_p2_cli.py.
"""

from tests import torch_threads  # noqa: F401  (one torch thread)
from tests.test_torch_p2_cli import check_cli_against_tpuwave


def test_cli_r2_2term_reproduces_tpuwave(tmp_path, capsys):
    check_cli_against_tpuwave(tmp_path, capsys, "newmark",
                              "oscillating-boundary",
                              ("--solver", "2term", "--precond", "mg"), {})
