"""On the card (`-m card`; each test skips without one): every cell runs
correct through the command, and at the cell's own size the control (the
reference in TF32 arithmetic in the program's place) fails its numbers
where the program's pass. Run from the repository's root:

    python -m pytest portbench/tests -m card
"""

import json
import os
import subprocess
import sys

import pytest

from portbench import calibrate, harness

CELLS = [w["name"] for w in harness.benchmark_spec()["workloads"]]
REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


@pytest.mark.card
@pytest.mark.parametrize("name", CELLS)
def test_cell_runs_correct(name, need_card):
    proc = subprocess.run([sys.executable, "-m", "portbench", "--workload", name,
                           "--seed", "3000000001", "--seconds", "2", "--trace", "0"],
                          cwd=REPO, capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert json.loads(proc.stdout.strip().splitlines()[-1])["correct"], proc.stderr[-2000:]


@pytest.mark.card
@pytest.mark.parametrize("name", CELLS)
def test_control_fails_at_the_cells_size(name, need_card):
    cell = harness.Cell(harness.benchmark_spec(), name)
    row = calibrate.readings(cell, 3000000002, 1.0, True, need_card)
    assert all(row["program"][k] <= v for k, v in cell.limits.items()), row
    assert any(row["control"][k] > v for k, v in cell.limits.items()), row
