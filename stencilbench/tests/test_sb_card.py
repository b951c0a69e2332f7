"""On the card only (``-m card``): a short run of each cell at its size is
correct, and its control, one precision below the cell's state, is not."""

import json
import os
import subprocess
import sys

import pytest

from stencilbench import cells, control, harness

REPO = os.path.dirname(cells.ROOT)
NAMES = [w["name"] for w in cells.benchmark(cells.ROOT)["workloads"]]


def enough_cards(name):
    """The cell; skips the test where the machine has fewer cards than the
    cell asks for."""
    import torch

    cell = cells.load_cell(name)
    if torch.cuda.device_count() < cell.chips:
        pytest.skip(f"{name} needs {cell.chips} CUDA cards")
    return cell


@pytest.mark.card
@pytest.mark.parametrize("name", NAMES)
def test_a_short_run_is_correct(card, name):
    enough_cards(name)
    proc = subprocess.run(
        [sys.executable, "-m", "stencilbench.run", "--workload", name,
         "--seed", str(2**31 + 11), "--seconds", "2", "--trace", "1"],
        cwd=REPO, capture_output=True, text=True, timeout=1200)
    assert proc.returncode == 0, proc.stderr[-3000:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result["correct"] is True
    assert 0 < result["device"]["busy_s"] <= result["device"]["window_s"]
    assert result["metrics"]
    pct = result["metrics"].get("kernel_roofline_pct", {"value": 0})
    assert pct["value"] <= 100


@pytest.mark.card
@pytest.mark.parametrize("name", NAMES)
def test_the_control_fails_at_the_cells_size(card, name):
    cell = enough_cards(name)
    [(_, err, _)] = control.readings(cell, [2**31 + 12], card, control=True)
    assert err > cell.limits[harness.CHECKED]
