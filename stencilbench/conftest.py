"""Test settings of the benchmark: the ``card`` marker, the fixture that
skips a card test where there is no CUDA card, and a small copy of the
benchmark for the CPU tests, which also holds the deferred cell: the
return cell."""

import json
import os
import re
import shutil

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
SHARDED = "3d7pt_star-3072x2048x2048.solve48"
# grids small enough for the port's plain CPU path; the four-card grid in
# four blocks of 32 planes, so that its crops are cut inside the grid
SMALL = {"2d25pt_box": [96, 80], "3d7pt_star": [28, 24, 20],
         "3d7pt_star-3072x2048x2048": [128, 24, 20],
         "2d25pt_box-bf16": [96, 80], "3d7pt_star-bf16": [28, 24, 20]}
# The return cell's entries: its files (the ``return48`` mix, its limits,
# the ``solve_p95_ms`` and ``readback_ms`` readers) are in the folder, and
# the tests drive it in a copy; BENCHMARK.json leaves it out until its p95
# is steady enough for a bound.
DEFERRED = {
    "workloads": [{"name": "2d25pt_box.return48", "config": "2d25pt_box",
                   "traffic": "return48", "chips": 1,
                   "why": "each result read back through final_a"}],
    "end_to_end": [{"name": "solve_p95_ms", "unit": "ms", "better": "lower",
                    "bound": 0.25, "source": "host_clock",
                    "workloads": ["2d25pt_box.return48"]}],
    "per_layer": [{"name": "readback_ms", "unit": "ms", "better": "lower",
                   "source": "host_clock",
                   "layer": "runner (ops/runner.final_a)",
                   "moves": "solve_p95_ms",
                   "workloads": ["2d25pt_box.return48"]}],
}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; run on a machine with one "
        "(python3 -m pytest stencilbench/tests -m card)")


@pytest.fixture
def card():
    """The CUDA device; skips the test where there is none."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"


def copy_bench(dest, dims=None):
    """A copy of ``BENCHMARK.json``, with the ``DEFERRED`` entries added,
    and of the benchmark's folder under ``dest``, each configuration's grid
    set to ``dims[config]``; returns the copy's folder."""
    root = os.path.join(dest, "stencilbench")
    shutil.copytree(HERE, root, ignore=shutil.ignore_patterns(
        "__pycache__", "tests"))
    with open(os.path.join(os.path.dirname(HERE), "BENCHMARK.json")) as f:
        bench = json.load(f)
    for key, entries in DEFERRED.items():
        bench[key] += entries
    with open(os.path.join(dest, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    for name, shape in (dims or {}).items():
        path = os.path.join(root, "configs", name + ".json")
        with open(path) as f:
            conf = json.load(f)
        conf["dims"] = shape
        with open(path, "w") as f:
            json.dump(conf, f)
        stc = os.path.join(root, "configs", conf["stc"])
        with open(stc) as f:
            text = f.read()
        keys = ("L", "M", "N")[3 - len(shape):]
        for key, size in zip(keys, shape):
            text = re.sub(rf"^{key} \d+", f"{key} {size}", text, flags=re.M)
        with open(stc, "w") as f:
            f.write(text)
    return root


@pytest.fixture
def small_root(tmp_path):
    """A copy of the benchmark at grids the CPU tests can hold."""
    return copy_bench(str(tmp_path), SMALL)
