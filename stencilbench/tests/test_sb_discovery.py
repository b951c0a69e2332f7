"""Cells, mixes, loops and metrics are found by name, in files of their own;
a cell added as files runs without an edit."""

import json
import os

import pytest

from stencilbench import cells, harness
from stencilbench.conftest import copy_bench, DEFERRED, SHARDED, SMALL

BENCH = cells.benchmark(cells.ROOT)


ENTRIES = {w["name"]: w for w in BENCH["workloads"] + DEFERRED["workloads"]}


@pytest.mark.parametrize("name", list(ENTRIES))
def test_every_cell_loads(tmp_path, name):
    cell = cells.load_cell(name, copy_bench(str(tmp_path)))
    assert cell.chips == ENTRIES[name]["chips"] in (1, 4)
    assert os.path.isfile(cell.stc_path)
    assert hasattr(cell.driver(), "run")
    assert cell.limits[harness.CHECKED] > 0
    e2e = [m[0] for m in cell.metrics(trace=False)]
    # set-up time and one more metric a user sees
    assert "setup_s" in e2e and len(e2e) >= 2
    # each per-layer metric moves an end-to-end metric the cell reports
    per_layer = {m["name"]: m for m in BENCH["per_layer"]
                 + DEFERRED["per_layer"]}
    layer = [m[0] for m in cell.metrics(trace=True)]
    assert layer and all(per_layer[n]["moves"] in e2e for n in layer)


def test_every_metric_has_a_reader():
    for m in (BENCH["end_to_end"] + BENCH["per_layer"]
              + DEFERRED["end_to_end"] + DEFERRED["per_layer"]):
        assert callable(cells.load_module(cells.ROOT, "metrics",
                                          m["name"]).read)


def test_metrics_follow_their_workloads_key(tmp_path):
    """A cell reports each metric whose ``workloads`` names it, or that has
    no such key: the per-layer lists as BENCHMARK.json and the deferred
    entries give them."""
    root = copy_bench(str(tmp_path))
    with open(os.path.join(os.path.dirname(root), "BENCHMARK.json")) as f:
        per_layer = json.load(f)["per_layer"]

    def names(cell, trace):
        return {m[0] for m in cells.load_cell(cell, root).metrics(trace)}

    def listed(cell):
        return {m["name"] for m in per_layer
                if cell in m.get("workloads", [cell])}

    for cell in ENTRIES:
        assert names(cell, True) == listed(cell)
    assert names("2d25pt_box.return48", True) == {"readback_ms"}
    solve = {"kernel_roofline_pct", "kernel_ms_per_step", "device_idle_pct"}
    assert solve < names("2d25pt_box.solve48", True) == names(
        "3d7pt_star.solve48", True)
    assert names(SHARDED, True) == solve | {"exchange_ms"}
    assert names("2d25pt_box.return48", False) == {"solve_p95_ms",
                                                   "setup_s"}
    for cell in ("3d7pt_star.solve48", SHARDED):
        assert names(cell, False) == {"gstencil_s", "setup_s"}


def test_names_are_refused_outside_the_folder():
    for bad in ("../BENCHMARK", "a/b", ""):
        with pytest.raises(ValueError):
            cells.load_json(cells.ROOT, "traffic", bad)
    with pytest.raises(ValueError, match="no cell named"):
        cells.load_cell("2d25pt_box.nothing")


def test_cell_takes_config_and_traffic_from_benchmark(tmp_path):
    root = copy_bench(str(tmp_path))
    bench_path = os.path.join(os.path.dirname(root), "BENCHMARK.json")
    with open(bench_path) as f:
        bench = json.load(f)
    entry = next(w for w in bench["workloads"]
                 if w["name"] == "2d25pt_box.solve48")
    entry["config"], entry["traffic"] = "3d7pt_star", "return48"
    with open(bench_path, "w") as f:
        json.dump(bench, f)
    cell = cells.load_cell("2d25pt_box.solve48", root)
    assert cell.config["stencil"] == "3d7pt_star"
    assert cell.traffic["readback"] is True
    with open(os.path.join(root, "workloads",
                           "2d25pt_box.solve48.json")) as f:
        assert set(json.load(f)) == {"limits"}


def test_a_cell_added_as_files_is_found_and_runs(tmp_path):
    """A new mix, loop, metric and cell, added as files and entries in a
    copy, run on the CPU with no other file changed."""
    root = copy_bench(str(tmp_path), SMALL)
    with open(os.path.join(root, "traffic", "solve12.json"), "w") as f:
        json.dump({"driver": "twice", "timesteps": 12, "readback": True,
                   "trace_requests": 4, "check_samples": 1,
                   "sample_from": 2}, f)
    with open(os.path.join(root, "drivers", "twice.py"), "w") as f:
        f.write("from stencilbench.harness import Window\n"
                "def run(bench, mix, seconds=None, requests=None, first=0,"
                " span=None):\n"
                "    n = 2 if requests is None else requests\n"
                "    for i in range(n):\n"
                "        bench.reset(); bench.solve()\n"
                "        bench.answered(first + i, bench.readback())\n"
                "    return Window(requests=n, wall_s=1.0, latencies=[])\n")
    with open(os.path.join(root, "metrics", "requests_done.py"), "w") as f:
        f.write("def read(ctx):\n    return float(ctx.window.requests)\n")
    with open(os.path.join(root, "workloads", "3d7pt_star.solve12.json"),
              "w") as f:
        json.dump({"limits": {harness.CHECKED: 1e-4}}, f)
    bench_path = os.path.join(os.path.dirname(root), "BENCHMARK.json")
    with open(bench_path) as f:
        bench = json.load(f)
    bench["workloads"].append({"name": "3d7pt_star.solve12",
                               "config": "3d7pt_star", "traffic": "solve12",
                               "chips": 1, "why": "a test's cell"})
    for metric in bench["end_to_end"]:
        if metric["name"] == "gstencil_s":
            metric["workloads"].append("3d7pt_star.solve12")
    bench["end_to_end"].append({"name": "requests_done", "unit": "1",
                                "better": "higher", "bound": 0.01,
                                "source": "host_clock",
                                "workloads": ["3d7pt_star.solve12"]})
    with open(bench_path, "w") as f:
        json.dump(bench, f)
    cell = cells.load_cell("3d7pt_star.solve12", root)
    result, lines, _ = harness.run_cell(cell, 7, 0.0, False, "cpu", 0.0)
    assert result["correct"] is True
    assert result["metrics"]["requests_done"]["value"] == 2.0
    assert result["metrics"]["gstencil_s"]["value"] > 0
    assert "solve_p95_ms" not in result["metrics"]
