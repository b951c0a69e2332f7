"""The run's last lines: the result's keys in order, the checks on standard
error, and the runs that must print no result."""

import json
import os
import subprocess
import sys
import types

import pytest
import torch

from stencilbench import cells, harness, run
from stencilbench.conftest import copy_bench

REPO = os.path.dirname(cells.ROOT)


def cpu_main(monkeypatch, capsys, root, argv):
    """``run.main`` with the look for a card answered yes and the run made
    on the CPU, in the benchmark copy at ``root``."""
    load, run_cell = cells.load_cell, harness.run_cell
    monkeypatch.setattr(cells, "load_cell", lambda name: load(name, root))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(harness, "run_cell",
                        lambda c, s, sec, t, dev, t0:
                        run_cell(c, s, sec, t, "cpu", t0))
    rc = run.main(argv)
    return rc, capsys.readouterr()


@pytest.mark.parametrize("name", ["2d25pt_box.solve48",
                                  "2d25pt_box.return48"])
def test_last_line_keys(monkeypatch, capsys, small_root, name):
    rc, out = cpu_main(monkeypatch, capsys, small_root,
                       ["--workload", name, "--seed", str(2**31 + 3),
                        "--seconds", "0.01", "--trace", "0"])
    assert rc == 0, out.err
    lines = out.out.strip().splitlines()
    result = json.loads(lines[-1])
    assert list(result) == ["correct", "attempted", "failed", "metrics",
                            "device", "checks"]
    assert result["correct"] is True and result["attempted"] >= 1
    assert set(result["device"]) == {"platform", "kind", "count",
                                     "memory_peak_bytes"}
    # one request's latency gives no percentile
    assert set(result["metrics"]) == {"setup_s"} | (
        set() if "return" in name else {"gstencil_s"})
    for m in result["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    check = result["checks"][harness.CHECKED]
    assert set(check) == {"value", "limit"}
    err = out.err.strip().splitlines()
    assert err[-1].startswith(f"{harness.CHECKED} {check['value']!r} "
                              f"limit {check['limit']!r}")
    assert "card" in json.loads(lines[-2])


def test_no_result_where_jax_was_loaded(monkeypatch, capsys, small_root):
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    rc, out = cpu_main(monkeypatch, capsys, small_root,
                       ["--workload", "2d25pt_box.solve48", "--seed", "1",
                        "--seconds", "0.01", "--trace", "0"])
    assert rc != 0 and out.out == ""
    assert "jax" in out.err


def test_forbidden_names_are_compared_whole():
    assert run.forbidden_modules(["drstencil_tpu_torch",
                                  "drstencil_tpu_torch.ops", "jaxtyping",
                                  "flaxen"]) == []
    assert run.forbidden_modules(["jax.numpy", "drstencil_tpu.ops",
                                  "jaxlib", "flax"]) == [
        "drstencil_tpu", "flax", "jax", "jaxlib"]


def test_no_result_without_a_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = run.main(["--workload", "2d25pt_box.solve48", "--seed", "1",
                   "--seconds", "1", "--trace", "0"])
    out = capsys.readouterr()
    assert rc != 0 and out.out == "" and "CUDA" in out.err


def test_no_result_with_too_few_cards(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    rc = run.main(["--workload", "3d7pt_star.solve48", "--seed", "1",
                   "--seconds", "1", "--trace", "0"])
    assert rc != 0 and capsys.readouterr().out == ""


def test_no_result_with_only_the_benchmark(tmp_path):
    """A checkout holding only BENCHMARK.json and the benchmark's folder."""
    copy_bench(str(tmp_path))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "-m", "stencilbench.run", "--workload",
         "2d25pt_box.solve48", "--seed", "1", "--seconds", "1"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0 and proc.stdout == ""
    assert "drstencil_tpu_torch" in proc.stderr


def test_command_of_benchmark_json():
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        bench = json.load(f)
    assert bench["command"] == ["python3", "-m", "stencilbench.run"]
    assert bench["paths"] == ["stencilbench"]
