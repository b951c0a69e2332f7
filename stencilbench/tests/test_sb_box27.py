"""The cell ``3d27pt_box.solve48`` at a grid the CPU can hold: the only cell
whose winner (``step 2, tm 127``) runs the ring 3D text, and the reader of
the levels kernels' shared-memory loads per stencil-cell update."""

import pytest
import torch

from stencilbench import cells, control, harness, reference, work
from stencilbench.conftest import copy_bench
from drstencil_tpu_torch.ir.spec import load_stc as port_load_stc
from drstencil_tpu_torch.ops.config import KernelConfig
from drstencil_tpu_torch.ops.runner import StencilProgram
from drstencil_tpu_torch.tune.tuned import best_config

CELL = "3d27pt_box.solve48"
SMALL = {"3d27pt_box": [28, 24, 20]}
PER_LAYER = {"kernel_roofline_pct", "kernel_ms_per_step", "device_idle_pct",
             "launch_host_us", "idle_host_pct", "plan_setup_s",
             "kernel_flops_per_stencil", "kernel_smem_loads_per_stencil"}
WINNER = KernelConfig(step=2, tm=127, trapezoid=True)


@pytest.fixture
def root(tmp_path):
    return copy_bench(str(tmp_path), SMALL)


def run(root, seed=5):
    cell = cells.load_cell(CELL, root)
    return harness.run_cell(cell, seed, 0.0, False, "cpu", 0.0)[0]


def test_the_winner_is_the_ring_plan():
    cfg = best_config("3d27pt_box")
    assert (cfg.step, cfg.tm, cfg.trapezoid, cfg.block) == (2, 127, True, 1)
    assert work.pairs_per_request(48, cfg.step) * 2 * cfg.step == 48


def test_reference_matches_the_ports_cpu_path(root):
    """At the winner's config: 48 timesteps from one field, the frame of
    ``a`` the field's bit for bit."""
    path = f"{root}/configs/3d27pt_box.stc"
    dims, taps = reference.load_stc(path)
    prog = StencilProgram(port_load_stc(path), WINNER, device="cpu")
    field = work.make_field(dims, 11, "cpu")
    state = {"a": field.clone(), "b": torch.zeros_like(field)}
    pairs = work.pairs_per_request(48, WINNER.step)
    got = prog.final_a(prog.run_pairs(state, pairs))
    ref = reference.solve(field, taps, WINNER.step, pairs)
    assert reference.max_rel_err(torch.from_numpy(got), ref) < 1e-5
    h = reference.frame(reference.fuse(taps, WINNER.step))
    assert h == 2
    frame = torch.ones(tuple(dims), dtype=torch.bool)
    frame[h:-h, h:-h, h:-h] = False
    assert torch.equal(torch.from_numpy(got)[frame], field[frame])


def test_sound_run_is_correct(root):
    res = run(root)
    assert res["correct"] is True and res["failed"] == 0
    check = res["checks"][harness.CHECKED]
    assert 0 < check["value"] < check["limit"]


def test_control_fails_the_limit(root):
    """The program's own bfloat16 state fails the float32 cell's limit
    tenfold."""
    cell = cells.load_cell(CELL, root)
    assert control.control_of(cell) == "bfloat16"
    bench = control.control_bench(cell, "cpu")
    bench.load(3)
    cell.driver().run(bench, cell.traffic, requests=1)
    errors = bench.check(bench.answers())
    assert max(errors.values()) > 10 * cell.limits[harness.CHECKED]


@pytest.mark.parametrize("which", ["request", "last request"])
def test_an_answer_altered_in_the_readback_is_caught(root, which):
    """A kept answer, or the last one, altered by 1e-3 in one interior cell
    as the harness reads it back for the check, over the first
    ``sample_from`` requests of the mix."""
    cell = cells.load_cell(CELL, root)
    bench = harness.Solve(cell, "cpu")
    bench.load(5)
    cell.driver().run(bench, cell.traffic,
                      requests=cell.traffic["sample_from"])
    answers = bench.answers()
    assert len(answers) == cell.traffic["check_samples"] + 1
    limit = cell.limits[harness.CHECKED]
    assert max(bench.check(answers).values()) < limit
    label = next(k for k in answers if k.startswith(which))
    answers[label] = answers[label].clone()
    answers[label][14, 12, 10] *= 1 + 1e-3
    errors = bench.check(answers)
    assert [k for k, e in errors.items() if not e <= limit] == [label]


def test_the_cell_reports_its_per_layer_set(root):
    cell = cells.load_cell(CELL, root)
    assert cell.chips == 1 and cell.config["dims"] == SMALL["3d27pt_box"]
    assert {m[0] for m in cell.metrics(trace=True)} == PER_LAYER
    assert {m[0] for m in cell.metrics(trace=False)} == {"gstencil_s",
                                                         "setup_s"}


def ctx():
    return harness.Context(setup_s=1.0, window=None, slice=None,
                           work=work.work_of((512,) * 3, 27, 48, 2,
                                             "float32"),
                           peaks=None)


def read(c):
    return cells.load_module(cells.ROOT, "metrics",
                             "kernel_smem_loads_per_stencil").read(c)


def test_the_reader_divides_smem_loads_by_cell_steps(monkeypatch):
    """One launch of the winner's plan at 512^3: 27 loads a quad-level."""
    from drstencil_tpu_torch.ops import kernels

    counts = {"flops": 15627296768, "cell_steps": 262193024,
              "smem_loads": 1990268928}
    monkeypatch.setattr(kernels, "plan_counters", lambda: dict(counts))
    assert read(ctx()) == pytest.approx(7.590853858873072, rel=1e-15)


@pytest.mark.parametrize("counts", [
    {"flops": 0, "cell_steps": 0, "smem_loads": 0},
    # a factor plan's launches: cell-steps, but no loads counted
    {"flops": 100, "cell_steps": 10, "smem_loads": 0},
    # a program without the counter
    {"flops": 7124373600, "cell_steps": 534775808},
])
def test_the_reader_finds_nothing_without_counts(monkeypatch, counts):
    from drstencil_tpu_torch.ops import kernels

    monkeypatch.setattr(kernels, "plan_counters", lambda: dict(counts))
    assert read(ctx()) is None


def test_a_cpu_run_reads_no_loads(root):
    """The plain versions count nothing, so nothing is read after a run on
    the CPU."""
    from drstencil_tpu_torch.ops import kernels

    kernels.reset_plan_counters()
    assert run(root)["correct"] is True
    assert read(ctx()) is None
