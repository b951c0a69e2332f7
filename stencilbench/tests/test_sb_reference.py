"""The plain reference against the port's CPU path at small grids, its
control, and the check seeing each fault the cells can have."""

import numpy as np
import pytest
import torch

from stencilbench import cells, harness, reference, work
from stencilbench.conftest import SMALL
from drstencil_tpu_torch.ir.passes import fuse as port_fuse, order_of
from drstencil_tpu_torch.ir.spec import load_stc as port_load_stc
from drstencil_tpu_torch.ops.config import KernelConfig
from drstencil_tpu_torch.ops.runner import StencilProgram

CELLS = ["2d25pt_box.solve48", "3d7pt_star.solve48", "2d25pt_box.return48"]


@pytest.mark.parametrize("config", sorted(SMALL))
def test_parser_and_fusion_agree_with_the_port(config):
    path = f"{cells.ROOT}/configs/{config}.stc"
    dims, taps = reference.load_stc(path)
    spec = port_load_stc(path)
    assert dims == spec.dims and taps == dict(spec.taps)
    for step in (1, 2, 3, 4):
        fused = reference.fuse(taps, step)
        ported = port_fuse(spec.taps, step)
        assert fused.keys() == ported.keys()
        assert all(fused[k] == pytest.approx(ported[k], rel=1e-12)
                   for k in fused)
        assert reference.frame(fused) == order_of(ported) == step * max(
            abs(o) for off in taps for o in off)


@pytest.mark.parametrize("config,step", [
    (c, s) for c in sorted(SMALL) for s in (1, 2, 3, 4)])
def test_reference_matches_the_ports_cpu_path(small_root, config, step):
    """The reference and the port's plain path, from one field, after 48
    timesteps of the step's fused operator."""
    dims, taps = reference.load_stc(f"{small_root}/configs/{config}.stc")
    spec = port_load_stc(f"{small_root}/configs/{config}.stc")
    prog = StencilProgram(spec, KernelConfig(step=step, trapezoid=True),
                          device="cpu")
    field = work.make_field(dims, 11, "cpu")
    state = {"a": field.clone(), "b": torch.zeros_like(field)}
    pairs = work.pairs_per_request(48, step)
    got = prog.final_a(prog.run_pairs(state, pairs))
    ref = reference.solve(field, taps, step, pairs)
    assert reference.max_rel_err(torch.from_numpy(got), ref) < 1e-5
    # the frame of `a` is the field's own, bit for bit
    h = reference.frame(reference.fuse(taps, step))
    assert np.array_equal(got[:h], field[:h].numpy())


def test_max_rel_err():
    ref = torch.tensor([1.0, 2.0, 0.0], dtype=torch.float64)
    assert reference.max_rel_err(torch.tensor([1.0, 2.0, 0.0]), ref) == 0
    assert reference.max_rel_err(torch.tensor([1.0, 2.2, 0.0]),
                                 ref) == pytest.approx(0.1, rel=1e-6)
    assert reference.max_rel_err(torch.tensor([1.0, 2.0, 1e-9]),
                                 ref) > 1e200
    assert reference.max_rel_err(torch.tensor([float("nan"), 2.0, 0.0]),
                                 ref) == float("inf")


def run(root, name, seed=5):
    cell = cells.load_cell(name, root)
    return harness.run_cell(cell, seed, 0.0, False, "cpu", 0.0)[0]


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(small_root, name):
    res = run(small_root, name)
    assert res["correct"] is True and res["failed"] == 0
    check = res["checks"][harness.CHECKED]
    assert 0 < check["value"] < check["limit"]


@pytest.mark.parametrize("name", CELLS)
def test_control_fails_the_limit(small_root, name):
    """The program's own bfloat16 state, in the program's place."""
    cell = cells.load_cell(name, small_root)
    bench = harness.Solve(cell, "cpu", dtype="bfloat16")
    bench.load(3)
    cell.driver().run(bench, cell.traffic, requests=1)
    errors = harness.check(cell, 3, bench.step, bench.pairs,
                           bench.answers(), bench.device)
    assert max(errors.values()) > 10 * cell.limits[harness.CHECKED]
    assert bench.check(bench.answers()) == errors


def unchanged(self, state, pairs):
    return dict(state)


def half_rows(run_pairs):
    def broken(self, state, pairs):
        a = state["a"]
        rest = a[a.shape[0] // 2:].clone()
        out = run_pairs(self, state, pairs)
        a[a.shape[0] // 2:] = rest
        return out
    return broken


def altered(run_pairs):
    def broken(self, state, pairs):
        out = run_pairs(self, state, pairs)
        a = state["a"]
        a[tuple(d // 2 for d in a.shape)] *= 1 + 1e-3
        return out
    return broken


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("fault", ["unchanged", "half_rows", "altered"])
def test_each_fault_comes_out_not_correct(small_root, monkeypatch, name,
                                          fault):
    """The whole run, the timed path broken underneath: a step that returns
    its state unchanged, half of the grid's rows left out, one cell of the
    answer altered where it is produced."""
    orig = StencilProgram.run_pairs
    broken = {"unchanged": unchanged, "half_rows": half_rows(orig),
              "altered": altered(orig)}[fault]
    monkeypatch.setattr(StencilProgram, "run_pairs", broken)
    res = run(small_root, name)
    assert res["correct"] is False and res["failed"] >= 1
    assert res["checks"][harness.CHECKED]["value"] > res["checks"][
        harness.CHECKED]["limit"]


@pytest.mark.parametrize("name", ["2d25pt_box.return48"])
def test_an_answer_altered_in_the_readback_is_caught(small_root, monkeypatch,
                                                     name):
    final_a = StencilProgram.final_a

    def broken(self, state):
        out = final_a(self, state)
        out[3, 40] *= 1 + 1e-3
        return out

    monkeypatch.setattr(StencilProgram, "final_a", broken)
    assert run(small_root, name)["correct"] is False
