"""The plain reference against the port's CPU path at small grids, its
control, and the check seeing each fault the cells can have."""

import numpy as np
import pytest
import torch

from stencilbench import cells, control, harness, reference, work
from stencilbench.conftest import SMALL
from drstencil_tpu_torch.ir.passes import fuse as port_fuse, order_of
from drstencil_tpu_torch.ir.spec import load_stc as port_load_stc
from drstencil_tpu_torch.ops.config import KernelConfig
from drstencil_tpu_torch.ops.runner import StencilProgram

CELLS = ["2d25pt_box.solve48", "3d7pt_star.solve48", "2d25pt_box.return48",
         "2d25pt_box.bf16-solve48", "3d7pt_star.bf16-solve48"]
# the .stc copies the small configurations read, by their names
STC = sorted({cells.load_json(cells.ROOT, "configs", c)["stc"][:-len(".stc")]
              for c in SMALL})


@pytest.mark.parametrize("config", STC)
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
    (c, s) for c in STC for s in (1, 2, 3, 4)])
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
    """The control one precision below the cell's state, in the program's
    place: the program's own bfloat16 state in a float32 cell, fails it
    tenfold; the reference held to 4 bits in a bfloat16 cell, twofold."""
    cell = cells.load_cell(name, small_root)
    bench = control.control_bench(cell, "cpu")
    bench.load(3)
    cell.driver().run(bench, cell.traffic, requests=1)
    errors = harness.check(cell, 3, bench.step, bench.pairs,
                           bench.answers(), bench.device)
    times = {"float32": 10, "bfloat16": 2}[cell.config["dtype"]]
    assert max(errors.values()) > times * cell.limits[harness.CHECKED]
    assert bench.check(bench.answers()) == errors


@pytest.mark.parametrize("name", CELLS)
def test_each_cell_has_its_control(small_root, name):
    cell = cells.load_cell(name, small_root)
    bench = control.control_bench(cell, "cpu")
    if cell.config["dtype"] == "float32":
        assert control.control_of(cell) == "bfloat16"
        assert type(bench) is harness.Solve
        assert bench.prog.dtype == torch.bfloat16
    else:
        assert control.control_of(cell) == "bits4"
        assert type(bench) is control.Bits4
    cell.config["dtype"] = "float16"
    with pytest.raises(ValueError, match="no control"):
        control.control_bench(cell, "cpu")


def round4(values):
    return reference.round_bits_(torch.tensor(values, dtype=torch.float64),
                                 4).tolist()


def test_round_bits_keeps_four_bits():
    """Exact on values that have 4 bits, to nearest even between two, with
    sign, zero and magnitudes to 1e30 kept, and idempotent."""
    four = [0.0, 1.0, 1.125, 1.875, -15.0, 0.5625, 2.0**-60 * 13, 13 * 2.0**90]
    assert round4(four) == four
    assert round4([1.0625, 1.1875, -1.0625, 3.0 * 2**-5]) == [
        1.0, 1.25, -1.0, 3.0 * 2**-5]
    assert round4([1.06, 1.07, 31.9, -0.0]) == [1.0, 1.125, 32.0, 0.0]
    assert str(round4([-0.0])[0]) == "-0.0"
    big = round4([1e30, -1e30, 7.3e29])
    for got, want in zip(big, [1e30, -1e30, 7.3e29]):
        assert abs(got - want) <= abs(want) / 16
        assert got != 0 and (got > 0) == (want > 0)
    x = torch.rand(10000, dtype=torch.float64,
                   generator=torch.Generator().manual_seed(1)) * 1e3 - 500
    once = reference.round_bits_(x.clone(), 4)
    assert torch.equal(reference.round_bits_(once.clone(), 4), once)
    assert float(((once - x).abs() / x.abs()).max()) <= 2.0**-4
    assert once.to(torch.bfloat16).to(torch.float64).equal(once)
    f32 = x.to(torch.float32)
    assert reference.round_bits_(f32.clone(), 4).double().equal(
        reference.round_bits_(f32.double(), 4))


@pytest.mark.parametrize("name", ["2d25pt_box.bf16-solve48",
                                  "3d7pt_star.bf16-solve48"])
def test_a_sound_bf16_answer_held_to_four_bits_fails(small_root, name):
    cell = cells.load_cell(name, small_root)
    bench = harness.Solve(cell, "cpu")
    bench.load(4)
    cell.driver().run(bench, cell.traffic, requests=1)
    answer = bench.state["a"].to(torch.float32)
    limit = cell.limits[harness.CHECKED]
    [sound] = bench.check({"a": answer}).values()
    [held] = bench.check({"a": reference.round_bits_(answer, 4)}).values()
    assert sound < limit < held


@pytest.mark.parametrize("name", ["2d25pt_box.bf16-solve48",
                                  "3d7pt_star.bf16-solve48"])
def test_the_bits4_control_rounds_at_every_store(small_root, name):
    """The control's answer is the fp32 reference with the state rounded to
    4 bits from the input on and at every application's store: not the one
    rounded only at the end, nor the one rounded only after each pair."""
    cell = cells.load_cell(name, small_root)
    bench = control.control_bench(cell, "cpu")
    bench.load(6)
    cell.driver().run(bench, cell.traffic, requests=1)
    got = bench.state["a"].to(torch.float32)
    assert reference.round_bits_(got.clone(), 4).equal(got)
    _, taps = reference.load_stc(cell.stc_path)
    field = bench.a0.to(torch.float32)

    def solve(store):
        return reference.solve(field, taps, bench.step, bench.pairs,
                               torch.float32, store=store)

    assert got.equal(solve(control.hold4))
    plain = control.hold4(solve(None))
    assert not got.equal(plain)
    fused = reference.fuse(taps, bench.step)
    h = reference.frame(fused)
    a = control.hold4(field.clone())
    b = torch.zeros_like(a)
    for _ in range(bench.pairs):
        reference.apply(a, b, fused, h)
        reference.apply(b, a, fused, h)
        control.hold4(a)
    assert not got.equal(a)


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


def altered(run_pairs, by):
    def broken(self, state, pairs):
        out = run_pairs(self, state, pairs)
        a = state["a"]
        a[tuple(d // 2 for d in a.shape)] *= 1 + by
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
    cell = cells.load_cell(name, small_root)
    # a bfloat16 ulp is 4e-3 to 8e-3 of a value: 1 + 1e-3 would round away
    by = (1e-3 if cell.config["dtype"] == "float32"
          else 4 * cell.limits[harness.CHECKED])
    broken = {"unchanged": unchanged, "half_rows": half_rows(orig),
              "altered": altered(orig, by)}[fault]
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
