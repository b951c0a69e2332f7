"""The bench of a cell on more than one card, on the CPU: a mesh that names
the CPU four times, in a copy of the benchmark at a small grid. Its answers
equal the one-card bench's, its cone reference equals the whole-grid one on
every box, and its check fails the faults the cell can have."""

import json
import os

import pytest
import torch
from drstencil_tpu_torch.ops import stream as stream_mod
from drstencil_tpu_torch.parallel import stream_shard

from stencilbench import cells, cones, harness, reference, run, work
from stencilbench.conftest import SHARDED, SMALL
from stencilbench.sharded import ShardedSolve

SEED = 2**31 + 21


@pytest.fixture
def cell(small_root):
    return cells.load_cell(SHARDED, small_root)


def one_request(bench, cell, seed=SEED):
    bench.load(seed)
    cell.driver().run(bench, cell.traffic, requests=1)
    return bench


def run_cell(cell, seed=SEED):
    return harness.run_cell(cell, seed, 0.0, False, "cpu", 0.0)


def test_the_bench_follows_the_cells_chips(cell):
    bench = harness.bench_for(cell, "cpu")
    assert isinstance(bench, ShardedSolve)
    assert len(bench.devices) == cell.chips == 4
    assert bench.g.local_rows == SMALL["3d7pt_star-3072x2048x2048"][0] // 4


@pytest.mark.parametrize("seed", [SEED, 5])
def test_sharded_answers_equal_one_card_answers(cell, seed):
    """From the same per-slab field, cell for cell: the whole of ``a``, and
    each box of the last answer."""
    sharded = one_request(ShardedSolve(cell, "cpu"), cell, seed)
    single = one_request(harness.Solve(cell, "cpu"), cell, seed)
    whole = torch.from_numpy(stream_shard.unshard_state(
        sharded.state["a"], sharded.g))
    assert torch.equal(whole, single.state["a"])
    boxes = sharded.answers()["last request"]
    for label, b in sharded.boxes.items():
        assert torch.equal(boxes[label],
                           single.state["a"][cones.within(b)])


def test_the_field_is_made_per_block(cell):
    dims = cell.config["dims"]
    field = work.field_of(cell.config, dims, SEED, "cpu")
    blocks = torch.chunk(field, 4)
    for k, block in enumerate(blocks):
        assert torch.equal(block, work.make_field(
            block.shape, work.block_seed(SEED, k), "cpu"))
    # the blocks differ, and no block is the whole field's
    assert not torch.equal(blocks[0], blocks[1])
    assert not torch.equal(field, work.make_field(dims, SEED, "cpu"))
    bench = ShardedSolve(cell, "cpu")
    bench.load(SEED)
    for k in range(4):
        assert torch.equal(bench.a0[k], blocks[k])


@pytest.mark.parametrize("config,step,pairs,size", [
    ("3d7pt_star", 4, 6, (16, 128, 128)),     # the cell's own solve
    ("3d7pt_star", 4, 1, (8, 8, 8)),          # crops cut on every axis
    ("2d25pt_box", 3, 1, (8, 8)),
])
def test_cone_reference_equals_the_whole_grid_reference(config, step, pairs,
                                                        size):
    _, taps = reference.load_stc(f"{cells.ROOT}/configs/{config}.stc")
    dims = (128, 40, 36)[:len(size)]
    field = work.make_field(dims, 9, "cpu")
    whole = reference.solve(field, taps, step, pairs)
    widen = cones.widening(taps, 2 * step * pairs)
    origin = (0,) * len(dims)
    found = cones.boxes(dims, 4, 9, size)
    assert [label for label in found if label.startswith("seam")] == [
        "seam 32", "seam 64", "seam 96"]
    cut = 0
    for label, b in found.items():
        c = cones.crop(b, dims, widen)
        cut += c != (origin, dims)
        ref = cones.reference_box(field[cones.within(c)], b, c,
                                  taps, step, pairs)
        assert torch.equal(ref, whole[cones.within(b)]), label
    assert cut == len(found)


def test_a_crop_one_cell_short_fails():
    """At one pair of the cell's step (8 timesteps) every box whose crop is
    cut one cell short reads above the limit. (At the cell's 48 timesteps
    a crop of 36 cells already reads the same bits: the far edge of the cone
    weighs 0.2 to the power of the timesteps.)"""
    _, taps = reference.load_stc(f"{cells.ROOT}/configs/3d7pt_star.stc")
    dims, step, pairs = (128, 40, 36), 4, 1
    field = work.make_field(dims, 9, "cpu")
    whole = reference.solve(field, taps, step, pairs)
    short = cones.widening(taps, 2 * step * pairs) - 1
    for label, b in cones.boxes(dims, 4, 9, (8, 8, 8)).items():
        c = cones.crop(b, dims, short)
        ref = cones.reference_box(field[cones.within(c)], b, c,
                                  taps, step, pairs)
        assert reference.max_rel_err(
            ref, whole[cones.within(b)]) > 2e-4, label


def test_boxes_cover_seams_edges_and_a_corner():
    dims = (3072, 2048, 2048)
    found = cones.boxes(dims, 4, SEED, (16, 128, 128))
    assert list(found) == ["seam 768", "seam 1536", "seam 2304", "edge 0",
                           "edge 3072", "corner", "interior 1", "interior 2"]
    for label, (lo, hi) in found.items():
        assert [z - a for a, z in zip(lo, hi)] == [16, 128, 128]
        assert all(0 <= a and z <= d for a, z, d in zip(lo, hi, dims))
    for plane in (768, 1536, 2304):
        assert found[f"seam {plane}"][0][0] == plane - 8
    assert found["edge 0"][0][0] == 0 and found["edge 3072"][1][0] == 3072
    assert all(a in (0, d - 128) for a, d in zip(found["corner"][0][1:],
                                                 dims[1:]))
    assert cones.boxes(dims, 4, SEED, (16, 128, 128)) == found
    assert cones.boxes(dims, 4, SEED + 1, (16, 128, 128)) != found


def test_a_sound_run_is_correct_on_every_box(cell):
    result, lines, _ = run_cell(cell)
    assert result["correct"] is True and result["failed"] == 0
    assert result["device"]["count"] == 4
    assert 0 < result["checks"][harness.CHECKED]["value"] < 2e-4
    # every box of every kept answer is printed with its reading
    boxes = [line for line in lines[:-1] if "last request, " in line]
    assert len(boxes) == 8


def test_the_control_fails_the_limit(cell):
    """The program's own bfloat16 state, in the program's place."""
    bench = one_request(harness.bench_for(cell, "cpu", "bfloat16"), cell)
    errors = bench.check(bench.answers())
    assert max(errors.values()) > 10 * cell.limits[harness.CHECKED]


def skipped_exchange(monkeypatch, cell):
    monkeypatch.setattr(stream_shard.HaloExchange, "__call__",
                        lambda self, slabs: None)


def unchanged(monkeypatch, cell):
    build = stream_shard.sharded_stream_pair

    def broken(spec, cfg, mesh):
        _, g = build(spec, cfg, mesh)
        return (lambda a, b: (a, b)), g

    monkeypatch.setattr(stream_shard, "sharded_stream_pair", broken)


def half_slabs(monkeypatch, cell):
    """The shard kernels of the upper half of the mesh never run."""
    build, made = stream_mod.build_stream_kernel, []

    def broken(an, cfg, device=None, row_frame=True):
        made.append(build(an, cfg, device, row_frame))
        # built in the mesh's order, one kernel a shard
        if (len(made) - 1) % cell.chips >= cell.chips // 2:
            return lambda src, dst, *rows: dst
        return made[-1]

    monkeypatch.setattr(stream_mod, "build_stream_kernel", broken)


def altered(kind):
    """One cell of the answer, at the centre of the first box of ``kind``,
    altered where the solve produces it."""
    def plant(monkeypatch, cell):
        solve = ShardedSolve.solve

        def broken(self):
            solve(self)
            b = next(b for label, b in self.boxes.items()
                     if label.startswith(kind))
            at = [(a + z) // 2 for a, z in zip(*b)]
            k, rows = at[0] // self.g.local_rows, self.g.local_rows
            at[0] += self.g.halo - k * rows
            self.state["a"][k][tuple(at)] *= 1 + 1e-3

        monkeypatch.setattr(ShardedSolve, "solve", broken)
    return plant


FAULTS = {"skipped_exchange": skipped_exchange, "unchanged": unchanged,
          "half_slabs": half_slabs}
FAULTS.update({f"altered_{kind}": altered(kind)
               for kind in ("seam", "edge", "corner", "interior")})


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_each_fault_comes_out_not_correct(monkeypatch, cell, fault):
    """The whole run, the sharded path broken underneath."""
    FAULTS[fault](monkeypatch, cell)
    result, lines, _ = run_cell(cell)
    assert result["correct"] is False and result["failed"] >= 1
    check = result["checks"][harness.CHECKED]
    assert check["value"] > check["limit"]


def test_a_skipped_exchange_fails_every_seam_box(monkeypatch, cell):
    skipped_exchange(monkeypatch, cell)
    bench = one_request(ShardedSolve(cell, "cpu"), cell)
    errors = bench.check(bench.answers())
    seams = {label: e for label, e in errors.items() if ", seam " in label}
    assert len(seams) == 3 and min(seams.values()) > 2e-4
    assert errors["last request, edge 0"] < 2e-4


def test_no_result_with_fewer_cards_than_the_cell_asks(monkeypatch, capsys,
                                                       small_root):
    monkeypatch.setattr(cells, "load_cell",
                        lambda name, load=cells.load_cell: load(name,
                                                                small_root))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
    rc = run.main(["--workload", SHARDED, "--seed", "1", "--seconds", "1"])
    out = capsys.readouterr()
    assert rc != 0 and out.out == ""
    assert "needs 4 CUDA card(s), found 3" in out.err


def test_the_cells_files_state_the_deployment():
    with open(f"{cells.ROOT}/configs/3d7pt_star-3072x2048x2048.json") as f:
        conf = json.load(f)
    assert conf["dims"] == [3072, 2048, 2048] and conf["field_blocks"] == 4
    dims, taps = reference.load_stc(
        f"{cells.ROOT}/configs/3d7pt_star-3072x2048x2048.stc")
    assert list(dims) == conf["dims"]
    assert taps == reference.load_stc(
        f"{cells.ROOT}/configs/3d7pt_star.stc")[1]
    with open(f"{cells.ROOT}/workloads/{SHARDED}.json") as f:
        check = json.load(f)
    assert check == {"limits": {harness.CHECKED: 2e-4},
                     "box": [16, 128, 128]}


def test_a_mix_that_returns_results_is_checked_on_the_returned_boxes(
        monkeypatch, small_root):
    """The sharded cell under the return mix: each result comes back whole
    through ``readback``, its boxes are held to the reference, and one cell
    of a returned box altered on the host fails the check."""
    path = f"{os.path.dirname(small_root)}/BENCHMARK.json"
    with open(path) as f:
        bench = json.load(f)
    next(w for w in bench["workloads"] if w["name"] == SHARDED)[
        "traffic"] = "return48"
    with open(path, "w") as f:
        json.dump(bench, f)
    cell = cells.load_cell(SHARDED, small_root)
    result, lines, _ = run_cell(cell)
    assert result["correct"] is True
    assert [line for line in lines if line.startswith("last request, ")]
    readback = ShardedSolve.readback

    def broken(self):
        out = readback(self)
        lo, hi = self.boxes["seam 64"]
        out[tuple((a + z) // 2 for a, z in zip(lo, hi))] *= 1 + 1e-3
        return out

    monkeypatch.setattr(ShardedSolve, "readback", broken)
    assert run_cell(cell)[0]["correct"] is False
