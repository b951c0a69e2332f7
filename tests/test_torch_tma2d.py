"""Source rows by TMA in the windowed 2D text
(``drstencil_tpu_torch/ops/codegen.py``).

A windowed 2D plan that is not in factor mode, whose staged row, its start
and the grid's rows are whole 16-byte pieces in either state type (the
strip, its halo and the grid's width multiples of 8 cells), and whose
shared memory holds four CTAs an SM or more, as many with either feed,
gets each row as one box of a 2D
tensor map of 8-byte elements: one thread asks for it ``AHEAD`` steps
before its use into a slot in shared memory, reported on the slot's
mbarrier, and the copy engine fills zeros outside the domain (left of the
grid too), where the ``cp.async`` feed it replaces fills them by hand.
Only where the source's cells come from changes, so its text must compute
what the ``cp.async`` text of the same plan computes bit for bit.  That is
checked under the ``g++`` emulation (``test_torch_codegen.emulated``, whose
``tests/cuda_emulation/bulk_copy.h`` copies a box as the card does and
refuses one that does not start on 16 bytes) for ``2d25pt_box`` ``fu3`` in
both dtypes and the cross's block-fused ``fu8 b2`` (on 240-cell strips), on
a grid of several strips and segments, a shard slab, a grid narrower than
one strip, a strip of 424 cells and the shortest window.  Plans at three
CTAs an SM, factor plans, unaligned strips and ``tile2d_fused`` keep their
texts byte for byte.  Then the host's map cache (two maps a ping-pong pair)
and the plan counter ``tma_2d``.
"""

import dataclasses
import subprocess
import sys

import numpy as np
import pytest
import torch

from drstencil_tpu_torch.ir.passes import analyze
from drstencil_tpu_torch.ops import codegen, kernels
from drstencil_tpu_torch.ops.config import KernelConfig
from drstencil_tpu_torch.ops.stream import level_plan, state_dtype

from test_torch_codegen import bench_spec, bf16_ulp, emulated
from test_torch_partial2d import WINNERS_2D, winner_plan
from test_torch_tma3d import MAPS_RUNNER, fake_build  # noqa: F401 (fixture)
from test_torch_window3d import KERNEL_TOL, bits, plan_for


def copies_feed(*_):
    """``codegen._feed_2d`` with TMA off."""
    return codegen.CpAsyncFeed(codegen.AHEAD_2D)


def copies_text(plan, dims, dtype, shard, monkeypatch):
    """The plan's text on the ``cp.async`` feed: each thread copies its
    quad of each row."""
    with monkeypatch.context() as m:
        m.setattr(codegen, "_feed_2d", copies_feed)
        assert not codegen.geometry(plan, dims).tma
        return codegen.cuda_source(plan, dims, dtype, shard)


def build(name):
    """(dims, store range) of a build: several strips and segments, a shard
    slab with a store range inside it, a grid narrower than one strip (one
    box of 56 cells, more threads than quads), a strip of 424 cells, or one
    output row: the shortest window, ``2 * H + 1`` rows."""
    return {"grid": ((64, 1008), None),
            "shard": ((40, 1008), (10, 28)),
            "narrow": ((40, 40), None),
            "ragged": ((64, 408), None),
            "short": (None, None)}[name]


CASES = ([("2d25pt_box", dt, b) for dt in codegen.DTYPES
          for b in ("grid", "shard", "narrow", "ragged", "short")]
         + [("2d5pt_cross", dt, b) for dt in codegen.DTYPES
            for b in ("grid", "shard")])


def case_plan(name, dtype, dims):
    """The winner's plan; the cross's on 240-cell strips, whose shared
    memory holds four CTAs an SM (its 496-cell strip holds three)."""
    spec, plan = winner_plan(name, dtype, dims)
    return plan if name == "2d25pt_box" else dataclasses.replace(
        plan, column=240)


@pytest.mark.parametrize("name,dtype,which", CASES,
                         ids=[" ".join(c) for c in CASES])
def test_tma_text_equals_the_cp_async_text(tmp_path, monkeypatch, name,
                                           dtype, which):
    dims, rows = build(which)
    if which == "short":
        frame = winner_plan(name, dtype)[1].frame
        dims = (2 * frame + 1, 1008)
    plan = case_plan(name, dtype, dims)
    g = codegen.geometry(plan, dims)
    assert g.partial and g.tma and g.ahead == 7
    if which == "grid":
        assert g.grid[0] >= 3 and g.grid[-1] > 1
    if which == "narrow":
        assert g.ex == 56 and g.threads > g.ex // 4
    if which == "ragged":
        assert g.ex == 424
    if which == "short":
        assert g.interior == 1
    if name == "2d5pt_cross":
        assert plan.block_fused and g.ex == 256
    shard = rows is not None
    tma = codegen.cuda_source(plan, dims, dtype, shard)
    copies = copies_text(plan, dims, dtype, shard, monkeypatch)
    assert "cp.async.bulk.tensor.2d" in tma
    assert "__pipeline_memcpy_async" not in tma
    assert "__pipeline_memcpy_async" in copies and "tma_" not in copies
    rng = np.random.default_rng(11)
    tdt = state_dtype(dtype)
    src = torch.from_numpy(rng.uniform(0, 100, dims)).to(tdt)
    fill = torch.from_numpy(rng.uniform(-0.5, 0.5, dims)).to(tdt)
    store = [int(v) for v in rows] if shard else []
    outs = []
    for label, text in (("tma", tma), ("copies", copies)):
        (tmp_path / label).mkdir()
        outs.append(emulated(text, tmp_path / label)(src, fill.clone(), store))
    got, want_bits = outs
    assert torch.equal(bits(got), bits(want_bits))
    # and both are the plain version's levels
    want = fill.clone()
    kernels.kernel_for(2, shard).plain(src, want, plan,
                                       *([tuple(store)] if shard else []))
    diff = (got.float() - want.float()).abs()
    top = float(want.float().abs().max())
    if dtype == "float32":
        assert float(diff.max()) <= KERNEL_TOL * top
    else:
        assert bool((diff <= bf16_ulp(want) + KERNEL_TOL * top).all())
    assert not torch.equal(bits(got), bits(fill))


def test_every_engaged_window_outlasts_the_rows_requested_ahead():
    """A window of fewer rows than ``AHEAD`` cannot take the feed: the
    strip's halo is a multiple of 8 cells, so the frame is at least 5 and
    a window at least ``2 * 5 + 1`` rows; the prologue's bound on the rows
    it asks for is there for the text's sake."""
    for name in sorted(WINNERS_2D):
        spec, plan = winner_plan(name)
        dims = (2 * plan.frame + 1, 1008)
        g = codegen.geometry(winner_plan(name, dims=dims)[1], dims)
        if g.tma:
            assert g.hx % 8 == 0 and g.frame >= 5
            assert g.interior + 2 * g.frame > g.ahead


def test_feed_engages_by_the_plan_alone(monkeypatch):
    """The 2d25pt_box winner, whose shared memory holds four CTAs an SM,
    takes the feed in both dtypes, full grid and shard slab, with the
    geometry of the cp.async feed (strip, segment, threads, CTAs an SM) in
    less shared memory; the other 2D winners (three CTAs an SM; 2d13pt_star
    besides a 12-cell halo), a plan whose slots would admit more CTAs an SM
    than its staging rows, factor plans and a grid width of 4 modulo 8 keep
    their texts byte for byte; ``tile2d_fused`` has no TMA."""
    for name in sorted(WINNERS_2D):
        spec, plan = winner_plan(name)
        for dims in (spec.dims, (spec.dims[0] // 4 + 2 * plan.frame,
                                 spec.dims[1])):
            g = codegen.geometry(plan, dims)
            with monkeypatch.context() as m:
                m.setattr(codegen, "_feed_2d", copies_feed)
                cp = codegen.geometry(plan, dims)
            assert g.tma == (name == "2d25pt_box")
            assert g.tma == (g.hx % 8 == 0 and cp.min_blocks == 4)
            assert (g.tile, g.threads, g.min_blocks, g.ctas_per_sm) == (
                cp.tile, cp.threads, cp.min_blocks, cp.ctas_per_sm)
            assert g.smem_bytes <= cp.smem_bytes
            if g.tma:
                assert g.feed == codegen.TmaFeed(7, ndim=2)
                assert g.ex == 512 and (g.tile[1] - g.hx) % 8 == 0
            for dtype in codegen.DTYPES:
                for shard in (False, True):
                    text = codegen.cuda_source(plan, dims, dtype, shard)
                    if not g.tma:
                        assert text == copies_text(plan, dims, dtype, shard,
                                                   monkeypatch)
    # the cross at fu6 b3 holds four CTAs an SM by the staging rows and
    # would hold five by the slots: its segment would move
    cross = bench_spec("2d5pt_cross")
    fu6 = level_plan(analyze(cross, 6), KernelConfig(step=6, block=3,
                                                     trapezoid=True))
    g = codegen.geometry(fu6, cross.dims)
    assert g.partial and not g.tma and g.ctas_per_sm == 4
    rings = 2 * g.guard + g.levels * g.ring * g.ex
    assert codegen._ctas_by_smem(codegen.TmaFeed(7, ndim=2).smem_bytes(
        rings, g.ex), g.threads) == 5
    box = bench_spec("2d25pt_box")
    plan = winner_plan("2d25pt_box")[1]
    g = codegen.geometry(plan, (8192, 8188))        # 4 cells modulo 8
    assert g.partial and not g.tma
    for dtype in codegen.DTYPES:
        assert codegen.cuda_source(plan, (8192, 8188), dtype, True) == \
            copies_text(plan, (8192, 8188), dtype, True, monkeypatch)
    for step in (1, 2):
        factor = level_plan(analyze(box, step), KernelConfig(
            step=step, factor=True))
        g = codegen.geometry(factor, box.dims)
        assert g.factor and g.tail and not g.tma
        for dtype in codegen.DTYPES:
            text = codegen.cuda_source(factor, box.dims, dtype, False)
            assert "__pipeline_memcpy_async" in text and "tma_" not in text
    taps = kernels.tile2d_taps(*(lambda an: (an.fused, an.halo))(
        analyze(bench_spec("2d5pt_star"), step=2, require_partition=False)))
    assert "cp.async.bulk" not in codegen.tile2d_source(taps, 8192, 8192, 128)


def test_a_row_is_one_box_on_one_barrier():
    """The 2D text's constants: a row is one box of ``EX * sizeof(T) / 8``
    8-byte elements, at most ``TMA_BOX``, its bytes on one barrier; slots a
    power of two, past the rings on 128 bytes."""
    for name, dims, ex in (("2d25pt_box", (8192, 8192), 512),
                           ("2d25pt_box", (40, 40), 56),
                           ("2d25pt_box", (64, 408), 424),
                           ("2d5pt_cross", (64, 1008), 256)):
        for dtype in codegen.DTYPES:
            plan = case_plan(name, dtype, dims)
            text = codegen.cuda_source(plan, dims, dtype, False)
            g = codegen.geometry(plan, dims)
            assert g.tma and g.ex == ex
            item = 4 if dtype == "float32" else 2
            assert "constexpr int BOX = EX * (int)sizeof(T) / 8;" in text
            assert ex * item // 8 <= codegen.TMA_BOX and ex * item % 16 == 0
            assert "tma_bar_expect(bar, ROW_BYTES);" in text
            assert text.count("tma_copy_2d(") == 2      # its definition
            assert "CU_TENSOR_MAP_DATA_TYPE_INT64, 2," in text
            slots = g.ahead + 1
            assert slots & (slots - 1) == 0
            rings = 2 * g.guard + g.levels * g.ring * g.ex
            assert g.smem_bytes == (4 * codegen._ceil_to(rings, 32)
                                    + slots * (4 * codegen._ceil_to(g.ex, 32)
                                               + 8))
            # no modulo by the slots: a row's slot is a mask of its index
            assert "% SLOTS" not in text and "% (AHEAD + 1)" not in text


def test_the_map_cache_keeps_two_maps_a_pair(tmp_path):
    """A map holds its buffer's address, so the C entry encodes one a
    buffer and keeps it: a ping-pong pair needs two, however many
    launches."""
    dims = (40, 1008)
    plan = winner_plan("2d25pt_box", dims=dims)[1]
    assert codegen.geometry(plan, dims).tma
    text = codegen.cuda_source(plan, dims, "float32", False)
    assert "tma_encode_2d(&g_maps[k], src, 8, dims, box);" in text
    emulated(text, tmp_path)        # builds tmp_path / kernel.so
    state = tmp_path / "state.bin"
    np.random.default_rng(3).uniform(0, 1, dims).astype(
        np.float32).view(np.uint8).tofile(state)
    counts = []
    for n in (1, 4):
        run = subprocess.run([sys.executable, "-c", MAPS_RUNNER,
                              str(tmp_path / "kernel.so"), str(n),
                              str(state)],
                             capture_output=True, text=True, timeout=300)
        assert run.returncode == 0, run.stderr[-3000:]
        counts.append(int(run.stdout))
    assert counts == [2, 2]


def test_the_counter_counts_2d_tma_plans_apart(fake_build):
    spec = bench_spec("2d25pt_box")
    box = winner_plan("2d25pt_box")[1]
    star13 = winner_plan("2d13pt_star")[1]
    cross = winner_plan("2d5pt_cross")[1]
    factor = level_plan(analyze(spec, 1), KernelConfig(step=1, factor=True))
    spec3 = bench_spec("3d7pt_star")
    star3 = plan_for("3d7pt_star", spec3.dims)
    kernels.build_plans([(box, spec.dims, dt, False, 132)
                         for dt in codegen.DTYPES]
                        + [(cross, spec.dims, "float32", False, 132),
                           (star13, spec.dims, "float32", False, 132),
                           (factor, spec.dims, "float32", False, 132),
                           (star3, spec3.dims, "float32", False, 132)])
    got = kernels.plan_counters()
    assert (got["builds"], got["partial_2d"], got["tma_2d"],
            got["tma_3d"]) == (6, 4, 2, 1)
    plan = kernels.plan_kernel(box, spec.dims, "float32", sms=132)
    assert plan.tma and plan.maps_encoded() == 0
    for _ in range(10):
        plan.launch(1 << 20, 2 << 20, (), 0)
        plan.launch(2 << 20, 1 << 20, (), 0)
    assert plan.maps_encoded() == 2
    # a plan loaded once counts once; the cross at three CTAs an SM none
    kernels.plan_kernel(box, spec.dims, "float32", sms=132)
    assert kernels.plan_counters()["tma_2d"] == 2
    assert not kernels.plan_kernel(cross, spec.dims, "float32",
                                   sms=132).tma
