"""Partial sums in the windowed 2D text (``_partial_row`` and
``_partial_level`` of ``drstencil_tpu_torch/ops/codegen.py``).

A windowed 2D plan's thread keeps, for every level, the partial sums of the
``2 * reach + 1`` output rows an arriving row of the level below feeds; it
reads that row's cells beside its quad once and adds each tap row of the
table to the sum of the row it feeds.  Rows arrive in increasing order, so
every output cell's ``fmaf`` chain must run over the table in its sorted order
from 0, as the gather text's did: that is followed here through the text's
schedule (the unrolled steps, the slots of the sums, the rings) for every 2D
winner in both dtypes, and a swapped pair of taps or of sums fails it.  Then
the loads (each arriving row's cells beside the quad read once a level), the
text under the ``g++`` emulation bit for bit equal to the ring text of the
same plan (``codegen.WINDOW_REGS`` at 0), and the plan cache's counter
``partial_2d``.
"""

import json
import os
import re

import numpy as np
import pytest
import torch

from drstencil_tpu_torch.ir.passes import analyze
from drstencil_tpu_torch.ops import codegen, kernels
from drstencil_tpu_torch.ops.config import KernelConfig
from drstencil_tpu_torch.ops.stream import level_plan, state_dtype
from drstencil_tpu_torch.tune import tuned as tuned_mod

from test_torch_codegen import bench_spec, constants, emulated
from test_torch_window3d import counters  # noqa: F401 (a fixture)

with open(os.path.join(os.path.dirname(tuned_mod.__file__),
                       "tuned_gpu.json")) as _f:
    WINNERS_2D = {name: KernelConfig.from_dict(e["config"])
                  for name, e in json.load(_f).items()
                  if name.startswith("2d")}


def winner_plan(name, dtype="float32", dims=None):
    cfg = WINNERS_2D[name].replace(dtype=dtype)
    spec = bench_spec(name, dims)
    return spec, level_plan(analyze(spec, cfg.step, cfg.distance,
                                    cfg.merge_forward), cfg)


# -- the text, read back ------------------------------------------------------

def level_row_of(cuda):
    """``level_row``'s arguments for the partial sums (``o_<dy>``, in
    order), the cell each loaded name holds (relative x: ``own`` is the
    quad's own 0..3), and its fmaf terms in order as (sum, component,
    literal, cell)."""
    head, body = cuda.split("void level_row(")[1].split(") {\n", 1)
    body = body.split("\n}")[0]
    sums = re.findall(r"float4& (o_\w+)", head)
    cells = {f"own.{c}": j for j, c in enumerate("xyzw")}
    for kind, name, first in re.findall(
            r"const (float[24]?) (\w+) = .*\(?b(?: \+ at \+ |\[at \+ )"
            r"\((-?\d+)\)", body):
        width = {"float": 1, "float2": 2, "float4": 4}[kind]
        if width == 1:
            cells[name] = int(first)
        for k in range(width if width > 1 else 0):
            cells[f"{name}.{'xyzw'[k]}"] = int(first) + k
    terms = []
    for acc, comp, lit, src in re.findall(
            r"(o_\w+)\.([xyzw]) = fmaf\((\S+f), ([\w.]+), \1\.\2\);", body):
        terms.append((acc, "xyzw".index(comp), lit, cells[src]))
    return sums, cells, terms


LEVEL_BLOCK = re.compile(
    r"\{  // level (\d+) of \d+:.*?\n"
    r"\s+const int p = s - (\d+);\n.*?"
    r"if \(p >= (-?\d+) && p < n0 \+ (\d+)\) \{\n"
    r"\s+const float\* const b = smem \+ \((\d+) \* RING \+ \(u \+ (\d+)\) % "
    r"RING\) \* PLANE;\n.*?"
    r"ps\[(\d+)\]\[\(u \+ (\d+)\) % WINDOW\] = make_float4\(0.0f, 0.0f, 0.0f,"
    r" 0.0f\);\n\s+level_row\(cur\[(\d+)\], b, 4 \* q, ([^;]*)\);\n"
    r"\s+if \(p < (\d+)\) continue;.*?\n"
    r"\s+const float4 v = ps\[(\d+)\]\[\(u \+ (\d+)\) % WINDOW\];\n"
    r"(.*?)\} while \(0\);", re.S)


def schedule_of(cuda):
    """Each level's block of a step, in the text's order: (level, lag,
    first arriving p, end of p past n0, ring read: (level, place), the
    sum opened, the sums passed, its first row, the sum stored, the ring
    written: place or None)."""
    out = []
    for m in LEVEL_BLOCK.finditer(cuda):
        (t, lag, lo, hi, rl, rp, zl, zp, cl, args, first, vl, vp,
         rest) = m.groups()
        t = int(t)
        assert int(rl) == int(zl) == int(cl) == int(vl) == t - 1
        passed = [(int(a), int(b)) for a, b in re.findall(
            r"ps\[(\d+)\]\[\(u \+ (\d+)\) % WINDOW\]", args)]
        assert {a for a, _ in passed} == {t - 1}
        store = re.search(r"smem \+ \((\d+) \* RING \+ \(u \+ (\d+)\) % "
                          r"RING\) \* PLANE \+ 4 \* q\) = v;\n"
                          r"\s+cur\[(\d+)\] = v;", rest)
        if store:
            assert int(store.group(1)) == int(store.group(3)) == t
        out.append((t, int(lag), int(lo), int(hi), int(rp), int(zp),
                    [b for _, b in passed], int(first), int(vp),
                    int(store.group(2)) if store else None))
    return out


# rows of the segment the schedule is followed on: several turns of the
# widest rotation (13 sums, reach 6)
N0 = 3 * 13 + 5


GARBAGE = "garbage"


def follow_chains(cuda):
    """Run the text's schedule on a segment of ``N0`` rows: the rows each
    ring slot and ``cur[t]`` hold, and each partial sum's terms (a sum not
    yet opened holds ``GARBAGE``: what the registers held before).
    Returns, per level and stored row, the four cells' chains as (row
    offset, x offset, literal) in the order of their fmafs."""
    c = constants(cuda)
    r, L, H = c["REACH"], c["LEVELS"], c["H"]
    W = 2 * r + 1
    assert "constexpr int WINDOW = 2 * REACH + 1;" in cuda
    assert c["RING"] == W
    # the source row s lands in ring slot s % RING: the TMA feed names it
    # by the step's place u, equal since the steps go WINDOW at a time
    assert "stage_arrived(smem + (s % RING) * PLANE" in cuda \
        or "stage_plane(smem + (s % RING) * PLANE" in cuda \
        or ("stage_arrived(smem + u * PLANE" in cuda
            and "s0 += WINDOW) {" in cuda)
    sums, _, terms = level_row_of(cuda)
    blocks = schedule_of(cuda)
    assert [b[0] for b in blocks] == list(range(L, 0, -1))
    ring = {t: [None] * W for t in range(L)}     # row held by each slot
    cur = {t: None for t in range(L)}
    ps = {t: [(GARBAGE, [])] * W for t in range(L)}  # (row, terms) a sum
    chains = {t: {} for t in range(1, L + 1)}
    n0 = N0
    steps = n0 + 2 * H + L
    for s in range(-(-steps // W) * W):
        u = s % W
        for (t, lag, lo, hi, rp, zp, passed, first, vp, wp) in blocks:
            p = s - lag
            if not (lo <= p < n0 + hi):
                continue
            row = ring[t - 1][(u + rp) % W]
            assert row == cur[t - 1] == p + r        # the arriving row
            ps[t - 1][(u + zp) % W] = (None, [])
            slots = [(u + k) % W for k in passed]
            for k, (acc, j, lit, cell) in enumerate(terms):
                dy = int(acc[3:]) * (-1 if acc[2] == "m" else 1)
                slot = slots[sums.index(acc)]
                held = ps[t - 1][slot]
                out = row - dy                      # the row the tap feeds
                assert held[0] in (None, out, GARBAGE)
                ps[t - 1][slot] = (held[0] if held[0] == GARBAGE else out,
                                   held[1] + [(j, row - out, cell - j, lit)])
            if p < first:
                continue
            done, got = ps[t - 1][(u + vp) % W]
            assert done == p
            chains[t][p] = [[(dy, dx, lit) for jj, dy, dx, lit in got
                             if jj == j] for j in range(4)]
            if wp is not None:
                ring[t][(u + wp) % W] = p
                cur[t] = p
        if s < n0 + 2 * H:
            ring[0][s % W] = s
            cur[0] = s
    return chains


def check_chains(cuda, plan):
    """Every stored row of every level: each cell's chain is the table in
    its sorted order, one fmaf a tap, with the tap's float32 literal."""
    want = [(dy, dx, codegen.float32_literal(cf)) for (dy, dx), cf in zip(
        plan.offsets.tolist(), plan.coeffs.tolist())]
    assert [w[:2] for w in want] == sorted(w[:2] for w in want)
    chains = follow_chains(cuda)
    c = constants(cuda)
    for t in range(1, c["LEVELS"] + 1):
        # every row of the level's range [t * reach, n0 + 2H - t * reach)
        assert sorted(chains[t]) == list(range(
            t * c["REACH"], N0 + 2 * c["H"] - t * c["REACH"]))
        for p, cells in chains[t].items():
            for chain in cells:
                assert chain == want, (t, p)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(WINNERS_2D))
def test_fmaf_chains_follow_the_sorted_table(name, dtype):
    spec, plan = winner_plan(name, dtype)
    g = codegen.geometry(plan, spec.dims)
    assert g.partial
    check_chains(codegen.cuda_source(plan, spec.dims, dtype, False), plan)


def swap_lines(cuda, first, second):
    lines = cuda.split("\n")
    i, j = lines.index(first), lines.index(second)
    lines[i], lines[j] = lines[j], lines[i]
    return "\n".join(lines)


@pytest.mark.parametrize("what", ["taps in a row", "tap rows",
                                  "partial sums"])
def test_a_swapped_pair_fails(what):
    spec, plan = winner_plan("2d25pt_box")
    cuda = codegen.cuda_source(plan, spec.dims, "float32", False)
    check_chains(cuda, plan)
    taps = [ln for ln in cuda.split("\n") if ln.startswith("  o_")]
    if what == "taps in a row":         # (-2, -2) and (-2, -1)
        bad = swap_lines(cuda, taps[0], taps[1])
    elif what == "tap rows":            # the first taps of rows -2 and -1
        bad = swap_lines(cuda, taps[0], taps[5])
    else:                               # two sums passed to level_row
        call = re.search(r"level_row\(cur\[2\], b, 4 \* q, (.*)\);", cuda)
        args = call.group(1).split(", ")
        args[0], args[1] = args[1], args[0]
        bad = cuda.replace(call.group(1), ", ".join(args))
    assert bad != cuda
    with pytest.raises(AssertionError):
        check_chains(bad, plan)


# -- one read of each arriving row a level ------------------------------------

@pytest.mark.parametrize("name", sorted(WINNERS_2D) + ["169_taps"])
def test_each_arriving_row_is_read_once_a_level(name):
    """``level_row`` loads each cell beside the quad that a tap reads once
    (a float, an aligned float2, or a float4 where a block needs more), and
    each level reads the ring once a step, through one ``level_row`` call:
    per level and step as many shared loads as the blocks of four cells
    beside the quad that the taps reach, where the gather text read that
    many for every tap row."""
    if name == "169_taps":
        cfg = KernelConfig(step=3)
        spec = bench_spec("2d25pt_box")
        plan = level_plan(analyze(spec, 3), cfg)
    else:
        spec, plan = winner_plan(name)
    cuda = codegen.cuda_source(plan, spec.dims, "float32", False)
    _, cells, _ = level_row_of(cuda)
    loaded = sorted(v for k, v in cells.items() if not k.startswith("own"))
    need = sorted({j + dx for dx in plan.offsets[:, 1].tolist()
                   for j in range(4)} - {0, 1, 2, 3})
    # each cell a tap reads loaded once (a float4 may bring one it does
    # not need)
    assert set(need) <= set(loaded) and len(set(loaded)) == len(loaded)
    body = cuda.split("void level_row(")[1].split("\n}")[0]
    loads = re.findall(r"\b(b\[at|b \+ at)", body)
    blocks = {j // 4 for j in need}
    assert len(loads) == len(blocks) <= 2 * -(-plan.reach // 4)
    # a level block reads shared memory only through its one level_row call
    kernel = cuda.split("__global__")[1]
    for block in LEVEL_BLOCK.finditer(kernel):
        text = block.group(0)
        assert text.count("level_row(") == 1
        assert text.count("const float* const b = smem") == 1
        assert "b_m" not in text and "b_p" not in text
    assert kernel.count("level_row(") == plan.levels
    # the gather text read, for every output row, the blocks beside the
    # quad that each tap row reaches: fewer loads wherever more than one
    # tap row reaches beside the quad (box and cross tables, not stars)
    by_row = {}
    for dy, dx in plan.offsets.tolist():
        by_row.setdefault(dy, set()).update(
            (j + dx) // 4 for j in range(4) if not 0 <= j + dx < 4)
    gather = sum(len(b) for b in by_row.values())
    assert len(loads) <= gather
    assert (len(loads) < gather) == (sum(map(bool, by_row.values())) > 1)


# -- bit for bit the ring text under the emulation ----------------------------

def bits(t):
    return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)


@pytest.mark.parametrize("name,dtype,build", [
    ("2d25pt_box", "float32", "grid"), ("2d25pt_box", "bfloat16", "grid"),
    ("2d25pt_box", "float32", "shard"), ("2d25pt_box", "bfloat16", "odd"),
    ("2d5pt_cross", "float32", "grid"), ("2d13pt_star", "bfloat16", "shard"),
    ("2d9pt_star", "float32", "narrow"), ("169_taps", "float32", "grid"),
])
def test_partial_sums_equal_the_ring_text(tmp_path, name, dtype, build):
    """Several strips and segments of a grid, a shard slab's first store
    range, a grid of odd width (cell-wise access, the register feed) and a
    strip narrower than its warps."""
    if name == "169_taps":
        stc, cfg = "2d25pt_box", KernelConfig(step=3, dtype=dtype)
    else:
        stc, cfg = name, WINNERS_2D[name].replace(dtype=dtype)
    dims, rows = {"grid": ((56, 1100), None), "shard": ((60, 600), (24, 48)),
                  "odd": ((44, 601), None), "narrow": ((40, 200), None)}[build]
    plan = level_plan(analyze(bench_spec(stc, dims), cfg.step, cfg.distance,
                              cfg.merge_forward), cfg)
    if rows:
        rows = (2 * plan.frame, dims[0] - plan.frame)
    shard = rows is not None
    assert codegen.geometry(plan, dims).partial
    rng = np.random.default_rng(7)
    src = torch.from_numpy(rng.uniform(0, 100, dims)).to(state_dtype(dtype))
    fill = torch.from_numpy(rng.uniform(-1, 1, dims)).to(state_dtype(dtype))
    store = list(rows) if shard else []
    for d in ("p", "r"):
        (tmp_path / d).mkdir()
    got = emulated(codegen.cuda_source(plan, dims, dtype, shard),
                   tmp_path / "p")(src, fill.clone(), store)
    with pytest.MonkeyPatch.context() as m:
        m.setattr(codegen, "WINDOW_REGS", 0)
        assert not codegen.geometry(plan, dims).window
        want = emulated(codegen.cuda_source(plan, dims, dtype, shard),
                        tmp_path / "r")(src, fill.clone(), store)
    assert not got.float().isnan().any()
    assert torch.equal(bits(got), bits(want))


# -- the counter --------------------------------------------------------------

def test_the_plan_counters_count_partial_sum_plans(counters):  # noqa: F811
    spec, plan = winner_plan("2d25pt_box")
    kernels.build_plans([(plan, spec.dims, "float32", False, 132),
                         (plan, spec.dims, "bfloat16", False, 132)])
    got = kernels.plan_counters()
    assert (got["builds"], got["partial_2d"], got["windowed_2d"]) == (2, 2, 2)


def test_the_counter_leaves_out_factor_plans(counters):  # noqa: F811
    spec = bench_spec("2d25pt_box")
    plan = level_plan(analyze(spec, 2), KernelConfig(step=2, factor=True))
    g = codegen.geometry(plan, spec.dims)
    assert g.factor and g.window and not g.partial
    kernels.plan_kernel(plan, spec.dims, "float32", False, sms=132)
    got = kernels.plan_counters()
    assert (got["builds"], got["windowed_2d"], got["partial_2d"]) == (1, 1, 0)


def test_the_counter_leaves_out_3d_plans(counters):  # noqa: F811
    spec = bench_spec("3d7pt_star")
    star = level_plan(analyze(spec, 4), KernelConfig(step=4, trapezoid=True))
    box = level_plan(analyze(bench_spec("3d27pt_box"), 2),
                     KernelConfig(step=2, trapezoid=True))
    assert codegen.geometry(star, spec.dims).window3d
    kernels.build_plans([(star, spec.dims, "float32", False, 132),
                         (box, spec.dims, "float32", False, 132)])
    got = kernels.plan_counters()
    assert (got["builds"], got["windowed_3d"], got["partial_2d"]) == (2, 1, 0)
