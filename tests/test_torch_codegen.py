"""The per-plan kernel text (``drstencil_tpu_torch/ops/codegen.py``).

No card and no ``nvcc`` here, so the text is checked (a) as text — the
literals, the ``fmaf`` order, the constants, the hash, the build path, the
error without a compiler, the agreement of ``tile_shape`` / ``smem_estimate``
/ ``traffic_model`` with it — and (b) as a program: compiled by ``g++``
against two stub headers (``tests/cuda_emulation``: a CTA's threads as
``std::thread``s, ``__syncthreads`` as a barrier, shared memory poisoned
with NaN before each CTA) and held against the plain version, fp32 within
1e-5 relative and bf16 within one bf16 ulp, everything outside the stored
region untouched.
"""

import dataclasses
import hashlib
import itertools
import json
import os
import re
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from drstencil_tpu_torch import emit as emit_mod
from drstencil_tpu_torch.ir.passes import analyze
from drstencil_tpu_torch.ir.spec import StencilSpec, load_stc
from drstencil_tpu_torch.ops import codegen, kernels
from drstencil_tpu_torch.ops.config import KernelConfig
from drstencil_tpu_torch.ops.stream import level_plan
from drstencil_tpu_torch.tune import space
from drstencil_tpu_torch.tune import tuned as tuned_mod
from drstencil_tpu_torch.tune.tuned import best_config
from drstencil_tpu_torch.utils.profiling import traffic_model

from conftest import BENCH_DIR

WINNERS = [
    "2d13pt_star", "2d25pt_box", "2d5pt_cross", "2d5pt_star", "2d9pt_box",
    "2d9pt_cross", "2d9pt_star", "3d13pt_star", "3d27pt_box", "3d7pt_star",
    "3d9pt_cross",
]
# coefficient-fused tables: 13 x 13 = 169 taps of reach 6, 5^3 = 125 of reach 2
BIG_TABLES = {"169_taps": ("2d25pt_box", KernelConfig(step=3)),
              "125_taps": ("3d27pt_box", KernelConfig(step=2))}
N_SHARDS = 4
KERNEL_TOL = 1e-5
EMU_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "cuda_emulation")


@pytest.fixture(autouse=True)
def tpu_winners(monkeypatch, tmp_path):
    """Every test here holds the plans of the JAX package's winners
    (``benchmarks/tuned.json``), whatever the port's committed table picks:
    the port's table is pointed at a missing file, so ``best_config`` falls
    back to them."""
    monkeypatch.setattr(tuned_mod, "TUNED_GPU_PATH",
                        str(tmp_path / "tuned_gpu.json"))


def bench_spec(name, dims=None):
    spec = load_stc(os.path.join(BENCH_DIR, name + ".stc"))
    if dims is None:
        return spec
    return StencilSpec(spec.name, tuple(dims), spec.iterations, spec.taps)


def plan_of(name, cfg=None, dtype="float32"):
    spec = bench_spec(name)
    cfg = (cfg or best_config(name)).replace(dtype=dtype)
    an = analyze(spec, cfg.step, cfg.distance, cfg.merge_forward)
    return spec, cfg, an, level_plan(an, cfg)


def slab_dims(spec, plan):
    return ((spec.dims[0] // N_SHARDS + 2 * plan.frame,)
            + tuple(spec.dims[1:]))


def constants(cuda):
    """Every ``NAME = integer`` of the text's ``constexpr int`` lines."""
    out = {}
    for line in cuda.splitlines():
        if line.startswith("constexpr int "):
            for name, value in re.findall(r"(\w+) = (\d+)\b(?! \*)", line):
                out[name] = int(value)
    out["SMEM_BYTES"] = int(re.search(
        r"static_assert\(SMEM_BYTES == (\d+),", cuda).group(1))
    return out


def level_fn(cuda):
    """The level function of a text and its body: ``level_row`` (the
    partial-sum form of a windowed 2D plan) or ``level_quad``."""
    fn = "level_row" if "void level_row(" in cuda else "level_quad"
    head = "void level_row(" if fn == "level_row" else "float4 level_quad("
    return fn, cuda.split(head)[1].split("\n}")[0]


def tap_lines(cuda):
    """(literal per output cell, tap offset) of the level function's fmaf
    lines, in order: ``a0..a3`` of ``level_quad``, or ``o_<dy>.x..w`` of
    ``level_row``, each line one tap for the quad's four cells."""
    _, body = level_fn(cuda)
    taps = []
    for line in body.splitlines():
        found = re.findall(r"(\w+(?:\.[xyzw])?) = fmaf\((\S+f), [\w.\[\]]+, "
                           r"(\w+(?:\.[xyzw])?)\);", line)
        if found:
            # one tap: a literal into each of the quad's four accumulators
            accs = [a for a, _, _ in found]
            assert accs == [b for _, _, b in found]
            off = tuple(int(v) for v in re.search(
                r"// \((.*)\)$", line).group(1).split(","))
            # level_row's accumulators: the partial sum of the row the tap's
            # row offset feeds
            assert accs in (["a0", "a1", "a2", "a3"], [
                f"o_{codegen._signed(off[0])}.{c}" for c in "xyzw"])
            taps.append(([lit for _, lit, _ in found], off))
    return taps


def check_text(cuda, plan, dims, dtype, shard):
    g = codegen.geometry(plan, dims)
    c = constants(cuda)
    # the literals are the plan's float32 coefficients, the order the
    # table's sorted order: one fmaf per tap and output cell from acc = 0
    taps = tap_lines(cuda)
    assert len(taps) == len(plan.coeffs)
    for (lits, off), want_off, coef in zip(taps, plan.offsets.tolist(),
                                           plan.coeffs.tolist()):
        assert off == tuple(want_off)
        for lit in lits:
            assert emit_mod.literal_value(lit) == float(np.float32(coef))
    assert [off for _, off in taps] == sorted(off for _, off in taps)
    assert cuda.count("= fmaf(") == codegen.QUAD * len(plan.coeffs)
    fn, _ = level_fn(cuda)
    assert (fn == "level_row") == g.partial
    if g.partial:
        # each level opens one partial sum a step, from 0
        assert cuda.count("= make_float4(0.0f, 0.0f, 0.0f, 0.0f);\n"
                          "            level_row(") == plan.levels
    else:
        assert "float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f, a3 = 0.0f;" in cuda
    # one call per level
    assert cuda.count(fn + "(") == plan.levels + 1
    assert "TapTable" not in cuda and "coef" not in cuda
    # the constants are the plan's and the geometry's
    names = ("D", "M", "N")[-len(dims):]
    assert tuple(c[n] for n in names) == tuple(dims)
    assert (c["H"], c["LEVELS"], c["REACH"]) == (plan.frame, plan.levels,
                                                 plan.reach)
    tile = (c["SEG"],) + tuple(c[n] for n in ("TY", "TX")[-(len(dims) - 1):])
    assert tile == g.tile == kernels.tile_shape(plan, dims)
    # a ring per level: 2 * reach + 2 planes; with 3D register windows the
    # planes at the axis-0 offsets of the taps that leave the column, and
    # the one being written; with partial sums 2 * reach + 1 rows, a row's
    # slot named by its step among the 2 * reach + 1 unrolled ones
    leave = [o[0] for o in plan.offsets.tolist() if any(o[1:])]
    shallow = max(leave) - min(leave) + 2
    ring = (shallow if g.window and len(dims) == 3
            else 2 * plan.reach + (1 if g.partial else 2))
    assert (c["HX"], c["EY"], c["EX"], c["RING"], c["GUARD"]) == (
        g.hx, g.ey, g.ex, ring, g.guard)
    assert (c["THREADS"], c["MIN_BLOCKS"]) == (g.threads, g.min_blocks)
    assert "PREFETCH" not in c      # the staging depth is no constant to set
    assert c["SMEM_BYTES"] == g.smem_bytes == kernels.smem_bytes(plan, dims)
    plane = g.ey * g.ex
    if g.tma:
        # the rings, then 128-byte slots, each with an 8-byte mbarrier
        slots = kernels.n_buffers(plan, dims) - plan.levels * c["RING"]
        rings = -(-(2 * g.guard + plan.levels * c["RING"] * plane) // 32) * 32
        assert c["SMEM_BYTES"] == 4 * (rings + slots * (-(-plane // 32) * 32)
                                       ) + 8 * slots
    else:
        assert c["SMEM_BYTES"] == 4 * (2 * g.guard + kernels.n_buffers(
            plan, dims) * plane)
    # a ring per level; windowed 2D plans add their staging rows or TMA
    # slots, windowed 3D plans fed by TMA their slots
    staging = kernels.n_buffers(plan, dims) - plan.levels * c["RING"]
    # 2D: windowed where the windows fit; 3D: where they fit and free ring
    # planes
    assert g.window == (plan.levels * (2 * plan.reach + 1) * 4
                        <= codegen.WINDOW_REGS and (
                            len(dims) == 2 or shallow < 2 * plan.reach + 2))
    if g.tma:
        # 2D: a power of two of slots, at most the cp.async feed's rows
        assert staging == c["AHEAD"] + 1 == (
            codegen.AHEAD_3D + 1 if len(dims) == 3 else 8)
        assert f"cp.async.bulk.tensor.{len(dims)}d" in cuda
        assert "fetch_plane" not in cuda and "Raw st[" not in cuda
        assert "__pipeline_memcpy_async" not in cuda
        assert g.partial or g.window3d
    elif g.window and g.vec and len(dims) == 2:
        assert staging == c["AHEAD"] + 1 == codegen.AHEAD_2D + 1
        assert "__pipeline_memcpy_async" in cuda and "fetch_plane" not in cuda
    else:
        assert staging == 0 and "AHEAD" not in c
        assert "__pipeline_memcpy_async" not in cuda
    assert ("float4 w[LEVELS][WINDOW];" in cuda) == (g.window
                                                      and not g.partial)
    assert ("float4 cur[LEVELS], ps[LEVELS][WINDOW];" in cuda) == g.partial
    assert g.partial == (g.window and len(dims) == 2 and not g.factor)
    assert c["SMEM_BYTES"] <= kernels.SMEM_LIMIT == 227 * 1024
    assert c["HX"] % 4 == 0 and c["EX"] % 4 == 0 and c["TX"] % 4 == 0
    grid = re.search(r"const dim3 grid\(([\d, ]+)\);", cuda).group(1)
    assert tuple(int(v) for v in grid.split(",")) == g.grid
    assert g.grid[-1] * c["SEG"] >= dims[0] - 2 * plan.frame
    # the interface and the storage type
    launch = cuda.split('extern "C" int launch(')[1].split(")")[0]
    assert launch == ("const void* src, void* dst, "
                      + ("int s_lo, int s_hi, " if shard else "")
                      + "void* stream")
    assert ("typedef __nv_bfloat16 T;" in cuda) == (dtype == "bfloat16")
    assert ("__float2bfloat16_rn" in cuda) == (dtype == "bfloat16")


@pytest.mark.parametrize("shard", [False, True], ids=["full", "shard"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", WINNERS)
def test_winner_text(name, dtype, shard):
    spec, cfg, an, plan = plan_of(name, dtype=dtype)
    dims = slab_dims(spec, plan) if shard else tuple(spec.dims)
    cuda = codegen.cuda_source(plan, dims, dtype, shard)
    check_text(cuda, plan, dims, dtype, shard)
    assert cuda == codegen.cuda_source(plan, dims, dtype, shard)


@pytest.mark.parametrize("case", sorted(BIG_TABLES))
def test_large_table_text(case):
    name, cfg = BIG_TABLES[case]
    spec, cfg, an, plan = plan_of(name, cfg)
    assert len(plan.coeffs) == int(case.split("_")[0])
    cuda = codegen.cuda_source(plan, spec.dims, "float32", False)
    check_text(cuda, plan, tuple(spec.dims), "float32", False)
    # the blocking does not grow with the table: a row's loads sit right
    # before its fmafs, so one row's values are live at a time; the
    # partial-sum form reads its arriving row's cells beside the quad
    # once, before every fmaf, whatever the table
    fn, body = level_fn(cuda)
    lines = [ln for ln in body.splitlines()
             if re.match(r"\s+const float[24]? [sdq]_?\w+ = ", ln)
             or "= fmaf(" in ln]
    if fn == "level_row":
        loads = [ln for ln in lines if "= fmaf(" not in ln]
        assert lines[:len(loads)] == loads
        assert 0 < len(loads) <= 2 * (-(-plan.reach // codegen.QUAD))
        return
    loads_in_a_row = max(
        len(list(run)) for is_load, run in itertools.groupby(
            lines, key=lambda ln: "= fmaf(" not in ln) if is_load)
    assert loads_in_a_row <= 2 * (-(-plan.reach // codegen.QUAD)) + 1


@pytest.mark.parametrize("name", WINNERS)
def test_models_describe_the_kernel_that_runs(name):
    """``tile_shape``, ``smem_estimate`` and ``traffic_model`` give the
    text's column, segment, rings and staged planes; the bound stays the
    function's."""
    spec, cfg, an, plan = plan_of(name)
    dims = tuple(spec.dims)
    c = constants(codegen.cuda_source(plan, dims, "float32", False))
    g = codegen.geometry(plan, dims)
    cand = space.smem_estimate(spec, cfg)
    assert cand.tile == g.tile and cand.smem_bytes == c["SMEM_BYTES"]
    model = traffic_model(an, cfg)
    assert model.smem_bytes == c["SMEM_BYTES"]
    cells = int(np.prod(dims))
    interior = dims[0] - 2 * plan.frame
    # every column stages its segments' planes plus 2 * frame per segment
    planes = interior + g.n_segments * 2 * plan.frame
    assert model.read_bytes == 4 * g.n_columns * planes * c["EY"] * c["EX"]
    assert model.write_bytes == 4 * int(np.prod(
        [d - 2 * plan.frame for d in dims]))
    assert model.bound_bytes == 2 * 4 * cells
    assert model.flops == 2 * len(plan.coeffs) * plan.levels * cells
    assert 1.0 < model.read_bytes / (4 * cells) < 1.6
    # segments long enough that the warm-up planes stay a small share
    assert g.warmup / g.tile[0] < 0.15
    half = traffic_model(an, cfg.replace(dtype="bfloat16"))
    assert (half.read_bytes, half.bound_bytes) == (
        model.read_bytes // 2, model.bound_bytes // 2)
    assert half.smem_bytes == model.smem_bytes      # fp32 rings either way


def test_hash_is_stable_and_keyed():
    spec, cfg, an, plan = plan_of("2d5pt_star")
    dims = tuple(spec.dims)
    text = codegen.cuda_source(plan, dims, "float32", False)
    base = codegen.source_hash(text)
    assert base == codegen.source_hash(
        codegen.cuda_source(plan, dims, "float32", False))
    assert base == hashlib.sha256(
        (text + " ".join(codegen.NVCC_FLAGS)).encode()).hexdigest()[:16]
    coeffs = plan.coeffs.copy()
    coeffs[0] = np.nextafter(coeffs[0], np.float32(1))
    offsets = plan.offsets.copy()
    offsets[0] = offsets[0][::-1]
    wider = level_plan(analyze(spec, 2), KernelConfig(step=2, trapezoid=True))
    variants = {
        "dims": (plan, (dims[0], dims[1] // 2), "float32", False),
        "dtype": (plan, dims, "bfloat16", False),
        "shard": (plan, dims, "float32", True),
        "coeffs": (dataclasses.replace(plan, coeffs=coeffs), dims, "float32",
                   False),
        "offsets": (dataclasses.replace(plan, offsets=offsets), dims,
                    "float32", False),
        "levels": (wider, dims, "float32", False),
    }
    hashes = {k: codegen.source_hash(codegen.cuda_source(*v))
              for k, v in variants.items()}
    assert len(set(hashes.values()) | {base}) == len(variants) + 1, hashes
    keys = {kernels.plan_key(*v) for v in variants.values()}
    assert len(keys | {kernels.plan_key(plan, dims, "float32", False)}) \
        == len(variants) + 1
    # a torch dtype and its name are one key
    assert kernels.plan_key(plan, dims, torch.float32) \
        == kernels.plan_key(plan, dims, "float32")


def test_build_path_and_missing_compiler(tmp_path, monkeypatch):
    spec, cfg, an, plan = plan_of("3d7pt_star")
    p = kernels.plan_of(plan, spec.dims, "float32", False)
    root = os.path.dirname(os.path.dirname(os.path.abspath(kernels.__file__)))
    build = os.path.join(os.path.dirname(root), "build")
    assert kernels.BUILD_DIR == build
    assert os.path.dirname(p.path) == os.path.join(build, "plans")
    assert os.path.basename(p.path) \
        == f"plan_{codegen.source_hash(p.text)}.so"
    assert kernels.plan_of(plan, spec.dims, torch.float32, False) is p
    # no compiler: the build raises and names it; nothing falls back
    monkeypatch.setattr(kernels, "PLAN_DIR", str(tmp_path))
    monkeypatch.setattr(kernels, "_PLANS", {})
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no_cuda"))
    with pytest.raises(RuntimeError, match="nvcc"):
        kernels.plan_kernel(plan, spec.dims, "float32")
    with pytest.raises(RuntimeError, match="nvcc"):
        kernels.build_plans([(plan, spec.dims, "float32", False),
                             (plan, spec.dims, "bfloat16", False)])
    assert not [f for f in os.listdir(tmp_path) if f.endswith(".so")]


def test_a_failed_build_raises_with_the_compilers_log(tmp_path, monkeypatch):
    """A stand-in compiler that fails: every plan is tried, the first
    failure is raised with what the compiler printed."""
    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\necho 'error: no such opcode' >&2\n"
                    "exit 3\n")
    fake.chmod(0o755)
    monkeypatch.setattr(kernels, "PLAN_DIR", str(tmp_path / "plans"))
    monkeypatch.setattr(kernels, "_PLANS", {})
    monkeypatch.setenv("PATH", f"{tmp_path}{os.pathsep}{os.environ['PATH']}")
    spec, cfg, an, plan = plan_of("2d9pt_star")
    with pytest.raises(RuntimeError, match=r"nvcc failed \(3\)(.|\n)*no such "
                                           "opcode"):
        kernels.build_plans([(plan, spec.dims, "float32", False),
                             (plan, spec.dims, "bfloat16", False)])
    # both texts were written for the compiler, neither library exists
    left = sorted(os.listdir(tmp_path / "plans"))
    assert len([f for f in left if f.endswith(".cu")]) == 2
    assert not [f for f in left if f.endswith(".so")]


def test_every_plan_stages_ahead_and_prefetch_changes_nothing():
    spec = bench_spec("2d5pt_star")
    an = analyze(spec, 4)
    deep = level_plan(an, KernelConfig(step=4, trapezoid=True))
    flat = level_plan(an, KernelConfig(step=4, trapezoid=True, prefetch=1))
    # the config's prefetch is no part of the plan, its key or its text
    assert not hasattr(deep, "prefetch")
    assert kernels.plan_key(deep, spec.dims, "float32") \
        == kernels.plan_key(flat, spec.dims, "float32")
    staged = codegen.cuda_source(deep, spec.dims, "float32", False)
    assert staged == codegen.cuda_source(flat, spec.dims, "float32", False)

    def order(text, *marks):
        """Whether ``marks`` come in this order in the plane loop (a
        partial-sum text's steps go in an inner loop over ``u``)."""
        body = text.split("++u) {" if "++u) {" in text else "++s) {")[-1]
        at = [body.index(m) for m in marks]
        return at == sorted(at)

    # a windowed 2D plan: rows are requested AHEAD steps ahead by cp.async
    # and staged after the levels, which run last to first, each adding the
    # newest row of the level below to its partial sums
    assert codegen.geometry(deep, spec.dims).partial
    assert codegen.geometry(deep, spec.dims).ahead == codegen.AHEAD_2D
    assert order(staged, "request_plane(src, a0 - H + s + AHEAD",
                 "__pipeline_commit();", "// level 4", "level_row(cur[3]",
                 "// level 1", "level_row(cur[0]",
                 "__pipeline_wait_prior(AHEAD);", "stage_arrived(",
                 "if (q < PLANE_QUADS) cur[0] = raw_to_f32(slot[q]);",
                 "__syncthreads();")
    # a windowed plan without 16-byte access requests into registers
    odd = codegen.cuda_source(deep, (spec.dims[0], spec.dims[1] - 1),
                              "float32", False)
    assert order(odd, "fetch_plane(", "// level 4", "// level 1",
                 "stage_plane(", "cur[0] = raw_to_f32(st[0]);")
    # the others (3D; deep 2D plans) request into registers before the
    # levels and stage after them; a windowed 3D plan (a star table) runs
    # its levels last to first, its planes asked for by TMA AHEAD steps
    # ahead, its quad read from the slot before the levels and staged
    # after, the next plane seen to land before the barrier
    for name in ("3d27pt_box", "2d25pt_box"):
        spec3, _, an3, plan3 = plan_of(name)
        assert not codegen.geometry(plan3, spec3.dims).window
        assert order(codegen.cuda_source(plan3, spec3.dims, "float32", False),
                     "fetch_plane(", "// level 1", f"// level {plan3.levels}",
                     "stage_plane(")
    spec3, _, an3, plan3 = plan_of("3d7pt_star")
    g3 = codegen.geometry(plan3, spec3.dims)
    assert g3.window and g3.tma and g3.ahead == codegen.AHEAD_3D
    assert order(codegen.cuda_source(plan3, spec3.dims, "float32", False),
                 "request_plane(&map, slots, full, s + AHEAD",
                 "own = reinterpret_cast<const Raw*>(slots + s % SLOTS",
                 f"// level {plan3.levels}", "// level 1",
                 "w[0][2] = raw_to_f32(own);",
                 "tma_bar_wait(full + (s + 1) % SLOTS", "__syncthreads();")
    # the space collapses the knob with the other TPU-only ones, and keeps
    # tm: the segment
    rep = space.representative(KernelConfig(step=4, trapezoid=True,
                                            prefetch=1, tm=128), 2)
    assert rep.prefetch == 2 and rep.tm == 128
    assert {c.cfg.prefetch for c in space.default_space(
        bench_spec("2d5pt_star", (64, 256)))} == {2}


def test_narrow_and_odd_grids_get_a_geometry():
    """Any plan ``level_plan`` accepts has a text: a grid narrower than the
    strip, and one whose width is no multiple of 4 (cell-wise access)."""
    spec = bench_spec("2d5pt_star", (64, 250))
    plan = level_plan(analyze(spec, 2), KernelConfig(step=2, trapezoid=True))
    g = codegen.geometry(plan, spec.dims)
    assert not g.vec and g.tile[1] == 252 and g.grid[0] == 1
    cuda = codegen.cuda_source(plan, spec.dims, "float32", False)
    assert "store_quad" not in cuda and "edge_cell" in cuda
    check_text(cuda, plan, tuple(spec.dims), "float32", False)
    vec = codegen.cuda_source(plan, (64, 252), "float32", False)
    assert "store_quad" in vec and "edge_cell" not in vec


# -- (b) the text as a program, under the g++ emulation -------------------------

EMU_RUNNER = """
import ctypes, sys
import numpy as np
lib = ctypes.CDLL(sys.argv[1])
src = np.fromfile(sys.argv[2], dtype=np.uint8)
dst = np.fromfile(sys.argv[3], dtype=np.uint8)
store = [int(v) for v in sys.argv[4:]]
ptr, i32 = ctypes.c_void_p, ctypes.c_int
lib.launch.argtypes = [ptr, ptr] + [i32] * len(store) + [ptr]
lib.launch.restype = i32
err = lib.launch(src.ctypes.data, dst.ctypes.data, *store, None)
dst.tofile(sys.argv[3])
sys.exit(err)
"""


def emulated(cuda, tmp_path):
    """The text compiled by g++ against ``tests/cuda_emulation``'s stubs
    (the kernel launch becomes a loop over CTAs of ``std::thread``s);
    returns ``launch(src, dst, store)``, which runs it in a process of its
    own on the tensors' bytes and returns ``dst``."""
    if shutil.which("g++") is None:
        pytest.skip("no g++ to emulate the kernel text with")
    text = re.sub(r"(\w+)<<<(\w+), (\w+), \w+,\s*\(cudaStream_t\)stream>>>\(\s*",
                  r"EMU_LAUNCH(\1, \2, \3, ", cuda)
    assert "EMU_LAUNCH(stencil_kernel, grid, block, " in text
    # a TMA-fed text's copies and barriers: tests/cuda_emulation/bulk_copy.h
    text = re.sub(r"// ---- TMA bulk copy and mbarrier \(PTX\) -+\n.*?"
                  r"// ---- end of PTX -+\n", '#include "bulk_copy.h"\n',
                  text, flags=re.S)
    text = re.sub(
        r"extern __shared__ (__align__\(128\) )?float4 smem4\[\];",
        "float4* const smem4 = reinterpret_cast<float4*>(g_smem);", text)
    src_path, lib = tmp_path / "kernel.cc", tmp_path / "kernel.so"
    src_path.write_text(text)
    proc = subprocess.run(
        ["g++", "-std=c++20", "-O1", "-ffp-contract=off", "-shared", "-fPIC",
         "-pthread", "-I", EMU_DIR, "-o", str(lib), str(src_path)],
        capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr[-3000:]

    def launch(src, dst, store=()):
        files = [tmp_path / "src.bin", tmp_path / "dst.bin"]
        for t, f in zip((src, dst), files):
            t.contiguous().view(torch.uint8).numpy().tofile(f)
        run = subprocess.run(
            [sys.executable, "-c", EMU_RUNNER, str(lib), *map(str, files),
             *map(str, store)], capture_output=True, text=True, timeout=300)
        assert run.returncode == 0, run.stderr[-3000:]
        out = torch.from_numpy(np.fromfile(files[1], dtype=np.uint8))
        return out.view(dst.dtype).reshape(dst.shape)

    return launch


def bf16_ulp(x):
    _, e = torch.frexp(x.float())
    return torch.where(x != 0, torch.ldexp(torch.ones_like(
        x, dtype=torch.float32), e - 8), torch.zeros_like(
        x, dtype=torch.float32))


def run_emulated(tmp_path, name, dims, dtype="float32", rows=None, cfg=None):
    spec = bench_spec(name, dims)
    cfg = (cfg or best_config(name)).replace(dtype=dtype)
    plan = level_plan(analyze(spec, cfg.step, cfg.distance,
                              cfg.merge_forward), cfg)
    shard = rows is not None
    launch = emulated(codegen.cuda_source(plan, dims, dtype, shard), tmp_path)
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    rng = np.random.default_rng(1)
    src = torch.from_numpy(rng.uniform(0, 100, dims)).to(tdt)
    fill = torch.from_numpy(rng.uniform(-0.5, 0.5, dims)).to(tdt)
    want = fill.clone()
    got = launch(src, fill, [int(v) for v in rows] if shard else [])
    kernels.kernel_for(len(dims), shard).plain(
        src, want, plan, *([rows] if shard else []))
    diff = (got.float() - want.float()).abs()
    top = float(want.float().abs().max())
    assert not got.float().isnan().any()
    if dtype == "float32":
        assert float(diff.max()) <= KERNEL_TOL * top
    else:
        assert bool((diff <= bf16_ulp(want) + KERNEL_TOL * top).all())
    H = plan.frame
    lo, hi = rows if shard else (H, dims[0] - H)
    outside = torch.ones(dims, dtype=torch.bool)
    outside[(slice(lo, max(lo, hi)),)
            + tuple(slice(H, n - H) for n in dims[1:])] = False
    assert torch.equal(got[outside], fill[outside])
    return codegen.geometry(plan, dims)


@pytest.mark.parametrize("name", WINNERS)
def test_emulated_winner_equals_plain(tmp_path, name):
    """Several strips/columns and segments of every winner's plan."""
    dims = (20, 40, 136) if name.startswith("3d") else (
        (80, 1100) if name == "2d25pt_box" else (40, 1100))
    g = run_emulated(tmp_path, name, dims)
    assert int(np.prod(g.grid)) > 1


@pytest.mark.parametrize("name,dims,kw", [
    ("2d9pt_star", (40, 1100), dict(dtype="bfloat16")),
    ("3d27pt_box", (20, 40, 136), dict(dtype="bfloat16")),
    ("2d5pt_star", (40, 1101), dict()),
    ("3d7pt_star", (20, 30, 71), dict(dtype="bfloat16")),
    ("2d5pt_star", (24, 200), dict(dtype="bfloat16")),
    ("3d13pt_star", (12, 20, 40), dict(dtype="bfloat16")),
    ("2d25pt_box", (60, 600), dict(cfg=KernelConfig(step=3))),
    ("3d27pt_box", (24, 30, 72), dict(cfg=KernelConfig(step=2))),
    ("2d5pt_star", (40, 600), dict(cfg=KernelConfig(step=4, trapezoid=True,
                                                    block=2))),
], ids=["bf16_2d", "bf16_3d", "odd_width_2d", "odd_width_bf16_3d",
        "narrow_bf16_2d", "one_column_bf16_3d", "169_taps", "125_taps", "block"])
def test_emulated_variants_equal_plain(tmp_path, name, dims, kw):
    run_emulated(tmp_path, name, dims, **kw)


def hopper_winner(name):
    """``name``'s entry of the port's committed table (read directly: the
    fixture above points ``best_config`` at the JAX winners)."""
    with open(os.path.join(os.path.dirname(tuned_mod.__file__),
                           "tuned_gpu.json")) as f:
        return KernelConfig.from_dict(json.load(f)[name]["config"])


@pytest.mark.parametrize("name", WINNERS)
@pytest.mark.parametrize("shard", [False, True], ids=["grid", "shard"])
def test_emulated_hopper_winners_equal_plain(tmp_path, name, shard):
    """The plans of the card's winners (``tune/tuned_gpu.json``) under the
    emulation: a small grid in fp32, and a shard slab's first store range
    (a frame's worth of rows left to the neighbour) in bf16."""
    cfg = hopper_winner(name)
    spec = bench_spec(name)
    H = level_plan(analyze(spec, cfg.step, cfg.distance, cfg.merge_forward),
                   cfg).frame
    rest = (600,) if spec.ndim == 2 else (30, 72)
    if shard:
        run_emulated(tmp_path, name, (24 + 2 * H,) + rest, "bfloat16",
                     rows=(2 * H, 24 + H), cfg=cfg)
    else:
        run_emulated(tmp_path, name, (40 + 2 * H,) + rest, "float32", cfg=cfg)


@pytest.mark.parametrize("name,dims,dtype,rows", [
    ("2d5pt_star", (40, 1100), "float32", (4, 36)),     # every local row
    ("2d5pt_star", (40, 1100), "float32", (8, 36)),     # the first shard
    ("2d5pt_star", (40, 1100), "bfloat16", (4, 32)),    # the last shard
    ("2d5pt_star", (40, 1100), "float32", (10, 10)),    # nothing
    # a strip narrower than its warps: more threads than quads
    ("2d5pt_star", (24, 200), "float32", (4, 20)),
    ("3d7pt_star", (20, 30, 72), "bfloat16", (3, 17)),
    ("3d7pt_star", (20, 30, 72), "float32", (6, 17)),
    ("3d7pt_star", (20, 30, 72), "float32", (3, 14)),
], ids=["2d_all", "2d_first", "2d_last_bf16", "2d_empty", "2d_narrow",
        "3d_all_bf16",
        "3d_first", "3d_last"])
def test_emulated_shard_ranges_equal_plain(tmp_path, name, dims, dtype, rows):
    run_emulated(tmp_path, name, dims, dtype, rows)


# -- the wrappers and the timing script around the plans -------------------------

class _FakeTensor:
    """What ``LevelsKernel._launch`` reads of a CUDA tensor."""

    def __init__(self, shape, dtype, ptr):
        self.shape, self.dtype, self._ptr = torch.Size(shape), dtype, ptr
        self.device = torch.device("cuda", 0)

    def data_ptr(self):
        return self._ptr


def test_wrapper_keys_a_plan_once(monkeypatch):
    """A launch finds its plan's kernel by the identity of the ``LevelTaps``
    it was given: ``plan_kernel`` (which keys the table's bytes under a
    lock) is asked once per (plan, shape, dtype), not per launch; and a
    quad-access kernel refuses a misaligned tensor."""
    spec, cfg, an, plan = plan_of("2d5pt_star")
    asked, launched = [], []

    class FakePlan:
        geometry = codegen.geometry(plan, spec.dims)

        def launch(self, *args):
            launched.append(args)

    def fake_plan_kernel(taps, dims, dtype, shard=False):
        asked.append((taps, tuple(dims), dtype, shard))
        return FakePlan()

    monkeypatch.setattr(kernels, "plan_kernel", fake_plan_kernel)
    kernel = kernels.LevelsKernel("probe", 2, None, "nowhere")
    src = _FakeTensor(spec.dims, torch.float32, 1 << 20)
    dst = _FakeTensor(spec.dims, torch.float32, 1 << 30)
    for _ in range(3):
        kernel._launch(src, dst, plan, (), 7)
    assert len(asked) == 1 and len(launched) == 3
    assert launched[0] == (1 << 20, 1 << 30, (), 7)
    half = _FakeTensor(spec.dims, torch.bfloat16, 1 << 20)
    kernel._launch(half, half, plan, (), 7)
    twin = dataclasses.replace(plan)        # equal fields, another object
    kernel._launch(src, dst, twin, (), 7)
    assert [a[2] for a in asked] == [torch.float32, torch.bfloat16,
                                     torch.float32]
    assert asked[2][0] is twin
    assert FakePlan.geometry.vec
    with pytest.raises(ValueError, match="16-byte aligned"):
        kernel._launch(_FakeTensor(spec.dims, torch.float32, (1 << 20) + 4),
                       dst, plan, (), 7)


def test_every_levels_factor_and_tile2d_kernel_comes_from_codegen():
    """No kernel is table-driven any more: the levels kernels, the factor
    kernel and ``tile2d_fused`` are ``codegen``'s text, built per plan (no
    ``.cu`` library behind them, no table passed at launch); ``csrc`` keeps
    only the overlap probe."""
    csrc = os.path.dirname(kernels.EXPERIMENTS_SOURCE)
    assert sorted(os.listdir(csrc)) == ["experiments.cu"]
    with open(kernels.EXPERIMENTS_SOURCE) as f:
        text = f.read()
    exported = re.findall(r"^(?:int|const char\*) (\w+)\(", text, flags=re.M)
    assert sorted(exported) == ["experiments_error_string",
                                "experiments_limit", "overlap_probe",
                                "overlap_probe_info"]
    assert "tile2d" not in text.split("// overlap_probe replaces")[1]
    by_source = {}
    for k in kernels.KERNELS:
        by_source.setdefault(k.source, []).append(k.name)
    assert by_source == {
        "drstencil_tpu_torch/ops/codegen.py": [
            "stencil2d_levels", "stencil3d_levels", "stencil2d_levels_shard",
            "stencil3d_levels_shard", "stencil2d_factor_levels",
            "stencil2d_factor_levels_shard", "tile2d_fused"],
        "drstencil_tpu_torch/csrc/experiments.cu": ["overlap_probe"]}
    for k in kernels.KERNELS:
        assert (k.library is None) == k.source.endswith("codegen.py")
    spec, cfg, an, plan = plan_of("2d25pt_box", KernelConfig(step=2,
                                                             factor=True))
    fac = codegen.cuda_source(plan, spec.dims, "float32", False)
    taps = kernels.tile2d_taps(analyze(spec, 2).fused, 4)
    tile = codegen.tile2d_source(taps, 256, 512, 32)
    for cuda in (fac, tile):
        assert ('extern "C" int launch(const void* src, void* dst, '
                "void* stream)") in cuda
        assert "Table" not in cuda and "coef" not in cuda


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernel_times_plans_and_build_report(dtype, monkeypatch):
    """The timing script's plans are the winners' (the ones the main path
    builds), and its build report asks for them in one ``build_plans``
    call — or reports nothing in a tree without per-plan builds."""
    from drstencil_tpu_torch.utils import kernel_times

    asked = []

    class Built:
        build_seconds = 1.5

        def __init__(self, request):
            self.geometry = codegen.geometry(request[0], request[1])

        def ptxas(self):
            return {"registers": 64, "spill_bytes": 0}

    def fake_build_plans(requests):
        asked.append(list(requests))
        return [Built(r) for r in requests]

    monkeypatch.setattr(kernels, "build_plans", fake_build_plans)
    report = kernel_times.build_report(WINNERS, dtype)
    (requests,) = asked
    assert sorted(report) == WINNERS and len(requests) == len(WINNERS)
    for name, (plan, dims, dt, shard) in zip(WINNERS, requests):
        spec, cfg, an, want = plan_of(name, dtype=dtype)
        assert (tuple(dims), dt, shard) == (tuple(spec.dims), dtype, False)
        assert kernels.plan_key(plan, dims, dt) \
            == kernels.plan_key(want, spec.dims, dtype)
        assert report[name] == {
            "seconds": 1.5, "tile": list(kernels.tile_shape(want, spec.dims)),
            "smem_bytes": kernels.smem_bytes(want, spec.dims),
            "registers": 64, "spill_bytes": 0}
    monkeypatch.delattr(kernels, "build_plans")
    assert kernel_times.build_report(WINNERS, dtype) == {}
