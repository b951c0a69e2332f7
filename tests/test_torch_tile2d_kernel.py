"""``tile2d_fused``'s per-table text (``ops/codegen.tile2d_source``).

No card and no ``nvcc`` here, so the text is checked as text (per column
shift a multiply then ``fmaf``s in ascending ``di``, the shifts' sums
added in ascending ``dj``: the TPU kernel's order; the literals; the
constants; a geometry that ``tm`` does not change) and as a program under
the ``g++`` emulation of ``tests/test_torch_codegen.py``, held against the
plain version within 1e-5 relative on the sweep's four tables at small
sizes, with columns wrapping, on grids narrower than the strip and widths
that are no multiple of 4, pad rows of the destination untouched; one case
is held against the JAX experiment in interpret mode.
"""

import importlib
import os
import re
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from drstencil_tpu_torch import convert
from drstencil_tpu_torch import emit as emit_mod
from drstencil_tpu_torch.ir.passes import analyze
from drstencil_tpu_torch.ops import codegen, kernels

from conftest import small_spec
from test_torch_codegen import EMU_DIR, EMU_RUNNER, KERNEL_TOL, bench_spec

# the sweep's four tables: (stencil, step) -> fused taps
TABLES = {"5pt_fu2": ("2d5pt_star", 2, 13), "5pt_fu4": ("2d5pt_star", 4, 41),
          "9pt_fu2": ("2d9pt_star", 2, 33), "25pt_fu2": ("2d25pt_box", 2, 81)}


def table(case):
    name, step, ntaps = TABLES[case]
    an = analyze(bench_spec(name), step=step, require_partition=False)
    taps = kernels.tile2d_taps(an.fused, an.halo)
    assert taps.ntaps == ntaps
    return taps


def quad_lines(cuda):
    """(group, literal, first, tap) of ``tile_quad``'s lines, in order."""
    body = cuda.split("float4 tile_quad(")[1].split("return make_float4")[0]
    out = []
    for line in body.splitlines():
        mul = re.findall(r"g(\d+)_(\d) = __fmul_rn\((\S+f), [\w.]+\);", line)
        fma = re.findall(r"g(\d+)_(\d) = fmaf\((\S+f), [\w.]+, g(\d+)_(\d)\);",
                         line)
        if mul or fma:
            assert not (mul and fma)
            found = mul or [(k, j, lit) for k, j, lit, _, _ in fma]
            assert [j for _, j, _ in found] == [str(j) for j in range(4)]
            assert len({k for k, _, _ in found}) == 1
            tap = tuple(int(v) for v in re.search(r"// \((.*)\)$",
                                                  line).group(1).split(","))
            out.append((int(found[0][0]), found[0][2], bool(mul), tap))
    return out


@pytest.mark.parametrize("case", sorted(TABLES))
def test_tile2d_text_keeps_the_tpu_kernels_order(case):
    taps = table(case)
    cuda = codegen.tile2d_source(taps, 8192, 8192, 128)
    lines = quad_lines(cuda)
    assert len(lines) == taps.ntaps
    for k, (dj, rows) in enumerate(taps.groups):
        mine = [(lit, first, tap) for g, lit, first, tap in lines if g == k]
        # ascending di within the shift, the first term a multiply
        assert [tap for _, _, tap in mine] == [(di, dj) for di, _ in rows]
        assert [first for _, first, _ in mine] == [True] + [False] * (
            len(rows) - 1)
        assert [emit_mod.literal_value(lit) for lit, _, _ in mine] == [
            float(np.float32(c)) for _, c in rows]
    # rows outside, shifts inside: the taps in ascending (di, dj)
    assert [tap for _, _, _, tap in lines] == sorted(
        tap for _, _, _, tap in lines)
    # the shifts' sums added in ascending dj
    n = len(taps.groups)
    assert "return make_float4(" + ", ".join(
        " + ".join(f"g{k}_{j}" for k in range(n)) for j in range(4)) + ");" \
        in cuda
    assert cuda.count("= fmaf(") == 4 * (taps.ntaps - n)
    assert cuda.count("__fmul_rn(") == 4 * n
    assert "coef" not in cuda and "Table" not in cuda


@pytest.mark.parametrize("case", sorted(TABLES))
def test_tile2d_geometry_is_the_texts_and_not_tms(case):
    taps = table(case)
    g = codegen.tile2d_geometry(taps, 8192, 8192, 128)
    cuda = codegen.tile2d_source(taps, 8192, 8192, 128)
    c = {n: int(v) for n, v in re.findall(r"\b([A-Z_]+) = (\d+)\b", cuda)}
    assert (c["R"], c["C"], c["TM"], c["H"]) == (8192, 8192, 128, taps.halo)
    assert (c["SEG"], c["TX"]) == g.tile and c["HX"] == g.hx == -(
        -taps.halo // 4) * 4
    assert c["EX"] == g.ex == codegen.STRIP_2D[0] == g.tile[1] + 2 * g.hx
    assert c["AHEAD"] == codegen.AHEAD_2D
    assert "constexpr int ROWS = 2 * H + 2 + AHEAD;" in cuda
    assert g.ring == 2 * taps.halo + 2 + codegen.AHEAD_2D
    assert re.search(r"SMEM_BYTES == (\d+)", cuda).group(1) == str(
        g.smem_bytes) and g.smem_bytes == 4 * g.ring * g.ex
    assert (c["THREADS"], c["MIN_BLOCKS"]) == (g.threads, g.min_blocks)
    grid = re.search(r"const dim3 grid\(([\d, ]+)\);", cuda).group(1)
    assert tuple(int(v) for v in grid.split(",")) == g.grid
    assert g.grid[0] * g.tile[1] >= 8192 and g.grid[1] * g.tile[0] >= 8192
    # every strip's segments plus 2 * h rows each, EX wide
    assert g.read_cells() == g.grid[0] * g.ex * (8192 + 2 * taps.halo
                                                 * g.n_segments)
    # tm places the data rows and changes nothing else
    other = codegen.tile2d_geometry(taps, 8192, 8192, 256)
    assert (other.tile, other.smem_bytes, other.grid) == (g.tile,
                                                          g.smem_bytes,
                                                          g.grid)
    assert codegen.tile2d_source(taps, 8192, 8192, 256).replace(
        "TM = 256", "TM = 128") == cuda
    # a table's plan is keyed by layout and table, built per plan
    p = kernels.tile2d_plan(taps, (8192 + 256, 8192), 128)
    assert p is kernels.tile2d_plan(taps, (8192 + 256, 8192), 128)
    assert p is not kernels.tile2d_plan(taps, (8192 + 512, 8192), 256)
    assert os.path.dirname(p.path) == kernels.PLAN_DIR
    assert p.text == cuda and p.geometry == g


def emulated_tile2d(cuda, tmp_path):
    """``tile2d_source``'s text compiled by g++ against the stubs;
    returns ``launch(src, dst)`` on the tensors' bytes."""
    if shutil.which("g++") is None:
        pytest.skip("no g++ to emulate the kernel text with")
    text = re.sub(r"(\w+)<<<(\w+), (\w+), \w+,\s*\(cudaStream_t\)stream>>>"
                  r"\(\s*", r"EMU_LAUNCH(\1, \2, \3, ", cuda)
    assert "EMU_LAUNCH(tile2d_kernel, grid, block, " in text
    text = text.replace(
        "extern __shared__ float4 smem4[];",
        "float4* const smem4 = reinterpret_cast<float4*>(g_smem);")
    src_path, lib = tmp_path / "tile.cc", tmp_path / "tile.so"
    src_path.write_text(text)
    proc = subprocess.run(
        ["g++", "-std=c++20", "-O1", "-ffp-contract=off", "-shared", "-fPIC",
         "-pthread", "-I", EMU_DIR, "-o", str(lib), str(src_path)],
        capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr[-3000:]

    def launch(src, dst):
        files = [tmp_path / "src.bin", tmp_path / "dst.bin"]
        for t, f in zip((src, dst), files):
            t.contiguous().numpy().tofile(f)
        run = subprocess.run([sys.executable, "-c", EMU_RUNNER, str(lib),
                              *map(str, files)], capture_output=True,
                             text=True, timeout=300)
        assert run.returncode == 0, run.stderr[-3000:]
        return torch.from_numpy(np.fromfile(files[1], dtype=np.float32)
                                ).reshape(dst.shape)

    return launch


def run_emulated(tmp_path, case, R, C, tm):
    """The text against the plain version: a random source whose pad rows
    are random too (read as the layout holds them), a random destination
    whose pad rows must come back bit for bit."""
    taps = table(case)
    launch = emulated_tile2d(codegen.tile2d_source(taps, R, C, tm), tmp_path)
    rng = np.random.default_rng(3)
    src = torch.from_numpy(rng.uniform(0, 100, (R + 2 * tm, C))).float()
    fill = torch.from_numpy(rng.uniform(-0.5, 0.5, (R + 2 * tm, C))).float()
    got = launch(src, fill)
    want = kernels.tile2d_fused.plain(src, fill.clone(), taps, tm)
    diff = (got - want).abs()
    assert float(diff.max()) <= KERNEL_TOL * float(want.abs().max())
    assert torch.equal(got[:tm], fill[:tm])
    assert torch.equal(got[tm + R:], fill[tm + R:])
    return codegen.tile2d_geometry(taps, R, C, tm)


@pytest.mark.parametrize("case", sorted(TABLES))
def test_emulated_tile2d_equals_plain(tmp_path, case):
    """Several strips (columns wrap at both ends) and segments."""
    g = run_emulated(tmp_path, case, 48, 1100, 16)
    assert g.grid[0] == 3 and g.grid[1] > 1 and g.vec


@pytest.mark.parametrize("case,R,C,tm", [
    ("5pt_fu2", 32, 200, 8),
    ("25pt_fu2", 16, 37, 8),
    ("9pt_fu2", 24, 1101, 8),
    ("5pt_fu4", 16, 12, 16),
], ids=["narrow", "narrow_odd", "odd_width", "narrower_than_halo_rows"])
def test_emulated_tile2d_variants_equal_plain(tmp_path, case, R, C, tm):
    g = run_emulated(tmp_path, case, R, C, tm)
    assert g.vec == (C % 4 == 0)
    if C < codegen.STRIP_2D[0]:
        # one strip wider than the grid: its halo wraps more than once
        assert g.grid[0] == 1 and g.threads * 4 > C


def test_emulated_tile2d_matches_jax_interpret(tmp_path):
    """One application from the same padded state against the JAX
    experiment's kernel in interpret mode, on the whole data block (the
    gate of ``tests/test_torch_tile2d.py``: 1e-5 of max|JAX|)."""
    from drstencil_tpu.ir import golden

    sys.path.insert(0, ".")
    jax_exp = importlib.import_module("tuning.exp_tile2d")
    jspec, tm = small_spec("2d9pt_star"), 32
    a0, _ = golden.random_state(jspec, 0, dtype=np.float64)
    a0 = a0.astype(np.float32)
    jpair, jpad, junpad, jan = jax_exp.build_tile_program(
        jspec, step=2, tm=tm, interpret=True)
    ja = jpad(jnp.asarray(a0))
    _, jb = jax.jit(jpair)(ja, jpad(jnp.zeros_like(ja[:a0.shape[0]])))
    want = np.asarray(junpad(jb))
    taps = kernels.tile2d_taps(jan.fused, jan.halo)
    R, C = jspec.dims
    launch = emulated_tile2d(codegen.tile2d_source(taps, R, C, tm), tmp_path)
    a = convert.padded_state_from_numpy(a0, tm, "cpu")
    got = convert.padded_state_to_numpy(launch(a, torch.zeros_like(a)), tm)
    assert np.abs(got - want).max() <= KERNEL_TOL * np.abs(want).max()
