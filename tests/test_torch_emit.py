"""The port's program emitter (``drstencil_tpu_torch/emit.py``) on the CPU,
mirroring ``tests/test_native.py``.

An emitted program holds its kernel twice: as CUDA text (compiled only on
a card) and as plain torch code, which ``--device cpu`` runs.  Here the
plain path is held

- against the fp64 golden model through the program's own ``--check`` in a
  subprocess (RMS < 1e-3 in fp32, as ``tests/test_native.py``);
- against the port's library (``StencilProgram(..., device="cpu")``) bit
  for bit: the emitted slices run the library's operations in its order;
- against the JAX package's library runtime in Pallas interpret mode within
  1e-5 of max|JAX| in fp32 (fp32 sums in another order) and one bf16 ulp
  in bf16 (both round one fp32 sum once).

The CUDA text is checked as text: no tap table, float literals that are
exactly the library's float32 coefficients.
"""

import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from drstencil_tpu.ops.config import KernelConfig as JConfig
from drstencil_tpu.ops.runner import StencilProgram as JProgram
from drstencil_tpu.parallel import halo as jhalo
from drstencil_tpu.parallel import stream_shard as jshard
from drstencil_tpu_torch import convert, emit as emit_mod
from drstencil_tpu_torch.ir import golden
from drstencil_tpu_torch.ir.passes import AnalysisError, analyze, fuse
from drstencil_tpu_torch.ir.spec import load_stc
from drstencil_tpu_torch.ops import codegen
from drstencil_tpu_torch.ops.config import KernelConfig
from drstencil_tpu_torch.ops.runner import StencilProgram
from drstencil_tpu_torch.ops.stream import level_plan
from drstencil_tpu_torch.parallel import halo, stream_shard
from drstencil_tpu_torch.tune.tuned import tpu_config, tuned_entries

from conftest import BENCH_DIR, small_spec
from test_torch_codegen import level_fn, tap_lines

FIVE_PT = "0 0 0.3\n0 1 0.2\n1 0 0.2\n0 -1 0.2\n-1 0 0.2\n"
SEVEN_PT = ("0 0 0 0.3\n1 0 0 0.2\n-1 0 0 0.2\n0 1 0 0.2\n"
            "0 -1 0 0.2\n0 0 1 0.2\n0 0 -1 0.2\n")
TINY_2D = "M 64\nN 256\niterations 4\nstencil\n" + FIVE_PT
TINY_3D = "L 24\nM 16\nN 128\niterations 4\nstencil\n" + SEVEN_PT
RMS_TOL = 1e-3      # tests/test_native.py's gate on the [Test] RMS line
JAX_TOL = 1e-5      # fp32 vs the JAX runtime, relative to max|JAX|


def port_spec(name, dims=None):
    jspec = small_spec(name, dims)
    return jspec, convert.spec_from_fields(jspec.name, jspec.dims,
                                           jspec.iterations, jspec.taps)


def run_program(tmp_path, text, *args):
    """Run an emitted program as its own process, away from the repository
    (no ``sys.path`` entry, another working directory)."""
    out_py = tmp_path / "gen.py"
    out_py.write_text(text, encoding="utf-8")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, str(out_py), *args],
                       capture_output=True, text=True, env=env,
                       cwd=str(tmp_path), timeout=600)
    assert r.returncode == 0, r.stderr[-2000:]
    return r.stdout


def result_line(stdout, what):
    lines = [ln for ln in stdout.splitlines()
             if ln.startswith(f"[Test] {what}:")]
    assert lines, stdout
    return float(lines[0].split(":")[1])


def load_program(text):
    g = {"__name__": "gen"}
    exec(compile(text, "gen.py", "exec"), g)
    return g


# -- (a) the programs run and pass their own check ------------------------------

CHECK_CASES = {
    "fused_step1": (TINY_2D, dict(step=1, tm=16)),
    "fused_step2": (TINY_2D, dict(step=2, tm=16)),
    "3d_step1": (TINY_3D, dict(step=1, tm=24)),
    "trapezoid": (TINY_2D, dict(step=2, tm=16, trapezoid=True)),
    "deep_trapezoid": ("M 96\nN 256\niterations 4\nstencil\n" + FIVE_PT,
                       dict(step=6, tm=48, ch=16, trapezoid=True)),
    "block": (TINY_2D, dict(step=4, tm=16, trapezoid=True, block=2,
                            lane_mode="roll")),
    "block_vfuse": (TINY_2D, dict(step=4, tm=16, trapezoid=True, block=2,
                                  vfuse=True, lane_mode="roll")),
    "3d_vfuse": ("L 24\nM 8\nN 256\niterations 4\nstencil\n" + SEVEN_PT,
                 dict(step=2, tm=24, trapezoid=True, vfuse=True,
                      lane_mode="roll")),
    "prefetch1_jfix_kernel": (TINY_3D, dict(step=2, tm=72, trapezoid=True,
                                            jfix="kernel", prefetch=1)),
}


@pytest.mark.parametrize("case", sorted(CHECK_CASES))
def test_emitted_program_check_passes(tmp_path, case):
    stc, kw = CHECK_CASES[case]
    text = emit_mod.emit(stc, "tiny", check=True, **kw)
    out = run_program(tmp_path, text, "--check", "--device", "cpu",
                      "--pairs", "1", "--warmup", "1")
    assert result_line(out, "RMS Error") < RMS_TOL, out
    assert result_line(out, "Max Relative Error") < 1e-5, out
    assert "kernel launches: 0" in out      # the CPU path launches nothing


def test_emitted_bf16_program_check_passes(tmp_path):
    text = emit_mod.emit(TINY_2D, "tiny", step=2, trapezoid=True,
                         dtype="bfloat16", check=True)
    out = run_program(tmp_path, text, "--check", "--device", "cpu",
                      "--pairs", "1", "--warmup", "1")
    # tests/test_kernels.py's bf16 gates against the fp64 golden
    assert result_line(out, "Max Error") < 2.0 and \
        result_line(out, "RMS Error") < 0.5, out


def test_emitted_odd_step_distance_check_passes(tmp_path):
    """The explicit-distance family: 3d9pt_cross has no reuse at the
    default distance for step 3, and emits with ``--dist 2``."""
    jspec, spec = port_spec("3d9pt_cross", (24, 8, 256))
    with pytest.raises(AnalysisError, match="No data to reuse"):
        emit_mod.emit(spec, step=3, trapezoid=True)
    text = emit_mod.emit(spec.to_stc(), "tiny3dd2", step=3, distance=2,
                         tm=32, trapezoid=True, lane_mode="roll", check=True)
    out = run_program(tmp_path, text, "--check", "--device", "cpu",
                      "--pairs", "1", "--warmup", "1")
    # this operator grows the state (its coefficients sum to 1.8), so the
    # relative line is the one to hold at fp32 roundoff
    assert result_line(out, "Max Relative Error") < 1e-5, out


def test_emitted_gold_program_runs(tmp_path):
    text = emit_mod.emit("M 32\nN 64\niterations 4\nstencil\n" + FIVE_PT,
                         "tiny", gold_only=True)
    assert "import torch" not in text and "CUDA_SOURCE" not in text
    out = run_program(tmp_path, text, "--pairs", "1")
    assert "checksum" in out
    spec = load_stc(os.path.join(BENCH_DIR, "2d5pt_star.stc"))
    want = golden.run_golden(
        convert.spec_from_fields("tiny", (32, 64), 4, spec.taps), pairs=1)
    checksum = float(out.split("checksum:")[1])
    assert checksum == pytest.approx(want["a"][1:-1].sum(), rel=1e-6)


@pytest.mark.parametrize("stc,kw,devices", [
    (TINY_2D, dict(step=2, tm=8, trapezoid=True, lane_mode="roll", shards=4),
     "cpu,cpu,cpu,cpu"),
    ("L 32\nM 8\nN 256\niterations 4\nstencil\n" + SEVEN_PT,
     dict(step=1, tm=24, lane_mode="roll", shards=2), "cpu,cpu"),
], ids=["2d_4shards", "3d_2shards"])
def test_emitted_shard_program_check_passes(tmp_path, stc, kw, devices):
    text = emit_mod.emit(stc, "tiny", check=True, **kw)
    assert f"NSHARDS = {kw['shards']}" in text and "DIMS_LOCAL" in text
    out = run_program(tmp_path, text, "--check", "--devices", devices,
                      "--pairs", "1", "--warmup", "1")
    assert result_line(out, "RMS Error") < RMS_TOL, out


# -- (b) the emitted plain path against both libraries --------------------------

LIBRARY_CASES = {
    # name: (stencil, dims, JAX config fields beyond variant/interpret)
    "fused": ("2d5pt_star", (64, 256), dict(step=2, tm=16)),
    "trapezoid_chained": ("2d25pt_box", (64, 256), dict(
        step=2, tm=16, ch=8, trapezoid=True, lane_mode="roll")),
    "deep_trapezoid": ("2d5pt_star", (96, 256), dict(
        step=6, tm=48, ch=16, trapezoid=True)),
    "vfuse": ("2d5pt_star", (64, 256), dict(
        step=3, tm=16, trapezoid=True, vfuse=True, lane_mode="roll")),
    "block": ("2d5pt_star", (64, 256), dict(
        step=4, tm=16, trapezoid=True, block=2, lane_mode="roll")),
    "block_vfuse": ("2d5pt_star", (64, 256), dict(
        step=4, tm=16, trapezoid=True, block=2, vfuse=True,
        lane_mode="roll")),
    "3d_vfuse": ("3d7pt_star", (24, 8, 256), dict(
        step=2, tm=24, trapezoid=True, vfuse=True, lane_mode="roll")),
    "3d_jfix_kernel": ("3d7pt_star", (16, 16, 256), dict(
        step=2, tm=72, trapezoid=True, jfix="kernel")),
    "odd_step_distance": ("3d9pt_cross", (24, 8, 256), dict(
        step=3, distance=2, tm=32, trapezoid=True, lane_mode="roll")),
    "bf16": ("2d9pt_star", (64, 256), dict(
        step=2, tm=16, trapezoid=True, dtype="bfloat16")),
}


def emit_for(spec, fields, **extra):
    """``emit`` with a config's fields, as the tuner passes them."""
    c = KernelConfig(**fields)
    return emit_mod.emit(
        spec, spec.name, step=c.step, distance=c.distance,
        merge_forward=c.merge_forward, tm=c.tm or 0, dtype=c.dtype,
        trapezoid=c.trapezoid, lane_mode=c.lane_mode or "", ch=c.ch or 0,
        vfuse=c.vfuse, block=c.block, prefetch=c.prefetch, jfix=c.jfix,
        **extra)


def bf16_ulp(x):
    """One bf16 ulp of each value of the float32 array ``x``."""
    _, e = np.frexp(x.astype(np.float32))
    return np.where(x != 0, np.ldexp(1.0, e - 8), 0.0)


@pytest.mark.parametrize("case", sorted(LIBRARY_CASES))
def test_emitted_matches_library_runtime(case):
    name, dims, fields = LIBRARY_CASES[case]
    jspec, spec = port_spec(name, dims)
    seed = 7
    g = load_program(emit_for(spec, fields))

    # the emitted plain path, on the program's own initial state
    a0, b0 = g["init_state"](seed, np.float64)
    ga, gb = golden.random_state(spec, seed)
    np.testing.assert_array_equal(a0, ga)       # bit-equal initial state
    np.testing.assert_array_equal(b0, gb)
    call = g["build_call"]("cpu")
    a, b = g["to_state"](a0, "cpu"), g["to_state"](b0, "cpu")
    call(a, b)
    call(b, a)
    gen = a.to(torch.float32).numpy()

    # the port's library on the CPU: bit for bit
    prog = StencilProgram(spec, KernelConfig(**fields), device="cpu")
    lib = prog.final_a(prog.run_pairs(prog.init_state(seed), 1))
    np.testing.assert_array_equal(gen, lib)

    # the JAX library runtime in interpret mode
    jprog = JProgram(jspec, JConfig(variant="stream", interpret=True,
                                    **fields))
    jout = np.asarray(jprog.final_a(jprog.run_pairs(jprog.init_state(seed),
                                                    1)), dtype=np.float32)
    jout = jout.reshape(dims)
    diff = np.abs(gen - jout)
    if fields.get("dtype") == "bfloat16":
        assert np.all(diff <= bf16_ulp(jout) + JAX_TOL * np.abs(jout).max())
    else:
        assert diff.max() <= JAX_TOL * np.abs(jout).max()


@pytest.mark.parametrize("name,dims,fields,n", [
    ("2d5pt_star", (64, 256), dict(step=2, tm=8, trapezoid=True,
                                   lane_mode="roll"), 4),
    ("3d7pt_star", (32, 8, 256), dict(step=1, tm=24, lane_mode="roll"), 4),
], ids=["2d", "3d"])
def test_emitted_matches_library_shard(cpu_devices, name, dims, fields, n):
    """The ``--shard`` program's pair against the port's
    ``sharded_stream_pair`` (bit for bit) and the JAX package's on a CPU
    mesh (within 1e-5)."""
    jspec, spec = port_spec(name, dims)
    g = load_program(emit_for(spec, fields, shards=n))
    assert g["NSHARDS"] == n and g["DIMS"] == dims
    a0, b0 = golden.random_state(spec, 7)
    devices = [torch.device("cpu")] * n
    apply_fn = g["build_sharded"](devices)
    a, b = g["shard_state"](a0, devices), g["shard_state"](b0, devices)
    apply_fn(a, b)
    apply_fn(b, a)
    gen = g["unshard_state"](a)

    cfg = KernelConfig(**fields)
    pair, geo = stream_shard.sharded_stream_pair(
        spec, cfg, halo.make_mesh(n, devices=["cpu"] * n))
    state = convert.sharded_state_from_numpy(a0, b0, geo)
    for got, want in zip(a, state["a"]):        # the same ghosted slabs
        assert got.shape == want.shape
    pair(state["a"], state["b"])
    lib, _ = convert.sharded_state_to_numpy(state, geo)
    np.testing.assert_array_equal(gen, lib)

    import jax
    jcfg = JConfig(variant="stream", interpret=True, **fields)
    mesh = jhalo.make_mesh(n, devices=list(cpu_devices)[:n])
    jpair, g_lib, sh = jshard.sharded_stream_pair(jspec, jcfg, mesh)
    sa = jshard.shard_state(a0.astype(np.float32), g_lib, n)
    sb = jshard.shard_state(b0.astype(np.float32), g_lib, n)
    ja, _ = jpair(jax.device_put(sa[0], sh), jax.device_put(sb[0], sh),
                  tuple(jax.device_put(s, sh) for s in sa[1:]),
                  tuple(jax.device_put(s, sh) for s in sb[1:]))
    jout = jshard.unshard_state(np.asarray(ja), g_lib, n).reshape(dims)
    assert np.abs(gen - jout).max() <= JAX_TOL * np.abs(jout).max()


# -- (c) the program's text --------------------------------------------------------

def cuda_source_of(text):
    return text.split("CUDA_SOURCE = r'''")[1].split("'''")[0]


def literals_of(cuda):
    """(float literal, tap offset) of every tap of the level function in
    the order of its lines; each line feeds the quad's four outputs with
    one literal."""
    taps = []
    for lits, off in tap_lines(cuda):
        assert len(set(lits)) == 1
        taps.append((lits[0], off))
    return taps


def test_emitted_text_stands_alone():
    text = emit_mod.emit(TINY_2D, "tiny", step=2, trapezoid=True, check=True,
                         tm=16, ch=8, lane_mode="roll", prefetch=1)
    mods = set()
    for node in ast.walk(ast.parse(text)):
        if isinstance(node, ast.Import):
            mods |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            mods.add((node.module or "").split(".")[0])
    assert mods <= {"argparse", "time", "numpy", "ctypes", "hashlib", "os",
                    "shutil", "subprocess", "tempfile", "torch"}
    cuda = cuda_source_of(text)
    assert "__global__" in cuda and "compute_90a" in text
    # specialised: constants, no tap table, no run-time shapes
    assert "constexpr int M = 64, N = 256;" in cuda
    assert "constexpr int H = 2, LEVELS = 2, REACH = 1;" in cuda
    assert "TapTable" not in cuda and "coef" not in cuda
    launch = cuda.split('extern "C" int launch(')[1].split(")")[0]
    assert launch == "const void* src, void* dst, void* stream"
    assert len(literals_of(cuda)) == 5
    # the header records the tile (a segment of 16 rows, strips of 8
    # columns) and the TPU-only knobs, which change nothing else
    assert "tile    : bx=16 ch=8 (0 = the generator's), segments sized " \
        f"for {codegen.SM_COUNT} SMs" in text
    assert "lane_mode=roll jfix=outer prefetch=1" in text
    assert "constexpr int SEG = 16, TX = 8;" in cuda
    plain = emit_mod.emit(TINY_2D, "tiny", step=2, trapezoid=True, check=True,
                          tm=16, ch=8)
    assert cuda_source_of(plain).split("\n", 2)[2] == cuda.split("\n", 2)[2]
    auto = emit_mod.emit(TINY_2D, "tiny", step=2, trapezoid=True, check=True)
    assert "constexpr int SEG = 16, TX = 8;" not in cuda_source_of(auto)


def test_shard_kernel_takes_a_store_range():
    cuda = cuda_source_of(emit_mod.emit(TINY_2D, "tiny", shards=4))
    assert "int s_lo, int s_hi, void* stream" in cuda
    assert "constexpr int M = 18, N = 256;" in cuda     # 16 rows + 2 ghosts
    bf16 = cuda_source_of(emit_mod.emit(TINY_2D, "tiny", dtype="bfloat16"))
    assert "typedef __nv_bfloat16 T;" in bf16
    assert "__float2bfloat16_rn" in bf16


def winner_plans():
    """(label, plan) of every tuned winner in fp32, plus two coefficient-
    and block-fused tables with many distinct coefficients."""
    for name, entry in sorted(tuned_entries().items()):
        spec = load_stc(os.path.join(BENCH_DIR, name + ".stc"))
        cfg = tpu_config(entry["config"])
        an = analyze(spec, cfg.step, cfg.distance, cfg.merge_forward)
        yield name, spec, cfg, level_plan(an, cfg)
    for name, fields in (("2d25pt_box", dict(step=3)),
                         ("3d27pt_box", dict(step=2)),
                         ("2d9pt_box", dict(step=4, trapezoid=True,
                                            block=2))):
        spec = load_stc(os.path.join(BENCH_DIR, name + ".stc"))
        cfg = KernelConfig(**fields)
        yield name, spec, cfg, level_plan(analyze(spec, cfg.step), cfg)


@pytest.mark.parametrize("index", range(14))
def test_float_literals_are_the_library_float32_coefficients(index):
    name, spec, cfg, plan = list(winner_plans())[index]
    cuda = emit_mod.cuda_source(plan, spec.dims, "float32", False, name)
    lits = literals_of(cuda)
    assert len(lits) == len(plan.coeffs)
    for (lit, at), off, c in zip(lits, plan.offsets.tolist(),
                                 plan.coeffs.tolist()):
        assert lit.startswith("0x") or lit.startswith("-0x")
        assert emit_mod.literal_value(lit) == np.float32(c)     # exact
        assert np.float32(emit_mod.literal_value(lit)) == np.float32(c)
        assert at == tuple(off)         # the table's sorted order
    # one fmaf line per tap (four outputs each), not per tap per level
    assert cuda.count("= fmaf(") == 4 * len(plan.coeffs)
    assert cuda.count(level_fn(cuda)[0] + "(") == plan.levels + 1


def test_float32_literal_round_trips():
    rng = np.random.default_rng(0)
    values = np.concatenate([rng.normal(size=200), [0.0, 1.0, -2.5, 1e-30,
                                                    0.1, 1 / 3]])
    for v in values:
        lit = emit_mod.float32_literal(v)
        assert lit.endswith("f") and "p" in lit
        assert emit_mod.literal_value(lit) == float(np.float32(v))
    with pytest.raises(emit_mod.EmitError, match="non-finite"):
        emit_mod.float32_literal(float("inf"))


# -- (d) rejections ----------------------------------------------------------------

@pytest.mark.parametrize("kw,exc,message", [
    (dict(vfuse=True), emit_mod.EmitError,
     "--vfuse requires --trapezoid with --step > 1"),
    (dict(block=2), emit_mod.EmitError,
     "--block requires --trapezoid with --step > 1"),
    (dict(step=4, trapezoid=True, block=3), emit_mod.EmitError,
     r"--block requires step % block == 0 and block < step "
     r"\(block == step is plain coefficient fusion\)"),
    (dict(step=4, trapezoid=True, block=4), emit_mod.EmitError,
     "--block requires step % block == 0 and block < step"),
    (dict(step=6, trapezoid=True, vfuse=True, lane_mode="roll"), ValueError,
     "vfuse requires levels < DEEP_LEVELS"),
    (dict(step=2, trapezoid=True, vfuse=True, lane_mode="slice"), ValueError,
     "vfuse requires roll lane-mode"),
    (dict(jfix="inner"), emit_mod.EmitError,
     "--jfix must be 'outer' or 'kernel'"),
    (dict(jfix="kernel"), emit_mod.EmitError, "--jfix kernel is 3D-only"),
    (dict(shards=5), emit_mod.EmitError,
     "leading dim not divisible by shards"),
    (dict(prefetch=3), emit_mod.EmitError, "prefetch depth must be 1 or 2"),
    (dict(factor=True), emit_mod.EmitError, "factor mode has no emitter"),
    (dict(dtype="float16"), ValueError, "dtype 'float16'"),
])
def test_emitter_rejections(kw, exc, message):
    with pytest.raises(exc, match=message):
        emit_mod.emit(TINY_2D, "tiny", **kw)


def test_emitter_rejects_what_the_jax_emitter_rejects():
    """The same configurations fail in ``native_bridge.emit``, with the
    same message where the JAX emitter has one."""
    from drstencil_tpu import native_bridge

    for kw in (dict(vfuse=True), dict(block=2),
               dict(step=4, trapezoid=True, block=3),
               dict(jfix="kernel"), dict(shards=5)):
        with pytest.raises(native_bridge.NativeError) as jax_err:
            native_bridge.emit(TINY_2D, "tiny", **kw)
        with pytest.raises(emit_mod.EmitError) as port_err:
            emit_mod.emit(TINY_2D, "tiny", **kw)
        assert str(port_err.value) == str(jax_err.value)
    with pytest.raises(emit_mod.EmitError, match="needs M % 8 == 0"):
        emit_mod.emit(TINY_3D, "tiny", step=6, trapezoid=True, jfix="kernel")
    with pytest.raises(ValueError, match="iteratioins"):
        emit_mod.emit("M 8 N 8 iteratioins 4 stencil 0 0 1.0", "t")


def test_block_fused_table_is_the_library_plan():
    spec = load_stc(os.path.join(BENCH_DIR, "2d5pt_star.stc"))
    text = emit_mod.emit(spec, step=4, trapezoid=True, block=2,
                         lane_mode="roll")
    cuda = cuda_source_of(text)
    assert "LEVELS = 2, REACH = 2" in cuda
    assert len(literals_of(cuda)) == len(fuse(spec.taps, 2)) == 13
    assert "plan    : levels=2 reach=2 frame=4 taps/level=13" in text
