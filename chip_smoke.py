#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (drstencil_tpu_torch) on one GPU.

Run from the repository root on a machine with one NVIDIA Hopper card:

    python3 chip_smoke.py                      # every tuned stencil
    python3 chip_smoke.py --stencils 2d5pt_star,3d7pt_star
    python3 chip_smoke.py --from-phase 14      # phases 14-18 alone (partial)
    python3 chip_smoke.py --mesh-devices cuda:0,cuda:1,cuda:2,cuda:3
                                  # four cards: phases 11 and 13 with one shard
                                  # per card, and weak scaling measured

It builds the CUDA kernels from the sources in the checkout (nvcc, into
``build/``) and runs, raising on the first failure:

1. environment: the card's name and power limit, versions; the ``.cu``
   library of ``drstencil_tpu_torch/csrc`` (the overlap probe) and the
   per-plan kernels of every plan known ahead (``ops/codegen.py``'s text:
   every winner at the ``.stc`` and the reduced size in fp32 and bf16, the
   shard slabs, factor mode's plans and its unfactored programs, and
   ``tile2d_fused`` for every row of the plain-tile sweep), one ``nvcc``
   each, started together; seconds, registers, spills and CTAs per SM per
   plan;
2. each per-plan kernel against its plain PyTorch version on every tuned
   winner's tap table at the ``.stc`` size (max|kernel - plain| /
   max|plain| <= 1e-5), with the kernel's, the plain version's and a cuDNN
   convolution's times beside the kernel's bound, its registers, spills,
   CTAs per SM and build seconds;
3. the main path — ``StencilProgram(spec, best_config(name))`` at the
   ``.stc`` size: ``time()``, then ``device_check(pairs=1) <= 1e-3`` —
   with the kernel's launch count read around it.  Phases 2-8 also run,
   as cases of their own, the TPU config (``benchmarks/tuned.json``) of
   each kernel mode a TPU winner runs and no winner of the card's table
   does (K1 single level, K3 value-fused, K4 deep);
4. ``check()`` against the fp64 golden model at a reduced size;
5. the entry point ``drstencil_tpu_torch.entry.entry()`` (2d5pt_star,
   step 1, 1024²): one pair against the torch gold and the fp64 golden;
6. the bf16 builds of the kernels against their plain version on every
   winner's tap table at the ``.stc`` size: at most one bf16 ulp of the
   plain value per cell (plus fp32 noise), with the same times, the bound
   at 2 bytes per cell and bf16 cuDNN convolutions as the yardstick;
7. the bf16 main path — ``StencilProgram(spec, best_config(name)
   .replace(dtype="bfloat16"))``: ``time()``, ``device_check(pairs=1) <=
   1e-2``, launches read around it;
8. the bf16 ``check()`` against the fp64 golden model at a reduced size;
9. the autotuner on the card: short sweeps at the ``.stc`` size of
   2d5pt_star (every candidate at its prior's step: fp32 with its tile
   candidates, bf16 and xla) and 3d7pt_star (its prior's trapezoid in fp32
   and bf16), one config through the isolated worker, and one profiler
   trace (its busy share by ``utils/trace_summary``), into a temporary
   directory with ``TUNED_GPU_PATH`` pointed there; then the tuner's tile
   axes: for the 2d5pt_star and 3d27pt_box winners at the ``.stc`` size
   and the 2d5pt_star winner on two grids narrower than its strip, every
   ``(tm, ch)`` the space emits beside the generator's tile, each output
   bit-equal to the generator's tile's and within 1e-5 of the plain
   version, with ms per launch against the bound, the tile, the CTAs per
   SM and the SM count the card reports;
10. the shard-local kernels against their plain version, fp32 and bf16,
    on a quarter slab of the ``.stc`` grid with its ghost rows, for the
    first, an interior and the last shard's store range and an empty one
    (fp32 <= 1e-5 relative, bf16 <= 1 ulp; everything outside the range
    bit-unchanged; the empty range launches nothing);
11. the sharded main path — ``sharded_stream_pair(spec, best_config(name),
    make_mesh(4, devices=["cuda:0"] * 4))`` at the ``.stc`` size for every
    winner in fp32 and four of them in bf16: one pair against the
    single-device ``StencilProgram``'s pair (fp32 <= 1e-6 relative, bf16 <=
    1 ulp) and the torch gold (the ``device_check`` gates), ms/pair beside
    the single-device program's, the exchange's bytes against the model's,
    4 launches per application; then the weak-scaling MODEL's rows.  Four
    shards on one card run one after another: the sharded ms/pair shows
    what the exchange and the slab edges cost, not weak scaling;
12. factor mode: ``stencil2d_factor_levels`` (fp32, bf16) against its
    plain version at 8192² on 2d25pt_box, 2d9pt_star and 2d9pt_cross at
    steps 1 and 2, with a cuDNN convolution of the unfactored 5x5 table per
    step as the yardstick, and the plan's registers, spills and CTAs per
    SM; then ``StencilProgram(spec, KernelConfig(step, factor=True))``:
    ``time()`` and ``device_check`` beside the unfactored trapezoid of the
    same step;
13. ``dryrun_multichip(4, devices=["cuda:0"] * 4)``;
14. emitted programs: ``python -m drstencil_tpu_torch.cli`` emits one
    standalone program per tuned winner at the ``.stc`` size in fp32, and
    per ``SHARD_STENCILS`` winner in bf16; their specialised kernels are
    built (one ``nvcc`` each, all started together) and held against the
    emitted plain version (<= 1e-5; bf16 <= 1 ulp) and against the library
    kernel (<= 1e-6; bf16 <= 1 ulp; differing cells counted), timed in
    turns with the library kernel, and every program's ``main()`` runs a
    few pairs at full size (its launches counted).  Then five programs run
    end to end as their own processes at a reduced size: a 2D trapezoid, a
    3D fused level and a bf16 program with ``--check`` (the fp64 golden
    tolerances), a ``--shard 4`` program on four shards of the one card,
    and a ``--gold`` program;
15. the plain-tile experiment: ``tile2d_fused`` against its plain version
    on the whole padded buffer at 8192² for every row of its ``SWEEP``
    (pad rows bit-unchanged), timed beside a cuDNN convolution, with the
    table's registers, spills and CTAs per SM; then the experiment itself
    (tile ms/step, the port's winner ms/step, ratio);
16. the overlap probe: ``overlap_probe`` A/B/C x depth 1/2 at 8192²
    against its plain version on the written rows (the others
    bit-unchanged, variant C's carry equal), with its registers, shared
    memory, CTAs per SM and CTA count, the bound beside the time to move
    the variant's whole windows, and two cuDNN convolutions (the two
    levels) as the yardstick; then the experiment (ms/sweep beside the
    bytes time and the compute-only time);
17. the bench: ``python -m drstencil_tpu_torch.bench`` with
    ``BENCH_CHECK=1`` as its own process (one more process per stencil):
    its JSON line must hold the 8 stencils, each with its roofline
    fraction and launches counted in its process, no environment marker,
    and every ``max_dev_diff`` within the ``device_check`` gate of its
    dtype;
18. the trace: ``python -m drstencil_tpu_torch.tuning.capture_trace`` of
    the 2d5pt_star winner as its own process (one warmup pair and two
    timed pairs), read back by ``utils/trace_summary``: the kernel row must
    count the launches the wrapper counted in the traced window; the busy
    share is printed;
19. one ``{"kernels": [...]}`` line (every kernel a driven path launches,
    fp32 and bf16 rows, with that path's count), the card line, then the ok
    line.

Details also go to ``build/chip_smoke.json``.  ``benchmarks/tuned.json``
is checked byte-identical at the end.  Without CUDA, or outside a
checkout of the repository, it exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import re
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
KERNEL_TOL = 1e-5       # kernel vs its plain version, relative to max|plain|
# bf16 kernel vs its plain version: both round the same fp32 sum once, and
# fp32 associativity may flip that rounding by one bf16 ulp of the value;
# a cell within fp32 noise (BF16_NOISE * max|plain|) of zero has no ulp
BF16_NOISE = 1e-5
# device_check gates: the tuner's CHECK_TOL (tune/tuner.py) per dtype
DEVICE_CHECK_TOL = {"float32": 1e-3, "bfloat16": 1e-2}
# fp64-golden tolerances of tests/test_kernels.py per dtype, stated for
# values ~100 and scaled with max|gold| for operators that grow the state
GOLDEN_TOL = {"float32": (5e-3, 1e-3), "bfloat16": (2.0, 0.5)}
MAX_TOL, RMS_TOL = GOLDEN_TOL["float32"]
GRAFT_DIMS = (1024, 1024)
REDUCED = {2: (1024, 1024), 3: (128, 128, 128)}
# sharded result vs the single-device program's, fp32 (every stored cell
# runs the same operations on the same values, so 0 is expected)
SHARD_TOL = 1e-6
N_SHARDS = 4
# phase 10: the stencils whose plans the shard kernels are held on; the
# bf16 sharded main path runs the same four, so every row has launches
SHARD_STENCILS = ("2d5pt_star", "2d25pt_box", "3d7pt_star", "3d27pt_box")
# phase 12: factor mode's stencils and steps
FACTOR_STENCILS = ("2d25pt_box", "2d9pt_star", "2d9pt_cross")
FACTOR_STEPS = (1, 2)
# phases 11-12: pairs per timing (3 repeats, after 1 warmup pair)
PAIRS = 4
# phase 9: the stencils swept (with the labels swept, {step} the prior's:
# the 2D stencil's every candidate at that step, its tiles included, the 3D
# one's trapezoid in both dtypes), the pairs per timing, the worker's cap
TUNE_STENCILS = (("2d5pt_star", "*_fu{step}*"),
                 ("3d7pt_star", "stream_fu{step}_trap*"))
TUNE_PAIRS = 4
TUNE_TIMEOUT_S = 300.0
# phase 9: the tile axes' cases: (stencil, grid or None for the .stc
# size); the two narrow 2D grids are narrower than a 512-cell strip, one of
# them no multiple of 4 wide (cell-wise access)
GEOMETRY_CASES = (("2d5pt_star", None), ("3d27pt_box", None),
                  ("2d5pt_star", (1024, 132)), ("2d5pt_star", (1024, 130)))
# phase 14: emitted kernel vs the library kernel, fp32 (the same fmaf
# sequence on the same values, so 0 differing cells is expected)
EMIT_TOL = 1e-6
# phase 14: pairs and warmup pairs of a program's main() at full size, and
# of the programs run as their own processes at the reduced size
EMIT_PAIRS, EMIT_WARMUP = 2, 1
RUN_PAIRS, RUN_WARMUP = 1, 1
EMIT_TIMEOUT_S = 300.0
# phases 2-8: the kernel modes of the TPU winners that keep a case of
# their own where no winner of the card's table runs them
MODES = ("K1 single level", "K3 value-fused", "K4 deep")
# phase 17: the bench's cap, its build included
BENCH_TIMEOUT_S = 600.0
# phase 18: the traced winner and its kernel's name in the trace
TRACE_STENCIL = "2d5pt_star"
TRACE_KERNEL = "stencil_kernel"
TRACE_TIMEOUT_S = 300.0


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(torch, fn, reps: int) -> float:
    """Mean ms of ``fn`` over ``reps`` calls, CUDA-event timed after one
    warmup call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def print_ptxas(log: str, prefix: str = "") -> None:
    """The registers, spills and entry names of an nvcc ``-Xptxas -v`` log."""
    for line in log.splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            print(f"  ptxas{prefix}: {line.strip()}")


def bf16_ulp(torch, x):
    """One bf16 ulp of each value of the bf16 tensor ``x`` (as fp32): for
    |x| in [2^(e-1), 2^e) the 8-bit significand gives 2^(e-8); 0 for 0."""
    _, e = torch.frexp(x.float())
    return torch.where(x != 0, torch.ldexp(torch.ones_like(x, dtype=torch.float32), e - 8),
                       torch.zeros_like(x, dtype=torch.float32))


def sha256(path: str) -> str:
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def main(argv=None) -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import numpy as np
    import torch.nn.functional as F

    from drstencil_tpu_torch import cli as cli_mod
    from drstencil_tpu_torch import entry as entry_mod
    from drstencil_tpu_torch.ir.passes import analyze
    from drstencil_tpu_torch.ir.spec import StencilSpec, load_stc
    from drstencil_tpu_torch.ops import kernels, xla_ref
    from drstencil_tpu_torch.ops.config import KernelConfig
    from drstencil_tpu_torch.ops.runner import StencilProgram, relative_diff
    from drstencil_tpu_torch.ops.stream import level_plan, state_dtype
    from drstencil_tpu_torch.parallel import halo, stream_shard
    from drstencil_tpu_torch.parallel.model import winner_rows
    from drstencil_tpu_torch.tune import session as session_mod
    from drstencil_tpu_torch.tune import space as space_mod
    from drstencil_tpu_torch.tune import tuned as tuned_mod
    from drstencil_tpu_torch.tune.tuned import (
        best_config, card_peaks, naive_sol_gstencil, tuned_entries)
    from drstencil_tpu_torch.tune.tuner import Tuner
    from drstencil_tpu_torch.tuning import exp_overlap, exp_tile2d
    from drstencil_tpu_torch.utils.profiling import traffic_model

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--stencils", default="",
                    help="comma-separated subset of benchmarks/tuned.json")
    ap.add_argument("--mesh-devices", default="",
                    help=f"{N_SHARDS} comma-separated CUDA devices: run only "
                         "the multi-device phases (11 and 13) with the mesh "
                         "on them, and measure weak scaling; the default "
                         f"mesh names cuda:0 {N_SHARDS} times")
    ap.add_argument("--from-phase", type=int, default=2, choices=[2, 10, 14],
                    help="skip the phases before this one (a partial run, "
                         "to try a later phase alone: it prints no result "
                         "lines)")
    args = ap.parse_args(argv)
    mesh_devices = (args.mesh_devices.split(",") if args.mesh_devices
                    else ["cuda:0"] * N_SHARDS)
    names = sorted(tuned_entries())
    if args.stencils:
        names = [n for n in args.stencils.split(",") if n]
    bench = os.path.join(ROOT, "benchmarks")
    tuned_json = os.path.join(bench, "tuned.json")
    tuned_sha = sha256(tuned_json)
    dev = torch.device("cuda", 0)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    # -- 1. environment -----------------------------------------------------
    t_start = time.perf_counter()
    smi = nvidia_smi_line()
    kind = torch.cuda.get_device_name(0)
    hbm_gbps, fp32_tflops = card_peaks(kind)
    print(f"card: {smi}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")
    t0 = time.perf_counter()
    libs = kernels.build()
    build_seconds = time.perf_counter() - t0
    for lib in libs:
        print(f"kernels built in {lib.build_seconds:.1f}s -> "
              f"{os.path.relpath(lib.path, ROOT)}")
        print_ptxas(lib.build_log)
    report = {"card": smi, "torch": torch.__version__,
              "cuda": torch.version.cuda,
              "build_seconds": build_seconds, "plans": [], "kernels": [],
              "main_path": [], "golden": [], "sharded": [], "factor": [],
              "weak_scaling_measured": [], "emitted": [], "emitted_runs": [],
              "tile2d": [], "overlap": []}

    specs = {n: load_stc(os.path.join(bench, n + ".stc")) for n in names}
    shard_names = [n for n in SHARD_STENCILS if n in specs]
    # the main-path cases: each winner, and the TPU config of each kernel
    # mode the card's winners no longer run
    cases = {n: (n, best_config(n)) for n in names}
    cases.update(lost_mode_cases(names, specs))
    for key, (_, cfg) in cases.items():
        if key not in names:
            print(f"case {key}: {cfg.label()} (a mode no winner runs)")

    def geometry_tiles(name, dims):
        """(spec, an, [(cfg, plan), ...]) of a tile-axes case: ``name``'s
        winner in fp32 at the generator's tile, then at every tile the
        space emits beside it (``tune/space.tile_candidates``), on
        ``dims`` (None: the .stc size)."""
        spec = specs.get(name) or load_stc(os.path.join(bench, name + ".stc"))
        if dims is not None:
            spec = StencilSpec(spec.name, dims, spec.iterations, spec.taps)
        base = best_config(name).replace(tm=None, ch=None, dtype="float32")
        an = analyze(spec, base.step, base.distance, base.merge_forward)
        cfgs = [base] + [c.cfg for c in space_mod.tile_candidates(spec, base)]
        return spec, an, [(c, level_plan(an, c)) for c in cfgs]

    def plan_requests(mesh_only):
        """(what, (plan, dims, dtype, shard)) of every per-plan kernel the
        phases below are known to launch (``mesh_only``: the multi-device
        phases', weak scaling's longer slabs included)."""
        out = []
        for key, (name, case_cfg) in cases.items():
            spec = specs[name]
            for dtype in ("float32", "bfloat16"):
                cfg = case_cfg.replace(dtype=dtype)
                an = analyze(spec, cfg.step, cfg.distance, cfg.merge_forward)
                plan = level_plan(an, cfg)
                rest = tuple(spec.dims[1:])
                out.append((f"{key} {dtype}",
                            (plan, spec.dims, dtype, False)))
                if not mesh_only:
                    out.append((f"{key} {dtype} reduced",
                                (plan, REDUCED[spec.ndim], dtype, False)))
                if key != name:
                    continue
                if dtype == "float32" or name in shard_names:
                    slab = (spec.dims[0] // N_SHARDS + 2 * plan.frame,) + rest
                    out.append((f"{name} {dtype} shard slab",
                                (plan, slab, dtype, True)))
                if mesh_only and dtype == "float32":
                    slab = (spec.dims[0] + 2 * plan.frame,) + rest
                    out.append((f"{name} weak-scaling slab",
                                (plan, slab, dtype, True)))
        for name in () if mesh_only else FACTOR_STENCILS:
            spec = specs.get(name) or load_stc(
                os.path.join(bench, name + ".stc"))
            for step in FACTOR_STEPS:
                for dtype in ("float32", "bfloat16"):
                    for factor in (True, False):
                        cfg = KernelConfig(step=step, factor=factor,
                                           trapezoid=step > 1 and not factor,
                                           dtype=dtype)
                        out.append((f"{name} {cfg.label()}", (
                            level_plan(analyze(spec, step), cfg), spec.dims,
                            dtype, False)))
        for name, dims in () if mesh_only else GEOMETRY_CASES:
            spec, _, tiles = geometry_tiles(name, dims)
            for cfg, plan in tiles:
                out.append((f"{name} {spec.dims} {cfg.label()} tile",
                            (plan, spec.dims, "float32", False)))
        for name, sweep in () if mesh_only else exp_tile2d.SWEEP.items():
            spec = specs.get(name) or load_stc(
                os.path.join(bench, name + ".stc"))
            for step, tm in sweep:
                an = analyze(spec, step=step, require_partition=False)
                taps = kernels.tile2d_taps(an.fused, an.halo)
                shape = (spec.dims[0] + 2 * tm, spec.dims[1])
                out.append((f"{name} tile2d fu{step} tm{tm}",
                            kernels.tile2d_plan(taps, shape, tm)))
        return out

    wanted_plans = plan_requests(bool(args.mesh_devices))
    t0 = time.perf_counter()
    built = kernels.build_plans([r for _, r in wanted_plans])
    report["plan_build_seconds"] = time.perf_counter() - t0
    distinct = len({p.path for p in built})
    print(f"{distinct} per-plan kernels ({len(built)} requests) built in "
          f"{report['plan_build_seconds']:.1f}s -> "
          f"{os.path.relpath(kernels.PLAN_DIR, ROOT)}")
    for (what, _), p in zip(wanted_plans, built):
        line = {"plan": what, "tile": list(p.geometry.tile),
                "smem_bytes": p.geometry.smem_bytes,
                "threads": p.geometry.threads,
                "ctas_per_sm_by_smem": p.geometry.ctas_per_sm,
                "build_seconds": p.build_seconds, **p.ptxas()}
        print("plan " + json.dumps(line))
        report["plans"].append(line)
        if line.get("spill_bytes"):
            print(f"  note: {what} spills {line['spill_bytes']} bytes")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)

    def within_tolerance(got, want, dtype, row):
        """fp32: max|got - want| <= KERNEL_TOL * max|want|; bf16: every cell
        within one bf16 ulp of the plain value (plus fp32 noise).  Fills the
        row's error fields."""
        diff = (got.float() - want.float()).abs()
        top = float(want.float().abs().max())
        row["max_abs_err"] = max(float(diff.max()),
                                 row.get("max_abs_err", 0.0))
        row["rel_err"] = row["max_abs_err"] / top
        if dtype == "float32":
            return row["rel_err"] <= KERNEL_TOL
        ulp = bf16_ulp(torch, want)
        safe = torch.where(ulp > 0, ulp, torch.ones_like(ulp))
        row["max_ulps"] = max(float((diff / safe).max()),
                              row.get("max_ulps", 0.0))
        row["cells_differing"] = int((diff > 0).sum())
        return bool((diff <= ulp + BF16_NOISE * top).all())

    def compare(stencil, kernel, plan, an, cfg, conv_table, conv_calls,
                rows=None, also_rows=()):
        """``kernel`` vs its plain version on ``plan`` at ``an``'s dims in
        ``cfg.dtype``, with the kernel's, the plain version's and a cuDNN
        convolution's times beside the kernel's bound.  ``rows`` is a
        shard kernel's store range (timed); ``also_rows`` are further
        ranges that are only checked.  A shard kernel's destination is
        random, and everything outside the range must come back bit for
        bit."""
        dtype = cfg.dtype
        tdt = state_dtype(dtype)
        shape = tuple(an.spec.dims)
        src = (torch.rand(shape, generator=gen, device=dev) * 100.0).to(tdt)
        if rows is None:
            d0 = torch.zeros_like(src)
        else:
            d0 = (torch.rand(shape, generator=gen, device=dev) - 0.5).to(tdt)
        factor = kernels.is_factor(plan)
        row = {
            "name": kernel.name + kernels.BUILDS[tdt], "stencil": stencil,
            "dtype": dtype, "route": kernel.route,
            "source": kernel.source, "replaces": kernel.replaces,
            "launches": 0, "levels": plan.levels, "frame": plan.frame,
            "dims": list(shape),
            "taps": plan.taps_per_step if factor else len(plan.coeffs),
            "tile": list(kernels.tile_shape(plan, shape)),
            "smem_bytes": kernels.smem_bytes(plan, shape),
        }
        built = kernels.plan_kernel(plan, shape, tdt, rows is not None)
        row.update(ctas_per_sm_by_smem=built.geometry.ctas_per_sm,
                   build_seconds=built.build_seconds, **built.ptxas())
        ok = True
        for r in ((rows,) if rows is None else (rows, *also_rows)):
            args = () if r is None else (r,)
            got, want = d0.clone(), d0.clone()
            kernel(src, got, plan, *args)
            kernel.plain(src, want, plan, *args)
            torch.cuda.synchronize()
            # an empty range stores nothing: the check below, that every
            # cell outside the range is unchanged, is then the whole check
            empty = r is not None and r[0] >= r[1]
            if not empty:
                ok = within_tolerance(got, want, dtype, row) and ok
            if r is not None:
                H = plan.frame
                outside = torch.ones(shape, dtype=torch.bool, device=dev)
                outside[(slice(r[0], r[1]),) + tuple(
                    slice(H, n - H) for n in shape[1:])] = False
                kept = torch.equal(got[outside], d0[outside])
                row.setdefault("rows_checked", []).append(
                    {"rows": list(r), "outside_unchanged": kept})
                ok = ok and kept
                del outside
        args = () if rows is None else (rows,)
        got, want = d0.clone(), d0.clone()
        row["ms"] = cuda_ms(torch, lambda: kernel(src, got, plan, *args), 20)
        row["plain_ms"] = cuda_ms(
            torch, lambda: kernel.plain(src, want, plan, *args), 3)
        # yardstick: cuDNN convolutions of the same taps ('same' padding,
        # the state's dtype, TF32 off), never called by the port
        offsets, coeffs, r = conv_table
        weight = torch.zeros((1, 1) + (2 * r + 1,) * len(shape), device=dev)
        for off, c in zip(offsets, coeffs):
            weight[(0, 0) + tuple(o + r for o in off)] = c
        weight = weight.to(tdt)
        conv = F.conv2d if len(shape) == 2 else F.conv3d
        x5 = src[None, None]

        def library():
            y = x5
            for _ in range(conv_calls):
                y = conv(y, weight, padding=r)
            return y

        row["library_ms"] = cuda_ms(torch, library, 3)
        row["bound_ms"], row["bound_by"] = traffic_model(an, cfg).bound_ms(
            hbm_gbps, fp32_tflops)
        row["x_bound"] = row["ms"] / row["bound_ms"]
        print(f"kernel {stencil}: " + json.dumps(row))
        if not ok:
            raise RuntimeError(f"{row['name']} on {stencil}: kernel vs plain "
                               f"out of tolerance: {row}")
        del src, d0, got, want, x5
        torch.cuda.empty_cache()
        return row

    def level_table(plan):
        return plan.offsets.tolist(), plan.coeffs.tolist(), plan.reach

    def kernel_row(key, dtype):
        """Kernel vs plain version on case ``key``'s plan at the .stc size
        in ``dtype``; the yardstick is one convolution per level."""
        name, cfg = cases[key]
        spec = specs[name]
        cfg = cfg.replace(dtype=dtype)
        an = analyze(spec, cfg.step, cfg.distance, cfg.merge_forward)
        plan = level_plan(an, cfg)
        return compare(key, kernels.kernel_for(spec.ndim), plan, an, cfg,
                       level_table(plan), plan.levels)

    def shard_kernel_row(name, dtype):
        """The shard-local kernel on ``name``'s winner plan on a quarter
        slab of the .stc grid with its ghost rows, for an interior shard's
        store range (timed), the first shard's, the last's and an empty
        one."""
        spec = specs[name]
        cfg = best_config(name).replace(dtype=dtype)
        an = analyze(spec, cfg.step, cfg.distance, cfg.merge_forward)
        plan = level_plan(an, cfg)
        H, local = plan.frame, spec.dims[0] // N_SHARDS
        slab = StencilSpec(spec.name, (local + 2 * H,) + tuple(spec.dims[1:]),
                           spec.iterations, spec.taps)
        an_slab = analyze(slab, cfg.step, cfg.distance, cfg.merge_forward)
        return compare(name, kernels.kernel_for(spec.ndim, shard=True), plan,
                       an_slab, cfg, level_table(plan), plan.levels,
                       rows=(H, H + local),
                       also_rows=((2 * H, H + local), (H, local),
                                  (2 * H, 2 * H)))

    def factor_kernel_row(name, step, dtype):
        """The factor-mode kernel on ``name`` at ``step`` at the .stc size;
        the yardstick is one convolution of the unfactored 5x5 table per
        timestep."""
        spec = specs.get(name) or load_stc(os.path.join(bench, name + ".stc"))
        cfg = KernelConfig(step=step, factor=True, dtype=dtype)
        an = analyze(spec, step)
        plan = level_plan(an, cfg)
        taps = sorted(spec.taps.items())
        row = compare(name, kernels.stencil2d_factor_levels, plan, an, cfg,
                      ([o for o, _ in taps], [c for _, c in taps], 2), step)
        row["step"] = step
        return row

    def geometry_phase():
        """Phase 9, the tuner's tile axes: each ``GEOMETRY_CASES`` case at
        every tile of :func:`geometry_tiles` on one random fp32 state: the
        output bit-equal to the generator's tile's (every cell runs the same
        ``fmaf`` chain whatever the tile) and within ``KERNEL_TOL`` of the
        plain version, ms per launch against the bound, and the SM count
        the card reports."""
        sms = kernels.sm_count(dev)
        print(f"geometry: the card reports {sms} SMs")
        lines = []
        for name, dims in GEOMETRY_CASES:
            spec, an, tiles = geometry_tiles(name, dims)
            kernel = kernels.kernel_for(spec.ndim)
            src = torch.rand(spec.dims, generator=gen, device=dev) * 100.0
            want = torch.zeros_like(src)
            kernel.plain(src, want, tiles[0][1])
            top = float(want.abs().max())
            bound = traffic_model(an, tiles[0][0]).bound_ms(hbm_gbps,
                                                            fp32_tflops)
            first = None
            for cfg, plan in tiles:
                got = torch.zeros_like(src)
                kernel(src, got, plan)
                torch.cuda.synchronize()
                built = kernels.plan_kernel(plan, spec.dims, torch.float32)
                g = built.geometry
                line = {"stencil": name, "dims": list(spec.dims),
                        "cfg": cfg.label(), "tm": cfg.tm, "ch": cfg.ch,
                        "sms": sms, "tile": list(g.tile),
                        "grid": list(g.grid), "ctas": int(np.prod(g.grid)),
                        "threads": g.threads, "smem_bytes": g.smem_bytes,
                        "ctas_per_sm": built.ctas_per_sm(), **built.ptxas(),
                        "rel_err": float((got - want).abs().max()) / top,
                        "bit_equal_default": first is None or torch.equal(
                            got.view(torch.int32), first.view(torch.int32))}
                if first is None:
                    first = got
                line["ms"] = cuda_ms(torch, lambda: kernel(src, got, plan),
                                     20)
                line["bound_ms"], line["bound_by"] = bound
                line["x_bound"] = line["ms"] / bound[0]
                print("geometry " + json.dumps(line))
                lines.append(line)
                if not (line["bit_equal_default"]
                        and line["rel_err"] <= KERNEL_TOL):
                    raise RuntimeError(f"{name} {cfg.label()} on "
                                       f"{spec.dims}: tile check failed: "
                                       f"{line}")
            del src, want, first, got
            torch.cuda.empty_cache()
        return lines

    def time_pairs(pair, a, b, devices=(dev,)):
        """Median ms per pair over 3 repeats of ``PAIRS`` pairs after one
        warmup pair: CUDA events on one card; across several cards, the
        host's clock around work that ends in a synchronize of each."""
        if len(set(devices)) == 1:
            return sorted(cuda_ms(torch, lambda: pair(a, b), PAIRS)
                          for _ in range(3))[1]

        def run(n):
            for _ in range(n):
                pair(a, b)
            for d in set(devices):
                torch.cuda.synchronize(d)

        reps = []
        for _ in range(3):
            run(1)      # as cuda_ms warms up: both ways run the same pairs
            t0 = time.perf_counter()
            run(PAIRS)
            reps.append((time.perf_counter() - t0) / PAIRS * 1e3)
        return sorted(reps)[1]

    def real_rows(slabs, g):
        """The sharded state's real rows joined on the first card."""
        H, local = g.halo, g.local_rows
        return torch.cat([x[H:H + local].to(dev) for x in slabs])

    def same_cells(x, y):
        """Whether two states agree bit for bit (a NaN equals a NaN: the
        timed pairs of an operator that grows the state may overflow)."""
        return bool(((x == y) | (x.isnan() & y.isnan())).all())

    def sharded_main_path(name, dtype):
        """``sharded_stream_pair`` on ``N_SHARDS`` shards (of one card, or
        on ``--mesh-devices``) at the .stc size against the single-device
        program from the same state: after one pair, and again after the
        timed pairs, which both run alike."""
        spec, cfg = specs[name], best_config(name).replace(dtype=dtype)
        prog = StencilProgram(spec, cfg)
        mesh = halo.make_mesh(N_SHARDS, devices=mesh_devices)
        spair, g = stream_shard.sharded_stream_pair(spec, cfg, mesh)
        kernel = kernels.kernel_for(spec.ndim, shard=True)
        state = prog.init_state(0)
        gold, inset = prog.gold_a(state, 1)
        sa = stream_shard.shard_state(state["a"], g)
        sb = stream_shard.shard_state(state["b"], g)
        single = prog.run_pairs(state, 1)["a"]
        kernels.reset_launches()
        spair(sa, sb)
        launches = kernel.launches
        copies, copied = g.exchange.copies, g.exchange.bytes
        H, local = g.halo, g.local_rows
        sharded = real_rows(sa, g)
        ghosts_zero = not (sa[0][:H].any() or sa[-1][H + local:].any()
                           or sb[0][:H].any() or sb[-1][H + local:].any())
        line = {"stencil": name, "cfg": cfg.label(), "dims": list(spec.dims),
                "dtype": dtype, "shards": N_SHARDS,
                "devices": [str(d) for d in mesh.devices],
                "launches": launches}
        if dtype == "float32":
            line["vs_single"] = relative_diff(sharded, single)
            same = line["vs_single"] <= SHARD_TOL
        else:
            same = within_tolerance(sharded, single, dtype, line)
        line["cells_differing_from_single"] = int((sharded != single).sum())
        line["vs_gold"] = relative_diff(sharded, gold, inset)
        model = stream_shard.halo_traffic_model(
            prog.an, cfg.step, N_SHARDS, itemsize=prog.dtype.itemsize)
        line["copies_per_pair"], line["bytes_per_pair"] = copies, copied
        line["model_bytes_per_apply"] = model["bytes_per_apply_mesh"]
        del gold, sharded, single
        line["single_ms_per_pair"] = time_pairs(
            prog.pair_fn(), state["a"], state["b"])
        line["sharded_ms_per_pair"] = time_pairs(spair, sa, sb, mesh.devices)
        line["same_after_timed_pairs"] = same_cells(real_rows(sa, g),
                                                    state["a"])
        line["exchange_us"] = time_exchange(g, sa, mesh.devices)
        line["copy_us"] = line["exchange_us"] / model["copies_per_apply_mesh"]
        print("sharded " + json.dumps(line))
        report["sharded"].append(line)
        if not (same and ghosts_zero and line["same_after_timed_pairs"]
                and line["vs_gold"] <= DEVICE_CHECK_TOL[dtype]
                and launches == 2 * N_SHARDS
                and copies == 2 * model["copies_per_apply_mesh"]
                and copied == 2 * model["bytes_per_apply_mesh"]):
            raise RuntimeError(f"{name} {dtype}: sharded main path failed "
                               f"(ghosts zero: {ghosts_zero}): {line}")
        del prog, sa, sb, state
        torch.cuda.empty_cache()
        return line

    def time_exchange(g, slabs, devices):
        """Mean µs of one halo exchange (all its copies) over 20 calls."""
        if len(set(devices)) == 1:
            return cuda_ms(torch, lambda: g.exchange(slabs), 20) * 1e3
        for d in set(devices):
            torch.cuda.synchronize(d)
        t0 = time.perf_counter()
        for _ in range(20):
            g.exchange(slabs)
        for d in set(devices):
            torch.cuda.synchronize(d)
        return (time.perf_counter() - t0) / 20 * 1e6

    def weak_scaling(name, single_ms_per_pair):
        """Weak scaling MEASURED on ``--mesh-devices``: every card keeps the
        full .stc problem (the global grid is ``N_SHARDS`` times as long on
        axis 0, random state made on each card), timed like the
        single-device program of :func:`sharded_main_path`."""
        spec, cfg = specs[name], best_config(name)
        big = StencilSpec(spec.name, (spec.dims[0] * N_SHARDS,)
                          + tuple(spec.dims[1:]), spec.iterations, spec.taps)
        mesh = halo.make_mesh(N_SHARDS, devices=mesh_devices)
        spair, g = stream_shard.sharded_stream_pair(big, cfg, mesh)
        H, local = g.halo, g.local_rows
        sa, sb = [], []
        for d in mesh.devices:
            a = torch.zeros(g.slab_dims, dtype=g.dtype, device=d)
            a[H:H + local] = torch.rand((local,) + tuple(spec.dims[1:]),
                                        device=d) * 100.0
            sa.append(a)
            sb.append(torch.zeros_like(a))
        ms = time_pairs(spair, sa, sb, mesh.devices)
        line = {"stencil": name, "cfg": cfg.label(), "dims": list(big.dims),
                "devices": [str(d) for d in mesh.devices],
                "single_ms_per_pair": single_ms_per_pair,
                "weak_ms_per_pair": ms,
                "weak_scaling_efficiency": single_ms_per_pair / ms,
                "exchange_us": time_exchange(g, sa, mesh.devices)}
        print("weak-scaling measured " + json.dumps(line))
        report["weak_scaling_measured"].append(line)
        del sa, sb
        torch.cuda.empty_cache()
        return line

    def sharded_phase():
        """Phase 11: every winner in fp32, ``shard_names`` in bf16, then the
        weak-scaling MODEL on this run's single-device times and copy
        time.  Returns the fp32 and the bf16 lines by stencil."""
        fp32 = {n: sharded_main_path(n, "float32") for n in names}
        bf16 = {n: sharded_main_path(n, "bfloat16") for n in shard_names}
        copy_s = float(np.median([x["copy_us"] for x in fp32.values()])) / 1e6
        model_rows = winner_rows(
            N_SHARDS, latency_s=copy_s,
            ms_per_step={n: x["single_ms_per_pair"]
                         / (2 * best_config(n).step)
                         for n, x in fp32.items()})
        report["weak_scaling_model"] = [m for m in model_rows
                                        if m["name"] in fp32]
        for m in report["weak_scaling_model"]:
            print("weak-scaling model (not measured) " + json.dumps(m))
        return fp32, bf16

    def dryrun_phase():
        """Phase 13: ``dryrun_multichip`` on the mesh's devices."""
        kernels.reset_launches()
        dry = entry_mod.dryrun_multichip(N_SHARDS, devices=mesh_devices)
        for d in set(mesh_devices):
            torch.cuda.synchronize(d)
        dry["launches"] = kernels.stencil2d_levels_shard.launches
        print("dryrun " + json.dumps(dry))
        report["dryrun"] = dry
        if dry["launches"] != 2 * N_SHARDS:
            raise RuntimeError(f"dryrun_multichip launched {dry['launches']} "
                               f"shard kernels, expected {2 * N_SHARDS}")

    def phase_done(n):
        """Seconds since the start, after phase ``n``."""
        t = time.perf_counter() - t_start
        report.setdefault("phase_seconds", {})[str(n)] = t
        print(f"phase {n} done at {t:.1f} s")

    def write_report():
        os.makedirs(kernels.BUILD_DIR, exist_ok=True)
        path = os.path.join(kernels.BUILD_DIR, "chip_smoke.json")
        with open(path, "w") as fh:
            json.dump(report, fh, indent=1)

    def ok_line():
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": kind,
            "count": torch.cuda.device_count()}}))

    def multi_device_only():
        """``--mesh-devices``: phases 11 and 13 on several cards, and weak
        scaling measured there."""
        fp32, _ = sharded_phase()
        for name in names:
            weak_scaling(name, fp32[name]["single_ms_per_pair"])
        dryrun_phase()
        write_report()
        print(smi)
        ok_line()
        return 0

    def factor_main_path(name, step, dtype, row):
        """``StencilProgram`` in factor mode at the .stc size: time() and
        device_check(pairs=1), launches counted from 0 around them, beside
        the unfactored trapezoid of the same step."""
        spec = specs.get(name) or load_stc(os.path.join(bench, name + ".stc"))
        cfg = KernelConfig(step=step, factor=True, dtype=dtype)
        prog = StencilProgram(spec, cfg)
        kernels.reset_launches()
        res = prog.time(warmup_pairs=1, pairs=PAIRS)
        diff = prog.device_check(pairs=1)
        launches = kernels.stencil2d_factor_levels.launches
        row["launches"] = launches
        other = StencilProgram(spec, KernelConfig(
            step=step, trapezoid=step > 1, dtype=dtype))
        unfactored = other.time(warmup_pairs=1, pairs=PAIRS)
        line = {"stencil": name, "cfg": cfg.label(), "dtype": dtype,
                "ms_per_step": res.seconds_per_pair * 1e3 / (2 * step),
                "unfactored_cfg": other.cfg.label(),
                "unfactored_ms_per_step":
                    unfactored.seconds_per_pair * 1e3 / (2 * step),
                "max_dev_diff": diff, "launches": launches}
        print("factor " + json.dumps(line))
        report["factor"].append(line)
        if launches <= 0 or not diff <= DEVICE_CHECK_TOL[dtype]:
            raise RuntimeError(f"{name} factor step {step} {dtype} failed: "
                               f"{line}")
        del prog, other
        torch.cuda.empty_cache()

    def main_path(key, dtype, rows):
        """``StencilProgram`` on case ``key``'s config in ``dtype``: time(),
        device_check(pairs=1), launches counted from 0 around them."""
        name, cfg = cases[key]
        spec, cfg = specs[name], cfg.replace(dtype=dtype)
        kernel = kernels.kernel_for(spec.ndim)
        prog = StencilProgram(spec, cfg)
        kernels.reset_launches()
        res = prog.time()
        diff = prog.device_check(pairs=1)
        launches = kernel.launches
        rows[key]["launches"] = launches
        ms_pair = res.seconds_per_pair * 1e3
        line = {
            "stencil": key, "cfg": cfg.label(), "dims": list(spec.dims),
            "dtype": dtype, "ms_per_pair": ms_pair,
            "ms_per_step": ms_pair / (2 * prog.an.step),
            "gstencil_per_s": res.gstencil_per_s,
            "roofline_frac": res.gstencil_per_s / naive_sol_gstencil(
                prog.dtype.itemsize, kind),
            "max_dev_diff": diff, "launches": launches,
        }
        print(json.dumps(line))
        report["main_path"].append(line)
        if launches <= 0:
            raise RuntimeError(f"{key} {dtype}: main path launched no "
                               "kernel")
        if not diff <= DEVICE_CHECK_TOL[dtype]:
            raise RuntimeError(f"{key} {dtype}: device_check {diff} > "
                               f"{DEVICE_CHECK_TOL[dtype]}")
        del prog
        torch.cuda.empty_cache()

    def golden(key, dtype):
        """``check()`` against the fp64 golden model at the reduced size."""
        name, cfg = cases[key]
        full = specs[name]
        cfg = cfg.replace(dtype=dtype)
        spec = StencilSpec(full.name, REDUCED[full.ndim], full.iterations,
                           full.taps)
        prog = StencilProgram(spec, cfg)
        max_err, rms = prog.check()
        a = prog.final_a(prog.run_pairs(prog.init_state(), prog.num_pairs()))
        h = prog.an.halo
        inner = a[tuple(slice(h, s - h) for s in a.shape)]
        scale = max(1.0, float(np.abs(inner).max()) / 100.0)
        line = {"stencil": key, "dims": list(spec.dims), "dtype": dtype,
                "max_err": max_err, "rms_err": rms, "tol_scale": scale}
        print("golden " + json.dumps(line))
        report["golden"].append(line)
        max_tol, rms_tol = GOLDEN_TOL[dtype]
        if not (max_err < max_tol * scale and rms < rms_tol * scale):
            raise RuntimeError(f"{key} {dtype}: fp64 golden check failed "
                               f"{line}")

    # -- phases 14-16: helpers ------------------------------------------------
    emit_dir = os.path.join(kernels.BUILD_DIR, "chip_smoke_emitted")

    def cli_flags(cfg):
        """``cfg`` as the compiler CLI's flags."""
        flags = ["--step", str(cfg.step), "--dist", str(cfg.distance),
                 "--merge-forward", str(cfg.merge_forward),
                 "--bx", str(cfg.tm or 0), "--ch", str(cfg.ch or 0),
                 "--dtype", cfg.dtype, "--block", str(cfg.block),
                 "--jfix", cfg.jfix, "--prefetch", str(cfg.prefetch)]
        if cfg.lane_mode:
            flags += ["--lane-mode", cfg.lane_mode]
        for flag, on in (("--trapezoid", cfg.trapezoid),
                         ("--vfuse", cfg.vfuse)):
            if on:
                flags.append(flag)
        return flags

    def load_program(path):
        """An emitted program as a module (its ``__file__`` places its
        build directory)."""
        import importlib.util

        mspec = importlib.util.spec_from_file_location(
            "emitted_" + hashlib.sha256(path.encode()).hexdigest()[:12], path)
        mod = importlib.util.module_from_spec(mspec)
        mspec.loader.exec_module(mod)
        return mod

    def emitted_row(mod, name, dtype, library_row):
        """One emitted program at the .stc size: its kernel against its
        emitted plain version and against the library kernel on the same
        input, timed in turns with the library kernel (library, emitted,
        emitted, library), then its ``main()`` for a few pairs."""
        spec, cfg = specs[name], best_config(name).replace(dtype=dtype)
        an = analyze(spec, cfg.step, cfg.distance, cfg.merge_forward)
        plan = level_plan(an, cfg)
        tdt = state_dtype(dtype)
        kernel = mod.build_call(dev)        # built already: a cache hit
        libk = kernels.kernel_for(spec.ndim)
        src = (torch.rand(tuple(spec.dims), generator=gen, device=dev)
               * 100.0).to(tdt)
        got, want, lib_out = (torch.zeros_like(src) for _ in range(3))
        kernel(src, got)
        mod.plain_apply(src, want)
        libk(src, lib_out, plan)
        torch.cuda.synchronize()
        row = {"name": f"emitted_stencil{spec.ndim}d"
                       + kernels.BUILDS[tdt], "stencil": name,
               "cfg": cfg.label(), "dtype": dtype, "route": "cuda",
               "source": "drstencil_tpu_torch/emit.py",
               "replaces": "native/emit.hpp:733", "launches": 0,
               "levels": plan.levels, "taps": len(plan.coeffs),
               "dims": list(spec.dims), "tile": list(mod.TILE)}
        ok = within_tolerance(got, want, dtype, row)
        vs_lib = {}
        if dtype == "float32":
            vs_lib["rel_err"] = relative_diff(got, lib_out)
            same = vs_lib["rel_err"] <= EMIT_TOL
        else:
            same = within_tolerance(got, lib_out, dtype, vs_lib)
        row["vs_library_rel_err"] = vs_lib["rel_err"]
        row["cells_differing_from_library"] = int((got != lib_out).sum())
        lib_ms, ms = [], []
        for fn, into in ((lambda: libk(src, lib_out, plan), lib_ms),
                         (lambda: kernel(src, got), ms),
                         (lambda: kernel(src, got), ms),
                         (lambda: libk(src, lib_out, plan), lib_ms)):
            into.append(cuda_ms(torch, fn, 10))
        row["ms"] = sum(ms) / 2
        row["library_kernel_ms"] = sum(lib_ms) / 2
        row["plain_ms"] = cuda_ms(torch, lambda: mod.plain_apply(src, want),
                                  3)
        # the yardstick and the bound are the library kernel's row's: the
        # same function on the same shapes, timed earlier in this run
        row["library_ms"] = library_row["library_ms"]
        row["bound_ms"], row["bound_by"] = traffic_model(an, cfg).bound_ms(
            hbm_gbps, fp32_tflops)
        del src, got, want, lib_out
        torch.cuda.empty_cache()
        res = mod.main(["--pairs", str(EMIT_PAIRS), "--warmup",
                        str(EMIT_WARMUP)])
        row["launches"] = res["launches"]
        row["main_ms_per_pair"] = res["ms"] / EMIT_PAIRS
        print(f"emitted {name}: " + json.dumps(row))
        report["emitted"].append(row)
        if not (ok and same
                and res["launches"] == 2 * (EMIT_PAIRS + EMIT_WARMUP)):
            raise RuntimeError(f"emitted program of {name} {dtype} failed: "
                               f"{row}")
        torch.cuda.empty_cache()
        return row

    def emitted_phase(library_rows):
        """Phase 14.  ``library_rows`` are phase 2's and phase 6's rows by
        dtype and stencil (made here where those phases were skipped).
        Returns the emitted kernels' rows."""
        os.makedirs(emit_dir, exist_ok=True)
        wanted = ([(n, "float32") for n in names]
                  + [(n, "bfloat16") for n in shard_names])
        mods = []
        for name, dtype in wanted:
            cfg = best_config(name).replace(dtype=dtype)
            path = os.path.join(emit_dir, f"{name}__{cfg.label()}.py")
            rc = cli_mod.main([os.path.join(bench, name + ".stc"), "-o", path,
                               "--check", *cli_flags(cfg)])
            if rc != 0:
                raise RuntimeError(f"the CLI refused {name} {cfg.label()}")
            mods.append(load_program(path))
        # one nvcc per program, all started together
        from concurrent.futures import ThreadPoolExecutor

        t0 = time.perf_counter()
        with ThreadPoolExecutor(max_workers=len(mods)) as pool:
            logs = list(pool.map(lambda m: m.compile_kernel()[1], mods))
        report["emitted_build_seconds"] = time.perf_counter() - t0
        print(f"{len(mods)} emitted kernels built in "
              f"{report['emitted_build_seconds']:.1f}s")
        for (name, dtype), log in zip(wanted, logs):
            print_ptxas(log, f" {name} {dtype}")
        rows = []
        for (name, dtype), mod in zip(wanted, mods):
            base = library_rows[dtype].get(name) or kernel_row(name, dtype)
            rows.append(emitted_row(mod, name, dtype, base))
        emitted_runs()
        return rows

    def emitted_runs():
        """Five programs emitted by ``python -m drstencil_tpu_torch.cli``
        and run as their own processes at the reduced size, all started
        together; each must exit 0 and, with ``--check``, print [Test]
        lines within the fp64-golden tolerances."""
        four = ",".join(["cuda:0"] * N_SHARDS)
        runs = [
            ("2d5pt_star", ["--step", "4", "--trapezoid", "--check"],
             ["--check"], "float32"),
            ("3d13pt_star", ["--step", "1", "--check"], ["--check"],
             "float32"),
            ("2d9pt_star", ["--step", "2", "--trapezoid", "--dtype",
                            "bfloat16", "--check"], ["--check"], "bfloat16"),
            ("3d7pt_star", ["--step", "3", "--trapezoid", "--shard",
                            str(N_SHARDS), "--check"],
             ["--check", "--devices", four], "float32"),
            ("2d5pt_star", ["--step", "2", "--gold"], None, None),
        ]
        env = dict(os.environ)
        env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
        procs = []
        for i, (name, emit_flags, run_flags, dtype) in enumerate(runs):
            full = specs.get(name) or load_stc(
                os.path.join(bench, name + ".stc"))
            small = StencilSpec(full.name, REDUCED[full.ndim],
                                full.iterations, full.taps)
            stc = os.path.join(emit_dir, f"run{i}_{name}.stc")
            out_py = os.path.join(emit_dir, f"run{i}_{name}.py")
            with open(stc, "w") as fh:
                fh.write(small.to_stc())
            run = ([sys.executable, out_py, "--pairs", "1"]
                   if run_flags is None else
                   [sys.executable, out_py, "--pairs", str(RUN_PAIRS),
                    "--warmup", str(RUN_WARMUP), *run_flags])
            emit_cmd = [sys.executable, "-m", "drstencil_tpu_torch.cli", stc,
                        "-o", out_py, *emit_flags]
            # emit, then run the program from another directory and with no
            # path to the package: it stands alone
            script = ("import os, subprocess, sys; "
                      f"subprocess.run({emit_cmd!r}, check=True); "
                      "env = {k: v for k, v in os.environ.items() "
                      "if k != 'PYTHONPATH'}; "
                      f"sys.exit(subprocess.run({run!r}, cwd={emit_dir!r}, "
                      "env=env).returncode)")
            procs.append(subprocess.Popen(
                [sys.executable, "-c", script], env=env, cwd=ROOT,
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
        try:
            outs = [p.communicate(timeout=EMIT_TIMEOUT_S) for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
        for (name, emit_flags, run_flags, dtype), p, (out, err) in zip(
                runs, procs, outs):
            line = {"stencil": name, "emit": emit_flags, "run": run_flags,
                    "rc": p.returncode}
            ok = p.returncode == 0
            if run_flags is None:
                ok = ok and "checksum:" in out
            elif ok:
                vals = {k: float(out.split(f"[Test] {k}:")[1].split()[0])
                        for k in ("Max Error", "RMS Error",
                                  "Max Relative Error")}
                line.update(max_err=vals["Max Error"],
                            rms_err=vals["RMS Error"],
                            max_rel_err=vals["Max Relative Error"],
                            launches=int(out.split("kernel launches:")[1]
                                         .split()[0]),
                            ms=float(out.split("GPU computation time:")[1]
                                     .split()[0]))
                # max|gold| = max error / max relative error (floored at 1)
                top = (vals["Max Error"] / vals["Max Relative Error"]
                       if vals["Max Relative Error"] > 0 else 1.0)
                line["tol_scale"] = max(1.0, top / 100.0)
                max_tol, rms_tol = GOLDEN_TOL[dtype]
                shards = N_SHARDS if "--shard" in emit_flags else 1
                ok = (vals["Max Error"] < max_tol * line["tol_scale"]
                      and vals["RMS Error"] < rms_tol * line["tol_scale"]
                      and line["launches"]
                      == 2 * shards * (RUN_PAIRS + RUN_WARMUP))
            print("emitted run " + json.dumps(line))
            report["emitted_runs"].append(line)
            if not ok:
                raise RuntimeError(f"emitted program run failed: {line}\n"
                                   f"{out[-2000:]}\n{err[-3000:]}")

    def tile2d_phase():
        """Phase 15.  Returns ``tile2d_fused``'s rows, one per row of the
        experiment's ``SWEEP``."""
        rows, table = [], []
        for name, sweep in exp_tile2d.SWEEP.items():
            spec = specs.get(name) or load_stc(
                os.path.join(bench, name + ".stc"))
            R, C = spec.dims
            for step, tm in sweep:
                an = analyze(spec, step=step, require_partition=False)
                taps = kernels.tile2d_taps(an.fused, an.halo)
                src = torch.zeros((R + 2 * tm, C), device=dev)
                src[tm:tm + R] = torch.rand((R, C), generator=gen,
                                            device=dev) * 100.0
                fill = torch.rand((R + 2 * tm, C), generator=gen,
                                  device=dev) - 0.5
                got, want = fill.clone(), fill.clone()
                kernels.tile2d_fused(src, got, taps, tm)
                kernels.tile2d_fused.plain(src, want, taps, tm)
                torch.cuda.synchronize()
                built = kernels.tile2d_plan(taps, src.shape, tm).load()
                row = {"name": "tile2d_fused", "stencil": name,
                       "dtype": "float32", "step": step, "tm": tm,
                       "route": kernels.tile2d_fused.route,
                       "source": kernels.tile2d_fused.source,
                       "replaces": kernels.tile2d_fused.replaces,
                       "launches": 0, "taps": taps.ntaps,
                       "halo": an.halo, "dims": [R + 2 * tm, C],
                       "tile": list(built.geometry.tile),
                       "smem_bytes": built.geometry.smem_bytes,
                       "ctas_per_sm_by_smem": built.geometry.ctas_per_sm,
                       "build_seconds": built.build_seconds,
                       **built.ptxas()}
                ok = within_tolerance(got[tm:tm + R], want[tm:tm + R],
                                      "float32", row)
                row["pads_unchanged"] = bool(
                    torch.equal(got[:tm], fill[:tm])
                    and torch.equal(got[tm + R:], fill[tm + R:]))
                row["ms"] = cuda_ms(
                    torch, lambda: kernels.tile2d_fused(src, got, taps, tm),
                    20)
                row["plain_ms"] = cuda_ms(
                    torch, lambda: kernels.tile2d_fused.plain(
                        src, want, taps, tm), 3)
                # yardstick: one cuDNN convolution of the fused table on
                # the data block (zero padding, TF32 off)
                h = an.halo
                weight = torch.zeros((1, 1, 2 * h + 1, 2 * h + 1), device=dev)
                for (di, dj), c in an.fused.items():
                    weight[0, 0, di + h, dj + h] = c
                x4 = src[None, None, tm:tm + R]
                row["library_ms"] = cuda_ms(
                    torch, lambda: F.conv2d(x4, weight, padding=h), 3)
                bytes_ms = 2 * 4 * R * C / (hbm_gbps * 1e9) * 1e3
                ops_ms = 2 * taps.ntaps * R * C / (fp32_tflops * 1e12) * 1e3
                row["bound_ms"] = max(bytes_ms, ops_ms)
                row["bound_by"] = ("bytes" if bytes_ms >= ops_ms
                                   else "operations")
                del src, fill, got, want, x4
                torch.cuda.empty_cache()
                if not (ok and row["pads_unchanged"]):
                    raise RuntimeError(f"tile2d_fused failed: {row}")
                rows.append(row)
        # the experiment itself: each stencil's winner, then each tile
        # program checked against the torch gold and timed
        for name in exp_tile2d.SWEEP:
            spec = specs.get(name) or load_stc(
                os.path.join(bench, name + ".stc"))
            win = exp_tile2d.measure_winner(spec)
            for row in (r for r in rows if r["stencil"] == name):
                kernels.reset_launches()
                ms = exp_tile2d.measure_tile(spec, row["step"], row["tm"])
                row["launches"] = kernels.tile2d_fused.launches
                row["ms_per_step"], row["winner_ms_per_step"] = ms, win
                table.append((name, row["step"], row["tm"], ms, win))
                torch.cuda.empty_cache()
        exp_tile2d.print_table(table)
        for row in rows:
            print("tile2d " + json.dumps(row))
        report["tile2d"] = rows
        return rows

    def small_probe_check():
        """Phase 16 first: every variant and depth on small grids with a
        ragged tail (R = 200, TM = 48), one tile that wraps onto itself (N
        = PROBE_TILE) and four tiles, against plain."""
        R, TM, HK = 200, 48, 8
        written = torch.zeros(R, dtype=torch.bool, device=dev)
        for i in range(R // TM):
            written[i * TM:i * TM + TM - 4 * HK] = True
        for N in (kernels.PROBE_TILE, 4 * kernels.PROBE_TILE):
            for variant in kernels.PROBE_VARIANTS:
                shape = (R, N) if variant == "A" else (R + 2 * HK, N)
                x = torch.rand(shape, generator=gen, device=dev) * 100.0
                fill = torch.rand((R, N), generator=gen, device=dev) - 0.5
                for depth in exp_overlap.DEPTHS:
                    got, want = fill.clone(), fill.clone()
                    _, carry = kernels.overlap_probe(x, got, variant, depth,
                                                     TM, HK)
                    _, want_carry = kernels.overlap_probe.plain(
                        x, want, variant, TM, HK, kernels.overlap_probe.n_ctas(
                            dev, (R, N), variant, depth, TM, HK))
                    torch.cuda.synchronize()
                    row = {"name": "overlap_probe small", "variant": variant,
                           "depth": depth, "dims": [R, N]}
                    ok = (within_tolerance(got[written], want[written],
                                           "float32", row)
                          and torch.equal(got[~written], fill[~written])
                          and (carry is None if want_carry is None
                               else torch.equal(carry, want_carry)))
                    print("overlap small " + json.dumps(row))
                    if not ok:
                        raise RuntimeError(f"overlap_probe failed: {row}")

    def overlap_phase():
        """Phase 16.  Returns ``overlap_probe``'s rows, one per variant and
        depth."""
        small_probe_check()
        R, N, TM, HK = (exp_overlap.R, exp_overlap.N, exp_overlap.TM,
                        exp_overlap.HK)
        n_strips, wrote = R // TM, TM - 4 * HK
        written = torch.zeros(R, dtype=torch.bool, device=dev)
        for i in range(n_strips):
            written[i * TM:i * TM + wrote] = True
        # yardstick: the two levels as two cuDNN convolutions (columns
        # wrapped by circular padding, TF32 off): level 1 on each strip's
        # window rows, level 2 on its result
        w5 = torch.tensor([[0.02, 0.05, 0.1, 0.05, 0.02],
                           [0.05, 0.1, 0.2, 0.1, 0.05],
                           [0.1, 0.2, 0.3, 0.2, 0.1],
                           [0.05, 0.1, 0.2, 0.1, 0.05],
                           [0.02, 0.05, 0.1, 0.05, 0.02]], device=dev)
        # the rows a strip's result needs, read once, and its rows written
        need_bytes = 4 * N * n_strips * ((wrote + 8) + wrote)
        ops = 21 * N * n_strips * ((TM - 2 * HK) + wrote)
        rows1 = TM - 2 * HK
        rows = []
        for variant in kernels.PROBE_VARIANTS:
            shape = (R, N) if variant == "A" else (R + 2 * HK, N)
            x = torch.rand(shape, generator=gen, device=dev) * 100.0
            fill = torch.rand((R, N), generator=gen, device=dev) - 0.5
            strips = x[:n_strips * TM].view(n_strips, 1, TM, N)

            def library(strips=strips):
                lvl1 = F.conv2d(F.pad(strips[:, :, :rows1 + 4],
                                      (2, 2, 0, 0), mode="circular"),
                                w5[None, None])
                return F.conv2d(F.pad(lvl1[:, :, :wrote + 4], (2, 2, 0, 0),
                                      mode="circular"), w5[None, None])

            library_ms = cuda_ms(torch, library, 3)
            lib_out = library()[:, 0]
            # the variant's whole windows read once (the experiment copies
            # them on purpose) and the written rows written once
            wrows = TM if variant == "A" else TM + 2 * HK
            window_bytes_ms = (4 * N * n_strips * (wrows + wrote)
                               / (hbm_gbps * 1e9) * 1e3)
            for depth in exp_overlap.DEPTHS:
                call, _ = exp_overlap.make(variant, depth, dev)
                got, want = fill.clone(), fill.clone()
                _, carry = call(x, got)
                n_ctas = kernels.overlap_probe.n_ctas(
                    dev, (R, N), variant, depth, TM, HK)
                info = kernels.overlap_probe.info(dev, variant, depth, TM, HK)
                _, want_carry = kernels.overlap_probe.plain(
                    x, want, variant, TM, HK, n_ctas)
                torch.cuda.synchronize()
                row = {"name": "overlap_probe", "stencil": f"{variant}"
                       f" depth {depth}", "dtype": "float32",
                       "variant": variant, "depth": depth, "ctas": n_ctas,
                       "route": kernels.overlap_probe.route,
                       "source": kernels.overlap_probe.source,
                       "replaces": kernels.overlap_probe.replaces,
                       "launches": 0, "dims": list(shape), **info}
                ok = within_tolerance(got[written], want[written], "float32",
                                      row)
                wview = want[:n_strips * TM].view(n_strips, TM, N)[:, :wrote]
                row["library_rel_err"] = float(
                    (lib_out - wview).abs().max() / wview.abs().max())
                row["unwritten_unchanged"] = bool(
                    torch.equal(got[~written], fill[~written]))
                row["carry_equal"] = (carry is None if want_carry is None
                                      else bool(torch.equal(carry,
                                                            want_carry)))
                row["plain_ms"] = cuda_ms(
                    torch, lambda: kernels.overlap_probe.plain(
                        x, want, variant, TM, HK, n_ctas), 3)
                row["library_ms"] = library_ms
                bytes_ms = need_bytes / (hbm_gbps * 1e9) * 1e3
                ops_ms = ops / (fp32_tflops * 1e12) * 1e3
                row["bound_ms"] = max(bytes_ms, ops_ms)
                row["bound_by"] = ("bytes" if bytes_ms >= ops_ms
                                   else "operations")
                row["window_bytes_ms"] = window_bytes_ms
                if not (ok and row["unwritten_unchanged"]
                        and row["carry_equal"]):
                    raise RuntimeError(f"overlap_probe failed: {row}")
                rows.append(row)
            del x, fill, strips, lib_out, got, want
            torch.cuda.empty_cache()
        # the experiment itself: its own times, counted launch by launch
        sweep_bytes_ms = exp_overlap.bytes_ms(dev)
        print(f"overlap: one sweep moves {2 * 4 * R * N / 1e9:.3f} GB: "
              f"{sweep_bytes_ms:.4f} ms at the HBM peak")
        for row in rows:
            kernels.reset_launches()
            row["ms"] = exp_overlap.measure(row["variant"], row["depth"], dev)
            row["launches"] = kernels.overlap_probe.launches
            row["compute_only_ms"] = exp_overlap.measure(
                row["variant"], row["depth"], dev, load=False)
            row["compute_only_info"] = kernels.overlap_probe.info(
                dev, row["variant"], row["depth"], TM, HK, load=False)
            row["sweep_bytes_ms"] = sweep_bytes_ms
            print("overlap " + json.dumps(row))
        report["overlap"] = rows
        return rows

    if args.mesh_devices:
        return multi_device_only()

    phase_done(1)
    if args.from_phase <= 2:
        # -- 2. each kernel against its plain version ---------------------------
        kernel_rows = {k: kernel_row(k, "float32") for k in cases}

        # -- 3. main path at the .stc size ---------------------------------------
        for key in cases:
            main_path(key, "float32", kernel_rows)

        # -- 4. fp64 golden at reduced size --------------------------------------
        for key in cases:
            golden(key, "float32")

        # -- 5. the entry point ---------------------------------------------------
        pair, (a, b) = entry_mod.entry()
        base = load_stc(os.path.join(bench, "2d5pt_star.stc"))
        spec = StencilSpec(base.name, tuple(a.shape), base.iterations, base.taps)
        cfg = KernelConfig(variant="stream", step=1)
        gold = xla_ref.apply_interior(analyze(spec, cfg.step))
        ga, gb = a.clone(), b.clone()
        kernels.reset_launches()
        pair(a, b)
        gold(ga, gb)
        gold(gb, ga)
        torch.cuda.synchronize()
        graft_rel = relative_diff(a, ga)
        max_err, rms = StencilProgram(spec, cfg).check()
        graft = {"stencil": "2d5pt_star", "cfg": cfg.label(),
                 "dims": list(a.shape), "rel_vs_gold": graft_rel,
                 "golden_max_err": max_err, "golden_rms": rms,
                 "launches": kernels.stencil2d_levels.launches}
        print("graft " + json.dumps(graft))
        report["graft"] = graft
        if not (graft["dims"] == list(GRAFT_DIMS) and graft["launches"] >= 2
                and graft_rel <= KERNEL_TOL
                and max_err < MAX_TOL and rms < RMS_TOL):
            raise RuntimeError(f"entry() failed: {graft}")
        del a, b, ga, gb

        # -- 6. the bf16 builds against their plain version ----------------------
        bf16_rows = {k: kernel_row(k, "bfloat16") for k in cases}

        # -- 7. the bf16 main path at the .stc size -------------------------------
        for key in cases:
            main_path(key, "bfloat16", bf16_rows)

        # -- 8. bf16 fp64 golden at reduced size ---------------------------------
        for key in cases:
            golden(key, "bfloat16")

        # -- 9. the autotuner on the card ----------------------------------------
        kernels.reset_launches()
        report["tuner"] = tune_phase(
            torch, Tuner, tuned_mod, session_mod, bench, specs)
        report["tuner"]["launches"] = {
            k.name: k.launches for k in kernels.PLAN_KERNELS if k.launches}
        print("tune launches " + json.dumps(report["tuner"]["launches"]))
        if not report["tuner"]["launches"]:
            raise RuntimeError("the tuner's sweeps launched no per-plan "
                               "kernel")
        report["geometry"] = geometry_phase()
        phase_done(9)

    if args.from_phase <= 10:
        # -- 10. the shard-local kernels against their plain version -------------
        shard_rows = {dt: {n: shard_kernel_row(n, dt) for n in shard_names}
                      for dt in ("float32", "bfloat16")}

        # -- 11. the sharded main path at the .stc size ---------------------------
        for dt, lines in zip(shard_rows, sharded_phase()):
            for name in shard_names:
                shard_rows[dt][name]["launches"] = lines[name]["launches"]

        # -- 12. factor mode -------------------------------------------------------
        factor_rows = []
        for name in FACTOR_STENCILS:
            for step in FACTOR_STEPS:
                for dt in ("float32", "bfloat16"):
                    row = factor_kernel_row(name, step, dt)
                    factor_main_path(name, step, dt, row)
                    factor_rows.append(row)

        # -- 13. the multi-device dry run -------------------------------------------
        dryrun_phase()
        phase_done(13)

    # -- 14. emitted programs -------------------------------------------------
    kernels.reset_launches()
    emitted_rows = emitted_phase(
        {"float32": kernel_rows, "bfloat16": bf16_rows}
        if args.from_phase <= 2 else {"float32": {}, "bfloat16": {}})

    # -- 15. the plain-tile experiment -----------------------------------------
    tile2d_rows = tile2d_phase()

    # -- 16. the overlap probe ---------------------------------------------------
    overlap_rows = overlap_phase()
    phase_done(16)

    # -- 17. the bench --------------------------------------------------------
    report["bench"] = bench_phase(kind)
    phase_done(17)

    # -- 18. one trace, read back ----------------------------------------------
    report["trace"] = trace_phase()
    phase_done(18)

    if args.from_phase > 2:
        write_report()
        print(f"partial run from phase {args.from_phase}: no result lines")
        return 0

    # -- 19. result lines ----------------------------------------------------
    if sha256(tuned_json) != tuned_sha:
        raise RuntimeError("benchmarks/tuned.json changed during the run")
    keys = ("name", "stencil", "dtype", "route", "source", "replaces",
            "launches", "max_abs_err", "ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms")
    all_rows = ([kernel_rows[k] for k in cases] + [bf16_rows[k] for k in cases]
                + [shard_rows[dt][n] for dt in shard_rows for n in shard_names]
                + factor_rows + emitted_rows + tile2d_rows + overlap_rows)
    idle = [r["name"] for r in all_rows if r["launches"] <= 0]
    if idle:
        raise RuntimeError(f"kernels never launched on their path: {idle}")
    report["kernels"] = all_rows
    write_report()
    print(smi)
    print(json.dumps({"kernels": [{k: r[k] for k in keys}
                                  for r in all_rows]}))
    ok_line()
    return 0


def lost_mode_cases(names, specs) -> dict:
    """``"<name> tpu"`` -> ``(name, TPU config)`` for each kernel mode of
    ``MODES`` that a TPU winner of ``names`` (``benchmarks/tuned.json``)
    runs and no winner of ``best_config`` does: the first such stencil's
    TPU config, so that no mode loses its check on the card."""
    from drstencil_tpu_torch.ir.passes import analyze
    from drstencil_tpu_torch.ops.stream import is_deep, n_levels
    from drstencil_tpu_torch.tune.tuned import (best_config, tpu_config,
                                                tuned_entries)

    def modes(name, cfg):
        spec = specs[name]
        an = analyze(spec, cfg.step, cfg.distance, cfg.merge_forward)
        return {m for m, has in (
            ("K1 single level", n_levels(an, cfg) == 1),
            ("K3 value-fused", cfg.vfuse),
            ("K4 deep", is_deep(an, cfg))) if has}

    # the TPU configs without their TPU tile sizes (tm, ch)
    tpu = {n: tpu_config(e["config"])
           for n, e in tuned_entries().items() if n in names}
    running = set().union(*(modes(n, best_config(n)) for n in names))
    out = {}
    for mode in MODES:
        if mode in running:
            continue
        for name in sorted(tpu):
            if mode in modes(name, tpu[name]):
                out[f"{name} tpu"] = (name, tpu[name])
                break
    return out


def tune_phase(torch, Tuner, tuned_mod, session_mod, bench, specs) -> dict:
    """Short sweeps on the card: for each of ``TUNE_STENCILS``, the
    candidates of its labels at its prior's step (fp32 and bf16 streams,
    the tiles and the xla gold of the 2D stencil's), then the prior once
    more through the isolated worker, then one
    profiler trace.  Writes only under a temporary directory; raises
    unless every kind was measured with no error and no failed check."""
    from drstencil_tpu_torch.ir.spec import load_stc
    from drstencil_tpu_torch.tune.space import representative
    from drstencil_tpu_torch.utils.trace_summary import busy_share

    out = {"sweeps": {}, "isolated": None, "trace": None}
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    saved = tuned_mod.TUNED_GPU_PATH
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as tmp:
        tuned_mod.TUNED_GPU_PATH = os.path.join(tmp, "tuned_gpu.json")
        try:
            entries = []
            for name, labels in TUNE_STENCILS:
                spec = specs.get(name) or load_stc(
                    os.path.join(bench, name + ".stc"))
                prior = representative(tuned_mod.best_config(name),
                                       spec.ndim)
                tuner = Tuner(spec, tmp, pairs=TUNE_PAIRS,
                              config_timeout_s=TUNE_TIMEOUT_S)
                res = tuner.sweep(label_filter=labels.format(step=prior.step),
                                  log=lambda m: print("tune " + m))
                ledger = dict(tuner.ledger)
                entries += list(ledger.values())
                out["sweeps"][name] = {
                    "best": res.best_cfg.label() if res.best_cfg else None,
                    "best_ms_per_step": res.best_ms, "tried": res.tried,
                    "errors": res.errors,
                    "configs": {k: {f: e.get(f) for f in (
                        "status", "ms_per_step", "gstencil_per_s",
                        "roofline_frac", "modeled_gbps", "max_dev_diff",
                        "error")} for k, e in sorted(ledger.items())}}
                print("tune " + json.dumps({name: out["sweeps"][name]}))
            # the prior once more, in its own worker process
            name = TUNE_STENCILS[0][0]
            spec = load_stc(os.path.join(bench, name + ".stc"))
            prior = representative(tuned_mod.best_config(name), spec.ndim)
            iso = Tuner(spec, os.path.join(tmp, "isolated"),
                        pairs=TUNE_PAIRS, isolate=True,
                        config_timeout_s=TUNE_TIMEOUT_S)
            ires = iso.sweep(label_filter=prior.label(),
                             log=lambda m: print("tune isolated " + m))
            ientry = iso.ledger.get(prior.label(), {})
            entries.append(ientry)
            out["isolated"] = {"config": prior.label(), "tried": ires.tried,
                               "errors": ires.errors,
                               "status": ientry.get("status"),
                               "ms_per_step": ientry.get("ms_per_step"),
                               "error": ientry.get("error")}
            print("tune isolated " + json.dumps(out["isolated"]))
            trace_dir = session_mod.session_trace(
                bench, tmp, name, log=lambda m: print("tune " + m))
            out["trace"] = busy_share(trace_dir) if trace_dir else None
            print("tune trace " + json.dumps(out["trace"]))
        finally:
            tuned_mod.TUNED_GPU_PATH = saved

    def kind(cfg):
        return (cfg["variant"], cfg["dtype"])

    ok = {kind(e["config"]) for e in entries if e.get("status") == "ok"}
    bad = [e for e in entries if e.get("status") != "ok"]
    out["measured_kinds"] = sorted(map(list, ok))
    need = {("stream", "float32"), ("stream", "bfloat16"), ("xla", "float32")}
    if bad or not need <= ok or out["isolated"]["status"] != "ok":
        raise RuntimeError(f"tuner phase failed: {len(bad)} configs not ok "
                           f"({bad[:2]}), kinds measured {sorted(ok)}, "
                           f"isolated {out['isolated']}")
    return out


def bench_phase(kind) -> dict:
    """Phase 17: the bench as its own process with ``BENCH_CHECK=1``; its
    JSON line is printed (not as the last line) and must hold every
    stencil of its suite, each scored, counted and within its gate."""
    from drstencil_tpu_torch.bench import ALL

    env = dict(os.environ, BENCH_CHECK="1")
    env.pop("BENCH_STENCILS", None)
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "drstencil_tpu_torch.bench"], cwd=ROOT,
        env=env, capture_output=True, text=True, timeout=BENCH_TIMEOUT_S)
    seconds = time.perf_counter() - t0
    line = proc.stdout.strip().splitlines()[-1] if proc.stdout.strip() else ""
    print("bench " + line)
    for err in proc.stderr.splitlines():
        if err.startswith("# "):
            print("bench " + err)
    launches = dict(re.findall(r"^# (\S+): launches=(\d+)", proc.stderr,
                               re.M))
    out = json.loads(line) if line.startswith("{") else {}
    detail = out.get("detail", {})
    rows = {n: r for n, r in detail.items() if not n.startswith("_")}
    bad = [n for n, r in rows.items()
           if "roofline_frac" not in r or int(launches.get(n, 0)) <= 0
           or not r.get("max_dev_diff", float("inf")) <= DEVICE_CHECK_TOL[
               "bfloat16" if "bfloat16" in r.get("cfg", "") else "float32"]]
    summary = {"value": out.get("value"), "unit": out.get("unit"),
               "rows": rows, "launches": {n: int(v)
                                          for n, v in launches.items()},
               "seconds": seconds, "rc": proc.returncode}
    if (proc.returncode != 0 or sorted(rows) != sorted(ALL) or bad
            or "_environment" in detail or kind not in out.get("unit", "")):
        raise RuntimeError(f"bench phase failed (rc {proc.returncode}, "
                           f"bad rows {bad}): {line[:2000]}\n"
                           f"{proc.stderr[-3000:]}")
    print(f"bench: value {out['value']} over {len(rows)} stencils in "
          f"{seconds:.1f} s")
    return summary


def trace_phase() -> dict:
    """Phase 18: ``python -m drstencil_tpu_torch.tuning.capture_trace`` of
    the 2d5pt_star winner as its own process (a second ``torch.profiler``
    session in this process, after phase 9's, recorded no CUDA events).
    Its last line is its JSON verdict, read through ``utils/trace_summary``
    in that process: the trace's kernel row must count the launches the
    wrapper counted in the traced window."""
    from drstencil_tpu_torch.tuning import capture_trace

    proc = subprocess.run(
        [sys.executable, "-m", "drstencil_tpu_torch.tuning.capture_trace",
         TRACE_STENCIL, "chip_smoke"], cwd=ROOT, capture_output=True,
        text=True, timeout=TRACE_TIMEOUT_S)
    lines = proc.stdout.strip().splitlines()
    if proc.returncode != 0 or not lines or not lines[-1].startswith("{"):
        raise RuntimeError(f"capture_trace failed (rc {proc.returncode}): "
                           f"{proc.stdout[-2000:]}\n{proc.stderr[-2000:]}")
    print("\n".join("trace " + line for line in lines[:-1]))
    verdict = json.loads(lines[-1])
    counted = sum(r["count"] for r in verdict["rows"]
                  if r["name"].startswith(TRACE_KERNEL))
    expect = 2 * (capture_trace.WARMUP_PAIRS
                  + capture_trace.REPEATS * capture_trace.PAIRS)
    out = {"stencil": TRACE_STENCIL, "launches": verdict["launches"],
           "kernel_rows_count": counted, "busy": verdict["busy"],
           "threads": sorted({r["thread"] for r in verdict["rows"]})}
    print("trace " + json.dumps(out))
    if not counted == out["launches"] == expect:
        raise RuntimeError(f"trace phase failed: {out}")
    return out


if __name__ == "__main__":
    sys.exit(main())
