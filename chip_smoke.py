#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (drstencil_tpu_torch) on one GPU.

Run from the repository root on a machine with one NVIDIA Hopper card:

    python3 chip_smoke.py                      # every tuned stencil
    python3 chip_smoke.py --stencils 2d5pt_star,3d7pt_star
    python3 chip_smoke.py --mesh-devices cuda:0,cuda:1,cuda:2,cuda:3
                                  # four cards: phases 11 and 13 with one shard
                                  # per card, and weak scaling measured

It builds the CUDA kernels from ``drstencil_tpu_torch/csrc`` (nvcc, into
``build/``) and runs, raising on the first failure:

1. environment: the card's name and power limit, versions, build time;
2. each kernel against its plain PyTorch version on every tuned winner's
   tap table at the ``.stc`` size (max|kernel - plain| / max|plain| <=
   1e-5), with the kernel's, the plain version's and a cuDNN convolution's
   times beside the kernel's bound;
3. the main path — ``StencilProgram(spec, best_config(name))`` at the
   ``.stc`` size: ``time()``, then ``device_check(pairs=1) <= 1e-3`` —
   with the kernel's launch count read around it;
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
9. the autotuner on the card: short sweeps of 2d5pt_star and 3d7pt_star
   at the ``.stc`` size (fp32, bf16 and xla candidates), one config
   through the isolated worker, and one profiler trace, into a temporary
   directory with ``TUNED_GPU_PATH`` pointed there;
10. the shard-local kernels against their plain version, fp32 and bf16,
    on a quarter slab of the ``.stc`` grid with its ghost rows, for the
    first, an interior and the last shard's store range (fp32 <= 1e-5
    relative, bf16 <= 1 ulp; everything outside the range bit-unchanged);
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
    step as the yardstick; then ``StencilProgram(spec, KernelConfig(step,
    factor=True))``: ``time()`` and ``device_check`` beside the unfactored
    trapezoid of the same step;
13. ``dryrun_multichip(4, devices=["cuda:0"] * 4)``;
14. one ``{"kernels": [...]}`` line (every kernel, fp32 and bf16 rows), the
    card line, then the ok line.

Details also go to ``build/chip_smoke.json``.  ``benchmarks/tuned.json``
is checked byte-identical at the end.  Without CUDA, or outside a
checkout of the repository, it exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
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
# phase 9: the stencils swept, the pairs per timing, the worker's cap
TUNE_STENCILS = ("2d5pt_star", "3d7pt_star")
TUNE_PAIRS = 4
TUNE_TIMEOUT_S = 300.0


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
    from drstencil_tpu_torch.tune import tuned as tuned_mod
    from drstencil_tpu_torch.tune.tuned import (
        best_config, card_peaks, naive_sol_gstencil, tuned_entries)
    from drstencil_tpu_torch.tune.tuner import Tuner
    from drstencil_tpu_torch.utils.profiling import traffic_model

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--stencils", default="",
                    help="comma-separated subset of benchmarks/tuned.json")
    ap.add_argument("--mesh-devices", default="",
                    help=f"{N_SHARDS} comma-separated CUDA devices: run only "
                         "the multi-device phases (11 and 13) with the mesh "
                         "on them, and measure weak scaling; the default "
                         f"mesh names cuda:0 {N_SHARDS} times")
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
    smi = nvidia_smi_line()
    kind = torch.cuda.get_device_name(0)
    hbm_gbps, fp32_tflops = card_peaks(kind)
    print(f"card: {smi}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")
    lib = kernels.build()
    print(f"kernels built in {lib.build_seconds:.1f}s -> "
          f"{os.path.relpath(lib.path, ROOT)}")
    for line in lib.build_log.splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            print(f"  ptxas: {line.strip()}")
    report = {"card": smi, "torch": torch.__version__,
              "cuda": torch.version.cuda,
              "build_seconds": lib.build_seconds, "kernels": [],
              "main_path": [], "golden": [], "sharded": [], "factor": [],
              "weak_scaling_measured": []}

    specs = {n: load_stc(os.path.join(bench, n + ".stc")) for n in names}
    shard_names = [n for n in SHARD_STENCILS if n in specs]
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
            "tile": list(kernels.tile_shape(len(shape), plan.frame,
                                            plan.levels, factor)),
        }
        ok = True
        for r in ((rows,) if rows is None else (rows, *also_rows)):
            args = () if r is None else (r,)
            got, want = d0.clone(), d0.clone()
            kernel(src, got, plan, *args)
            kernel.plain(src, want, plan, *args)
            torch.cuda.synchronize()
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
        print(f"kernel {stencil}: " + json.dumps(row))
        if not ok:
            raise RuntimeError(f"{row['name']} on {stencil}: kernel vs plain "
                               f"out of tolerance: {row}")
        del src, d0, got, want, x5
        torch.cuda.empty_cache()
        return row

    def level_table(plan):
        return plan.offsets.tolist(), plan.coeffs.tolist(), plan.reach

    def kernel_row(name, dtype):
        """Kernel vs plain version on ``name``'s winner plan at the .stc
        size in ``dtype``; the yardstick is one convolution per level."""
        spec = specs[name]
        cfg = best_config(name).replace(dtype=dtype)
        an = analyze(spec, cfg.step, cfg.distance, cfg.merge_forward)
        plan = level_plan(an, cfg)
        return compare(name, kernels.kernel_for(spec.ndim), plan, an, cfg,
                       level_table(plan), plan.levels)

    def shard_kernel_row(name, dtype):
        """The shard-local kernel on ``name``'s winner plan on a quarter
        slab of the .stc grid with its ghost rows, for an interior shard's
        store range (timed), the first shard's and the last's."""
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
                       also_rows=((2 * H, H + local), (H, local)))

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

    def main_path(name, dtype, rows):
        """``StencilProgram`` on ``name``'s winner in ``dtype``: time(),
        device_check(pairs=1), launches counted from 0 around them."""
        spec, cfg = specs[name], best_config(name).replace(dtype=dtype)
        kernel = kernels.kernel_for(spec.ndim)
        prog = StencilProgram(spec, cfg)
        kernels.reset_launches()
        res = prog.time()
        diff = prog.device_check(pairs=1)
        launches = kernel.launches
        rows[name]["launches"] = launches
        ms_pair = res.seconds_per_pair * 1e3
        line = {
            "stencil": name, "cfg": cfg.label(), "dims": list(spec.dims),
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
            raise RuntimeError(f"{name} {dtype}: main path launched no "
                               "kernel")
        if not diff <= DEVICE_CHECK_TOL[dtype]:
            raise RuntimeError(f"{name} {dtype}: device_check {diff} > "
                               f"{DEVICE_CHECK_TOL[dtype]}")
        del prog
        torch.cuda.empty_cache()

    def golden(name, dtype):
        """``check()`` against the fp64 golden model at the reduced size."""
        full = specs[name]
        cfg = best_config(name).replace(dtype=dtype)
        spec = StencilSpec(full.name, REDUCED[full.ndim], full.iterations,
                           full.taps)
        prog = StencilProgram(spec, cfg)
        max_err, rms = prog.check()
        a = prog.final_a(prog.run_pairs(prog.init_state(), prog.num_pairs()))
        h = prog.an.halo
        inner = a[tuple(slice(h, s - h) for s in a.shape)]
        scale = max(1.0, float(np.abs(inner).max()) / 100.0)
        line = {"stencil": name, "dims": list(spec.dims), "dtype": dtype,
                "max_err": max_err, "rms_err": rms, "tol_scale": scale}
        print("golden " + json.dumps(line))
        report["golden"].append(line)
        max_tol, rms_tol = GOLDEN_TOL[dtype]
        if not (max_err < max_tol * scale and rms < rms_tol * scale):
            raise RuntimeError(f"{name} {dtype}: fp64 golden check failed "
                               f"{line}")

    if args.mesh_devices:
        return multi_device_only()

    # -- 2. each kernel against its plain version ---------------------------
    kernel_rows = {n: kernel_row(n, "float32") for n in names}

    # -- 3. main path at the .stc size ---------------------------------------
    for name in names:
        main_path(name, "float32", kernel_rows)

    # -- 4. fp64 golden at reduced size --------------------------------------
    for name in names:
        golden(name, "float32")

    # -- 5. the entry point ---------------------------------------------------
    pair, (a, b) = entry_mod.entry()
    base = load_stc(os.path.join(bench, "2d5pt_star.stc"))
    spec = StencilSpec(base.name, tuple(a.shape), base.iterations, base.taps)
    cfg = KernelConfig(variant="stream", step=1, tm=128)
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
    bf16_rows = {n: kernel_row(n, "bfloat16") for n in names}

    # -- 7. the bf16 main path at the .stc size -------------------------------
    for name in names:
        main_path(name, "bfloat16", bf16_rows)

    # -- 8. bf16 fp64 golden at reduced size ---------------------------------
    for name in names:
        golden(name, "bfloat16")

    # -- 9. the autotuner on the card ----------------------------------------
    report["tuner"] = tune_phase(
        torch, Tuner, tuned_mod, session_mod, bench, specs)

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

    # -- 14. result lines ----------------------------------------------------
    if sha256(tuned_json) != tuned_sha:
        raise RuntimeError("benchmarks/tuned.json changed during the run")
    keys = ("name", "stencil", "dtype", "route", "source", "replaces",
            "launches", "max_abs_err", "ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms")
    all_rows = ([kernel_rows[n] for n in names] + [bf16_rows[n] for n in names]
                + [shard_rows[dt][n] for dt in shard_rows for n in shard_names]
                + factor_rows)
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


def tune_phase(torch, Tuner, tuned_mod, session_mod, bench, specs) -> dict:
    """Short sweeps on the card: for each of ``TUNE_STENCILS``, every
    candidate at its prior's step (fp32 and bf16 streams, the xla gold),
    then the prior once more through the isolated worker, then one
    profiler trace.  Writes only under a temporary directory; raises
    unless every kind was measured with no error and no failed check."""
    from drstencil_tpu_torch.ir.spec import load_stc
    from drstencil_tpu_torch.tune.space import representative

    out = {"sweeps": {}, "isolated": None, "trace": None}
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    saved = tuned_mod.TUNED_GPU_PATH
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as tmp:
        tuned_mod.TUNED_GPU_PATH = os.path.join(tmp, "tuned_gpu.json")
        try:
            entries = []
            for name in TUNE_STENCILS:
                spec = specs.get(name) or load_stc(
                    os.path.join(bench, name + ".stc"))
                prior = representative(tuned_mod.best_config(name),
                                       spec.ndim)
                tuner = Tuner(spec, tmp, pairs=TUNE_PAIRS,
                              config_timeout_s=TUNE_TIMEOUT_S)
                res = tuner.sweep(label_filter=f"*_fu{prior.step}*",
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
            name = TUNE_STENCILS[0]
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
            out["trace"] = trace_summary(session_mod.session_trace(
                bench, tmp, name, log=lambda m: print("tune " + m)))
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


def trace_summary(trace_dir):
    """Kernel events of the session trace's Chrome trace and the device's
    busy share over their span (soft: None where no trace was written)."""
    path = os.path.join(trace_dir, "trace.json") if trace_dir else None
    if not path or not os.path.exists(path):
        return None
    with open(path) as f:
        events = json.load(f).get("traceEvents", [])
    ks = [e for e in events if e.get("cat") == "kernel" and "dur" in e]
    if not ks:
        return {"kernel_events": 0}
    span = max(e["ts"] + e["dur"] for e in ks) - min(e["ts"] for e in ks)
    busy = sum(e["dur"] for e in ks)
    names = sorted({e.get("name", "")[:60] for e in ks})
    return {"kernel_events": len(ks), "kernel_us": busy, "span_us": span,
            "busy_share": busy / span if span else None, "names": names[:8]}


if __name__ == "__main__":
    sys.exit(main())
