#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (drstencil_tpu_torch) on one GPU.

Run from the repository root on a machine with one NVIDIA Hopper card:

    python3 chip_smoke.py                      # every tuned stencil
    python3 chip_smoke.py --stencils 2d5pt_star,3d7pt_star

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
5. the graft entry's config (2d5pt_star, step 1, 1024²) through
   ``build_stream_kernel``;
6. one ``{"kernels": [...]}`` line, then the ok line.

Details also go to ``build/chip_smoke.json``.  Without CUDA, or outside
a checkout of the repository, it exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.abspath(__file__))
KERNEL_TOL = 1e-5       # kernel vs its plain version, relative to max|plain|
DEVICE_CHECK_TOL = 1e-3  # the tuner's CHECK_TOL (drstencil_tpu/tune/tuner.py)
# fp64-golden tolerances of tests/test_kernels.py, stated for values ~100
# and scaled with max|gold| for operators that grow the state
MAX_TOL, RMS_TOL = 5e-3, 1e-3
GRAFT_DIMS = (1024, 1024)
REDUCED = {2: (1024, 1024), 3: (128, 128, 128)}


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


def main(argv=None) -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import numpy as np
    import torch.nn.functional as F

    from drstencil_tpu_torch.ir.passes import analyze
    from drstencil_tpu_torch.ir.spec import StencilSpec, load_stc
    from drstencil_tpu_torch.ops import kernels, xla_ref
    from drstencil_tpu_torch.ops.config import KernelConfig
    from drstencil_tpu_torch.ops.runner import StencilProgram
    from drstencil_tpu_torch.ops.stream import build_stream_kernel, level_plan
    from drstencil_tpu_torch.tune.tuned import (
        best_config, card_peaks, naive_sol_gstencil, tuned_entries)

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--stencils", default="",
                    help="comma-separated subset of benchmarks/tuned.json")
    args = ap.parse_args(argv)
    names = sorted(tuned_entries())
    if args.stencils:
        names = [n for n in args.stencils.split(",") if n]
    bench = os.path.join(ROOT, "benchmarks")
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
              "main_path": [], "golden": []}

    specs = {n: load_stc(os.path.join(bench, n + ".stc")) for n in names}
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)

    # -- 2. each kernel against its plain version ---------------------------
    kernel_rows = {}
    for name in names:
        spec, cfg = specs[name], best_config(name)
        an = analyze(spec, cfg.step, cfg.distance, cfg.merge_forward)
        plan = level_plan(an, cfg)
        kernel = kernels.kernel_for(spec.ndim)
        src = torch.rand(spec.dims, generator=gen, device=dev) * 100.0
        got = torch.zeros_like(src)
        want = torch.zeros_like(src)
        kernel(src, got, plan)
        kernel.plain(src, want, plan)
        torch.cuda.synchronize()
        max_abs = float((got - want).abs().max())
        rel = max_abs / float(want.abs().max())
        ms = cuda_ms(torch, lambda: kernel(src, got, plan), 20)
        plain_ms = cuda_ms(torch, lambda: kernel.plain(src, want, plan), 3)
        # yardstick: one cuDNN convolution per level (same taps, 'same'
        # padding), never called by the port
        r = plan.reach
        weight = torch.zeros((1, 1) + (2 * r + 1,) * spec.ndim, device=dev)
        for off, c in zip(plan.offsets.tolist(), plan.coeffs.tolist()):
            weight[(0, 0) + tuple(o + r for o in off)] = c
        conv = F.conv2d if spec.ndim == 2 else F.conv3d
        x5 = src[None, None]

        def library(x5=x5, weight=weight, conv=conv, plan=plan):
            y = x5
            for _ in range(plan.levels):
                y = conv(y, weight, padding=plan.reach)
            return y

        library_ms = cuda_ms(torch, library, 3)
        cells = float(np.prod(spec.dims))
        bytes_ms = 2 * 4 * cells / (hbm_gbps * 1e9) * 1e3
        ops_ms = (2 * len(plan.coeffs) * plan.levels * cells
                  / (fp32_tflops * 1e12) * 1e3)
        row = {
            "name": kernel.name, "stencil": name, "route": kernel.route,
            "source": kernel.source, "replaces": kernel.replaces,
            "launches": 0, "max_abs_err": max_abs, "rel_err": rel,
            "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": library_ms,
            "taps": len(plan.coeffs), "levels": plan.levels,
            "frame": plan.frame,
            "tile": list(kernels.tile_shape(spec.ndim, plan.frame,
                                            plan.levels)),
        }
        print(f"kernel {name}: " + json.dumps(row))
        if not rel <= KERNEL_TOL:
            raise RuntimeError(f"{kernel.name} on {name}: kernel vs plain "
                               f"relative error {rel} > {KERNEL_TOL}")
        kernel_rows[name] = row
        del src, got, want, x5
        torch.cuda.empty_cache()

    # -- 3. main path at the .stc size ---------------------------------------
    for name in names:
        spec, cfg = specs[name], best_config(name)
        kernel = kernels.kernel_for(spec.ndim)
        prog = StencilProgram(spec, cfg)
        kernels.reset_launches()
        res = prog.time()
        diff = prog.device_check(pairs=1)
        launches = kernel.launches
        kernel_rows[name]["launches"] = launches
        ms_pair = res.seconds_per_pair * 1e3
        line = {
            "stencil": name, "cfg": cfg.label(), "dims": list(spec.dims),
            "ms_per_pair": ms_pair,
            "ms_per_step": ms_pair / (2 * prog.an.step),
            "gstencil_per_s": res.gstencil_per_s,
            "roofline_frac": res.gstencil_per_s / naive_sol_gstencil(
                prog.dtype.itemsize, kind),
            "max_dev_diff": diff, "launches": launches,
        }
        print(json.dumps(line))
        report["main_path"].append(line)
        if launches <= 0:
            raise RuntimeError(f"{name}: main path launched no kernel")
        if not diff <= DEVICE_CHECK_TOL:
            raise RuntimeError(f"{name}: device_check {diff} > "
                               f"{DEVICE_CHECK_TOL}")
        del prog
        torch.cuda.empty_cache()

    # -- 4. fp64 golden at reduced size --------------------------------------
    for name in names:
        full, cfg = specs[name], best_config(name)
        spec = StencilSpec(full.name, REDUCED[full.ndim], full.iterations,
                           full.taps)
        prog = StencilProgram(spec, cfg)
        max_err, rms = prog.check()
        a = prog.final_a(prog.run_pairs(prog.init_state(), prog.num_pairs()))
        h = prog.an.halo
        inner = a[tuple(slice(h, s - h) for s in a.shape)]
        scale = max(1.0, float(np.abs(inner).max()) / 100.0)
        line = {"stencil": name, "dims": list(spec.dims), "max_err": max_err,
                "rms_err": rms, "tol_scale": scale}
        print("golden " + json.dumps(line))
        report["golden"].append(line)
        if not (max_err < MAX_TOL * scale and rms < RMS_TOL * scale):
            raise RuntimeError(f"{name}: fp64 golden check failed {line}")

    # -- 5. the graft entry's config ----------------------------------------
    base = load_stc(os.path.join(bench, "2d5pt_star.stc"))
    spec = StencilSpec(base.name, GRAFT_DIMS, base.iterations, base.taps)
    cfg = KernelConfig(variant="stream", step=1, tm=128)
    an = analyze(spec, cfg.step)
    f = build_stream_kernel(an, cfg)
    gold = xla_ref.apply_interior(an)
    prog = StencilProgram(spec, cfg)
    state = prog.init_state(0)
    a = state["a"]
    got, want = state["b"].clone(), state["b"].clone()
    kernels.reset_launches()
    f(a, got)
    gold(a, want)
    torch.cuda.synchronize()
    graft_rel = float((got - want).abs().max() / want.abs().max())
    max_err, rms = prog.check()
    graft = {"stencil": "2d5pt_star", "cfg": cfg.label(),
             "dims": list(GRAFT_DIMS), "rel_vs_gold": graft_rel,
             "golden_max_err": max_err, "golden_rms": rms,
             "launches": kernels.stencil2d_levels.launches}
    print("graft " + json.dumps(graft))
    report["graft"] = graft
    if not (graft["launches"] >= 1 and graft_rel <= KERNEL_TOL
            and max_err < MAX_TOL and rms < RMS_TOL):
        raise RuntimeError(f"graft entry config failed: {graft}")

    # -- 6. result lines -----------------------------------------------------
    keys = ("name", "stencil", "route", "source", "replaces", "launches",
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    rows = [{k: kernel_rows[n][k] for k in keys} for n in names]
    report["kernels"] = [kernel_rows[n] for n in names]
    os.makedirs(kernels.BUILD_DIR, exist_ok=True)
    with open(os.path.join(kernels.BUILD_DIR, "chip_smoke.json"), "w") as fh:
        json.dump(report, fh, indent=1)
    print(smi)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
