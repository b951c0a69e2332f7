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
10. one ``{"kernels": [...]}`` line (fp32 and bf16 rows), the card line,
    then the ok line.

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

    from drstencil_tpu_torch.ir.passes import analyze
    from drstencil_tpu_torch.ir.spec import StencilSpec, load_stc
    from drstencil_tpu_torch.ops import kernels, xla_ref
    from drstencil_tpu_torch.ops.config import KernelConfig
    from drstencil_tpu_torch.ops.runner import StencilProgram
    from drstencil_tpu_torch.ops.stream import (build_stream_kernel,
                                                level_plan, state_dtype)
    from drstencil_tpu_torch.tune import session as session_mod
    from drstencil_tpu_torch.tune import tuned as tuned_mod
    from drstencil_tpu_torch.tune.tuned import (
        best_config, card_peaks, naive_sol_gstencil, tuned_entries)
    from drstencil_tpu_torch.tune.tuner import Tuner
    from drstencil_tpu_torch.utils.profiling import traffic_model

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--stencils", default="",
                    help="comma-separated subset of benchmarks/tuned.json")
    args = ap.parse_args(argv)
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
              "main_path": [], "golden": []}

    specs = {n: load_stc(os.path.join(bench, n + ".stc")) for n in names}
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)

    def kernel_row(name, dtype):
        """Kernel vs plain version on ``name``'s winner plan at the .stc
        size in ``dtype``, with the kernel's, the plain version's and a
        cuDNN convolution's times beside the kernel's bound."""
        spec = specs[name]
        cfg = best_config(name).replace(dtype=dtype)
        an = analyze(spec, cfg.step, cfg.distance, cfg.merge_forward)
        plan = level_plan(an, cfg)
        kernel = kernels.kernel_for(spec.ndim)
        tdt = state_dtype(dtype)
        src = (torch.rand(spec.dims, generator=gen, device=dev)
               * 100.0).to(tdt)
        got = torch.zeros_like(src)
        want = torch.zeros_like(src)
        kernel(src, got, plan)
        kernel.plain(src, want, plan)
        torch.cuda.synchronize()
        diff = (got.float() - want.float()).abs()
        max_abs = float(diff.max())
        rel = max_abs / float(want.float().abs().max())
        ms = cuda_ms(torch, lambda: kernel(src, got, plan), 20)
        plain_ms = cuda_ms(torch, lambda: kernel.plain(src, want, plan), 3)
        # yardstick: one cuDNN convolution per level (same taps, 'same'
        # padding, the state's dtype), never called by the port
        r = plan.reach
        weight = torch.zeros((1, 1) + (2 * r + 1,) * spec.ndim, device=dev)
        for off, c in zip(plan.offsets.tolist(), plan.coeffs.tolist()):
            weight[(0, 0) + tuple(o + r for o in off)] = c
        weight = weight.to(tdt)
        conv = F.conv2d if spec.ndim == 2 else F.conv3d
        x5 = src[None, None]

        def library():
            y = x5
            for _ in range(plan.levels):
                y = conv(y, weight, padding=plan.reach)
            return y

        library_ms = cuda_ms(torch, library, 3)
        bound_ms, bound_by = traffic_model(an, cfg).bound_ms(
            hbm_gbps, fp32_tflops)
        row = {
            "name": kernel.name + kernels.BUILDS[tdt], "stencil": name,
            "dtype": dtype, "route": kernel.route,
            "source": kernel.source, "replaces": kernel.replaces,
            "launches": 0, "max_abs_err": max_abs, "rel_err": rel,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": library_ms,
            "taps": len(plan.coeffs), "levels": plan.levels,
            "frame": plan.frame,
            "tile": list(kernels.tile_shape(spec.ndim, plan.frame,
                                            plan.levels)),
        }
        if dtype == "float32":
            ok = rel <= KERNEL_TOL
        else:
            ulp = bf16_ulp(torch, want)
            noise = BF16_NOISE * float(want.float().abs().max())
            ok = bool((diff <= ulp + noise).all())
            safe = torch.where(ulp > 0, ulp, torch.ones_like(ulp))
            row["max_ulps"] = float((diff / safe).max())
            row["cells_differing"] = int((diff > 0).sum())
        print(f"kernel {name}: " + json.dumps(row))
        if not ok:
            raise RuntimeError(f"{row['name']} on {name}: kernel vs plain "
                               f"out of tolerance: {row}")
        del src, got, want, x5, diff
        torch.cuda.empty_cache()
        return row

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

    # -- 2. each kernel against its plain version ---------------------------
    kernel_rows = {n: kernel_row(n, "float32") for n in names}

    # -- 3. main path at the .stc size ---------------------------------------
    for name in names:
        main_path(name, "float32", kernel_rows)

    # -- 4. fp64 golden at reduced size --------------------------------------
    for name in names:
        golden(name, "float32")

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

    # -- 10. result lines ----------------------------------------------------
    if sha256(tuned_json) != tuned_sha:
        raise RuntimeError("benchmarks/tuned.json changed during the run")
    keys = ("name", "stencil", "dtype", "route", "source", "replaces",
            "launches", "max_abs_err", "ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms")
    all_rows = [kernel_rows[n] for n in names] + [bf16_rows[n] for n in names]
    report["kernels"] = all_rows
    os.makedirs(kernels.BUILD_DIR, exist_ok=True)
    with open(os.path.join(kernels.BUILD_DIR, "chip_smoke.json"), "w") as fh:
        json.dump(report, fh, indent=1)
    print(smi)
    print(json.dumps({"kernels": [{k: r[k] for k in keys}
                                  for r in all_rows]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
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
