"""Time the single-device kernels on tuned winners' plans at the ``.stc``
size — the quick way to hold two trees against each other on one card.

    python -m drstencil_tpu_torch.utils.kernel_times [tag] [stencil ...]
        [--dtype bfloat16] [--check]

``all`` names every tuned winner.  Run it from the root of each tree
within one call on the card, in turns (parent, change, change, parent):
times compare only within one call.  It builds the plans' kernels first
(one ``nvcc`` each, started together; seconds, registers and spills are
reported, never timed), then prints one JSON line: the tag, the card, and
per stencil the kernel's ms — the median over 5 repeats of the mean of 20
launches (CUDA events, after 3 warmup launches) — and the SHA-256 of its
result on a state drawn from seed 0: two trees whose digests agree on one
card computed every cell alike.  ``--check`` adds the relative error
against the plain version.

The file needs of its tree only ``kernels.kernel_for``, ``level_plan`` and
the tuned table, so a copy of it also runs in a tree whose kernels are not
built per plan (it then has no build to report).
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import time

import torch

from drstencil_tpu_torch.ir.passes import analyze
from drstencil_tpu_torch.ir.spec import load_stc
from drstencil_tpu_torch.ops import kernels
from drstencil_tpu_torch.ops.stream import (level_plan, resolve_device,
                                            state_dtype)
from drstencil_tpu_torch.tune.tuned import (BENCH_DIR, best_config,
                                            tuned_entries)

DEFAULT_STENCILS = ("2d5pt_star", "2d9pt_star", "3d7pt_star", "3d13pt_star")


def winner_plan(name: str, dtype: str = "float32"):
    """(spec, plan) of ``name``'s tuned winner in ``dtype`` state."""
    spec = load_stc(os.path.join(BENCH_DIR, name + ".stc"))
    cfg = best_config(name).replace(dtype=dtype)
    return spec, level_plan(analyze(spec, cfg.step, cfg.distance,
                                    cfg.merge_forward), cfg)


def launch_ms(fn, device) -> float:
    """Median over 5 repeats of the mean ms of 20 calls of ``fn``."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize(device)
    reps = []
    for _ in range(5):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(20):
            fn()
        end.record()
        end.synchronize()
        reps.append(start.elapsed_time(end) / 20)
    return sorted(reps)[len(reps) // 2]


def kernel_row(name: str, device, dtype: str = "float32",
               check: bool = False) -> dict:
    """The kernel on ``name``'s winner plan at the ``.stc`` size."""
    spec, plan = winner_plan(name, dtype)
    kernel = kernels.kernel_for(spec.ndim)
    gen = torch.Generator(device=device).manual_seed(0)
    src = (torch.rand(spec.dims, device=device, generator=gen)
           * 100.0).to(state_dtype(dtype))
    dst = torch.zeros_like(src)
    row = {"ms": launch_ms(lambda: kernel(src, dst, plan), device)}
    # bit patterns: numpy has no bfloat16
    bits = dst.view(torch.int16 if dtype == "bfloat16" else torch.int32)
    row["sha256"] = hashlib.sha256(bits.cpu().numpy().tobytes()).hexdigest()
    if check:
        want = torch.zeros_like(src)
        kernel.plain(src, want, plan)
        row["rel_err"] = float((dst.float() - want.float()).abs().max()
                               / want.float().abs().max())
    return row


def build_report(names, dtype: str) -> dict:
    """Build the winners' per-plan kernels together; per stencil the nvcc
    seconds (None when found on disk), tile, shared memory, registers and
    spills.  Empty in a tree whose kernels are not built per plan."""
    if not hasattr(kernels, "build_plans"):
        return {}
    plans = kernels.build_plans(
        [(plan, spec.dims, dtype, False) for spec, plan in
         (winner_plan(n, dtype) for n in names)])
    return {n: {"seconds": p.build_seconds, "tile": list(p.geometry.tile),
                "smem_bytes": p.geometry.smem_bytes, **p.ptxas()}
            for n, p in zip(names, plans)}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("tag", nargs="?", default="tree")
    ap.add_argument("stencils", nargs="*", default=list(DEFAULT_STENCILS))
    ap.add_argument("--dtype", default="float32",
                    choices=["float32", "bfloat16"])
    ap.add_argument("--check", action="store_true")
    args = ap.parse_args(argv)
    names = (sorted(tuned_entries()) if args.stencils == ["all"]
             else args.stencils)
    device = resolve_device(None)   # the card: raises where there is none
    t0 = time.perf_counter()
    kernels.build()
    build = build_report(names, args.dtype)
    build_seconds = time.perf_counter() - t0
    with torch.cuda.device(device):
        rows = {n: kernel_row(n, device, args.dtype, args.check)
                for n in names}
    print(json.dumps({
        "tag": args.tag, "card": torch.cuda.get_device_name(device),
        "dtype": args.dtype,
        **{key: {n: r[key] for n, r in rows.items()}
           for key in ("ms", "sha256") + (("rel_err",) if args.check else ())},
        "build_seconds": build_seconds, "build": build}))


if __name__ == "__main__":
    main()
