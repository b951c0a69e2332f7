"""Time the single-device kernels on tuned winners' plans at the ``.stc``
size — the quick way to hold two trees against each other on one card.

    python -m drstencil_tpu_torch.utils.kernel_times [tag] [row ...]
        [--dtype bfloat16] [--check]

A row is a tuned winner's name (``all`` names every one), or ``factor``:
``stencil2d_factor_levels`` on 2d25pt_box, 2d9pt_star and 2d9pt_cross at
steps 1 and 2 (``<stencil> factor s<step>``), or ``tile2d``: ``tile2d_fused``
on the plain-tile experiment's sweep (``<stencil> tile2d fu<step>
tm<tm>``, fp32 only), or ``probe``: ``overlap_probe`` at the overlap
experiment's sizes, variants A/B/C at depths 1 and 2 (``probe <variant>
d<depth>``), each with its compute-only ms (the copies skipped) and a digest
of the written rows only (variant C's carry depends on the CTA count; the
tests and ``chip_smoke.py`` hold it against plain).  Run it from the root of
each tree
within one call on the card, in turns (parent, change, change, parent):
times compare only within one call.  It builds the plans' kernels first
(one ``nvcc`` each, started together; seconds, registers and spills are
reported, never timed), then prints one JSON line: the tag, the card, and
per stencil the kernel's ms — the median over 5 repeats of the mean of 20
launches (CUDA events, after 3 warmup launches) — and the SHA-256 of its
result on a state drawn from seed 0: two trees whose digests agree on one
card computed every cell alike.  ``--check`` adds the relative error
against the plain version.  ``--default-tile`` runs each winner with the
generator's tile (``tm=None, ch=None``) in place of the one it was tuned
with, for its default geometry's time in the same call; the build report
then gives each plan's tile and CTAs per SM beside the winner's.

The file needs of its tree only ``kernels.kernel_for``, ``level_plan``,
the tuned table, and for the factor and tile2d rows
``kernels.stencil2d_factor_levels``, ``kernels.tile2d_taps``,
``kernels.tile2d_fused`` and the experiment's sweep, and for the probe
rows ``kernels.overlap_probe`` and ``tuning.exp_overlap``'s sizes, so a copy
of it also
runs in a tree whose kernels are not built per plan (it then has no build
to report for them).
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
from drstencil_tpu_torch.ops.config import KernelConfig
from drstencil_tpu_torch.ops.stream import (level_plan, resolve_device,
                                            state_dtype)
from drstencil_tpu_torch.tune.tuned import (BENCH_DIR, best_config,
                                            tuned_entries)
from drstencil_tpu_torch.tuning import exp_overlap
from drstencil_tpu_torch.tuning.exp_tile2d import SWEEP

DEFAULT_STENCILS = ("2d5pt_star", "2d9pt_star", "3d7pt_star", "3d13pt_star")
FACTOR_STENCILS = ("2d25pt_box", "2d9pt_star", "2d9pt_cross")
FACTOR_STEPS = (1, 2)
PROBE_ROWS = tuple(f"probe {v} d{d}" for v in ("A", "B", "C") for d in (1, 2))


def expand(names) -> list:
    """Row names: ``all``, ``factor``, ``tile2d`` and ``probe``
    expanded."""
    out = []
    for n in names:
        if n == "all":
            out += sorted(tuned_entries())
        elif n == "factor":
            out += [f"{s} factor s{k}" for s in FACTOR_STENCILS
                    for k in FACTOR_STEPS]
        elif n == "tile2d":
            out += [f"{s} tile2d fu{k} tm{tm}" for s, sweep in SWEEP.items()
                    for k, tm in sweep]
        elif n == "probe":
            out += list(PROBE_ROWS)
        else:
            out.append(n)
    return out


def row_plan(name: str, dtype: str = "float32", default_tile: bool = False):
    """(kernel, its taps, src shape, extra call arguments, plan request)
    of a row; the request is what ``kernels.build_plans`` builds, None
    where this tree does not build the row's kernel per plan."""
    stencil, *kind = name.split()
    spec = load_stc(os.path.join(BENCH_DIR, stencil + ".stc"))
    if not kind:
        spec, plan = winner_plan(stencil, dtype, default_tile)
        return (kernels.kernel_for(spec.ndim), plan, spec.dims, (),
                (plan, spec.dims, dtype, False))
    if kind[0] == "factor":
        step = int(kind[1][1:])
        plan = level_plan(analyze(spec, step), KernelConfig(
            step=step, factor=True, dtype=dtype))
        kernel = kernels.stencil2d_factor_levels
        return (kernel, plan, spec.dims, (),
                None if getattr(kernel, "library", None) else
                (plan, spec.dims, dtype, False))
    if dtype != "float32":
        raise ValueError(f"{name}: tile2d_fused is fp32 only")
    step, tm = int(kind[1][2:]), int(kind[2][2:])
    an = analyze(spec, step=step, require_partition=False)
    taps = kernels.tile2d_taps(an.fused, an.halo)
    shape = (spec.dims[0] + 2 * tm, spec.dims[1])
    return (kernels.tile2d_fused, taps, shape, (tm,),
            kernels.tile2d_plan(taps, shape, tm)
            if hasattr(kernels, "tile2d_plan") else None)


def winner_plan(name: str, dtype: str = "float32",
                default_tile: bool = False):
    """(spec, plan) of ``name``'s tuned winner in ``dtype`` state (with the
    generator's tile where ``default_tile``)."""
    spec = load_stc(os.path.join(BENCH_DIR, name + ".stc"))
    cfg = best_config(name).replace(dtype=dtype)
    if default_tile:
        cfg = cfg.replace(tm=None, ch=None)
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
               check: bool = False, default_tile: bool = False) -> dict:
    """The kernel of row ``name`` at the ``.stc`` size (a tile2d row's
    source has zero pad rows)."""
    if name in PROBE_ROWS:
        return probe_row(name, device, check)
    kernel, plan, shape, extra, _ = row_plan(name, dtype, default_tile)
    gen = torch.Generator(device=device).manual_seed(0)
    src = (torch.rand(shape, device=device, generator=gen)
           * 100.0).to(state_dtype(dtype))
    if extra:
        tm = extra[0]
        src[:tm] = 0
        src[-tm:] = 0
    dst = torch.zeros_like(src)
    row = {"ms": launch_ms(lambda: kernel(src, dst, plan, *extra), device)}
    # bit patterns: numpy has no bfloat16
    bits = dst.view(torch.int16 if dtype == "bfloat16" else torch.int32)
    row["sha256"] = hashlib.sha256(bits.cpu().numpy().tobytes()).hexdigest()
    if check:
        want = torch.zeros_like(src)
        kernel.plain(src, want, plan, *extra)
        row["rel_err"] = float((dst.float() - want.float()).abs().max()
                               / want.float().abs().max())
    return row


def probe_row(name: str, device, check: bool = False) -> dict:
    """``overlap_probe`` at the experiment's sizes on a seed-0 input: ms,
    compute-only ms, the SHA-256 of the written rows."""
    _, variant, depth = name.split()
    depth = int(depth[1:])
    R, N, TM, HK = (exp_overlap.R, exp_overlap.N, exp_overlap.TM,
                    exp_overlap.HK)
    shape = (R, N) if variant == "A" else (R + 2 * HK, N)
    gen = torch.Generator(device=device).manual_seed(0)
    x = torch.rand(shape, device=device, generator=gen) * 100.0
    out = torch.zeros((R, N), device=device)
    scratch = torch.zeros((R, N), device=device)
    kernel = kernels.overlap_probe
    row = {"ms": launch_ms(lambda: kernel(x, out, variant, depth, TM, HK),
                           device),
           "compute_only_ms": launch_ms(lambda: kernel(
               x, scratch, variant, depth, TM, HK, False), device)}
    written = torch.zeros(R, dtype=torch.bool, device=device)
    for i in range(R // TM):
        written[i * TM:i * TM + TM - 4 * HK] = True
    bits = out[written].view(torch.int32)
    row["sha256"] = hashlib.sha256(bits.cpu().numpy().tobytes()).hexdigest()
    if hasattr(kernel, "info"):    # registers, shared memory, CTAs per SM
        row["info"] = kernel.info(device, variant, depth, TM, HK)
    if check:
        want = torch.zeros_like(out)
        kernel.plain(x, want, variant, TM, HK, 1)
        row["rel_err"] = float((out[written] - want[written]).abs().max()
                               / want[written].abs().max())
    return row


def build_report(names, dtype: str, default_tile: bool = False) -> dict:
    """Build the rows' per-plan kernels together; per row the nvcc seconds
    (None when found on disk), tile, shared memory, registers and spills,
    and the CTAs per SM where this tree models them.  Empty for the rows
    whose kernels this tree does not build per plan."""
    names = [n for n in names if n not in PROBE_ROWS]
    if not hasattr(kernels, "build_plans"):
        return {}
    requests = {n: row_plan(n, dtype, default_tile)[4] for n in names}
    names = [n for n in names if requests[n] is not None]
    plans = kernels.build_plans([requests[n] for n in names])
    return {n: {"seconds": p.build_seconds, "tile": list(p.geometry.tile),
                "smem_bytes": p.geometry.smem_bytes, **p.ptxas(),
                **({"ctas_per_sm": p.ctas_per_sm()}
                   if hasattr(p, "ctas_per_sm") else {})}
            for n, p in zip(names, plans)}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("tag", nargs="?", default="tree")
    ap.add_argument("rows", nargs="*", default=list(DEFAULT_STENCILS))
    ap.add_argument("--dtype", default="float32",
                    choices=["float32", "bfloat16"])
    ap.add_argument("--check", action="store_true")
    ap.add_argument("--default-tile", action="store_true",
                    help="the winners at the generator's tile")
    args = ap.parse_args(argv)
    names = expand(args.rows)
    device = resolve_device(None)   # the card: raises where there is none
    t0 = time.perf_counter()
    kernels.build()
    build = build_report(names, args.dtype, args.default_tile)
    build_seconds = time.perf_counter() - t0
    with torch.cuda.device(device):
        rows = {n: kernel_row(n, device, args.dtype, args.check,
                              args.default_tile) for n in names}
    print(json.dumps({
        "tag": args.tag, "card": torch.cuda.get_device_name(device),
        "dtype": args.dtype, "default_tile": args.default_tile,
        **{key: {n: r[key] for n, r in rows.items() if key in r}
           for key in ("ms", "compute_only_ms", "sha256", "info")
           + (("rel_err",) if args.check else ())},
        "build_seconds": build_seconds, "build": build}))


if __name__ == "__main__":
    main()
