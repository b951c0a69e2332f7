"""Time the single-device kernels on tuned winners' plans at the ``.stc``
size — the quick way to hold two trees against each other on one card.

    python -m drstencil_tpu_torch.utils.kernel_times [tag] [stencil ...]

Run it from the root of each tree within one call on the card, in turns
(parent, change, change, parent): times compare only within one call.  It
prints one JSON line: the tag, the card, and per stencil the median over 5
repeats of the mean ms of 20 launches (CUDA events, after 3 warmup
launches).
"""

from __future__ import annotations

import json
import os
import sys

import torch

from drstencil_tpu_torch.ir.passes import analyze
from drstencil_tpu_torch.ir.spec import load_stc
from drstencil_tpu_torch.ops import kernels
from drstencil_tpu_torch.ops.stream import level_plan, resolve_device
from drstencil_tpu_torch.tune.tuned import BENCH_DIR, best_config

DEFAULT_STENCILS = ("2d5pt_star", "2d9pt_star", "3d7pt_star", "3d13pt_star")


def kernel_ms(name: str, device) -> float:
    """Median ms per launch of ``name``'s winner plan at the ``.stc`` size."""
    spec = load_stc(os.path.join(BENCH_DIR, name + ".stc"))
    cfg = best_config(name)
    plan = level_plan(analyze(spec, cfg.step, cfg.distance,
                              cfg.merge_forward), cfg)
    kernel = kernels.kernel_for(spec.ndim)
    src = torch.rand(spec.dims, device=device) * 100.0
    dst = torch.zeros_like(src)
    for _ in range(3):
        kernel(src, dst, plan)
    torch.cuda.synchronize(device)
    reps = []
    for _ in range(5):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(20):
            kernel(src, dst, plan)
        end.record()
        end.synchronize()
        reps.append(start.elapsed_time(end) / 20)
    return sorted(reps)[len(reps) // 2]


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    tag = argv[0] if argv else "tree"
    device = resolve_device(None)   # the card: raises where there is none
    with torch.cuda.device(device):
        times = {n: kernel_ms(n, device)
                 for n in (argv[1:] or DEFAULT_STENCILS)}
    print(json.dumps({"tag": tag, "card": torch.cuda.get_device_name(device),
                      "ms": times}))


if __name__ == "__main__":
    main()
