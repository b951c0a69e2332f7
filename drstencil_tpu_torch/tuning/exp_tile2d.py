"""The reference's 2D PLAIN-TILE kernel strategy on Hopper, measured
against the tuned winners — the port of ``tuning/exp_tile2d.py``.

The reference selects between two 2D strategies: a streaming kernel (what
the library builds) and a plain tile kernel where each block loads its own
haloed window and applies the FUSED multi-step operator whole — one level,
no inter-tile reuse, halo cells loaded again by the neighbours.  The JAX
package measured its Pallas incarnation on a TPU; a TPU's answer does not
carry over, so this module measures the strategy on the card with the CUDA
kernel ``tile2d_fused`` (``ops/codegen.tile2d_source``'s text, one build
per table and layout).

Ping-pong state lives in a ``(R + 2 * tm, C)`` padded layout, as in the JAX
experiment: data rows ``[tm, tm + R)``, pad rows never written, so the
output of one application is directly the input of the next.  On this card
``tm`` is only the pad height of the layout: a CTA streams a strip of
columns down a segment of rows whatever ``tm``.  Unwritten pads and
wrapping columns mean the boundary band diverges from the interior-update golden semantics by
``halo`` cells per application: the differential check compares an interior
inset past the creep, like ``StencilProgram.device_check``'s deep-gold path.

    python -m drstencil_tpu_torch.tuning.exp_tile2d [stencil ...]

Default sweep: 2d5pt_star (fu2/fu4 x tm 128/256), 2d9pt_star (fu2),
2d25pt_box (fu2) — one process, the port's winner re-measured alongside.
"""

from __future__ import annotations

import os
import sys

import torch

from drstencil_tpu_torch.ir.passes import analyze
from drstencil_tpu_torch.ir.spec import load_stc
from drstencil_tpu_torch.ops import kernels
from drstencil_tpu_torch.ops.config import KernelConfig
from drstencil_tpu_torch.ops.runner import (StencilProgram, relative_diff,
                                            time_pairs)
from drstencil_tpu_torch.ops.stream import resolve_device
from drstencil_tpu_torch.tune.tuned import BENCH_DIR, best_config

# (step, tm) per stencil, as the JAX experiment sweeps them
SWEEP = {
    "2d5pt_star": [(2, 128), (2, 256), (4, 128), (4, 256)],
    "2d9pt_star": [(2, 128), (2, 256)],
    "2d25pt_box": [(2, 128)],
}
# the differential check's gate, relative to max|gold| (the JAX experiment's)
CHECK_TOL = 1e-4


def build_tile_program(spec, step: int, tm: int, device=None):
    """The plain-tile strategy for one 2D spec: returns ``(pair, pad,
    unpad, an)``.  ``pair(a, b)`` applies the step-fused operator to ``a``'s
    data rows into ``b``'s, then back, in place (pad rows are never
    written); ``pad(x)`` puts a real-shaped tensor into a new padded buffer
    on ``device`` (``None`` = CUDA, ``"cpu"`` runs the plain version);
    ``unpad`` views the data rows."""
    device = resolve_device(device)
    an = analyze(spec, step=step, merge_forward=5, require_partition=False)
    R, C = spec.dims
    if R % tm or an.halo > tm:
        raise ValueError(f"tm={tm} must divide the {R} rows and be at least "
                         f"the halo {an.halo}")
    taps = kernels.tile2d_taps(an.fused, an.halo)

    def pair(a, b):
        kernels.tile2d_fused(a, b, taps, tm)
        kernels.tile2d_fused(b, a, taps, tm)
        return a, b

    def pad(x):
        buf = torch.zeros((R + 2 * tm, C), dtype=torch.float32, device=device)
        buf[tm:tm + R] = x
        return buf

    def unpad(x):
        return x[tm:tm + R]

    return pair, pad, unpad, an


def measure_tile(spec, step: int, tm: int, device=None) -> float:
    """Differential-check then time the plain-tile program on the card.
    Returns ms per plain timestep (the tuner's objective)."""
    pair, pad, unpad, an = build_tile_program(spec, step, tm, device)
    gold = StencilProgram(spec, KernelConfig(variant="xla", step=step),
                          device)
    s_gd = gold.init_state(seed=0)
    a, b = pad(s_gd["a"]), pad(s_gd["b"])
    # one checked pair: divergence creeps h per application from the
    # unwritten pads + interior-update band, so compare inset 3h
    pair(a, b)
    s_gd = gold.run_pairs(s_gd, 1)
    err = relative_diff(unpad(a), s_gd["a"], 3 * an.halo)
    if not err < CHECK_TOL:
        raise RuntimeError(f"tile kernel diverges from gold: {err}")
    del s_gd, gold
    # runner.time's protocol: 3 warmup pairs, median of 3 x 6 pairs
    ms_step = time_pairs(pair, a, b, 3, 6, 3) * 1e3 / (2 * step)
    print(f"{spec.name} TILE fu{step}_tm{tm}: {ms_step:.4f} ms/step "
          f"(dev_diff {err:.2e})", flush=True)
    return ms_step


def measure_winner(spec, device=None) -> float:
    """ms per timestep of the port's winner for ``spec`` (``best_config``)."""
    cfg = best_config(spec.name)
    prog = StencilProgram(spec, cfg, device)
    ms = prog.time(pairs=6).seconds_per_pair * 1e3 / (2 * prog.an.step)
    print(f"{spec.name} STREAM winner [{cfg.label()}]: {ms:.4f} ms/step",
          flush=True)
    return ms


def print_table(rows) -> None:
    """The experiment's table from rows ``(stencil, step, tm, tile ms/step,
    winner ms/step)``."""
    print("\nstencil       fu  tm   tile ms   winner ms  tile/winner")
    for name, step, tm, ms, win in rows:
        print(f"{name:<12} {step:>3} {tm:>4} {ms:>8.4f} {win:>10.4f} "
              f"{ms / win:>10.3f}")


def run_sweep(names=None, device=None) -> list:
    """Measure ``SWEEP`` for ``names`` (default: all of it) beside each
    stencil's winner and print the table; returns its rows."""
    rows = []
    for name in names or list(SWEEP):
        spec = load_stc(os.path.join(BENCH_DIR, name + ".stc"))
        win = measure_winner(spec, device)
        for step, tm in SWEEP.get(name, [(2, 128)]):
            rows.append((name, step, tm, measure_tile(spec, step, tm, device),
                         win))
    print_table(rows)
    return rows


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    device = resolve_device(None)   # the card: raises where there is none
    print(f"card: {torch.cuda.get_device_name(device)}")
    run_sweep([a for a in argv if not a.startswith("--")], device)


if __name__ == "__main__":
    main()
