"""Does an asynchronous copy of the next window overlap with two levels of
compute on Hopper, and which feature loses the overlap?  The port of
``tuning/exp_overlap.py``: a timing probe whose results mean nothing beyond
agreeing with its plain version.

  A: aligned (TM, N) input blocks, 2 compute levels through shared memory
  B: A with the input fetched as an overlapping (TM + 2*HK)-row window of an
     (R + 2*HK, N) input at row i*TM — the production input shape
  C: B plus a (HK, width) carry written per strip

each at depth 1 (the window copied by TMA and awaited before compute) and
depth 2 (the next tile's window copied by TMA into a second shared-memory
buffer while the current one computes; each buffer's copy completes on its
own ``mbarrier``).  The kernel is ``overlap_probe``
(``csrc/experiments.cu``): persistent CTAs over (strip, 64-column tile)
pairs, as many as the runtime's occupancy puts on the card.

Read beside each time: the bytes time of one sweep (input + output, R * N
fp32 each) at the card's HBM peak from ``tune/tuned.CARD_PEAKS``, and the
compute-only time (the same kernel with its loads skipped).  Serial would
be copy + compute, overlapped their maximum.

    python -m drstencil_tpu_torch.tuning.exp_overlap [variants]
"""

from __future__ import annotations

import sys

import torch

from drstencil_tpu_torch.ops import kernels
from drstencil_tpu_torch.ops.stream import resolve_device
from drstencil_tpu_torch.tune.tuned import hbm_peak_gbps

# the JAX experiment's sizes
R, N = 8192, 8192
TM, HK = 96, 8
DEPTHS = (1, 2)


def make(variant: str, depth: int = 2, device=None, R: int = R, N: int = N,
         TM: int = TM, HK: int = HK, load: bool = True):
    """``(call, shape)`` for one variant: ``call(x, out)`` runs the probe
    on the fp32 tensor ``x`` of ``shape`` into the ``(R, N)`` tensor ``out``
    and returns ``(out, carry)``; ``device`` (``None`` = CUDA) is where the
    caller allocates them.  ``load=False`` builds the compute-only timing."""
    resolve_device(device)
    if variant not in kernels.PROBE_VARIANTS:
        raise ValueError(f"variant {variant!r} is not one of "
                         f"{kernels.PROBE_VARIANTS}")
    shape = (R, N) if variant == "A" else (R + 2 * HK, N)

    def call(x, out):
        return kernels.overlap_probe(x, out, variant, depth, TM, HK, load)

    return call, shape


def sweep_ms(call, x, out, reps: int = 10) -> float:
    """Median over 3 repeats of the mean ms of ``reps`` sweeps (CUDA
    events), after 2 warmup sweeps."""
    with torch.cuda.device(x.device):
        for _ in range(2):
            call(x, out)
        torch.cuda.synchronize()
        times = []
        for _ in range(3):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(reps):
                call(x, out)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) / reps)
    return sorted(times)[1]


def measure(variant: str, depth: int, device=None, load: bool = True) -> float:
    """ms per sweep of one variant at one depth on the card, printed."""
    device = resolve_device(device)
    call, shape = make(variant, depth, device, load=load)
    x = torch.ones(shape, dtype=torch.float32, device=device)
    out = torch.zeros((R, N), dtype=torch.float32, device=device)
    ms = sweep_ms(call, x, out)
    what = "" if load else " (compute only: loads skipped)"
    print(f"{variant} depth {depth}: {ms:.4f} ms/sweep{what}", flush=True)
    return ms


def bytes_ms(device=None) -> float:
    """ms to move one sweep's input and output once at the card's HBM
    peak."""
    device = resolve_device(device)
    gbps = hbm_peak_gbps(torch.cuda.get_device_name(device))
    return 2 * 4 * R * N / (gbps * 1e9) * 1e3


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    device = resolve_device(None)   # the card: raises where there is none
    print(f"card: {torch.cuda.get_device_name(device)}; one sweep moves "
          f"{2 * 4 * R * N / 1e9:.3f} GB: {bytes_ms(device):.4f} ms at the "
          "HBM peak")
    for v in (argv[0] if argv else "ABC"):
        for depth in DEPTHS:
            measure(v, depth, device)
        measure(v, 1, device, load=False)


if __name__ == "__main__":
    main()
