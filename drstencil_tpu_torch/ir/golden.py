"""NumPy golden model — the framework's source of truth for correctness.

Reproduces the semantics of the reference's generated gold kernel + host
protocol (codegen.hpp:637-660, 547-635):

- one *launch* applies the **fused** operator (``step`` timesteps) to the
  interior ``[halo, dim-halo)`` of every axis, with ``halo`` = fused order;
  boundary cells of the destination buffer are left untouched;
- the run protocol is a ping-pong over two buffers: ``in`` starts random,
  ``out`` starts zero, and launches alternate (in→out, out→in) for
  ``ceil(iterations / (2·step))`` pairs;
- the result compared is the ``in`` buffer after the final pair, over the
  interior only (checkError3D call site, codegen.hpp:618-621).

Everything is float64 (the reference is fp64 end-to-end; the CUDA kernels
are fp32 and are validated against this model to fp32 tolerance).  A copy
of ``drstencil_tpu/ir/golden.py``, so both packages share one arbiter and
one initial state (``random_state``).
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from drstencil_tpu_torch.ir.spec import StencilSpec, Taps
from drstencil_tpu_torch.ir.passes import fuse, order_of


def apply_interior(
    src: np.ndarray, dst: np.ndarray, taps: Taps, halo: int
) -> np.ndarray:
    """Return a copy of ``dst`` whose interior is the stencil of ``src``.

    Interior = ``[halo, dim-halo)`` along every axis; boundary keeps
    ``dst``'s values (the reference kernels never write boundary cells).
    """
    nd = src.ndim
    for off in taps:
        if any(abs(o) > halo for o in off):
            raise ValueError(
                f"tap offset {off} exceeds the interior margin halo={halo}; "
                "the golden model requires every offset within the halo"
            )
    out = dst.copy()
    interior = tuple(slice(halo, d - halo) for d in src.shape)
    acc = np.zeros(tuple(d - 2 * halo for d in src.shape), dtype=src.dtype)
    for off, coe in taps.items():
        sl = tuple(
            slice(halo + off[a], src.shape[a] - halo + off[a]) for a in range(nd)
        )
        acc += coe * src[sl]
    out[interior] = acc
    return out


def num_launch_pairs(iterations: int, step: int) -> int:
    """``for (t = 0; t < Iterations; t += 2*step)`` trip count
    (codegen.hpp:581)."""
    return -(-iterations // (2 * step))


def random_state(
    spec: StencilSpec, seed: int = 0, dtype=np.float64
) -> Tuple[np.ndarray, np.ndarray]:
    """Initial (in, out) buffers: uniform [0, 100) input (the reference's
    getRandom*Array scales rand() to ~[0,100)), zero output."""
    rng = np.random.default_rng(seed)
    a = rng.uniform(0.0, 100.0, size=spec.dims).astype(dtype)
    b = np.zeros(spec.dims, dtype=dtype)
    return a, b


def run_golden(
    spec: StencilSpec,
    step: int = 1,
    seed: int = 0,
    pairs: int | None = None,
) -> Dict[str, np.ndarray]:
    """Run the full golden ping-pong protocol.

    Returns dict with 'a' (the final ``in`` buffer — the compared one),
    'b' (the final ``out`` buffer), and 'halo'.
    """
    fused = fuse(spec.taps, step)
    halo = order_of(fused)
    a, b = random_state(spec, seed)
    n = num_launch_pairs(spec.iterations, step) if pairs is None else pairs
    for _ in range(n):
        b = apply_interior(a, b, fused, halo)
        a = apply_interior(b, a, fused, halo)
    return {"a": a, "b": b, "halo": np.asarray(halo)}


def check_error(
    got: np.ndarray, want: np.ndarray, halo: int
) -> Tuple[float, float]:
    """(max_abs_error, rms_error) over the interior, as checkError2D/3D
    (common.hpp:47-102) but returned instead of printed."""
    interior = tuple(slice(halo, d - halo) for d in got.shape)
    g = np.asarray(got, dtype=np.float64)[interior]
    w = np.asarray(want, dtype=np.float64)[interior]
    diff = np.abs(g - w)
    max_err = float(diff.max()) if diff.size else 0.0
    rms = float(np.sqrt(np.mean((g - w) ** 2))) if diff.size else 0.0
    return max_err, rms
