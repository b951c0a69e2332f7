"""Convolution factorization of radius-2 2D stencils — a copy of
``drstencil_tpu/ir/factor.py`` (numpy only).

The pass splits a radius-2 operator W (5x5 coefficient table) into

    W = V1 * V2 + R        (* = 2D convolution)

with V1, V2 3x3 and the residual R supported on the centre column only
(pure axis-0 shifts).  One application of W then becomes two 3x3 levels
plus a correction of at most 5 taps read from the level two back
(``KernelConfig.factor``, kernel ``stencil2d_factor_levels``).

The JAX package introduced it to halve the TPU's lane rolls per level.
On Hopper a tap is a shared-memory load whatever its offset, so what the
mode trades is 25 loads per cell and step against 9 + 9 + 5 loads, one
more level and one more shared-memory tile; whether that pays is for the
card to say (``PERF.md``).  ``tune/space.default_space`` does not sweep it,
as in the JAX package.

The code below is kept identical to the JAX package's, seed, solver and
amplitude gate included, so both packages' kernels apply bit-equal V1, V2
and R (``tests/test_torch_factor.py``).  Exactness: the factorization is
solved to ~1e-14 residual in fp64.  Conditioning: the solution set is a
one-parameter family, and the best-conditioned member is kept; V1*V2 and
R may still reach 30x the table's scale and cancel, so factor mode is
looser in fp32 than the other modes.

Solvability: with V1, V2 symmetric in axis 1 (columns 0 and 2 equal, 6
DOF each) the off-centre-column constraints give 10 equations in 12
unknowns — a generically solvable system (plus gauge).  All benchmark
tables are symmetric in axis 1; tables that are not return None.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

Offset = Tuple[int, ...]


def _conv2(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Full 2D convolution (3x3 * 3x3 -> 5x5), numpy only."""
    out = np.zeros((a.shape[0] + b.shape[0] - 1, a.shape[1] + b.shape[1] - 1))
    for i in range(a.shape[0]):
        for j in range(a.shape[1]):
            out[i : i + b.shape[0], j : j + b.shape[1]] += a[i, j] * b
    return out


def _table(taps: Dict[Offset, float]) -> Optional[np.ndarray]:
    """5x5 coefficient table from a 2D tap map, or None if not radius 2."""
    if not taps or any(len(off) != 2 for off in taps):
        return None
    r0 = max(abs(off[0]) for off in taps)
    r1 = max(abs(off[1]) for off in taps)
    if r0 > 2 or r1 != 2:
        return None
    W = np.zeros((5, 5))
    for (d, s), c in taps.items():
        W[d + 2, s + 2] = c
    return W


def _unpack(v: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """12-vector -> two lane-symmetric 3x3 factors (rows (p, q, p))."""
    V1 = np.empty((3, 3))
    V2 = np.empty((3, 3))
    for i in range(3):
        p1, q1 = v[2 * i], v[2 * i + 1]
        p2, q2 = v[6 + 2 * i], v[7 + 2 * i]
        V1[i] = (p1, q1, p1)
        V2[i] = (p2, q2, p2)
    return V1, V2


def _residuals(v: np.ndarray, W: np.ndarray) -> np.ndarray:
    V1, V2 = _unpack(v)
    D = W - _conv2(V1, V2)
    # off-center-column residuals (s = +1, +2 columns; lane symmetry of
    # the parametrization makes s = -1, -2 redundant) + gauge |V1|^2 = 1
    return np.concatenate([D[:, 3], D[:, 4], [v[:6] @ v[:6] - 1.0]])


def factor_radius2(taps: Dict[Offset, float], seeds: int = 60,
                   tol: float = 1e-13):
    """Solve W = V1 * V2 + R(center column).  Returns (V1, V2, rcol)
    with rcol the 5 residual coefficients at lane shift 0 (row shifts
    -2..2), or None if the table is not a lane-symmetric radius-2 2D
    stencil or no real factorization is found.
    """
    W = _table(taps)
    if W is None:
        return None
    if not (np.allclose(W[:, 0], W[:, 4]) and np.allclose(W[:, 1], W[:, 3])):
        return None
    rng = np.random.default_rng(20260816)
    scale = max(np.max(np.abs(W)), 1e-30)
    # The solution set is a 1-parameter family (10 structural equations,
    # 12 unknowns, 1 gauge): collect converged solutions across seeds and
    # keep the best-CONDITIONED one.  Ill-conditioned members (factor
    # products and residual thousands of times larger than W, cancelling
    # to O(W)) are exact in fp64 but lose everything to fp32 rounding in
    # the kernel — score by the largest intermediate amplitude and reject
    # members beyond 30x the table scale.
    best = None
    best_amp = np.inf
    for _ in range(seeds):
        v = rng.normal(0.0, 1.0, 12) * np.sqrt(scale)
        ok = False
        for _ in range(80):
            r = _residuals(v, W)
            if np.max(np.abs(r[:-1])) < tol and abs(r[-1]) < 1e-9:
                ok = True
                break
            # numeric Jacobian (12x11 system, cheap)
            J = np.empty((r.size, 12))
            for k in range(12):
                dv = np.zeros(12)
                dv[k] = 1e-7 * max(1.0, abs(v[k]))
                J[:, k] = (_residuals(v + dv, W) - r) / dv[k]
            try:
                step, *_ = np.linalg.lstsq(J, r, rcond=None)
            except np.linalg.LinAlgError:
                break
            if not np.all(np.isfinite(step)):
                break
            v = v - step
        if not ok:
            continue
        V1, V2 = _unpack(v)
        D = W - _conv2(V1, V2)
        if np.max(np.abs(D[:, [0, 1, 3, 4]])) >= 1e-12:
            continue
        rcol = D[:, 2]
        amp = max(np.max(np.abs(rcol)),
                  np.max(np.abs(V1)) * np.max(np.abs(V2)))
        if amp < best_amp:
            best_amp = amp
            best = (V1, V2, rcol.copy())
    if best is not None and best_amp <= 30.0 * scale:
        return best
    return None


def factor_tap_lists(taps: Dict[Offset, float]):
    """Factorization as (axis-0 shift, axis-1 shift, coeff) tap lists:
    (v1_taps, v2_taps, r_taps) or None.

    Lists are sorted, zeros dropped, coefficients float64 — the order
    ``ops/stream.level_plan`` keeps for its tables, so sums run in the
    same order in both packages.
    """
    f = factor_radius2(taps)
    if f is None:
        return None
    V1, V2, rcol = f

    def to_list(V):
        out = []
        for i in range(3):
            for j in range(3):
                if V[i, j] != 0.0:
                    out.append((i - 1, j - 1, float(V[i, j])))
        out.sort()
        return out

    r_taps = [(d - 2, 0, float(rcol[d])) for d in range(5) if rcol[d] != 0.0]
    r_taps.sort()
    return to_list(V1), to_list(V2), r_taps
