"""Analysis passes over the stencil IR.

These are pure-function mirrors of the reference's pass pipeline
(fuse → set_order_distance → partition → cal_range; reference:
drstencil.hpp:262-311, drstencil_2d.hpp:180-276, pass order fixed by
main.cpp:247-249), generalized over dimensionality: offsets are tuples
with **axis 0 as the streaming axis** (k in 3D, j in 2D).

The partition exists in the reference because a CUDA thread block holds a
window of streaming-axis planes in shared memory and must split tap
contributions into "computable now for a future plane" (forward) vs
"accumulate into the current plane" (backward).  The port's Hopper
kernels (ops/kernels.py) stage a whole haloed tile in shared memory, so
the partition is not needed for correctness — it is kept so that the
port accepts and rejects exactly the configurations the JAX package does
(``AnalysisError`` for a stencil with no axis-0 reuse).

A copy of ``drstencil_tpu/ir/passes.py``: the port imports nothing of the
JAX package.  ``compose`` keeps its sorted iteration so fused tables come
out bit-equal to the JAX package's.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, FrozenSet, Mapping, Optional, Tuple

from drstencil_tpu_torch.ir.spec import Offset, StencilSpec, Taps


class AnalysisError(ValueError):
    """Raised when a pass rejects the stencil/config combination."""


def compose(a: Taps, b: Taps) -> Dict[Offset, float]:
    """Compose two linear stencil operators: (a ∘ b) applied = a after b.

    Offsets add, coefficients multiply-and-accumulate.  Equivalent to the
    reference's recursive ``do_fusing`` expansion (drstencil.hpp:262-276)
    but iterative (O(|a|·|b|) instead of points^step recursion).

    Iteration is in sorted-offset order so the per-key fp64 accumulation
    sequence is IDENTICAL to the native std::map loop — symmetric fused
    entries must come out bit-equal on both sides or plan_taps' exact
    row/column grouping diverges between the library kernel and the
    emitted program (first seen on the 125-tap fused 3d27pt_box table,
    where insertion-order sums drifted 1 ULP and split a row group).
    """
    out: Dict[Offset, float] = {}
    for oa, ca in sorted(a.items()):
        for ob, cb in sorted(b.items()):
            key = tuple(x + y for x, y in zip(oa, ob))
            out[key] = out.get(key, 0.0) + ca * cb
    return out


def fuse(taps: Taps, step: int) -> Dict[Offset, float]:
    """Temporally fuse ``step`` applications of the stencil into one operator.

    ``fuse(s, 1) == s``; ``fuse(s, 2)`` is the operator of two timesteps.
    Mirrors ``DRStencil::fusing`` (drstencil.hpp:278-282).
    """
    if step < 1:
        raise AnalysisError(f"step must be >= 1, got {step}")
    ndim = len(next(iter(taps)))
    fused: Dict[Offset, float] = {(0,) * ndim: 1.0}
    for _ in range(step):
        fused = compose(fused, taps)
    return fused


def order_of(taps: Taps) -> int:
    """The stencil order: max positive offset along the streaming axis.

    Reference semantics exactly (drstencil.hpp:88-98): the *positive* axis-0
    extent, used as the halo width in every axis (valid for the symmetric
    stencils the suite ships; asymmetric stencils are validated against the
    true per-axis radius by callers).
    """
    return max(0, max(off[0] for off in taps))


def default_distance(taps: Taps) -> int:
    """Default data-reuse distance: half the axis-0 extent of the fused
    stencil, ``(high - low) >> 1`` (drstencil.hpp:101-102)."""
    ks = [off[0] for off in taps]
    high, low = max(max(ks), 0), min(min(ks), 0)
    return (high - low) >> 1


@dataclass(frozen=True)
class Partition:
    """Data-reuse partition of a fused stencil's taps.

    ``forward[a]`` holds taps whose contribution to an output point
    ``distance`` cells ahead along axis ``a`` can be computed while the
    current plane window is resident; ``backward`` holds the rest,
    accumulated into the current output plane.  Axis 0 is the streaming
    axis (forward_k in the 3D reference, forward_j in 2D); reference:
    drstencil.hpp:198-259 / drstencil_2d.hpp:180-228.

    Invariants (checked by ``partition``): the contributing source offsets
    of all partitions are disjoint and their union is the full tap set.
    """

    forward: Tuple[FrozenSet[Offset], ...]
    backward: FrozenSet[Offset]
    distance: int
    low: int   # min axis-0 offset over all partitioned taps (plane window)
    high: int  # max axis-0 offset over all partitioned taps

    @property
    def window(self) -> int:
        """Number of streaming-axis planes that must be resident
        (the reference's ``Range``, codegen.hpp:89)."""
        return self.high - self.low + 1


def _shift(off: Offset, axis: int, delta: int) -> Offset:
    return off[:axis] + (off[axis] + delta,) + off[axis + 1 :]


def partition(taps: Taps, distance: int, merge_forward: int = 5) -> Partition:
    """Partition fused taps into per-axis forward sets + a backward set.

    Mirror of the reference algorithm (drstencil.hpp:198-259) with the
    C++ ``std::set``/``std::map`` sorted-iteration order reproduced via
    ``sorted()`` so that the dedup tie-breaking is bit-identical:

    - ``contri[a]`` = taps p such that ``p - distance·ê_a`` is also a tap
      (p's contribution to the output ``distance`` ahead on axis ``a`` can
      reuse the resident window);
    - axis 0 takes all its candidates; later axes take candidates whose
      *target* (``p - distance·ê_a``) wasn't already covered;
    - remaining taps go backward;
    - empty axis-0 forward set is an error ("No data to reuse",
      drstencil.hpp:243-246);
    - forward sets (axes >= 1) smaller than ``merge_forward`` are folded
      back into backward (as their shifted targets), since a separate
      guarded accumulation pass isn't worth it (drstencil.hpp:249-258).
    """
    if distance <= 0:
        raise AnalysisError(f"distance must be positive, got {distance}")
    ndim = len(next(iter(taps)))
    keys = sorted(taps)
    contri = [
        [p for p in keys if _shift(p, a, -distance) in taps] for a in range(ndim)
    ]

    done: set[Offset] = set()
    forward: list[set[Offset]] = [set() for _ in range(ndim)]
    for a in range(ndim):
        for p in contri[a]:
            target = _shift(p, a, -distance)
            if a > 0 and target in done:
                continue
            forward[a].add(p)
            done.add(target)
    backward = {p for p in keys if p not in done}

    if not forward[0]:
        raise AnalysisError(
            "No data to reuse along the streaming axis at distance "
            f"{distance}; try another dist."
        )

    # Fold small non-stream forward sets back into backward.
    for a in range(1, ndim):
        if len(forward[a]) < merge_forward:
            for p in forward[a]:
                backward.add(_shift(p, a, -distance))
            forward[a] = set()

    # Plane-window range over all partitioned taps (cal_range,
    # drstencil.hpp:285-304; initialized to (1, -1) exactly as the
    # reference so an all-center partition still yields window >= 1).
    low, high = 1, -1
    for group in (*forward, backward):
        for off in group:
            low = min(low, off[0])
            high = max(high, off[0])

    part = Partition(
        forward=tuple(frozenset(f) for f in forward),
        backward=frozenset(backward),
        distance=distance,
        low=low,
        high=high,
    )
    _check_partition_invariants(taps, part)
    return part


def _check_partition_invariants(taps: Taps, part: Partition) -> None:
    """Every tap's contribution is counted exactly once.

    A tap p in forward[a] contributes coefficient taps[p - dist·ê_a] to the
    output dist ahead; a tap in backward contributes taps[p] directly.  The
    *source coefficients* used must cover the tap set exactly once.
    """
    covered: list[Offset] = []
    for a, group in enumerate(part.forward):
        for p in group:
            covered.append(_shift(p, a, -part.distance))
    covered.extend(part.backward)
    if sorted(covered) != sorted(taps):
        raise AnalysisError(
            "partition invariant violated: contributions do not cover the "
            "tap set exactly once (this is a bug)"
        )


@dataclass(frozen=True)
class Analysis:
    """Full analysis result for one (spec, step, distance) configuration —
    the IR handed to the emitter/kernel builders, equivalent to the
    analyzed ``DRStencil`` object passed to ``codeGen`` (main.cpp:251)."""

    spec: StencilSpec
    step: int
    fused: Mapping[Offset, float]
    order: int
    distance: int
    # None only for non-streaming consumers (analyze(...,
    # require_partition=False)): the XLA gold applies the fused operator
    # whole and has no streaming structure to partition.
    part: Optional[Partition]

    @property
    def halo(self) -> int:
        """Interior margin = fused order (codegen.hpp:90)."""
        return self.order


def analyze(
    spec: StencilSpec,
    step: int = 1,
    distance: int = 0,
    merge_forward: int = 5,
    require_partition: bool = True,
) -> Analysis:
    """Run the full reference pass pipeline: fuse → order/distance →
    partition → range (main.cpp:247-249 ordering: everything downstream of
    fusing operates on the *fused* stencil).

    ``require_partition=False`` tolerates a partition failure ("No data
    to reuse…") and returns ``part=None``: the XLA gold variant applies
    the fused operator whole, so it has no streaming structure to
    partition — e.g. the step-1 gold for a deep pure-diagonal config has
    no reuse at any distance in the step-1 reference range, yet is a
    perfectly good differential-check reference.  Streaming/emitting
    consumers must keep the reference's hard error (drstencil.hpp:243-246).
    """
    fused = fuse(spec.taps, step)
    order = order_of(fused)
    dist = distance if distance != 0 else default_distance(fused)
    try:
        part = partition(fused, dist, merge_forward)
    except AnalysisError:
        if require_partition:
            raise
        part = None
    return Analysis(
        spec=spec, step=step, fused=fused, order=order, distance=dist, part=part
    )
