"""The check of a sharded cell on dependence cones: boxes of the answer held
to the plain reference run on crops of the initial field.

A box is a half-open range ``[lo, hi)`` of global cells on every axis. Its
crop is the box widened on every axis by ``widening`` cells, the computed
timesteps times the table's reach, and clipped at the grid's edges. The
reference (``reference.solve``, unchanged) run on the crop alone freezes the
crop's frame. Where the crop meets the grid's edge that frame is the true
one. Where the crop is cut inside the grid its frame goes stale after the
first application, and each application carries that error at most ``H``
cells (the fused table's order) further in: after ``applications x H =
computed timesteps x reach`` cells it has not reached the box, so the box's
cells run the same operations on the same values as on the whole grid and
equal its reference bit for bit.

The boxes of a run, at least ``size`` cells each (clipped to the grid):

- ``seam <plane>``: one across each seam between axis-0 blocks, half of it
  on each side;
- ``edge 0``, ``edge <dims[0]>``: one on each global axis-0 edge, its frame
  included;
- ``corner``: one at a corner of the other axes, which corner drawn from the
  seed;
- ``interior 1``, ``interior 2``: drawn from the seed.

The other axes' place of each box but the corner is drawn from the seed.
The sample leaves most cells unseen: a fault confined to cells outside every
box (one altered cell) is not seen, while one that reaches a seam, an edge,
a block or the whole grid is.
"""

from __future__ import annotations

import random
from typing import Dict, Tuple

import torch

from stencilbench import reference

Box = Tuple[Tuple[int, ...], Tuple[int, ...]]


def widening(taps, computed_timesteps: int) -> int:
    """How far the crop reaches past the box on every axis: the computed
    timesteps times the single-step table's reach."""
    reach = max(abs(o) for off in taps for o in off)
    return computed_timesteps * reach


def boxes(dims, blocks: int, seed: int, size) -> Dict[str, Box]:
    """The boxes of a grid of ``dims`` split in ``blocks`` axis-0 blocks,
    for ``seed``."""
    dims = tuple(dims)
    if len(size) != len(dims) or dims[0] % blocks:
        raise ValueError(f"boxes of {tuple(size)} on {dims} in {blocks} "
                         "blocks")
    size = tuple(min(s, d) for s, d in zip(size, dims))
    rng = random.Random(f"{seed} boxes")

    def drawn(axis: int) -> int:
        return rng.randrange(dims[axis] - size[axis] + 1)

    def box(lo0: int, rest) -> Box:
        lo = (lo0,) + tuple(rest)
        return lo, tuple(a + s for a, s in zip(lo, size))

    out: Dict[str, Box] = {}
    rows = dims[0] // blocks
    for k in range(1, blocks):
        lo0 = min(max(k * rows - size[0] // 2, 0), dims[0] - size[0])
        out[f"seam {k * rows}"] = box(lo0, map(drawn, range(1, len(dims))))
    out["edge 0"] = box(0, map(drawn, range(1, len(dims))))
    out[f"edge {dims[0]}"] = box(dims[0] - size[0],
                                 map(drawn, range(1, len(dims))))
    out["corner"] = box(drawn(0), (rng.choice((0, d - s)) for d, s in
                                   zip(dims[1:], size[1:])))
    for i in (1, 2):
        out[f"interior {i}"] = box(drawn(0), map(drawn, range(1, len(dims))))
    return out


def crop(b: Box, dims, widen: int) -> Box:
    """The box widened by ``widen`` cells on every axis, clipped to the
    grid."""
    lo, hi = b
    return (tuple(max(0, a - widen) for a in lo),
            tuple(min(d, z + widen) for z, d in zip(hi, dims)))


def within(b: Box, outer_lo=None) -> tuple:
    """Slices of box ``b`` in the coordinates of a block starting at
    ``outer_lo`` (the grid's origin by default)."""
    lo, hi = b
    outer_lo = outer_lo or (0,) * len(lo)
    return tuple(slice(a - o, z - o) for a, z, o in zip(lo, hi, outer_lo))


def reference_box(field: torch.Tensor, b: Box, c: Box, taps, step: int,
                  pairs: int) -> torch.Tensor:
    """The fp64 reference of box ``b``: ``reference.solve`` run on
    ``field``, the initial field's crop ``c``, restricted to the box."""
    return reference.solve(field, taps, step, pairs)[within(b, c[0])]
