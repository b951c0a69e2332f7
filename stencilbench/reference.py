"""The plain reference: a 48-step solve of a `.stc` table in fp64 PyTorch.

It reads the configuration's frozen `.stc` copy with a parser of its own and
works out again what the program derives from it: the operator of ``step``
fused timesteps (the table composed ``step`` times), its frame ``H`` (the
fused table's largest axis-0 offset, DRStencil's order) and the ping-pong
over two buffers. One application writes the interior ``[H, dim - H)`` of
every axis of its destination from its source and leaves the destination's
frame as it was; the input buffer ``a`` keeps the field's own frame, ``b``
starts at zero and keeps a zero frame. Nothing of the program is imported.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

Offset = Tuple[int, ...]


def parse_stc(text: str) -> Tuple[Tuple[int, ...], Dict[Offset, float]]:
    """``(dims, taps)`` of `.stc` text: ``[L] M N``, ``iterations``, then one
    ``offset... coefficient`` row per tap after ``stencil``; ``#`` starts a
    comment. A repeated offset adds its coefficients."""
    tokens = " ".join(line.split("#", 1)[0]
                      for line in text.splitlines()).split()
    sizes: Dict[str, int] = {}
    i = 0
    while i < len(tokens) and tokens[i] != "stencil":
        key, value = tokens[i], tokens[i + 1]
        if key not in ("L", "M", "N", "iterations"):
            raise ValueError(f"unknown .stc key {key!r}")
        sizes[key] = int(value)
        i += 2
    dims = tuple(sizes[k] for k in ("L", "M", "N") if k in sizes)
    rows = tokens[i + 1:]
    width = len(dims) + 1
    if len(dims) not in (2, 3) or not rows or len(rows) % width:
        raise ValueError("a .stc needs M, N (and L in 3D) and a full table")
    taps: Dict[Offset, float] = {}
    for r in range(0, len(rows), width):
        off = tuple(int(t) for t in rows[r:r + width - 1])
        taps[off] = taps.get(off, 0.0) + float(rows[r + width - 1])
    return dims, taps


def load_stc(path: str):
    with open(path) as f:
        return parse_stc(f.read())


def fuse(taps: Dict[Offset, float], step: int) -> Dict[Offset, float]:
    """The operator of ``step`` timesteps: ``taps`` composed with itself."""
    out: Dict[Offset, float] = {(0,) * len(next(iter(taps))): 1.0}
    for _ in range(step):
        nxt: Dict[Offset, float] = {}
        for oa, ca in out.items():
            for ob, cb in taps.items():
                key = tuple(x + y for x, y in zip(oa, ob))
                nxt[key] = nxt.get(key, 0.0) + ca * cb
        out = nxt
    return out


def frame(fused: Dict[Offset, float]) -> int:
    """The frozen frame: the largest axis-0 offset of the fused table, which
    must bound every offset of it on every axis."""
    h = max(0, max(off[0] for off in fused))
    if any(abs(o) > h for off in fused for o in off):
        raise ValueError("the table reaches past its axis-0 order")
    return h


def apply(src: torch.Tensor, dst: torch.Tensor,
          fused: Dict[Offset, float], h: int) -> None:
    """``dst``'s interior ``[h, dim - h)`` from ``src``, in place."""
    inner = tuple(slice(h, d - h) for d in src.shape)
    acc = torch.zeros([d - 2 * h for d in src.shape], dtype=src.dtype,
                      device=src.device)
    for off, c in fused.items():
        acc.add_(src[tuple(slice(h + o, d - h + o)
                           for o, d in zip(off, src.shape))], alpha=c)
    dst[inner] = acc


def solve(field: torch.Tensor, taps: Dict[Offset, float], step: int,
          pairs: int, dtype=torch.float64, store=None) -> torch.Tensor:
    """``a`` after ``pairs`` ping-pong pairs of the ``step``-fused operator
    from the initial field, in ``dtype`` (fp64 unless a control asks for
    less) on the field's device. ``store``, where given, rounds the state in
    place: the input once, then each application's destination, as a state
    held in a narrower type is rounded at each store."""
    fused = fuse(taps, step)
    h = frame(fused)
    keep = store or (lambda t: t)
    a = keep(field.to(dtype, copy=True))
    b = torch.zeros_like(a)
    for _ in range(pairs):
        apply(a, b, fused, h)
        keep(b)
        apply(b, a, fused, h)
        keep(a)
    return a


def round_bits_(x: torch.Tensor, bits: int) -> torch.Tensor:
    """``x`` rounded in place to ``bits`` significant bits, to nearest even,
    with the exponent unbounded: float8 e4m3's precision (``bits=4``)
    without its range, which the field outgrows. ``x`` is fp32 or fp64;
    zero, the sign and magnitudes from 2**-100 to 2**100 are kept."""
    m, e = torch.frexp(x)
    # m in [0.5, 1): ``bits`` bits are the integers in [2**(bits-1), 2**bits)
    m.mul_(2 ** bits).round_().div_(2 ** bits)
    return x.copy_(torch.ldexp(m, e))


def max_rel_err(got: torch.Tensor, ref: torch.Tensor) -> float:
    """max |got - ref| / |ref| over every cell (frame included), in fp64 on
    ``ref``'s device; a cell where ``ref`` is 0 is held to ``got`` being 0.
    Every reference value here is a sum of non-negative terms, so no
    cancellation hides in the denominator. NaN or inf reads as inf."""
    g = got.to(ref.device, torch.float64)
    err = (g - ref).abs_()
    err.div_(ref.abs().clamp_(min=1e-300))
    worst = float(err.max())
    return worst if math.isfinite(worst) else math.inf
