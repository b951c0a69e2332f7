"""CUDA text of the streamed kernels, specialised to one plan.

``cuda_source`` writes the kernel that replaces the TPU streaming kernel
``drstencil_tpu/ops/stream.py:568-803`` (K1-K5, K7, and K8 with a store
range) for ONE plan: tap table, levels, reach, grid dims, storage type.
The library builds it per plan (``ops/kernels.plan_kernel``) and the
emitter puts the same text into its programs (``emit.emit``), so an
emitted program's ``CUDA_SOURCE`` is the library's kernel of that plan.

What the kernel computes: ``levels`` applications of the tap table to the
interior ``[H, dim - H)`` of every axis (``H = levels * reach``), reading
``src``, writing ``dst``; a frame cell is never written; out-of-domain
source cells read 0; every level is fp32 whatever the storage type, with
one round-to-nearest-even at a bf16 store.  The shard build stores the
axis-0 range ``[s_lo, s_hi)`` of a ghosted slab.

What bounds it on an H100: the function moves ``2 * item * cells`` bytes
and does ``2 * taps * levels * cells`` fp32 flops; the tuned winners sit
near the bytes side, so the kernel's job is to touch device memory about
once and keep every level on chip without drowning in shared-memory
loads, halo recompute or idle SMs.

Design (:class:`Geometry` holds the numbers):

- *Streamed along axis 0.*  A CTA owns a column of the grid — ``TY x TX``
  cells of (y, x) in 3D, a strip of ``TX`` columns in 2D — and a segment
  of ``SEG`` planes (rows in 2D) of axis 0, and walks the planes in a
  loop; the TPU kernel's sequential grid becomes that loop.  Level ``t``
  lags level ``t - 1`` by ``reach + 1`` planes and keeps only a ring of
  ``2 * reach + 2`` planes in shared memory, so the halo is recomputed in
  y and x only; along axis 0 a segment pays ``2 * H`` warm-up planes.
  One ring slot more than the window lets all levels of a step run
  between two barriers: one ``__syncthreads`` per plane, not per level.
- *Register-blocked.*  A thread computes four adjacent outputs along x
  (a quad) at a time.  The text knows the taps: per tap row (one offset
  on the other axes) it loads the aligned ``float4`` blocks that cover
  the quad's x window once and feeds all four outputs from them, so a
  7-point star's level costs 7 shared-memory loads per four cells, not
  28.  A row's loads sit right before its ``fmaf``s, so the live
  registers stay one row's worth whatever the size of the table.
- *Summation order.*  Each output cell is one ``fmaf`` chain over the
  table in ``ops/stream.tap_table``'s sorted order from ``acc = 0`` —
  the arithmetic of the table-driven kernels this text replaced, cell
  for cell.
- *Register windows (2D).*  A 2D strip gives every thread one quad column
  for all rows and levels.  Where ``levels * (2 * reach + 1)`` quads fit
  ``WINDOW_REGS`` registers the thread also carries its own cells' last
  ``2 * reach + 1`` rows of every level in registers (the levels then run
  last to first within a step, so that level ``t`` reads level ``t - 1``'s
  window before it moves on), and only the cells beside its quad come from
  the rings: a 5-point star's level costs 2 shared loads per four cells.
  Deep or wide plans (2d25pt_box: 120 registers) and 3D plans (several
  quads per thread) keep to the rings.
- *Loads.*  Planes start on a multiple of four columns, so the source is
  read and the result written as 16-byte quads (8 bytes of bf16) with
  the domain's edge decided per quad; a grid whose width is not a
  multiple of four falls back to cell-wise access.  Every plan stages
  ahead.  A windowed 2D plan requests source rows ``AHEAD_2D`` steps ahead
  with ``cp.async`` (out-of-domain quads zero-filled) into a small staging
  ring in the state's own type, and each thread converts the quads it
  requested on the way into the fp32 ring: a strip's row is only 2 KB, and
  tens of KB must be in flight per SM to keep device memory busy.  Every
  other plan requests the next plane's quads into registers before the
  step's levels and stages them after (a plane is 8 KB or more, and the
  rings leave no shared memory for more planes).  The staging depth is
  not a knob: ``KernelConfig.prefetch`` is accepted and changes nothing.
- Every shape is a ``constexpr``; coefficients are float32 hexadecimal
  literals; no table is passed.  The interface is plain C: ``launch(src,
  dst[, s_lo, s_hi], stream)`` returns ``cudaGetLastError()``.

Factor mode (``FactorTaps``: the TPU kernel's ``factor=True`` build, K6,
``drstencil_tpu/ops/stream.py:446-474, 683-714``) is the same 2D text with
two level functions: odd levels apply V1 to the level below, even levels
V2 to the level below plus R (axis-0 taps only, reach 2) to the level two
below, each table one ``fmaf`` chain from 0 in its sorted order and the
two chains joined by one add.  R reads only the thread's own column, so a
factor plan is always windowed and the levels R reads keep ``4 * reach +
2`` rows in registers (their newest row is ``2 * reach + 1`` past R's
output row when it is read); those levels, and the staged source, run one
row past their range so that the windows shift on to the last output row.
Its shard build (``stencil2d_factor_levels_shard``, the TPU kernel's
``factor=True, row_frame=False``) is the same text with the store range:
a segment is the same walk whichever row it starts on, and the row one past
the last window lies outside the slab at the global edge and reads 0, as a
row past ``M`` does; no stored cell reads it.

``tile2d_source`` writes ``tile2d_fused``, the kernel of the plain-tile
experiment (the TPU kernel ``tuning/exp_tile2d.py:78-89``, K10), for one
table and layout: one level of the fused operator on a padded layout whose
columns wrap.  It streams a strip of columns down a segment of rows through
a ring of source rows requested ahead by ``cp.async`` (the wrap decided
per 16-byte quad), four outputs per thread, in the TPU kernel's order: per
column shift a multiply then ``fmaf``s in ascending row offset, the
shifts' sums added in ascending column shift.
"""

from __future__ import annotations

import dataclasses
import hashlib
from dataclasses import dataclass
from typing import Tuple

import numpy as np

# Shared memory one block may use on Hopper (227 KB), and what a CTA aims
# to stay under so that two fit on an SM beside their 1 KB reservations.
SMEM_LIMIT = 232448
SMEM_TARGET = 113 * 1024
SMEM_RESERVED = 1024
# SMs of an H100 SXM.  The segment count is chosen to fill the card's SMs:
# on a card the library passes the count it reads from the device
# (``ops/kernels.sm_count``); this value is only that of text made without
# one (the tests, the g++ emulation) and of the emitter's programs
SM_COUNT = 132
# outputs a thread computes at a time along x
QUAD = 4
# widest plane of a 2D strip (cells, halo included), and the 3D columns
# (TY, TX) tried in order until the rings fit SMEM_TARGET
STRIP_2D = (512, 256, 128, 64, 32, 16, 8)
COLUMNS_3D = ((32, 64), (24, 64), (16, 64), (12, 64), (8, 64), (8, 32),
              (4, 32), (4, 16), (2, 16), (2, 8), (1, 8), (1, 4))
THREADS_3D = 256
# 2D: a thread keeps its own cells' window of every level in registers
# where that takes at most this many of them
WINDOW_REGS = 96
# 2D with register windows: rows requested ahead of their use by cp.async:
# a strip's row is 2 KB, and an SM needs tens of KB in flight to keep device
# memory busy
AHEAD_2D = 8
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
DTYPES = ("float32", "bfloat16")


class EmitError(ValueError):
    """Raised when a stencil/config combination has no kernel text."""


def float32_literal(c) -> str:
    """``c`` rounded to float32 as a C++17 hexadecimal float literal with
    the ``f`` suffix: exactly the float32 of ``LevelTaps.coeffs``.  A
    decimal literal without the suffix would be a double and promote the
    level's arithmetic."""
    v = np.float32(c)
    if not np.isfinite(v):
        raise EmitError(f"non-finite coefficient {c!r}")
    mantissa, exponent = float(v).hex().split("p")
    mantissa = mantissa.rstrip("0")
    if mantissa.endswith("."):
        mantissa += "0"
    return f"{mantissa}p{exponent}f"


def literal_value(lit: str) -> float:
    """The value of a :func:`float32_literal` (for tests and checks)."""
    return float.fromhex(lit[:-1])


def _ceil_to(n: int, m: int) -> int:
    return -(-n // m) * m


@dataclass(frozen=True)
class Geometry:
    """How one plan's kernel cuts a grid of ``dims``.

    ``tile`` is the output cells of one CTA, axis 0 first: ``(SEG, TX)`` in
    2D and ``(SEG, TY, TX)`` in 3D — a segment of axis 0 and the column
    (strip) it walks.  A staged plane is ``ey x ex`` fp32 cells: the column
    with ``frame`` halo rows on each side of y (``ey = 1`` in 2D) and
    ``hx`` halo columns (the frame rounded up to whole quads) on each side
    of x.  Each of the ``levels`` levels keeps a ring of ``ring`` planes.
    With ``window`` (2D plans whose windows fit ``WINDOW_REGS``) a thread
    owns one quad column of the strip and also carries its own cells' last
    ``2 * reach + 1`` rows of every level in registers, so that only taps
    that reach into a neighbour's columns read the rings.  ``ahead`` > 0
    (windowed plans with 16-byte access) is the number
    of source rows requested ahead by ``cp.async`` into ``ahead + 1``
    staging rows; 0 stages through registers.  A ``factor`` plan (2D,
    always windowed) keeps ``window_len`` rows of every level and stages
    ``tail`` source rows past its segment's window."""

    dims: Tuple[int, ...]
    frame: int
    reach: int
    levels: int
    tile: Tuple[int, ...]
    hx: int
    ey: int
    ex: int
    ring: int
    threads: int
    min_blocks: int
    vec: bool
    window: bool = False
    ahead: int = 0
    factor: bool = False

    @property
    def ndim(self) -> int:
        return len(self.dims)

    @property
    def window_len(self) -> int:
        """Rows of each level a windowed thread keeps: the ``2 * reach +
        1`` a level reads of the one below; a factor plan's V2 level also
        reads R's ``4 * reach + 1`` rows of the level two below, whose
        newest row is then one step ahead of them."""
        return 4 * self.reach + 2 if self.factor else 2 * self.reach + 1

    @property
    def tail(self) -> int:
        """Source rows staged past a segment's window (see ``_kernel_text``):
        1 for a factor plan."""
        return 1 if self.factor else 0

    @property
    def plane_cells(self) -> int:
        return self.ey * self.ex

    @property
    def guard(self) -> int:
        """Floats before and after the rings: a quad at a plane's edge
        reads up to ``reach`` cells past it, rounded up to whole quads
        (values that reach no stored cell)."""
        return _ceil_to(self.reach, QUAD)

    @property
    def window_planes(self) -> int:
        """fp32 planes of one CTA in shared memory: the levels' rings and
        the staging planes (sized for fp32 whatever the state's type)."""
        return self.levels * self.ring + (self.ahead + 1 if self.ahead else 0)

    @property
    def smem_bytes(self) -> int:
        return 4 * (2 * self.guard + self.window_planes * self.plane_cells)

    @property
    def warmup(self) -> int:
        """Steps a segment runs beyond its own planes."""
        return 2 * self.frame + self.levels

    @property
    def interior(self) -> int:
        return max(0, self.dims[0] - 2 * self.frame)

    @property
    def n_segments(self) -> int:
        return max(1, -(-self.interior // self.tile[0]))

    @property
    def n_columns(self) -> int:
        return int(np.prod([-(-d // t) for d, t
                            in zip(self.dims[1:], self.tile[1:])]))

    @property
    def grid(self) -> Tuple[int, ...]:
        """CTAs per axis, x first (CUDA's order), segments last."""
        cols = [-(-d // t) for d, t in zip(self.dims[1:], self.tile[1:])]
        return tuple(reversed(cols)) + (self.n_segments,)

    @property
    def ctas_per_sm(self) -> int:
        """CTAs an SM holds by shared memory and threads, at most 8."""
        return max(1, min(SMEM_LIMIT // (self.smem_bytes + SMEM_RESERVED),
                          2048 // self.threads, 8))

    def level_region(self, t: int):
        """(first row, rows, first quad, quads) of the plane cells level
        ``t`` (1-based) computes: the column grown by what the later
        levels still reach, whole quads along x."""
        grow = self.frame - t * self.reach
        y0 = t * self.reach if self.ndim == 3 else 0
        rows = self.ey - 2 * y0 if self.ndim == 3 else 1
        q0 = (self.hx - grow) // QUAD
        q1 = -(-(self.hx + self.tile[-1] + grow) // QUAD)
        return y0, rows, q0, q1 - q0

    def read_cells(self) -> int:
        """Source cells the kernel requests per application: every CTA
        stages its segment's planes plus ``2 * frame`` warm-up planes."""
        seg, n = self.tile[0], self.interior
        planes = sum(min(seg, n - k * seg) + 2 * self.frame + self.tail
                     for k in range(self.n_segments)) if n else 0
        return self.n_columns * planes * self.plane_cells


def _segment(interior: int, n_cols: int, warmup: int, slots: int) -> int:
    """Planes per segment: the count of segments that minimises waves of
    CTAs times steps per CTA (a wave fills ``slots`` CTAs at once)."""
    if interior <= 0:
        return 1
    best = None
    for n in range(1, interior + 1):
        seg = -(-interior // n)
        if n > 1 and seg < warmup:
            break
        ctas = n_cols * -(-interior // seg)
        cost = -(-ctas // slots) * (seg + warmup)
        if best is None or cost < best[0]:
            best = (cost, seg)
    return best[1]


def _asked_segment(segment: int, interior: int, warmup: int) -> int:
    """A segment the caller asked for (``KernelConfig.tm``), cut to the
    interior: shorter than ``warmup`` only where it covers the whole
    interior, as ``_segment`` requires of its own."""
    if segment < 1:
        raise ValueError(f"segment tm={segment} must be at least 1")
    seg = min(segment, max(1, interior))
    if seg < warmup and seg < interior:
        raise ValueError(
            f"segment tm={segment} is shorter than the {warmup} planes a "
            f"segment runs beyond its own (and than the {interior}-plane "
            "interior)")
    return seg


def is_factor(plan) -> bool:
    """Whether ``plan`` is a factor-mode plan (``ops/kernels.FactorTaps``)."""
    return hasattr(plan, "v2")


def window_regs(plan) -> int:
    """fp32 registers a windowed 2D thread holds in its windows: ``2 *
    reach + 1`` quads of every level below the last; a factor plan keeps
    ``4 * reach + 2`` of the levels R reads (0, 2, ..., levels - 2), whose
    odd neighbours need only their ``2 * reach + 1``."""
    r, L = int(plan.reach), int(plan.levels)
    if is_factor(plan):
        return QUAD * (L // 2) * ((4 * r + 2) + (2 * r + 1))
    return QUAD * L * (2 * r + 1)


def _column_entries(dims, frame: int):
    """(nominal column, x width, staged plane (ey, ex) cut to the grid) of
    every ``STRIP_2D`` strip (2D) or ``COLUMNS_3D`` column (3D), widest
    first."""
    hx, nx = _ceil_to(frame, QUAD), _ceil_to(dims[-1], QUAD)
    if len(dims) == 2:
        return [(ex - 2 * hx, ex, (1, min(ex, nx + 2 * hx)))
                for ex in STRIP_2D if ex - 2 * hx >= QUAD]
    return [(ty * tx, tx, (min(ty, dims[1]) + 2 * frame,
                           min(tx, nx) + 2 * hx))
            for ty, tx in COLUMNS_3D]


def columns(plan, dims) -> Tuple[int, ...]:
    """The columns (``KernelConfig.ch`` values) :func:`geometry` names for
    ``plan`` on ``dims``, widest first; some may not fit shared memory."""
    out = []
    for c, _, _ in _column_entries(tuple(int(d) for d in dims),
                                   int(plan.frame)):
        if c not in out:
            out.append(c)
    return tuple(out)


def geometry(plan, dims, sms: int = SM_COUNT, segment=None,
             column=None) -> Geometry:
    """The :class:`Geometry` of ``plan`` (a ``LevelTaps`` or, on a 2D grid,
    a ``FactorTaps``) on ``dims`` for a card of ``sms`` SMs.

    ``segment`` (``KernelConfig.tm``) is the planes of axis 0 one CTA
    walks, and ``column`` (``KernelConfig.ch``) the CTA's output cells
    across the other axes, named before they are cut to the grid: a 2D
    strip's ``ex - 2 * hx`` for an ``ex`` of ``STRIP_2D``, a 3D column's
    ``TY * TX`` for a pair of ``COLUMNS_3D`` (of two pairs with one product,
    the wider ``TX``).  Either defaults to the plan's own ``segment`` /
    ``column``, and ``None`` there to the generator's choice: the first
    column whose rings fit ``SMEM_TARGET`` and the segment that fills the
    ``sms`` SMs in the fewest steps (``_segment``).  A column that names no
    entry or whose rings exceed ``SMEM_LIMIT``, and a segment shorter than
    ``Geometry.warmup`` that does not cover the interior, raise
    ``ValueError``."""
    dims = tuple(int(d) for d in dims)
    ndim = len(dims)
    if ndim not in (2, 3) or plan.ndim != ndim:
        raise ValueError(f"a {plan.ndim}D table on a {ndim}D grid")
    segment = plan.segment if segment is None else segment
    column = plan.column if column is None else column
    H, r, L = int(plan.frame), int(plan.reach), int(plan.levels)
    factor = is_factor(plan)
    hx = _ceil_to(H, QUAD)
    ring = 2 * r + 2
    guard = _ceil_to(r, QUAD)
    nx = _ceil_to(dims[-1], QUAD)

    vec = dims[-1] % QUAD == 0
    # a 2D strip has one quad per thread (see ``threads`` below); a factor
    # plan is always windowed, its R reading the level two below in
    # registers (with fewer CTAs per SM where the windows outgrow
    # WINDOW_REGS: step 3 and 4)
    in_regs = ndim == 2 and window_regs(plan) <= WINDOW_REGS
    window = in_regs or factor
    ahead = AHEAD_2D if window and vec else 0

    def smem(ey, ex):
        return 4 * (2 * guard + (L * ring + (ahead + 1 if ahead else 0))
                    * ey * ex)

    entries = _column_entries(dims, H)
    if column is None:
        shapes = [e[2] for e in entries]
        fits = ([s for s in shapes if smem(*s) <= SMEM_TARGET]
                or [s for s in shapes if smem(*s) <= SMEM_LIMIT])
        if not fits:
            raise ValueError(
                f"frame {H} is too wide for a shared-memory window")
        ey, ex = fits[0]
    else:
        named = [e for e in entries if e[0] == column]
        if not named:
            raise ValueError(
                f"column ch={column} names no "
                f"{'strip' if ndim == 2 else 'column'} of this plan: one of "
                f"{sorted({e[0] for e in entries})}")
        ey, ex = max(named, key=lambda e: e[1])[2]
        if smem(ey, ex) > SMEM_LIMIT:
            raise ValueError(
                f"column ch={column}: its rings take {smem(ey, ex)} bytes of "
                f"shared memory, more than {SMEM_LIMIT}")
    column = (ex - 2 * hx,) if ndim == 2 else (ey - 2 * H, ex - 2 * hx)
    quads = ey * ex // QUAD
    threads = min(_ceil_to(quads, 32),
                  THREADS_3D if ndim == 3 else STRIP_2D[0] // QUAD)
    g = Geometry(dims=dims, frame=H, reach=r, levels=L, tile=(1,) + column,
                 hx=hx, ey=ey, ex=ex, ring=ring, threads=threads,
                 min_blocks=1, vec=vec, ahead=ahead, window=window,
                 factor=factor)
    assert not window or quads <= threads
    min_blocks = min(g.ctas_per_sm,
                     2 if ndim == 3 or (factor and not in_regs) else 4)
    if segment is None:
        # a factor plan's registers, not its shared memory, decide how many
        # of its CTAs an SM holds (at step 1 shared memory would admit six,
        # its 88 registers five): its segments fill the ones the launch
        # bound promises
        slots = int(sms) * (min_blocks if factor else g.ctas_per_sm)
        seg = _segment(g.interior, g.n_columns, g.warmup, slots)
    else:
        seg = _asked_segment(int(segment), g.interior, g.warmup)
    return dataclasses.replace(g, tile=(seg,) + column,
                               min_blocks=min_blocks)


# -- the text ------------------------------------------------------------------

def _row_loads(rid: int, base: str, off: int, dxs, own: str = None):
    """Loads of one tap row: the aligned blocks covering quad cells
    ``[min(dxs), 3 + max(dxs)]`` of ``base[at + off + .]``; with ``own``
    (the expression of the thread's own quad of that row, in registers)
    only the cells beside the quad are loaded.  Returns (lines, {relative
    x: expression})."""
    need = sorted({j + dx for dx in dxs for j in range(QUAD)})
    lines, expr = [], {}
    if own:
        expr = {j: f"{own}." + "xyzw"[j] for j in range(QUAD)}
        need = [j for j in need if j not in expr]
    for blk in sorted({j // QUAD for j in need}):
        inside = [j for j in need if j // QUAD == blk]
        tag = f"{rid}_{'m' if blk < 0 else 'p'}{abs(blk)}"
        if len(inside) == 1:
            j = inside[0]
            lines.append(f"  const float s{tag} = {base}[at + ({off + j})];")
            expr[j] = f"s{tag}"
        else:
            lines.append(f"  const float4 q{tag} = *reinterpret_cast<const "
                         f"float4*>({base} + at + ({off + QUAD * blk}));")
            for j in inside:
                expr[j] = f"q{tag}." + "xyzw"[j - QUAD * blk]
    return lines, expr


def _plane_name(d0: int) -> str:
    return f"b_{'m' if d0 < 0 else 'p'}{abs(d0)}"


def _taps_text(offsets, coeffs, g: Geometry, own_base: int, acc: str = "a",
               window: str = "w", tag: str = ""):
    """``fmaf`` lines of one tap table at the quad ``at``, one per tap and
    output cell into ``acc0..acc3``, in table order; with register windows
    the thread's own quad of axis-0 offset ``d0`` is ``window[d0 +
    own_base]``.  Returns (lines, axis-0 offsets of the planes read from
    shared memory)."""
    rows = []       # taps grouped by everything but dx, in table order
    for off, c in zip(offsets.tolist(), coeffs.tolist()):
        key = tuple(off[:-1])
        if not rows or rows[-1][0] != key:
            rows.append((key, []))
        rows[-1][1].append((off[-1], c, tuple(off)))
    body, planes = [], set()
    for rid, (key, taps) in enumerate(rows):
        off = key[1] * g.ex if len(key) == 2 else 0
        own = f"{window}[{key[0] + own_base}]" if g.window else None
        lines, expr = _row_loads(f"{tag}{rid}", _plane_name(key[0]), off,
                                 [dx for dx, _, _ in taps], own)
        if lines:
            planes.add(key[0])
        body += lines
        for dx, c, full in taps:
            lit = float32_literal(c)
            body.append("  " + " ".join(
                f"{acc}{j} = fmaf({lit}, {expr[j + dx]}, {acc}{j});"
                for j in range(QUAD)) + f"  // {full}")
    return body, planes


def _quad_fn(name: str, comment, windows, planes, body):
    """A ``__device__`` function of the quad ``at`` up to its return:
    ``comment``, the signature, ``a0..a3`` from 0, then ``body``."""
    args = [f"const float4 (&{w})[WINDOW]" for w in windows]
    args += [f"const float* __restrict__ {_plane_name(d)}" for d in planes]
    return comment + [
        f"__device__ __forceinline__ float4 {name}("
        + ", ".join(args + ["int at"]) + ") {",
        "  float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f, a3 = 0.0f;",
    ] + body


def _level_quad(plan, g: Geometry):
    """Text of ``level_quad``: one level at the quad ``at`` — the table in
    sorted order, one ``fmaf`` per tap and output cell.  Returns (lines,
    axis-0 offsets of the planes it reads from shared memory)."""
    body, planes = _taps_text(plan.offsets, plan.coeffs, g, g.reach)
    planes = sorted(planes)
    o = ["// One level at the quad `at` of a plane: the tap table in sorted "
         "order, one fmaf",
         "// per tap and output cell; b_m1, b_p0, ... are the planes at "
         "axis-0 offsets -1, 0, ..."]
    if g.window:
        o.append("// in shared memory, w[k] the thread's own quad at offset "
                 "k - REACH, in registers")
    o = _quad_fn("level_quad", o, ["w"] if g.window else [], planes, body)
    o.append("  return make_float4(a0, a1, a2, a3);")
    o.append("}")
    return o, planes


def _factor_quads(plan, g: Geometry):
    """Text of factor mode's two levels at the quad ``at``: ``level_v1``
    (V1 of the level below) and ``level_v2r`` (V2 of the level below plus
    R of the level two below).  Each table is one ``fmaf`` chain from 0 in
    its sorted order, and a V2 level adds R's chain to V2's with one add:
    the arithmetic of ``ops/kernels.stencil2d_factor_levels_ref`` and of
    the table-driven kernel it replaced.  R's taps lie on the thread's own
    column, so they read the level two below from its register window.
    Returns (lines, {level parity: planes read from shared memory})."""
    r_offsets, r_coeffs = plan.r
    if r_offsets[:, 1].any():
        raise EmitError("factor mode's R must lie on axis 0 (dx = 0)")
    newest = g.window_len - 1
    o = ["// Factor mode's levels at the quad `at`: w[k] is the thread's own "
         "quad of the level",
         "// below in its row k - WINDOW + 1 + REACH relative to the output "
         "row, w2[k] that",
         "// of the level two below in row k - WINDOW + 2 + 2 * REACH; b_m1, "
         "b_p0, ... are the",
         "// level below's rows at axis-0 offsets -1, 0, ... in shared "
         "memory."]
    planes = {}
    body, p1 = _taps_text(*plan.v1, g, newest - g.reach)
    planes[1] = sorted(p1)
    o += _quad_fn("level_v1", ["// odd levels: V1"], ["w"], planes[1], body)
    o += ["  return make_float4(a0, a1, a2, a3);", "}"]
    body, p2 = _taps_text(*plan.v2, g, newest - g.reach)
    rbody, _ = _taps_text(r_offsets, r_coeffs, g, newest - 1 - 2 * g.reach,
                          acc="c", window="w2", tag="r")
    planes[0] = sorted(p2)
    o += _quad_fn("level_v2r", ["// even levels: V2, then R's chain, then "
                                "one add"], ["w", "w2"], planes[0], body)
    o.append("  float c0 = 0.0f, c1 = 0.0f, c2 = 0.0f, c3 = 0.0f;")
    o += rbody
    o += ["  return make_float4(a0 + c0, a1 + c1, a2 + c2, a3 + c3);", "}"]
    return o, planes


def cuda_source(plan, dims, dtype: str, shard: bool, name: str = "plan",
                label: str = "", sms: int = SM_COUNT) -> str:
    """The CUDA C++ text of ``plan``'s kernel on a grid (or ghosted slab)
    of ``dims`` in ``dtype`` state for a card of ``sms`` SMs, in the
    plan's geometry (:func:`geometry`); ``shard`` adds the axis-0 store
    range ``[s_lo, s_hi)`` as kernel arguments."""
    if dtype not in DTYPES:
        raise ValueError(f"dtype {dtype!r}: the kernels take {DTYPES} state")
    g = geometry(plan, dims, sms)
    ndim, H, L, r = g.ndim, g.frame, g.levels, g.reach
    bf16 = dtype == "bfloat16"
    d3 = ndim == 3
    dim_names = ("D", "M", "N") if d3 else ("M", "N")
    A0 = dim_names[0]           # the streamed axis' extent
    o = []
    if g.factor:
        n1, n2, nr = (len(c) for _, c in (plan.v1, plan.v2, plan.r))
        o.append(f"// {name} [{label}]: {L} levels alternating V1 ({n1} "
                 f"taps) and V2 ({n2}) + R ({nr}), frame {H},")
        o.append("// specialised to this plan.")
        kind = f"stencil2d_factor_levels{'_shard' if shard else ''}"
    else:
        o.append(f"// {name} [{label}]: {L} level(s) of {len(plan.coeffs)} "
                 f"taps, reach {r}, frame {H}, specialised to this plan.")
        kind = f"stencil{ndim}d_levels{'_shard' if shard else ''}"
    o.append(f"// {kind}{'_bf16' if bf16 else ''}: streamed along axis 0, "
             f"{QUAD} outputs per thread along x,")
    o.append("// every shape a constant and the taps unrolled: no table is "
             "passed.")
    o.append("#include <cuda_bf16.h>")
    o.append("#include <cuda_runtime.h>")
    if g.ahead:
        o.append("#include <cuda_pipeline.h>")
    o.append("#include <stddef.h>")
    o.append("")
    o.append(f"typedef {'__nv_bfloat16' if bf16 else 'float'} T;"
             "  // the state's storage type")
    o.append("constexpr int " + ", ".join(
        f"{n} = {d}" for n, d in zip(dim_names, g.dims)) + ";")
    o.append(f"constexpr int H = {H}, LEVELS = {L}, REACH = {r};")
    o.append("// output cells of one CTA: a segment of axis 0 and the "
             "column it walks")
    o.append("constexpr int SEG = %d, " % g.tile[0] + ", ".join(
        f"T{a} = {t}" for a, t in zip("YX"[-(ndim - 1):], g.tile[1:])) + ";")
    o.append(f"constexpr int HX = {g.hx};  // x halo in whole quads")
    o.append(f"constexpr int EY = {g.ey}, EX = {g.ex}, QX = EX / 4;"
             "  // a staged plane")
    o.append("constexpr int PLANE = EY * EX, PLANE_QUADS = EY * QX;")
    o.append(f"constexpr int RING = {g.ring};  // planes a level keeps: "
             "2 * REACH + 2")
    o.append(f"constexpr int GUARD = {g.guard};")
    o.append(f"constexpr int THREADS = {g.threads}, MIN_BLOCKS = "
             f"{g.min_blocks};")
    o.append("constexpr int STAGE = (PLANE_QUADS + THREADS - 1) / THREADS;"
             "  // quads a thread stages per plane")
    if g.window:
        o.append("// a thread owns quad threadIdx.x of every row and keeps "
                 "each level's last WINDOW")
        o.append("// rows of it in registers")
        if g.factor:
            o.append("// (4 * REACH + 2: a V2 level reads R's rows of the "
                     "level two below, whose")
            o.append("// newest row is then 2 * REACH + 1 rows past the "
                     "output row)")
            o.append("constexpr int WINDOW = 4 * REACH + 2;")
            o.append("// source rows staged past the window, so that the "
                     "windows R reads shift")
            o.append("// on to the last output row")
            o.append("constexpr int TAIL = 1;")
        else:
            o.append("constexpr int WINDOW = 2 * REACH + 1;")
        o.append("static_assert(STAGE == 1, \"one quad per thread\");")
    if g.ahead:
        o.append(f"constexpr int AHEAD = {g.ahead};  // source planes "
                 "requested ahead of their use (cp.async)")
        o.append("constexpr int STAGING = (AHEAD + 1) * PLANE;  // their "
                 "staging planes, sized for fp32")
    else:
        o.append("constexpr int STAGING = 0;")
    o.append("constexpr size_t SMEM_BYTES =")
    o.append("    (size_t)(2 * GUARD + LEVELS * RING * PLANE + STAGING) * "
             "sizeof(float);")
    o.append(f"static_assert(SMEM_BYTES == {g.smem_bytes}, \"geometry\");")
    o.append("")
    o += _io_text(bf16, g.vec)
    o.append("")
    plane_args = "int g0" + (", int y0" if d3 else "") + ", int x0"
    row_expr = ("((size_t)g0 * M + gy) * N" if d3 else "(size_t)g0 * N")
    if not g.ahead:
        o.append("// Request plane g0 of the source (0 outside the domain) "
                 "into registers.")
        o.append("__device__ __forceinline__ void fetch_plane("
                 f"const T* __restrict__ src, {plane_args},")
        o.append("                                            "
                 "Raw (&st)[STAGE]) {")
        o.append(f"  const bool in0 = g0 >= 0 && g0 < {A0};")
        o.append("#pragma unroll")
        o.append("  for (int k = 0; k < STAGE; ++k) {")
        o.append("    const int i = (int)threadIdx.x + k * THREADS;")
        if d3:
            o.append("    const int row = i / QX, gy = y0 + row;")
            o.append("    const int gx = x0 + 4 * (i - row * QX);")
            o.append("    const bool in = in0 && i < PLANE_QUADS && gy >= 0 && "
                     "gy < M;")
        else:
            o.append("    const int gx = x0 + 4 * i;")
            o.append("    const bool in = in0 && i < PLANE_QUADS;")
        o.append(f"    st[k] = fetch_quad(in ? src + {row_expr} : src, gx, in);")
        o.append("  }")
        o.append("}")
        o.append("")
        o.append("// Stage the requested plane into a ring slot as fp32.")
        o.append("__device__ __forceinline__ void stage_plane("
                 "float* __restrict__ plane,")
        o.append("                                            "
                 "const Raw (&st)[STAGE]) {")
        o.append("#pragma unroll")
        o.append("  for (int k = 0; k < STAGE; ++k) {")
        o.append("    const int i = (int)threadIdx.x + k * THREADS;")
        o.append("    if (i < PLANE_QUADS)")
        o.append("      *reinterpret_cast<float4*>(plane + 4 * i) = "
                 "raw_to_f32(st[k]);")
        o.append("  }")
        o.append("}")
        o.append("")
    if g.ahead:
        o.append("// Request plane g0 of the source (0 outside the domain) "
                 "into a staging plane,")
        o.append("// each thread the quads it will itself stage.")
        o.append("__device__ __forceinline__ void request_plane("
                 f"const T* __restrict__ src, {plane_args},")
        o.append("                                              "
                 "Raw* __restrict__ slot) {")
        o.append(f"  const bool in0 = g0 >= 0 && g0 < {A0};")
        o.append("#pragma unroll")
        o.append("  for (int k = 0; k < STAGE; ++k) {")
        o.append("    const int i = (int)threadIdx.x + k * THREADS;")
        o.append("    if (i >= PLANE_QUADS) continue;")
        if d3:
            o.append("    const int row = i / QX, gy = y0 + row;")
            o.append("    const int gx = x0 + 4 * (i - row * QX);")
            o.append("    const bool in = in0 && gy >= 0 && gy < M && gx >= 0 "
                     "&& gx < N;")
        else:
            o.append("    const int gx = x0 + 4 * i;")
            o.append("    const bool in = in0 && gx >= 0 && gx < N;")
        o.append("    // a quad outside the domain copies nothing and is "
                 "filled with zeros")
        o.append(f"    __pipeline_memcpy_async(slot + i, in ? src + {row_expr}"
                 " + gx : src,")
        o.append("                            sizeof(Raw), in ? 0 : "
                 "sizeof(Raw));")
        o.append("  }")
        o.append("}")
        o.append("")
        o.append("// Stage the thread's own quads of an arrived plane into a "
                 "ring slot as fp32.")
        o.append("__device__ __forceinline__ void stage_arrived("
                 "float* __restrict__ plane,")
        o.append("                                              "
                 "const Raw* __restrict__ slot) {")
        o.append("#pragma unroll")
        o.append("  for (int k = 0; k < STAGE; ++k) {")
        o.append("    const int i = (int)threadIdx.x + k * THREADS;")
        o.append("    if (i < PLANE_QUADS)")
        o.append("      *reinterpret_cast<float4*>(plane + 4 * i) = "
                 "raw_to_f32(slot[i]);")
        o.append("  }")
        o.append("}")
        o.append("")
    if g.factor:
        quad_text, by_parity = _factor_quads(plan, g)

        def level_call(t):
            if t % 2:
                return "level_v1", [f"w[{t - 1}]"], by_parity[1]
            return "level_v2r", [f"w[{t - 1}]", f"w[{t - 2}]"], by_parity[0]
    else:
        quad_text, planes = _level_quad(plan, g)

        def level_call(t):
            return ("level_quad", [f"w[{t - 1}]"] if g.window else [],
                    planes)
    o += quad_text
    o.append("")
    o += _kernel_text(g, shard, level_call)
    o.append("")
    o.append('extern "C" const char* error_string(int err) {')
    o.append("  return cudaGetErrorString((cudaError_t)err);")
    o.append("}")
    o.append("")
    rng = ", int s_lo, int s_hi" if shard else ""
    o.append(f'extern "C" int launch(const void* src, void* dst{rng}, '
             "void* stream) {")
    if shard:
        o.append(f"  if (s_lo < H || s_hi > {A0} - H) "
                 "return (int)cudaErrorInvalidValue;")
        o.append("  if (s_lo >= s_hi) return (int)cudaSuccess;"
                 "  // nothing to store")
    o.append("  cudaError_t err = cudaFuncSetAttribute(")
    o.append("      stencil_kernel, "
             "cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_BYTES);")
    o.append("  if (err != cudaSuccess) return (int)err;")
    o.append("  const dim3 block(THREADS);")
    o.append("  const dim3 grid(" + ", ".join(map(str, g.grid)) + ");"
             "  // columns, then segments")
    o.append("  stencil_kernel<<<grid, block, SMEM_BYTES, "
             "(cudaStream_t)stream>>>(")
    o.append("      (const T*)src, (T*)dst" + (", s_lo, s_hi" if shard else "")
             + ");")
    o.append("  return (int)cudaGetLastError();")
    o.append("}")
    return "\n".join(o)


def _io_text(bf16: bool, vec: bool):
    """Quad access to the state: ``Raw`` is what a thread holds of one
    requested quad until it is staged."""
    o = []
    if bf16:
        o.append("__device__ __forceinline__ float cell_f32(const T* p) "
                 "{ return __bfloat162float(*p); }")
        o.append("// fp32 levels, one rounding to nearest even at the store")
        o.append("__device__ __forceinline__ void store_cell(T* p, float v) "
                 "{ *p = __float2bfloat16_rn(v); }")
    else:
        o.append("__device__ __forceinline__ float cell_f32(const T* p) "
                 "{ return *p; }")
        o.append("__device__ __forceinline__ void store_cell(T* p, float v) "
                 "{ *p = v; }")
    if not vec:
        o.append("// N is no multiple of 4: rows are not 16-byte aligned, "
                 "cells go one by one")
        o.append("typedef float4 Raw;")
        o.append("__device__ __forceinline__ float edge_cell(const T* row, "
                 "int gx, bool in) {")
        o.append("  return (in && gx >= 0 && gx < N) ? cell_f32(row + gx) "
                 ": 0.0f;")
        o.append("}")
        o.append("__device__ __forceinline__ Raw fetch_quad(const T* row, "
                 "int gx, bool in) {")
        o.append("  return make_float4(edge_cell(row, gx, in), "
                 "edge_cell(row, gx + 1, in),")
        o.append("                     edge_cell(row, gx + 2, in), "
                 "edge_cell(row, gx + 3, in));")
        o.append("}")
        o.append("__device__ __forceinline__ float4 raw_to_f32(const Raw& v) "
                 "{ return v; }")
        return o
    o.append("// N is a multiple of 4 and planes start on one: a quad lies "
             "wholly inside the")
    o.append("// domain or wholly outside, and is 16 bytes (8 of bf16) "
             "aligned")
    if bf16:
        o.append("typedef uint2 Raw;  // four bf16, converted when staged")
        o.append("__device__ __forceinline__ Raw fetch_quad(const T* row, "
                 "int gx, bool in) {")
        o.append("  return (in && gx >= 0 && gx < N)")
        o.append("      ? *reinterpret_cast<const uint2*>(row + gx) "
                 ": make_uint2(0u, 0u);")
        o.append("}")
        o.append("__device__ __forceinline__ float4 raw_to_f32(const Raw& v) "
                 "{")
        o.append("  // a bf16 is the high half of its fp32")
        o.append("  return make_float4(__uint_as_float(v.x << 16), "
                 "__uint_as_float(v.x & 0xffff0000u),")
        o.append("                     __uint_as_float(v.y << 16), "
                 "__uint_as_float(v.y & 0xffff0000u));")
        o.append("}")
        o.append("__device__ __forceinline__ void store_quad(T* p, float4 v) "
                 "{")
        o.append("  __align__(8) T h[4] = {__float2bfloat16_rn(v.x), "
                 "__float2bfloat16_rn(v.y),")
        o.append("                         __float2bfloat16_rn(v.z), "
                 "__float2bfloat16_rn(v.w)};")
        o.append("  *reinterpret_cast<uint2*>(p) = "
                 "*reinterpret_cast<const uint2*>(h);")
        o.append("}")
    else:
        o.append("typedef float4 Raw;")
        o.append("__device__ __forceinline__ Raw fetch_quad(const T* row, "
                 "int gx, bool in) {")
        o.append("  return (in && gx >= 0 && gx < N)")
        o.append("      ? *reinterpret_cast<const float4*>(row + gx)")
        o.append("      : make_float4(0.0f, 0.0f, 0.0f, 0.0f);")
        o.append("}")
        o.append("__device__ __forceinline__ float4 raw_to_f32(const Raw& v) "
                 "{ return v; }")
        o.append("__device__ __forceinline__ void store_quad(T* p, float4 v) "
                 "{")
        o.append("  *reinterpret_cast<float4*>(p) = v;")
        o.append("}")
    return o


def _store_lines(g: Geometry, y_first: int, pad: str):
    """The last level's store of the quad ``v`` (local quad ``q``, local
    row ``row``): only cells inside the frozen frame."""
    o = [f"{pad}const int gx = x0 + 4 * q;"]
    if g.ndim == 3:
        o.append(f"{pad}const int gy = y0 + row + {y_first};")
        o.append(f"{pad}if (gy < H || gy >= M - H || gx >= N) continue;")
        o.append(f"{pad}T* const cell = dst + ((size_t)g0 * M + gy) * N + gx;")
    else:
        o.append(f"{pad}if (gx >= N) continue;")
        o.append(f"{pad}T* const cell = dst + (size_t)g0 * N + gx;")
    o.append(f"{pad}// stored only inside [H, N - H): a quad on the frame's "
             "edge goes cell by cell")
    if g.vec:
        o.append(f"{pad}if (gx >= H && gx + 3 < N - H) {{")
        o.append(f"{pad}  store_quad(cell, v);")
        o.append(f"{pad}  continue;")
        o.append(f"{pad}}}")
    for j, c in enumerate("xyzw"):
        o.append(f"{pad}if (gx + {j} >= H && gx + {j} < N - H) "
                 f"store_cell(cell + {j}, v.{c});")
    return o


def _kernel_text(g: Geometry, shard: bool, level_call):
    """The kernel; ``level_call(t)`` is (function, window arguments,
    axis-0 offsets of the planes it reads) of level ``t``."""
    d3 = g.ndim == 3
    H, L, r = g.frame, g.levels, g.reach
    wl = g.window_len
    # rows of the segment's window staged (a factor plan: TAIL more)
    feed_end = "n0 + 2 * H" + (" + TAIL" if g.tail else "")
    A0 = "D" if d3 else "M"
    rng = ", int s_lo, int s_hi" if shard else ""
    lo0, hi0 = ("s_lo", "s_hi") if shard else ("H", f"{A0} - H")
    seg_idx = "blockIdx.z" if d3 else "blockIdx.y"
    o = []
    o.append("__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)")
    o.append("stencil_kernel(const T* __restrict__ src, T* __restrict__ dst"
             f"{rng}) {{")
    o.append("  extern __shared__ float4 smem4[];")
    o.append("  float* const smem = reinterpret_cast<float*>(smem4) + GUARD;")
    o.append(f"  // this CTA's segment [a0, a1) of the store range "
             f"[{lo0}, {hi0}): uniform over the block")
    o.append(f"  const int a0 = {lo0} + (int){seg_idx} * SEG;")
    o.append(f"  const int a1 = a0 + SEG < {hi0} ? a0 + SEG : {hi0};")
    o.append("  if (a0 >= a1) return;")
    o.append("  const int n0 = a1 - a0;")
    o.append("  // global coordinates of the plane's local (0, 0)")
    if d3:
        o.append("  const int y0 = (int)blockIdx.y * TY - H;")
    o.append("  const int x0 = (int)blockIdx.x * TX - HX;")
    coords = ("y0, " if d3 else "") + "x0"
    fetch_args = f"a0 - H + s, {coords}, st"
    if g.ahead:
        o.append("  Raw* const staging = reinterpret_cast<Raw*>(")
        o.append("      smem + GUARD + LEVELS * RING * PLANE);")
        o.append("  // the first AHEAD planes of the window, one copy group "
                 "each")
        o.append("  for (int s = 0; s < AHEAD; ++s) {")
        o.append(f"    if (s < {feed_end})")
        o.append(f"      request_plane(src, a0 - H + s, {coords}, staging + "
                 "s * PLANE_QUADS);")
        o.append("    __pipeline_commit();")
        o.append("  }")
    else:
        o.append("  Raw st[STAGE];")
    if g.window:
        o.append("  const int q = threadIdx.x;  // this thread's quad of "
                 "every row")
        o.append("  // w[t][k]: the thread's quad of level t (0: the source) "
                 "in its last WINDOW rows")
        o.append("  float4 w[LEVELS][WINDOW];")
        o.append("#pragma unroll")
        o.append("  for (int t = 0; t < LEVELS; ++t)")
        o.append("#pragma unroll")
        o.append("    for (int k = 0; k < WINDOW; ++k)")
        o.append("      w[t][k] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);")
    o.append("  // step s stages source plane s of the window [a0 - H, a1 + H)"
             "; level t then")
    o.append("  // computes its plane s - t * (REACH + 1) from planes staged "
             "in earlier steps")
    o.append("  for (int s = 0; s < n0 + 2 * H + LEVELS; ++s) {")
    o.append(f"    const bool feed = s < {feed_end};")
    if g.ahead:
        o.append("    // request plane s + AHEAD now; plane s, requested "
                 "AHEAD steps ago, is staged")
        o.append("    // after the levels")
        o.append(f"    if (s + AHEAD < {feed_end})")
        o.append(f"      request_plane(src, a0 - H + s + AHEAD, {coords},")
        o.append("                    staging + ((s + AHEAD) % (AHEAD + 1)) "
                 "* PLANE_QUADS);")
        o.append("    __pipeline_commit();")
    else:
        o.append("    // request the plane now, stage it after the levels: "
                 "its latency hides")
        o.append(f"    if (feed) fetch_plane(src, {fetch_args});")
    # with register windows the levels run last to first: level t reads
    # level t - 1's window before level t - 1 pushes this step's row
    for t in (range(L, 0, -1) if g.window else range(1, L + 1)):
        y_first, rows, q_first, qw = g.level_region(t)
        nq = rows * qw
        lag = t * (r + 1)
        fn, windows, planes = level_call(t)
        # the levels whose windows a V2 level's R reads run one row past
        # their range (that row is read by no stored cell), so that the
        # window has shifted on to the last output row
        past = g.tail if g.factor and t % 2 == 0 and t < L else 0
        o.append(f"    {{  // level {t} of {L}: rows [{y_first}, "
                 f"{y_first + rows}) x quads [{q_first}, {q_first + qw})")
        o.append(f"      const int p = s - {lag};")
        o.append(f"      if (p >= {t * r} && p < n0 + "
                 f"{2 * H - t * r + past}) {{")
        if planes:
            o.append(f"        const float* const in = smem + {(t - 1)} * "
                     "RING * PLANE;")
        for d0 in planes:
            o.append(f"        const float* const {_plane_name(d0)} = in + "
                     f"((p + {d0 + g.ring}) % RING) * PLANE;")
        if t < L:
            o.append(f"        float* const out = smem + ({t} * RING + "
                     "p % RING) * PLANE;")
        else:
            o.append("        const int g0 = a0 - H + p;  // in [a0, a1)")
        args = [_plane_name(d) for d in planes]
        if g.window:
            # one quad per thread; `do ... while (0)` gives the store's
            # `continue` somewhere to go
            o.append(f"        if (q >= {q_first} && q < {q_first + qw}) "
                     "do {")
            o.append(f"          const float4 v = {fn}("
                     + ", ".join(windows + args + ["4 * q"]) + ");")
            if t < L:
                o.append("          *reinterpret_cast<float4*>(out + 4 * q) "
                         "= v;")
                o += [f"          w[{t}][{k}] = w[{t}][{k + 1}];"
                      for k in range(wl - 1)]
                o.append(f"          w[{t}][{wl - 1}] = v;")
            else:
                o += _store_lines(g, y_first, "          ")
            o.append("        } while (0);")
        else:
            o.append(f"        for (int i = threadIdx.x; i < {nq}; "
                     "i += THREADS) {")
            if d3:
                o.append(f"          const int row = i / {qw}, q = i - row * "
                         f"{qw} + {q_first};")
                o.append(f"          const int at = (row + {y_first}) * EX + "
                         "4 * q;")
            else:
                o.append(f"          const int q = i + {q_first};")
                o.append("          const int at = 4 * q;")
            call = f"{fn}(" + ", ".join(args + ["at"]) + ")"
            if t < L:
                o.append(f"          *reinterpret_cast<float4*>(out + at) = "
                         f"{call};")
            else:
                o.append(f"          const float4 v = {call};")
                o += _store_lines(g, y_first, "          ")
            o.append("        }")
        o.append("      }")
        o.append("    }")
    o.append("    if (feed) {")
    own = "raw_to_f32(st[0])"
    if g.ahead:
        o.append("      // all but the AHEAD newest of this thread's copy "
                 "groups have landed")
        o.append("      __pipeline_wait_prior(AHEAD);")
        o.append("      const Raw* const slot = staging + (s % (AHEAD + 1))"
                 " * PLANE_QUADS;")
        o.append("      stage_arrived(smem + (s % RING) * PLANE, slot);")
        own = "raw_to_f32(slot[q])"
    else:
        o.append("      stage_plane(smem + (s % RING) * PLANE, st);")
    if g.window:
        # a narrow strip has more threads than quads
        o.append("      if (q < PLANE_QUADS) {")
        o += [f"        w[0][{k}] = w[0][{k + 1}];" for k in range(wl - 1)]
        o.append(f"        w[0][{wl - 1}] = {own};")
        o.append("      }")
    o.append("    }")
    o.append("    __syncthreads();")
    o.append("  }")
    o.append("}")
    return o


# -- tile2d_fused: the plain-tile experiment's kernel -------------------------

@dataclass(frozen=True)
class TileGeometry:
    """How ``tile2d_fused``'s text for one table cuts a ``(rows + 2 * tm,
    C)`` padded layout: a CTA walks a strip of ``tile[1]`` output columns
    (``hx`` halo columns, the halo ``h`` rounded up to whole quads, on each
    side, wrapping around ``C``) down a segment of ``tile[0]`` data rows,
    through a ring of ``ring`` source rows: ``2 * h + 1`` in use, one being
    read by slower threads, and ``AHEAD_2D`` requested ahead by
    ``cp.async``.  ``tm`` places the data rows; nothing else depends on
    it."""

    rows: int
    cols: int
    tm: int
    h: int
    hx: int
    ex: int
    tile: Tuple[int, int]
    ring: int
    threads: int
    min_blocks: int
    vec: bool

    @property
    def smem_bytes(self) -> int:
        return 4 * self.ring * self.ex

    @property
    def ctas_per_sm(self) -> int:
        return max(1, min(SMEM_LIMIT // (self.smem_bytes + SMEM_RESERVED),
                          2048 // self.threads, 8))

    @property
    def n_segments(self) -> int:
        return -(-self.rows // self.tile[0])

    @property
    def grid(self) -> Tuple[int, int]:
        """CTAs: strips, then segments."""
        return (-(-self.cols // self.tile[1]), self.n_segments)

    def read_cells(self) -> int:
        """Source cells requested per application: every strip's segments
        with ``2 * h`` rows of halo each."""
        return self.grid[0] * (self.rows + 2 * self.h * self.n_segments) \
            * self.ex


def tile2d_geometry(taps, rows: int, cols: int, tm: int,
                    sms: int = SM_COUNT) -> TileGeometry:
    """The :class:`TileGeometry` of ``tile2d_fused`` for ``taps`` (an
    ``ops/kernels.Tile2dTaps``) on ``rows`` data rows of ``cols`` columns
    padded by ``tm`` rows, its segments filling ``sms`` SMs."""
    h = int(taps.halo)
    hx = _ceil_to(h, QUAD)
    ring = 2 * h + 2 + AHEAD_2D
    widths = [min(ex, _ceil_to(cols, QUAD) + 2 * hx) for ex in STRIP_2D
              if ex - 2 * hx >= QUAD]
    fits = [ex for ex in widths if 4 * ring * ex <= SMEM_LIMIT]
    if not fits:
        raise ValueError(f"halo {h} is too wide for a shared-memory ring")
    ex = fits[0]
    threads = _ceil_to(ex // QUAD, 32)
    g = TileGeometry(rows=rows, cols=cols, tm=tm, h=h, hx=hx, ex=ex,
                     tile=(1, ex - 2 * hx), ring=ring, threads=threads,
                     min_blocks=1, vec=cols % QUAD == 0)
    seg = _segment(rows, g.grid[0], 2 * h, int(sms) * g.ctas_per_sm)
    return dataclasses.replace(g, tile=(seg, ex - 2 * hx),
                               min_blocks=min(g.ctas_per_sm, 4))


def _tile_quad(taps):
    """Text of ``tile_quad``: the fused table at the output quad ``at`` in
    the TPU kernel's order (``tuning/exp_tile2d.py:78-89``): per column
    shift ``dj`` a partial sum over its rows ``di`` — the first term a
    multiply, the rest ``fmaf`` in ascending ``di`` — and the shifts' sums
    added in ascending ``dj``.  Rows run outside and shifts inside, so each
    source row's aligned blocks are loaded once for all shifts and every
    shift's sum keeps its ``di`` order.  ``__fmul_rn`` keeps a lone product
    from being contracted into the add that follows it."""
    groups = [(int(dj), [(int(di), c) for di, c in rows])
              for dj, rows in taps.groups]
    dis = sorted({di for _, rows in groups for di, _ in rows})
    o = ["// The fused table at the output quad `at` of a row: r_m2, r_p0, "
         "... are the source",
         "// rows at offsets -2, 0, ... from it in the ring; gK_j is column "
         "shift K's partial",
         "// sum of output j (shifts in ascending dj, rows in ascending di)."]
    args = [f"const float* __restrict__ {_row_name(di)}" for di in dis]
    o.append("__device__ __forceinline__ float4 tile_quad("
             + ", ".join(args + ["int at"]) + ") {")
    o.append("  float " + ", ".join(f"g{k}_{j}" for k in range(len(groups))
                                    for j in range(QUAD)) + ";")
    started = set()
    for rid, di in enumerate(dis):
        here = [(k, dj, c) for k, (dj, rows) in enumerate(groups)
                for d, c in rows if d == di]
        lines, expr = _row_loads(rid, _row_name(di), 0,
                                 [dj for _, dj, _ in here])
        o += lines
        for k, dj, c in here:
            lit = float32_literal(c)
            if k in started:
                terms = [f"g{k}_{j} = fmaf({lit}, {expr[j + dj]}, g{k}_{j});"
                         for j in range(QUAD)]
            else:
                started.add(k)
                terms = [f"g{k}_{j} = __fmul_rn({lit}, {expr[j + dj]});"
                         for j in range(QUAD)]
            o.append("  " + " ".join(terms) + f"  // ({di}, {dj})")
    o.append("  return make_float4(" + ", ".join(
        " + ".join(f"g{k}_{j}" for k in range(len(groups)))
        for j in range(QUAD)) + ");")
    o.append("}")
    return o, dis


def _row_name(di: int) -> str:
    return f"r_{'m' if di < 0 else 'p'}{abs(di)}"


def tile2d_source(taps, rows: int, cols: int, tm: int,
                  name: str = "tile2d", sms: int = SM_COUNT) -> str:
    """The CUDA C++ text of ``tile2d_fused`` for one table (``taps``, an
    ``ops/kernels.Tile2dTaps``) on a ``(rows + 2 * tm, cols)`` fp32 padded
    layout: data rows ``[tm, tm + rows)`` written, every column, columns
    wrapping around ``cols``; pad rows read as the layout holds them and
    never written; ``sms`` is the card's SM count."""
    g = tile2d_geometry(taps, rows, cols, tm, sms)
    quad_text, dis = _tile_quad(taps)
    o = [f"// {name}: tile2d_fused for one table of {taps.ntaps} taps in "
         f"{len(taps.groups)} column shifts, halo {g.h},",
         "// specialised to it: the TPU kernel tuning/exp_tile2d.py:78-89 "
         "(one level of the",
         "// step-fused operator on a padded layout, columns wrapping) "
         "streamed down the rows of",
         "// a column strip, 4 outputs per thread along x, every shape a "
         "constant.",
         "#include <cuda_runtime.h>",
         "#include <cuda_pipeline.h>",
         "#include <stddef.h>",
         "",
         f"constexpr int R = {rows}, C = {cols}, TM = {tm};"
         "  // data rows [TM, TM + R) of R + 2 * TM",
         f"constexpr int H = {g.h};  // the halo: every |di| and |dj|",
         "// output cells of one CTA: a segment of data rows and the strip "
         "it walks",
         f"constexpr int SEG = {g.tile[0]}, TX = {g.tile[1]};",
         f"constexpr int HX = {g.hx};  // x halo in whole quads",
         f"constexpr int EX = {g.ex}, QX = EX / 4;  // a staged row",
         f"constexpr int AHEAD = {AHEAD_2D};  // rows requested ahead of "
         "their use (cp.async)",
         "// ring rows: 2 * H + 1 in use, one still read by slower threads, "
         "AHEAD arriving",
         "constexpr int ROWS = 2 * H + 2 + AHEAD;",
         f"constexpr int THREADS = {g.threads}, MIN_BLOCKS = {g.min_blocks};",
         "constexpr size_t SMEM_BYTES = (size_t)ROWS * EX * sizeof(float);",
         f"static_assert(SMEM_BYTES == {g.smem_bytes}, \"geometry\");",
         "",
         "// Request buffer row g of the strip whose local column 0 is x0 "
         "into a ring slot,",
         "// each thread one quad; columns wrap around C as the TPU "
         "kernel's lane roll does."]
    o.append("__device__ __forceinline__ void request_row(const float* "
             "__restrict__ src, int g, int x0,")
    o.append("                                            float* __restrict__"
             " slot) {")
    o.append("  const int i = threadIdx.x;")
    o.append("  if (i >= QX) return;")
    o.append("  const float* const row = src + (size_t)g * C;")
    if g.vec:
        o.append("  // C is a multiple of 4 and so is x0: a quad wraps "
                 "whole, 16 bytes aligned")
        o.append("  const int gx = ((x0 + 4 * i) % C + C) % C;")
        o.append("  __pipeline_memcpy_async(slot + 4 * i, row + gx, 16);")
    else:
        o.append("  // C is no multiple of 4: each cell wraps on its own")
        o.append("#pragma unroll")
        o.append("  for (int j = 0; j < 4; ++j) {")
        o.append("    const int gx = ((x0 + 4 * i + j) % C + C) % C;")
        o.append("    __pipeline_memcpy_async(slot + 4 * i + j, row + gx, 4);")
        o.append("  }")
    o.append("}")
    o.append("")
    o += quad_text
    o.append("")
    o.append("__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)")
    o.append("tile2d_kernel(const float* __restrict__ src, float* "
             "__restrict__ dst) {")
    o.append("  extern __shared__ float4 smem4[];")
    o.append("  float* const ring = reinterpret_cast<float*>(smem4);")
    o.append("  // this CTA's data rows [y0, y1); window row s is buffer "
             "row g0 + s")
    o.append("  const int y0 = (int)blockIdx.y * SEG;")
    o.append("  const int y1 = y0 + SEG < R ? y0 + SEG : R;")
    o.append("  const int n = y1 - y0 + 2 * H;")
    o.append("  const int g0 = TM + y0 - H;  // >= 0: H <= TM")
    o.append("  const int x0 = (int)blockIdx.x * TX - HX;  // unwrapped "
             "column of local 0")
    o.append("  const int q = threadIdx.x;  // this thread's quad of "
             "every row")
    o.append("  for (int s = 0; s < AHEAD; ++s) {")
    o.append("    if (s < n) request_row(src, g0 + s, x0, ring + s * EX);")
    o.append("    __pipeline_commit();")
    o.append("  }")
    o.append("  for (int s = 0; s < n; ++s) {")
    o.append("    if (s + AHEAD < n)")
    o.append("      request_row(src, g0 + s + AHEAD, x0, ring + ((s + AHEAD)"
             " % ROWS) * EX);")
    o.append("    __pipeline_commit();")
    o.append("    // all but the AHEAD newest copy groups have landed: row s "
             "is in, from every thread")
    o.append("    __pipeline_wait_prior(AHEAD);")
    o.append("    __syncthreads();")
    o.append("    if (s < 2 * H || q < HX / 4 || q >= (HX + TX) / 4) "
             "continue;")
    o.append("    const int c = s - H;  // the output's window row")
    for di in dis:
        o.append(f"    const float* const {_row_name(di)} = ring + "
                 f"((c + ({di})) % ROWS) * EX;")
    o.append("    const float4 v = tile_quad(" + ", ".join(
        [_row_name(di) for di in dis] + ["4 * q"]) + ");")
    o.append("    const int gx = x0 + 4 * q;")
    o.append("    float* const cell = dst + (size_t)(g0 + c) * C + gx;")
    if g.vec:
        o.append("    if (gx < C) *reinterpret_cast<float4*>(cell) = v;")
    else:
        for j, f in enumerate("xyzw"):
            o.append(f"    if (gx + {j} < C) cell[{j}] = v.{f};")
    o.append("  }")
    o.append("}")
    o.append("")
    o.append('extern "C" const char* error_string(int err) {')
    o.append("  return cudaGetErrorString((cudaError_t)err);")
    o.append("}")
    o.append("")
    o.append('extern "C" int launch(const void* src, void* dst, '
             "void* stream) {")
    o.append("  cudaError_t err = cudaFuncSetAttribute(")
    o.append("      tile2d_kernel, "
             "cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_BYTES);")
    o.append("  if (err != cudaSuccess) return (int)err;")
    o.append("  const dim3 block(THREADS);")
    o.append("  const dim3 grid(" + ", ".join(map(str, g.grid)) + ");"
             "  // strips, then segments")
    o.append("  tile2d_kernel<<<grid, block, SMEM_BYTES, "
             "(cudaStream_t)stream>>>(")
    o.append("      (const float*)src, (float*)dst);")
    o.append("  return (int)cudaGetLastError();")
    o.append("}")
    return "\n".join(o)


def source_hash(text: str) -> str:
    """What names a plan's build: the text and the compiler's flags."""
    return hashlib.sha256(
        (text + " ".join(NVCC_FLAGS)).encode()).hexdigest()[:16]
