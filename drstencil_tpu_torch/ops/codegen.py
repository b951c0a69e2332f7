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

Design (:func:`geometry` makes every choice once, in a :class:`Geometry`):

- *Streamed along axis 0.*  A CTA owns a column of the grid — ``TY x TX``
  cells of (y, x) in 3D, a strip of ``TX`` columns in 2D — and a segment
  of ``SEG`` planes (rows in 2D) of axis 0, and walks the planes in a
  loop; the TPU kernel's sequential grid becomes that loop.  Level ``t``
  lags level ``t - 1`` by ``reach + 1`` planes and keeps only a ring of
  planes in shared memory (``2 * reach + 2``; fewer in 3D with register
  windows, below), so the halo is recomputed in y and x only; along axis 0
  a segment pays ``2 * H`` warm-up planes.  One ring slot more than the
  planes read lets all levels of a step run between two barriers: one
  ``__syncthreads`` per plane, not per level.
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
- *Kinds: rings, partial sums and register windows.*  A ring plan's
  threads share out the quads of each level's region.  A windowed strip
  (2D, where ``levels * (2 * reach + 1)`` quads fit ``WINDOW_REGS``
  registers, and every factor plan) gives every thread one quad column for
  all rows and levels, and runs the levels last to first within a step, so
  that level ``t`` reads what level ``t - 1`` computed a step earlier
  before that moves on.  A factor plan's thread carries its own cells'
  last rows of every level in registers and reads only the cells beside
  its quad from the rings.  Every other windowed strip accumulates
  *partial sums*: a thread keeps, for every level, the sums of the ``2 *
  reach + 1`` output rows that an arriving row of the level below feeds;
  when a row arrives it reads the row's cells beside its quad once (its
  own quad it holds in registers) and adds tap row ``dy`` of the table to
  the sum of output row ``j - dy``, whose sum is then whole at ``dy =
  reach`` (``_partial_row``, ``_partial_level``).  Rows arrive in
  increasing order, so each cell still sums the table in its sorted order.
  The steps go ``2 * reach + 1`` at a time, unrolled, so that a sum's
  register and a ring row's slot are named by the step's place among them
  (the ring keeps ``2 * reach + 1`` rows: a row is read a step after it is
  written): a 5 x 5 box's level costs two 8-byte shared loads per four
  cells, where gathering its output rows cost ten 16-byte ones.

  A windowed 3D thread owns one quad of the staged plane, the same on
  every plane and at every level (where a level's region is smaller, the
  threads outside it skip),
  and keeps its window of the source and of every level but the last.  The
  taps on its own row read the window; the cells beside its quad come from
  the neighbouring lanes' windows by warp shuffles (from shared memory at
  a warp's two ends); only the rows above and below are shared loads: a
  7-point star's level costs two ``float4`` loads per four cells.  Each
  level then writes to its ring not its newest plane but the one the level
  above reads newest a step later, so a ring keeps only the planes at the
  axis-0 offsets of the taps that leave the thread's quad column, and the
  one being written: two planes for a star table, whose column then widens
  (3d7pt_star ``fu4``: 32 x 64 where the rings took 16 x 64).  A 3D plan is
  windowed where that frees ring planes (a star, not a box or a cross,
  whose taps off the column span the whole reach: there the windows would
  cost registers and free nothing) and its windows, ``4 * levels *
  window_len`` registers, fit ``WINDOW_REGS`` (``_window_3d``); deep or
  wide plans (2d25pt_box: 120 registers; 3d13pt_star at step 5) keep to
  the rings.
- *Feeds.*  Planes start on a multiple of four columns, so the source is
  read and the result written as 16-byte quads (8 bytes of bf16) with the
  domain's edge decided per quad; a grid whose width is not a multiple of
  four falls back to cell-wise access.  Source planes arrive by one of
  three feeds (:class:`Feed`), chosen in :func:`geometry`:

  - :class:`TmaFeed`, for a windowed 3D plan whose rows are whole 16-byte
    pieces in both types (``_feed_3d``; one CTA an SM, so no other CTA
    hides a fetch): one thread asks the copy engine for each plane as one
    box of a 3D tensor map (zeros outside the domain) up to ``AHEAD_3D``
    steps ahead, into slots behind mbarriers; each thread reads its quad.
    A windowed 2D plan not in factor mode takes it too where its staged
    row, the row's start and the grid's rows are whole 16-byte pieces in
    both types and the shared memory holds four CTAs an SM (``_feed_2d``):
    one thread asks for each row as one box of a 2D tensor map of 8-byte
    elements seven rows ahead, in place of every thread's ``cp.async``
    request (its address, bounds tests and zero fill, the commits and
    waits, a slot by a modulo by 9), into eight slots, a row's slot a mask
    of its index; the threads stage the row as the ``cp.async`` feed's do,
    into the ring slot that the partial-sum text's unrolled step names;
  - :class:`CpAsyncFeed`, for every other windowed strip on whole quads
    (factor mode's, whose steps are not unrolled; a halo or a grid width
    of 4 cells modulo 8; three CTAs an SM or fewer): each
    thread copies its quads ``AHEAD_2D`` rows ahead by ``cp.async`` into a
    staging ring in the state's type (a strip's row is 2 KB, and tens of KB
    must be in flight per SM to keep device memory busy);
  - :class:`RegisterFeed`, for every other plan: each thread fetches its
    quads of the next plane into registers before the levels and stages
    them after (a plane is 8 KB or more; the rings leave no room for more).

  The depth is not a knob: ``KernelConfig.prefetch`` changes nothing.
- *One skeleton.*  ``_kernel_text`` writes the ``__global__`` kernel of
  every plan, branching on the plan's kind; each feed writes every piece
  of the text and of the shared memory that depends on it, which the
  skeleton and :func:`cuda_source` put in their places.  Nothing outside
  :func:`geometry` and the feeds branches on the feed.  :func:`geometry`
  decides the column (the first whose shared memory fits
  ``SMEM_TARGET``), the windows (``window_regs``, ``_window_3d``), the
  feed, the threads, the launch bound (``_ctas_by_smem``,
  ``_ctas_by_registers``) and the segment (``_segment``).
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
import string
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
# a thread keeps its own cells' window of every level in registers where
# that takes at most this many of them
WINDOW_REGS = 96
# 3D with register windows: threads of a CTA at most (one quad each), and
# the registers a thread holds beside its windows: a CTA's must fit the
# 64K register file, and how many do decides the CTAs an SM holds
THREADS_3D_WINDOW = 1024
REGS_BESIDE_WINDOWS = 40
REGISTER_FILE = 65536
# 2D with register windows: rows requested ahead of their use by cp.async
# (by TMA one fewer, in a power of two of slots): a strip's row is 2 KB, and
# an SM needs tens of KB in flight to keep device memory busy
AHEAD_2D = 8
# 3D with register windows: at most this many source planes requested ahead
# of their use by TMA, in AHEAD_3D + 1 slots (fewer where shared memory holds
# fewer; always a power of two), and the widest box the copy engine takes
# along an axis
AHEAD_3D = 3
TMA_BOX = 256
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


def _ctas_by_smem(smem_bytes: int, threads: int) -> int:
    """CTAs an SM holds by shared memory and threads, at most 8."""
    return max(1, min(SMEM_LIMIT // (smem_bytes + SMEM_RESERVED),
                      2048 // threads, 8))


def _ctas_by_registers(threads: int, regs: int) -> int:
    """CTAs an SM holds by threads and the register estimate of a thread
    with ``regs`` registers in windows, at most 8."""
    return max(1, min(REGISTER_FILE // (threads * (
        regs + REGS_BESIDE_WINDOWS)), 2048 // threads, 8))


# -- the plane feeds (the design note's *Feeds*) -----------------------------

def _stage_fn(comment: str, name: str, arg: str, value: str):
    """A helper that stages a thread's quads of a plane into the ring."""
    head = f"__device__ __forceinline__ void {name}("
    return [comment, head + "float* __restrict__ plane,",
            " " * len(head) + arg + ") {",
            "#pragma unroll",
            "  for (int k = 0; k < STAGE; ++k) {",
            "    const int i = (int)threadIdx.x + k * THREADS;",
            "    if (i < PLANE_QUADS)",
            "      *reinterpret_cast<float4*>(plane + 4 * i) = raw_to_f32("
            f"{value});",
            "  }", "}", ""]


def _stage_arrived():
    """The helper that stages a thread's own quads of a plane landed in a
    staging slot (:class:`CpAsyncFeed`, a 2D :class:`TmaFeed`)."""
    return _stage_fn("// Stage the thread's own quads of an arrived plane "
                     "into a ring slot as fp32.", "stage_arrived",
                     "const Raw* __restrict__ slot", "slot[i]")


@dataclass(frozen=True)
class Feed:
    """How a step's source plane reaches the CTA (the design note's
    *Feeds*), ``ahead`` planes ahead of its use into ``ahead + 1`` staging
    planes or slots.  Its pieces: ``includes``, ``constants`` (whose
    ``SMEM_BYTES`` is ``smem_bytes``), ``helpers``; in the kernel,
    ``source``, ``align``, the ``prologue`` around the lines that name the
    thread's quads (``mine``), ``request``, then ``stage`` (ring and strip
    plans) or ``own`` (the thread's quad), ``end_step``; on the host,
    ``host`` and ``launch``.  ``end`` is the window's staged extent."""

    ahead: int = 0

    includes = ("cuda_bf16.h", "cuda_runtime.h", "stddef.h")
    source = "const T* __restrict__ src"
    align = ""
    host = ()
    launch = ()
    launch_source = "(const T*)src"

    @property
    def staging(self) -> int:
        """fp32 planes of shared memory past the rings."""
        return self.ahead + 1 if self.ahead else 0

    def smem_bytes(self, rings: int, plane: int) -> int:
        """A CTA's shared memory: ``rings`` floats (the levels' rings with
        their guards) and the feed's for ``plane``-cell planes."""
        return 4 * (rings + self.staging * plane)

    def constants(self, g, bf16: bool):
        return ["constexpr size_t SMEM_BYTES =",
                "    (size_t)(2 * GUARD + LEVELS * RING * PLANE + STAGING) * "
                "sizeof(float);"]

    def end_step(self, end: str):
        return []


@dataclass(frozen=True)
class RegisterFeed(Feed):
    """Source planes fetched into registers a step ahead (*Feeds*)."""

    own = "raw_to_f32(st[0])"
    stage = ("      stage_plane(smem + (s % RING) * PLANE, st);",)

    def constants(self, g, bf16: bool):
        return ["constexpr int STAGING = 0;"] + super().constants(g, bf16)

    def helpers(self, g, bf16: bool):
        d3 = g.ndim == 3
        row = "((size_t)g0 * M + gy) * N" if d3 else "(size_t)g0 * N"
        o = ["// Request plane g0 of the source (0 outside the domain) into "
             "registers.",
             "__device__ __forceinline__ void fetch_plane(const T* "
             f"__restrict__ src, int g0, {'int y0, ' if d3 else ''}int x0,",
             "                                            "
             "Raw (&st)[STAGE]) {",
             f"  const bool in0 = g0 >= 0 && g0 < {'D' if d3 else 'M'};",
             "#pragma unroll",
             "  for (int k = 0; k < STAGE; ++k) {",
             "    const int i = (int)threadIdx.x + k * THREADS;",
             *(["    const int row = i / QX, gy = y0 + row;",
                "    const int gx = x0 + 4 * (i - row * QX);"] if d3 else
               ["    const int gx = x0 + 4 * i;"]),
             "    const bool in = in0 && i < PLANE_QUADS"
             + (" && gy >= 0 && gy < M;" if d3 else ";"),
             f"    st[k] = fetch_quad(in ? src + {row} : src, gx, in);",
             "  }", "}", ""]
        if not g.window3d:      # a windowed 3D thread stages its own quad
            o += _stage_fn("// Stage the requested plane into a ring slot "
                           "as fp32.", "stage_plane",
                           "const Raw (&st)[STAGE]", "st[k]")
        return o

    def prologue(self, g, end: str, bf16: bool, mine):
        return ["  Raw st[STAGE];"] + mine

    def request(self, g, end: str, bf16: bool):
        return ["    // request the plane now, stage it after the levels: its "
                "latency hides",
                "    if (feed) fetch_plane(src, a0 - H + s, "
                f"{'y0, ' if g.ndim == 3 else ''}x0, st);"]


REGISTERS = RegisterFeed()


@dataclass(frozen=True)
class CpAsyncFeed(Feed):
    """A strip's source rows copied ``ahead`` steps ahead by ``cp.async``,
    one copy group a row, each thread its own quads (*Feeds*)."""

    includes = ("cuda_bf16.h", "cuda_runtime.h", "cuda_pipeline.h",
                "stddef.h")
    own = "raw_to_f32(slot[q])"
    stage = ("      // all but the AHEAD newest of this thread's copy groups "
             "have landed",
             "      __pipeline_wait_prior(AHEAD);",
             "      const Raw* const slot = staging + (s % (AHEAD + 1)) * "
             "PLANE_QUADS;",
             "      stage_arrived(smem + (s % RING) * PLANE, slot);")

    def constants(self, g, bf16: bool):
        return [f"constexpr int AHEAD = {self.ahead};  // source planes "
                "requested ahead of their use (cp.async)",
                "constexpr int STAGING = (AHEAD + 1) * PLANE;  // their "
                "staging planes, sized for fp32"] + super().constants(g, bf16)

    def helpers(self, g, bf16: bool):
        return ["// Request plane g0 of the source (0 outside the domain) "
                "into a staging plane,",
                "// each thread the quads it will itself stage.",
                "__device__ __forceinline__ void request_plane(const T* "
                "__restrict__ src, int g0, int x0,",
                "                                              "
                "Raw* __restrict__ slot) {",
                "  const bool in0 = g0 >= 0 && g0 < M;",
                "#pragma unroll",
                "  for (int k = 0; k < STAGE; ++k) {",
                "    const int i = (int)threadIdx.x + k * THREADS;",
                "    if (i >= PLANE_QUADS) continue;",
                "    const int gx = x0 + 4 * i;",
                "    const bool in = in0 && gx >= 0 && gx < N;",
                "    // a quad outside the domain copies nothing and is "
                "filled with zeros",
                "    __pipeline_memcpy_async(slot + i, in ? src + (size_t)g0 "
                "* N + gx : src,",
                "                            sizeof(Raw), in ? 0 : "
                "sizeof(Raw));",
                "  }", "}", ""] + _stage_arrived()

    def prologue(self, g, end: str, bf16: bool, mine):
        return ["  Raw* const staging = reinterpret_cast<Raw*>(",
                "      smem + GUARD + LEVELS * RING * PLANE);",
                "  // the first AHEAD planes of the window, one copy group "
                "each",
                "  for (int s = 0; s < AHEAD; ++s) {",
                f"    if (s < {end})",
                "      request_plane(src, a0 - H + s, x0, staging + s * "
                "PLANE_QUADS);",
                "    __pipeline_commit();",
                "  }"] + mine

    def request(self, g, end: str, bf16: bool):
        return ["    // request plane s + AHEAD now; plane s, requested AHEAD "
                "steps ago, is staged",
                "    // after the levels",
                f"    if (s + AHEAD < {end})",
                "      request_plane(src, a0 - H + s + AHEAD, x0,",
                "                    staging + ((s + AHEAD) % (AHEAD + 1)) * "
                "PLANE_QUADS);",
                "    __pipeline_commit();"]


# The TMA feed's device helpers and the host's encoder of a tensor map of the
# source, between the markers that the tests' g++ emulation replaces with its
# own (tests/cuda_emulation/bulk_copy.h); then request_plane, which asks for
# one plane (row) of a segment's window.  A 3D map's cells are the state's; a
# 2D map's are 8-byte elements, so that a strip's row (up to 512 fp32 cells,
# where a box takes at most TMA_BOX of its cells a row) is one box.
_TMA_TEXT = string.Template(r"""// ---- TMA bulk copy and mbarrier (PTX) ----------------------------------------
#include <cuda.h>  // CUtensorMap; the CUDA driver API is reached through the runtime
// Describe the $shape array at `base` of `elem`-byte cells ($cells_are to the copy engine, in boxes of $box cells (x first),
// unswizzled; a cell outside the array reads 0.  The encoder is the CUDA driver API's,
// found through the runtime, so nothing links against libcuda.
typedef CUresult (*encode_fn)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);
static int tma_encode_${rank}d(CUtensorMap* map, const void* base, int elem,
                         const unsigned long long dims[$rank], const unsigned box[$rank]) {
  static encode_fn encode = nullptr;
  if (!encode) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &fn, 12000, cudaEnableDefault, &found);
    if (err != cudaSuccess) return (int)err;
    if (found != cudaDriverEntryPointSuccess || !fn)
      return (int)cudaErrorNotSupported;
    encode = (encode_fn)fn;
  }
  const cuuint64_t size[$rank] = {$size};
  const cuuint64_t strides[$strides_n] = {$strides};  // bytes
  const cuuint32_t cells[$rank] = {$cells};
  const cuuint32_t steps[$rank] = {$steps};
  const CUresult r = encode(
      map, $data_type, $rank,
      const_cast<void*>(base), size, strides, cells, steps, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// Arm the barrier for one arrival a phase, and show it to the copy engine.
__device__ __forceinline__ void tma_bar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" :: "r"(smem_addr(bar)) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// The one arrival of a phase, which expects `bytes` of copies to complete it.
__device__ __forceinline__ void tma_bar_expect(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

// Copy the box of `map` whose first cell is ($coords) into `dst` (128-byte aligned),
// rows packed; its bytes are counted on `bar`.
__device__ __forceinline__ void tma_copy_${rank}d(void* dst, const CUtensorMap* map, int x, int y,
                                            ${z}uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.${rank}d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {$operands}], [%$bar_operand];"
      :: "r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(map)), $coord_args
         "r"(smem_addr(bar)) : "memory");
}

// Wait until the phase of parity `parity` has completed.
__device__ __forceinline__ void tma_bar_wait(uint64_t* bar, unsigned parity) {
  const unsigned addr = smem_addr(bar);
  unsigned done;
  do {
    asm volatile(
        "{ .reg .pred p; mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;"
        " selp.u32 %0, 1, 0, p; }"
        : "=r"(done) : "r"(addr), "r"(parity) : "memory");
  } while (!done);
}
// ---- end of PTX --------------------------------------------------------------

$request""")

_TMA_RANK = {
    3: dict(rank=3, shape="(dims[2], dims[1], dims[0])",
            box="box[0] x box[1] x box[2]", cells_are="2: bf16,\n// 4: fp32)",
            data_type="elem == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : "
                      "CU_TENSOR_MAP_DATA_TYPE_FLOAT32",
            size="dims[0], dims[1], dims[2]", strides_n=2,
            strides="dims[0] * elem, dims[0] * dims[1] * elem",
            cells="box[0], box[1], box[2]", steps="1, 1, 1",
            coords="x, y, z", z="int z, ", operands="%2, %3, %4",
            bar_operand=5, coord_args='"r"(x), "r"(y), "r"(z),',
            request=r"""// Ask the copy engine for plane k of the window, plane g0 + k of the source (0 outside
// the domain), into slot k % SLOTS: one box, its bytes counted on that slot's barrier.
__device__ __forceinline__ void request_plane(const CUtensorMap* map, float* slots,
                                              uint64_t* full, int k, int g0, int y0, int x0) {
  uint64_t* const bar = full + k % SLOTS;
  tma_bar_expect(bar, BOX_BYTES);
  tma_copy_3d(slots + k % SLOTS * SLOT, map, x0, y0, g0 + k, bar);
}"""),
    2: dict(rank=2, shape="(dims[1], dims[0])", box="box[0] x box[1]",
            cells_are="8: two fp32 or four\n// bf16 cells of a row)",
            data_type="CU_TENSOR_MAP_DATA_TYPE_INT64",
            size="dims[0], dims[1]", strides_n=1, strides="dims[0] * elem",
            cells="box[0], box[1]", steps="1, 1", coords="x, y", z="",
            operands="%2, %3", bar_operand=4, coord_args='"r"(x), "r"(y),',
            request=r"""// Ask the copy engine for row k of the window, row g0 + k of the source (0 outside the
// domain), into slot k & (SLOTS - 1): one box of BOX 8-byte elements, its bytes counted
// on that slot's barrier.
__device__ __forceinline__ void request_plane(const CUtensorMap* map, float* slots,
                                              uint64_t* full, int k, int g0, int x0) {
  uint64_t* const bar = full + (k & (SLOTS - 1));
  tma_bar_expect(bar, ROW_BYTES);
  tma_copy_2d(slots + (k & (SLOTS - 1)) * SLOT, map, x0 * (int)sizeof(T) / 8, g0 + k, bar);
}"""),
}


# The host's tensor maps of the source (a map holds its buffer's address);
# maps_encoded counts the maps encoded.
_MAP_CACHE_TEXT = string.Template(r"""// The source's tensor map, encoded once a buffer and kept (a ping-pong pair needs two):
// at most MAPS_KEPT, the oldest replaced first.
constexpr int MAPS_KEPT = 16;
static const void* g_map_src[MAPS_KEPT];
static CUtensorMap g_maps[MAPS_KEPT];
static long long g_maps_encoded = 0;
static std::mutex g_maps_mutex;
static int source_map(const void* src, CUtensorMap* map) {
  std::lock_guard<std::mutex> lock(g_maps_mutex);
  for (int k = 0; k < MAPS_KEPT; ++k)
    if (g_map_src[k] == src) {
      *map = g_maps[k];
      return 0;
    }
  const int k = (int)(g_maps_encoded % MAPS_KEPT);
  const unsigned long long dims[$rank] = {$dims};
  const unsigned box[$rank] = {$box};
  g_map_src[k] = nullptr;
  const int err = tma_encode_${rank}d(&g_maps[k], src, $elem, dims, box);
  if (err) return err;
  g_map_src[k] = src;
  ++g_maps_encoded;
  *map = g_maps[k];
  return 0;
}

extern "C" long long maps_encoded() { return g_maps_encoded; }""")
_MAP_RANK = {3: dict(rank=3, dims="N, M, D", box="BX, EY, 1",
                     elem="(int)sizeof(T)"),
             2: dict(rank=2, dims="N * sizeof(T) / 8, M", box="BOX, 1",
                     elem="8")}


@dataclass(frozen=True)
class TmaFeed(Feed):
    """Source planes copied whole ``ahead`` steps ahead by TMA (*Feeds*),
    one thread asking for each: in 3D (``ndim`` 3) a plane is one box of a
    3D tensor map and each thread reads its own quad of the slot before the
    levels, since a windowed 3D thread writes the ring itself; in 2D a
    strip's row is one box of a 2D tensor map of 8-byte elements, which
    the issuing thread sees land a step ahead, before its levels, and the
    threads stage from the slot after the levels as :class:`CpAsyncFeed`'s
    stage their rows."""

    ndim: int = 3

    includes = ("cuda_bf16.h", "cuda_runtime.h", "stddef.h", "mutex")
    source = "const __grid_constant__ CUtensorMap map"
    align = "__align__(128) "
    launch = ("  CUtensorMap map;",
              "  err = (cudaError_t)source_map(src, &map);",
              "  if (err != cudaSuccess) return (int)err;")
    launch_source = "map"
    # 2D: row s landed before the last barrier; its ring slot is its step's
    # place u among the unrolled ones (s0 is a multiple of RING)
    stage = ("      // row s landed before the last barrier",
             "      const Raw* const slot = reinterpret_cast<const Raw*>(",
             "          slots + (s & (SLOTS - 1)) * SLOT);",
             "      stage_arrived(smem + u * PLANE, slot);")

    @property
    def own(self) -> str:
        return "raw_to_f32(own)" if self.ndim == 3 else "raw_to_f32(slot[q])"

    @property
    def host(self):
        return tuple(_MAP_CACHE_TEXT.substitute(_MAP_RANK[self.ndim])
                     .split("\n")) + ("",)

    @staticmethod
    def slot_bytes(plane: int) -> int:
        """A slot of a ``plane``-cell plane, rounded up to 128 bytes, and
        its 8-byte mbarrier."""
        return 4 * _ceil_to(plane, 32) + 8

    def smem_bytes(self, rings: int, plane: int) -> int:
        return 4 * _ceil_to(rings, 32) + self.staging * self.slot_bytes(plane)

    def constants(self, g, bf16: bool):
        d3 = self.ndim == 3
        o = [f"constexpr int AHEAD = {self.ahead};  // source "
             f"{'planes' if d3 else 'rows'} requested ahead of their use "
             "(TMA)",
             "constexpr int SLOTS = AHEAD + 1;  // where they land, sized for "
             "fp32",
             "// a slot's floats and the first slot's offset: whole 128 "
             "bytes, as a box lands",
             "constexpr int SLOT = (PLANE + 31) / 32 * 32;",
             "constexpr int FEED = (2 * GUARD + LEVELS * RING * PLANE + 31) / "
             "32 * 32;"]
        if not d3:
            return o + [
                "// a row is one box of 8-byte elements (x0 and EX are "
                "multiples of 8 cells: whole",
                "// 16 bytes in either type), its bytes on its slot's barrier",
                "constexpr int BOX = EX * (int)sizeof(T) / 8;",
                f"static_assert(BOX <= {TMA_BOX}, \"one box a row\");",
                "static_assert((SLOTS & (SLOTS - 1)) == 0,",
                "              \"a row's slot is a mask of its index\");",
                "constexpr unsigned ROW_BYTES = EX * sizeof(T);",
                "// the rings, the slots, and an mbarrier a slot",
                "constexpr size_t SMEM_BYTES =",
                "    (size_t)(FEED + SLOTS * SLOT) * sizeof(float) + "
                "SLOTS * sizeof(uint64_t);"]
        if bf16:
            o += ["// a box starts on a whole 16 bytes of the source: at x0 "
                  "rounded down to 8 cells,",
                  "// so it is 8 cells wider than the staged plane",
                  "constexpr int BX = EX + 8;"]
        else:
            o.append("constexpr int BX = EX;  // a box is a staged plane (x0 "
                     "is a multiple of 4 cells)")
        return o + ["constexpr unsigned BOX_BYTES = EY * BX * sizeof(T);",
                    "// the rings, the slots, and an mbarrier a slot",
                    "constexpr size_t SMEM_BYTES =",
                    "    (size_t)(FEED + SLOTS * SLOT) * sizeof(float) + "
                    "SLOTS * sizeof(uint64_t);"]

    def helpers(self, g, bf16: bool):
        o = _TMA_TEXT.substitute(_TMA_RANK[self.ndim]).split("\n") + [""]
        return o if self.ndim == 3 else o + _stage_arrived()

    def prologue(self, g, end: str, bf16: bool, mine):
        d3 = self.ndim == 3
        unit = "plane" if d3 else "row"
        o = mine + ([
            "  // plane k of the window [a0 - H, a1 + H) lands in slot k % "
            "SLOTS, whose barrier",
            "  // full[k % SLOTS] counts its bytes; the last thread, in the "
            "warp with the fewest quads,",
            "  // asks for each plane AHEAD steps before its use and sees it "
            "land a step before"] if d3 else [
            "  // row k of the window [a0 - H, a1 + H) lands in slot k & "
            "(SLOTS - 1), whose barrier",
            "  // counts its bytes; the last thread asks for each row AHEAD "
            "steps before its use and",
            "  // sees it land a step before"])
        o += ["  float* const slots = reinterpret_cast<float*>(smem4) + FEED;",
              "  uint64_t* const full = reinterpret_cast<uint64_t*>(slots + "
              "SLOTS * SLOT);",
              f"  const bool issuer = {'i' if d3 else 'q'} == THREADS - 1;"]
        if bf16 and d3:
            o += ["  // a box's first column: x0 rounded down to 8 cells, xs "
                  "cells before it",
                  "  const int xs = x0 & 7;"]
        return o + ["  if (issuer)",
                    "    for (int k = 0; k < SLOTS; ++k) tma_bar_init(full + "
                    "k);",
                    "  __syncthreads();  // the barriers are set up",
                    f"  if (issuer) {{  // the first AHEAD {unit}s",
                    f"    for (int k = 0; k < AHEAD && k < {end}; ++k)",
                    "      request_plane(&map, slots, full, k, "
                    f"{self._at(bf16)});",
                    f"    tma_bar_wait(full, 0u);  // {unit} 0 has landed",
                    "  }",
                    "  __syncthreads();"]

    def _at(self, bf16: bool) -> str:
        """request_plane's arguments past the plane's index: the window's
        first plane and the box's corner."""
        if self.ndim == 2:
            return "a0 - H, x0"
        return f"a0 - H, y0, {'x0 - xs' if bf16 else 'x0'}"

    def request(self, g, end: str, bf16: bool):
        unit = "plane" if self.ndim == 3 else "row"
        o = [f"    // {unit} s + AHEAD, into the slot that {unit} s - 1 left "
             "at the last barrier",
             f"    if (issuer && s + AHEAD < {end})",
             f"      request_plane(&map, slots, full, s + AHEAD, "
             f"{self._at(bf16)});"]
        if self.ndim == 2:
            return o + [
                "    // the issuer sees row s + 1 land before its levels; the "
                "barrier at the step's end",
                "    // shows it to every thread",
                f"    if (issuer && s + 1 < {end})",
                "      tma_bar_wait(full + ((s + 1) & (SLOTS - 1)), "
                "(unsigned)(s + 1) / SLOTS & 1u);"]
        o += ["    // plane s landed before the last barrier: read the "
              "thread's quad now, stage it",
              "    // after the levels",
              "    Raw own;",
              "    if (feed && i < PLANE_QUADS)"]
        if bf16:
            return o + ["      own = *reinterpret_cast<const Raw*>(",
                        "          reinterpret_cast<const T*>(slots + s % "
                        "SLOTS * SLOT) + row * BX + xs + 4 * q);"]
        return o + ["      own = reinterpret_cast<const Raw*>(slots + s % "
                    "SLOTS * SLOT)[i];"]

    def end_step(self, end: str):
        if self.ndim == 2:      # the issuer waited before the levels
            return []
        return ["    // the issuer sees plane s + 1 land; the barrier shows "
                "it to every thread",
                f"    if (issuer && s + 1 < {end})",
                "      tma_bar_wait(full + (s + 1) % SLOTS, (unsigned)((s + "
                "1) / SLOTS) & 1u);"]


@dataclass(frozen=True)
class Geometry:
    """How one plan's kernel cuts a grid of ``dims``.

    ``tile`` is the output cells of one CTA, axis 0 first: ``(SEG, TX)`` in
    2D and ``(SEG, TY, TX)`` in 3D — a segment of axis 0 and the column
    (strip) it walks.  A staged plane is ``ey x ex`` fp32 cells: the column
    with ``frame`` halo rows on each side of y (``ey = 1`` in 2D) and
    ``hx`` halo columns (the frame rounded up to whole quads) on each side
    of x.  Each of the ``levels`` levels keeps a ring of ``ring`` planes:
    ``2 * reach + 2`` without register windows.
    With ``window`` (plans whose windows fit ``WINDOW_REGS``) a thread owns
    the same quad of every plane (row in 2D) at every level, and also
    carries its last ``window_len`` planes of the source and of every level
    below the last in registers, so that only taps that reach into a
    neighbour's cells read the rings.  A ``partial`` plan (2D, not factor)
    keeps instead its quad of each level's newest row and the partial sums
    of the ``2 * reach + 1`` rows an arriving row feeds, in rings of ``2 *
    reach + 1`` rows.  Each 3D level writes to its ring
    the plane of its window that the level above reads newest a step later
    (offset ``dhi``), so that a ring keeps only the planes at the offsets
    ``[dlo, dhi]`` of the taps that leave the column, and the plane being
    written (``_window_3d``).  ``feed`` is how the source planes arrive
    (:class:`Feed`).  A ``factor`` plan (2D, always windowed) keeps
    ``window_len`` rows of every level and stages ``tail`` source rows past
    its segment's window."""

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
    feed: Feed = REGISTERS
    factor: bool = False
    wlen: int = 0
    dhi: int = 0

    @property
    def ndim(self) -> int:
        return len(self.dims)

    @property
    def window3d(self) -> bool:
        return self.window and self.ndim == 3

    @property
    def partial(self) -> bool:
        """Whether the text accumulates partial sums (a windowed 2D plan but
        factor mode's): a thread reads each arriving row of a level once and
        adds it to every output row it feeds (``_partial_row``)."""
        return self.window and self.ndim == 2 and not self.factor

    @property
    def window_len(self) -> int:
        """Rows of each level a windowed thread keeps: the ``2 * reach +
        1`` a level reads of the one below; a factor plan's V2 level also
        reads R's ``4 * reach + 1`` rows of the level two below, whose
        newest row is then one step ahead of them.  A 3D thread keeps
        ``wlen`` planes (``_window_3d``)."""
        if self.window3d:
            return self.wlen
        return 4 * self.reach + 2 if self.factor else 2 * self.reach + 1

    @property
    def window_write(self) -> int:
        """3D: the window entry a level writes to its ring after its push:
        the plane at offset ``dhi`` from the level above's output plane of
        the next step."""
        return self.wlen - 1 - self.reach + self.dhi

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
    def ahead(self) -> int:
        """Source planes the feed requests ahead of their use."""
        return self.feed.ahead

    @property
    def tma(self) -> bool:
        """Whether the source planes arrive by TMA (:class:`TmaFeed`)."""
        return isinstance(self.feed, TmaFeed)

    @property
    def window_planes(self) -> int:
        """fp32 planes of one CTA in shared memory: the levels' rings and
        the feed's staging planes (sized for fp32 whatever the state's
        type)."""
        return self.levels * self.ring + self.feed.staging

    @property
    def smem_bytes(self) -> int:
        return self.feed.smem_bytes(
            2 * self.guard + self.levels * self.ring * self.plane_cells,
            self.plane_cells)

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
        return int(np.prod(self.grid[:-1]))

    @property
    def grid(self) -> Tuple[int, ...]:
        """CTAs per axis, x first (CUDA's order), segments last."""
        cols = [-(-d // t) for d, t in zip(self.dims[1:], self.tile[1:])]
        return tuple(reversed(cols)) + (self.n_segments,)

    @property
    def ctas_per_sm(self) -> int:
        """CTAs an SM holds by shared memory and threads, at most 8."""
        return _ctas_by_smem(self.smem_bytes, self.threads)

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
    reach + 1`` quads a level (the partial sums of the rows an arriving row
    feeds); a factor plan keeps ``4 * reach + 2`` rows of the levels R reads
    (0, 2, ..., levels - 2), whose odd neighbours need only their ``2 *
    reach + 1``."""
    r, L = int(plan.reach), int(plan.levels)
    if is_factor(plan):
        return QUAD * (L // 2) * ((4 * r + 2) + (2 * r + 1))
    return QUAD * L * (2 * r + 1)


def _window_3d(plan, ey: int, ex: int):
    """``(threads, wlen, ring, dhi)`` of a 3D column whose staged plane is
    ``ey x ex`` with register windows, or None.  A thread owns one quad, so
    the plane's quads must not exceed ``THREADS_3D_WINDOW``.  The taps on
    the thread's own row read its window, so a window reaches back to the
    oldest plane they read, or to the plane the level writes to its ring
    where that is older; the windows of all levels but the last must fit
    ``WINDOW_REGS``, and a CTA's registers the register file.  A ring keeps
    the planes at the axis-0 offsets ``[dlo, dhi]`` of the taps that leave
    the thread's quad column, and the plane being written: the windows
    engage only where that is fewer than the ``2 * reach + 2`` of the ring
    text (a star table, not a box), since they pay for their registers
    with the wider column the freed shared memory admits."""
    r, L = int(plan.reach), int(plan.levels)
    offsets = np.asarray(plan.offsets).tolist()
    leave = [d0 for d0, dy, dx in offsets if (dy, dx) != (0, 0)] or [0]
    dlo, dhi = min(leave), max(leave)
    threads = _ceil_to(ey * ex // QUAD, 32)
    wlen = r + 1 - min([d0 for d0, dy, _ in offsets if dy == 0] + [dhi])
    regs = QUAD * L * wlen
    if (threads > THREADS_3D_WINDOW or dhi - dlo + 2 >= 2 * r + 2
            or regs > WINDOW_REGS
            or threads * (regs + REGS_BESIDE_WINDOWS) > REGISTER_FILE):
        return None
    return threads, wlen, dhi - dlo + 2, dhi


def _feed_3d(dims, ey: int, ex: int, threads: int, regs: int,
             rings: int) -> Feed:
    """The feed of a windowed 3D plan: a :class:`TmaFeed`, or the
    :class:`RegisterFeed` where TMA does not fit.  A staged plane, ``ey x
    ex`` cells, is one box of the source (8 cells wider in bf16, whose
    boxes start on 16 bytes), so its rows and the grid's must be whole
    16-byte pieces in either state type (``ex`` and the grid's width
    multiples of 8).  Its slots take the shared memory that the rings
    (``rings`` floats with their guards) leave to each of the CTAs an SM
    holds by their registers (``regs`` a thread in windows), so that the
    feed costs no CTA an SM; at most ``AHEAD_3D`` planes, and at least
    one.  The slots are a power of two, so that a plane's slot is a mask
    of its index (on the card 4 slots ran 4-7% faster than 3, 5 or 9 at
    four levels)."""
    if dims[-1] % 8 or ex % 8 or max(ey, ex + 8) > TMA_BOX:
        return REGISTERS
    ctas = _ctas_by_registers(threads, regs)
    budget = SMEM_LIMIT if ctas == 1 else SMEM_LIMIT // ctas - SMEM_RESERVED
    fit = min(AHEAD_3D + 1, (budget - 4 * _ceil_to(rings, 32))
              // TmaFeed.slot_bytes(ey * ex))
    return (TmaFeed((1 << (fit.bit_length() - 1)) - 1) if fit >= 2
            else REGISTERS)


def _feed_2d(dims, ex: int, hx: int, rings: int, threads: int) -> Feed:
    """The feed of a windowed 2D plan on whole quads that is not in factor
    mode: a :class:`TmaFeed`, or the :class:`CpAsyncFeed` where TMA does
    not fit or does not pay.  A staged row, ``ex`` cells from ``x0 = k *
    TX - hx``, is one box of a 2D tensor map of 8-byte elements, so the
    row, its start and the grid's rows must be whole 16-byte pieces in
    either state type (``ex``, ``hx`` and the grid's width multiples of 8
    cells; ``TX = ex - 2 * hx`` then is one too).  Its slots are the
    largest power of two not above the ``AHEAD_2D + 1`` staging rows of the
    cp.async feed, so that a row's slot is a mask of its index.  The
    issuing thread's wait for the next row, once a step, holds up its warp:
    where the shared memory (``rings`` floats with their guards, and the
    staging rows or slots) holds four CTAs of ``threads`` an SM or more,
    the other CTAs' warps cover it; where three, they did not (on the card
    the 2d25pt_box winner ran 4.3% faster a launch in fp32 and 5.4% in
    bf16, the six 2D winners at three CTAs an SM 1.0-4.5% slower), and the
    feed stays cp.async.  It stays so too where the slots, smaller than the
    staging rows, would admit more CTAs an SM: the segment, sized by them
    (``_segment``), and the tuner's candidates would move with the feed."""
    copies = CpAsyncFeed(AHEAD_2D)
    if dims[-1] % 8 or ex % 8 or hx % 8:
        return copies
    tma = TmaFeed((1 << ((AHEAD_2D + 1).bit_length() - 1)) - 1, ndim=2)
    ctas = {_ctas_by_smem(f.smem_bytes(rings, ex), threads)
            for f in (tma, copies)}
    return tma if len(ctas) == 1 and min(ctas) >= 4 else copies


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
    if in_regs and not factor:
        # the partial-sum text reads a row a step after it is written, and
        # its steps go 2 * reach + 1 at a time: a ring of as many rows
        # names each row's slot by its step's place among them
        ring = 2 * r + 1
    # the feed: a windowed strip's rows by cp.async where they are whole
    # quads (by _feed_2d once the strip is chosen, unless in factor mode), a
    # windowed 3D plan's by _feed_3d, every other by registers
    feed = CpAsyncFeed(AHEAD_2D) if window and vec else REGISTERS

    def rings(ey, ex, ring):
        return 2 * guard + L * ring * ey * ex   # floats, with the guards

    def smem(ey, ex):
        return feed.smem_bytes(rings(ey, ex, ring), ey * ex)

    entries = _column_entries(dims, H)
    # the asked column: of two entries with its name, the wider
    named = [e for e in entries if e[0] == column]
    named = named and [max(named, key=lambda e: e[1])]
    # 3D: register windows where a column's fit (_window_3d), the widest
    # first; the column the rings fit otherwise
    win3 = None
    if ndim == 3:
        for _, _, (ey3, ex3) in (entries if column is None else named):
            w = _window_3d(plan, ey3, ex3)
            if w and 4 * rings(ey3, ex3, w[2]) <= SMEM_LIMIT:
                win3 = (ey3, ex3) + w
                break
    if win3:
        ey, ex, threads, wlen, ring, dhi = win3
        feed = _feed_3d(dims, ey, ex, threads, QUAD * L * wlen,
                        rings(ey, ex, ring))
    elif column is None:
        shapes = [e[2] for e in entries]
        fits = ([s for s in shapes if smem(*s) <= SMEM_TARGET]
                or [s for s in shapes if smem(*s) <= SMEM_LIMIT])
        if not fits:
            raise ValueError(
                f"frame {H} is too wide for a shared-memory window")
        ey, ex = fits[0]
    else:
        if not named:
            raise ValueError(
                f"column ch={column} names no "
                f"{'strip' if ndim == 2 else 'column'} of this plan: one of "
                f"{sorted({e[0] for e in entries})}")
        ey, ex = named[0][2]
        if smem(ey, ex) > SMEM_LIMIT:
            raise ValueError(
                f"column ch={column}: its rings take {smem(ey, ex)} bytes of "
                f"shared memory, more than {SMEM_LIMIT}")
    column = (ex - 2 * hx,) if ndim == 2 else (ey - 2 * H, ex - 2 * hx)
    quads = ey * ex // QUAD
    if not win3:
        wlen, dhi = 0, 0
        threads = min(_ceil_to(quads, 32),
                      THREADS_3D if ndim == 3 else STRIP_2D[0] // QUAD)
    if window and vec and ndim == 2 and not factor:
        feed = _feed_2d(dims, ex, hx, rings(ey, ex, ring), threads)
    g = Geometry(dims=dims, frame=H, reach=r, levels=L, tile=(1,) + column,
                 hx=hx, ey=ey, ex=ex, ring=ring, threads=threads,
                 min_blocks=1, vec=vec, feed=feed,
                 window=window or bool(win3), factor=factor, wlen=wlen,
                 dhi=dhi)
    assert not window or quads <= threads
    if win3:
        # registers, not shared memory, decide how many CTAs an SM holds
        min_blocks = min(g.ctas_per_sm,
                         _ctas_by_registers(threads, QUAD * L * wlen))
    else:
        min_blocks = min(g.ctas_per_sm,
                         2 if ndim == 3 or (factor and not in_regs) else 4)
    if segment is None:
        # a factor plan's registers, not its shared memory, decide how many
        # of its CTAs an SM holds (at step 1 shared memory would admit six,
        # its 88 registers five): its segments fill the ones the launch
        # bound promises; so do a windowed 3D plan's
        slots = int(sms) * (min_blocks if factor or win3
                            else g.ctas_per_sm)
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
        tag = f"{rid}_{_signed(blk)}"
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


def _signed(n: int) -> str:
    """``n`` in a C name: ``m1``, ``p0``, ``p2``."""
    return f"{'m' if n < 0 else 'p'}{abs(n)}"


def _plane_name(d0: int, prefix: str = "b") -> str:
    return f"{prefix}_{_signed(d0)}"


def _edge_lanes(m: int) -> Tuple[int, int]:
    """``[lo, hi)``: the lanes of a warp whose neighbour ``m`` quads away
    lies in another warp (``_own_row_3d``'s ``far`` condition)."""
    return (0, -m) if m < 0 else (32 - m, 32)


def _own_row_3d(rid: str, base: str, d0: int, dxs, own: str, beside):
    """Loads of a windowed 3D thread's own row at axis-0 offset ``d0``: its
    quad ``own`` from its window, and each cell ``j`` beside it from the
    window of the lane ``j // 4`` quads away by a warp shuffle done before
    the call (``_kernel_text``), named ``x_<d0>_<j>`` and appended to
    ``beside`` as (name, d0, component, lanes away); a lane whose neighbour
    lies in another warp loads the cell from shared memory instead.  A quad
    at a row's start or end takes a neighbour of another row there, for
    cells within ``reach`` of the staged plane's edge, which no kept cell
    reads.  Returns (lines, {relative x: expression})."""
    need = sorted({j + dx for dx in dxs for j in range(QUAD)})
    expr = {j: f"{own}." + "xyzw"[j] for j in range(QUAD)}
    lines = []
    for j in need:
        if j in expr:
            continue
        m = j // QUAD
        name = f"x_{_signed(d0)}_{_signed(j)}"
        beside.append((name, d0, "xyzw"[j - QUAD * m], m))
        lo, hi = _edge_lanes(m)
        far = f"lane < {hi}" if m < 0 else f"lane >= {lo}"
        tag = f"{rid}_{_signed(j)}"
        lines.append(f"  const float s{tag} = {far} ? {base}[at + ({j})] : "
                     f"{name};")
        expr[j] = f"s{tag}"
    return lines, expr


def _taps_text(offsets, coeffs, g: Geometry, own_base: int, acc: str = "a",
               window: str = "w", tag: str = "", beside=None):
    """``fmaf`` lines of one tap table at the quad ``at``, one per tap and
    output cell into ``acc0..acc3``, in table order; with register windows
    the thread's own quad of axis-0 offset ``d0`` is ``window[d0 +
    own_base]`` (in 3D on the thread's own row, whose cells beside the quad
    come from its neighbours' windows: ``_own_row_3d``, which appends them
    to ``beside``).  Returns (lines, axis-0 offsets of the planes read from
    shared memory, the shared loads every thread runs: ``_row_loads``'
    lines)."""
    rows = []       # taps grouped by everything but dx, in table order
    for off, c in zip(offsets.tolist(), coeffs.tolist()):
        key = tuple(off[:-1])
        if not rows or rows[-1][0] != key:
            rows.append((key, []))
        rows[-1][1].append((off[-1], c, tuple(off)))
    body, planes, loads = [], set(), 0
    for rid, (key, taps) in enumerate(rows):
        off = key[1] * g.ex if len(key) == 2 else 0
        own = f"{window}[{key[0] + own_base}]" if g.window else None
        dxs = [dx for dx, _, _ in taps]
        if g.window3d and key[1] == 0:
            lines, expr = _own_row_3d(f"{tag}{rid}", _plane_name(key[0]),
                                      key[0], dxs, own, beside)
        else:
            lines, expr = _row_loads(f"{tag}{rid}", _plane_name(key[0]),
                                     off, dxs, None if g.window3d else own)
            loads += len(lines)
        if lines:
            planes.add(key[0])
        body += lines
        for dx, c, full in taps:
            lit = float32_literal(c)
            body.append("  " + " ".join(
                f"{acc}{j} = fmaf({lit}, {expr[j + dx]}, {acc}{j});"
                for j in range(QUAD)) + f"  // {full}")
    return body, planes, loads


@dataclass(frozen=True)
class QuadLoads:
    """The shared-memory loads one quad step of a level writes for its taps
    (the feed's staging is not counted): ``each``, the loads every thread
    that computes a quad runs, and ``lanes``, one ``[lo, hi)`` range of
    warp lanes for each load that only those lanes run (a windowed 3D
    thread's cell beside its quad where the lane beside it is in another
    warp, ``_own_row_3d``)."""

    each: int
    lanes: Tuple[Tuple[int, int], ...] = ()


def _quad_fn(name: str, comment, windows, planes, body, scalars=()):
    """A ``__device__`` function of the quad ``at`` up to its return:
    ``comment``, the signature, ``a0..a3`` from 0, then ``body``."""
    args = [f"const float4 (&{w})[WINDOW]" for w in windows]
    args += [f"const float {x}" for x in scalars]
    args += [f"const float* __restrict__ {_plane_name(d)}" for d in planes]
    return comment + [
        f"__device__ __forceinline__ float4 {name}("
        + ", ".join(args + ["int at"]) + ") {",
        "  float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f, a3 = 0.0f;",
    ] + body


def _level_quad(plan, g: Geometry):
    """Text of ``level_quad``: one level at the quad ``at`` — the table in
    sorted order, one ``fmaf`` per tap and output cell.  Returns (lines,
    axis-0 offsets of the planes it reads from shared memory, the shuffled
    cells it takes as ``(name, d0, component, lanes away)``, its
    :class:`QuadLoads`)."""
    beside = []
    body, planes, loads = _taps_text(plan.offsets, plan.coeffs, g,
                                     g.window_len - 1 - g.reach,
                                     beside=beside)
    planes = sorted(planes)
    o = ["// One level at the quad `at` of a plane: the tap table in sorted "
         "order, one fmaf",
         "// per tap and output cell; b_m1, b_p0, ... are the planes at "
         "axis-0 offsets -1, 0, ..."]
    if g.window3d:
        o.append(f"// in shared memory, w[k] the thread's own quad at offset "
                 f"k - {g.window_len - 1 - g.reach}, in registers, and "
                 "x_<d0>_<j> its row's")
        o.append("// cell j at offset d0, from the window of the lane beside "
                 "(shared memory where")
        o.append("// that lane is in another warp)")
        body = ["  const int lane = (int)threadIdx.x & 31;"] + body
    o = _quad_fn("level_quad", o, ["w"] if g.window else [], planes, body,
                 [b[0] for b in beside])
    o.append("  return make_float4(a0, a1, a2, a3);")
    o.append("}")
    # each cell that _own_row_3d shuffles in is one load at the warp's ends
    return o, planes, beside, QuadLoads(
        loads, tuple(_edge_lanes(b[3]) for b in beside))


def _beside_cells(plan):
    """Cells beside a quad (relative x, ``0..3`` the quad's own) that some
    tap of ``plan``'s table reads."""
    dxs = {off[-1] for off in plan.offsets.tolist()}
    return sorted({j + dx for dx in dxs for j in range(QUAD)}
                  - set(range(QUAD)))


def _beside_loads(base: str, need):
    """Shared loads of the cells ``need`` beside the quad ``at`` of the row
    ``base``: per aligned block of four, one cell as a ``float``, an aligned
    pair as a ``float2``, more as a ``float4``.  Returns (lines, {relative
    x: expression})."""
    lines, expr = [], {}
    for blk in sorted({j // QUAD for j in need}):
        inside = [j for j in need if j // QUAD == blk]
        if len(inside) == 1:
            j = inside[0]
            lines.append(f"  const float s_{_signed(j)} = {base}[at + ({j})];")
            expr[j] = f"s_{_signed(j)}"
            continue
        pair = (len(inside) == 2 and inside[1] == inside[0] + 1
                and inside[0] % 2 == 0)
        kind, first = ("float2", inside[0]) if pair else ("float4",
                                                          QUAD * blk)
        name = f"{'d' if pair else 'q'}_{_signed(first)}"
        lines.append(f"  const {kind} {name} = *reinterpret_cast<const "
                     f"{kind}*>({base} + at + ({first}));")
        for j in inside:
            expr[j] = f"{name}." + "xyzw"[j - first]
    return lines, expr


def _partial_row(plan):
    """Text of ``level_row``: the partial-sum form of a level (the design
    note's *Partial sums*).  Row ``j`` of the level below arrives at the
    quad ``at``: the thread's own quad ``own`` from its registers, and the
    cells beside it read once from the row ``b`` in shared memory.  Tap row
    ``dy`` of the table then adds its taps, in sorted order, to ``o_<dy>``,
    the partial sum of output row ``j - dy``.  Rows arrive in increasing
    ``j``, so every output cell's ``fmaf`` chain runs over the table in its
    sorted order from 0, as ``level_quad``'s does.  Returns (lines, its
    :class:`QuadLoads`: one load a line of ``_beside_loads``)."""
    lines, expr = _beside_loads("b", _beside_cells(plan))
    expr.update({j: "own." + "xyzw"[j] for j in range(QUAD)})
    body = []
    for off, c in zip(plan.offsets.tolist(), plan.coeffs.tolist()):
        acc, lit = f"o_{_signed(off[0])}", float32_literal(c)
        body.append("  " + " ".join(
            f"{acc}.{x} = fmaf({lit}, {expr[j + off[1]]}, {acc}.{x});"
            for j, x in enumerate("xyzw")) + f"  // {tuple(off)}")
    args = (["const float4 own", "const float* __restrict__ b", "int at"]
            + [f"float4& o_{_signed(dy)}"
               for dy in range(-int(plan.reach), int(plan.reach) + 1)])
    return ["// One arriving row j of the level below at the quad `at`: the "
            "thread's own quad",
            "// `own` in registers, the cells beside it read once from the "
            "row `b` in shared",
            "// memory; tap row dy adds its taps, in sorted order, to o_<dy>, "
            "the partial sum",
            "// of output row j - dy",
            "__device__ __forceinline__ void level_row(" + ", ".join(args)
            + ") {"] + lines + body + ["}"], QuadLoads(len(lines))


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
    body, p1, _ = _taps_text(*plan.v1, g, newest - g.reach)
    planes[1] = sorted(p1)
    o += _quad_fn("level_v1", ["// odd levels: V1"], ["w"], planes[1], body)
    o += ["  return make_float4(a0, a1, a2, a3);", "}"]
    body, p2, _ = _taps_text(*plan.v2, g, newest - g.reach)
    rbody, _, _ = _taps_text(r_offsets, r_coeffs, g,
                             newest - 1 - 2 * g.reach, acc="c", window="w2",
                             tag="r")
    planes[0] = sorted(p2)
    o += _quad_fn("level_v2r", ["// even levels: V2, then R's chain, then "
                                "one add"], ["w", "w2"], planes[0], body)
    o.append("  float c0 = 0.0f, c1 = 0.0f, c2 = 0.0f, c3 = 0.0f;")
    o += rbody
    o += ["  return make_float4(a0 + c0, a1 + c1, a2 + c2, a3 + c3);", "}"]
    return o, planes


def level_loads(plan, g: Geometry) -> Tuple[int, ...]:
    """Shared-memory loads for taps that one CTA's threads run in a step in
    which a level runs its quad step, level by level, from the quad step the
    text writes (:class:`QuadLoads` of ``level_quad``, or of ``level_row``
    in the partial-sum text): ``each`` for every quad of the level's region
    (``Geometry.level_region``), and each load of ``lanes`` for the threads
    of the region whose lane lies in its range.  Factor mode's loads are
    not counted: zeros."""
    if g.factor:
        return (0,) * g.levels
    loads = _partial_row(plan)[1] if g.partial else _level_quad(plan, g)[3]
    qx = g.ex // QUAD
    out = []
    for t in range(1, g.levels + 1):
        y0, rows, q0, quads = g.level_region(t)
        n = loads.each * rows * quads
        if loads.lanes:
            # a windowed 3D thread i owns quad i % qx of the row i // qx
            owners = [i % 32 for i in range(g.threads)
                      if y0 <= i // qx < y0 + rows
                      and q0 <= i % qx < q0 + quads]
            n += sum(lo <= lane < hi for lane in owners
                     for lo, hi in loads.lanes)
        out.append(n)
    return tuple(out)


def cuda_source(plan, dims, dtype: str, shard: bool, name: str = "plan",
                label: str = "", sms: int = SM_COUNT) -> str:
    """The CUDA C++ text of ``plan``'s kernel on a grid (or ghosted slab)
    of ``dims`` in ``dtype`` state for a card of ``sms`` SMs, in the
    plan's geometry (:func:`geometry`); ``shard`` adds the axis-0 store
    range ``[s_lo, s_hi)`` as kernel arguments."""
    if dtype not in DTYPES:
        raise ValueError(f"dtype {dtype!r}: the kernels take {DTYPES} state")
    g = geometry(plan, dims, sms)
    feed = g.feed
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
    o += [f"#include <{h}>" for h in feed.includes] + [""]
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
    if g.window3d:
        o.append(f"constexpr int RING = {g.ring};  // planes a level keeps: "
                 "those its taps off the column read,")
        o.append("                        // and the one being written")
    elif g.partial:
        o.append(f"constexpr int RING = {g.ring};  // rows a level keeps: "
                 "2 * REACH + 1, a row's slot its")
        o.append("                        // step's place among the WINDOW "
                 "unrolled ones")
    else:
        o.append(f"constexpr int RING = {g.ring};  // planes a level keeps: "
                 "2 * REACH + 2")
    o.append(f"constexpr int GUARD = {g.guard};")
    o.append(f"constexpr int THREADS = {g.threads}, MIN_BLOCKS = "
             f"{g.min_blocks};")
    o.append("constexpr int STAGE = (PLANE_QUADS + THREADS - 1) / THREADS;"
             "  // quads a thread stages per plane")
    if g.window3d:
        o.append("// a thread owns quad threadIdx.x of every plane and keeps "
                 "the source's and each")
        o.append("// level's last WINDOW planes of it in registers")
        o.append(f"constexpr int WINDOW = {g.window_len};")
        o.append("// the window entry a level writes to its ring: the plane "
                 "the level above reads")
        o.append("// newest a step later")
        o.append(f"constexpr int WRITE = {g.window_write};")
    elif g.partial:
        o.append("// a thread owns quad threadIdx.x of every row and keeps "
                 "in registers its quad of")
        o.append("// each level's newest row and each level's partial sums "
                 "of the WINDOW output rows")
        o.append("// that an arriving row feeds")
        o.append("constexpr int WINDOW = 2 * REACH + 1;")
        o.append("static_assert(RING == WINDOW, \"a row's slot is its step's "
                 "place\");")
    elif g.window:
        o.append("// a thread owns quad threadIdx.x of every row and keeps "
                 "each level's last WINDOW")
        o.append("// rows of it in registers")
        o.append("// (4 * REACH + 2: a V2 level reads R's rows of the "
                 "level two below, whose")
        o.append("// newest row is then 2 * REACH + 1 rows past the "
                 "output row)")
        o.append("constexpr int WINDOW = 4 * REACH + 2;")
        o.append("// source rows staged past the window, so that the "
                 "windows R reads shift")
        o.append("// on to the last output row")
        o.append("constexpr int TAIL = 1;")
    if g.window:
        o.append("static_assert(STAGE == 1, \"one quad per thread\");")
    o += feed.constants(g, bf16)
    o.append(f"static_assert(SMEM_BYTES == {g.smem_bytes}, \"geometry\");")
    o.append("")
    o += _io_text(bf16, g.vec)
    o.append("")
    o += feed.helpers(g, bf16)
    beside = []
    if g.factor:
        quad_text, by_parity = _factor_quads(plan, g)

        def level_call(t):
            if t % 2:
                return "level_v1", [f"w[{t - 1}]"], by_parity[1]
            return "level_v2r", [f"w[{t - 1}]", f"w[{t - 2}]"], by_parity[0]
    elif g.partial:
        quad_text, level_call = _partial_row(plan)[0], None
    else:
        quad_text, planes, beside, _ = _level_quad(plan, g)

        def level_call(t):
            return ("level_quad", [f"w[{t - 1}]"] if g.window else [],
                    planes)
    o += quad_text
    o.append("")
    o += _kernel_text(g, shard, bf16, level_call, beside)
    o.append("")
    checks = [f"  if (s_lo < H || s_hi > {A0} - H) return (int)"
              "cudaErrorInvalidValue;",
              "  if (s_lo >= s_hi) return (int)cudaSuccess;  // nothing to "
              "store"] if shard else []
    o += _host_text("stencil_kernel", g.grid, "columns, then segments",
                    f"{feed.launch_source}, (T*)dst"
                    + (", s_lo, s_hi" if shard else ""),
                    ", int s_lo, int s_hi" if shard else "", checks,
                    feed.host, feed.launch)
    return "\n".join(o)


def _host_text(kernel: str, grid, what: str, args: str, params: str = "",
               checks=(), host=(), setup=()):
    """The host's entry points: ``error_string``, then ``host``, then
    ``launch(src, dst{params}, stream)``, which runs ``checks``, lets
    ``kernel`` take its shared memory, runs ``setup`` and launches it with
    ``args`` on ``grid`` (``what`` its CTAs are)."""
    return ['extern "C" const char* error_string(int err) {',
            "  return cudaGetErrorString((cudaError_t)err);", "}", "", *host,
            f'extern "C" int launch(const void* src, void* dst{params}, '
            "void* stream) {", *checks,
            "  cudaError_t err = cudaFuncSetAttribute(",
            f"      {kernel}, cudaFuncAttributeMaxDynamicSharedMemorySize, "
            "(int)SMEM_BYTES);",
            "  if (err != cudaSuccess) return (int)err;", *setup,
            "  const dim3 block(THREADS);",
            f"  const dim3 grid({', '.join(map(str, grid))});  // {what}",
            f"  {kernel}<<<grid, block, SMEM_BYTES, (cudaStream_t)stream>>>(",
            f"      {args});",
            "  return (int)cudaGetLastError();", "}"]


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


def _partial_level(g: Geometry, t: int):
    """Level ``t``'s block of a step of the partial-sum text (the design
    note's *Partial sums*), at the step's indentation: row ``p + REACH`` of
    level ``t - 1`` arrives and feeds the partial sums of rows ``[p, p + 2 *
    REACH]``; row ``p``'s is then whole, and is stored (to ``dst`` at the
    last level, to the ring and ``cur[t]`` below it).  A step's ``u``, its
    place among the ``WINDOW`` unrolled ones, names every sum's register:
    row ``x``'s is ``ps[t - 1][x % WINDOW]``, and ``s0`` is a multiple of
    ``WINDOW``."""
    H, L, r = g.frame, g.levels, g.reach
    w = 2 * r + 1
    _, _, q_first, qw = g.level_region(t)
    lag = t * (r + 1)

    def place(k):   # row p + k's place among the WINDOW unrolled steps
        return f"(u + {(k - lag) % w})"

    def ps(k):      # the partial sum of row p + k
        return f"ps[{t - 1}][{place(k)} % WINDOW]"

    o = [f"    {{  // level {t} of {L}: rows [0, 1) x quads [{q_first}, "
         f"{q_first + qw})",
         f"      const int p = s - {lag};",
         "      // row p + REACH of the level below is one of its rows: it "
         "feeds a row of this one",
         f"      if (p >= {(t - 2) * r} && p < n0 + {2 * H - t * r}) {{",
         f"        const float* const b = smem + ({t - 1} * RING + {place(r)}"
         " % RING) * PLANE;",
         f"        if (q >= {q_first} && q < {q_first + qw}) do {{",
         "          // row p + 2 * REACH's sum starts from 0",
         f"          {ps(2 * r)} = make_float4(0.0f, 0.0f, 0.0f, 0.0f);",
         "          level_row(" + ", ".join(
             [f"cur[{t - 1}]", "b", "4 * q"]
             + [ps(r - dy) for dy in range(-r, r + 1)]) + ");",
         f"          if (p < {t * r}) continue;  // before the level's first "
         "row",
         f"          const float4 v = {ps(0)};"]
    if t == L:
        o.append("          const int g0 = a0 - H + p;  // in [a0, a1)")
        o += _store_lines(g, 0, "          ")
    else:
        o += [f"          *reinterpret_cast<float4*>(smem + ({t} * RING + "
              f"{place(0)} % RING) * PLANE + 4 * q) = v;",
              f"          cur[{t}] = v;"]
    return o + ["        } while (0);", "      }", "    }"]


def _kernel_text(g: Geometry, shard: bool, bf16: bool, level_call, beside):
    """The ``__global__`` kernel of every streamed plan (the design note's
    *One skeleton*): the plan's kind (ring, partial sums, factor mode's
    windowed strip or windowed 3D) branches here, the feed's pieces
    (``g.feed``) go in their places.  ``level_call(t)`` is (function,
    window arguments, axis-0 offsets of the planes it reads) of level ``t``
    (a partial-sum plan's levels are ``_partial_level``'s); a windowed 3D
    plan's ``level_quad`` also takes the cells ``beside`` its quad
    (``_own_row_3d``)."""
    d3, w3 = g.ndim == 3, g.window3d
    H, L, r = g.frame, g.levels, g.reach
    wl = g.window_len
    feed = g.feed
    # planes (rows) of the segment's window staged: a factor plan's TAIL more
    end = "n0 + 2 * H" + (" + TAIL" if g.tail else "")
    rng = ", int s_lo, int s_hi" if shard else ""
    lo0, hi0 = ("s_lo", "s_hi") if shard else ("H", ("D" if d3 else "M")
                                               + " - H")
    seg_idx = "blockIdx.z" if d3 else "blockIdx.y"
    # 3D windows: the ring slot of the plane a level writes is (its output
    # plane + woff) % RING: that plane is REACH - dhi planes older, and
    # woff >= 0
    woff = g.ring * r - r + g.dhi

    def push(t, value, pad):
        return ([f"{pad}w[{t}][{k}] = w[{t}][{k + 1}];" for k in range(wl - 1)]
                + [f"{pad}w[{t}][{wl - 1}] = {value};"])

    o = ["__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)",
         f"stencil_kernel({feed.source}, T* __restrict__ dst{rng}) {{",
         f"  extern __shared__ {feed.align}float4 smem4[];",
         "  float* const smem = reinterpret_cast<float*>(smem4) + GUARD;",
         f"  // this CTA's segment [a0, a1) of the store range [{lo0}, {hi0}):"
         " uniform over the block",
         f"  const int a0 = {lo0} + (int){seg_idx} * SEG;",
         f"  const int a1 = a0 + SEG < {hi0} ? a0 + SEG : {hi0};",
         "  if (a0 >= a1) return;",
         "  const int n0 = a1 - a0;",
         "  // global coordinates of the plane's local (0, 0)"]
    if d3:
        o.append("  const int y0 = (int)blockIdx.y * TY - H;")
    o.append("  const int x0 = (int)blockIdx.x * TX - HX;")
    mine = (["  // this thread's quad of every plane: quad q of row `row`; a "
             "thread past the plane's",
             "  // quads owns none",
             "  const int i = threadIdx.x, row = i / QX, q = i - row * QX;"]
            if w3 else ["  const int q = threadIdx.x;  // this thread's quad "
                        "of every row"] if g.window else [])
    o += feed.prologue(g, end, bf16, mine)
    if g.partial:
        o += ["  // cur[t]: the thread's quad of level t's newest row (0: the "
              "source); ps[t][k]: level",
              "  // t + 1's partial sums of the thread's quad in its output "
              "rows p, p % WINDOW == k",
              "  float4 cur[LEVELS], ps[LEVELS][WINDOW];",
              "#pragma unroll",
              "  for (int t = 0; t < LEVELS; ++t) {",
              "    cur[t] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);",
              "#pragma unroll",
              "    for (int k = 0; k < WINDOW; ++k)",
              "      ps[t][k] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);",
              "  }"]
    elif g.window:
        o += (["  // w[t][k]: the thread's quad of level t (0: the source) "
               "in the k-th of its last WINDOW", "  // planes"] if w3 else
              ["  // w[t][k]: the thread's quad of level t (0: the source) "
               "in its last WINDOW rows"])
        o += ["  float4 w[LEVELS][WINDOW];",
              "#pragma unroll",
              "  for (int t = 0; t < LEVELS; ++t)",
              "#pragma unroll",
              "    for (int k = 0; k < WINDOW; ++k)",
              "      w[t][k] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);"]
    o.append("  // step s stages source plane s of the window [a0 - H, a1 + "
             "H); level t then")
    if g.partial:
        o += ["  // completes its row p = s - t * (REACH + 1): row p + REACH "
              "of level t - 1, written a",
              "  // step earlier, arrives and adds to the partial sums of "
              "rows [p, p + 2 * REACH], the",
              "  // levels last to first, so that each reads the newest row "
              "of the level below before",
              "  // that moves on.  The steps go WINDOW at a time, unrolled, so "
              "that a partial sum's",
              "  // register is named by its row's place in the rotation; a "
              "step past the last only",
              "  // waits at the barrier",
              "  for (int s0 = 0; s0 < n0 + 2 * H + LEVELS; s0 += WINDOW) {",
              "#pragma unroll",
              "    for (int u = 0; u < WINDOW; ++u) {"]
        body = len(o)
        o.append("    const int s = s0 + u;")
    else:
        o += (["  // computes its plane s - t * (REACH + 1) from planes of "
               "earlier steps, the levels last",
               "  // to first, so that each reads the window of the level "
               "below before that moves on"] if w3 else
              ["  // computes its plane s - t * (REACH + 1) from planes "
               "staged in earlier steps"])
        o.append("  for (int s = 0; s < n0 + 2 * H + LEVELS; ++s) {")
    o.append(f"    const bool feed = s < {end};")
    o += feed.request(g, end, bf16)
    # with register windows the levels run last to first: level t reads
    # level t - 1's window before level t - 1 pushes this step's row
    for t in (range(L, 0, -1) if g.window else range(1, L + 1)):
        if g.partial:
            o += _partial_level(g, t)
            continue
        y_first, rows, q_first, qw = g.level_region(t)
        fn, windows, planes = level_call(t)
        # the levels whose windows a V2 level's R reads run one row past
        # their range (that row is read by no stored cell), so that the
        # window has shifted on to the last output row
        past = g.tail if g.factor and t % 2 == 0 and t < L else 0
        o.append(f"    {{  // level {t} of {L}: rows [{y_first}, "
                 f"{y_first + rows}) x quads [{q_first}, {q_first + qw})")
        o.append(f"      const int p = s - {t * (r + 1)};")
        o.append(f"      if (p >= {t * r} && p < n0 + "
                 f"{2 * H - t * r + past}) {{")
        if planes:
            o.append(f"        const float* const in = smem + {t - 1} * "
                     "RING * PLANE;")
        for d0 in planes:
            o.append(f"        const float* const {_plane_name(d0)} = in + "
                     f"((p + {d0 + g.ring}) % RING) * PLANE;")
        if beside:
            o.append("        // the cells beside the thread's quad in its "
                     "own row, from the lanes")
            o.append("        // beside it: every lane shuffles")
        for name, d0, c, m in beside:
            o.append(f"        const float {name} = __shfl_"
                     f"{'up' if m < 0 else 'down'}_sync(0xffffffffu, "
                     f"w[{t - 1}][{d0 + wl - 1 - r}].{c}, {abs(m)});")
        if t == L:
            o.append("        const int g0 = a0 - H + p;  // in [a0, a1)")
        elif w3:
            o.append("        // the plane the level above reads newest a "
                     "step later")
            o.append(f"        float* const out = smem + ({t} * RING + "
                     f"(p + {woff}) % RING) * PLANE;")
        else:
            o.append(f"        float* const out = smem + ({t} * RING + "
                     "p % RING) * PLANE;")
        args = windows + [b[0] for b in beside] + [_plane_name(d)
                                                   for d in planes]
        if g.window:
            # one quad per thread; `do ... while (0)` gives the store's
            # `continue` somewhere to go
            rows_in = (f"row >= {y_first} && row < {y_first + rows} && "
                       if w3 else "")
            o.append(f"        if ({rows_in}q >= {q_first} && q < "
                     f"{q_first + qw}) do {{")
            o.append(f"          const float4 v = {fn}(" + ", ".join(
                args + ["4 * i" if w3 else "4 * q"]) + ");")
            if t == L:
                o += _store_lines(g, 0, "          ")
            elif w3:
                o += push(t, "v", "          ")
                o.append("          *reinterpret_cast<float4*>(out + 4 * i) = "
                         f"w[{t}][WRITE];")
            else:
                o.append("          *reinterpret_cast<float4*>(out + 4 * q) "
                         "= v;")
                o += push(t, "v", "          ")
            o.append("        } while (0);")
        else:
            o.append(f"        for (int i = threadIdx.x; i < {rows * qw}; "
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
            if t == L:
                o.append(f"          const float4 v = {call};")
                o += _store_lines(g, y_first, "          ")
            else:
                o.append(f"          *reinterpret_cast<float4*>(out + at) = "
                         f"{call};")
            o.append("        }")
        o.append("      }")
        o.append("    }")
    if w3:
        o.append("    if (feed && i < PLANE_QUADS) {")
        o += push(0, feed.own, "      ")
        o.append(f"      *reinterpret_cast<float4*>(smem + ((s + {woff}) % "
                 "RING) * PLANE + 4 * i) =")
        o.append("          w[0][WRITE];")
    else:
        o.append("    if (feed) {")
        o += feed.stage
        # a narrow strip has more threads than quads
        if g.partial:
            o.append(f"      if (q < PLANE_QUADS) cur[0] = {feed.own};")
        elif g.window:
            o.append("      if (q < PLANE_QUADS) {")
            o += push(0, feed.own, "        ")
            o.append("      }")
    o.append("    }")
    o += feed.end_step(end)
    o += ["    __syncthreads();", "  }"]
    if g.partial:
        # the unrolled steps one level deeper
        o[body:] = [ln if ln.startswith("#") else "  " + ln
                    for ln in o[body:]] + ["  }"]
    return o + ["}"]


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
        return _ctas_by_smem(self.smem_bytes, self.threads)

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
    fits = [ex for _, _, (_, ex) in _column_entries((rows, cols), h)
            if 4 * ring * ex <= SMEM_LIMIT]
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
    args = [f"const float* __restrict__ {_plane_name(di, "r")}" for di in dis]
    o.append("__device__ __forceinline__ float4 tile_quad("
             + ", ".join(args + ["int at"]) + ") {")
    o.append("  float " + ", ".join(f"g{k}_{j}" for k in range(len(groups))
                                    for j in range(QUAD)) + ";")
    started = set()
    for rid, di in enumerate(dis):
        here = [(k, dj, c) for k, (dj, rows) in enumerate(groups)
                for d, c in rows if d == di]
        lines, expr = _row_loads(rid, _plane_name(di, "r"), 0,
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
        o.append(f"    const float* const {_plane_name(di, "r")} = ring + "
                 f"((c + ({di})) % ROWS) * EX;")
    o.append("    const float4 v = tile_quad(" + ", ".join(
        [_plane_name(di, "r") for di in dis] + ["4 * q"]) + ");")
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
    o += _host_text("tile2d_kernel", g.grid, "strips, then segments",
                    "(const float*)src, (float*)dst")
    return "\n".join(o)


def source_hash(text: str) -> str:
    """What names a plan's build: the text and the compiler's flags."""
    return hashlib.sha256(
        (text + " ".join(NVCC_FLAGS)).encode()).hexdigest()[:16]
