// Hand-written Hopper kernel of the overlap experiment (sm_90a).  The
// plain-tile experiment's kernel, tile2d_fused, is built per table from
// specialised text (ops/codegen.tile2d_source).
//
// overlap_probe replaces the TPU kernel tuning/exp_overlap.py:59-65 (`kernel`
// of make(), called at :77, with level() of :35-55; K11).  It is a timing
// probe: per TM-row strip it computes level(level(window)), each level a 5-row
// x 5-column operator with fixed weights and columns that wrap, and writes
// rows [0, TM - 4*HK) of each TM-row output block; the other rows are never
// written.  Variant A reads aligned (TM, N) blocks, B overlapping (TM + 2*HK)
// -row windows of an (R + 2*HK, N) input, C is B plus a (HK, width) carry
// written per strip.  The question on the TPU was whether the pipeline overlaps
// the window's DMA with the two levels' compute; here it is whether a TMA
// window copy overlaps them.
//
// What bounds it: bytes.  A sweep must read the rows each strip needs and
// write its written rows (0.113 ms at 3.35 TB/s for 8192², TM 96, HK 8); the
// variant's whole window, which the experiment copies on purpose, makes it
// 0.133 ms (A) or 0.146 ms (B, C).  Two levels cost about 21 FP operations
// per cell each, so the compute must stay under the copy for the overlap to
// show.  The design:
//  - persistent CTAs loop over (strip, 64-column tile) pairs; a window row is
//    the tile and 4 wrapped columns a side, 72 floats.  A CTA is 8 warps
//    that compute and one that copies (warp specialisation): the copy
//    engine holds back the instruction that issues a copy while its queue
//    is full, and a warp that also computed would stall its CTA there;
//  - the copying warp waits for a buffer to be released ("empty" mbarrier),
//    arms its "full" mbarrier with the window's bytes (expect_tx) and
//    issues the copy; the computing warps wait on "full".  An inner tile's
//    window is one box of a 2D tensor map (cp.async.bulk.tensor, encoded on
//    the host through the runtime's CUDA driver entry point, no -lcuda): one
//    instruction per window, where one cp.async.bulk per 288-byte row kept
//    the copy engine's queue full.  The two edge tiles' columns wrap, so
//    their rows go as one cp.async.bulk per contiguous run (two or three);
//  - depth 1: one buffer, released after the whole tile, so its next window
//    is copied while nothing of this CTA computes (no overlap within a CTA
//    by design; three CTAs share an SM).  Depth 2: two buffers with a full
//    and an empty barrier each; a buffer is released once level 1 has read
//    it, and the next tile's window is copied while this one computes; the
//    phase parity flips with each use of a buffer;
//  - each level streams down rows: a thread owns 4 adjacent output columns
//    and a segment of rows, reads a source row as two aligned float4s into a
//    5-row register window, and computes the pre-sums and the three inners
//    once per (row, column) — the parent design recomputed them per column
//    shift.  Each output is in2[c] + in1[c+1] + in1[c-1] + in0[c+2] +
//    in0[c-2], each inner w2*p2 + w1*p1 + w0*p0: level()'s operations in its
//    order;
//  - level 1 goes to a shared scratch of the tile and 2 columns a side,
//    level 2 from there to the output block as float4 stores;
//  - 64-column tiles keep a CTA at 51-56 KB (depth 1: three CTAs per SM by
//    registers) or 79-88 KB (depth 2: two); the extra 8 columns per 64 are
//    the neighbours' and come mostly from L2.
// kLoad = false skips every copy (compute-only time).  The carry of variant C
// lives in shared memory, as the TPU's lives in VMEM, and is written out once
// per CTA at the end so that its stores stay alive.
//
// Interface: plain C, loaded with ctypes.  Each entry checks its arguments,
// launches on the given stream and returns cudaGetLastError() (0 = success).

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

// ---- TMA bulk copy and mbarrier (PTX) ----------------------------------------

#include <cuda.h>   // CUtensorMap; the CUDA driver API is reached through the runtime

// Describe the (rows, N) fp32 array `in` to the copy engine, in boxes of
// box_rows x box_cols, unswizzled.  The encoder is the CUDA driver API's, found
// through the runtime, so nothing links against libcuda.
typedef CUresult (*probe_encode_fn)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

static int probe_make_map(CUtensorMap* map, const float* in, int N, int rows,
                          int box_cols, int box_rows) {
  static probe_encode_fn encode = nullptr;
  if (!encode) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &fn, 12000, cudaEnableDefault, &found);
    if (err != cudaSuccess) return (int)err;
    if (found != cudaDriverEntryPointSuccess || !fn)
      return (int)cudaErrorNotSupported;
    encode = (probe_encode_fn)fn;
  }
  const cuuint64_t dims[2] = {(cuuint64_t)N, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)N * sizeof(float)};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t steps[2] = {1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<float*>(in), dims,
      strides, box, steps, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

__device__ __forceinline__ unsigned probe_smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// Arm the barrier for one arrival, then make it visible to the copy engine.
__device__ __forceinline__ void probe_bar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n"
               :: "r"(probe_smem_addr(bar)) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// The one arrival of a phase, which expects `bytes` of copies to complete it.
__device__ __forceinline__ void probe_bar_expect(uint64_t* bar,
                                                 unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(probe_smem_addr(bar)), "r"(bytes) : "memory");
}

// Copy `bytes` (a multiple of 16, both ends 16-byte aligned) from global to
// shared memory; completion is counted on `bar`.
__device__ __forceinline__ void probe_bulk_copy(void* dst, const void* src,
                                                unsigned bytes,
                                                uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(probe_smem_addr(dst)), "l"(src), "r"(bytes),
         "r"(probe_smem_addr(bar)) : "memory");
}

// Copy the box of `map` whose first element is (column c0, row r0) into
// `dst` (128-byte aligned), rows packed; completion is counted on `bar`.
__device__ __forceinline__ void probe_tensor_copy(void* dst,
                                                  const CUtensorMap* map,
                                                  int c0, int r0,
                                                  uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n"
      :: "r"(probe_smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(c0), "r"(r0), "r"(probe_smem_addr(bar)) : "memory");
}

// One arrival on `bar` (release: the caller's reads of the buffer it guards
// are done).
__device__ __forceinline__ void probe_bar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(probe_smem_addr(bar)) : "memory");
}

// Barrier 1 among the first `n` threads of the CTA (the producer warp is
// not among them).
__device__ __forceinline__ void probe_consumer_sync(int n) {
  asm volatile("bar.sync 1, %0;\n" :: "r"(n) : "memory");
}

// Wait until the phase of parity `parity` has completed.
__device__ __forceinline__ void probe_bar_wait(uint64_t* bar,
                                               unsigned parity) {
  const unsigned addr = probe_smem_addr(bar);
  unsigned done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(addr), "r"(parity) : "memory");
  } while (!done);
}

// ---- end of PTX ----------------------------------------------------------------

// ---- overlap_probe (K11) ----------------------------------------------------

#define PROBE_TW 64             // columns of one tile
#define PROBE_WX (PROBE_TW + 8) // window row: the tile and 4 wrapped columns a side
#define PROBE_SX (PROBE_TW + 4) // level-1 row: the tile and 2 columns a side
#define PROBE_CH 8              // the TPU level's rows per chunk: TM - 2*HK and
                                // TM - 4*HK are multiples of it
#define PROBE_THREADS 256       // the threads that compute
#define PROBE_BLOCK (PROBE_THREADS + 32)  // and one warp that copies

// One output row of 4 columns from 5 source rows of 8 columns (lo: columns
// 0-3, hi: 4-7; the outputs are columns 2-5): level()'s pre-sums and inners
// once per column, then its sum over the shifts (0, +1, -1, +2, -2).
__device__ __forceinline__ float4 probe_row(const float4* lo,
                                            const float4* hi, int k) {
  float v[5][8];
#pragma unroll
  for (int d = 0; d < 5; ++d) {
    const float4 a = lo[(k + d) % 5], b = hi[(k + d) % 5];
    v[d][0] = a.x; v[d][1] = a.y; v[d][2] = a.z; v[d][3] = a.w;
    v[d][4] = b.x; v[d][5] = b.y; v[d][6] = b.z; v[d][7] = b.w;
  }
  float in0[8], in1[8], in2[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float p2 = v[0][j] + v[4][j];
    const float p1 = v[1][j] + v[3][j];
    const float p0 = v[2][j];
    in0[j] = 0.02f * p2 + 0.05f * p1 + 0.1f * p0;
    if (j >= 1 && j <= 6) in1[j] = 0.05f * p2 + 0.1f * p1 + 0.2f * p0;
    if (j >= 2 && j <= 5) in2[j] = 0.1f * p2 + 0.2f * p1 + 0.3f * p0;
  }
  float o[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int c = i + 2;
    float acc = in2[c];
    acc = acc + in1[c + 1];
    acc = acc + in1[c - 1];
    acc = acc + in0[c + 2];
    acc = acc + in0[c - 2];
    o[i] = acc;
  }
  return make_float4(o[0], o[1], o[2], o[3]);
}

// One level on rows [r0, r1) of one quad: `src` points at the quad's first
// source column (8 columns are read), rows are `stride` floats apart; row r
// of the output needs source rows r .. r + 4.  store(r, value) writes it.
template <class Store>
__device__ __forceinline__ void probe_level(const float* __restrict__ src,
                                            int stride, int r0, int r1,
                                            Store store) {
  float4 lo[5], hi[5];
#pragma unroll
  for (int d = 0; d < 4; ++d) {
    const float* s = src + (size_t)(r0 + d) * stride;
    lo[d] = *reinterpret_cast<const float4*>(s);
    hi[d] = *reinterpret_cast<const float4*>(s + 4);
  }
  for (int r = r0; r < r1; r += 5) {
#pragma unroll
    for (int k = 0; k < 5; ++k) {
      if (r + k >= r1) break;
      const float* s = src + (size_t)(r + k + 4) * stride;
      lo[(k + 4) % 5] = *reinterpret_cast<const float4*>(s);
      hi[(k + 4) % 5] = *reinterpret_cast<const float4*>(s + 4);
      store(r + k, probe_row(lo, hi, k));
    }
  }
}

// The producer warp's lane `lane`: arm `bar` and copy tile `tile`'s window
// into `win`.  An inner tile's window is one box of `map`; an edge tile's
// columns wrap, so its rows go one bulk copy per contiguous run.
__device__ __forceinline__ void probe_issue(const CUtensorMap* map,
                                            const float* __restrict__ in,
                                            float* win, uint64_t* bar,
                                            int lane, int tile, int n_ctiles,
                                            int N, int TM, int wrows) {
  if (lane == 0) probe_bar_expect(bar, (unsigned)(wrows * PROBE_WX * 4));
  const int strip = tile / n_ctiles, ct = tile - strip * n_ctiles;
  if (ct > 0 && ct < n_ctiles - 1) {
    if (lane == 0)
      probe_tensor_copy(win, map, ct * PROBE_TW - 4, strip * TM, bar);
    return;
  }
  const float* base = in + (size_t)strip * TM * N;
  int c0 = ct * PROBE_TW - 4;
  if (c0 < 0) c0 += N;
  for (int r = lane; r < wrows; r += 32) {
    const float* row = base + (size_t)r * N;
    float* dst = win + r * PROBE_WX;
    int c = c0;
    for (int d = 0; d < PROBE_WX;) {
      const int run = min(PROBE_WX - d, N - c);
      probe_bulk_copy(dst + d, row + c, (unsigned)(run * 4), bar);
      d += run;
      c = 0;
    }
  }
}

// kVariant: 0 = A, 1 = B, 2 = C.  kDepth: 1 = one buffer, whose next copy
// starts once the tile is done (no overlap within a CTA); 2 = two buffers,
// the next tile's window copied while this one computes.  kLoad = false: no
// copies at all.  Threads [0, PROBE_THREADS) compute; the last warp copies.
// full[b] completes when buffer b's window has landed, empty[b] when the
// computing threads have done reading it.
template <int kVariant, int kDepth, bool kLoad>
__global__ void __launch_bounds__(PROBE_BLOCK, 3)
overlap_probe_kernel(const __grid_constant__ CUtensorMap map,
                     const float* __restrict__ in, float* __restrict__ out,
                     float* __restrict__ carry, int N, int TM, int HK,
                     int n_strips, int n_ctiles) {
  extern __shared__ __align__(128) float smem[];
  const int wrows = kVariant == 0 ? TM : TM + 2 * HK;
  const int rows1 = TM - 2 * HK, rows2 = TM - 4 * HK;
  // windows first: a box lands 128-byte aligned (wrows is a multiple of 4,
  // so a window is a multiple of 128 bytes)
  float* const win0 = smem;
  float* const scr = win0 + kDepth * wrows * PROBE_WX;
  float* const carry_s = scr + rows1 * PROBE_SX;
  uint64_t* const full = reinterpret_cast<uint64_t*>(carry_s + HK * PROBE_TW);
  uint64_t* const empty = full + 2;
  const int ntiles = n_strips * n_ctiles;
  const int tid = threadIdx.x;

  if (kLoad) {
    if (tid == 0)
      for (int b = 0; b < 2; ++b) {
        probe_bar_init(&full[b]);
        probe_bar_init(&empty[b]);
      }
  } else {
    for (int i = tid; i < kDepth * wrows * PROBE_WX; i += PROBE_BLOCK)
      win0[i] = 1.0f;
  }
  __syncthreads();

  if (tid >= PROBE_THREADS) {   // the producer warp
    if (kLoad) {
      int it = 0;
      for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x, ++it) {
        const int buf = it % kDepth, use = it / kDepth;
        if (use > 0) probe_bar_wait(&empty[buf], (unsigned)((use - 1) & 1));
        probe_issue(&map, in, win0 + buf * wrows * PROBE_WX, &full[buf],
                    tid - PROBE_THREADS, tile, n_ctiles, N, TM, wrows);
      }
    }
    return;
  }

  // this thread's task in each level: a quad of columns and a row segment
  constexpr int q1n = PROBE_SX / 4, q2n = PROBE_TW / 4;
  const int seg1 = min(rows1, PROBE_THREADS / q1n);
  const int seg2 = min(rows2, PROBE_THREADS / q2n);
  const int q1 = tid % q1n, s1 = tid / q1n;
  const int q2 = tid % q2n, s2 = tid / q2n;

  int it = 0;
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x, ++it) {
    const int buf = it % kDepth, use = it / kDepth;
    float* const win = win0 + buf * wrows * PROBE_WX;
    if (kLoad) probe_bar_wait(&full[buf], (unsigned)(use & 1));

    // level 1: window rows -> scr rows [0, TM - 2*HK), the tile and 2
    // columns a side (scr column j is window column j + 2)
    if (s1 < seg1) {
      float* const dst = scr + 4 * q1;
      probe_level(win + 4 * q1, PROBE_WX, s1 * rows1 / seg1,
                  (s1 + 1) * rows1 / seg1, [&](int r, float4 v) {
                    *reinterpret_cast<float4*>(dst + r * PROBE_SX) = v;
                  });
    }
    if (kVariant == 2)
      for (int i = tid; i < HK * PROBE_TW; i += PROBE_THREADS) {
        const int r = i / PROBE_TW, x = i - r * PROBE_TW;
        carry_s[i] = win[r * PROBE_WX + x + 4] * 0.5f;
      }
    probe_consumer_sync(PROBE_THREADS);   // scr written, win[buf] read
    if (kLoad && kDepth == 2 && tid == 0) probe_bar_arrive(&empty[buf]);

    // level 2: scr -> rows [0, TM - 4*HK) of the strip's output block
    if (s2 < seg2) {
      const int strip = tile / n_ctiles, ct = tile - strip * n_ctiles;
      float* const dst = out + (size_t)strip * TM * N + ct * PROBE_TW + 4 * q2;
      probe_level(scr + 4 * q2, PROBE_SX, s2 * rows2 / seg2,
                  (s2 + 1) * rows2 / seg2, [&](int r, float4 v) {
                    *reinterpret_cast<float4*>(dst + (size_t)r * N) = v;
                  });
    }
    probe_consumer_sync(PROBE_THREADS);   // scr is free for the next tile
    if (kLoad && kDepth == 1 && tid == 0) probe_bar_arrive(&empty[buf]);
  }
  if (kVariant == 2 && (int)blockIdx.x < ntiles)
    for (int i = tid; i < HK * PROBE_TW; i += PROBE_THREADS)
      carry[(size_t)blockIdx.x * HK * PROBE_TW + i] = carry_s[i];
}

static size_t probe_smem(int variant, int depth, int TM, int HK) {
  const int wrows = variant == 0 ? TM : TM + 2 * HK;
  return 32 + ((size_t)depth * wrows * PROBE_WX +
               (size_t)(TM - 2 * HK) * PROBE_SX + (size_t)HK * PROBE_TW) *
                  sizeof(float);
}

// The instantiation of (variant, depth, load), as a kernel pointer.
typedef void (*probe_fn)(const CUtensorMap, const float*, float*, float*, int,
                         int, int, int, int);

template <int kVariant>
static probe_fn probe_kernel_of(int depth, int load) {
  if (depth == 1)
    return load ? overlap_probe_kernel<kVariant, 1, true>
                : overlap_probe_kernel<kVariant, 1, false>;
  return load ? overlap_probe_kernel<kVariant, 2, true>
              : overlap_probe_kernel<kVariant, 2, false>;
}

static probe_fn probe_kernel(int variant, int depth, int load) {
  if (variant == 0) return probe_kernel_of<0>(depth, load);
  if (variant == 1) return probe_kernel_of<1>(depth, load);
  return probe_kernel_of<2>(depth, load);
}

static bool probe_sizes_ok(int variant, int depth, int TM, int HK) {
  return variant >= 0 && variant <= 2 && depth >= 1 && depth <= 2 &&
         HK >= 2 && TM > 4 * HK && (TM - 2 * HK) % PROBE_CH == 0 &&
         (TM - 4 * HK) % PROBE_CH == 0;
}

extern "C" {

// The sizes ops/kernels.py must agree with: 0 = the probe's tile width,
// 1 = its rows per chunk.
int experiments_limit(int what) {
  const int limits[2] = {PROBE_TW, PROBE_CH};
  return what >= 0 && what < 2 ? limits[what] : -1;
}

const char* experiments_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// What one instantiation takes: info[0] = CTAs per SM (the runtime's
// occupancy, registers and shared memory both counted), info[1] = registers
// per thread, info[2] = shared memory per CTA in bytes, info[3] = local
// (spill) bytes per thread.
int overlap_probe_info(int variant, int depth, int load, int TM, int HK,
                       int* info) {
  if (!probe_sizes_ok(variant, depth, TM, HK))
    return (int)cudaErrorInvalidValue;
  const probe_fn k = probe_kernel(variant, depth, load);
  const size_t smem = probe_smem(variant, depth, TM, HK);
  cudaError_t err = cudaFuncSetAttribute(
      k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, k);
  if (err != cudaSuccess) return (int)err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, k,
                                                      PROBE_BLOCK, smem);
  if (err != cudaSuccess) return (int)err;
  info[0] = per_sm;
  info[1] = attr.numRegs;
  info[2] = (int)smem;
  info[3] = (int)attr.localSizeBytes;
  return 0;
}

// in is (R, N) for variant 0 and (R + 2*HK, N) for variants 1 and 2, 16-byte
// aligned; out is (R, N); carry is (n_ctas, HK, 64), written by variant 2
// only.  depth is 1 or 2; load = 0 skips the window copies.
int overlap_probe(const float* in, float* out, float* carry, int R, int N,
                  int TM, int HK, int variant, int depth, int load,
                  int n_ctas, void* stream) {
  if (!probe_sizes_ok(variant, depth, TM, HK) || R < TM || N < PROBE_TW ||
      N % PROBE_TW || n_ctas < 1 || n_ctas > (R / TM) * (N / PROBE_TW) ||
      ((uintptr_t)in & 15) || ((uintptr_t)out & 15))
    return (int)cudaErrorInvalidValue;
  const probe_fn k = probe_kernel(variant, depth, load);
  const size_t smem = probe_smem(variant, depth, TM, HK);
  cudaError_t err = cudaFuncSetAttribute(
      k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int wrows = variant == 0 ? TM : TM + 2 * HK;
  CUtensorMap map;
  const int bad = probe_make_map(&map, in, N, variant == 0 ? R : R + 2 * HK,
                                 PROBE_WX, wrows);
  if (bad) return bad;
  k<<<n_ctas, PROBE_BLOCK, smem, (cudaStream_t)stream>>>(
      map, in, out, carry, N, TM, HK, R / TM, N / PROBE_TW);
  return (int)cudaGetLastError();
}

}  // extern "C"
