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
// the window's DMA with the two levels' compute.  Hopper's form of it:
// persistent CTAs loop over (strip, 128-column tile) pairs; depth 1 loads each
// window into shared memory synchronously (load, barrier, compute); depth 2
// starts the NEXT tile's window copy with cp.async into a second buffer while the
// current one computes.  kLoad = false skips every load (compute-only time).
// The carry of variant C lives in shared memory, as the TPU's lives in VMEM,
// and is written out once per CTA at the end so that its stores stay alive.
// Bound: bytes (the rows a strip needs read once, its 64 rows written once).
//
// Interface: plain C, loaded with ctypes.  Each entry checks its arguments,
// launches on the given stream and returns cudaGetLastError() (0 = success).

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stddef.h>

// ---- overlap_probe (K11) ----------------------------------------------------

#define PROBE_TW 128            // columns of one tile
#define PROBE_WX (PROBE_TW + 8) // window row: the tile and 4 wrapped columns a side
#define PROBE_SX (PROBE_TW + 4) // level-1 row: the tile and 2 columns a side
#define PROBE_CH 8              // rows one thread computes at a time

// One level for PROBE_CH rows at one column: exp_overlap.py's level(), the
// columns taken in its order (0, +1, -1, +2, -2).  `in` points at the first
// source row of the chunk, at the column of shift 0; rows are `stride` apart.
__device__ __forceinline__ void probe_level(const float* __restrict__ in,
                                            int stride, float* acc) {
  const int shift[5] = {0, 1, -1, 2, -2};
  // weights of (p2, p1, p0) by |shift|: inners[2], inners[1], inners[0]
  const float w2[3] = {0.1f, 0.05f, 0.02f};
  const float w1[3] = {0.2f, 0.1f, 0.05f};
  const float w0[3] = {0.3f, 0.2f, 0.1f};
#pragma unroll
  for (int s = 0; s < 5; ++s) {
    const int a = shift[s] < 0 ? -shift[s] : shift[s];
    float v[PROBE_CH + 4];
#pragma unroll
    for (int i = 0; i < PROBE_CH + 4; ++i) v[i] = in[i * stride + shift[s]];
#pragma unroll
    for (int k = 0; k < PROBE_CH; ++k) {
      const float p2 = v[k] + v[k + 4];
      const float p1 = v[k + 1] + v[k + 3];
      const float p0 = v[k + 2];
      const float inner = w2[a] * p2 + w1[a] * p1 + w0[a] * p0;
      acc[k] = s == 0 ? inner : acc[k] + inner;
    }
  }
}

// Start the copy of tile `tile`'s window into `win`: 16-byte pieces, whole
// pieces wrap (the tile starts at a multiple of 4 columns and N % 4 == 0).
template <bool kAsync>
__device__ __forceinline__ void probe_load(const float* __restrict__ in,
                                           float* win, int tile, int n_ctiles,
                                           int N, int TM, int wrows) {
  const int strip = tile / n_ctiles, ct = tile - strip * n_ctiles;
  const int pieces = PROBE_WX / 4;
  const float* base = in + (size_t)strip * TM * N;
  for (int idx = threadIdx.x; idx < wrows * pieces; idx += 256) {
    const int r = idx / pieces, q = idx - r * pieces;
    int gc = ct * PROBE_TW - 4 + 4 * q;
    if (gc < 0) gc += N;
    if (gc >= N) gc -= N;
    const float* s = base + (size_t)r * N + gc;
    float* d = win + r * PROBE_WX + 4 * q;
    if (kAsync)
      __pipeline_memcpy_async(d, s, 16);
    else
      *reinterpret_cast<float4*>(d) = *reinterpret_cast<const float4*>(s);
  }
}

// kVariant: 0 = A, 1 = B, 2 = C.  kDepth: 1 = synchronous window load, 2 =
// the next window prefetched with cp.async.  kLoad = false: no loads at all.
template <int kVariant, int kDepth, bool kLoad>
__global__ void __launch_bounds__(256)
overlap_probe_kernel(const float* __restrict__ in, float* __restrict__ out,
                     float* __restrict__ carry, int N, int TM, int HK,
                     int n_strips, int n_ctiles) {
  extern __shared__ __align__(16) float smem[];
  const int wrows = kVariant == 0 ? TM : TM + 2 * HK;
  const int rows1 = TM - 2 * HK, rows2 = TM - 4 * HK;
  float* const win0 = smem;
  float* const scr = smem + kDepth * wrows * PROBE_WX;
  float* const carry_s = scr + rows1 * PROBE_SX;
  const int ntiles = n_strips * n_ctiles;
  const int tid = threadIdx.x;

  if (!kLoad) {
    for (int i = tid; i < kDepth * wrows * PROBE_WX; i += 256) smem[i] = 1.0f;
    __syncthreads();
  }
  int tile = blockIdx.x;
  if (kLoad && kDepth == 2 && tile < ntiles) {
    probe_load<true>(in, win0, tile, n_ctiles, N, TM, wrows);
    __pipeline_commit();
  }
  int buf = 0;
  for (; tile < ntiles; tile += gridDim.x) {
    float* const win = win0 + buf * wrows * PROBE_WX;
    if (kLoad && kDepth == 2) {
      const int next = tile + gridDim.x;
      if (next < ntiles)
        probe_load<true>(in, win0 + (buf ^ 1) * wrows * PROBE_WX, next,
                         n_ctiles, N, TM, wrows);
      __pipeline_commit();
      __pipeline_wait_prior(1);   // all but the newest group: this tile's
    } else if (kLoad) {
      probe_load<false>(in, win, tile, n_ctiles, N, TM, wrows);
    }
    __syncthreads();

    // level 1: window rows -> scr rows [0, TM - 2*HK), the tile and 2 columns
    for (int task = tid; task < (rows1 / PROBE_CH) * PROBE_SX; task += 256) {
      const int chunk = task / PROBE_SX, x = task - chunk * PROBE_SX;
      float acc[PROBE_CH];
      probe_level(win + chunk * PROBE_CH * PROBE_WX + x + 2, PROBE_WX, acc);
#pragma unroll
      for (int k = 0; k < PROBE_CH; ++k)
        scr[(chunk * PROBE_CH + k) * PROBE_SX + x] = acc[k];
    }
    if (kVariant == 2)
      for (int i = tid; i < HK * PROBE_TW; i += 256) {
        const int r = i / PROBE_TW, x = i - r * PROBE_TW;
        carry_s[i] = win[r * PROBE_WX + x + 4] * 0.5f;
      }
    __syncthreads();

    // level 2: scr -> rows [0, TM - 4*HK) of the strip's output block
    const int strip = tile / n_ctiles, ct = tile - strip * n_ctiles;
    float* const obase = out + (size_t)strip * TM * N + ct * PROBE_TW;
    for (int task = tid; task < (rows2 / PROBE_CH) * PROBE_TW; task += 256) {
      const int chunk = task / PROBE_TW, x = task - chunk * PROBE_TW;
      float acc[PROBE_CH];
      probe_level(scr + chunk * PROBE_CH * PROBE_SX + x + 2, PROBE_SX, acc);
#pragma unroll
      for (int k = 0; k < PROBE_CH; ++k)
        obase[(size_t)(chunk * PROBE_CH + k) * N + x] = acc[k];
    }
    __syncthreads();   // win[buf] and scr are free for the next tile
    if (kDepth == 2) buf ^= 1;
  }
  if (kVariant == 2 && (int)blockIdx.x < ntiles)
    for (int i = tid; i < HK * PROBE_TW; i += 256)
      carry[(size_t)blockIdx.x * HK * PROBE_TW + i] = carry_s[i];
}

template <int kVariant, int kDepth, bool kLoad>
static int launch_probe(const float* in, float* out, float* carry, int R,
                        int N, int TM, int HK, int n_ctas, void* stream) {
  const int n_strips = R / TM, n_ctiles = N / PROBE_TW;
  const int wrows = kVariant == 0 ? TM : TM + 2 * HK;
  const size_t smem =
      ((size_t)kDepth * wrows * PROBE_WX + (size_t)(TM - 2 * HK) * PROBE_SX +
       (size_t)HK * PROBE_TW) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      overlap_probe_kernel<kVariant, kDepth, kLoad>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  overlap_probe_kernel<kVariant, kDepth, kLoad>
      <<<n_ctas, 256, smem, (cudaStream_t)stream>>>(
      in, out, carry, N, TM, HK, n_strips, n_ctiles);
  return (int)cudaGetLastError();
}

template <int kVariant>
static int dispatch_probe(const float* in, float* out, float* carry, int R,
                          int N, int TM, int HK, int depth, int load,
                          int n_ctas, void* stream) {
  if (depth == 1 && load)
    return launch_probe<kVariant, 1, true>(in, out, carry, R, N, TM, HK,
                                           n_ctas, stream);
  if (depth == 2 && load)
    return launch_probe<kVariant, 2, true>(in, out, carry, R, N, TM, HK,
                                           n_ctas, stream);
  if (depth == 1)
    return launch_probe<kVariant, 1, false>(in, out, carry, R, N, TM, HK,
                                            n_ctas, stream);
  return launch_probe<kVariant, 2, false>(in, out, carry, R, N, TM, HK,
                                          n_ctas, stream);
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

// in is (R, N) for variant 0 and (R + 2*HK, N) for variants 1 and 2; out is
// (R, N); carry is (n_ctas, HK, 128), written by variant 2 only.  depth is 1
// or 2; load = 0 skips the window loads.
int overlap_probe(const float* in, float* out, float* carry, int R, int N,
                  int TM, int HK, int variant, int depth, int load,
                  int n_ctas, void* stream) {
  if (variant < 0 || variant > 2 || depth < 1 || depth > 2 || HK < 2 ||
      TM <= 4 * HK || (TM - 2 * HK) % PROBE_CH || (TM - 4 * HK) % PROBE_CH ||
      R < TM || N < PROBE_TW || N % PROBE_TW || n_ctas < 1 ||
      n_ctas > (R / TM) * (N / PROBE_TW))
    return (int)cudaErrorInvalidValue;
  if (variant == 0)
    return dispatch_probe<0>(in, out, carry, R, N, TM, HK, depth, load,
                             n_ctas, stream);
  if (variant == 1)
    return dispatch_probe<1>(in, out, carry, R, N, TM, HK, depth, load,
                             n_ctas, stream);
  return dispatch_probe<2>(in, out, carry, R, N, TM, HK, depth, load, n_ctas,
                           stream);
}

}  // extern "C"
