// Hand-written Hopper stencil kernels of drstencil_tpu_torch (sm_90a).
//
// Replaces the TPU kernel drstencil_tpu/ops/stream.py:568-803 (the Pallas
// `kernel` closure of build_stream_kernel, called at stream.py:858) in all
// of its main-path modes: K1 single fused level, K2 scratch trapezoid, K3
// value-fused trapezoid, K4 deep trapezoid and K7 block-hybrid levels.
// stencil2d_levels_kernel takes 2D grids, stencil3d_levels_kernel 3D ones.
// Both are templates on the storage type: float (the fp32 builds) and
// __nv_bfloat16 (the bf16 builds, the TPU kernel's dtype="bfloat16").  Its
// two remaining builds follow further down: the shard-local entries (K8)
// and stencil2d_factor_levels_kernel (K6).
//
// What both compute: `levels` applications of one linear tap operator to
// the interior [H, dim-H) of every axis, H = frame = levels * reach.  Every
// cell within H of a face keeps dst's value (a frozen Dirichlet frame).
// Intermediate levels are unbounded: out-of-domain source cells read as 0,
// and whatever that feeds lands only on frame cells, which are never stored.
//
// Design: one CTA per output tile.  It loads its tile plus a halo of H into
// shared memory (masked to 0 outside the domain), computes levels
// 1..levels-1 in shared memory over regions that shrink by `reach` per
// level, ping-ponging two buffers, then computes the last level and stores
// only the cells inside [H, dim-H).  None of the TPU kernel's mechanics
// survive: no tall layout, lane rolls, straddle carry, frame slabs or
// j-frame read-modify-write — the frame falls out of never writing it.
//
// Storage and arithmetic: the TPU kernel loads bf16 state as fp32
// (drstencil_tpu/ops/stream.py:604-617), keeps every level in fp32 scratch
// (:866) and rounds once at the store (:652).  Here too: the load
// converts to fp32 (__bfloat162float), shared memory and every level stay
// fp32, and the last level rounds to nearest even once at the store
// (__float2bfloat16_rn, as XLA's convert does).  The tap table stays fp32.
//
// Bound: per launch the function reads src once and writes dst once,
// 2 * item * cells bytes over HBM (3.35 TB/s on H100 SXM), and does
// 2 * taps * levels * cells flops on fp32 CUDA cores (67 TFLOP/s).  The
// tuned winners' tables (<= 27 taps, <= 6 levels) sit near the bytes side
// of that line.  This first kernel re-reads shared memory once per tap and
// recomputes the halo of every tile at every level; a streamed revolving
// window along axis 0 and TMA loads are later work.
//
// Shard-local entries (stencil{2,3}d_levels_shard[_bf16]) replace the TPU
// kernel's row_frame=False build (drstencil_tpu/ops/stream.py:403-417, 570,
// 759, 828, 883-898; the multi-device path's K8).  The TPU build drops the
// lo/hi slab inputs and the pl.when row-frame stores and leans on the padded
// tall layout for halo rows.  Here the function is: src and dst are one
// shard's slab with H ghost rows (planes in 3D) on each side of axis 0, and
// the kernel stores every cell whose axis-0 index lies in [s_lo, s_hi), a
// range the caller derives from the shard's place in the mesh; the off-axis
// frame stays frozen as above, and cells outside the slab read as 0.  It is
// the same tile kernel, instantiated with kShard = true: the range comes
// from the caller in place of [H, dim-H), and a CTA whose tile lies outside
// it returns before loading.  Bound: as above, on the slab's cells.
//
// Factor mode (stencil2d_factor_levels[_bf16]) replaces the TPU kernel's
// factor=True build (drstencil_tpu/ops/stream.py:446-474, 491, 683-714; K6).
// A 2D radius-2 operator W is applied as W = V1*V2 + R (ir/factor.py): per
// timestep one level of the 3x3 table V1, then one of V2 that adds the
// residual R (at most 5 taps on axis 0, reach 2) read from the level TWO
// back.  `levels` = 2*step levels of reach 1, H = levels.  Three fp32 tiles
// rotate in shared memory so that level t-2 is alive while level t is
// written; level t covers local [t, E-t), exactly 2 cells inside level t-2's
// region, which is what R's reach needs.  Bound: 2 * item * cells bytes, or
// 2 * (|V1|+|V2|+|R|) * step * cells fp32 flops.  What the mode trades on
// Hopper is 25 shared-memory loads per cell and step against 9 + 9 + 5, for
// one more level's barrier and halo recompute and a third tile.
//
// Interface: plain C, loaded with ctypes.  Each entry checks its arguments,
// launches on the given stream and returns cudaGetLastError() (0 = success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

#define MAX_TAPS 256

// Tap table passed by value as a kernel parameter (constant bank): linear
// offsets into the shared-memory tile and fp32 coefficients, in the sorted
// order of ops/stream.py so that sums run in the plain version's order.
struct TapTable {
  int n;
  int off[MAX_TAPS];
  float coef[MAX_TAPS];
};

__device__ __forceinline__ float apply_taps(const float* __restrict__ in,
                                            int at, const TapTable& t) {
  float acc = 0.0f;
  for (int k = 0; k < t.n; ++k) acc = fmaf(t.coef[k], in[at + t.off[k]], acc);
  return acc;
}

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <typename T, bool kShard>
__global__ void __launch_bounds__(256)
stencil2d_levels_kernel(const T* __restrict__ src, T* __restrict__ dst,
                        int M, int N, int levels, int reach, int H,
                        int TY, int TX, int s_lo, int s_hi,
                        const __grid_constant__ TapTable taps) {
  extern __shared__ float smem[];
  // the axis-0 store range: the caller's for a shard, else the interior
  const int lo0 = kShard ? s_lo : H, hi0 = kShard ? s_hi : M - H;
  // a shard's tile with nothing to store: uniform over the block
  if (kShard &&
      ((int)blockIdx.y * TY >= hi0 || (int)blockIdx.y * TY + TY <= lo0))
    return;
  const int EY = TY + 2 * H, EX = TX + 2 * H;
  float* const buf0 = smem;
  float* const buf1 = smem + EY * EX;
  // global coordinates of the tile's local (0, 0)
  const int y0 = (int)blockIdx.y * TY - H;
  const int x0 = (int)blockIdx.x * TX - H;

  for (int ly = threadIdx.y; ly < EY; ly += blockDim.y) {
    const int gy = y0 + ly;
    const bool row_in = gy >= 0 && gy < M;
    for (int lx = threadIdx.x; lx < EX; lx += blockDim.x) {
      const int gx = x0 + lx;
      buf0[ly * EX + lx] = (row_in && gx >= 0 && gx < N)
                                  ? load_f32(src + (size_t)gy * N + gx) : 0.0f;
    }
  }
  __syncthreads();

  // intermediate level t covers local [t*reach, E - t*reach) on each axis
  for (int t = 1; t < levels; ++t) {
    const float* in = (t & 1) ? buf0 : buf1;
    float* out = (t & 1) ? buf1 : buf0;
    const int lo = t * reach;
    for (int ly = lo + threadIdx.y; ly < EY - lo; ly += blockDim.y)
      for (int lx = lo + threadIdx.x; lx < EX - lo; lx += blockDim.x)
        out[ly * EX + lx] = apply_taps(in, ly * EX + lx, taps);
    __syncthreads();
  }

  // last level: the output tile, stored only inside [lo0, hi0) x [H, N-H)
  const float* in = (levels & 1) ? buf0 : buf1;
  for (int ly = H + threadIdx.y; ly < H + TY; ly += blockDim.y) {
    const int gy = y0 + ly;
    if (gy < lo0 || gy >= hi0) continue;
    for (int lx = H + threadIdx.x; lx < H + TX; lx += blockDim.x) {
      const int gx = x0 + lx;
      if (gx < H || gx >= N - H) continue;
      store_f32(dst + (size_t)gy * N + gx, apply_taps(in, ly * EX + lx, taps));
    }
  }
}

template <typename T, bool kShard>
__global__ void __launch_bounds__(256)
stencil3d_levels_kernel(const T* __restrict__ src, T* __restrict__ dst,
                        int D, int M, int N, int levels, int reach, int H,
                        int TZ, int TY, int TX, int s_lo, int s_hi,
                        const __grid_constant__ TapTable taps) {
  extern __shared__ float smem[];
  const int lo0 = kShard ? s_lo : H, hi0 = kShard ? s_hi : D - H;
  if (kShard &&
      ((int)blockIdx.z * TZ >= hi0 || (int)blockIdx.z * TZ + TZ <= lo0))
    return;
  const int EZ = TZ + 2 * H, EY = TY + 2 * H, EX = TX + 2 * H;
  const int plane = EY * EX;
  float* const buf0 = smem;
  float* const buf1 = smem + EZ * plane;
  const int z0 = (int)blockIdx.z * TZ - H;
  const int y0 = (int)blockIdx.y * TY - H;
  const int x0 = (int)blockIdx.x * TX - H;

  // rows of the tile are (z, y) pairs; threadIdx.x walks x within a row
  for (int row = threadIdx.y; row < EZ * EY; row += blockDim.y) {
    const int lz = row / EY, ly = row - lz * EY;
    const int gz = z0 + lz, gy = y0 + ly;
    const bool row_in = gz >= 0 && gz < D && gy >= 0 && gy < M;
    const T* grow = row_in ? src + ((size_t)gz * M + gy) * N : src;
    float* srow = buf0 + lz * plane + ly * EX;
    for (int lx = threadIdx.x; lx < EX; lx += blockDim.x) {
      const int gx = x0 + lx;
      srow[lx] = (row_in && gx >= 0 && gx < N) ? load_f32(grow + gx) : 0.0f;
    }
  }
  __syncthreads();

  for (int t = 1; t < levels; ++t) {
    const float* in = (t & 1) ? buf0 : buf1;
    float* out = (t & 1) ? buf1 : buf0;
    const int lo = t * reach;
    const int ny = EY - 2 * lo, nrows = (EZ - 2 * lo) * ny;
    for (int row = threadIdx.y; row < nrows; row += blockDim.y) {
      const int lz = lo + row / ny, ly = lo + row % ny;
      const int at = lz * plane + ly * EX;
      for (int lx = lo + threadIdx.x; lx < EX - lo; lx += blockDim.x)
        out[at + lx] = apply_taps(in, at + lx, taps);
    }
    __syncthreads();
  }

  const float* in = (levels & 1) ? buf0 : buf1;
  for (int row = threadIdx.y; row < TZ * TY; row += blockDim.y) {
    const int lz = H + row / TY, ly = H + row % TY;
    const int gz = z0 + lz, gy = y0 + ly;
    if (gz < lo0 || gz >= hi0 || gy < H || gy >= M - H) continue;
    const int at = lz * plane + ly * EX;
    T* drow = dst + ((size_t)gz * M + gy) * N;
    for (int lx = H + threadIdx.x; lx < H + TX; lx += blockDim.x) {
      const int gx = x0 + lx;
      if (gx < H || gx >= N - H) continue;
      store_f32(drow + gx, apply_taps(in, at + lx, taps));
    }
  }
}

// Factor mode's three tables, by value: V1 and V2 (3x3, <= 9 taps) and the
// residual R (<= 5 taps), as linear offsets into the tile and fp32
// coefficients in ir/factor.py's sorted order.
#define MAX_FACTOR_TAPS 9
struct SmallTable {
  int n;
  int off[MAX_FACTOR_TAPS];
  float coef[MAX_FACTOR_TAPS];
};
struct FactorTables {
  SmallTable v1, v2, r;
};

__device__ __forceinline__ float apply_small(const float* __restrict__ in,
                                             int at, const SmallTable& t) {
  float acc = 0.0f;
  for (int k = 0; k < t.n; ++k) acc = fmaf(t.coef[k], in[at + t.off[k]], acc);
  return acc;
}

// Level t (1-based) of factor mode at tile cell `at`: V1 of level t-1 for
// odd t; V2 of level t-1 plus R of level t-2 for even t.
__device__ __forceinline__ float factor_level(const float* __restrict__ in,
                                              const float* __restrict__ prev,
                                              int at, bool odd,
                                              const FactorTables& f) {
  if (odd) return apply_small(in, at, f.v1);
  return apply_small(in, at, f.v2) + apply_small(prev, at, f.r);
}

template <typename T>
__global__ void __launch_bounds__(256)
stencil2d_factor_levels_kernel(const T* __restrict__ src, T* __restrict__ dst,
                               int M, int N, int levels, int H, int TY,
                               int TX, const __grid_constant__ FactorTables f) {
  extern __shared__ float smem[];
  const int EY = TY + 2 * H, EX = TX + 2 * H, E = EY * EX;
  const int y0 = (int)blockIdx.y * TY - H;
  const int x0 = (int)blockIdx.x * TX - H;

  // level 0 (the source, 0 outside the domain) into tile 0
  for (int ly = threadIdx.y; ly < EY; ly += blockDim.y) {
    const int gy = y0 + ly;
    const bool row_in = gy >= 0 && gy < M;
    for (int lx = threadIdx.x; lx < EX; lx += blockDim.x) {
      const int gx = x0 + lx;
      smem[ly * EX + lx] = (row_in && gx >= 0 && gx < N)
                               ? load_f32(src + (size_t)gy * N + gx) : 0.0f;
    }
  }
  __syncthreads();

  // level t lives in tile t % 3 and covers local [t, E - t) on each axis;
  // it reads level t-1 and, on even t, level t-2 (tile (t+1) % 3) at reach 2
  for (int t = 1; t < levels; ++t) {
    const float* in = smem + ((t - 1) % 3) * E;
    const float* prev = smem + ((t + 1) % 3) * E;
    float* out = smem + (t % 3) * E;
    const bool odd = t & 1;
    for (int ly = t + threadIdx.y; ly < EY - t; ly += blockDim.y)
      for (int lx = t + threadIdx.x; lx < EX - t; lx += blockDim.x)
        out[ly * EX + lx] = factor_level(in, prev, ly * EX + lx, odd, f);
    __syncthreads();
  }

  // last level (even: V2 + R), stored only inside [H, dim-H)
  const float* in = smem + ((levels - 1) % 3) * E;
  const float* prev = smem + ((levels + 1) % 3) * E;
  for (int ly = H + threadIdx.y; ly < H + TY; ly += blockDim.y) {
    const int gy = y0 + ly;
    if (gy < H || gy >= M - H) continue;
    for (int lx = H + threadIdx.x; lx < H + TX; lx += blockDim.x) {
      const int gx = x0 + lx;
      if (gx < H || gx >= N - H) continue;
      store_f32(dst + (size_t)gy * N + gx,
                factor_level(in, prev, ly * EX + lx, false, f));
    }
  }
}

// Fill the by-value tap table: offsets (ntaps x ndim, row-major, axis 0
// first) become linear offsets into a tile of extents ext[0..ndim).
static bool fill_table(TapTable* t, const int* offsets, const float* coefs,
                       int ntaps, int ndim, const int* ext) {
  if (ntaps < 1 || ntaps > MAX_TAPS) return false;
  t->n = ntaps;
  for (int k = 0; k < ntaps; ++k) {
    int lin = 0;
    for (int a = 0; a < ndim; ++a) lin = lin * ext[a] + offsets[k * ndim + a];
    t->off[k] = lin;
    t->coef[k] = coefs[k];
  }
  return true;
}

static bool valid_plan(int levels, int reach, int H) {
  return levels >= 1 && reach >= 0 && H == levels * reach;
}

template <bool kShard, typename T>
static int launch2d(const T* src, T* dst, int M, int N, const int* offsets,
                    const float* coefs, int ntaps, int levels, int reach,
                    int H, int TY, int TX, int s_lo, int s_hi, void* stream) {
  if (!valid_plan(levels, reach, H) || TY < 1 || TX < 1 || s_lo < H ||
      s_hi > M - H)
    return (int)cudaErrorInvalidValue;
  const int ext[2] = {TY + 2 * H, TX + 2 * H};
  TapTable t = {};
  if (!fill_table(&t, offsets, coefs, ntaps, 2, ext))
    return (int)cudaErrorInvalidValue;
  // shared memory holds fp32 whatever T is: the load converts
  const size_t smem =
      (size_t)(levels > 1 ? 2 : 1) * ext[0] * ext[1] * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      stencil2d_levels_kernel<T, kShard>,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 block(32, 8);
  const dim3 grid((N + TX - 1) / TX, (M + TY - 1) / TY);
  stencil2d_levels_kernel<T, kShard>
      <<<grid, block, smem, (cudaStream_t)stream>>>(
      src, dst, M, N, levels, reach, H, TY, TX, s_lo, s_hi, t);
  return (int)cudaGetLastError();
}

template <bool kShard, typename T>
static int launch3d(const T* src, T* dst, int D, int M, int N,
                    const int* offsets, const float* coefs, int ntaps,
                    int levels, int reach, int H, int TZ, int TY, int TX,
                    int s_lo, int s_hi, void* stream) {
  if (!valid_plan(levels, reach, H) || TZ < 1 || TY < 1 || TX < 1 ||
      s_lo < H || s_hi > D - H)
    return (int)cudaErrorInvalidValue;
  const int ext[3] = {TZ + 2 * H, TY + 2 * H, TX + 2 * H};
  TapTable t = {};
  if (!fill_table(&t, offsets, coefs, ntaps, 3, ext))
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)(levels > 1 ? 2 : 1) * ext[0] * ext[1] *
                      ext[2] * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      stencil3d_levels_kernel<T, kShard>,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 block(32, 8);
  const dim3 grid((N + TX - 1) / TX, (M + TY - 1) / TY, (D + TZ - 1) / TZ);
  stencil3d_levels_kernel<T, kShard>
      <<<grid, block, smem, (cudaStream_t)stream>>>(
      src, dst, D, M, N, levels, reach, H, TZ, TY, TX, s_lo, s_hi, t);
  return (int)cudaGetLastError();
}

// Fill one of factor mode's tables from (ntaps x 2) offsets.
static bool fill_small(SmallTable* t, const int* offsets, const float* coefs,
                       int ntaps, int ex) {
  if (ntaps < 1 || ntaps > MAX_FACTOR_TAPS) return false;
  t->n = ntaps;
  for (int k = 0; k < ntaps; ++k) {
    t->off[k] = offsets[2 * k] * ex + offsets[2 * k + 1];
    t->coef[k] = coefs[k];
  }
  return true;
}

template <typename T>
static int launch2d_factor(const T* src, T* dst, int M, int N,
                           const int* v1_off, const float* v1_coef, int n1,
                           const int* v2_off, const float* v2_coef, int n2,
                           const int* r_off, const float* r_coef, int nr,
                           int levels, int H, int TY, int TX, void* stream) {
  // 2*step levels of reach 1; the residual's reach 2 needs levels >= 2
  if (levels < 2 || (levels & 1) || H != levels || TY < 1 || TX < 1)
    return (int)cudaErrorInvalidValue;
  const int ey = TY + 2 * H, ex = TX + 2 * H;
  FactorTables f = {};
  if (!fill_small(&f.v1, v1_off, v1_coef, n1, ex) ||
      !fill_small(&f.v2, v2_off, v2_coef, n2, ex) ||
      !fill_small(&f.r, r_off, r_coef, nr, ex))
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)3 * ey * ex * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      stencil2d_factor_levels_kernel<T>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 block(32, 8);
  const dim3 grid((N + TX - 1) / TX, (M + TY - 1) / TY);
  stencil2d_factor_levels_kernel<T><<<grid, block, smem,
                                      (cudaStream_t)stream>>>(
      src, dst, M, N, levels, H, TY, TX, f);
  return (int)cudaGetLastError();
}

extern "C" {

int stencil_max_taps(void) { return MAX_TAPS; }

const char* stencil_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

int stencil2d_levels(const float* src, float* dst, int M, int N,
                     const int* offsets, const float* coefs, int ntaps,
                     int levels, int reach, int H, int TY, int TX,
                     void* stream) {
  return launch2d<false>(src, dst, M, N, offsets, coefs, ntaps, levels,
                         reach, H, TY, TX, H, M - H, stream);
}

int stencil2d_levels_bf16(const __nv_bfloat16* src, __nv_bfloat16* dst,
                          int M, int N, const int* offsets,
                          const float* coefs, int ntaps, int levels,
                          int reach, int H, int TY, int TX, void* stream) {
  return launch2d<false>(src, dst, M, N, offsets, coefs, ntaps, levels,
                         reach, H, TY, TX, H, M - H, stream);
}

int stencil3d_levels(const float* src, float* dst, int D, int M, int N,
                     const int* offsets, const float* coefs, int ntaps,
                     int levels, int reach, int H, int TZ, int TY, int TX,
                     void* stream) {
  return launch3d<false>(src, dst, D, M, N, offsets, coefs, ntaps, levels,
                         reach, H, TZ, TY, TX, H, D - H, stream);
}

int stencil3d_levels_bf16(const __nv_bfloat16* src, __nv_bfloat16* dst,
                          int D, int M, int N, const int* offsets,
                          const float* coefs, int ntaps, int levels,
                          int reach, int H, int TZ, int TY, int TX,
                          void* stream) {
  return launch3d<false>(src, dst, D, M, N, offsets, coefs, ntaps, levels,
                         reach, H, TZ, TY, TX, H, D - H, stream);
}

// Shard-local entries: the same arguments on one shard's slab (H ghost rows
// or planes on each side of axis 0), then the axis-0 store range.

int stencil2d_levels_shard(const float* src, float* dst, int M, int N,
                           const int* offsets, const float* coefs, int ntaps,
                           int levels, int reach, int H, int TY, int TX,
                           int s_lo, int s_hi, void* stream) {
  return launch2d<true>(src, dst, M, N, offsets, coefs, ntaps, levels,
                        reach, H, TY, TX, s_lo, s_hi, stream);
}

int stencil2d_levels_shard_bf16(const __nv_bfloat16* src, __nv_bfloat16* dst,
                                int M, int N, const int* offsets,
                                const float* coefs, int ntaps, int levels,
                                int reach, int H, int TY, int TX, int s_lo,
                                int s_hi, void* stream) {
  return launch2d<true>(src, dst, M, N, offsets, coefs, ntaps, levels,
                        reach, H, TY, TX, s_lo, s_hi, stream);
}

int stencil3d_levels_shard(const float* src, float* dst, int D, int M, int N,
                           const int* offsets, const float* coefs, int ntaps,
                           int levels, int reach, int H, int TZ, int TY,
                           int TX, int s_lo, int s_hi, void* stream) {
  return launch3d<true>(src, dst, D, M, N, offsets, coefs, ntaps, levels,
                        reach, H, TZ, TY, TX, s_lo, s_hi, stream);
}

int stencil3d_levels_shard_bf16(const __nv_bfloat16* src, __nv_bfloat16* dst,
                                int D, int M, int N, const int* offsets,
                                const float* coefs, int ntaps, int levels,
                                int reach, int H, int TZ, int TY, int TX,
                                int s_lo, int s_hi, void* stream) {
  return launch3d<true>(src, dst, D, M, N, offsets, coefs, ntaps, levels,
                        reach, H, TZ, TY, TX, s_lo, s_hi, stream);
}

// Factor mode: three (ntaps x 2) tables, 2*step levels, H = levels.

int stencil2d_factor_levels(const float* src, float* dst, int M, int N,
                            const int* v1_off, const float* v1_coef, int n1,
                            const int* v2_off, const float* v2_coef, int n2,
                            const int* r_off, const float* r_coef, int nr,
                            int levels, int H, int TY, int TX, void* stream) {
  return launch2d_factor(src, dst, M, N, v1_off, v1_coef, n1, v2_off, v2_coef,
                         n2, r_off, r_coef, nr, levels, H, TY, TX, stream);
}

int stencil2d_factor_levels_bf16(const __nv_bfloat16* src, __nv_bfloat16* dst,
                                 int M, int N, const int* v1_off,
                                 const float* v1_coef, int n1,
                                 const int* v2_off, const float* v2_coef,
                                 int n2, const int* r_off,
                                 const float* r_coef, int nr, int levels,
                                 int H, int TY, int TX, void* stream) {
  return launch2d_factor(src, dst, M, N, v1_off, v1_coef, n1, v2_off, v2_coef,
                         n2, r_off, r_coef, nr, levels, H, TY, TX, stream);
}

}  // extern "C"
