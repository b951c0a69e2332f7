// Hand-written Hopper stencil kernels of drstencil_tpu_torch (sm_90a).
//
// Replaces the TPU kernel drstencil_tpu/ops/stream.py:568-803 (the Pallas
// `kernel` closure of build_stream_kernel, called at stream.py:858) in all
// of its main-path modes: K1 single fused level, K2 scratch trapezoid, K3
// value-fused trapezoid, K4 deep trapezoid and K7 block-hybrid levels.
// stencil2d_levels_kernel takes 2D grids, stencil3d_levels_kernel 3D ones.
// Both are templates on the storage type: float (the fp32 builds) and
// __nv_bfloat16 (the bf16 builds, the TPU kernel's dtype="bfloat16").
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

template <typename T>
__global__ void __launch_bounds__(256)
stencil2d_levels_kernel(const T* __restrict__ src, T* __restrict__ dst,
                        int M, int N, int levels, int reach, int H,
                        int TY, int TX, const __grid_constant__ TapTable taps) {
  extern __shared__ float smem[];
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

  // last level: the output tile, stored only inside [H, dim-H)
  const float* in = (levels & 1) ? buf0 : buf1;
  for (int ly = H + threadIdx.y; ly < H + TY; ly += blockDim.y) {
    const int gy = y0 + ly;
    if (gy < H || gy >= M - H) continue;
    for (int lx = H + threadIdx.x; lx < H + TX; lx += blockDim.x) {
      const int gx = x0 + lx;
      if (gx < H || gx >= N - H) continue;
      store_f32(dst + (size_t)gy * N + gx, apply_taps(in, ly * EX + lx, taps));
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(256)
stencil3d_levels_kernel(const T* __restrict__ src, T* __restrict__ dst,
                        int D, int M, int N, int levels, int reach, int H,
                        int TZ, int TY, int TX,
                        const __grid_constant__ TapTable taps) {
  extern __shared__ float smem[];
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
    if (gz < H || gz >= D - H || gy < H || gy >= M - H) continue;
    const int at = lz * plane + ly * EX;
    T* drow = dst + ((size_t)gz * M + gy) * N;
    for (int lx = H + threadIdx.x; lx < H + TX; lx += blockDim.x) {
      const int gx = x0 + lx;
      if (gx < H || gx >= N - H) continue;
      store_f32(drow + gx, apply_taps(in, at + lx, taps));
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

template <typename T>
static int launch2d(const T* src, T* dst, int M, int N, const int* offsets,
                    const float* coefs, int ntaps, int levels, int reach,
                    int H, int TY, int TX, void* stream) {
  if (!valid_plan(levels, reach, H) || TY < 1 || TX < 1)
    return (int)cudaErrorInvalidValue;
  const int ext[2] = {TY + 2 * H, TX + 2 * H};
  TapTable t = {};
  if (!fill_table(&t, offsets, coefs, ntaps, 2, ext))
    return (int)cudaErrorInvalidValue;
  // shared memory holds fp32 whatever T is: the load converts
  const size_t smem =
      (size_t)(levels > 1 ? 2 : 1) * ext[0] * ext[1] * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      stencil2d_levels_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 block(32, 8);
  const dim3 grid((N + TX - 1) / TX, (M + TY - 1) / TY);
  stencil2d_levels_kernel<T><<<grid, block, smem, (cudaStream_t)stream>>>(
      src, dst, M, N, levels, reach, H, TY, TX, t);
  return (int)cudaGetLastError();
}

template <typename T>
static int launch3d(const T* src, T* dst, int D, int M, int N,
                    const int* offsets, const float* coefs, int ntaps,
                    int levels, int reach, int H, int TZ, int TY, int TX,
                    void* stream) {
  if (!valid_plan(levels, reach, H) || TZ < 1 || TY < 1 || TX < 1)
    return (int)cudaErrorInvalidValue;
  const int ext[3] = {TZ + 2 * H, TY + 2 * H, TX + 2 * H};
  TapTable t = {};
  if (!fill_table(&t, offsets, coefs, ntaps, 3, ext))
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)(levels > 1 ? 2 : 1) * ext[0] * ext[1] *
                      ext[2] * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      stencil3d_levels_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 block(32, 8);
  const dim3 grid((N + TX - 1) / TX, (M + TY - 1) / TY, (D + TZ - 1) / TZ);
  stencil3d_levels_kernel<T><<<grid, block, smem, (cudaStream_t)stream>>>(
      src, dst, D, M, N, levels, reach, H, TZ, TY, TX, t);
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
  return launch2d(src, dst, M, N, offsets, coefs, ntaps, levels, reach, H,
                  TY, TX, stream);
}

int stencil2d_levels_bf16(const __nv_bfloat16* src, __nv_bfloat16* dst,
                          int M, int N, const int* offsets,
                          const float* coefs, int ntaps, int levels,
                          int reach, int H, int TY, int TX, void* stream) {
  return launch2d(src, dst, M, N, offsets, coefs, ntaps, levels, reach, H,
                  TY, TX, stream);
}

int stencil3d_levels(const float* src, float* dst, int D, int M, int N,
                     const int* offsets, const float* coefs, int ntaps,
                     int levels, int reach, int H, int TZ, int TY, int TX,
                     void* stream) {
  return launch3d(src, dst, D, M, N, offsets, coefs, ntaps, levels, reach, H,
                  TZ, TY, TX, stream);
}

int stencil3d_levels_bf16(const __nv_bfloat16* src, __nv_bfloat16* dst,
                          int D, int M, int N, const int* offsets,
                          const float* coefs, int ntaps, int levels,
                          int reach, int H, int TZ, int TY, int TX,
                          void* stream) {
  return launch3d(src, dst, D, M, N, offsets, coefs, ntaps, levels, reach, H,
                  TZ, TY, TX, stream);
}

}  // extern "C"
