// Hand-written Hopper factor-mode stencil kernel of drstencil_tpu_torch
// (sm_90a).
//
// The levels kernels (stencil{2,3}d_levels[_shard]: the TPU kernel
// drstencil_tpu/ops/stream.py:568-803 in its modes K1-K5, K7 and K8) are
// not in this file: they are built per plan from specialised text
// (ops/codegen.py -> ops/kernels.plan_kernel: streamed along axis 0, four
// outputs per thread, shapes and taps compile-time constants).
//
// Factor mode (stencil2d_factor_levels[_bf16]) replaces the TPU kernel's
// factor=True build (drstencil_tpu/ops/stream.py:446-474, 491, 683-714; K6).
// A 2D radius-2 operator W is applied as W = V1*V2 + R (ir/factor.py): per
// timestep one level of the 3x3 table V1, then one of V2 that adds the
// residual R (at most 5 taps on axis 0, reach 2) read from the level TWO
// back.  `levels` = 2*step levels of reach 1, H = levels.  Every cell within
// H of a face keeps dst's value (a frozen Dirichlet frame); out-of-domain
// source cells read as 0, and whatever that feeds lands only on frame cells,
// which are never stored.
//
// Design: one CTA per output tile.  It loads its tile plus a halo of H into
// shared memory (masked to 0 outside the domain).  Three fp32 tiles rotate
// in shared memory so that level t-2 is alive while level t is written;
// level t covers local [t, E-t), exactly 2 cells inside level t-2's region,
// which is what R's reach needs.  The last level stores only the cells
// inside [H, dim-H).  The template is on the storage type: a bf16 load
// converts to fp32 (__bfloat162float), shared memory and every level stay
// fp32, and the last level rounds to nearest even once at the store
// (__float2bfloat16_rn), as the TPU kernel does with dtype="bfloat16"
// (drstencil_tpu/ops/stream.py:604-617, 652, 866).  The tables stay fp32.
//
// Bound: 2 * item * cells bytes over HBM (3.35 TB/s on H100 SXM), or
// 2 * (|V1|+|V2|+|R|) * step * cells fp32 flops (67 TFLOP/s).  What the mode
// trades on Hopper is 25 shared-memory loads per cell and step against
// 9 + 9 + 5, for one more level's barrier and halo recompute and a third
// tile.  No tuned winner uses it, and it has had no redesign.
//
// Interface: plain C, loaded with ctypes.  Each entry checks its arguments,
// launches on the given stream and returns cudaGetLastError() (0 = success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
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

int stencil_max_factor_taps(void) { return MAX_FACTOR_TAPS; }

const char* stencil_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
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
