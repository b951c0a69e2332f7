// g++ emulation of the little CUDA the generated kernels use
#pragma once
#include <algorithm>
#include <barrier>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <limits>
#include <memory>
#include <thread>
#include <vector>
#define __global__
#define __device__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __grid_constant__
#define __align__(n) alignas(n)
struct alignas(8) float2 { float x, y; };
struct alignas(16) float4 { float x, y, z, w; };
struct alignas(8) uint2 { unsigned x, y; };
static inline float4 make_float4(float x, float y, float z, float w) { return {x, y, z, w}; }
static inline uint2 make_uint2(unsigned x, unsigned y) { return {x, y}; }
static inline float __uint_as_float(unsigned u) { float f; memcpy(&f, &u, 4); return f; }
// a product never contracted into a following add (g++ runs with -ffp-contract=off)
static inline float __fmul_rn(float a, float b) { return a * b; }
struct dim3 { unsigned x, y, z; dim3(unsigned x_ = 1, unsigned y_ = 1, unsigned z_ = 1) : x(x_), y(y_), z(z_) {} };
static thread_local dim3 threadIdx, blockIdx, gridDim, blockDim;
static thread_local std::barrier<>* g_bar;
static inline void __syncthreads() { g_bar->arrive_and_wait(); }
// warp shuffles: every lane of the warp posts its value, then reads its source lane's
// (a lane whose source lies outside the warp keeps its own value, as on the card)
static thread_local std::barrier<>* g_warp_bar;
static thread_local float* g_lanes;
static inline float emu_shfl(float v, int delta) {
  const int t = (int)threadIdx.x, lane = t % 32, from = lane + delta;
  g_lanes[t] = v;
  g_warp_bar->arrive_and_wait();
  const float got = (from >= 0 && from < 32) ? g_lanes[t + delta] : v;
  g_warp_bar->arrive_and_wait();
  return got;
}
static inline float __shfl_up_sync(unsigned, float v, unsigned d) { return emu_shfl(v, -(int)d); }
static inline float __shfl_down_sync(unsigned, float v, unsigned d) { return emu_shfl(v, (int)d); }
typedef int cudaError_t;
typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1, cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
template <class K> static inline cudaError_t cudaFuncSetAttribute(K, int, int) { return 0; }
static inline cudaError_t cudaGetLastError() { return 0; }
static inline const char* cudaGetErrorString(cudaError_t) { return "emulated"; }
using std::min;
struct cudaFuncAttributes { int numRegs; size_t localSizeBytes; };
template <class K> static inline cudaError_t cudaFuncGetAttributes(cudaFuncAttributes* a, K) { a->numRegs = 0; a->localSizeBytes = 0; return 0; }
template <class K> static inline cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* n, K, int, size_t) { *n = 1; return 0; }
alignas(128) static float g_smem[232448 / 4];
template <class F> static void emu_launch(dim3 grid, dim3 block, F f) {
  const unsigned n = block.x * block.y * block.z;
  for (unsigned bz = 0; bz < grid.z; ++bz) for (unsigned by = 0; by < grid.y; ++by) for (unsigned bx = 0; bx < grid.x; ++bx) {
    for (auto& v : g_smem) v = std::numeric_limits<float>::quiet_NaN();
    std::barrier<> bar(n);
    std::vector<std::unique_ptr<std::barrier<>>> warps;
    for (unsigned w = 0; w < n; w += 32) warps.emplace_back(new std::barrier<>(std::min(32u, n - w)));
    std::vector<float> lanes(n);
    std::vector<std::thread> ts;
    for (unsigned t = 0; t < n; ++t) ts.emplace_back([&, t] {
      threadIdx = dim3(t % block.x, (t / block.x) % block.y, t / (block.x * block.y));
      blockIdx = dim3(bx, by, bz); gridDim = grid; blockDim = block; g_bar = &bar;
      g_warp_bar = warps[t / 32].get(); g_lanes = lanes.data();
      struct Drop { std::barrier<>* b; std::barrier<>* w; ~Drop() { b->arrive_and_drop(); w->arrive_and_drop(); } } drop{&bar, g_warp_bar};
      f();
    });
    for (auto& t : ts) t.join();
  }
}
#define EMU_LAUNCH(kernel, grid, block, ...) emu_launch(grid, block, [&] { kernel(__VA_ARGS__); })
