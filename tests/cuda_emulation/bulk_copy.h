// The TMA bulk copy and the mbarrier of csrc/experiments.cu as a memcpy and
// a byte count: a barrier's phase completes when its one arrival has come
// and every byte it expects has been copied, in either order, as on the card
#pragma once
#include <barrier>
#include <chrono>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <mutex>
struct EmuBar { int32_t tx; uint16_t pending; uint16_t phase; };
static_assert(sizeof(EmuBar) == 8, "an mbarrier is 8 bytes");
static std::mutex g_bar_mu;
static std::condition_variable g_bar_cv;
static inline EmuBar* emu_bar(uint64_t* bar) { return reinterpret_cast<EmuBar*>(bar); }
static inline void emu_bar_settle(EmuBar* b) {
  if (b->pending == 0 && b->tx == 0) { b->phase ^= 1; b->pending = 1; g_bar_cv.notify_all(); }
}
static inline void probe_bar_init(uint64_t* bar) {
  std::lock_guard<std::mutex> l(g_bar_mu);
  *emu_bar(bar) = EmuBar{0, 1, 0};
}
static inline void probe_bar_expect(uint64_t* bar, unsigned bytes) {
  std::lock_guard<std::mutex> l(g_bar_mu);
  EmuBar* b = emu_bar(bar);
  if (b->pending != 1) { fprintf(stderr, "mbarrier armed twice in one phase\n"); abort(); }
  b->tx += (int32_t)bytes; b->pending = 0;
  emu_bar_settle(b);
}
static inline void probe_bulk_copy(void* dst, const void* src, unsigned bytes, uint64_t* bar) {
  if (bytes % 16 || (uintptr_t)dst % 16 || (uintptr_t)src % 16) {
    fprintf(stderr, "bulk copy of %u bytes not 16-byte aligned\n", bytes); abort();
  }
  memcpy(dst, src, bytes);
  std::lock_guard<std::mutex> l(g_bar_mu);
  EmuBar* b = emu_bar(bar);
  b->tx -= (int32_t)bytes;
  emu_bar_settle(b);
}
static inline void probe_bar_wait(uint64_t* bar, unsigned parity) {
  std::unique_lock<std::mutex> l(g_bar_mu);
  EmuBar* b = emu_bar(bar);
  if (!g_bar_cv.wait_for(l, std::chrono::seconds(30), [&] { return b->phase != parity; })) {
    fprintf(stderr, "mbarrier wait timed out: tx %d, pending %d\n", b->tx, b->pending); abort();
  }
}
static inline void probe_bar_arrive(uint64_t* bar) {
  std::lock_guard<std::mutex> l(g_bar_mu);
  EmuBar* b = emu_bar(bar);
  if (b->pending != 1) { fprintf(stderr, "mbarrier arrived twice in one phase\n"); abort(); }
  b->pending = 0;
  emu_bar_settle(b);
}
// bar.sync 1, n: CTAs run one after another, so one barrier serves them all
static inline void probe_consumer_sync(int n) {
  static std::barrier<> consumers(n);
  consumers.arrive_and_wait();
}
// the tensor map as the array it describes, x first (a 2D map has one plane);
// a box copy packs its rows, zero outside the array, and counts every byte of
// the box
struct CUtensorMap { const char* base; int elem; long long dims[3]; int box[3]; };
static inline int probe_make_map(CUtensorMap* m, const float* in, int N, int rows, int box_cols, int box_rows) {
  *m = CUtensorMap{reinterpret_cast<const char*>(in), 4, {N, rows, 1}, {box_cols, box_rows, 1}};
  return 0;
}
static inline void emu_box_copy(void* dst, const CUtensorMap* m, int x0, int y0, int z0, uint64_t* bar) {
  char* d = static_cast<char*>(dst);
  const int e = m->elem;
  for (int z = 0; z < m->box[2]; ++z)
    for (int y = 0; y < m->box[1]; ++y)
      for (int x = 0; x < m->box[0]; ++x) {
        const long long gx = x0 + x, gy = y0 + y, gz = z0 + z;
        char* to = d + ((size_t)(z * m->box[1] + y) * m->box[0] + x) * e;
        if (gx >= 0 && gx < m->dims[0] && gy >= 0 && gy < m->dims[1] && gz >= 0 && gz < m->dims[2])
          memcpy(to, m->base + ((gz * m->dims[1] + gy) * m->dims[0] + gx) * e, e);
        else
          memset(to, 0, e);
      }
  std::lock_guard<std::mutex> l(g_bar_mu);
  EmuBar* b = emu_bar(bar);
  b->tx -= m->box[0] * m->box[1] * m->box[2] * e;
  emu_bar_settle(b);
}
static inline void probe_tensor_copy(void* dst, const CUtensorMap* m, int c0, int r0, uint64_t* bar) {
  if ((uintptr_t)dst % 16) { fprintf(stderr, "box copy to an unaligned address\n"); abort(); }
  emu_box_copy(dst, m, c0, r0, 0, bar);
}
// the plans' TMA feed (ops/codegen's windowed 3D and 2D texts): the encoder refuses
// what the driver's does (an address, a row or a plane stride, or a box row
// that is no whole 16 bytes; a box wider than 256 cells), a box starts on a
// whole 16 bytes of the array along x, and it lands 128-byte aligned
static inline int tma_encode_3d(CUtensorMap* m, const void* base, int elem, const unsigned long long dims[3], const unsigned box[3]) {
  if ((uintptr_t)base % 16 || dims[0] * elem % 16 || box[0] * elem % 16) return 1;
  for (int a = 0; a < 3; ++a)
    if (box[a] < 1 || box[a] > 256) return 1;
  *m = CUtensorMap{static_cast<const char*>(base), elem, {(long long)dims[0], (long long)dims[1], (long long)dims[2]},
                   {(int)box[0], (int)box[1], (int)box[2]}};
  return 0;
}
static inline void tma_bar_init(uint64_t* bar) { probe_bar_init(bar); }
static inline void tma_bar_expect(uint64_t* bar, unsigned bytes) { probe_bar_expect(bar, bytes); }
static inline void tma_bar_wait(uint64_t* bar, unsigned parity) { probe_bar_wait(bar, parity); }
static inline void tma_copy_3d(void* dst, const CUtensorMap* m, int x, int y, int z, uint64_t* bar) {
  if ((uintptr_t)dst % 128) { fprintf(stderr, "box copy to an address not 128-byte aligned\n"); abort(); }
  if ((long long)x * m->elem % 16) { fprintf(stderr, "box copy from x = %d, not on 16 bytes\n", x); abort(); }
  emu_box_copy(dst, m, x, y, z, bar);
}
// a 2D map is a 3D map of one plane: its box rows land packed, zero outside the
// grid (left of x = 0 too), under the same checks
static inline int tma_encode_2d(CUtensorMap* m, const void* base, int elem, const unsigned long long dims[2], const unsigned box[2]) {
  const unsigned long long dims3[3] = {dims[0], dims[1], 1};
  const unsigned box3[3] = {box[0], box[1], 1};
  return tma_encode_3d(m, base, elem, dims3, box3);
}
static inline void tma_copy_2d(void* dst, const CUtensorMap* m, int x, int y, uint64_t* bar) {
  tma_copy_3d(dst, m, x, y, 0, bar);
}
