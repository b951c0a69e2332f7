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
// the tensor map as the array it describes; a box copy packs its rows, zero
// outside the array, and counts every byte of the box
struct CUtensorMap { const float* base; int N, rows, box_cols, box_rows; };
static inline int probe_make_map(CUtensorMap* m, const float* in, int N, int rows, int box_cols, int box_rows) {
  *m = CUtensorMap{in, N, rows, box_cols, box_rows};
  return 0;
}
static inline void probe_tensor_copy(void* dst, const CUtensorMap* m, int c0, int r0, uint64_t* bar) {
  if ((uintptr_t)dst % 16) { fprintf(stderr, "box copy to an unaligned address\n"); abort(); }
  float* d = static_cast<float*>(dst);
  for (int r = 0; r < m->box_rows; ++r)
    for (int c = 0; c < m->box_cols; ++c) {
      const int gr = r0 + r, gc = c0 + c;
      d[r * m->box_cols + c] = gr >= 0 && gr < m->rows && gc >= 0 && gc < m->N ? m->base[(size_t)gr * m->N + gc] : 0.0f;
    }
  std::lock_guard<std::mutex> l(g_bar_mu);
  EmuBar* b = emu_bar(bar);
  b->tx -= m->box_cols * m->box_rows * 4;
  emu_bar_settle(b);
}
