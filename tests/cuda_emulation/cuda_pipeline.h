// cp.async as a plain copy: the staging protocol's data flow, without its
// asynchrony
#pragma once
#include <cstddef>
#include <cstring>
static inline void __pipeline_memcpy_async(void* dst, const void* src, size_t size, size_t zfill = 0) {
  memcpy(dst, src, size - zfill);
  memset(static_cast<char*>(dst) + (size - zfill), 0, zfill);
}
static inline void __pipeline_commit() {}
static inline void __pipeline_wait_prior(int) {}
