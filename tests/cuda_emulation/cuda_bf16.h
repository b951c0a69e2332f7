#pragma once
#include <cstdint>
#include <cstring>
struct __nv_bfloat16 { uint16_t x; };
static inline float __bfloat162float(__nv_bfloat16 h) { uint32_t u = (uint32_t)h.x << 16; float f; memcpy(&f, &u, 4); return f; }
static inline __nv_bfloat16 __float2bfloat16_rn(float f) { uint32_t u; memcpy(&u, &f, 4); u += 0x7fffu + ((u >> 16) & 1u); return {(uint16_t)(u >> 16)}; }
