// bfloat16 for the CPU emulation of tests/cuda_shim/cuda_runtime.h: the
// storage type and the two conversions the port's kernels use (round to
// nearest even, NaN kept a NaN).
#pragma once

#include "cuda_runtime.h"

struct __nv_bfloat16 {
  unsigned short bits;
};

inline float __bfloat162float(__nv_bfloat16 h) {
  const uint32_t u = static_cast<uint32_t>(h.bits) << 16;
  float f;
  std::memcpy(&f, &u, 4);
  return f;
}

inline __nv_bfloat16 __float2bfloat16_rn(float f) {
  uint32_t u;
  std::memcpy(&u, &f, 4);
  if ((u & 0x7fffffffu) > 0x7f800000u) return {0x7fc0};
  u += 0x7fffu + ((u >> 16) & 1u);
  return {static_cast<unsigned short>(u >> 16)};
}
