// Element helpers shared by the kernels in this directory.
//
// f32 is carried as its uint32 bits, bf16 as its uint16 bits; conversions
// are exact bit operations, so no cuda_bf16.h semantics are involved, and
// the rounding is the one torch's .to(bfloat16) does.

#pragma once

#include <cstdint>

#include <cuda_runtime.h>

namespace {

template <typename E>
struct Elem;

template <>
struct Elem<uint32_t> {
  static constexpr uint32_t kNan = 0x7fc00000u;   // jnp/torch canonical NaN
  __device__ static float to_f32(uint32_t b) { return __uint_as_float(b); }
  __device__ static uint32_t from_f32(float x) { return __float_as_uint(x); }
};

template <>
struct Elem<uint16_t> {
  static constexpr uint16_t kNan = 0x7fc0u;
  __device__ static float to_f32(uint16_t b) {
    return __uint_as_float(static_cast<uint32_t>(b) << 16);
  }
  // Round to nearest even, NaN to 0x7fc0: what torch's .to(bfloat16) does.
  __device__ static uint16_t from_f32(float x) {
    uint32_t u = __float_as_uint(x);
    if ((u & 0x7fffffffu) > 0x7f800000u) return kNan;
    u += 0x7fffu + ((u >> 16) & 1u);
    return static_cast<uint16_t>(u >> 16);
  }
};

// x rounded to bf16 and widened back to f32.
__device__ __forceinline__ float round_bf16(float x) {
  return Elem<uint16_t>::to_f32(Elem<uint16_t>::from_f32(x));
}

template <typename E, int N>
struct alignas(sizeof(E) * N) Pack {
  E e[N];
};

inline bool aligned_to(const void* p, uintptr_t bytes) {
  return (reinterpret_cast<uintptr_t>(p) % bytes) == 0;
}

}  // namespace
