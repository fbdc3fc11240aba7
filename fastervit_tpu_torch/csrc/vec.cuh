// V contiguous channels of an element type, loaded and stored as one 2- to
// 16-byte vector; shared by the MSDA kernels (msda_fwd.cu, msda_bwd.cu,
// msda_probe.cu).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "dtype.cuh"

namespace fastervit {

// An unsigned type of B bytes, for one vector load or store
template <int B> struct Bits;
template <> struct Bits<2> { using type = unsigned short; };
template <> struct Bits<4> { using type = unsigned; };
template <> struct Bits<8> { using type = uint2; };
template <> struct Bits<16> { using type = uint4; };

__device__ __forceinline__ unsigned word(unsigned short b, int) { return b; }
__device__ __forceinline__ unsigned word(unsigned b, int) { return b; }
__device__ __forceinline__ unsigned word(uint2 b, int i) {
  return i ? b.y : b.x;
}
__device__ __forceinline__ unsigned word(uint4 b, int i) {
  return i == 0 ? b.x : i == 1 ? b.y : i == 2 ? b.z : b.w;
}
__device__ __forceinline__ void set_word(unsigned short& b, int, unsigned w) {
  b = (unsigned short)w;
}
__device__ __forceinline__ void set_word(unsigned& b, int, unsigned w) {
  b = w;
}
__device__ __forceinline__ void set_word(uint2& b, int i, unsigned w) {
  (i ? b.y : b.x) = w;
}
__device__ __forceinline__ void set_word(uint4& b, int i, unsigned w) {
  (i == 0 ? b.x : i == 1 ? b.y : i == 2 ? b.z : b.w) = w;
}

// V channels of T, read and written as one vector
template <typename T, int V>
struct Vec {
  using B = typename Bits<V * sizeof(T)>::type;
  B bits;

  // from global memory, by the read-only path
  __device__ __forceinline__ void load(const T* p) {
    bits = __ldg(reinterpret_cast<const B*>(p));
  }
  // from global memory, read once (evict-first: __ldcs)
  __device__ __forceinline__ void load_cs(const T* p) {
    bits = __ldcs(reinterpret_cast<const B*>(p));
  }
  // from shared memory (or any generic address)
  __device__ __forceinline__ void load_plain(const T* p) {
    bits = *reinterpret_cast<const B*>(p);
  }
  // channel e widened to f32 (exact: a bf16 is the high half of its f32)
  __device__ __forceinline__ float get(int e) const {
    if constexpr (sizeof(T) == 4) {
      return __uint_as_float(word(bits, e));
    } else {
      const unsigned w = word(bits, e >> 1);
      return __uint_as_float((e & 1) ? (w & 0xffff0000u) : (w << 16));
    }
  }
  __device__ __forceinline__ void set(int e, float x) {
    if constexpr (sizeof(T) == 4) {
      set_word(bits, e, __float_as_uint(x));
    } else {
      const unsigned h = __bfloat16_as_ushort(from_f32<T>(x));
      const unsigned w = word(bits, e >> 1);
      set_word(bits, e >> 1, (e & 1) ? ((w & 0xffffu) | (h << 16))
                                     : ((w & 0xffff0000u) | h));
    }
  }
  __device__ __forceinline__ void store(T* p) const {
    *reinterpret_cast<B*>(p) = bits;
  }
};

}  // namespace fastervit
