// The tile plan and tile steps shared by the long-window attention kernels:
// K3 and P2 (window_mhsa_long.cu) and P1 (attn_online.cu).
//
// One block of kThreads threads owns kTile q rows of one (window, head) and
// streams the keys through shared memory kTile at a time. Thread (ty, tx)
// of the 16 × 16 holds rows ty + 16i and keys tx + 16j (i, j < 4) of the
// logits tile, and rows ty + 16i and columns tx + 16j (j < NJ) of the f32
// accumulator, NJ = hd_pad / 16. A row's keys lie with the 16 threads of
// one ty, in one half-warp, so row sums and maxima reduce with xor shuffles
// 8..1. Scalar f32 FMA fed from shared memory.
//
// q, k, v and out are (B, H, S, hd) operands given by a base pointer and
// element strides (window, head, token), hd contiguous: the packed qkv
// projection output (B, S, 3C) that K3 reads, or separate (B, H, S, hd)
// tensors. They are read element by element, since at hd = 49 a head's
// offset is not aligned for vector loads. Every offset is 64-bit; the token
// stride is 32-bit (checked by `launchable`), so a token's offset is one
// widening multiply-add.
#pragma once

#include <cmath>
#include <cstddef>
#include <type_traits>
#include <cuda_runtime.h>

#include "dtype.cuh"

namespace fastervit {
namespace attn_tiles {

constexpr int kTile = 64;         // q rows per block, keys per K/V tile
constexpr int kThreads = 256;     // 16 × 16; each thread 4 rows × 4 keys
constexpr int kMaxHeadDim = 128;  // LONG_MAX_HEAD_DIM in cuda_attention.py
constexpr int kLd = kTile + 1;    // padded rows: no bank conflicts on the
                                  // transposed writes and p's two-row reads

// Element strides of a (B, H, S, hd) operand.
struct Strides {
  long long window, head;
  int token;
};

// Shared memory, in floats: q and k transposed (hd × kLd each), p
// (kTile × kLd), v (kTile × hd_pad).
inline size_t smem_floats(int head_dim, int hd_pad) {
  return size_t(2 * head_dim + kTile) * kLd + size_t(kTile) * hd_pad;
}

// The pointers' layout: qt [d][row], kt [d][key], p [row][key], v [key][d].
struct Smem {
  float *qt, *kt, *p, *v;
  __device__ Smem(float* smem, int head_dim)
      : qt(smem), kt(smem + head_dim * kLd), p(kt + head_dim * kLd),
        v(p + kTile * kLd) {}
};

// Offset of (window blockIdx.x, head blockIdx.z) in an operand.
__device__ __forceinline__ long long slab(const Strides& st) {
  return (long long)blockIdx.x * st.window + (long long)blockIdx.z * st.head;
}

// q rows q0 .. q0 + kTile, transposed, rows past S as zeros; and v's
// padding columns above hd as zeros, which no later tile overwrites.
template <typename T, int kHdPad>
__device__ __forceinline__ void load_q(const T* __restrict__ q,
                                       int token, int q0, int seq,
                                       int head_dim, const Smem& sm) {
  for (int e = threadIdx.x; e < kTile * head_dim; e += kThreads) {
    const int r = e / head_dim, d = e - r * head_dim;
    const int s = q0 + r;
    sm.qt[d * kLd + r] = s < seq ? to_f32(q[(long long)s * token + d])
                                 : 0.f;
  }
  for (int e = threadIdx.x; e < kTile * (kHdPad - head_dim); e += kThreads) {
    const int c = e / (kHdPad - head_dim);
    sm.v[c * kHdPad + head_dim + (e - c * (kHdPad - head_dim))] = 0.f;
  }
}

// Keys k0 .. k0 + kTile: k transposed, and v if kWithV; keys from `end` on
// as zeros.
template <typename T, int kHdPad, bool kWithV>
__device__ __forceinline__ void load_kv(const T* __restrict__ k,
                                        const T* __restrict__ v,
                                        int token, int k0, int end,
                                        int head_dim, const Smem& sm) {
  for (int e = threadIdx.x; e < kTile * head_dim; e += kThreads) {
    const int c = e / head_dim, d = e - c * head_dim;
    const bool in = k0 + c < end;
    const long long at = (long long)(k0 + c) * token + d;
    sm.kt[d * kLd + c] = in ? to_f32(k[at]) : 0.f;
    if (kWithV) sm.v[c * kHdPad + d] = in ? to_f32(v[at]) : 0.f;
  }
}

// This thread's 4×4 logits of the tile at k0: q kᵀ·scale (+ bias) in f32,
// −inf for keys from `end` on. bias_h is the head's (S, S) slab.
template <typename TB, bool kBias>
__device__ __forceinline__ void logits(const Smem& sm,
                                       const TB* __restrict__ bias_h, int q0,
                                       int k0, int end, int seq, int head_dim,
                                       float scale, float (&sc)[4][4]) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < head_dim; ++d) {
    float qa[4], ka[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) qa[i] = sm.qt[d * kLd + ty + 16 * i];
#pragma unroll
    for (int j = 0; j < 4; ++j) ka[j] = sm.kt[d * kLd + tx + 16 * j];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = fmaf(qa[i], ka[j], sc[i][j]);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = min(q0 + ty + 16 * i, seq - 1);  // rows past S: any row
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = k0 + tx + 16 * j;
      if (c >= end) {
        sc[i][j] = -INFINITY;
      } else if constexpr (kBias) {
        sc[i][j] = fmaf(sc[i][j], scale,
                        to_f32(bias_h[(long long)r * seq + c]));
      } else {
        sc[i][j] *= scale;
      }
    }
  }
}

// acc += p · v over the tile's first kn keys.
template <int NJ>
__device__ __forceinline__ void accumulate_pv(const Smem& sm, int kn,
                                              float (&acc)[4][NJ]) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll 4
  for (int c = 0; c < kn; ++c) {
    float pa[4], va[NJ];
#pragma unroll
    for (int i = 0; i < 4; ++i) pa[i] = sm.p[(ty + 16 * i) * kLd + c];
#pragma unroll
    for (int j = 0; j < NJ; ++j) va[j] = sm.v[c * 16 * NJ + tx + 16 * j];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] = fmaf(pa[i], va[j], acc[i][j]);
  }
}

// Sum over the 16 threads that hold one row.
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Max over the 16 threads that hold one row.
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// out = acc / Σp for rows below S and columns below hd, written as T.
template <typename T, int NJ>
__device__ __forceinline__ void store(T* __restrict__ out, int token,
                                      int q0, int seq, int head_dim,
                                      const float (&acc)[4][NJ],
                                      const float (&l)[4]) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r >= seq) continue;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int d = tx + 16 * j;
      if (d < head_dim)
        out[(long long)r * token + d] = from_f32<T>(acc[i][j] / l[i]);
    }
  }
}

// Whether CUDA can launch the (B, S/kTile, H) grid for these sizes, and
// the token strides fit in 32 bits.
inline bool launchable(int batch, int seq, int heads, int head_dim,
                       long long in_token, long long out_token) {
  return batch > 0 && seq > 0 && heads > 0 && heads <= 65535 &&
         head_dim > 0 && head_dim <= kMaxHeadDim &&
         (seq + kTile - 1) / kTile <= 65535 && in_token > 0 &&
         in_token <= 0x7fffffff && out_token > 0 && out_token <= 0x7fffffff;
}

// f(std::integral_constant<int, NJ>) for NJ = hd_pad / 16, with hd_pad hd
// rounded up to 32, 64, 96 or 128.
template <typename F>
cudaError_t with_nj(int head_dim, F&& f) {
  if (head_dim <= 32) return f(std::integral_constant<int, 2>{});
  if (head_dim <= 64) return f(std::integral_constant<int, 4>{});
  if (head_dim <= 96) return f(std::integral_constant<int, 6>{});
  return f(std::integral_constant<int, 8>{});
}

// Launch a kernel of this plan on the (B, S/kTile, H) grid with the
// shared memory of head_dim and NJ.
template <int NJ, typename... Params, typename... Args>
cudaError_t launch(void (*kernel)(Params...), int batch, int seq, int heads,
                   int head_dim, cudaStream_t stream, Args... args) {
  const size_t smem = smem_floats(head_dim, 16 * NJ) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(unsigned(batch), unsigned((seq + kTile - 1) / kTile),
                  unsigned(heads));
  kernel<<<grid, kThreads, smem, stream>>>(args...);
  return cudaGetLastError();
}

}  // namespace attn_tiles
}  // namespace fastervit
