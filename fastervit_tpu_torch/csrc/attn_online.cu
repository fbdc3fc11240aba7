// Bias-added attention with a chunked online softmax, for Hopper (sm_90a): P1.
//
// Replaces `_online_kernel` of scripts/attn_online_probe.py (called through
// `online_forward`), the TPU probe that splits each key row into C chunks
// and keeps a running (max, sum, context) rescaled once a chunk. For each
// window b and head h:
//
//   out[b, h] = softmax(q[b, h] k[b, h]ᵀ·scale + bias[h]) · v[b, h]
//
// on q, k, v and out of (B, H, S, hd) given by strides (hd contiguous), f32
// or bf16, bias (H, S, S) f32 or bf16, any S >= 1 that C divides and
// hd <= 128. It never writes logits to device memory.
//
// Bound on this card: operations. At the probe's geometry, FasterViT-4-21k
// at 768² level 2 (B = 16, S = 2304, H = 16, hd = 49, bf16, bf16 bias), the
// function is 4·B·H·S²·hd = 266 GFLOP against 401 MB of q, k, v, bias and
// output: 0.27 ms at the bf16 tensor-core peak, 0.12 ms at the memory rate.
//
// The contract that keeps it to the plain version's roundings (and to the
// TPU kernel's) is that each chunk's p is taken against the running max
// after that chunk: p = exp(logit − m_new) with m_new = max(m, the chunk's
// row max), then rounded to the input type for the PV product. A chunk is
// S/C keys, 1152 at the probe's C = 2; its f32 logits for 64 q rows are
// 295 KB, more than the 227 KB of shared memory a block may have, and S
// has no upper limit. So each chunk takes two sweeps over its keys in
// 64-key tiles: the first computes q kᵀ·scale + bias and keeps only the
// row max; then the running sum and context are rescaled once by
// α = exp(m − m_new); the second recomputes the same logits (the same code,
// so the same bits), forms p, sums it and accumulates p·v. Shared memory
// stays at K3's plan (window_mhsa_long.cu) for any S and any C, at the cost
// of one more q kᵀ product: three products where K3 does two. At C = 1 it
// is one softmax over the whole row.
//
// Otherwise it is K3's design, on K3's tile steps (attn_tiles.cuh): one
// block per (window, q-tile of 64 rows, head), the window innermost so that
// the blocks that read one (head, q-tile) bias slab run side by side and
// find it in L2; 256 threads, each with a 4×4 register tile of the logits
// and a 4×(hd_pad/16) tile of the f32 accumulator; scalar f32 FMA fed from
// shared memory. Tensor-core tiles and TMA are later work.
//
// Numerics, as ops/attention_probes.py::online_attention_reference: q, k
// and bias read as f32, logits in f32; Σp of the unrounded p in f32; the
// context divided by the sum once at the end and written in the input
// type. Only the order of the f32 sums differs. hd is padded in shared
// memory only; every offset is 64-bit. Plain C interface, bound with
// ctypes by fastervit_tpu_torch/ops/cuda_attention.py, which checks
// device, dtype, shape and layout.

#include <cmath>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "attn_tiles.cuh"
#include "dtype.cuh"

namespace {

using namespace fastervit::attn_tiles;
using fastervit::from_f32;
using fastervit::to_f32;

// NJ = hd_pad / 16: the accumulator columns each thread holds.
template <typename T, typename TB, int NJ>
__global__ void __launch_bounds__(kThreads)
attn_online_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, Strides in,
                   const TB* __restrict__ bias, T* __restrict__ out,
                   Strides os, int seq, int head_dim, int chunk,
                   float scale) {
  constexpr int kHdPad = 16 * NJ;
  extern __shared__ float smem[];
  const Smem sm(smem, head_dim);
  const int q0 = blockIdx.y * kTile;
  const long long at = slab(in);
  const int tx = threadIdx.x & 15;    // keys tx + 16j
  const int ty = threadIdx.x >> 4;    // rows ty + 16i
  const TB* bias_h = bias + (long long)blockIdx.z * seq * seq;

  load_q<T, kHdPad>(q + at, in.token, q0, seq, head_dim, sm);
  float m[4], l[4], acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
  }

  float sc[4][4];
  for (int c0 = 0; c0 < seq; c0 += chunk) {
    const int end = c0 + chunk;

    // 1. the chunk's row max, over its 64-key tiles.
    float cmax[4] = {-INFINITY, -INFINITY, -INFINITY, -INFINITY};
    for (int k0 = c0; k0 < end; k0 += kTile) {
      __syncthreads();  // the previous tile's k, v and p are no longer read
      load_kv<T, kHdPad, false>(k + at, nullptr, in.token, k0, end,
                                head_dim, sm);
      __syncthreads();
      logits<TB, true>(sm, bias_h, q0, k0, end, seq, head_dim, scale, sc);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) cmax[i] = fmaxf(cmax[i], sc[i][j]);
    }

    // 2. m_new = max(m, chunk max); rescale the running sum and context
    //    once. Every chunk holds at least one key, so m_new is finite and
    //    α is 0 on the first chunk.
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float mnew = fmaxf(m[i], row_max(cmax[i]));
      const float alpha = expf(m[i] - mnew);
      l[i] *= alpha;
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] *= alpha;
      m[i] = mnew;
    }

    // 3. p = exp(logits − m_new), Σp, and acc += p · v, tile by tile.
    for (int k0 = c0; k0 < end; k0 += kTile) {
      __syncthreads();
      load_kv<T, kHdPad, true>(k + at, v + at, in.token, k0, end, head_dim,
                               sm);
      __syncthreads();
      logits<TB, true>(sm, bias_h, q0, k0, end, seq, head_dim, scale, sc);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float psum = 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float pv = expf(sc[i][j] - m[i]);
          psum += pv;
          sm.p[(ty + 16 * i) * kLd + tx + 16 * j] = to_f32(from_f32<T>(pv));
        }
        l[i] += row_sum(psum);
      }
      __syncthreads();
      accumulate_pv<NJ>(sm, min(kTile, end - k0), acc);
    }
  }

  // 4. out = acc / Σp, written as T.
  store<T, NJ>(out + slab(os), os.token, q0, seq, head_dim, acc, l);
}

template <typename T, typename TB>
cudaError_t launch_typed(const void* q, const void* k, const void* v,
                         Strides in, const void* bias, void* out, Strides os,
                         int batch, int heads, int seq, int head_dim,
                         int chunk, float scale, cudaStream_t stream) {
  return with_nj(head_dim, [&](auto nj) {
    constexpr int NJ = decltype(nj)::value;
    return launch<NJ>(attn_online_kernel<T, TB, NJ>, batch, seq, heads,
                      head_dim, stream, static_cast<const T*>(q),
                      static_cast<const T*>(k), static_cast<const T*>(v), in,
                      static_cast<const TB*>(bias), static_cast<T*>(out), os,
                      seq, head_dim, chunk, scale);
  });
}

}  // namespace

extern "C" {

// q, k, v: (batch, heads, seq, head_dim) with element strides in_window,
// in_head, in_token (alike for the three, hd contiguous); out: the same
// shape with strides out_*; all f32 (qkv_bf16 = 0) or all bf16
// (qkv_bf16 = 1); bias: (heads, seq, seq), f32 or bf16 (bias_bf16), read
// as f32; chunks divides seq. Returns the cudaError_t of the launch.
int attn_online_forward(const void* q, const void* k, const void* v,
                        const void* bias, void* out, int batch, int heads,
                        int seq, int head_dim, int chunks,
                        long long in_window, long long in_head,
                        long long in_token, long long out_window,
                        long long out_head, long long out_token,
                        int qkv_bf16, int bias_bf16, float scale,
                        void* stream) {
  if (!launchable(batch, seq, heads, head_dim, in_token, out_token) ||
      chunks <= 0 || seq % chunks != 0)
    return int(cudaErrorInvalidValue);
  const int chunk = seq / chunks;
  const Strides in{in_window, in_head, int(in_token)};
  const Strides os{out_window, out_head, int(out_token)};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (qkv_bf16) {
    return bias_bf16
        ? int(launch_typed<__nv_bfloat16, __nv_bfloat16>(
              q, k, v, in, bias, out, os, batch, heads, seq, head_dim, chunk,
              scale, s))
        : int(launch_typed<__nv_bfloat16, float>(
              q, k, v, in, bias, out, os, batch, heads, seq, head_dim, chunk,
              scale, s));
  }
  return bias_bf16
      ? int(launch_typed<float, __nv_bfloat16>(q, k, v, in, bias, out, os,
                                               batch, heads, seq, head_dim,
                                               chunk, scale, s))
      : int(launch_typed<float, float>(q, k, v, in, bias, out, os, batch,
                                       heads, seq, head_dim, chunk, scale,
                                       s));
}

}  // extern "C"
