// Bias-added multi-head attention over long windows, for Hopper (sm_90a): K3.
//
// Replaces fastervit_tpu/ops/pallas_flash_attention.py::_fwd_kernel (called
// through _flash_forward and flash_window_mhsa), the Q-tiled attention
// forward of the JAX package's large windows. For each window b and head h:
//
//   out[b, :, h*hd:(h+1)*hd] = softmax(q kᵀ·scale + bias[h]) · v
//
// with q, k and v read straight from the qkv projection output (B, S, 3C),
// channel layout (3, H, hd), as K1 (window_mhsa.cu) reads them. It takes any
// S >= 1 and hd <= 128, and never writes logits to device memory.
//
// Bound on this card: operations at the largest shape. FasterViT-4-21k at
// 768², batch 16, level 2 (B = 16 windows of S = 2304 tokens, H = 16,
// hd = 49, bf16) does 4·B·H·S²·hd = 266 GFLOP per call against 401 MB of
// qkv, bias and output: 0.27 ms at the bf16 tensor-core peak, 0.12 ms at the
// memory rate. Level 3 (S = 576, H = 32) is byte-bound: 137 MB, 0.04 ms.
//
// The TPU kernel keeps the whole K/V row of a head in VMEM and so needs no
// running softmax state. At S = 2304 that row is 451 KB of bf16, more than
// the 227 KB of shared memory a block may have, so this kernel streams K/V
// in tiles (FlashAttention-2): one block per (q-tile of kTile rows, window,
// head) keeps its q tile, a running row max and row sum in f32, and an f32
// accumulator rescaled at each K/V tile; the context is divided by the sum
// once at the end. The grid's x is the window, so the blocks that read the
// same (head, q-tile) bias slab run side by side and find it in L2: the
// bias, (H, S, S), is the largest operand (170 MB in bf16 per level-2 call)
// and every window reads it. This is the TPU kernel's "hqb" grid order.
//
// This first version is a scalar f32-FMA kernel: each of the 256 threads
// holds a 4×4 register tile of the 64×64 logits tile and a 4×(hd_pad/16)
// tile of the accumulator, fed from shared memory. It is far from its bound
// (see PERF.md); tensor-core tiles (mma.sync or wgmma) and TMA are the work
// of a later version.
//
// Numerics, as the plain version (ops/attention.py::
// window_mhsa_long_reference): logits q·kᵀ·scale + bias in f32;
// p = exp(logit − running max) in f32; Σp of the unrounded p in f32; p
// rounded to qkv's type for the PV product, which accumulates in f32; the
// context divided by Σp and written in qkv's type. The plain version takes
// p against the final row max; here each tile's p is against the running
// max and later rescaled, which differs only by rounding.
//
// The same kernel without the bias operand is P2: it replaces the kernel
// `_nobias_kernel` of scripts/attn_vpu_probe.py (called through
// `flash_nobias`, defined in its `main`), the TPU probe's copy of this
// attention with the bias taken out, softmax(q kᵀ·scale)·v. Its instance
// has no bias loads and no bias add, and reads q, k and v through strides:
// given views of K3's packed qkv it differs from K3 by the bias stream
// alone, which is what attn_vpu_probe measures; given separate
// (B, H, S, hd) tensors it is the probe's function on the probe's layout.
//
// hd is padded in shared memory only (v's columns to a multiple of 16
// above hd, as zeros). The tile steps are in attn_tiles.cuh. Plain C
// interface, bound with ctypes by fastervit_tpu_torch/ops/
// cuda_attention.py, which checks device, dtype, shape and layout.

#include <cmath>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "attn_tiles.cuh"
#include "dtype.cuh"

namespace {

using namespace fastervit::attn_tiles;
using fastervit::from_f32;
using fastervit::to_f32;

// NJ = hd_pad / 16: the accumulator columns each thread holds. kBias false
// is P2, whose bias is never read.
template <typename T, typename TB, bool kBias, int NJ>
__global__ void __launch_bounds__(kThreads)
window_mhsa_long_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, Strides in,
                        const TB* __restrict__ bias, T* __restrict__ out,
                        Strides os, int seq, int head_dim, float scale) {
  constexpr int kHdPad = 16 * NJ;
  extern __shared__ float smem[];
  const Smem sm(smem, head_dim);
  const int q0 = blockIdx.y * kTile;
  const long long at = slab(in);
  const int tx = threadIdx.x & 15;    // keys tx + 16j
  const int ty = threadIdx.x >> 4;    // rows ty + 16i
  const TB* bias_h = kBias ? bias + (long long)blockIdx.z * seq * seq
                           : nullptr;

  load_q<T, kHdPad>(q + at, in.token, q0, seq, head_dim, sm);
  float m[4], l[4], acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
  }

  for (int k0 = 0; k0 < seq; k0 += kTile) {
    __syncthreads();  // the previous tile's k, v and p are no longer read
    // 1. k (transposed) and v of keys k0 .. k0 + kTile; keys past S are 0.
    load_kv<T, kHdPad, true>(k + at, v + at, in.token, k0, seq, head_dim,
                             sm);
    __syncthreads();

    // 2. this thread's 4×4 logits: q kᵀ·scale (+ bias), f32.
    float sc[4][4];
    logits<TB, kBias>(sm, bias_h, q0, k0, seq, seq, head_dim, scale, sc);

    // 3. online softmax: every tile holds at least one key < S, so mnew
    //    is finite and alpha is 0 on the first tile.
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float tmax = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) tmax = fmaxf(tmax, sc[i][j]);
      const float mnew = fmaxf(m[i], row_max(tmax));
      const float alpha = expf(m[i] - mnew);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float pv = expf(sc[i][j] - mnew);
        psum += pv;
        sm.p[(ty + 16 * i) * kLd + tx + 16 * j] = to_f32(from_f32<T>(pv));
      }
      l[i] = fmaf(l[i], alpha, row_sum(psum));
      m[i] = mnew;
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

    // 4. acc += p · v over this tile's keys.
    accumulate_pv<NJ>(sm, min(kTile, seq - k0), acc);
  }

  // 5. out = acc / Σp, written as T.
  store<T, NJ>(out + slab(os), os.token, q0, seq, head_dim, acc, l);
}

template <typename T, typename TB, bool kBias>
cudaError_t launch_typed(const void* q, const void* k, const void* v,
                         Strides in, const void* bias, void* out, Strides os,
                         int batch, int heads, int seq, int head_dim,
                         float scale, cudaStream_t stream) {
  return with_nj(head_dim, [&](auto nj) {
    constexpr int NJ = decltype(nj)::value;
    return launch<NJ>(window_mhsa_long_kernel<T, TB, kBias, NJ>, batch, seq,
                      heads, head_dim, stream, static_cast<const T*>(q),
                      static_cast<const T*>(k), static_cast<const T*>(v), in,
                      static_cast<const TB*>(bias), static_cast<T*>(out), os,
                      seq, head_dim, scale);
  });
}

}  // namespace

extern "C" {

// K3. qkv: (batch, seq, 3·channels), channels (3, heads, hd); out: (batch,
// seq, channels); both f32 (qkv_bf16 = 0) or bf16 (qkv_bf16 = 1); bias:
// (heads, seq, seq), f32 or bf16 (bias_bf16), read as f32. Returns the
// cudaError_t of the launch.
int window_mhsa_long_forward(const void* qkv, const void* bias, void* out,
                             int batch, int seq, int channels, int heads,
                             int qkv_bf16, int bias_bf16, float scale,
                             void* stream) {
  if (heads <= 0 || channels % heads != 0 ||
      !launchable(batch, seq, heads, channels / heads, 3LL * channels,
                  channels))
    return int(cudaErrorInvalidValue);
  const int hd = channels / heads;
  const Strides in{(long long)seq * 3 * channels, hd, 3 * channels};
  const Strides os{(long long)seq * channels, hd, channels};
  const size_t esize = qkv_bf16 ? 2 : 4;
  const char* q = static_cast<const char*>(qkv);
  const char* k = q + channels * esize;
  const char* v = k + channels * esize;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (qkv_bf16) {
    return bias_bf16
        ? int(launch_typed<__nv_bfloat16, __nv_bfloat16, true>(
              q, k, v, in, bias, out, os, batch, heads, seq, hd, scale, s))
        : int(launch_typed<__nv_bfloat16, float, true>(
              q, k, v, in, bias, out, os, batch, heads, seq, hd, scale, s));
  }
  return bias_bf16
      ? int(launch_typed<float, __nv_bfloat16, true>(
            q, k, v, in, bias, out, os, batch, heads, seq, hd, scale, s))
      : int(launch_typed<float, float, true>(q, k, v, in, bias, out, os,
                                             batch, heads, seq, hd, scale,
                                             s));
}

// P2. q, k, v: (batch, heads, seq, head_dim) with element strides
// in_window, in_head, in_token (alike for the three, hd contiguous); out:
// the same shape with strides out_*; all f32 (bf16 = 0) or all bf16
// (bf16 = 1). Returns the cudaError_t of the launch.
int attn_nobias_forward(const void* q, const void* k, const void* v,
                        void* out, int batch, int heads, int seq,
                        int head_dim, long long in_window, long long in_head,
                        long long in_token, long long out_window,
                        long long out_head, long long out_token, int bf16,
                        float scale, void* stream) {
  if (!launchable(batch, seq, heads, head_dim, in_token, out_token))
    return int(cudaErrorInvalidValue);
  const Strides in{in_window, in_head, int(in_token)};
  const Strides os{out_window, out_head, int(out_token)};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? int(launch_typed<__nv_bfloat16, float, false>(
                    q, k, v, in, nullptr, out, os, batch, heads, seq,
                    head_dim, scale, s))
              : int(launch_typed<float, float, false>(
                    q, k, v, in, nullptr, out, os, batch, heads, seq,
                    head_dim, scale, s));
}

}  // extern "C"
