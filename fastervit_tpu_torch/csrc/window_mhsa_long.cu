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
// hd is padded in shared memory only (v's columns to a multiple of 16
// above hd, as zeros); q, k and v are read element by element, since at
// hd = 49 the head offsets are not aligned for vector loads. Every offset
// is computed in 64 bits. Plain C interface, bound with ctypes by
// fastervit_tpu_torch/ops/cuda_attention.py, which checks device, dtype,
// shape and contiguity.

#include <cmath>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "dtype.cuh"

namespace {

using fastervit::from_f32;
using fastervit::to_f32;

constexpr int kTile = 64;         // q rows per block, keys per K/V tile
constexpr int kThreads = 256;     // 16 × 16; each thread 4 rows × 4 keys
constexpr int kMaxHeadDim = 128;  // LONG_MAX_HEAD_DIM in cuda_attention.py
constexpr int kLd = kTile + 1;    // padded rows: no bank conflicts on the
                                  // transposed writes and p's two-row reads

// Shared memory, in floats: q and k transposed (hd × kLd each), p
// (kTile × kLd), v (kTile × hd_pad).
inline size_t smem_floats(int head_dim, int hd_pad) {
  return size_t(2 * head_dim + kTile) * kLd + size_t(kTile) * hd_pad;
}

// NJ = hd_pad / 16: the accumulator columns each thread holds.
template <typename T, typename TB, int NJ>
__global__ void __launch_bounds__(kThreads)
window_mhsa_long_kernel(const T* __restrict__ qkv, const TB* __restrict__ bias,
                        T* __restrict__ out, int seq, int channels, int heads,
                        float scale) {
  constexpr int kHdPad = 16 * NJ;
  extern __shared__ float smem[];
  const int head_dim = channels / heads;
  const long long b = blockIdx.x;
  const int q0 = blockIdx.y * kTile;
  const int h = blockIdx.z;
  float* qt = smem;                   // [d][row]
  float* kt = qt + head_dim * kLd;    // [d][key]
  float* p = kt + head_dim * kLd;     // [row][key]
  float* v = p + kTile * kLd;         // [key][d]
  const int tx = threadIdx.x & 15;    // keys tx + 16j, accumulator cols
  const int ty = threadIdx.x >> 4;    // rows ty + 16i

  const long long row = 3LL * channels;
  const T* src = qkv + b * seq * row + (long long)h * head_dim;

  // q tile, transposed; rows past S are zeros. v's padding columns are
  // zeroed once and never written again.
  for (int e = threadIdx.x; e < kTile * head_dim; e += kThreads) {
    const int r = e / head_dim, d = e - r * head_dim;
    const int s = q0 + r;
    qt[d * kLd + r] = s < seq ? to_f32(src[s * row + d]) : 0.f;
  }
  for (int e = threadIdx.x; e < kTile * (kHdPad - head_dim); e += kThreads) {
    const int c = e / (kHdPad - head_dim);
    v[c * kHdPad + head_dim + (e - c * (kHdPad - head_dim))] = 0.f;
  }

  float m[4], l[4], acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
  }
  const TB* bias_h = bias + (long long)h * seq * seq;

  for (int k0 = 0; k0 < seq; k0 += kTile) {
    __syncthreads();  // the previous tile's k, v and p are no longer read
    // 1. k (transposed) and v of keys k0 .. k0 + kTile; keys past S are 0.
    for (int e = threadIdx.x; e < kTile * head_dim; e += kThreads) {
      const int c = e / head_dim, d = e - c * head_dim;
      const int s = k0 + c;
      float kv = 0.f, vv = 0.f;
      if (s < seq) {
        const T* r = src + s * row + d;
        kv = to_f32(r[channels]);
        vv = to_f32(r[2 * channels]);
      }
      kt[d * kLd + c] = kv;
      v[c * kHdPad + d] = vv;
    }
    __syncthreads();

    // 2. this thread's 4×4 logits: q kᵀ, f32.
    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < head_dim; ++d) {
      float qa[4], ka[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qa[i] = qt[d * kLd + ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) ka[j] = kt[d * kLd + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] = fmaf(qa[i], ka[j], sc[i][j]);
    }

    // 3. ·scale + bias, online softmax. A row's 64 logits lie with the 16
    //    threads of one ty, in one half-warp: reduce with xor shuffles 8..1.
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = min(q0 + ty + 16 * i, seq - 1);  // rows past S: any row
      const TB* brow = bias_h + (long long)r * seq;
      float tmax = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = k0 + tx + 16 * j;
        sc[i][j] = c < seq ? fmaf(sc[i][j], scale, to_f32(brow[c]))
                           : -INFINITY;
        tmax = fmaxf(tmax, sc[i][j]);
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, o));
      // every tile holds at least one key < S, so mnew is finite and
      // alpha is 0 on the first tile
      const float mnew = fmaxf(m[i], tmax);
      const float alpha = expf(m[i] - mnew);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float pv = expf(sc[i][j] - mnew);
        psum += pv;
        p[(ty + 16 * i) * kLd + tx + 16 * j] = to_f32(from_f32<T>(pv));
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        psum += __shfl_xor_sync(0xffffffffu, psum, o);
      l[i] = fmaf(l[i], alpha, psum);
      m[i] = mnew;
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

    // 4. acc += p · v over this tile's keys.
    const int kn = min(kTile, seq - k0);
#pragma unroll 4
    for (int c = 0; c < kn; ++c) {
      float pa[4], va[NJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) pa[i] = p[(ty + 16 * i) * kLd + c];
#pragma unroll
      for (int j = 0; j < NJ; ++j) va[j] = v[c * kHdPad + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) acc[i][j] = fmaf(pa[i], va[j], acc[i][j]);
    }
  }

  // 5. out = acc / Σp, written as T.
  T* dst = out + b * seq * channels + (long long)h * head_dim;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r >= seq) continue;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int d = tx + 16 * j;
      if (d < head_dim) dst[r * (long long)channels + d] =
          from_f32<T>(acc[i][j] / l[i]);
    }
  }
}

template <typename T, typename TB, int NJ>
cudaError_t launch_nj(const void* qkv, const void* bias, void* out, int batch,
                      int seq, int channels, int heads, float scale,
                      cudaStream_t stream) {
  const size_t smem = smem_floats(channels / heads, 16 * NJ) * sizeof(float);
  auto kernel = window_mhsa_long_kernel<T, TB, NJ>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(unsigned(batch), unsigned((seq + kTile - 1) / kTile),
                  unsigned(heads));
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(qkv), static_cast<const TB*>(bias),
      static_cast<T*>(out), seq, channels, heads, scale);
  return cudaGetLastError();
}

// hd_pad: hd rounded up to 32, 64, 96 or 128.
template <typename T, typename TB>
cudaError_t launch(const void* qkv, const void* bias, void* out, int batch,
                   int seq, int channels, int heads, float scale,
                   cudaStream_t stream) {
  const int hd = channels / heads;
  if (hd <= 32)
    return launch_nj<T, TB, 2>(qkv, bias, out, batch, seq, channels, heads,
                               scale, stream);
  if (hd <= 64)
    return launch_nj<T, TB, 4>(qkv, bias, out, batch, seq, channels, heads,
                               scale, stream);
  if (hd <= 96)
    return launch_nj<T, TB, 6>(qkv, bias, out, batch, seq, channels, heads,
                               scale, stream);
  return launch_nj<T, TB, 8>(qkv, bias, out, batch, seq, channels, heads,
                             scale, stream);
}

}  // namespace

extern "C" {

// qkv: (batch, seq, 3·channels), out: (batch, seq, channels), both f32
// (qkv_bf16 = 0) or bf16 (qkv_bf16 = 1); bias: (heads, seq, seq), f32 or
// bf16 (bias_bf16), read as f32. Returns the cudaError_t of the launch.
int window_mhsa_long_forward(const void* qkv, const void* bias, void* out,
                             int batch, int seq, int channels, int heads,
                             int qkv_bf16, int bias_bf16, float scale,
                             void* stream) {
  if (batch <= 0 || seq <= 0 || heads <= 0 || heads > 65535 ||
      channels % heads != 0 || channels / heads > kMaxHeadDim ||
      (seq + kTile - 1) / kTile > 65535)
    return int(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (qkv_bf16) {
    return bias_bf16
        ? int(launch<__nv_bfloat16, __nv_bfloat16>(qkv, bias, out, batch, seq,
                                                   channels, heads, scale, s))
        : int(launch<__nv_bfloat16, float>(qkv, bias, out, batch, seq,
                                           channels, heads, scale, s));
  }
  return bias_bf16
      ? int(launch<float, __nv_bfloat16>(qkv, bias, out, batch, seq, channels,
                                         heads, scale, s))
      : int(launch<float, float>(qkv, bias, out, batch, seq, channels, heads,
                                 scale, s));
}

}  // extern "C"
