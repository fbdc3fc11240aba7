// Bias-added multi-head attention over small windows, for Hopper (sm_90a).
//
// Replaces fastervit_tpu/ops/pallas_attention.py::_mhsa_kernel, the packed
// window-attention forward of the JAX package. For each window b and head h:
//
//   out[b, :, h*hd:(h+1)*hd] = softmax(q kᵀ·scale + bias[h]) · v
//
// with q, k and v read straight from the qkv projection output (B, S, 3C),
// channel layout (3, H, hd): row stride 3C, column offsets h·hd, C + h·hd and
// 2C + h·hd. No head-split transpose runs outside the kernel. Logits and
// softmax are f32; the probabilities are rounded to the input type before
// the PV product (as pallas_attention.py casts p to v's dtype) and the PV
// product accumulates in f32.
//
// Bound on this card: memory. At FasterViT-0 level 2, batch 256, bf16
// (B = 1024 windows of S = 53 tokens, C = 256, H = 8, hd = 32) one call
// reads about 83 MB of qkv and writes 28 MB for about 2.9 GFLOP: roughly
// 26 FLOP/byte, far below the ~295 FLOP/byte at which an H100's bf16 tensor
// cores become the limit. So the design reads qkv once and keeps the S×S
// logits out of device memory: one thread block per (window, head) stages
// its q, k, v slice and its logits in shared memory.
//
// This first version does not reach that bound: at the shape above it took
// 0.5497 ms a call against 0.7489 ms for the plain PyTorch version (one
// H100, "NVIDIA H100 80GB HBM3, 700.00 W", chip_smoke.py), about 0.2 TB/s.
// Its two products are scalar FMA loops over shared memory, so shared-memory
// load issue, not device memory, is what limits it.
//
// The TPU kernel packed floor(128/S) windows into one sequence under a
// block-diagonal mask to fill the 128-wide MXU. On Hopper that mask only
// wastes work, so each window gets its own block here. Packing several
// windows per block onto mma/wgmma 64-row tiles is later work.
//
// Plain C interface, bound with ctypes by fastervit_tpu_torch/ops/
// cuda_attention.py, which checks device, dtype, shape and contiguity.

#include <climits>
#include <cmath>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "dtype.cuh"

namespace {

using fastervit::from_f32;
using fastervit::to_f32;

constexpr int kMaxSeq = 128;     // MAX_SEQ in cuda_attention.py
constexpr int kMaxHeadDim = 64;  // MAX_HEAD_DIM in cuda_attention.py
constexpr int kThreads = 128;

// Shared memory, in floats: q (S×hd), k (S×(hd+1), padded so that a warp
// reading one column of k hits 32 banks), v (S×hd), logits (S×S).
inline size_t smem_floats(int seq, int head_dim) {
  return size_t(seq) * (3 * head_dim + 1 + seq);
}

template <typename T, typename TB>
__global__ void __launch_bounds__(kThreads)
window_mhsa_kernel(const T* __restrict__ qkv, const TB* __restrict__ bias,
                   T* __restrict__ out, int seq, int channels, int heads,
                   float scale) {
  extern __shared__ float smem[];
  const int head_dim = channels / heads;
  const int h = blockIdx.x % heads;
  const long long b = blockIdx.x / heads;
  const int kstride = head_dim + 1;
  float* q = smem;
  float* k = q + seq * head_dim;
  float* v = k + seq * kstride;
  float* logits = v + seq * head_dim;

  // 1. q, k, v of head h, as f32.
  const long long row = 3LL * channels;
  const T* src = qkv + b * seq * row + h * head_dim;
  for (int e = threadIdx.x; e < seq * head_dim; e += blockDim.x) {
    const int s = e / head_dim, d = e - s * head_dim;
    const T* r = src + s * row + d;
    q[e] = to_f32(r[0]);
    k[s * kstride + d] = to_f32(r[channels]);
    v[e] = to_f32(r[2 * channels]);
  }
  __syncthreads();

  // 2. logits = q kᵀ·scale + bias[h], f32.
  const TB* bias_h = bias + (long long)h * seq * seq;
  for (int e = threadIdx.x; e < seq * seq; e += blockDim.x) {
    const int i = e / seq, j = e - i * seq;
    const float* qi = q + i * head_dim;
    const float* kj = k + j * kstride;
    float acc = 0.f;
    for (int d = 0; d < head_dim; ++d) acc = fmaf(qi[d], kj[d], acc);
    logits[e] = acc * scale + to_f32(bias_h[e]);
  }
  __syncthreads();

  // 3. Row softmax, one warp per row: max, exp, sum, divide. The result is
  //    rounded to T, as the reference casts p to v's dtype.
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  for (int i = warp; i < seq; i += warps) {
    float* li = logits + i * seq;
    float m = -INFINITY;
    for (int j = lane; j < seq; j += 32) m = fmaxf(m, li[j]);
    for (int o = 16; o > 0; o >>= 1)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    float sum = 0.f;
    for (int j = lane; j < seq; j += 32) {
      const float p = expf(li[j] - m);
      li[j] = p;
      sum += p;
    }
    for (int o = 16; o > 0; o >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, o);
    for (int j = lane; j < seq; j += 32)
      li[j] = to_f32(from_f32<T>(li[j] / sum));
  }
  __syncthreads();

  // 4. out = p · v, accumulated in f32, written as T.
  T* dst = out + b * seq * channels + h * head_dim;
  for (int e = threadIdx.x; e < seq * head_dim; e += blockDim.x) {
    const int i = e / head_dim, d = e - i * head_dim;
    const float* pi = logits + i * seq;
    float acc = 0.f;
    for (int j = 0; j < seq; ++j) acc = fmaf(pi[j], v[j * head_dim + d], acc);
    dst[(long long)i * channels + d] = from_f32<T>(acc);
  }
}

template <typename T, typename TB>
cudaError_t launch(const void* qkv, const void* bias, void* out, int batch,
                   int seq, int channels, int heads, float scale,
                   cudaStream_t stream) {
  const size_t smem = smem_floats(seq, channels / heads) * sizeof(float);
  auto kernel = window_mhsa_kernel<T, TB>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (err != cudaSuccess) return err;
  }
  kernel<<<unsigned(batch) * unsigned(heads), kThreads, smem, stream>>>(
      static_cast<const T*>(qkv), static_cast<const TB*>(bias),
      static_cast<T*>(out), seq, channels, heads, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// qkv: (batch, seq, 3·channels), out: (batch, seq, channels), both f32
// (qkv_bf16 = 0) or bf16 (qkv_bf16 = 1); bias: (heads, seq, seq), f32 or
// bf16 (bias_bf16), read as f32. Returns the cudaError_t of the launch.
int window_mhsa_forward(const void* qkv, const void* bias, void* out,
                        int batch, int seq, int channels, int heads,
                        int qkv_bf16, int bias_bf16, float scale,
                        void* stream) {
  if (batch <= 0 || seq <= 0 || seq > kMaxSeq || heads <= 0 ||
      channels % heads != 0 || channels / heads > kMaxHeadDim ||
      (long long)batch * heads > INT_MAX)
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

const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
