// Backward of the bias-added window attention, for Hopper (sm_90a).
//
// Replaces fastervit_tpu/ops/pallas_attention.py::_mhsa_bwd_kernel, the
// Pallas backward behind fused_window_mhsa's custom VJP. For each window b
// and head h, with P recomputed from q, k and the bias (f32, not rounded):
//
//   dP = g·vᵀ,  dl = P∘(dP − rowsum(dP∘P)),
//   dq = dl·k·scale,  dk = dlᵀ·q·scale,  dv = Pᵀ·g,
//   dbias[h] = Σ_b dl
//
// q, k and v are read from qkv (B, S, 3C), channel layout (3, H, hd), at
// row stride 3C and column offsets h·hd, C + h·hd and 2C + h·hd, g from
// (B, S, C); dq, dk and dv are written to dqkv at qkv's offsets. No
// head-split transpose runs outside the kernel. All arithmetic is f32.
//
// dbias: the TPU kernel carries one sum through its sequential grid. Here
// blocks run in parallel and in no order, so each block takes one head and
// a run of `per_block` windows, sums its dl in f32 shared memory and writes
// that partial sum to an f32 scratch (groups, H, S, S). A second kernel sums
// the partials over the groups in a fixed order and casts once to the
// bias's type, so dbias is the same from run to run.
//
// The TPU kernel packed floor(128/S) windows under a block-diagonal -1e30
// bias to fill the MXU and summed the diagonal blocks of dbias afterwards.
// On Hopper that mask only wastes work, as in the forward, so a window is
// never packed with another here.
//
// Bound on this card: memory. At FasterViT-0's training shapes, batch 128,
// bf16, a call must read qkv and g and write dqkv: at (B, S, H, hd) =
// (512, 53, 8, 32) 97.3 MB, 29.0 µs at 3.35 TB/s, against 3.7 GFLOP of
// products (5 of 2·S²·hd per window and head), 4 µs on the tensor cores.
// One training step's 17 calls come to about 0.25 ms. This first version is
// scalar FMA loops over shared memory, as K1's forward is, and will not
// reach that bound: shared-memory load issue limits it.
//
// Plain C interface, bound with ctypes by fastervit_tpu_torch/ops/
// cuda_attention.py, which checks device, dtype, shape and contiguity and
// allocates the outputs and the scratch.

#include <climits>
#include <cmath>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "dtype.cuh"

namespace {

using fastervit::from_f32;
using fastervit::to_f32;

constexpr int kMaxSeq = 64;      // BWD_MAX_SEQ in cuda_attention.py
constexpr int kMaxHeadDim = 64;  // BWD_MAX_HEAD_DIM in cuda_attention.py
constexpr int kThreads = 256;
constexpr int kSumThreads = 256;

// Shared memory, in floats: q and g (S×hd each, read along rows), k and v
// (S×(hd+1) each, padded so that a warp reading one column hits 32 banks),
// P, dl and the dbias accumulator (S×S each). 115 KB at S = hd = 64.
inline size_t smem_floats(int seq, int head_dim) {
  return size_t(seq) * (4 * head_dim + 2 + 3 * seq);
}

template <typename T, typename TB>
__global__ void __launch_bounds__(kThreads)
window_mhsa_bwd_kernel(const T* __restrict__ qkv, const TB* __restrict__ bias,
                       const T* __restrict__ g, T* __restrict__ dqkv,
                       float* __restrict__ dbias_partial, int batch, int seq,
                       int channels, int heads, int per_block, float scale) {
  extern __shared__ float smem[];
  const int head_dim = channels / heads;
  const int h = blockIdx.x;
  const int group = blockIdx.y;
  const int kstride = head_dim + 1;
  const int nn = seq * seq;
  float* q = smem;
  float* gs = q + seq * head_dim;
  float* k = gs + seq * head_dim;
  float* v = k + seq * kstride;
  float* p = v + seq * kstride;
  float* dl = p + nn;
  float* acc = dl + nn;

  for (int e = threadIdx.x; e < nn; e += blockDim.x) acc[e] = 0.f;

  const TB* bias_h = bias + (long long)h * nn;
  const long long row = 3LL * channels;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  const long long first = (long long)group * per_block;
  const long long last = min((long long)batch, first + per_block);

  for (long long b = first; b < last; ++b) {
    // 1. q, k, v of head h and its slice of g, as f32. The barrier first
    //    lets the previous window's readers finish.
    __syncthreads();
    const T* src = qkv + b * seq * row + h * head_dim;
    const T* gsrc = g + b * seq * channels + h * head_dim;
    for (int e = threadIdx.x; e < seq * head_dim; e += blockDim.x) {
      const int s = e / head_dim, d = e - s * head_dim;
      const T* r = src + s * row + d;
      q[e] = to_f32(r[0]);
      k[s * kstride + d] = to_f32(r[channels]);
      v[s * kstride + d] = to_f32(r[2 * channels]);
      gs[e] = to_f32(gsrc[(long long)s * channels + d]);
    }
    __syncthreads();

    // 2. logits = q kᵀ·scale + bias[h] into p, and dP = g vᵀ into dl.
    for (int e = threadIdx.x; e < nn; e += blockDim.x) {
      const int i = e / seq, j = e - i * seq;
      const float* qi = q + i * head_dim;
      const float* gi = gs + i * head_dim;
      const float* kj = k + j * kstride;
      const float* vj = v + j * kstride;
      float logit = 0.f, dp = 0.f;
      for (int d = 0; d < head_dim; ++d) {
        logit = fmaf(qi[d], kj[d], logit);
        dp = fmaf(gi[d], vj[d], dp);
      }
      p[e] = logit * scale + to_f32(bias_h[e]);
      dl[e] = dp;
    }
    __syncthreads();

    // 3. One warp per row: P = softmax(logits), then
    //    dl = P∘(dP − rowsum(dP∘P)), added into the dbias accumulator.
    for (int i = warp; i < seq; i += warps) {
      float* pi = p + i * seq;
      float* di = dl + i * seq;
      float m = -INFINITY;
      for (int j = lane; j < seq; j += 32) m = fmaxf(m, pi[j]);
      for (int o = 16; o > 0; o >>= 1)
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
      float sum = 0.f;
      for (int j = lane; j < seq; j += 32) {
        const float e = expf(pi[j] - m);
        pi[j] = e;
        sum += e;
      }
      for (int o = 16; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      float dot = 0.f;
      for (int j = lane; j < seq; j += 32) {
        pi[j] /= sum;
        dot = fmaf(di[j], pi[j], dot);
      }
      for (int o = 16; o > 0; o >>= 1)
        dot += __shfl_xor_sync(0xffffffffu, dot, o);
      for (int j = lane; j < seq; j += 32) {
        di[j] = pi[j] * (di[j] - dot);
        acc[i * seq + j] += di[j];
      }
    }
    __syncthreads();

    // 4. Thread (i, d) writes dq[i, d], dk[i, d] and dv[i, d]:
    //    dq = dl·k·scale, dk = dlᵀ·q·scale, dv = Pᵀ·g.
    T* dst = dqkv + b * seq * row + h * head_dim;
    for (int e = threadIdx.x; e < seq * head_dim; e += blockDim.x) {
      const int i = e / head_dim, d = e - i * head_dim;
      const float* dli = dl + i * seq;
      float dq = 0.f, dk = 0.f, dv = 0.f;
      for (int t = 0; t < seq; ++t) {
        dq = fmaf(dli[t], k[t * kstride + d], dq);
        dk = fmaf(dl[t * seq + i], q[t * head_dim + d], dk);
        dv = fmaf(p[t * seq + i], gs[t * head_dim + d], dv);
      }
      T* r = dst + i * row + d;
      r[0] = from_f32<T>(dq * scale);
      r[channels] = from_f32<T>(dk * scale);
      r[2 * channels] = from_f32<T>(dv);
    }
  }

  // 5. This block's share of dbias[h], f32, into its slot of the scratch.
  __syncthreads();
  float* part = dbias_partial + ((long long)group * heads + h) * nn;
  for (int e = threadIdx.x; e < nn; e += blockDim.x) part[e] = acc[e];
}

// dbias[e] = Σ_group partial[group, e], summed in group order, cast once.
template <typename TB>
__global__ void __launch_bounds__(kSumThreads)
dbias_sum_kernel(const float* __restrict__ partial, TB* __restrict__ dbias,
                 int groups, long long n) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  float sum = 0.f;
  for (int grp = 0; grp < groups; ++grp) sum += partial[grp * n + e];
  dbias[e] = from_f32<TB>(sum);
}

template <typename T, typename TB>
cudaError_t launch(const void* qkv, const void* bias, const void* g,
                   void* dqkv, void* dbias, float* partial, int batch,
                   int seq, int channels, int heads, int per_block,
                   int groups, float scale, cudaStream_t stream) {
  const size_t smem = smem_floats(seq, channels / heads) * sizeof(float);
  auto kernel = window_mhsa_bwd_kernel<T, TB>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (err != cudaSuccess) return err;
  }
  kernel<<<dim3(unsigned(heads), unsigned(groups)), kThreads, smem, stream>>>(
      static_cast<const T*>(qkv), static_cast<const TB*>(bias),
      static_cast<const T*>(g), static_cast<T*>(dqkv), partial, batch, seq,
      channels, heads, per_block, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long n = (long long)heads * seq * seq;
  dbias_sum_kernel<TB><<<unsigned((n + kSumThreads - 1) / kSumThreads),
                         kSumThreads, 0, stream>>>(
      partial, static_cast<TB*>(dbias), groups, n);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// qkv and dqkv: (batch, seq, 3·channels); g: (batch, seq, channels); all
// f32 (qkv_bf16 = 0) or all bf16 (qkv_bf16 = 1). bias and dbias: (heads,
// seq, seq), f32 or bf16 (bias_bf16). dbias_partial: f32 scratch of
// (groups, heads, seq, seq), where block (h, group) takes windows
// [group·per_block, (group + 1)·per_block) ∩ [0, batch). Returns the
// cudaError_t of the first launch that failed, or 0.
int window_mhsa_backward(const void* qkv, const void* bias, const void* g,
                         void* dqkv, void* dbias, void* dbias_partial,
                         int batch, int seq, int channels, int heads,
                         int per_block, int groups, int qkv_bf16,
                         int bias_bf16, float scale, void* stream) {
  if (batch <= 0 || seq <= 0 || seq > kMaxSeq || heads <= 0 ||
      channels % heads != 0 || channels / heads > kMaxHeadDim ||
      per_block <= 0 || groups <= 0 || groups > 65535 ||
      (long long)per_block * groups < batch ||
      (long long)per_block * (groups - 1) >= batch)
    return int(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* partial = static_cast<float*>(dbias_partial);
  if (qkv_bf16) {
    return bias_bf16
        ? int(launch<__nv_bfloat16, __nv_bfloat16>(
              qkv, bias, g, dqkv, dbias, partial, batch, seq, channels, heads,
              per_block, groups, scale, s))
        : int(launch<__nv_bfloat16, float>(
              qkv, bias, g, dqkv, dbias, partial, batch, seq, channels, heads,
              per_block, groups, scale, s));
  }
  return bias_bf16
      ? int(launch<float, __nv_bfloat16>(qkv, bias, g, dqkv, dbias, partial,
                                         batch, seq, channels, heads,
                                         per_block, groups, scale, s))
      : int(launch<float, float>(qkv, bias, g, dqkv, dbias, partial, batch,
                                 seq, channels, heads, per_block, groups,
                                 scale, s));
}

}  // extern "C"
