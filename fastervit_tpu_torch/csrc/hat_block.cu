// One whole pre-LN HAT sub-block in one launch, for Hopper (sm_90a): K6.
//
// Replaces fastervit_tpu/ops/pallas_hat_block.py::_hat_block_kernel and its
// DropPath variant _hat_block_kernel_dp (the pallas_call of `_forward`).
// For x (B, S, C), per window b and token s:
//
//   x   = x + γ3 · (proj(MHSA(LN1(x), bias)) + proj_b) · dp1[b]
//   out = x + γ4 · (fc2(GELU(fc1(LN2(x)) + fc1_b)) + fc2_b) · dp2[b]
//
// with the roundings of the TPU kernel: LayerNorm (eps 1e-5) in f32; each
// product accumulated in f32, its bias added in f32, then the sum rounded
// to the compute type T (qkv, ctx and the GELU output h1); the attention's
// logits q kᵀ·scale + bias in f32, softmax with max subtraction and an
// exact division, the probabilities rounded to T before the PV product;
// the residual sums kept in f32; one final cast. GELU is the exact-erf form
// with Abramowitz-Stegun 7.1.26 for erf, as the TPU kernel's. HAS_DP
// scales the two residual branches by the per-window f32 factors dp1, dp2.
//
// Bound on this card: operations. At FasterViT-0 batch 256 a forward's 17
// sub-blocks do about 970 GFLOP of products for about 0.3 GB of device
// traffic, ~0.98 ms at the bf16 tensor-core peak.
//
// Design. A block owns whole windows, as many as fit in kMaxRows = 64
// tokens and in shared memory (4 carrier windows of 16, one joint window of
// 53, one level-3 window of 49), so no two blocks depend on each other. The
// windows' f32 residual x32 (rows × C) stays in shared memory from the load
// of x to the store of out; at level 3 (S 49, C 512) that is 100 KB of the
// 227 KB a block may use, so the larger intermediates go elsewhere:
//  - LayerNorm is applied on load from per-row (mean, rstd) (scalar path),
//    or written once as bf16 into shared memory (tensor-core path: 66 KB at
//    level 3);
//  - the attention runs one head at a time on that head's q, k, v (rows ×
//    3·hd, f32 in shared memory), and its context (rounded to T) goes to a
//    per-block slice of a scratch tensor in device memory, which the proj
//    product then reads;
//  - h1 (rows × hidden, rounded to T), and on the tensor-core path the
//    whole qkv, go to the scratch too, which the next product reads.
// The scratch is written and read back by the same block at once, so it
// mostly stays in the 50 MB L2. Weights are read as nn.Linear holds them
// (out, in), from L2 (1.6-6.3 MB at FasterViT-0's sites).
//
// Products. fp32 (and bf16 at widths that are not multiples of 32): one
// block-wide scalar-FMA loop, a 64 × 64 output tile, 4 × 4 outputs a
// thread, operands staged as f32 through shared memory 32 deep, so that
// fp32 agrees with the plain version up to the order of sums. bf16 at
// FasterViT-0's widths: warp-level tensor cores (wmma 16 × 16 × 16, f32
// sums) on 64 × 64 output tiles, the operands' 32-deep slices double-
// buffered in shared memory by cp.async (block_gemm_tc). wgmma and TMA are
// later work. No atomics: each
// output has one owner and a fixed order of sums, so two launches give the
// same bits.
//
// Plain C interface, bound with ctypes by fastervit_tpu_torch/ops/
// cuda_hat_block.py, which checks device, dtype, shape and contiguity and
// allocates the output and the scratch.

#include <climits>
#include <cmath>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include "dtype.cuh"

namespace {

using fastervit::from_f32;
using fastervit::to_f32;

constexpr int kMaxRows = 64;     // tokens a block holds: _MAX_ROWS in python
constexpr int kMaxSeq = 64;      // MAX_SEQ in ops/cuda_hat_block.py
constexpr int kMaxHeadDim = 64;  // MAX_HEAD_DIM in ops/cuda_hat_block.py
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kNT = 64;          // output columns of a GEMM tile
constexpr int kKT = 32;          // depth of a GEMM step
constexpr int kTileStride = 65;  // a staged tile's row: 64 + 1 against bank
                                 // conflicts
constexpr int kTcK = 32;         // depth of a tensor-core GEMM step
constexpr int kTcLd = kTcK + 8;  // a staged bf16 row, padded against bank
                                 // conflicts
// the tensor-core GEMM's shared memory, in floats: bf16 double buffers of
// W and A (2 × 2 × 64 × kTcLd), then the warps' 16 × 16 f32 tiles
constexpr int kTcTileOffset = 2 * 2 * 64 * kTcLd / 2;
constexpr int kTcStageFloats = kTcTileOffset + kWarps * 256;
constexpr float kLnEps = 1e-5f;
constexpr int kSmemLimit = 232448;  // 227 KB, the most a block may use

// params, in PARAM_ORDER of ops/hat_block.py
enum {
  kLn1Scale, kLn1Bias, kQkvW, kQkvB, kProjW, kProjB, kGamma3, kLn2Scale,
  kLn2Bias, kFc1W, kFc1B, kFc2W, kFc2B, kGamma4, kNumParams
};

struct Args {
  const void* x;
  void* out;
  void* ctx;   // scratch (B·S + 64, C) in T
  void* big;   // scratch (B·S + 64, max(3C, hidden)) in T: qkv, then h1
  const void* bias;   // (H, S, S), f32 or bf16
  const float* dp1;   // (B,), HAS_DP only
  const float* dp2;
  const void* prm[kNumParams];  // matrices in T; vectors f32 or bf16
  int batch, seq, channels, hidden, heads, windows_per_block;
  int vec_bf16, bias_bf16;
  float scale;
};

// The row stride of a head's qkv in shared memory: odd, so that a warp
// reading one column of k across its rows hits 32 banks.
__host__ __device__ inline int qkv_stride(int head_dim) {
  return (3 * head_dim) | 1;
}


// The row stride of the scratch's wide part, which holds qkv (3C, tensor
// cores only) and then h1 (hidden).
__host__ __device__ inline int wide_stride(int channels, int hidden) {
  return max(3 * channels, hidden);
}

// floats of shared memory for the bf16 LayerNorm output of the tensor-core
// path: `rows` rounded up to 16, rows of C + 8 (against bank conflicts),
// rounded up to 32 bytes
__host__ __device__ inline int y16_floats(int rows, int channels) {
  const int bytes = ((rows + 15) / 16 * 16) * (channels + 8) * 2;
  return (bytes + 31) / 32 * 8;
}

// The block's shared memory, in floats: the layout at the top of
// hat_block_kernel
inline size_t smem_floats(int seq, int channels, int heads, int wpb,
                          bool tc) {
  const size_t rows = size_t(wpb) * seq;
  return (tc ? y16_floats(int(rows), channels) : 0)  // y16
         + rows * channels                // x32
         + 2 * kMaxRows                   // mean, rstd
         + 2 * size_t(channels)           // a LayerNorm's scale and bias
         + (tc ? kTcStageFloats           // the cp.async stage, or
               : 2 * kKT * kTileStride)   // staged A and W tiles
         + rows * qkv_stride(channels / heads)  // one head's qkv
         + rows * seq;                    // the head's logits
}

__device__ __forceinline__ float load_vec(const void* p, int i, int bf16) {
  return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i])
              : static_cast<const float*>(p)[i];
}

template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return to_f32(from_f32<T>(v));
}

__device__ __forceinline__ float erf_as(float x) {
  // Abramowitz-Stegun 7.1.26, |error| < 1.5e-7 (pallas_hat_block.py::_erf)
  const float ax = fabsf(x);
  const float t = 1.f / (1.f + 0.3275911f * ax);
  const float poly = t * (0.254829592f + t * (-0.284496736f + t * (
      1.421413741f + t * (-1.453152027f + t * 1.061405429f))));
  const float sign = x > 0.f ? 1.f : (x < 0.f ? -1.f : 0.f);
  return sign * (1.f - poly * expf(-ax * ax));
}

__device__ __forceinline__ float gelu(float x) {
  return 0.5f * x * (1.f + erf_as(x * 0.7071067811865476f));
}

// out(m, n) = Σ_k A(m, k) · W[n][k] for m < rows, n < cols, k < depth, in
// f32 with k in order, handed to epi(m, n, sum). load_a(m, k) gives A as f32
// (already rounded to the compute type); w_row(n) points at W's row n (of
// `depth` elements of type TW). As and Ws: kKT × kTileStride floats each.
// Ends with a barrier, so that what epi wrote is visible to the block.
template <typename TW, typename LoadA, typename WRow, typename Epi>
__device__ void block_gemm(int rows, int cols, int depth, LoadA load_a,
                           WRow w_row, Epi epi, float* As, float* Ws) {
  const int tid = threadIdx.x;
  const int tr = tid >> 4, tc = tid & 15;
  for (int n0 = 0; n0 < cols; n0 += kNT) {
    const int ncols = min(kNT, cols - n0);
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    for (int k0 = 0; k0 < depth; k0 += kKT) {
      const int kn = min(kKT, depth - k0);
      __syncthreads();  // the previous step's tiles are consumed
      // A tile, k-major: As[kk][m]; rows past `rows` are left as they are
      // (their outputs are dropped), the k tail is zero
      for (int e = tid; e < rows * kKT; e += kThreads) {
        const int m = e / kKT, kk = e - m * kKT;
        As[kk * kTileStride + m] = kk < kn ? load_a(m, k0 + kk) : 0.f;
      }
      for (int e = tid; e < ncols * kKT; e += kThreads) {
        const int nn = e / kKT, kk = e - nn * kKT;
        Ws[kk * kTileStride + nn] =
            kk < kn ? to_f32(static_cast<const TW*>(w_row(n0 + nn))[k0 + kk])
                    : 0.f;
      }
      __syncthreads();
#pragma unroll 8
      for (int kk = 0; kk < kKT; ++kk) {
        float a[4], w[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = As[kk * kTileStride + tr + 16 * i];
#pragma unroll
        for (int j = 0; j < 4; ++j) w[j] = Ws[kk * kTileStride + tc + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], w[j], acc[i][j]);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int m = tr + 16 * i, n = tc + 16 * j;
        if (m < rows && n < ncols) epi(m, n0 + n, acc[i][j]);
      }
  }
  __syncthreads();
}

// mean and 1/sqrt(var + eps) of each of x32's rows (pallas_hat_block.py::
// _ln), one warp a row; then the LayerNorm's scale and bias into lnv as f32.
__device__ void layer_norm_stats(const float* x32, int rows, int channels,
                                 float* mean, float* rstd, float* lnv,
                                 const void* scale, const void* bias,
                                 int vec_bf16) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int r = warp; r < rows; r += kWarps) {
    const float* xr = x32 + r * channels;
    float s = 0.f;
    for (int k = lane; k < channels; k += 32) s += xr[k];
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    const float mu = s / channels;
    float v = 0.f;
    for (int k = lane; k < channels; k += 32) {
      const float d = xr[k] - mu;
      v = fmaf(d, d, v);
    }
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    if (lane == 0) {
      mean[r] = mu;
      rstd[r] = 1.f / sqrtf(v / channels + kLnEps);
    }
  }
  for (int k = threadIdx.x; k < channels; k += kThreads) {
    lnv[k] = load_vec(scale, k, vec_bf16);
    lnv[channels + k] = load_vec(bias, k, vec_bf16);
  }
  __syncthreads();
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}

// The tensor-core form of block_gemm for bf16: out(m, n) = Σ_k A[m][k] ·
// W[n][k] for m < rows, n < cols, handed to epi(m, n, sum). A: bf16, row
// stride lda, in shared memory (A_GLOBAL false) or device memory (true; 64
// rows readable); W: (cols, depth) bf16 row-major in device memory; cols a
// multiple of 16, depth of kTcK, rows 16-byte aligned. A block computes 64 ×
// 64 output tiles: kTcK-deep slices of W (and of a device-memory A) are
// copied into a double buffer in shared memory with cp.async, the next
// while the tensor cores work on this one; warp w multiplies the 16-row
// slice w % 4 by the 16-column slices 2·(w / 4) and 2·(w / 4) + 1 (wmma
// 16 × 16 × 16, f32 sums) and hands its sums through a 16 × 16 f32 tile to
// epi. stage: kTcStageFloats of shared memory. Ends with a barrier.
template <bool A_GLOBAL, typename Epi>
__device__ void block_gemm_tc(int rows, int cols, int depth,
                              const __nv_bfloat16* A, int lda,
                              const __nv_bfloat16* W, Epi epi, float* stage) {
  namespace wmma = nvcuda::wmma;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int rs = warp & 3, cs = (warp >> 2) * 2;
  __nv_bfloat16* sb = reinterpret_cast<__nv_bfloat16*>(stage);  // [2][64][ld]
  __nv_bfloat16* sa = sb + 2 * 64 * kTcLd;                       // [2][64][ld]
  float* tile = stage + kTcTileOffset + warp * 256;
  const int steps = depth / kTcK;
  const int cr = tid >> 2, cc = (tid & 3) * 8;  // this thread's 16-byte copy
  const bool busy = rs * 16 < rows;             // warp-uniform
  for (int n0 = 0; n0 < cols; n0 += 64) {
    auto prefetch = [&](int step, int buf) {
      const int k0 = step * kTcK + cc;
      if (n0 + cr < cols)
        cp_async16(sb + (buf * 64 + cr) * kTcLd + cc,
                   W + (long long)(n0 + cr) * depth + k0);
      if (A_GLOBAL)
        cp_async16(sa + (buf * 64 + cr) * kTcLd + cc,
                   A + (long long)cr * lda + k0);
      asm volatile("cp.async.commit_group;\n" ::);
    };
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2];
    wmma::fill_fragment(acc[0], 0.f);
    wmma::fill_fragment(acc[1], 0.f);
    prefetch(0, 0);
    for (int step = 0; step < steps; ++step) {
      const int buf = step & 1;
      if (step + 1 < steps) {
        prefetch(step + 1, buf ^ 1);
        asm volatile("cp.async.wait_group 1;\n" ::);
      } else {
        asm volatile("cp.async.wait_group 0;\n" ::);
      }
      __syncthreads();
      if (busy) {
#pragma unroll
        for (int kk = 0; kk < kTcK; kk += 16) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                         wmma::row_major> x;
          if (A_GLOBAL)
            wmma::load_matrix_sync(
                x, sa + (buf * 64 + rs * 16) * kTcLd + kk, kTcLd);
          else
            wmma::load_matrix_sync(
                x, A + rs * 16 * lda + step * kTcK + kk, lda);
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                           wmma::col_major> y;
            wmma::load_matrix_sync(
                y, sb + (buf * 64 + (cs + j) * 16) * kTcLd + kk, kTcLd);
            wmma::mma_sync(acc[j], x, y, acc[j]);
          }
        }
      }
      __syncthreads();  // this buffer is refilled two steps on
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int nb = n0 + (cs + j) * 16;
      if (busy && nb < cols) {
        wmma::store_matrix_sync(tile, acc[j], 16, wmma::mem_row_major);
        __syncwarp();
        for (int e = lane; e < 256; e += 32) {
          const int m = rs * 16 + (e >> 4);
          if (m < rows) epi(m, nb + (e & 15), tile[e]);
        }
        __syncwarp();
      }
    }
  }
  __syncthreads();
}

// TC: the bf16 instantiation's products on tensor cores (block_gemm_tc),
// where the widths are multiples of 32 and the LayerNorm output fits in
// shared memory beside the rest; otherwise scalar FMA (block_gemm).
template <typename T, bool HAS_DP, bool TC>
__global__ void __launch_bounds__(kThreads) hat_block_kernel(const Args a) {
  extern __shared__ __align__(128) float smem[];
  const int seq = a.seq, channels = a.channels, hidden = a.hidden;
  const int head_dim = channels / a.heads;
  const int w0 = blockIdx.x * a.windows_per_block;
  const int windows = min(a.windows_per_block, a.batch - w0);
  const int rows = windows * seq;
  const int max_rows = a.windows_per_block * seq;
  const int ld = qkv_stride(head_dim);
  const int wide = wide_stride(channels, hidden);
  const int ldy = channels + 8;
  const long long row0 = (long long)w0 * seq;
  const int tid = threadIdx.x;

  // y16: the LayerNorm output as bf16, 16-row slices (TC only)
  __nv_bfloat16* y16 = reinterpret_cast<__nv_bfloat16*>(smem);
  float* x32 = smem + (TC ? y16_floats(max_rows, channels) : 0);
  float* mean = x32 + max_rows * channels;       // kMaxRows
  float* rstd = mean + kMaxRows;                 // kMaxRows
  float* lnv = rstd + kMaxRows;                  // 2 × C
  float* As = lnv + 2 * channels;                // kKT × kTileStride, or
  float* Ws = As + kKT * kTileStride;            // with Ws kTcStageFloats
  float* qkv = As + (TC ? kTcStageFloats         // for TC
                        : 2 * kKT * kTileStride);  // max_rows × ld
  float* logits = qkv + max_rows * ld;           // max_rows × S

  const T* x = static_cast<const T*>(a.x) + row0 * channels;
  T* out = static_cast<T*>(a.out) + row0 * channels;
  T* ctx = static_cast<T*>(a.ctx) + row0 * channels;
  T* big = static_cast<T*>(a.big) + row0 * wide;  // qkv (TC), then h1
  const T* qkv_w = static_cast<const T*>(a.prm[kQkvW]);
  const T* proj_w = static_cast<const T*>(a.prm[kProjW]);
  const T* fc1_w = static_cast<const T*>(a.prm[kFc1W]);
  const T* fc2_w = static_cast<const T*>(a.prm[kFc2W]);
  const int vb = a.vec_bf16;

  for (int e = tid; e < rows * channels; e += kThreads) x32[e] = to_f32(x[e]);
  __syncthreads();

  auto ln_on_load = [&](int m, int k) {
    return round_to<T>((x32[m * channels + k] - mean[m]) * rstd[m] * lnv[k]
                       + lnv[channels + k]);
  };
  // y16 = LN(x32) in bf16, the same values as ln_on_load's
  auto layer_norm_to_y16 = [&]() {
    for (int e = tid; e < rows * channels; e += kThreads) {
      const int m = e / channels, k = e - m * channels;
      y16[m * ldy + k] = __float2bfloat16(ln_on_load(m, k));
    }
    __syncthreads();
  };

  // --- attention branch ----------------------------------------------------
  layer_norm_stats(x32, rows, channels, mean, rstd, lnv, a.prm[kLn1Scale],
                   a.prm[kLn1Bias], vb);
  if constexpr (TC) {
    // the whole qkv product at once, rounded, into the scratch
    layer_norm_to_y16();
    block_gemm_tc<false>(
        rows, 3 * channels, channels, y16, ldy,
        reinterpret_cast<const __nv_bfloat16*>(qkv_w),
        [&](int m, int n, float acc) {
          big[(long long)m * wide + n] =
              from_f32<T>(acc + load_vec(a.prm[kQkvB], n, vb));
        },
        As);
  }
  for (int h = 0; h < a.heads; ++h) {
    // this head's q, k, v: columns part·C + h·hd + d of the qkv product,
    // kept as qkv[m][part·hd + d]
    if constexpr (TC) {
      for (int e = tid; e < rows * 3 * head_dim; e += kThreads) {
        const int m = e / (3 * head_dim), n = e - m * 3 * head_dim;
        const int part = n / head_dim;
        qkv[m * ld + n] = to_f32(big[(long long)m * wide + part * channels
                                     + h * head_dim + n - part * head_dim]);
      }
      __syncthreads();
    } else {
      block_gemm<T>(
          rows, 3 * head_dim, channels, ln_on_load,
          [&](int n) {
            const int part = n / head_dim;
            return qkv_w + (long long)(part * channels + h * head_dim
                                       + n - part * head_dim) * channels;
          },
          [&](int m, int n, float acc) {
            const int part = n / head_dim;
            const int col = part * channels + h * head_dim + n
                            - part * head_dim;
            qkv[m * ld + n] =
                round_to<T>(acc + load_vec(a.prm[kQkvB], col, vb));
          },
          As, Ws);
    }

    // logits = q kᵀ·scale + bias[h], f32, per window
    const long long bias_h = (long long)h * seq * seq;
    for (int e = tid; e < rows * seq; e += kThreads) {
      const int r = e / seq, j = e - r * seq;
      const int i = r % seq;
      const float* qi = qkv + r * ld;
      const float* kj = qkv + (r - i + j) * ld + head_dim;
      float acc = 0.f;
      for (int d = 0; d < head_dim; ++d) acc = fmaf(qi[d], kj[d], acc);
      logits[e] = acc * a.scale
                  + load_vec(a.bias, int(bias_h + i * seq + j), a.bias_bf16);
    }
    __syncthreads();

    // row softmax, one warp a row: max, exp, sum, exact division; p is
    // rounded to T, as the TPU kernel casts it to v's dtype
    const int lane = tid & 31, warp = tid >> 5;
    for (int r = warp; r < rows; r += kWarps) {
      float* lr = logits + r * seq;
      float mx = -INFINITY;
      for (int j = lane; j < seq; j += 32) mx = fmaxf(mx, lr[j]);
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      float sum = 0.f;
      for (int j = lane; j < seq; j += 32) {
        const float p = expf(lr[j] - mx);
        lr[j] = p;
        sum += p;
      }
      for (int o = 16; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      for (int j = lane; j < seq; j += 32) lr[j] = round_to<T>(lr[j] / sum);
    }
    __syncthreads();

    // ctx = p · v, f32 sums, rounded to T, into the scratch at h·hd
    for (int e = tid; e < rows * head_dim; e += kThreads) {
      const int r = e / head_dim, d = e - r * head_dim;
      const float* pr = logits + r * seq;
      const float* v = qkv + (r - r % seq) * ld + 2 * head_dim + d;
      float acc = 0.f;
      for (int j = 0; j < seq; ++j) acc = fmaf(pr[j], v[j * ld], acc);
      ctx[(long long)r * channels + h * head_dim + d] = from_f32<T>(acc);
    }
    __syncthreads();
  }

  // x32 += γ3 · (ctx · proj_wᵀ + proj_b) · dp1
  auto proj_epi = [&](int m, int n, float acc) {
    float delta = load_vec(a.prm[kGamma3], n, vb)
                  * (acc + load_vec(a.prm[kProjB], n, vb));
    if (HAS_DP) delta *= a.dp1[w0 + m / seq];
    x32[m * channels + n] += delta;
  };
  if constexpr (TC) {
    block_gemm_tc<true>(rows, channels, channels,
                  reinterpret_cast<const __nv_bfloat16*>(ctx), channels,
                  reinterpret_cast<const __nv_bfloat16*>(proj_w), proj_epi,
                  As);
  } else {
    block_gemm<T>(
        rows, channels, channels,
        [&](int m, int k) { return to_f32(ctx[(long long)m * channels + k]); },
        [&](int n) { return proj_w + (long long)n * channels; }, proj_epi,
        As, Ws);
  }

  // --- MLP branch -----------------------------------------------------------
  layer_norm_stats(x32, rows, channels, mean, rstd, lnv, a.prm[kLn2Scale],
                   a.prm[kLn2Bias], vb);
  // h1 = GELU(LN2(x32) · fc1_wᵀ + fc1_b), rounded to T, into the scratch
  auto fc1_epi = [&](int m, int n, float acc) {
    big[(long long)m * wide + n] =
        from_f32<T>(gelu(acc + load_vec(a.prm[kFc1B], n, vb)));
  };
  // x32 += γ4 · (h1 · fc2_wᵀ + fc2_b) · dp2
  auto fc2_epi = [&](int m, int n, float acc) {
    float delta = load_vec(a.prm[kGamma4], n, vb)
                  * (acc + load_vec(a.prm[kFc2B], n, vb));
    if (HAS_DP) delta *= a.dp2[w0 + m / seq];
    x32[m * channels + n] += delta;
  };
  if constexpr (TC) {
    layer_norm_to_y16();
    block_gemm_tc<false>(rows, hidden, channels, y16, ldy,
                  reinterpret_cast<const __nv_bfloat16*>(fc1_w), fc1_epi, As);
    block_gemm_tc<true>(rows, channels, hidden,
                  reinterpret_cast<const __nv_bfloat16*>(big), wide,
                  reinterpret_cast<const __nv_bfloat16*>(fc2_w), fc2_epi, As);
  } else {
    block_gemm<T>(
        rows, hidden, channels, ln_on_load,
        [&](int n) { return fc1_w + (long long)n * channels; }, fc1_epi, As,
        Ws);
    block_gemm<T>(
        rows, channels, hidden,
        [&](int m, int k) { return to_f32(big[(long long)m * wide + k]); },
        [&](int n) { return fc2_w + (long long)n * hidden; }, fc2_epi, As,
        Ws);
  }

  for (int e = tid; e < rows * channels; e += kThreads)
    out[e] = from_f32<T>(x32[e]);
}

template <typename T, bool HAS_DP, bool TC>
cudaError_t launch(const Args& a, size_t smem, unsigned blocks,
                   cudaStream_t stream) {
  auto kernel = hat_block_kernel<T, HAS_DP, TC>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  kernel<<<blocks, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

bool aligned32(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 31) == 0;
}

}  // namespace

extern "C" {

// ptrs: x (batch, seq, channels) and out, both f32 (x_bf16 = 0) or bf16;
// the scratch, in x's type: ctx ((batch·seq + 64), channels), then a wide
// part ((batch·seq + 64), max(3·channels, hidden)) for qkv and h1 (64 rows
// of padding that the tensor-core loads may read); bias (heads, seq, seq),
// f32 or bf16 (bias_bf16); dp1 and dp2, (batch,) f32 (read only when
// has_dp); then the 14 params in PARAM_ORDER of ops/hat_block.py: the
// matrices qkv_w (3C, C), proj_w (C, C), fc1_w (hidden, C), fc2_w (C,
// hidden) in x's type, the vectors all f32 (vec_bf16 = 0) or all bf16.
// wpb: whole windows a block holds, and tc: the bf16 products on tensor
// cores, both as ops/cuda_hat_block.py::plan chose them; checked here, not
// chosen. Returns the cudaError_t of the launch.
int hat_block_forward(const void* const* ptrs, int batch, int seq,
                      int channels, int hidden, int heads, int wpb, int tc,
                      int x_bf16, int vec_bf16, int bias_bf16, int has_dp,
                      float scale, void* stream) {
  if (batch <= 0 || seq <= 0 || seq > kMaxSeq || heads <= 0 ||
      channels <= 0 || channels % heads != 0 ||
      channels / heads > kMaxHeadDim || hidden <= 0 || wpb <= 0 ||
      wpb * seq > kMaxRows)
    return int(cudaErrorInvalidValue);
  // tensor cores: bf16, widths that are multiples of the step, operands
  // 32-byte aligned
  const int operands[] = {2, 3, 7 + kQkvW, 7 + kProjW, 7 + kFc1W, 7 + kFc2W};
  if (tc) {
    if (!x_bf16 || channels % kTcK != 0 || hidden % kTcK != 0)
      return int(cudaErrorInvalidValue);
    for (int i : operands)
      if (!aligned32(ptrs[i])) return int(cudaErrorInvalidValue);
  }
  const size_t smem = smem_floats(seq, channels, heads, wpb, tc) *
                      sizeof(float);
  const long long blocks = (batch + wpb - 1) / wpb;
  if (smem > size_t(kSmemLimit) || blocks > INT_MAX ||
      (long long)heads * seq * seq > INT_MAX)
    return int(cudaErrorInvalidValue);
  Args a;
  a.x = ptrs[0];
  a.out = const_cast<void*>(ptrs[1]);
  a.ctx = const_cast<void*>(ptrs[2]);
  a.big = const_cast<void*>(ptrs[3]);
  a.bias = ptrs[4];
  a.dp1 = static_cast<const float*>(ptrs[5]);
  a.dp2 = static_cast<const float*>(ptrs[6]);
  for (int i = 0; i < kNumParams; ++i) a.prm[i] = ptrs[7 + i];
  a.batch = batch;
  a.seq = seq;
  a.channels = channels;
  a.hidden = hidden;
  a.heads = heads;
  a.windows_per_block = wpb;
  a.vec_bf16 = vec_bf16;
  a.bias_bf16 = bias_bf16;
  a.scale = scale;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned nb = unsigned(blocks);
  if (!x_bf16)
    return has_dp ? int(launch<float, true, false>(a, smem, nb, s))
                  : int(launch<float, false, false>(a, smem, nb, s));
  if (tc)
    return has_dp ? int(launch<__nv_bfloat16, true, true>(a, smem, nb, s))
                  : int(launch<__nv_bfloat16, false, true>(a, smem, nb, s));
  return has_dp ? int(launch<__nv_bfloat16, true, false>(a, smem, nb, s))
                : int(launch<__nv_bfloat16, false, false>(a, smem, nb, s));
}

// The dynamic shared memory, in bytes, of a block that holds wpb windows of
// seq tokens, with (tc = 1) or without tensor cores: what
// ops/cuda_hat_block.py::_smem computes, for the card tests to hold it to.
long long hat_block_smem_bytes(int seq, int channels, int heads, int wpb,
                               int tc) {
  return (long long)(smem_floats(seq, channels, heads, wpb, tc) *
                     sizeof(float));
}

}  // extern "C"
