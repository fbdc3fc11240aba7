// Backward of the bias-added attention over long windows, for Hopper
// (sm_90a): K4.
//
// Replaces fastervit_tpu/ops/pallas_flash_attention.py::_flash_backward, the
// two Pallas kernels behind flash_window_mhsa's custom VJP: _bwd_dq_kernel
// (dq and dbias) and _bwd_dkv_kernel (dk and dv). For each window b and
// head h, with P recomputed from q, k and the bias:
//
//   P = softmax(q kᵀ·scale + bias[h])  (f32, normalised, not rounded),
//   dP = g·vᵀ,  dl = P∘(dP − rowsum(dP∘P)),
//   dq = dl·k·scale,  dk = dlᵀ·q·scale,  dv = Pᵀ·g,
//   dbias[h] = Σ_b dl
//
// q, k and v are read from qkv (B, S, 3C), channel layout (3, H, hd), g from
// (B, S, C); dq, dk and dv are written to dqkv at qkv's offsets. It takes any
// S >= 1 and hd <= 128, K3's limits (window_mhsa_long.cu), and never writes
// a (B, H, S, S) tensor to device memory.
//
// Bound on this card: operations at the large windows. FasterViT-4-21k at
// 384², batch 32, level 2 (B = 32 windows of S = 576, H = 16, hd = 49,
// bf16): five products of 2·S²·hd per window and head, 83 GFLOP, 0.08 ms at
// the bf16 tensor-core peak, against 224 MB of qkv, g, dqkv, bias and
// dbias, 0.067 ms at the memory rate. Level 3 (S = 144, H = 32) is
// byte-bound: 10 GFLOP against 104 MB.
//
// The TPU kernels keep a whole K/V row of a head in VMEM and carry their sums
// through a grid that runs in order: the batch innermost for dbias, the
// q-tile innermost for dk and dv. On Hopper blocks run in no order, and K/V
// of a head (451 KB of bf16 at S = 2304) do not fit in a block's 227 KB of
// shared memory. So K4 streams 64-token tiles, in four launches on the
// caller's stream:
//
//  1. row statistics: one block per (window, 64-row q-tile, head) runs over
//     the key tiles once and keeps, online with K3's rescaling, the row max
//     m, the row sum l of exp(logit − m), and Σ exp(logit − m)·dP. It writes
//     L = m + log l and D = rowsum(dP∘P), both f32, to a (2, B, H, S)
//     scratch. D is the exact rowsum(dP∘P) of the TPU kernels, not
//     FlashAttention's rowsum(dO∘O), which would read a rounded output.
//  2. dq and dbias: one block per (group of windows, q-tile, head) runs over
//     its windows and, for each, over the key tiles: P = exp(logit − L),
//     dl = P∘(dP − D); dq accumulates in registers in f32 and is written
//     once per window. dl is summed over the group's windows, in window
//     order, into the group's own f32 slab of a (groups, H, S, S) scratch,
//     which only this block touches: no atomics.
//  3. dk and dv: one block per (window, 64-key tile, head) runs over the
//     q-tiles and sums dk and dv in f32 registers. (The TPU kernel sums them
//     in qkv's type across its q-tiles; the f32 sum is the more exact one.)
//  4. dbias: a second kernel sums the groups' slabs in group order and casts
//     once to the bias's type, as K2 does (window_mhsa_bwd.cu). dbias is the
//     same bits from run to run.
//
// This first version is a scalar f32-FMA kernel, as K3 is: each of the 256
// threads holds a 4×4 register tile of a 64×64 logits tile and a
// 4×(hd_pad/16) tile of each accumulator, fed from shared memory. It
// recomputes q kᵀ and g vᵀ in each of the three passes, nine products where
// five would do, and is far from its bound (see PERF.md); tensor-core tiles
// (mma.sync or wgmma) and TMA are the work of a later version.
//
// Tiles are kept [token][d] in shared memory with a row stride of
// hd_pad + 1 floats (odd: no bank conflicts on reads along d); the ragged
// last q- and key tile are masked to zeros; every offset is computed in 64
// bits. Plain C interface, bound with ctypes by fastervit_tpu_torch/ops/
// cuda_attention.py, which checks device, dtype, shape and contiguity and
// allocates the outputs and the scratch.

#include <cmath>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "dtype.cuh"

namespace {

using fastervit::from_f32;
using fastervit::to_f32;

constexpr int kTile = 64;         // q rows and keys per tile
constexpr int kThreads = 256;     // 16 × 16; each thread 4 rows × 4 keys
constexpr int kMaxHeadDim = 128;  // LONG_MAX_HEAD_DIM in cuda_attention.py
constexpr int kLd = kTile + 1;    // row stride of the P and dl tiles
constexpr int kSumThreads = 256;

// Rows t0 .. t0 + kTile of one head of a token-major tensor (src points at
// token 0, column h·hd; stride is the row length) into dst[r·ldh + d], as
// f32; rows past S are zeros.
template <typename T>
__device__ __forceinline__ void load_tile(float* dst, int ldh, const T* src,
                                          long long stride, int t0, int seq,
                                          int head_dim) {
  for (int e = threadIdx.x; e < kTile * head_dim; e += kThreads) {
    const int r = e / head_dim, d = e - r * head_dim;
    const int t = t0 + r;
    dst[r * ldh + d] = t < seq ? to_f32(src[t * stride + d]) : 0.f;
  }
}

// Columns head_dim .. ldh - 1 of n tiles of kTile rows, laid out one after
// another, to zero. Loads never write them again.
__device__ __forceinline__ void zero_padding(float* tiles, int n, int ldh,
                                             int head_dim) {
  const int w = ldh - head_dim;
  for (int e = threadIdx.x; e < n * kTile * w; e += kThreads) {
    const int r = e / w;
    tiles[r * ldh + head_dim + (e - r * w)] = 0.f;
  }
}

// This thread's 4×4 tiles of a·bᵀ and c·eᵀ over d < head_dim: rows
// ty + 16i of a and c, tokens tx + 16j of b and e.
__device__ __forceinline__ void two_products(
    const float* a, const float* b, const float* c, const float* e, int ldh,
    int head_dim, int ty, int tx, float ab[4][4], float ce[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) ab[i][j] = ce[i][j] = 0.f;
#pragma unroll 2
  for (int d = 0; d < head_dim; ++d) {
    float av[4], bv[4], cv[4], ev[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      av[i] = a[(ty + 16 * i) * ldh + d];
      cv[i] = c[(ty + 16 * i) * ldh + d];
      bv[i] = b[(tx + 16 * i) * ldh + d];
      ev[i] = e[(tx + 16 * i) * ldh + d];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        ab[i][j] = fmaf(av[i], bv[j], ab[i][j]);
        ce[i][j] = fmaf(cv[i], ev[j], ce[i][j]);
      }
  }
}

// 1. L and D of the rows of one (window, q-tile, head).
template <typename T, typename TB, int NJ>
__global__ void __launch_bounds__(kThreads)
long_bwd_stats_kernel(const T* __restrict__ qkv, const TB* __restrict__ bias,
                      const T* __restrict__ g, float* __restrict__ lse,
                      float* __restrict__ delta, int seq, int channels,
                      int heads, float scale) {
  constexpr int kLdh = 16 * NJ + 1;
  extern __shared__ float smem[];
  const int head_dim = channels / heads;
  const long long b = blockIdx.x;
  const int q0 = blockIdx.y * kTile;
  const int h = blockIdx.z;
  float* qs = smem;
  float* gs = qs + kTile * kLdh;
  float* ks = gs + kTile * kLdh;
  float* vs = ks + kTile * kLdh;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;

  const long long row = 3LL * channels;
  const T* src = qkv + b * seq * row + (long long)h * head_dim;
  load_tile(qs, kLdh, src, row, q0, seq, head_dim);
  load_tile(gs, kLdh, g + b * seq * channels + (long long)h * head_dim,
            channels, q0, seq, head_dim);

  float m[4], l[4], pd[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = pd[i] = 0.f;
  }
  const TB* bias_h = bias + (long long)h * seq * seq;

  for (int k0 = 0; k0 < seq; k0 += kTile) {
    __syncthreads();  // the previous tile's k and v are no longer read
    load_tile(ks, kLdh, src + channels, row, k0, seq, head_dim);
    load_tile(vs, kLdh, src + 2 * channels, row, k0, seq, head_dim);
    __syncthreads();
    float sc[4][4], dp[4][4];
    two_products(qs, ks, gs, vs, kLdh, head_dim, ty, tx, sc, dp);
    // A row's 64 logits lie with the 16 threads of one ty, in one
    // half-warp: reduce with xor shuffles 8..1.
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
      // every tile holds a key < S: mnew is finite, alpha 0 on the first
      const float mnew = fmaxf(m[i], tmax);
      const float alpha = expf(m[i] - mnew);
      float psum = 0.f, dsum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(sc[i][j] - mnew);  // 0 past S; dP is 0 there
        psum += p;
        dsum = fmaf(p, dp[i][j], dsum);
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1) {
        psum += __shfl_xor_sync(0xffffffffu, psum, o);
        dsum += __shfl_xor_sync(0xffffffffu, dsum, o);
      }
      l[i] = fmaf(l[i], alpha, psum);
      pd[i] = fmaf(pd[i], alpha, dsum);
      m[i] = mnew;
    }
  }

  if (tx == 0) {
    const long long base = (b * heads + h) * seq;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = q0 + ty + 16 * i;
      if (r < seq) {
        lse[base + r] = m[i] + logf(l[i]);
        delta[base + r] = pd[i] / l[i];
      }
    }
  }
}

// P and dl of this thread's 4×4 tile from its logits and dP, for rows
// q0 + ty + 16i and keys k0 + tx + 16j; zero outside S × S. Lr and Dr are
// the rows' L and D.
template <typename TB>
__device__ __forceinline__ void probs_and_dl(
    float sc[4][4], float dp[4][4], const TB* bias_h, const float* Lr,
    const float* Dr, int q0, int k0, int seq, int ty, int tx, float scale) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty + 16 * i;
    const TB* brow = bias_h + (long long)min(r, seq - 1) * seq;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = k0 + tx + 16 * j;
      float p = 0.f, dl = 0.f;
      if (r < seq && c < seq) {
        p = expf(fmaf(sc[i][j], scale, to_f32(brow[c])) - Lr[i]);
        dl = p * (dp[i][j] - Dr[i]);
      }
      sc[i][j] = p;
      dp[i][j] = dl;
    }
  }
}

// The rows' L and D (0 past S).
__device__ __forceinline__ void row_stats(const float* lse, const float* delta,
                                          long long base, int q0, int seq,
                                          int ty, float Lr[4], float Dr[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty + 16 * i;
    Lr[i] = r < seq ? lse[base + r] : 0.f;
    Dr[i] = r < seq ? delta[base + r] : 0.f;
  }
}

// 2. dq of the windows [group·per_block, (group + 1)·per_block) ∩ [0, B)
//    and their dl summed into the group's slab of dbias_partial.
template <typename T, typename TB, int NJ>
__global__ void __launch_bounds__(kThreads)
long_bwd_dq_kernel(const T* __restrict__ qkv, const TB* __restrict__ bias,
                   const T* __restrict__ g, const float* __restrict__ lse,
                   const float* __restrict__ delta, T* __restrict__ dqkv,
                   float* __restrict__ dbias_partial, int batch, int seq,
                   int channels, int heads, int per_block, float scale) {
  constexpr int kHdPad = 16 * NJ;
  constexpr int kLdh = kHdPad + 1;
  extern __shared__ float smem[];
  const int head_dim = channels / heads;
  const int group = blockIdx.x;
  const int q0 = blockIdx.y * kTile;
  const int h = blockIdx.z;
  float* qs = smem;
  float* gs = qs + kTile * kLdh;
  float* ks = gs + kTile * kLdh;
  float* vs = ks + kTile * kLdh;
  float* dls = vs + kTile * kLdh;  // [row][key]
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  zero_padding(smem, 4, kLdh, head_dim);

  const long long row = 3LL * channels;
  const TB* bias_h = bias + (long long)h * seq * seq;
  float* part = dbias_partial + ((long long)group * heads + h) * seq * seq;
  const long long first = (long long)group * per_block;
  const long long last = min((long long)batch, first + per_block);

  for (long long b = first; b < last; ++b) {
    const T* src = qkv + b * seq * row + (long long)h * head_dim;
    __syncthreads();  // the previous window's readers are done
    load_tile(qs, kLdh, src, row, q0, seq, head_dim);
    load_tile(gs, kLdh, g + b * seq * channels + (long long)h * head_dim,
              channels, q0, seq, head_dim);
    float Lr[4], Dr[4];
    row_stats(lse, delta, (b * heads + h) * seq, q0, seq, ty, Lr, Dr);
    float acc[4][NJ];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;

    for (int k0 = 0; k0 < seq; k0 += kTile) {
      __syncthreads();  // the previous tile's k and dl are no longer read
      load_tile(ks, kLdh, src + channels, row, k0, seq, head_dim);
      load_tile(vs, kLdh, src + 2 * channels, row, k0, seq, head_dim);
      __syncthreads();
      float sc[4][4], dp[4][4];
      two_products(qs, ks, gs, vs, kLdh, head_dim, ty, tx, sc, dp);
      probs_and_dl(sc, dp, bias_h, Lr, Dr, q0, k0, seq, ty, tx, scale);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = q0 + ty + 16 * i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = k0 + tx + 16 * j;
          dls[(ty + 16 * i) * kLd + tx + 16 * j] = dp[i][j];
          if (r < seq && c < seq) {
            // this block alone owns the slab; windows in order
            float* pp = part + (long long)r * seq + c;
            *pp = b == first ? dp[i][j] : *pp + dp[i][j];
          }
        }
      }
      __syncthreads();
      // acc += dl · k over this tile's keys
      const int kn = min(kTile, seq - k0);
#pragma unroll 4
      for (int c = 0; c < kn; ++c) {
        float da[4], ka[NJ];
#pragma unroll
        for (int i = 0; i < 4; ++i) da[i] = dls[(ty + 16 * i) * kLd + c];
#pragma unroll
        for (int j = 0; j < NJ; ++j) ka[j] = ks[c * kLdh + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < NJ; ++j) acc[i][j] = fmaf(da[i], ka[j], acc[i][j]);
      }
    }

    T* dst = dqkv + b * seq * row + (long long)h * head_dim;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = q0 + ty + 16 * i;
      if (r >= seq) continue;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int d = tx + 16 * j;
        if (d < head_dim) dst[r * row + d] = from_f32<T>(acc[i][j] * scale);
      }
    }
  }
}

// 3. dk and dv of one (window, key tile, head).
template <typename T, typename TB, int NJ>
__global__ void __launch_bounds__(kThreads)
long_bwd_dkv_kernel(const T* __restrict__ qkv, const TB* __restrict__ bias,
                    const T* __restrict__ g, const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dqkv,
                    int seq, int channels, int heads, float scale) {
  constexpr int kHdPad = 16 * NJ;
  constexpr int kLdh = kHdPad + 1;
  extern __shared__ float smem[];
  const int head_dim = channels / heads;
  const long long b = blockIdx.x;
  const int k0 = blockIdx.y * kTile;
  const int h = blockIdx.z;
  float* ks = smem;
  float* vs = ks + kTile * kLdh;
  float* qs = vs + kTile * kLdh;
  float* gs = qs + kTile * kLdh;
  float* ps = gs + kTile * kLdh;  // [row][key]
  float* dls = ps + kTile * kLd;  // [row][key]
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  zero_padding(smem, 4, kLdh, head_dim);

  const long long row = 3LL * channels;
  const T* src = qkv + b * seq * row + (long long)h * head_dim;
  const T* gsrc = g + b * seq * channels + (long long)h * head_dim;
  const TB* bias_h = bias + (long long)h * seq * seq;
  const long long base = (b * heads + h) * seq;
  load_tile(ks, kLdh, src + channels, row, k0, seq, head_dim);
  load_tile(vs, kLdh, src + 2 * channels, row, k0, seq, head_dim);

  // keys k0 + ty + 16i, columns tx + 16j
  float dk[4][NJ], dv[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) dk[i][j] = dv[i][j] = 0.f;

  for (int q0 = 0; q0 < seq; q0 += kTile) {
    __syncthreads();  // the previous tile's q, g, P and dl are no longer read
    load_tile(qs, kLdh, src, row, q0, seq, head_dim);
    load_tile(gs, kLdh, gsrc, channels, q0, seq, head_dim);
    __syncthreads();
    float Lr[4], Dr[4];
    row_stats(lse, delta, base, q0, seq, ty, Lr, Dr);
    float sc[4][4], dp[4][4];
    two_products(qs, ks, gs, vs, kLdh, head_dim, ty, tx, sc, dp);
    probs_and_dl(sc, dp, bias_h, Lr, Dr, q0, k0, seq, ty, tx, scale);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        ps[(ty + 16 * i) * kLd + tx + 16 * j] = sc[i][j];
        dls[(ty + 16 * i) * kLd + tx + 16 * j] = dp[i][j];
      }
    __syncthreads();
    // dv += Pᵀ·g and dk += dlᵀ·q over this tile's rows
    const int rn = min(kTile, seq - q0);
#pragma unroll 2
    for (int r = 0; r < rn; ++r) {
      float pa[4], la[4], ga[NJ], qa[NJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pa[i] = ps[r * kLd + ty + 16 * i];
        la[i] = dls[r * kLd + ty + 16 * i];
      }
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        ga[j] = gs[r * kLdh + tx + 16 * j];
        qa[j] = qs[r * kLdh + tx + 16 * j];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          dv[i][j] = fmaf(pa[i], ga[j], dv[i][j]);
          dk[i][j] = fmaf(la[i], qa[j], dk[i][j]);
        }
    }
  }

  T* dst = dqkv + b * seq * row + (long long)h * head_dim;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int c = k0 + ty + 16 * i;
    if (c >= seq) continue;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int d = tx + 16 * j;
      if (d < head_dim) {
        T* r = dst + c * row + d;
        r[channels] = from_f32<T>(dk[i][j] * scale);
        r[2 * channels] = from_f32<T>(dv[i][j]);
      }
    }
  }
}

// 4. dbias[e] = Σ_group partial[group, e], summed in group order, cast once.
template <typename TB>
__global__ void __launch_bounds__(kSumThreads)
long_dbias_sum_kernel(const float* __restrict__ partial,
                      TB* __restrict__ dbias, int groups, long long n) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  float sum = 0.f;
  for (int grp = 0; grp < groups; ++grp) sum += partial[grp * n + e];
  dbias[e] = from_f32<TB>(sum);
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(bytes));
}

template <typename T, typename TB, int NJ>
cudaError_t launch_nj(const void* qkv_, const void* bias_, const void* g_,
                      void* dqkv_, void* dbias, float* stats, float* partial,
                      int batch, int seq, int channels, int heads,
                      int per_block, int groups, float scale,
                      cudaStream_t stream) {
  const T* qkv = static_cast<const T*>(qkv_);
  const TB* bias = static_cast<const TB*>(bias_);
  const T* g = static_cast<const T*>(g_);
  T* dqkv = static_cast<T*>(dqkv_);
  float* lse = stats;
  float* delta = stats + (long long)batch * heads * seq;
  const size_t tile = size_t(kTile) * (16 * NJ + 1) * sizeof(float);
  const size_t pl = size_t(kTile) * kLd * sizeof(float);
  const size_t smem_stats = 4 * tile;
  const size_t smem_dq = 4 * tile + pl;
  const size_t smem_dkv = 4 * tile + 2 * pl;
  auto stats_k = long_bwd_stats_kernel<T, TB, NJ>;
  auto dq_k = long_bwd_dq_kernel<T, TB, NJ>;
  auto dkv_k = long_bwd_dkv_kernel<T, TB, NJ>;
  cudaError_t err;
  if ((err = allow_smem(stats_k, smem_stats)) != cudaSuccess) return err;
  if ((err = allow_smem(dq_k, smem_dq)) != cudaSuccess) return err;
  if ((err = allow_smem(dkv_k, smem_dkv)) != cudaSuccess) return err;
  const unsigned nt = unsigned((seq + kTile - 1) / kTile);

  stats_k<<<dim3(unsigned(batch), nt, unsigned(heads)), kThreads, smem_stats,
            stream>>>(qkv, bias, g, lse, delta, seq, channels, heads, scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  dq_k<<<dim3(unsigned(groups), nt, unsigned(heads)), kThreads, smem_dq,
         stream>>>(qkv, bias, g, lse, delta, dqkv, partial, batch, seq,
                   channels, heads, per_block, scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  dkv_k<<<dim3(unsigned(batch), nt, unsigned(heads)), kThreads, smem_dkv,
          stream>>>(qkv, bias, g, lse, delta, dqkv, seq, channels, heads,
                    scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const long long n = (long long)heads * seq * seq;
  long_dbias_sum_kernel<TB><<<unsigned((n + kSumThreads - 1) / kSumThreads),
                              kSumThreads, 0, stream>>>(
      partial, static_cast<TB*>(dbias), groups, n);
  return cudaGetLastError();
}

// hd_pad: hd rounded up to 32, 64, 96 or 128.
template <typename T, typename TB>
cudaError_t launch(const void* qkv, const void* bias, const void* g,
                   void* dqkv, void* dbias, float* stats, float* partial,
                   int batch, int seq, int channels, int heads, int per_block,
                   int groups, float scale, cudaStream_t stream) {
  const int hd = channels / heads;
  if (hd <= 32)
    return launch_nj<T, TB, 2>(qkv, bias, g, dqkv, dbias, stats, partial,
                               batch, seq, channels, heads, per_block, groups,
                               scale, stream);
  if (hd <= 64)
    return launch_nj<T, TB, 4>(qkv, bias, g, dqkv, dbias, stats, partial,
                               batch, seq, channels, heads, per_block, groups,
                               scale, stream);
  if (hd <= 96)
    return launch_nj<T, TB, 6>(qkv, bias, g, dqkv, dbias, stats, partial,
                               batch, seq, channels, heads, per_block, groups,
                               scale, stream);
  return launch_nj<T, TB, 8>(qkv, bias, g, dqkv, dbias, stats, partial, batch,
                             seq, channels, heads, per_block, groups, scale,
                             stream);
}

}  // namespace

extern "C" {

// qkv and dqkv: (batch, seq, 3·channels); g: (batch, seq, channels); all
// f32 (qkv_bf16 = 0) or all bf16 (qkv_bf16 = 1). bias and dbias: (heads,
// seq, seq), f32 or bf16 (bias_bf16). stats: f32 scratch of (2, batch,
// heads, seq). dbias_partial: f32 scratch of (groups, heads, seq, seq),
// where block (group, q-tile, h) of pass 2 takes windows
// [group·per_block, (group + 1)·per_block) ∩ [0, batch). Returns the
// cudaError_t of the first launch that failed, or 0.
int window_mhsa_long_backward(const void* qkv, const void* bias,
                              const void* g, void* dqkv, void* dbias,
                              void* stats, void* dbias_partial, int batch,
                              int seq, int channels, int heads, int per_block,
                              int groups, int qkv_bf16, int bias_bf16,
                              float scale, void* stream) {
  if (batch <= 0 || seq <= 0 || heads <= 0 || heads > 65535 ||
      channels % heads != 0 || channels / heads > kMaxHeadDim ||
      (seq + kTile - 1) / kTile > 65535 || per_block <= 0 || groups <= 0 ||
      (long long)per_block * groups < batch ||
      (long long)per_block * (groups - 1) >= batch)
    return int(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* st = static_cast<float*>(stats);
  float* part = static_cast<float*>(dbias_partial);
  if (qkv_bf16) {
    return bias_bf16
        ? int(launch<__nv_bfloat16, __nv_bfloat16>(
              qkv, bias, g, dqkv, dbias, st, part, batch, seq, channels,
              heads, per_block, groups, scale, s))
        : int(launch<__nv_bfloat16, float>(
              qkv, bias, g, dqkv, dbias, st, part, batch, seq, channels,
              heads, per_block, groups, scale, s));
  }
  return bias_bf16
      ? int(launch<float, __nv_bfloat16>(qkv, bias, g, dqkv, dbias, st, part,
                                         batch, seq, channels, heads,
                                         per_block, groups, scale, s))
      : int(launch<float, float>(qkv, bias, g, dqkv, dbias, st, part, batch,
                                 seq, channels, heads, per_block, groups,
                                 scale, s));
}

}  // extern "C"
