// Backward of the bias-added attention over long windows, for Hopper
// (sm_90a): K4.
//
// Replaces fastervit_tpu/ops/pallas_flash_attention.py::_flash_backward, the
// two Pallas kernels behind flash_window_mhsa's custom VJP: _bwd_dq_kernel
// (:243, its pallas_call at :288; dq and dbias) and _bwd_dkv_kernel (:263,
// its pallas_call at :315; dk and dv). For each window b and head h, with P
// recomputed from q, k and the bias:
//
//   P = softmax(q kᵀ·scale + bias[h])  (f32, normalised, not rounded),
//   dP = g·vᵀ,  dl = P∘(dP − rowsum(dP∘P)),
//   dq = dl·k·scale,  dk = dlᵀ·q·scale,  dv = Pᵀ·g,
//   dbias[h] = Σ_b dl
//
// q, k and v are read from qkv (B, S, 3C), channel layout (3, H, hd), g from
// (B, S, C); dq, dk and dv are written to dqkv at qkv's offsets. It takes any
// S >= 1 and hd <= 128, K3's limits (window_mhsa_long.cu), and never writes
// a (B, H, S, S) tensor to device memory but dbias's partial sums.
//
// Bound on this card (five products of 2·S²·hd a window and head; qkv, g,
// dqkv, bias and dbias moved once): operations at the large windows.
// FasterViT-4-21k at 384², batch 32, level 2 (B = 32 windows of S = 576,
// H = 16, hd = 49, bf16): 83 GFLOP, 0.084 ms at the bf16 tensor-core peak,
// against 224 MB, 0.067 ms at the memory rate. Level 3 (S = 144, H = 32)
// is bytes: 10 GFLOP against 104 MB.
//
// The TPU kernels keep a whole K/V row of a head in VMEM and carry their sums
// through a grid that runs in order: the batch innermost for dbias, the
// q-tile innermost for dk and dv. On Hopper blocks run in no order, and K/V
// of a head (451 KB of bf16 at S = 2304) do not fit in a block's 227 KB of
// shared memory. So K4 streams 64-token tiles, in four launches on the
// caller's stream:
//
//  1. row statistics: one block per (window, q rows, head) runs over the
//     key tiles once and keeps, online with K3's rescaling, the row max m,
//     the row sum l of exp(logit − m), and Σ exp(logit − m)·dP. It writes
//     L = m + log l and D = rowsum(dP∘P), both f32, to a (2, B, H, S)
//     scratch. D is the exact rowsum(dP∘P) of the TPU kernels, not
//     FlashAttention's rowsum(dO∘O), which would read a rounded output.
//  2. dq and dbias: one block per (group of windows, q rows, head) runs over
//     its windows and, for each, over the key tiles: P = exp(logit − L),
//     dl = P∘(dP − D); dq accumulates in f32 and is written once per
//     window. dl is summed over the group's windows, in window order, into
//     the group's own f32 slab of a (groups, H, S, S) scratch, which only
//     this block touches: no atomics.
//  3. dk and dv: one block per (window, keys, head) runs over the q tiles
//     and sums dk and dv in f32. (The TPU kernel sums them in qkv's type
//     across its q-tiles; the f32 sum is the more exact one.)
//  4. dbias: a fourth kernel sums the groups' slabs in group order and casts
//     once to the bias's type, as K2 does (window_mhsa_bwd.cu). dbias and
//     dqkv are the same bits from run to run.
//
// Two routes, by the plan of ops/cuda_attention.py::long_bwd_plan, which
// the entry point checks against its own (BwdPlan below).
//
// bf16: the tensor cores (wgmma), on K3's tile steps (attn_tiles.cuh,
// namespace tc). A block is two consumer warpgroups of 64 rows; hd is
// padded with zeros to D = 32, 64, 80 or 128; the next 64-token tile is
// staged in registers (two bytes a load, or 16) while the current tile's
// products run and stored into the other of two shared-memory stages while
// the next products run, its bias tile copied a tile ahead by cp.async.
// Every product is a wgmma with an f32 accumulator:
//  - stats, 128 q rows a block: S = q·kᵀ and dP = g·vᵀ, m64n64 with q, g,
//    k and v all K-major in shared memory ([token][d], as K3's q and k);
//  - dq, 128 q rows a block: the same two, then dq += dl·k with dl, rounded
//    to bf16 pairs, as the A fragments (K3's p·v step). Its B has keys as
//    K, so k is stored twice, [key][d] for q·kᵀ and transposed [d][key]
//    for dl·k, by K3's own transposed store of vᵀ. (The descriptor's
//    transpose bit for 16-bit B would read the one copy, but its
//    no-swizzle MN-major layout is a second, untested layout; the copy
//    costs 64·D·2 bytes a stage and one transposed store a tile.)
//  - dk and dv, 128 keys a block: Sᵀ = k·qᵀ and dPᵀ = v·gᵀ directly, so
//    a fragment's rows are keys and Pᵀ and dlᵀ, rounded to bf16 pairs, are
//    the A fragments of dv += Pᵀ·g and dk += dlᵀ·q, with no trip through
//    shared memory; q and g come twice for the same reason, [row][d] and
//    [d][row]. L and D are per-column values of the fragment, staged with
//    the tile; the bias tile (64 rows × 128 keys) is read transposed.
// Nine products where five would do: each pass recomputes q·kᵀ and g·vᵀ
// (stats 2, dq 3, dk+dv 4). Rounding P and dl to bf16 for the second
// products is the only rounding beside the outputs' (2⁻⁹ relative).
// Rows past S take L = +inf (P = 0) and keys past S logits of −inf, so no
// NaN reaches a sum. Shared memory, by pass (BwdPlan): two 128-row
// operands, 2 or 3 or 4 64-row tiles a stage, the bias stages, and for dq
// one buffer into which each thread's slab values under the tile's dl come
// by cp.async while the tile's products run; two stages where they fit in
// 227 KB, one where not (dq at D 128, dk+dv at D 128 with an f32 bias).
// The stats pass runs two blocks an SM where K3 does (D <= 64, bf16 bias),
// the others one.
//
// What still sets the pace beside the products: the CUDA-core work between
// them (the staged loads, two bytes each at hd 49; three exponential
// sweeps, one a pass; the transposed stores), and the dbias slab, read,
// added to and written once a window: 2 × 4 × B·H·S² bytes, 1.36 GB (0.4
// ms at the memory rate) at the 21k-384 level-2 call, which makes the dq
// pass the slowest of the three: on an H100 it took 0.90 ms there, 0.58
// without the slab (PERF.md has the measured split).
//
// f32: the scalar route. TF32 would move the logits by ~1e-3 and the f32
// outputs are held to 1e-5, so f32 stays on scalar FMA: each of the 256
// threads holds a 4×4 register tile of a 64×64 logits tile and a
// 4×(hd_pad/16) tile of each accumulator, fed from f32 shared memory, 64
// rows (or keys) a block. Tiles are kept [token][d] with a row stride of
// hd_pad + 1 floats (odd: no bank conflicts on reads along d); the ragged
// last q- and key tile are masked to zeros.
//
// Every offset is computed in 64 bits. Plain C interface, bound with
// ctypes by fastervit_tpu_torch/ops/cuda_attention.py, which checks
// device, dtype, shape and contiguity and allocates the outputs and the
// scratch.

#include <cmath>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "attn_tiles.cuh"
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

// NJ = hd_pad / 16 of the scalar route: hd rounded up to 32, 64, 96 or
// 128.
constexpr int scalar_nj(int head_dim) {
  return head_dim <= 32 ? 2 : head_dim <= 64 ? 4 : head_dim <= 96 ? 6 : 8;
}

// Shared memory of one f32 [token][d] tile of the scalar route.
constexpr size_t scalar_tile_bytes(int nj) {
  return size_t(kTile) * (16 * nj + 1) * sizeof(float);
}

// The scalar route's three passes (f32 qkv and g).
template <typename TB, int NJ>
cudaError_t launch_nj(const void* qkv_, const void* bias_, const void* g_,
                      void* dqkv_, float* stats, float* partial, int batch,
                      int seq, int channels, int heads, int per_block,
                      int groups, float scale, cudaStream_t stream) {
  using T = float;
  const T* qkv = static_cast<const T*>(qkv_);
  const TB* bias = static_cast<const TB*>(bias_);
  const T* g = static_cast<const T*>(g_);
  T* dqkv = static_cast<T*>(dqkv_);
  float* lse = stats;
  float* delta = stats + (long long)batch * heads * seq;
  const size_t tile = scalar_tile_bytes(NJ);
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
  return cudaGetLastError();
}

template <typename TB>
cudaError_t launch(const void* qkv, const void* bias, const void* g,
                   void* dqkv, float* stats, float* partial, int batch,
                   int seq, int channels, int heads, int per_block,
                   int groups, float scale, cudaStream_t stream) {
  switch (scalar_nj(channels / heads)) {
    case 2:
      return launch_nj<TB, 2>(qkv, bias, g, dqkv, stats, partial, batch, seq,
                              channels, heads, per_block, groups, scale,
                              stream);
    case 4:
      return launch_nj<TB, 4>(qkv, bias, g, dqkv, stats, partial, batch, seq,
                              channels, heads, per_block, groups, scale,
                              stream);
    case 6:
      return launch_nj<TB, 6>(qkv, bias, g, dqkv, stats, partial, batch, seq,
                              channels, heads, per_block, groups, scale,
                              stream);
    default:
      return launch_nj<TB, 8>(qkv, bias, g, dqkv, stats, partial, batch, seq,
                              channels, heads, per_block, groups, scale,
                              stream);
  }
}

// 4. dbias from the groups' slabs (either route).
template <typename TB>
cudaError_t sum_dbias(const float* partial, void* dbias, int groups,
                      int heads, int seq, cudaStream_t stream) {
  const long long n = (long long)heads * seq * seq;
  long_dbias_sum_kernel<TB><<<unsigned((n + kSumThreads - 1) / kSumThreads),
                              kSumThreads, 0, stream>>>(
      partial, static_cast<TB*>(dbias), groups, n);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The tensor-core route, for bf16 qkv and g.
namespace tcb {

namespace tc = fastervit::attn_tiles::tc;
using fastervit::attn_tiles::Strides;
using tc::bf16;

constexpr int kRows = tc::kRows;       // q rows (stats, dq) or keys (dk+dv)
                                       // a block: two warpgroups of 64
constexpr int kTile = tc::kKeys;       // keys (stats, dq) or q rows (dk+dv)
                                       // a tile
constexpr int kThreads = tc::kThreads;
constexpr int kSmemLimit = 232448;     // SMEM_LIMIT in cuda_attention.py

enum Pass { kStats = 0, kDq = 1, kDkv = 2 };

// dk+dv's bias tile (kTile q rows × kRows keys): its row padded by one
// 16-byte unit, so the transposed reads of a warp miss no bank twice.
__host__ __device__ constexpr int bias_ld_t(int bias_bytes) {
  return kRows + 16 / bias_bytes;
}

// A pass's 64-row tiles a stage: stats k, v; dq k, v, kᵀ; dk+dv q, g, qᵀ,
// gᵀ. Each pass also keeps two 128-row operands (q and g, or k and v).
__host__ __device__ constexpr int tiles_per_stage(int pass) {
  return pass + 2;
}

// A stage's bytes past its tiles: the bias tile, and for dk+dv the tile's
// L and D (f32).
__host__ __device__ constexpr size_t bias_stage_bytes(int pass,
                                                      int bias_bytes) {
  return pass == kDkv ? size_t(kTile) * bias_ld_t(bias_bytes) * bias_bytes +
                            2 * kTile * sizeof(float)
                      : size_t(kRows) * tc::kBiasLd * bias_bytes;
}

// dq's one buffer past the stages: the slab's values under the tile's dl
// (kRows × kTile f32), each thread's own pairs, fetched by cp.async while
// the tile's products run.
__host__ __device__ constexpr size_t slab_bytes(int pass) {
  return pass == kDq ? size_t(kRows) * kTile * sizeof(float) : 0;
}

__host__ __device__ constexpr size_t smem_bytes(int pass, int d,
                                                int bias_bytes, int stages) {
  return size_t(2) * d * (2 * kRows + stages * tiles_per_stage(pass) * kTile) +
         stages * bias_stage_bytes(pass, bias_bytes) + slab_bytes(pass);
}

// Two stages where they fit a block's shared memory, else one.
__host__ __device__ constexpr int stages(int pass, int d, int bias_bytes) {
  return smem_bytes(pass, d, bias_bytes, 2) <= kSmemLimit ? 2 : 1;
}

// The shared memory of a pass: two 128-row operands, then kStages stages
// of kPer 64-row tiles, then kStages bias stages, then dq's slab buffer.
template <int kD, int kPass, typename TB>
struct Layout {
  static constexpr int kStages = stages(kPass, kD, sizeof(TB));
  static constexpr int kPer = tiles_per_stage(kPass);
  static constexpr size_t kBiasStage = bias_stage_bytes(kPass, sizeof(TB));
  uint16_t* base;
  __device__ uint16_t* resident(int i) const { return base + i * kRows * kD; }
  __device__ uint16_t* tile(int stage, int i) const {
    return base + (2 * kRows + (stage * kPer + i) * kTile) * kD;
  }
  __device__ TB* bias(int stage) const {
    return reinterpret_cast<TB*>(reinterpret_cast<char*>(tile(kStages, 0)) +
                                 stage * kBiasStage);
  }
  // dk+dv: the tile's L·log2 e (kTile floats), then its D
  __device__ float* stats(int stage) const {
    return reinterpret_cast<float*>(bias(stage) +
                                    kTile * bias_ld_t(sizeof(TB)));
  }
  // dq: pair i of thread t at [i][t]
  __device__ float2* slab() const {
    return reinterpret_cast<float2*>(bias(kStages));
  }
  __device__ static int next(int stage) {
    return kStages == 2 ? stage ^ 1 : 0;
  }
};

__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}

// Rows r0 .. r0 + kRows of a (rows, hd) operand into the K-major layout at
// dst, two 64-row halves; rows from `end` on as zeros.
template <int kD, int kVec>
__device__ __forceinline__ void load_rows(const bf16* __restrict__ src,
                                          int token, int r0, int end,
                                          int head_dim, uint16_t* dst) {
#pragma unroll
  for (int half = 0; half < kRows / kTile; ++half) {
    tc::Staged<kD, kVec> st;
    st.load(src, token, r0 + half * kTile, end, head_dim);
    st.store(dst + half * kTile * kD);
  }
}

// d = a·bᵀ over the depth kD: a this warpgroup's 64 rows of a K-major
// operand, b a 64-row K-major tile (m64n64, kD/16 steps, the first
// overwriting d). Issued, not committed.
template <int kD>
__device__ __forceinline__ void product_ss(float (&d)[32], const uint16_t* a,
                                           const uint16_t* b) {
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk)
    tc::wgmma_ss_n64(d, tc::desc(a + 128 * kk, 128, 16 * kD),
                     tc::desc(b + 128 * kk, 128, 16 * kD), kk > 0);
}

// d += a·b over 64 tokens: a the four k16 A fragments, b a transposed
// [d][token] tile (m64nDk16, as K3's p·v). Issued, not committed.
template <int kD>
__device__ __forceinline__ void product_rs(float (&d)[kD / 2],
                                           const uint32_t (&a)[4][4],
                                           const uint16_t* bt) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    tc::wgmma_rs<kD>(d, a[kk], tc::desc(bt + 128 * kk, 128, 16 * kTile));
}

// x rounded to the bf16 pairs of the four k16 A fragments: accumulator
// entries 8kk .. 8kk + 7 are step kk's fragment (attn_tiles.cuh).
__device__ __forceinline__ void fragments(const float (&x)[32],
                                          uint32_t (&a)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      a[kk][i] = tc::pack_bf16(x[8 * kk + 2 * i], x[8 * kk + 2 * i + 1]);
}

template <int N>
__device__ __forceinline__ void zero(float (&x)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) x[i] = 0.f;
}

// The bias tile of dk+dv: bias_h[row][key] for the kTile rows from q0
// (clamped to S − 1) and the kRows keys from kb0 below S (the rest is left
// as it was; those keys' logits are set to −inf), row by row at a stride of
// bias_ld_t. With `async` 16-byte cp.async copies, as tc::copy_bias.
template <typename TB>
__device__ __forceinline__ void copy_bias_t(const TB* __restrict__ bias_h,
                                            TB* dst, int q0, int kb0,
                                            int seq, bool async) {
  constexpr int kLd = bias_ld_t(sizeof(TB));
  if (async) {
    constexpr int kUnit = 16 / sizeof(TB), kPerRow = kRows / kUnit;
    for (int u = threadIdx.x; u < kTile * kPerRow; u += kThreads) {
      const int r = u / kPerRow, c = (u % kPerRow) * kUnit;
      if (kb0 + c < seq)
        tc::cp_async16(dst + r * kLd + c,
                       bias_h + (long long)min(q0 + r, seq - 1) * seq + kb0 +
                           c);
    }
    tc::cp_async_commit();
  } else {
    for (int e = threadIdx.x; e < kTile * kRows; e += kThreads) {
      const int r = e / kRows, c = e % kRows;
      if (kb0 + c < seq)
        dst[r * kLd + c] =
            bias_h[(long long)min(q0 + r, seq - 1) * seq + kb0 + c];
    }
  }
}

// This thread's share of a dk+dv tile's row statistics: threads 0 .. 63
// hold L·log2 e of rows q0 + t, threads 64 .. 127 D of rows q0 + t − 64;
// rows past S take L = +inf and D = 0.
__device__ __forceinline__ float row_stat(const float* __restrict__ lse,
                                          const float* __restrict__ delta,
                                          long long base, int q0, int seq) {
  const int t = threadIdx.x;
  if (t >= 2 * kTile) return 0.f;
  const int r = q0 + (t & (kTile - 1));
  if (t < kTile) return r < seq ? lse[base + r] * tc::kLog2e : INFINITY;
  return r < seq ? delta[base + r] : 0.f;
}

// Blocks an SM for the stats pass: two where K3 runs two (D <= 64, a bf16
// bias: registers and shared memory allow it); the dq and dk+dv passes
// hold more accumulators and shared memory and run one.
template <int kD, typename TB>
constexpr int stats_min_blocks() {
  return tc::min_blocks<kD, TB, true>();
}

// 1. L and D of 128 rows of one (window, head).
template <typename TB, int kD, int kVec>
__global__ void __launch_bounds__(kThreads, stats_min_blocks<kD, TB>())
long_bwd_stats_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ v, Strides in,
                         const bf16* __restrict__ g, Strides gs,
                         const TB* __restrict__ bias, float* __restrict__ lse,
                         float* __restrict__ delta, int seq, int heads,
                         int head_dim, float scale, int bias_async) {
  using L = Layout<kD, kStats, TB>;
  extern __shared__ __align__(128) uint16_t smem_tc[];
  const L sm{smem_tc};
  const tc::Fragment f;
  const int q0 = blockIdx.y * kRows;
  const long long at =
      (long long)blockIdx.x * in.window + (long long)blockIdx.z * in.head;
  q += at;
  k += at;
  v += at;
  g += (long long)blockIdx.x * gs.window + (long long)blockIdx.z * gs.head;
  const TB* bias_h = bias + (long long)blockIdx.z * seq * seq;

  // q and g; the first k, v (and bias) tile into stage 0
  load_rows<kD, kVec>(q, in.token, q0, seq, head_dim, sm.resident(0));
  load_rows<kD, kVec>(g, gs.token, q0, seq, head_dim, sm.resident(1));
  tc::Staged<kD, kVec> ks, vs;
  tc::copy_bias(bias_h, sm.bias(0), q0, 0, seq, seq, bias_async);
  ks.load(k, in.token, 0, seq, head_dim);
  vs.load(v, in.token, 0, seq, head_dim);
  ks.store(sm.tile(0, 0));
  vs.store(sm.tile(0, 1));
  tc::fence_proxy_async();
  tc::cp_async_wait_all();
  __syncthreads();

  const int wg = threadIdx.x >> 7;
  const uint16_t* qw = sm.resident(0) + wg * kTile * kD;
  const uint16_t* gw = sm.resident(1) + wg * kTile * kD;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, pd[2] = {0.f, 0.f};
  float s[32], dp[32];
  zero(s);
  zero(dp);

  const int tiles = (seq + kTile - 1) / kTile;
  for (int t = 0; t < tiles; ++t) {
    const int stage = L::kStages == 2 ? t & 1 : 0, k0 = t * kTile;
    const bool more = t + 1 < tiles;
    // S = q kᵀ and dP = g vᵀ on the tensor cores; meanwhile the next
    // tile's bias is copied and its k and v come into registers
    tc::fence_operands(s);
    tc::fence_operands(dp);
    tc::wgmma_fence();
    product_ss<kD>(s, qw, sm.tile(stage, 0));
    product_ss<kD>(dp, gw, sm.tile(stage, 1));
    tc::wgmma_commit();
    if (more) {
      if (L::kStages == 2)
        tc::copy_bias(bias_h, sm.bias(stage ^ 1), q0, k0 + kTile, seq, seq,
                      bias_async);
      ks.load(k, in.token, k0 + kTile, seq, head_dim);
      vs.load(v, in.token, k0 + kTile, seq, head_dim);
    }
    tc::wgmma_wait_all();
    tc::fence_operands(s);
    tc::fence_operands(dp);

    // online max, Σp and Σp·dP; every tile holds a key < S, so the new
    // max is finite and alpha is 0 on the first tile
    tc::logits<TB, true>(s, sm.bias(stage), f, k0, seq, scale);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float mnew = fmaxf(m[h], tc::quad_max(tc::thread_max(s, h)));
      const float alpha = exp2f((m[h] - mnew) * tc::kLog2e);
      float psum = 0.f, dsum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 4 * j + 2 * h + e;
          const float p = exp2f((s[i] - mnew) * tc::kLog2e);  // 0 past S
          psum += p;
          dsum = fmaf(p, dp[i], dsum);
        }
      l[h] = fmaf(l[h], alpha, tc::quad_sum(psum));
      pd[h] = fmaf(pd[h], alpha, tc::quad_sum(dsum));
      m[h] = mnew;
    }

    if (more) {
      const int next = L::next(stage);
      if (L::kStages == 1) {
        __syncthreads();  // the stage's k, v and bias are no longer read
        tc::copy_bias(bias_h, sm.bias(next), q0, k0 + kTile, seq, seq,
                      bias_async);
      }
      ks.store(sm.tile(next, 0));
      vs.store(sm.tile(next, 1));
      tc::fence_proxy_async();
    }
    tc::cp_async_wait_all();
    __syncthreads();
  }

  if ((threadIdx.x & 3) == 0) {
    const long long base = ((long long)blockIdx.x * heads + blockIdx.z) * seq;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = q0 + f.row0 + 8 * h;
      if (r < seq) {
        lse[base + r] = m[h] + logf(l[h]);
        delta[base + r] = pd[h] / l[h];
      }
    }
  }
}

// 2. dq of 128 rows of the windows [group·per_block, (group + 1)·per_block)
//    ∩ [0, B), and their dl summed into the group's slab of dbias_partial.
template <typename TB, int kD, int kVec>
__global__ void __launch_bounds__(kThreads, 1)
long_bwd_dq_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, Strides in,
                      const bf16* __restrict__ g, Strides gs,
                      const TB* __restrict__ bias,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta, bf16* __restrict__ dq,
                      float* __restrict__ dbias_partial, int batch, int seq,
                      int heads, int head_dim, int per_block, float scale,
                      int bias_async) {
  using L = Layout<kD, kDq, TB>;
  extern __shared__ __align__(128) uint16_t smem_tc[];
  const L sm{smem_tc};
  const tc::Fragment f;
  const int group = blockIdx.x;
  const int q0 = blockIdx.y * kRows;
  const int h = blockIdx.z;
  const TB* bias_h = bias + (long long)h * seq * seq;
  float* part = dbias_partial + ((long long)group * heads + h) * seq * seq;
  const long long first = (long long)group * per_block;
  const long long last = min((long long)batch, first + per_block);
  const int wg = threadIdx.x >> 7;
  const uint16_t* qw = sm.resident(0) + wg * kTile * kD;
  const uint16_t* gw = sm.resident(1) + wg * kTile * kD;
  const bool pairs = (seq & 1) == 0;  // a slab row's key pairs 8-byte aligned
  const int tiles = (seq + kTile - 1) / kTile;

  for (long long b = first; b < last; ++b) {
    const long long at = b * in.window + (long long)h * in.head;
    const bf16* qb = q + at;
    const bf16* kb = k + at;
    const bf16* vb = v + at;
    __syncthreads();  // the previous window's readers are done
    load_rows<kD, kVec>(qb, in.token, q0, seq, head_dim, sm.resident(0));
    load_rows<kD, kVec>(g + b * gs.window + (long long)h * gs.head, gs.token,
                        q0, seq, head_dim, sm.resident(1));
    tc::Staged<kD, kVec> ks, vs;
    tc::copy_bias(bias_h, sm.bias(0), q0, 0, seq, seq, bias_async);
    ks.load(kb, in.token, 0, seq, head_dim);
    vs.load(vb, in.token, 0, seq, head_dim);
    ks.store(sm.tile(0, 0));
    vs.store(sm.tile(0, 1));
    ks.store_transposed(sm.tile(0, 2));
    tc::fence_proxy_async();
    tc::cp_async_wait_all();
    __syncthreads();

    // the rows' L·log2 e and D; rows past S take L = +inf, so their P
    // is 0
    float Lr[2], Dr[2];
    const long long base = (b * heads + h) * seq;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = q0 + f.row0 + 8 * hh;
      Lr[hh] = r < seq ? lse[base + r] * tc::kLog2e : INFINITY;
      Dr[hh] = r < seq ? delta[base + r] : 0.f;
    }
    float o[kD / 2], s[32], dp[32];
    zero(o);
    zero(s);
    zero(dp);

    for (int t = 0; t < tiles; ++t) {
      const int stage = L::kStages == 2 ? t & 1 : 0, k0 = t * kTile;
      const bool more = t + 1 < tiles;
      // S = q kᵀ and dP = g vᵀ; meanwhile the next tile's bias, k and v
      tc::fence_operands(s);
      tc::fence_operands(dp);
      tc::wgmma_fence();
      product_ss<kD>(s, qw, sm.tile(stage, 0));
      product_ss<kD>(dp, gw, sm.tile(stage, 1));
      tc::wgmma_commit();
      if (more && L::kStages == 2)
        tc::copy_bias(bias_h, sm.bias(stage ^ 1), q0, k0 + kTile, seq, seq,
                      bias_async);
      if (b != first && pairs) {
        // the slab's values under this tile's dl, pair by pair into this
        // thread's own places (no barrier before they are read)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int r = q0 + f.row0 + 8 * hh;
          if (r >= seq) continue;
          const float* row = part + (long long)r * seq + k0 + f.col0;
#pragma unroll
          for (int j = 0; j < 8; ++j)
            if (k0 + 8 * j + f.col0 < seq)
              cp_async8(sm.slab() + (8 * hh + j) * kThreads + threadIdx.x,
                        row + 8 * j);
        }
        tc::cp_async_commit();
      }
      if (more) {
        ks.load(kb, in.token, k0 + kTile, seq, head_dim);
        vs.load(vb, in.token, k0 + kTile, seq, head_dim);
      }
      tc::wgmma_wait_all();
      tc::fence_operands(s);
      tc::fence_operands(dp);

      // P = exp(logit − L), dl = P∘(dP − D), in s; 0 outside S × S
      tc::logits<TB, true>(s, sm.bias(stage), f, k0, seq, scale);
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int hh = (i >> 1) & 1;
        s[i] = exp2f(fmaf(s[i], tc::kLog2e, -Lr[hh])) * (dp[i] - Dr[hh]);
      }
      // dl into the group's slab, windows in order: this block alone owns
      // these rows of it
      if (b != first && pairs) tc::cp_async_wait_all();
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int r = q0 + f.row0 + 8 * hh;
        if (r >= seq) continue;
        float* row = part + (long long)r * seq + k0 + f.col0;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int c = k0 + 8 * j + f.col0;
          const float x = s[4 * j + 2 * hh], y = s[4 * j + 2 * hh + 1];
          if (pairs) {
            if (c >= seq) continue;
            float2 val = make_float2(x, y);
            if (b != first) {
              const float2 was = sm.slab()[(8 * hh + j) * kThreads +
                                           threadIdx.x];
              val.x += was.x;
              val.y += was.y;
            }
            *reinterpret_cast<float2*>(row + 8 * j) = val;
          } else {
            if (c < seq) row[8 * j] = b == first ? x : row[8 * j] + x;
            if (c + 1 < seq)
              row[8 * j + 1] = b == first ? y : row[8 * j + 1] + y;
          }
        }
      }

      // dq += dl · k on the tensor cores, dl rounded to bf16 pairs; then
      // the next tile into the other stage
      uint32_t a[4][4];
      fragments(s, a);
      tc::fence_operands(o);
      tc::wgmma_fence();
      product_rs<kD>(o, a, sm.tile(stage, 2));
      tc::wgmma_commit();
      if (more) {
        const int next = L::next(stage);
        if (L::kStages == 1) {
          tc::wgmma_wait_all();
          __syncthreads();  // the stage's k, kᵀ and bias are no longer read
          tc::copy_bias(bias_h, sm.bias(next), q0, k0 + kTile, seq, seq,
                        bias_async);
        }
        ks.store(sm.tile(next, 0));
        vs.store(sm.tile(next, 1));
        ks.store_transposed(sm.tile(next, 2));
        tc::fence_proxy_async();
      }
      tc::wgmma_wait_all();
      tc::fence_operands(o);
      tc::cp_async_wait_all();
      __syncthreads();
    }

    bf16* dst = dq + at;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = q0 + f.row0 + 8 * hh;
      if (r >= seq) continue;
#pragma unroll
      for (int j = 0; j < kD / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int d = 8 * j + f.col0 + e;
          if (d < head_dim)
            dst[(long long)r * in.token + d] =
                __float2bfloat16(o[4 * j + 2 * hh + e] * scale);
        }
    }
  }
}

// 3. dk and dv of 128 keys of one (window, head).
template <typename TB, int kD, int kVec>
__global__ void __launch_bounds__(kThreads, 1)
long_bwd_dkv_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v, Strides in,
                       const bf16* __restrict__ g, Strides gs,
                       const TB* __restrict__ bias,
                       const float* __restrict__ lse,
                       const float* __restrict__ delta, bf16* __restrict__ dk,
                       bf16* __restrict__ dv, int seq, int heads,
                       int head_dim, float scale, int bias_async) {
  using L = Layout<kD, kDkv, TB>;
  constexpr int kLd = bias_ld_t(sizeof(TB));
  extern __shared__ __align__(128) uint16_t smem_tc[];
  const L sm{smem_tc};
  const tc::Fragment f;
  const int kb0 = blockIdx.y * kRows;
  const long long at =
      (long long)blockIdx.x * in.window + (long long)blockIdx.z * in.head;
  q += at;
  k += at;
  v += at;
  g += (long long)blockIdx.x * gs.window + (long long)blockIdx.z * gs.head;
  const TB* bias_h = bias + (long long)blockIdx.z * seq * seq;
  const long long base = ((long long)blockIdx.x * heads + blockIdx.z) * seq;

  // k and v; the first q, g tile (both ways), its bias and L, D into
  // stage 0
  load_rows<kD, kVec>(k, in.token, kb0, seq, head_dim, sm.resident(0));
  load_rows<kD, kVec>(v, in.token, kb0, seq, head_dim, sm.resident(1));
  tc::Staged<kD, kVec> qst, gst;
  copy_bias_t(bias_h, sm.bias(0), 0, kb0, seq, bias_async);
  qst.load(q, in.token, 0, seq, head_dim);
  gst.load(g, gs.token, 0, seq, head_dim);
  float st = row_stat(lse, delta, base, 0, seq);
  qst.store(sm.tile(0, 0));
  gst.store(sm.tile(0, 1));
  qst.store_transposed(sm.tile(0, 2));
  gst.store_transposed(sm.tile(0, 3));
  if (threadIdx.x < 2 * kTile) sm.stats(0)[threadIdx.x] = st;
  tc::fence_proxy_async();
  tc::cp_async_wait_all();
  __syncthreads();

  const int wg = threadIdx.x >> 7;
  const uint16_t* kw = sm.resident(0) + wg * kTile * kD;
  const uint16_t* vw = sm.resident(1) + wg * kTile * kD;
  // this thread's fragment rows are keys kb0 + f.row0 + 8h; keys past S
  // take logits of −inf, so their P is 0
  const bool key_in[2] = {kb0 + f.row0 < seq, kb0 + f.row0 + 8 < seq};
  float dkacc[kD / 2], dvacc[kD / 2], s[32], dp[32];
  zero(dkacc);
  zero(dvacc);
  zero(s);
  zero(dp);

  const int tiles = (seq + kTile - 1) / kTile;
  for (int t = 0; t < tiles; ++t) {
    const int stage = L::kStages == 2 ? t & 1 : 0, q0 = t * kTile;
    const bool more = t + 1 < tiles;
    // Sᵀ = k qᵀ and dPᵀ = v gᵀ; meanwhile the next tile's bias, q, g and
    // L, D
    tc::fence_operands(s);
    tc::fence_operands(dp);
    tc::wgmma_fence();
    product_ss<kD>(s, kw, sm.tile(stage, 0));
    product_ss<kD>(dp, vw, sm.tile(stage, 1));
    tc::wgmma_commit();
    if (more) {
      if (L::kStages == 2)
        copy_bias_t(bias_h, sm.bias(stage ^ 1), q0 + kTile, kb0, seq,
                    bias_async);
      qst.load(q, in.token, q0 + kTile, seq, head_dim);
      gst.load(g, gs.token, q0 + kTile, seq, head_dim);
      st = row_stat(lse, delta, base, q0 + kTile, seq);
    }
    tc::wgmma_wait_all();
    tc::fence_operands(s);
    tc::fence_operands(dp);

    // Pᵀ = exp(logitᵀ − L) and dlᵀ = Pᵀ∘(dPᵀ − D), the bias read
    // transposed, L and D by column (q row); Pᵀ in s, dlᵀ in dp
    const TB* bt = sm.bias(stage);
    const float* Ls = sm.stats(stage);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = 8 * j + f.col0 + e;
        const float Lc = Ls[c], Dc = Ls[kTile + c];
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int i = 4 * j + 2 * hh + e;
          const float x =
              key_in[hh] ? fmaf(s[i], scale,
                                to_f32(bt[c * kLd + f.row0 + 8 * hh]))
                         : -INFINITY;
          const float p = exp2f(fmaf(x, tc::kLog2e, -Lc));
          s[i] = p;
          dp[i] = p * (dp[i] - Dc);
        }
      }

    // dv += Pᵀ g and dk += dlᵀ q on the tensor cores, Pᵀ and dlᵀ rounded
    // to bf16 pairs; then the next tile into the other stage
    uint32_t pa[4][4], da[4][4];
    fragments(s, pa);
    fragments(dp, da);
    tc::fence_operands(dvacc);
    tc::fence_operands(dkacc);
    tc::wgmma_fence();
    product_rs<kD>(dvacc, pa, sm.tile(stage, 3));
    product_rs<kD>(dkacc, da, sm.tile(stage, 2));
    tc::wgmma_commit();
    if (more) {
      const int next = L::next(stage);
      if (L::kStages == 1) {
        tc::wgmma_wait_all();
        __syncthreads();  // the stage's tiles and bias are no longer read
        copy_bias_t(bias_h, sm.bias(next), q0 + kTile, kb0, seq, bias_async);
      }
      qst.store(sm.tile(next, 0));
      gst.store(sm.tile(next, 1));
      qst.store_transposed(sm.tile(next, 2));
      gst.store_transposed(sm.tile(next, 3));
      if (threadIdx.x < 2 * kTile) sm.stats(next)[threadIdx.x] = st;
      tc::fence_proxy_async();
    }
    tc::wgmma_wait_all();
    tc::fence_operands(dvacc);
    tc::fence_operands(dkacc);
    tc::cp_async_wait_all();
    __syncthreads();
  }

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int c = kb0 + f.row0 + 8 * hh;
    if (c >= seq) continue;
    const long long row = (long long)c * in.token;
#pragma unroll
    for (int j = 0; j < kD / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int d = 8 * j + f.col0 + e;
        if (d < head_dim) {
          const int i = 4 * j + 2 * hh + e;
          dk[at + row + d] = __float2bfloat16(dkacc[i] * scale);
          dv[at + row + d] = __float2bfloat16(dvacc[i]);
        }
      }
  }
}

template <typename K, typename... Args>
cudaError_t run(K kernel, size_t smem, dim3 grid, cudaStream_t stream,
                Args... args) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (err != cudaSuccess) return err;
  }
  kernel<<<grid, kThreads, smem, stream>>>(args...);
  return cudaGetLastError();
}

// The three passes of the tensor-core route; the dbias sum follows.
template <typename TB>
cudaError_t launch(const void* qkv, const void* bias_, const void* g_,
                   void* dqkv, float* stats, float* partial, int batch,
                   int seq, int channels, int heads, int per_block,
                   int groups, float scale, cudaStream_t stream) {
  const int hd = channels / heads;
  const Strides in{(long long)seq * 3 * channels, hd, 3 * channels};
  const Strides gs{(long long)seq * channels, hd, channels};
  const bf16* q = static_cast<const bf16*>(qkv);
  const bf16* k = q + channels;
  const bf16* v = k + channels;
  const bf16* g = static_cast<const bf16*>(g_);
  bf16* dq = static_cast<bf16*>(dqkv);
  const TB* bias = static_cast<const TB*>(bias_);
  float* lse = stats;
  float* delta = stats + (long long)batch * heads * seq;
  constexpr int bb = sizeof(TB);
  const int async = tc::bias_async(bias, seq, seq, bb);
  const bool wide = tc::wide_loads(hd, in, {q, k, v}) &&
                    tc::wide_loads(hd, gs, {g});
  const unsigned blocks = unsigned((seq + kRows - 1) / kRows);
  return tc::with_depth(hd, [&](auto depth) {
    constexpr int kD = decltype(depth)::value;
    return tc::with_vec(wide, [&](auto vec) {
      constexpr int kVec = decltype(vec)::value;
      cudaError_t err = run(
          long_bwd_stats_tc_kernel<TB, kD, kVec>,
          smem_bytes(kStats, kD, bb, stages(kStats, kD, bb)),
          dim3(unsigned(batch), blocks, unsigned(heads)), stream, q, k, v,
          in, g, gs, bias, lse, delta, seq, heads, hd, scale, async);
      if (err != cudaSuccess) return err;
      err = run(long_bwd_dq_tc_kernel<TB, kD, kVec>,
                smem_bytes(kDq, kD, bb, stages(kDq, kD, bb)),
                dim3(unsigned(groups), blocks, unsigned(heads)), stream, q, k,
                v, in, g, gs, bias, lse, delta, dq, partial, batch, seq,
                heads, hd, per_block, scale, async);
      if (err != cudaSuccess) return err;
      return run(long_bwd_dkv_tc_kernel<TB, kD, kVec>,
                 smem_bytes(kDkv, kD, bb, stages(kDkv, kD, bb)),
                 dim3(unsigned(batch), blocks, unsigned(heads)), stream, q, k,
                 v, in, g, gs, bias, lse, delta, dq + channels,
                 dq + 2 * channels, seq, heads, hd, scale, async);
    });
  });
}

}  // namespace tcb

// The plan ops/cuda_attention.py::long_bwd_plan made, as the entry point
// takes it: route (1 tensor cores, 0 scalar), the padded head dim, q rows
// a block (stats, dq), keys a block (dk+dv), each pass's stages, each
// pass's dynamic shared memory in bytes.
struct BwdPlan {
  int tensor_cores, depth, rows, keys, stages[3], smem[3];
};

BwdPlan bwd_plan_for(int head_dim, bool bf16, int bias_bytes) {
  if (bf16) {
    const int d = tcb::tc::padded_head_dim(head_dim);
    BwdPlan p{1, d, tcb::kRows, tcb::kRows, {}, {}};
    for (int pass = 0; pass < 3; ++pass) {
      p.stages[pass] = tcb::stages(pass, d, bias_bytes);
      p.smem[pass] =
          int(tcb::smem_bytes(pass, d, bias_bytes, p.stages[pass]));
    }
    return p;
  }
  const int nj = scalar_nj(head_dim);
  const int tile = int(scalar_tile_bytes(nj)), pl = kTile * kLd * 4;
  return {0, 16 * nj, kTile, kTile, {1, 1, 1},
          {4 * tile, 4 * tile + pl, 4 * tile + 2 * pl}};
}

bool plan_ok(const int* plan, int head_dim, bool bf16, int bias_bytes) {
  const BwdPlan p = bwd_plan_for(head_dim, bf16, bias_bytes);
  const int want[10] = {p.tensor_cores, p.depth,     p.rows,
                        p.keys,         p.stages[0], p.stages[1],
                        p.stages[2],    p.smem[0],   p.smem[1],
                        p.smem[2]};
  if (!plan) return false;
  for (int i = 0; i < 10; ++i)
    if (plan[i] != want[i]) return false;
  return true;
}

}  // namespace

extern "C" {

// qkv and dqkv: (batch, seq, 3·channels); g: (batch, seq, channels); all
// f32 (qkv_bf16 = 0) or all bf16 (qkv_bf16 = 1). bias and dbias: (heads,
// seq, seq), f32 or bf16 (bias_bf16). stats: f32 scratch of (2, batch,
// heads, seq). dbias_partial: f32 scratch of (groups, heads, seq, seq),
// where a block of pass 2 takes windows [group·per_block, (group + 1)·
// per_block) ∩ [0, batch). plan: the ten ints of long_bwd_plan (BwdPlan),
// checked against this library's own. Returns the cudaError_t of the
// first launch that failed, or 0.
int window_mhsa_long_backward(const void* qkv, const void* bias,
                              const void* g, void* dqkv, void* dbias,
                              void* stats, void* dbias_partial, int batch,
                              int seq, int channels, int heads, int per_block,
                              int groups, int qkv_bf16, int bias_bf16,
                              float scale, const int* plan, void* stream) {
  if (batch <= 0 || seq <= 0 || heads <= 0 || heads > 65535 ||
      channels % heads != 0 || channels / heads > kMaxHeadDim ||
      (seq + kTile - 1) / kTile > 65535 || per_block <= 0 || groups <= 0 ||
      (long long)per_block * groups < batch ||
      (long long)per_block * (groups - 1) >= batch ||
      3LL * channels > 0x7fffffff ||
      !plan_ok(plan, channels / heads, qkv_bf16, bias_bf16 ? 2 : 4))
    return int(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* st = static_cast<float*>(stats);
  float* part = static_cast<float*>(dbias_partial);
  cudaError_t err;
  if (qkv_bf16) {
    err = bias_bf16
        ? tcb::launch<__nv_bfloat16>(qkv, bias, g, dqkv, st, part, batch,
                                     seq, channels, heads, per_block, groups,
                                     scale, s)
        : tcb::launch<float>(qkv, bias, g, dqkv, st, part, batch, seq,
                             channels, heads, per_block, groups, scale, s);
  } else {
    err = bias_bf16
        ? launch<__nv_bfloat16>(qkv, bias, g, dqkv, st, part, batch, seq,
                                channels, heads, per_block, groups, scale, s)
        : launch<float>(qkv, bias, g, dqkv, st, part, batch, seq, channels,
                        heads, per_block, groups, scale, s);
  }
  if (err != cudaSuccess) return int(err);
  return int(bias_bf16 ? sum_dbias<__nv_bfloat16>(part, dbias, groups, heads,
                                                  seq, s)
                       : sum_dbias<float>(part, dbias, groups, heads, seq, s));
}

// The dynamic shared memory, in bytes, of a block of K4's pass `pass` (0
// stats, 1 dq and dbias, 2 dk and dv) at this hd on either route, with a
// bias of bias_bytes a value: what long_bwd_plan must name.
long long long_attention_bwd_smem_bytes(int head_dim, int tensor_cores,
                                        int bias_bytes, int pass) {
  if (pass < 0 || pass > 2) return -1;
  return bwd_plan_for(head_dim, tensor_cores != 0, bias_bytes).smem[pass];
}

}  // extern "C"
