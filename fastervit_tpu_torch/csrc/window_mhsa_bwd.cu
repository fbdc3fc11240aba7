// Backward of the bias-added window attention, for Hopper (sm_90a): K2.
//
// Replaces fastervit_tpu/ops/pallas_attention.py::_mhsa_bwd_kernel, the
// Pallas backward behind fused_window_mhsa's custom VJP. For each window b
// and head h, with P recomputed from q, k and the bias (f32, normalised):
//
//   dP = g·vᵀ,  dl = P∘(dP − rowsum(dP∘P)),
//   dq = dl·k·scale,  dk = dlᵀ·q·scale,  dv = Pᵀ·g,
//   dbias[h] = Σ_b dl
//
// q, k and v are read from qkv (B, S, 3C), channel layout (3, H, hd), at
// row stride 3C and column offsets h·hd, C + h·hd and 2C + h·hd, g from
// (B, S, C); dq, dk and dv are written to dqkv at qkv's offsets. No
// head-split transpose runs outside the kernel. It takes S <= 64 and
// hd <= 64; longer windows and wider heads are K4's.
//
// dbias: the TPU kernel carries one sum through its sequential grid. Here
// blocks run in parallel and in no order, so each block takes one head and
// a run of `per_block` windows (grid (H, groups), ops/cuda_attention.py::
// backward_grid), sums its dl in f32 and writes that partial sum to an f32
// scratch (groups, H, S, S). A second kernel sums the partials over the
// groups in a fixed order and casts once to the bias's type, so dbias and
// dqkv are the same bits from run to run.
//
// Bound on this card: memory. At FasterViT-0's training shapes, batch 128,
// bf16, a call must read qkv and g and write dqkv: at (B, S, H, hd) =
// (512, 53, 8, 32) 97.3 MB, 29.0 µs at 3.35 TB/s, against 3.7 GFLOP of
// products (5 of 2·S²·hd per window and head), 4 µs on the tensor cores.
// One training step's 17 calls come to about 0.25 ms.
//
// Two routes, by the plan of ops/cuda_attention.py::short_bwd_plan, which
// the entry point checks against its own (short_tiles.cuh says how the
// tensor-core route keeps its operands):
//
// bf16: the tensor cores (wgmma), one pass. A block's bias is read once,
// into shared memory in the S accumulator's fragment order. Each of its
// two warpgroups owns one window at a time (M = 64 rows, one 64-key tile:
// the softmax is exact in registers, no statistics pass), the windows of
// the block's run in turn, the next one's q, k, v and g coming into its
// other stage meanwhile. Per window, five products with f32 accumulators:
// S = q·kᵀ and dP = g·vᵀ (K-major operands); then P, D = rowsum(dP∘P)
// and dl = P∘(dP − D) in registers (exp2, log2 e folded in); dl and P rounded
// to bf16 (as K4 rounds them), dl as the register A fragments of
// dq = dl·k and both stored once to shared memory, where they are the
// MN-major A operands of dk = dlᵀ·q and dv = Pᵀ·g; k, q and g serve as
// MN-major B operands through the transpose bits, so nothing is computed
// twice or transposed. The warpgroup keeps its dbias partial (unrounded
// dl) in registers in the fragment's layout; at the end the block sums its
// warpgroups in order into its slot of the scratch.
//
// f32: the scalar route, FMA loops over f32 shared memory (q, k, v, g, P,
// dl and the dbias sum of one window and head: 115 KB at S = hd = 64).
// TF32 would move the logits by ~1e-3; the f32 path is held to 1e-4.
//
// The TPU kernel packed floor(128/S) windows under a block-diagonal -1e30
// bias to fill the MXU and summed the diagonal blocks of dbias afterwards.
// On Hopper that mask only wastes work, as in the forward, so a window is
// never packed with another here.
//
// Plain C interface, bound with ctypes by fastervit_tpu_torch/ops/
// cuda_attention.py, which checks device, dtype, shape and contiguity and
// allocates the outputs and the scratch.

#include <climits>
#include <cmath>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "dtype.cuh"
#include "short_tiles.cuh"

namespace {

namespace st = fastervit::short_tiles;
namespace tc = fastervit::attn_tiles::tc;
using tc::bf16;
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

// The scalar route (f32).
template <typename TB>
__global__ void __launch_bounds__(kThreads)
window_mhsa_bwd_kernel(const float* __restrict__ qkv,
                       const TB* __restrict__ bias,
                       const float* __restrict__ g, float* __restrict__ dqkv,
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
    // 1. q, k, v of head h and its slice of g. The barrier first lets
    //    the previous window's readers finish.
    __syncthreads();
    const float* src = qkv + b * seq * row + h * head_dim;
    const float* gsrc = g + b * seq * channels + h * head_dim;
    for (int e = threadIdx.x; e < seq * head_dim; e += blockDim.x) {
      const int s = e / head_dim, d = e - s * head_dim;
      const float* r = src + s * row + d;
      q[e] = r[0];
      k[s * kstride + d] = r[channels];
      v[s * kstride + d] = r[2 * channels];
      gs[e] = gsrc[(long long)s * channels + d];
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
    float* dst = dqkv + b * seq * row + h * head_dim;
    for (int e = threadIdx.x; e < seq * head_dim; e += blockDim.x) {
      const int i = e / head_dim, d = e - i * head_dim;
      const float* dli = dl + i * seq;
      float dq = 0.f, dk = 0.f, dv = 0.f;
      for (int t = 0; t < seq; ++t) {
        dq = fmaf(dli[t], k[t * kstride + d], dq);
        dk = fmaf(dl[t * seq + i], q[t * head_dim + d], dk);
        dv = fmaf(p[t * seq + i], gs[t * head_dim + d], dv);
      }
      float* r = dst + i * row + d;
      r[0] = dq * scale;
      r[channels] = dk * scale;
      r[2 * channels] = dv;
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

template <typename TB>
cudaError_t launch(const void* qkv, const void* bias, const void* g,
                   void* dqkv, float* partial, int batch, int seq,
                   int channels, int heads, int per_block, int groups,
                   float scale, cudaStream_t stream) {
  const size_t smem = smem_floats(seq, channels / heads) * sizeof(float);
  auto kernel = window_mhsa_bwd_kernel<TB>;
  const cudaError_t err = st::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(unsigned(heads), unsigned(groups)), kThreads, smem, stream>>>(
      static_cast<const float*>(qkv), static_cast<const TB*>(bias),
      static_cast<const float*>(g), static_cast<float*>(dqkv), partial,
      batch, seq, channels, heads, per_block, scale);
  return cudaGetLastError();
}

template <typename TB>
cudaError_t sum_dbias(const float* partial, void* dbias, int groups,
                      int heads, int seq, cudaStream_t stream) {
  const long long n = (long long)heads * seq * seq;
  dbias_sum_kernel<TB><<<unsigned((n + kSumThreads - 1) / kSumThreads),
                         kSumThreads, 0, stream>>>(
      partial, static_cast<TB*>(dbias), groups, n);
  return cudaGetLastError();
}

// The tensor-core route, kD the padded head dim. Block (h, group) takes
// head h of windows [group·per_block, (group + 1)·per_block) ∩ [0, B); its
// warpgroup wg the windows first + wg, first + wg + kW, ...
template <int kD>
__global__ void __launch_bounds__(st::kWgThreads * st::kBwdWarpgroups, 1)
window_mhsa_bwd_tc_kernel(const bf16* __restrict__ qkv,
                          const void* __restrict__ bias, int bias_bf16,
                          const bf16* __restrict__ g, bf16* __restrict__ dqkv,
                          float* __restrict__ dbias_partial, int batch,
                          int seq, int channels, int heads, int per_block,
                          float scale, int wide) {
  constexpr int kW = st::kBwdWarpgroups;
  constexpr int kOp = st::kTile * kD;  // one operand's elements
  constexpr int kStage = 4 * kOp;      // q, k, v, g
  constexpr int kMine = int(st::bwd_wg_elems(kD));
  constexpr int kTileElems = st::kTile * st::kTile;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* bias_s = reinterpret_cast<float*>(smem_raw);
  uint16_t* region = reinterpret_cast<uint16_t*>(smem_raw +
                                                 st::bias_bytes(1));
  const int wg = threadIdx.x >> 7, t = threadIdx.x & 127;
  const int h = blockIdx.x;
  const int head_dim = channels / heads;
  const int row = 3 * channels;

  st::zero(region, kW * kMine);
  st::fill_bias(bias_s, bias, bias_bf16, h, seq, 1);
  __syncthreads();

  uint16_t* mine = region + wg * kMine;
  uint16_t* pt = mine + st::kStages * kStage;  // P, [row][key], bf16
  uint16_t* dlt = pt + kTileElems;             // dl, the same
  const long long first = (long long)blockIdx.y * per_block;
  const long long last = min((long long)batch, first + per_block);
  const auto load = [&](long long b, uint16_t* dst) {
    const bf16* src = qkv + b * seq * row + h * head_dim;
    st::copy_operand<kD>(dst, src, row, seq, head_dim, wide, t);
    st::copy_operand<kD>(dst + kOp, src + channels, row, seq, head_dim, wide,
                         t);
    st::copy_operand<kD>(dst + 2 * kOp, src + 2 * channels, row, seq,
                         head_dim, wide, t);
    st::copy_operand<kD>(dst + 3 * kOp,
                         g + b * seq * channels + h * head_dim, channels, seq,
                         head_dim, wide, t);
    tc::cp_async_commit();
  };
  const st::Frag f(t);
  const float4* bias_t = reinterpret_cast<const float4*>(bias_s) + t;
  float acc[32];  // this warpgroup's Σ dl, in the fragment's layout
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;

  long long b = first + wg;
  if (b < last) load(b, mine);
  for (int i = 0; b < last; ++i, b += kW) {
    const uint16_t* q = mine + (i & 1) * kStage;
    const uint16_t* k = q + kOp;
    const uint16_t* v = q + 2 * kOp;
    const uint16_t* gs = q + 3 * kOp;
    // this window's operands have landed, and every thread of the
    // warpgroup is done with the other stage, P and dl
    tc::cp_async_wait_all();
    tc::fence_proxy_async();
    st::wg_sync(wg);
    if (b + kW < last) load(b + kW, mine + ((i + 1) & 1) * kStage);

    // 1. s = q kᵀ and dp = g vᵀ
    float s[32] = {}, dp[32] = {};
    tc::fence_operands(s);
    tc::fence_operands(dp);
    tc::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk)
      tc::wgmma_ss_n64(s, st::k_major<kD>(q, kk), st::k_major<kD>(k, kk),
                       kk > 0);
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk)
      tc::wgmma_ss_n64(dp, st::k_major<kD>(gs, kk), st::k_major<kD>(v, kk),
                       kk > 0);
    tc::wgmma_commit();
    tc::wgmma_wait_all();
    tc::fence_operands(s);
    tc::fence_operands(dp);

    // 2. P = softmax(s·scale + bias) (0 past S), D = rowsum(dP∘P),
    //    dl = P∘(dP − D), in f32; dl summed into acc
    float m[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float4 bv = bias_t[j * st::kWgThreads];
      s[4 * j] = fmaf(s[4 * j], scale, bv.x);
      s[4 * j + 1] = fmaf(s[4 * j + 1], scale, bv.y);
      s[4 * j + 2] = fmaf(s[4 * j + 2], scale, bv.z);
      s[4 * j + 3] = fmaf(s[4 * j + 3], scale, bv.w);
      m[0] = fmaxf(m[0], fmaxf(s[4 * j], s[4 * j + 1]));
      m[1] = fmaxf(m[1], fmaxf(s[4 * j + 2], s[4 * j + 3]));
    }
    float l[2] = {0.f, 0.f};
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) m[hh] = tc::quad_max(m[hh]);
#pragma unroll
    for (int i2 = 0; i2 < 32; ++i2) {
      const int hh = (i2 >> 1) & 1;
      s[i2] = exp2f((s[i2] - m[hh]) * tc::kLog2e);
      l[hh] += s[i2];
    }
    float dsum[2] = {0.f, 0.f};
    const float inv[2] = {1.f / tc::quad_sum(l[0]), 1.f / tc::quad_sum(l[1])};
#pragma unroll
    for (int i2 = 0; i2 < 32; ++i2) {
      const int hh = (i2 >> 1) & 1;
      s[i2] *= inv[hh];
      dsum[hh] = fmaf(dp[i2], s[i2], dsum[hh]);
    }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) dsum[hh] = tc::quad_sum(dsum[hh]);
#pragma unroll
    for (int i2 = 0; i2 < 32; ++i2) {
      dp[i2] = s[i2] * (dp[i2] - dsum[(i2 >> 1) & 1]);
      acc[i2] += dp[i2];
    }

    // 3. P and dl as bf16 pairs into their [row][key] tiles; dl's pairs
    //    are also dq's A fragments
    uint32_t a[4][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int r = f.row0 + 8 * hh;
        const int at = ((r >> 3) * 8 + j) * 64 + (r & 7) * 8 + f.col0;
        const int i2 = 4 * j + 2 * hh;
        const uint32_t pp = tc::pack_bf16(s[i2], s[i2 + 1]);
        const uint32_t dd = tc::pack_bf16(dp[i2], dp[i2 + 1]);
        *reinterpret_cast<uint32_t*>(pt + at) = pp;
        *reinterpret_cast<uint32_t*>(dlt + at) = dd;
        a[j >> 1][2 * (j & 1) + hh] = dd;
      }
    tc::fence_proxy_async();
    st::wg_sync(wg);

    // 4. dq = dl·k, dk = dlᵀ·q, dv = Pᵀ·g: k, q and g MN-major, dlᵀ and
    //    Pᵀ the MN-major reading of their tiles
    float dq[kD / 2] = {}, dk[kD / 2] = {}, dv[kD / 2] = {};
    tc::fence_operands(dq);
    tc::fence_operands(dk);
    tc::fence_operands(dv);
    tc::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      st::rs_t(dq, a[kk], st::mn_major<kD>(k, kk), kk > 0);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      st::ss_t(dk, st::tile_transposed(dlt, kk), st::mn_major<kD>(q, kk),
               kk > 0);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      st::ss_t(dv, st::tile_transposed(pt, kk), st::mn_major<kD>(gs, kk),
               kk > 0);
    tc::wgmma_commit();
    tc::wgmma_wait_all();
    tc::fence_operands(dq);
    tc::fence_operands(dk);
    tc::fence_operands(dv);

    // 5. dq·scale, dk·scale and dv as bf16 (rows and keys below S)
    bf16* dst = dqkv + b * seq * row + h * head_dim;
    const float by_scale[2] = {scale, scale}, one[2] = {1.f, 1.f};
    st::store_rows<kD>(dst, row, 0, seq, head_dim, f, dq, by_scale);
    st::store_rows<kD>(dst + channels, row, 0, seq, head_dim, f, dk,
                       by_scale);
    st::store_rows<kD>(dst + 2 * channels, row, 0, seq, head_dim, f, dv,
                       one);
  }

  // 6. the warpgroups' sums, added in order into the bias's place, then
  //    the rows and keys below S into this block's slot of the scratch
  __syncthreads();
  float4* sum = reinterpret_cast<float4*>(bias_s) + t;
  for (int w = 0; w < kW; ++w) {
    if (wg == w) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        float4 x = make_float4(acc[4 * j], acc[4 * j + 1], acc[4 * j + 2],
                               acc[4 * j + 3]);
        if (w > 0) {
          const float4 was = sum[j * st::kWgThreads];
          x.x += was.x;
          x.y += was.y;
          x.z += was.z;
          x.w += was.w;
        }
        sum[j * st::kWgThreads] = x;
      }
    }
    __syncthreads();
  }
  float* part = dbias_partial +
                ((long long)blockIdx.y * heads + h) * seq * seq;
  for (int e = threadIdx.x; e < kTileElems; e += blockDim.x) {
    const int c = e & 3, tt = (e >> 2) & 127, j = e >> 9;
    const st::Frag fe(tt);
    const int r = fe.row0 + 8 * (c >> 1), key = 8 * j + fe.col0 + (c & 1);
    if (r < seq && key < seq) part[r * seq + key] = bias_s[e];
  }
}

template <int kD>
cudaError_t launch_tc(const void* qkv, const void* bias, int bias_bf16,
                      const void* g, void* dqkv, float* partial, int batch,
                      int seq, int channels, int heads, int per_block,
                      int groups, float scale, cudaStream_t stream) {
  const size_t smem = st::bwd_smem_bytes(kD);
  auto kernel = window_mhsa_bwd_tc_kernel<kD>;
  const cudaError_t err = st::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(unsigned(heads), unsigned(groups)),
           st::kWgThreads * st::kBwdWarpgroups, smem, stream>>>(
      static_cast<const bf16*>(qkv), bias, bias_bf16,
      static_cast<const bf16*>(g), static_cast<bf16*>(dqkv), partial, batch,
      seq, channels, heads, per_block, scale,
      int(tc::wide_loads(channels / heads,
                         fastervit::attn_tiles::Strides{
                             (long long)seq * 3 * channels, channels / heads,
                             3 * channels},
                         {qkv}) &&
          tc::wide_loads(channels / heads,
                         fastervit::attn_tiles::Strides{
                             (long long)seq * channels, channels / heads,
                             channels},
                         {g})));
  return cudaGetLastError();
}

// The plan short_bwd_plan makes for S, hd and the operands' type.
st::Plan plan_for(int seq, int head_dim, bool tensor_cores) {
  if (tensor_cores) {
    const int d = st::depth(head_dim);
    return {1, d, 1, st::kBwdWarpgroups, st::kStages,
            int(st::bwd_smem_bytes(d))};
  }
  return {0, head_dim, 1, 1, 1,
          int(smem_floats(seq, head_dim) * sizeof(float))};
}

}  // namespace

extern "C" {

// qkv and dqkv: (batch, seq, 3·channels); g: (batch, seq, channels); all
// f32 (qkv_bf16 = 0: the scalar route) or all bf16 (qkv_bf16 = 1: the
// tensor cores). bias and dbias: (heads, seq, seq), f32 or bf16
// (bias_bf16). dbias_partial: f32 scratch of (groups, heads, seq, seq),
// where block (h, group) takes windows [group·per_block, (group + 1)·
// per_block) ∩ [0, batch). plan: the six ints of short_bwd_plan
// (short_tiles.cuh::Plan), checked against this library's own. Returns the
// cudaError_t of the first launch that failed, or 0.
int window_mhsa_backward(const void* qkv, const void* bias, const void* g,
                         void* dqkv, void* dbias, void* dbias_partial,
                         int batch, int seq, int channels, int heads,
                         int per_block, int groups, int qkv_bf16,
                         int bias_bf16, float scale, const int* plan,
                         void* stream) {
  if (batch <= 0 || seq <= 0 || seq > kMaxSeq || heads <= 0 ||
      channels % heads != 0 || channels / heads > kMaxHeadDim ||
      !st::grid_ok(batch, per_block, groups) ||
      !st::plan_ok(plan, plan_for(seq, channels / heads, qkv_bf16)))
    return int(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* partial = static_cast<float*>(dbias_partial);
  cudaError_t err;
  if (qkv_bf16) {
    err = st::depth(channels / heads) == 32
              ? launch_tc<32>(qkv, bias, bias_bf16, g, dqkv, partial, batch,
                              seq, channels, heads, per_block, groups, scale,
                              s)
              : launch_tc<64>(qkv, bias, bias_bf16, g, dqkv, partial, batch,
                              seq, channels, heads, per_block, groups, scale,
                              s);
  } else {
    err = bias_bf16 ? launch<__nv_bfloat16>(qkv, bias, g, dqkv, partial,
                                            batch, seq, channels, heads,
                                            per_block, groups, scale, s)
                    : launch<float>(qkv, bias, g, dqkv, partial, batch, seq,
                                    channels, heads, per_block, groups,
                                    scale, s);
  }
  if (err != cudaSuccess) return int(err);
  return int(bias_bf16 ? sum_dbias<__nv_bfloat16>(partial, dbias, groups,
                                                  heads, seq, s)
                       : sum_dbias<float>(partial, dbias, groups, heads, seq,
                                          s));
}

// The dynamic shared memory, in bytes, of a block of K2 at this S and hd on
// either route (tensor_cores: bf16 operands): what short_bwd_plan must
// name.
long long short_attention_bwd_smem_bytes(int seq, int head_dim,
                                         int tensor_cores) {
  if (seq <= 0 || seq > kMaxSeq || head_dim <= 0 || head_dim > kMaxHeadDim)
    return -1;
  return plan_for(seq, head_dim, tensor_cores != 0).smem;
}

}  // extern "C"
