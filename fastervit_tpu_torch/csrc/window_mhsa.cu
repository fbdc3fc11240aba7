// Bias-added multi-head attention over small windows, for Hopper (sm_90a):
// K1.
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
// product accumulates in f32. It takes S <= 128 and hd <= 64.
//
// Bound on this card: memory. At FasterViT-0 level 2, batch 256, bf16
// (B = 1024 windows of S = 53 tokens, C = 256, H = 8, hd = 32) one call
// reads about 83 MB of qkv and writes 28 MB for about 2.9 GFLOP: roughly
// 26 FLOP/byte, far below the ~295 FLOP/byte at which an H100's bf16 tensor
// cores become the limit (33 µs at the memory rate).
//
// Two routes, by the plan of ops/cuda_attention.py::short_plan, which the
// entry point checks against its own (short_tiles.cuh says how the
// tensor-core route keeps its operands):
//
// bf16: the tensor cores (wgmma). A block owns one head and a run of
// windows (grid (H, groups), ops/cuda_attention.py::forward_grid), its bias
// read once into shared memory in the S accumulator's fragment order. Each
// of its warpgroups owns one window at a time: q·kᵀ is m64n64 with q and k
// K-major in shared memory, the softmax runs on the f32 accumulator in
// registers (exp2, log2 e folded in, exact: every key lies in the one key
// tile, or two for 64 < S <= 128), the unnormalised p rounded to bf16
// pairs is the A fragment of p·v (m64nD, v MN-major by the transpose bit),
// and the context divided by Σp is written as bf16. Meanwhile the next
// window's q, k, v come into the warpgroup's other stage. S <= 64: two
// warpgroups a block; 64 < S <= 128: one, with two row slabs and two key
// tiles a window. hd pads to D = 32 or 64.
//
// f32: the scalar route, one block per (window, head), q, k, v and the
// logits as f32 in shared memory, scalar FMA loops. TF32 would move the
// logits by ~1e-3, and the f32 path is held to 2e-5. It reached about
// 0.2 TB/s as the route of every dtype (0.5497 ms at the shape above in
// bf16, one H100, "NVIDIA H100 80GB HBM3, 700.00 W", chip_smoke.py):
// shared-memory load issue limits it.
//
// The TPU kernel packed floor(128/S) windows into one sequence under a
// block-diagonal mask to fill the 128-wide MXU. On Hopper that mask only
// wastes work: a warpgroup's 64-row tile holds one window, padded.
//
// Plain C interface, bound with ctypes by fastervit_tpu_torch/ops/
// cuda_attention.py, which checks device, dtype, shape and contiguity.

#include <climits>
#include <cmath>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <type_traits>

#include "dtype.cuh"
#include "short_tiles.cuh"

namespace {

namespace st = fastervit::short_tiles;
namespace tc = fastervit::attn_tiles::tc;
using tc::bf16;
using fastervit::to_f32;

constexpr int kMaxSeq = 128;     // MAX_SEQ in cuda_attention.py
constexpr int kMaxHeadDim = 64;  // MAX_HEAD_DIM in cuda_attention.py
constexpr int kThreads = 128;

// Shared memory, in floats: q (S×hd), k (S×(hd+1), padded so that a warp
// reading one column of k hits 32 banks), v (S×hd), logits (S×S).
inline size_t smem_floats(int seq, int head_dim) {
  return size_t(seq) * (3 * head_dim + 1 + seq);
}

// The scalar route (f32).
template <typename TB>
__global__ void __launch_bounds__(kThreads)
window_mhsa_kernel(const float* __restrict__ qkv,
                   const TB* __restrict__ bias, float* __restrict__ out,
                   int seq, int channels, int heads, float scale) {
  extern __shared__ float smem[];
  const int head_dim = channels / heads;
  const int h = blockIdx.x % heads;
  const long long b = blockIdx.x / heads;
  const int kstride = head_dim + 1;
  float* q = smem;
  float* k = q + seq * head_dim;
  float* v = k + seq * kstride;
  float* logits = v + seq * head_dim;

  // 1. q, k, v of head h.
  const long long row = 3LL * channels;
  const float* src = qkv + b * seq * row + h * head_dim;
  for (int e = threadIdx.x; e < seq * head_dim; e += blockDim.x) {
    const int s = e / head_dim, d = e - s * head_dim;
    const float* r = src + s * row + d;
    q[e] = r[0];
    k[s * kstride + d] = r[channels];
    v[e] = r[2 * channels];
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

  // 3. Row softmax, one warp per row: max, exp, sum, divide.
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
    for (int j = lane; j < seq; j += 32) li[j] /= sum;
  }
  __syncthreads();

  // 4. out = p · v.
  float* dst = out + b * seq * channels + h * head_dim;
  for (int e = threadIdx.x; e < seq * head_dim; e += blockDim.x) {
    const int i = e / head_dim, d = e - i * head_dim;
    const float* pi = logits + i * seq;
    float acc = 0.f;
    for (int j = 0; j < seq; ++j) acc = fmaf(pi[j], v[j * head_dim + d], acc);
    dst[(long long)i * channels + d] = acc;
  }
}

template <typename TB>
cudaError_t launch(const void* qkv, const void* bias, void* out, int batch,
                   int seq, int channels, int heads, float scale,
                   cudaStream_t stream) {
  const size_t smem = smem_floats(seq, channels / heads) * sizeof(float);
  auto kernel = window_mhsa_kernel<TB>;
  const cudaError_t err = st::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<unsigned(batch) * unsigned(heads), kThreads, smem, stream>>>(
      static_cast<const float*>(qkv), static_cast<const TB*>(bias),
      static_cast<float*>(out), seq, channels, heads, scale);
  return cudaGetLastError();
}


// The tensor-core route: kD the padded head dim, kR the row slabs and key
// tiles of a window (1 for S <= 64, 2 up to 128). Block (h, group) takes
// head h of windows [group·per_block, (group + 1)·per_block) ∩ [0, B);
// its warpgroup wg the windows first + wg, first + wg + kW, ...
template <int kD, int kR>
__global__ void __launch_bounds__(st::kWgThreads * st::fwd_warpgroups(kR))
window_mhsa_tc_kernel(const bf16* __restrict__ qkv,
                      const void* __restrict__ bias, int bias_bf16,
                      bf16* __restrict__ out, int batch, int seq,
                      int channels, int heads, int per_block, float scale,
                      int wide) {
  constexpr int kW = st::fwd_warpgroups(kR);
  constexpr int kOp = kR * st::kTile * kD;  // one operand's elements
  constexpr int kStage = 3 * kOp;           // q, k, v
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const float* bias_s = reinterpret_cast<const float*>(smem_raw);
  uint16_t* stages = reinterpret_cast<uint16_t*>(smem_raw +
                                                 st::bias_bytes(kR));
  const int wg = threadIdx.x >> 7, t = threadIdx.x & 127;
  const int h = blockIdx.x;
  const int head_dim = channels / heads;
  const int row = 3 * channels;

  st::zero(stages, kW * st::kStages * kStage);
  st::fill_bias(reinterpret_cast<float*>(smem_raw), bias, bias_bf16, h, seq,
                kR);
  __syncthreads();

  uint16_t* mine = stages + wg * st::kStages * kStage;
  const long long first = (long long)blockIdx.y * per_block;
  const long long last = min((long long)batch, first + per_block);
  const bf16* src_h = qkv + h * head_dim;
  const auto load = [&](long long b, uint16_t* dst) {
    const bf16* src = src_h + b * seq * row;
    st::copy_operand<kD>(dst, src, row, seq, head_dim, wide, t);
    st::copy_operand<kD>(dst + kOp, src + channels, row, seq, head_dim, wide,
                         t);
    st::copy_operand<kD>(dst + 2 * kOp, src + 2 * channels, row, seq,
                         head_dim, wide, t);
    tc::cp_async_commit();
  };
  const st::Frag f(t);
  const float4* bias_t = reinterpret_cast<const float4*>(bias_s) + t;

  long long b = first + wg;
  if (b < last) load(b, mine);
  for (int i = 0; b < last; ++i, b += kW) {
    const uint16_t* cur = mine + (i & 1) * kStage;
    // this window's operands have landed, and every thread of the
    // warpgroup is done with the other stage: the next window goes there
    tc::cp_async_wait_all();
    tc::fence_proxy_async();
    st::wg_sync(wg);
    if (b + kW < last) load(b + kW, mine + ((i + 1) & 1) * kStage);

#pragma unroll
    for (int r = 0; r < kR; ++r) {
      // 1. s = q kᵀ over the slab's 64 rows and every key tile
      float s[kR][32] = {};
#pragma unroll
      for (int kt = 0; kt < kR; ++kt) tc::fence_operands(s[kt]);
      tc::wgmma_fence();
#pragma unroll
      for (int kt = 0; kt < kR; ++kt)
#pragma unroll
        for (int kk = 0; kk < kD / 16; ++kk)
          tc::wgmma_ss_n64(
              s[kt], st::k_major<kD>(cur + r * st::kTile * kD, kk),
              st::k_major<kD>(cur + kOp + kt * st::kTile * kD, kk), kk > 0);
      tc::wgmma_commit();
      tc::wgmma_wait_all();
#pragma unroll
      for (int kt = 0; kt < kR; ++kt) tc::fence_operands(s[kt]);

      // 2. logits s·scale + bias (−inf past S), the row max, p = exp(s −
      //    max) as exp2, Σp, and p rounded to bf16 pairs: the A fragments
      float m[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int kt = 0; kt < kR; ++kt)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float4 bv = bias_t[((r * kR + kt) * 8 + j) * st::kWgThreads];
          s[kt][4 * j] = fmaf(s[kt][4 * j], scale, bv.x);
          s[kt][4 * j + 1] = fmaf(s[kt][4 * j + 1], scale, bv.y);
          s[kt][4 * j + 2] = fmaf(s[kt][4 * j + 2], scale, bv.z);
          s[kt][4 * j + 3] = fmaf(s[kt][4 * j + 3], scale, bv.w);
          m[0] = fmaxf(m[0], fmaxf(s[kt][4 * j], s[kt][4 * j + 1]));
          m[1] = fmaxf(m[1], fmaxf(s[kt][4 * j + 2], s[kt][4 * j + 3]));
        }
      float l[2] = {0.f, 0.f};
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) m[hh] = tc::quad_max(m[hh]);
      uint32_t p[kR][4][4];
#pragma unroll
      for (int kt = 0; kt < kR; ++kt) {
#pragma unroll
        for (int i2 = 0; i2 < 32; ++i2) {
          const int hh = (i2 >> 1) & 1;
          s[kt][i2] = exp2f((s[kt][i2] - m[hh]) * tc::kLog2e);
          l[hh] += s[kt][i2];
        }
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int i2 = 0; i2 < 4; ++i2)
            p[kt][kk][i2] = tc::pack_bf16(s[kt][8 * kk + 2 * i2],
                                          s[kt][8 * kk + 2 * i2 + 1]);
      }

      // 3. o = p · v, v MN-major (the transpose bit)
      float o[kD / 2];
#pragma unroll
      for (int i2 = 0; i2 < kD / 2; ++i2) o[i2] = 0.f;
      tc::fence_operands(o);
      tc::wgmma_fence();
#pragma unroll
      for (int kt = 0; kt < kR; ++kt)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          st::rs_t(o, p[kt][kk],
                   st::mn_major<kD>(cur + 2 * kOp + kt * st::kTile * kD, kk),
                   1);
      tc::wgmma_commit();
      tc::wgmma_wait_all();
      tc::fence_operands(o);

      // 4. out = o / Σp, as bf16
      const float inv[2] = {1.f / tc::quad_sum(l[0]),
                            1.f / tc::quad_sum(l[1])};
      st::store_rows<kD>(out + b * seq * channels + h * head_dim, channels,
                         r * st::kTile, seq, head_dim, f, o, inv);
    }
  }
}

template <int kD, int kR>
cudaError_t launch_tc(const void* qkv, const void* bias, int bias_bf16,
                      void* out, int batch, int seq, int channels, int heads,
                      int per_block, int groups, float scale,
                      cudaStream_t stream) {
  const size_t smem = st::fwd_smem_bytes(kD, kR);
  auto kernel = window_mhsa_tc_kernel<kD, kR>;
  const cudaError_t err = st::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(unsigned(heads), unsigned(groups)),
           st::kWgThreads * st::fwd_warpgroups(kR), smem, stream>>>(
      static_cast<const bf16*>(qkv), bias, bias_bf16, static_cast<bf16*>(out),
      batch, seq, channels, heads, per_block, scale,
      int(tc::wide_loads(channels / heads,
                         fastervit::attn_tiles::Strides{
                             (long long)seq * 3 * channels, channels / heads,
                             3 * channels},
                         {qkv})));
  return cudaGetLastError();
}

// The plan short_plan makes for S, hd and the operands' type.
st::Plan plan_for(int seq, int head_dim, bool tensor_cores) {
  if (tensor_cores) {
    const int d = st::depth(head_dim), r = st::tiles(seq);
    return {1, d, r, st::fwd_warpgroups(r), st::kStages,
            int(st::fwd_smem_bytes(d, r))};
  }
  return {0, head_dim, 1, 1, 1,
          int(smem_floats(seq, head_dim) * sizeof(float))};
}

}  // namespace

extern "C" {

// qkv: (batch, seq, 3·channels), out: (batch, seq, channels), both f32
// (qkv_bf16 = 0: the scalar route) or bf16 (qkv_bf16 = 1: the tensor
// cores); bias: (heads, seq, seq), f32 or bf16 (bias_bf16), read as f32;
// plan: the six ints of short_plan (short_tiles.cuh::Plan), checked against
// this library's own; per_block, groups: the tensor-core route's (heads,
// groups) grid of forward_grid, block (h, group) taking windows
// [group·per_block, (group + 1)·per_block) ∩ [0, batch) (the scalar route
// runs a block per window and head). Returns the cudaError_t of the
// launch.
int window_mhsa_forward(const void* qkv, const void* bias, void* out,
                        int batch, int seq, int channels, int heads,
                        int qkv_bf16, int bias_bf16, float scale,
                        const int* plan, int per_block, int groups,
                        void* stream) {
  if (batch <= 0 || seq <= 0 || seq > kMaxSeq || heads <= 0 ||
      channels % heads != 0 || channels / heads > kMaxHeadDim ||
      (long long)batch * heads > INT_MAX ||
      !st::grid_ok(batch, per_block, groups) ||
      !st::plan_ok(plan, plan_for(seq, channels / heads, qkv_bf16)))
    return int(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (qkv_bf16) {
    const auto run = [&](auto d, auto r) {
      return launch_tc<decltype(d)::value, decltype(r)::value>(
          qkv, bias, bias_bf16, out, batch, seq, channels, heads, per_block,
          groups, scale, s);
    };
    using One = std::integral_constant<int, 1>;
    using Two = std::integral_constant<int, 2>;
    using D32 = std::integral_constant<int, 32>;
    using D64 = std::integral_constant<int, 64>;
    const bool narrow = st::depth(channels / heads) == 32;
    if (st::tiles(seq) == 1)
      return int(narrow ? run(D32{}, One{}) : run(D64{}, One{}));
    return int(narrow ? run(D32{}, Two{}) : run(D64{}, Two{}));
  }
  return bias_bf16
      ? int(launch<__nv_bfloat16>(qkv, bias, out, batch, seq, channels,
                                  heads, scale, s))
      : int(launch<float>(qkv, bias, out, batch, seq, channels, heads, scale,
                          s));
}

// The dynamic shared memory, in bytes, of a block of K1 at this S and hd on
// either route (tensor_cores: bf16 operands): what short_plan must name.
long long short_attention_smem_bytes(int seq, int head_dim,
                                     int tensor_cores) {
  if (seq <= 0 || seq > kMaxSeq || head_dim <= 0 || head_dim > kMaxHeadDim)
    return -1;
  return plan_for(seq, head_dim, tensor_cores != 0).smem;
}

const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
