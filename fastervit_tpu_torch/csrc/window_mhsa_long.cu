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
// The TPU kernel keeps the whole K/V row of a head in VMEM and so needs no
// running softmax state. At S = 2304 that row is 451 KB of bf16, more than
// the 227 KB of shared memory a block may have, so this kernel streams K/V
// in 64-key tiles (FlashAttention-2): a block keeps its q tile, a running
// row max and row sum in f32, and an f32 accumulator rescaled at each K/V
// tile; the context is divided by the sum once at the end. The grid's x is
// the window, so the blocks that read the same (head, q-tile) bias slab run
// side by side and find it in L2: the bias, (H, S, S), is the largest
// operand (170 MB in bf16 per level-2 call) and every window reads it. This
// is the TPU kernel's "hqb" grid order.
//
// Two routes, by the plan of ops/cuda_attention.py::long_plan (the tile
// steps and plans are in attn_tiles.cuh). bf16 runs on the tensor cores:
// a block of two warpgroups owns 128 q rows, q·kᵀ and p·v are wgmma with
// f32 accumulators, hd padded to D = 32, 64, 80 or 128, the next K/V tile
// staged in registers while the current one's products run, into the
// other of two shared-memory stages, two blocks an SM where they fit. f32
// stays on the scalar FMA tiles (64 q rows a block): TF32 would move the
// logits by ~1e-3.
//
// Bound on this card, bf16 (4·B·H·S²·hd operations; q, k, v and bias read
// once, the output written once):
//   21k-768 level 2 (B 16, S 2304, H 16, hd 49): 266 GFLOP, 0.269 ms at the
//     tensor-core peak (348 GFLOP padded to D 64: 0.352 ms); 401 MB, 0.12
//     ms at the memory rate: operations;
//   21k-768 level 3 (16, 576, 32, 49) and 21k-384 level 2 (32, 576, 16,
//     49): 33 GFLOP, 0.034 ms; 137 and 126 MB, 0.041 and 0.038 ms: bytes.
// What sets the pace at level 2 beside the products: the K/V loads (36
// tiles of 2 × 64 × 49 bf16 for each of the 4,608 blocks: 2.1 GB from
// L2, two bytes a load at hd 49), the bias stream (2.7 GB a call from
// L2, 170 MB from memory, staged a tile ahead by cp.async), the softmax's
// CUDA-core work between the products, and D's padding (23% of the
// products at hd 49); attn_tiles.cuh says what each costs. P2 below, the
// same kernel without the bias, measures the bias's share.
//
// Numerics, as the plain version (ops/attention.py::
// window_mhsa_long_reference): logits q·kᵀ·scale + bias in f32 (bf16
// products are exact in f32, so the tensor cores change only the order of
// the sums); p = exp(logit − running max) in f32 (on the tensor-core
// route as exp2 of (logit − max)·log2 e, within a few ulps); Σp of the
// unrounded p
// in f32; p rounded to qkv's type for the PV product, which accumulates in
// f32; the context divided by Σp and written in qkv's type. The plain
// version takes p against the final row max; here each tile's p is
// against the running max and later rescaled, which differs only by
// rounding.
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
// Plain C interface, bound with ctypes by fastervit_tpu_torch/ops/
// cuda_attention.py, which checks device, dtype, shape and layout.

#include <cmath>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "attn_tiles.cuh"
#include "dtype.cuh"

namespace {

using namespace fastervit::attn_tiles;

// The scalar route (f32). NJ = hd_pad / 16: the accumulator columns each
// thread holds. kBias false is P2, whose bias is never read.
template <typename TB, bool kBias, int NJ>
__global__ void __launch_bounds__(kThreads)
window_mhsa_long_kernel(const float* __restrict__ q,
                        const float* __restrict__ k,
                        const float* __restrict__ v, Strides in,
                        const TB* __restrict__ bias, float* __restrict__ out,
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

  load_q<kHdPad>(q + at, in.token, q0, seq, head_dim, sm);
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
    load_kv<kHdPad, true>(k + at, v + at, in.token, k0, seq,
                                 head_dim, sm);
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
        sm.p[(ty + 16 * i) * kLd + tx + 16 * j] = pv;
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

  // 5. out = acc / Σp.
  store<NJ>(out + slab(os), os.token, q0, seq, head_dim, acc, l);
}

// The tensor-core route (bf16): kD the padded head dim, kVec the load
// width in elements. kBias false is P2.
template <typename TB, bool kBias, int kD, int kVec>
__global__ void __launch_bounds__(tc::kThreads,
                                  tc::min_blocks<kD, TB, kBias>())
window_mhsa_long_tc_kernel(const tc::bf16* __restrict__ q,
                           const tc::bf16* __restrict__ k,
                           const tc::bf16* __restrict__ v, Strides in,
                           const TB* __restrict__ bias,
                           tc::bf16* __restrict__ out, Strides os, int seq,
                           int head_dim, float scale, int bias_async) {
  extern __shared__ __align__(128) uint16_t smem_tc[];
  const tc::Smem<kD> sm{smem_tc};
  const tc::Fragment f;
  const int q0 = blockIdx.y * tc::kRows;
  const long long at = slab(in);
  q += at;
  k += at;
  v += at;
  const TB* bias_h = kBias ? bias + (long long)blockIdx.z * seq * seq
                           : nullptr;

  // q, and the first K/V tile (and bias tile) into stage 0.
  tc::load_q<kD, kVec>(q, in.token, q0, seq, head_dim, sm);
  tc::Staged<kD, kVec> ks, vs;
  if constexpr (kBias)
    tc::copy_bias(bias_h, sm.template bias<TB>(0), q0, 0, seq, seq,
                  bias_async);
  ks.load(k, in.token, 0, seq, head_dim);
  vs.load(v, in.token, 0, seq, head_dim);
  ks.store(sm.k(0));
  vs.store_transposed(sm.vt(0));
  tc::fence_proxy_async();
  tc::cp_async_wait_all();
  __syncthreads();

  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float o[kD / 2], s[32];
#pragma unroll
  for (int i = 0; i < kD / 2; ++i) o[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = 0.f;

  const int tiles = (seq + tc::kKeys - 1) / tc::kKeys;
  for (int t = 0; t < tiles; ++t) {
    const int stage = t & 1, k0 = t * tc::kKeys;
    const bool more = t + 1 < tiles;
    // 1. s = q kᵀ on the tensor cores; meanwhile the next tile's bias
    //    is copied into the other stage and its k and v come into
    //    registers.
    tc::issue_qk<kD>(s, sm, stage);
    if constexpr (kBias) {
      if (more)
        tc::copy_bias(bias_h, sm.template bias<TB>(stage ^ 1), q0,
                      k0 + tc::kKeys, seq, seq, bias_async);
    }
    if (more) {
      ks.load(k, in.token, k0 + tc::kKeys, seq, head_dim);
      vs.load(v, in.token, k0 + tc::kKeys, seq, head_dim);
    }
    tc::wgmma_wait_all();
    tc::fence_operands(s);

    // 2. logits and the online softmax: every tile holds a key < S, so
    //    the new max is finite and alpha is 0 on the first tile.
    tc::logits<TB, kBias>(s, sm.template bias<TB>(stage), f, k0, seq,
                          scale);
    float mnew[2], alpha[2], psum[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mnew[h] = fmaxf(m[h], tc::quad_max(tc::thread_max(s, h)));
      alpha[h] = expf(m[h] - mnew[h]);
    }
    uint32_t p[4][4];
    tc::probabilities(s, mnew, psum, p);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      l[h] = fmaf(l[h], alpha[h], psum[h]);
      m[h] = mnew[h];
    }
    tc::rescale(o, alpha);

    // 3. o += p v on the tensor cores; meanwhile the next tile goes into
    //    the other stage, which the previous tile's products have left.
    tc::issue_pv<kD>(o, p, sm, stage);
    if (more) {
      ks.store(sm.k(stage ^ 1));
      vs.store_transposed(sm.vt(stage ^ 1));
      tc::fence_proxy_async();
    }
    tc::wgmma_wait_all();
    tc::fence_operands(o);
    tc::cp_async_wait_all();
    __syncthreads();
  }

  // 4. out = o / Σp, as bf16.
  tc::store<kD>(out + slab(os), os.token, q0, seq, head_dim, f, o, l);
}

template <typename TB, bool kBias>
cudaError_t launch_scalar(const void* q, const void* k, const void* v,
                          Strides in, const void* bias, void* out,
                          Strides os, int batch, int heads, int seq,
                          int head_dim, float scale, cudaStream_t stream) {
  return with_nj(head_dim, [&](auto nj) {
    constexpr int NJ = decltype(nj)::value;
    return launch<NJ>(window_mhsa_long_kernel<TB, kBias, NJ>, batch, seq,
                      heads, head_dim, stream, static_cast<const float*>(q),
                      static_cast<const float*>(k),
                      static_cast<const float*>(v), in,
                      static_cast<const TB*>(bias), static_cast<float*>(out),
                      os, seq, head_dim, scale);
  });
}

template <typename TB, bool kBias>
cudaError_t launch_tc(const void* q, const void* k, const void* v,
                      Strides in, const void* bias, void* out, Strides os,
                      int batch, int heads, int seq, int head_dim,
                      float scale, cudaStream_t stream) {
  const int bias_bytes = kBias ? int(sizeof(TB)) : 0;
  const bool async = kBias && tc::bias_async(bias, seq, seq, bias_bytes);
  return tc::with_depth(head_dim, [&](auto depth) {
    constexpr int kD = decltype(depth)::value;
    return tc::with_vec(
        tc::wide_loads(head_dim, in, {q, k, v}), [&](auto vec) {
          constexpr int kVec = decltype(vec)::value;
          return tc::launch<kD>(
              window_mhsa_long_tc_kernel<TB, kBias, kD, kVec>, bias_bytes,
              batch, seq, heads, stream, static_cast<const tc::bf16*>(q),
              static_cast<const tc::bf16*>(k),
              static_cast<const tc::bf16*>(v), in,
              static_cast<const TB*>(bias), static_cast<tc::bf16*>(out), os,
              seq, head_dim, scale, int(async));
        });
  });
}

}  // namespace

extern "C" {

// K3. qkv: (batch, seq, 3·channels), channels (3, heads, hd); out: (batch,
// seq, channels); both f32 (qkv_bf16 = 0) or bf16 (qkv_bf16 = 1); bias:
// (heads, seq, seq), f32 or bf16 (bias_bf16), read as f32; plan: the six
// ints of long_plan (attn_tiles.cuh::Plan), checked against this
// library's own. Returns the cudaError_t of the launch.
int window_mhsa_long_forward(const void* qkv, const void* bias, void* out,
                             int batch, int seq, int channels, int heads,
                             int qkv_bf16, int bias_bf16, float scale,
                             const int* plan, void* stream) {
  if (heads <= 0 || channels % heads != 0 ||
      !launchable(batch, seq, heads, channels / heads, 3LL * channels,
                  channels) ||
      !plan_ok(plan, channels / heads, qkv_bf16, bias_bf16 ? 2 : 4))
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
        ? int(launch_tc<__nv_bfloat16, true>(q, k, v, in, bias, out, os,
                                             batch, heads, seq, hd, scale,
                                             s))
        : int(launch_tc<float, true>(q, k, v, in, bias, out, os, batch,
                                     heads, seq, hd, scale, s));
  }
  return bias_bf16
      ? int(launch_scalar<__nv_bfloat16, true>(q, k, v, in, bias, out, os,
                                               batch, heads, seq, hd, scale,
                                               s))
      : int(launch_scalar<float, true>(q, k, v, in, bias, out, os, batch,
                                       heads, seq, hd, scale, s));
}

// P2. q, k, v: (batch, heads, seq, head_dim) with element strides
// in_window, in_head, in_token (alike for the three, hd contiguous); out:
// the same shape with strides out_*; all f32 (bf16 = 0) or all bf16
// (bf16 = 1); plan as K3's. Returns the cudaError_t of the launch.
int attn_nobias_forward(const void* q, const void* k, const void* v,
                        void* out, int batch, int heads, int seq,
                        int head_dim, long long in_window, long long in_head,
                        long long in_token, long long out_window,
                        long long out_head, long long out_token, int bf16,
                        float scale, const int* plan, void* stream) {
  if (!launchable(batch, seq, heads, head_dim, in_token, out_token) ||
      !plan_ok(plan, head_dim, bf16, 0))
    return int(cudaErrorInvalidValue);
  const Strides in{in_window, in_head, int(in_token)};
  const Strides os{out_window, out_head, int(out_token)};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? int(launch_tc<float, false>(q, k, v, in, nullptr, out, os,
                                            batch, heads, seq, head_dim,
                                            scale, s))
              : int(launch_scalar<float, false>(q, k, v, in, nullptr, out,
                                                os, batch, heads, seq,
                                                head_dim, scale, s));
}

// The dynamic shared memory, in bytes, of a block of the long-window
// attention kernels (K3, P1, P2) at this hd on either route, with a bias
// of bias_bytes a value (0: P2's none): what long_plan must name.
long long long_attention_smem_bytes(int head_dim, int tensor_cores,
                                    int bias_bytes) {
  return plan_for(head_dim, tensor_cores != 0, bias_bytes).smem;
}

}  // extern "C"
