// Bias-added attention with a chunked online softmax, for Hopper (sm_90a): P1.
//
// Replaces `_online_kernel` of scripts/attn_online_probe.py (called through
// `online_forward`), the TPU probe that splits each key row into C chunks
// and keeps a running (max, sum, context) rescaled once a chunk. For each
// window b and head h:
//
//   out[b, h] = softmax(q[b, h] k[b, h]ᵀ·scale + bias[h]) · v[b, h]
//
// on q, k, v and out of (B, H, S, hd) given by strides (hd contiguous), f32
// or bf16, bias (H, S, S) f32 or bf16, any S >= 1 that C divides and
// hd <= 128. It never writes logits to device memory.
//
// The contract that keeps it to the plain version's roundings (and to the
// TPU kernel's) is that each chunk's p is taken against the running max
// after that chunk: p = exp(logit − m_new) with m_new = max(m, the chunk's
// row max), then rounded to the input type for the PV product. A chunk is
// S/C keys, 1152 at the probe's C = 2; its f32 logits for 128 q rows are
// 590 KB, more than the 227 KB of shared memory a block may have, and S
// has no upper limit. So each chunk takes two sweeps over its keys in
// 64-key tiles: the first computes q kᵀ·scale + bias and keeps only the
// row max (no v is loaded); then the running sum and context are rescaled
// once by α = exp(m − m_new); the second recomputes the same logits (the
// same code on the same tiles, so the same bits), forms p, sums it and
// accumulates p·v. Shared memory stays at K3's plan for any S and any C,
// at the cost of one more q kᵀ product: three products where K3 does two.
// At C = 1 it is one softmax over the whole row.
//
// Otherwise it is K3's design (window_mhsa_long.cu) on K3's tile steps
// and plans (attn_tiles.cuh): one block per (window, q tile, head), the
// window innermost so that the blocks that read one (head, q-tile) bias
// slab run side by side and find it in L2. bf16 on the tensor cores
// (wgmma, 128 q rows a block, hd padded to D = 32, 64, 80 or 128, the
// next K/V tile staged in registers while the current tile's products
// run, two blocks an SM where they fit); f32 on scalar FMA (64 rows a
// block), where TF32 would move the logits by ~1e-3. The two sweeps are
// one pipeline of steps: the first sweep's steps load only k, the
// second's k and v.
//
// Bound on this card: operations. At the probe's geometry, FasterViT-4-21k
// at 768² level 2 (B = 16, S = 2304, H = 16, hd = 49, bf16, bf16 bias), the
// function is 4·B·H·S²·hd = 266 GFLOP against 401 MB of q, k, v, bias and
// output: 0.27 ms at the bf16 tensor-core peak, 0.12 ms at the memory
// rate. The kernel does 1.5× that work (the extra q kᵀ sweep), 523 GFLOP
// padded to D 64, reads k and the bias twice a call (two sweeps: 5.4 GB
// of bias from L2) and takes twice K3's tile steps, each with its
// CUDA-core share (attn_tiles.cuh): the extra sweep's steps are what it
// pays beside K3.
//
// Numerics, as ops/attention_probes.py::online_attention_reference: q, k
// and bias read as f32, logits in f32 (bf16 products are exact in f32);
// p = exp(logit − m_new) (on the tensor-core route as exp2 of
// (logit − m_new)·log2 e, within a few ulps); Σp of the unrounded p in
// f32; the context divided by the sum once at the end and written in the
// input type. Only the order of the f32 sums differs. Every offset is
// 64-bit. Plain C interface, bound with ctypes by fastervit_tpu_torch/
// ops/cuda_attention.py, which checks device, dtype, shape and layout.

#include <cmath>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "attn_tiles.cuh"
#include "dtype.cuh"

namespace {

using namespace fastervit::attn_tiles;

// The scalar route (f32). NJ = hd_pad / 16: the accumulator columns each
// thread holds.
template <typename TB, int NJ>
__global__ void __launch_bounds__(kThreads)
attn_online_kernel(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v, Strides in,
                   const TB* __restrict__ bias, float* __restrict__ out,
                   Strides os, int seq, int head_dim, int chunk,
                   float scale) {
  constexpr int kHdPad = 16 * NJ;
  extern __shared__ float smem[];
  const Smem sm(smem, head_dim);
  const int q0 = blockIdx.y * kTile;
  const long long at = slab(in);
  const int tx = threadIdx.x & 15;    // keys tx + 16j
  const int ty = threadIdx.x >> 4;    // rows ty + 16i
  const TB* bias_h = bias + (long long)blockIdx.z * seq * seq;

  load_q<kHdPad>(q + at, in.token, q0, seq, head_dim, sm);
  float m[4], l[4], acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
  }

  float sc[4][4];
  for (int c0 = 0; c0 < seq; c0 += chunk) {
    const int end = c0 + chunk;

    // 1. the chunk's row max, over its 64-key tiles.
    float cmax[4] = {-INFINITY, -INFINITY, -INFINITY, -INFINITY};
    for (int k0 = c0; k0 < end; k0 += kTile) {
      __syncthreads();  // the previous tile's k, v and p are no longer read
      load_kv<kHdPad, false>(k + at, nullptr, in.token, k0, end,
                                    head_dim, sm);
      __syncthreads();
      logits<TB, true>(sm, bias_h, q0, k0, end, seq, head_dim, scale, sc);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) cmax[i] = fmaxf(cmax[i], sc[i][j]);
    }

    // 2. m_new = max(m, chunk max); rescale the running sum and context
    //    once. Every chunk holds at least one key, so m_new is finite and
    //    α is 0 on the first chunk.
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float mnew = fmaxf(m[i], row_max(cmax[i]));
      const float alpha = expf(m[i] - mnew);
      l[i] *= alpha;
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] *= alpha;
      m[i] = mnew;
    }

    // 3. p = exp(logits − m_new), Σp, and acc += p · v, tile by tile.
    for (int k0 = c0; k0 < end; k0 += kTile) {
      __syncthreads();
      load_kv<kHdPad, true>(k + at, v + at, in.token, k0, end,
                                   head_dim, sm);
      __syncthreads();
      logits<TB, true>(sm, bias_h, q0, k0, end, seq, head_dim, scale, sc);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float psum = 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float pv = expf(sc[i][j] - m[i]);
          psum += pv;
          sm.p[(ty + 16 * i) * kLd + tx + 16 * j] = pv;
        }
        l[i] += row_sum(psum);
      }
      __syncthreads();
      accumulate_pv<NJ>(sm, min(kTile, end - k0), acc);
    }
  }

  // 4. out = acc / Σp.
  store<NJ>(out + slab(os), os.token, q0, seq, head_dim, acc, l);
}

// The tensor-core route (bf16): kD the padded head dim, kVec the load
// width in elements. Step t of the pipeline is tile t % tpc of sweep
// (t / tpc) % 2 of chunk t / (2·tpc), tpc the chunk's 64-key tiles.
template <typename TB, int kD, int kVec>
__global__ void __launch_bounds__(tc::kThreads,
                                  tc::min_blocks<kD, TB, true>())
attn_online_tc_kernel(const tc::bf16* __restrict__ q,
                      const tc::bf16* __restrict__ k,
                      const tc::bf16* __restrict__ v, Strides in,
                      const TB* __restrict__ bias,
                      tc::bf16* __restrict__ out, Strides os, int seq,
                      int head_dim, int chunk, float scale,
                      int bias_async) {
  extern __shared__ __align__(128) uint16_t smem_tc[];
  const tc::Smem<kD> sm{smem_tc};
  const tc::Fragment f;
  const int q0 = blockIdx.y * tc::kRows;
  const long long at = slab(in);
  q += at;
  k += at;
  v += at;
  const TB* bias_h = bias + (long long)blockIdx.z * seq * seq;
  const int tpc = (chunk + tc::kKeys - 1) / tc::kKeys;
  const int steps = (seq / chunk) * 2 * tpc;

  // q, and the first step's k (the first sweep loads no v) and bias into
  // stage 0.
  tc::load_q<kD, kVec>(q, in.token, q0, seq, head_dim, sm);
  tc::Staged<kD, kVec> ks, vs;
  tc::copy_bias(bias_h, sm.template bias<TB>(0), q0, 0, chunk, seq,
                bias_async);
  ks.load(k, in.token, 0, chunk, head_dim);
  ks.store(sm.k(0));
  tc::fence_proxy_async();
  tc::cp_async_wait_all();
  __syncthreads();

  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float cmax[2] = {-INFINITY, -INFINITY};
  float o[kD / 2], s[32];
#pragma unroll
  for (int i = 0; i < kD / 2; ++i) o[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = 0.f;

  for (int t = 0; t < steps; ++t) {
    const int stage = t & 1, c0 = (t / (2 * tpc)) * chunk;
    const int tile = t % tpc, end = c0 + chunk;
    const int k0 = c0 + tile * tc::kKeys;
    const bool second = (t / tpc) & 1;
    // the next step's keys, and whether it is a second sweep's
    const int tn = t + 1, cn = (tn / (2 * tpc)) * chunk;
    const bool more = tn < steps, next_v = (tn / tpc) & 1;
    const int kn = cn + (tn % tpc) * tc::kKeys;

    // 1. s = q kᵀ on the tensor cores; meanwhile the next step's bias is
    //    copied into the other stage and its k (and v) come into
    //    registers.
    tc::issue_qk<kD>(s, sm, stage);
    if (more) {
      tc::copy_bias(bias_h, sm.template bias<TB>(stage ^ 1), q0, kn,
                    cn + chunk, seq, bias_async);
      ks.load(k, in.token, kn, cn + chunk, head_dim);
      if (next_v) vs.load(v, in.token, kn, cn + chunk, head_dim);
    }
    tc::wgmma_wait_all();
    tc::fence_operands(s);
    tc::logits<TB, true>(s, sm.template bias<TB>(stage), f, k0, end,
                         scale);

    if (!second) {
      // 2. the first sweep: the chunk's row max; after its last tile,
      //    m_new = max(m, chunk max), and the running sum and context
      //    rescaled once. Every chunk holds a key, so m_new is finite and
      //    α is 0 on the first chunk.
#pragma unroll
      for (int h = 0; h < 2; ++h) cmax[h] = fmaxf(cmax[h],
                                                  tc::thread_max(s, h));
      if (tile == tpc - 1) {
        float alpha[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float mnew = fmaxf(m[h], tc::quad_max(cmax[h]));
          alpha[h] = expf(m[h] - mnew);
          l[h] *= alpha[h];
          m[h] = mnew;
          cmax[h] = -INFINITY;
        }
        tc::rescale(o, alpha);
      }
    } else {
      // 3. the second sweep: p = exp(logits − m_new), Σp, o += p v on the
      //    tensor cores.
      float psum[2];
      uint32_t p[4][4];
      tc::probabilities(s, m, psum, p);
#pragma unroll
      for (int h = 0; h < 2; ++h) l[h] += psum[h];
      tc::issue_pv<kD>(o, p, sm, stage);
    }
    // meanwhile the next step's tile goes into the other stage, which the
    // previous step's products have left.
    if (more) {
      ks.store(sm.k(stage ^ 1));
      if (next_v) vs.store_transposed(sm.vt(stage ^ 1));
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

template <typename TB>
cudaError_t launch_scalar(const void* q, const void* k, const void* v,
                          Strides in, const void* bias, void* out,
                          Strides os, int batch, int heads, int seq,
                          int head_dim, int chunk, float scale,
                          cudaStream_t stream) {
  return with_nj(head_dim, [&](auto nj) {
    constexpr int NJ = decltype(nj)::value;
    return launch<NJ>(attn_online_kernel<TB, NJ>, batch, seq, heads,
                      head_dim, stream, static_cast<const float*>(q),
                      static_cast<const float*>(k),
                      static_cast<const float*>(v), in,
                      static_cast<const TB*>(bias), static_cast<float*>(out),
                      os, seq, head_dim, chunk, scale);
  });
}

template <typename TB>
cudaError_t launch_tc(const void* q, const void* k, const void* v,
                      Strides in, const void* bias, void* out, Strides os,
                      int batch, int heads, int seq, int head_dim,
                      int chunk, float scale, cudaStream_t stream) {
  const bool async = tc::bias_async(bias, seq, chunk, sizeof(TB));
  return tc::with_depth(head_dim, [&](auto depth) {
    constexpr int kD = decltype(depth)::value;
    return tc::with_vec(
        tc::wide_loads(head_dim, in, {q, k, v}), [&](auto vec) {
          constexpr int kVec = decltype(vec)::value;
          return tc::launch<kD>(
              attn_online_tc_kernel<TB, kD, kVec>, int(sizeof(TB)), batch,
              seq, heads, stream, static_cast<const tc::bf16*>(q),
              static_cast<const tc::bf16*>(k),
              static_cast<const tc::bf16*>(v), in,
              static_cast<const TB*>(bias), static_cast<tc::bf16*>(out), os,
              seq, head_dim, chunk, scale, int(async));
        });
  });
}

}  // namespace

extern "C" {

// q, k, v: (batch, heads, seq, head_dim) with element strides in_window,
// in_head, in_token (alike for the three, hd contiguous); out: the same
// shape with strides out_*; all f32 (qkv_bf16 = 0) or all bf16
// (qkv_bf16 = 1); bias: (heads, seq, seq), f32 or bf16 (bias_bf16), read
// as f32; chunks divides seq; plan: the six ints of long_plan
// (attn_tiles.cuh::Plan), checked against this library's own. Returns the
// cudaError_t of the launch.
int attn_online_forward(const void* q, const void* k, const void* v,
                        const void* bias, void* out, int batch, int heads,
                        int seq, int head_dim, int chunks,
                        long long in_window, long long in_head,
                        long long in_token, long long out_window,
                        long long out_head, long long out_token,
                        int qkv_bf16, int bias_bf16, float scale,
                        const int* plan, void* stream) {
  if (!launchable(batch, seq, heads, head_dim, in_token, out_token) ||
      chunks <= 0 || seq % chunks != 0 ||
      !plan_ok(plan, head_dim, qkv_bf16, bias_bf16 ? 2 : 4))
    return int(cudaErrorInvalidValue);
  const int chunk = seq / chunks;
  const Strides in{in_window, in_head, int(in_token)};
  const Strides os{out_window, out_head, int(out_token)};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (qkv_bf16) {
    return bias_bf16
        ? int(launch_tc<__nv_bfloat16>(q, k, v, in, bias, out, os, batch,
                                       heads, seq, head_dim, chunk, scale,
                                       s))
        : int(launch_tc<float>(q, k, v, in, bias, out, os, batch, heads,
                               seq, head_dim, chunk, scale, s));
  }
  return bias_bf16
      ? int(launch_scalar<__nv_bfloat16>(q, k, v, in, bias, out, os, batch,
                                         heads, seq, head_dim, chunk, scale,
                                         s))
      : int(launch_scalar<float>(q, k, v, in, bias, out, os, batch, heads,
                                 seq, head_dim, chunk, scale, s));
}

}  // extern "C"
