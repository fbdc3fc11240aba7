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
// traffic, ~0.98 ms at the bf16 tensor-core peak. A block that holds one
// window reads all four weight matrices once (1.57 MB at C 256, 6.29 MB at
// C 512), from L2: ~18 GB over those 17 calls, so a design of one window a
// block is held by L2's rate, not by the tensor cores.
//
// Two routes, by the plan of ops/cuda_hat_block.py::plan, which the entry
// point checks against its own formulas and refuses where it cannot run it.
// A block owns whole windows, at most kMaxRows = 64 tokens, so no two
// blocks depend on each other; the windows' residual x32 (rows × C, f32)
// stays in shared memory from the proj product to the store of out. No
// atomics: each output has one owner and a fixed order of sums, so two
// launches give the same bits.
//
// bf16 at widths that are multiples of 32: the tensor-core route
// (hat_block_tc_kernel). Two consumer warpgroups and one producer warp.
//  - The four products are wgmma m64n64k16 a warpgroup, f32 sums in
//    registers: A is the block's 64 rows in bf16 in shared memory (the
//    LayerNorm output, the context, the GELU output) in the core-matrix
//    layout [row / 8][k / 8][row % 8][k % 8] that tc::desc names; B a
//    weight tile of kNt = 128 output columns × kKt = 64 of depth, K-major
//    as nn.Linear holds it (out, in), of which each warpgroup takes 64
//    columns.
//  - One thread of the producer warp streams every weight tile of the
//    sub-block, qkv → proj → (fc1 → fc2) a hidden chunk at a time, through
//    a ring of `stages` 16 KB slots by TMA (cp.async.bulk.tensor, 128B
//    swizzle, the tensor maps made on the host by cuTensorMapEncodeTiled),
//    limited only by free slots: one mbarrier a slot counts its bytes in,
//    another that both warpgroups are done with it. The weights do not
//    depend on the data, so the ring keeps loading while the block runs its
//    LayerNorms, the attention and the epilogues. (16-byte cp.async from
//    the producer warp's 32 lanes could not keep the ring full: the
//    products waited on it.)
//  - The epilogues work on the accumulator fragments: + bias in f32, each
//    thread's 16 bias and γ columns of a tile loaded before any of its
//    stores (there is no room for them in shared memory beside x32 and a
//    3-slot ring at C 512). qkv, rounded to bf16, goes to a per-block slice
//    of a scratch tensor in device memory (rows × 3C does not fit beside
//    x32), which the attention reads back at once, so it mostly stays in
//    L2; proj writes x32 = x + γ3·(sum + b)·dp1.
//  - The MLP runs in hidden chunks of kHc = 128 columns: fc1's tile, GELU'd
//    and rounded to bf16, is written into shared memory as the A operand
//    of fc2's product over that chunk, whose γ4·(sum + b)·dp2 is added into
//    x32 chunk by chunk (the last chunk writes out). h1 never leaves the SM.
//  - The attention runs on K1's tile steps (short_tiles.cuh): one 64 × 64
//    tile a head, q·kᵀ by wgmma with q and k K-major, the softmax on the
//    f32 accumulator in registers, p·v with p from registers and v MN-major.
//    hd is padded with zeros to 64. The two warpgroups take alternate
//    heads, each with two operand stages (the next head's q, k, v come by
//    cp.async while this one computes), in the x32 region, which is free
//    until the proj product. Several carrier windows (S 16) share one
//    64-row tile under a block-diagonal mask, as the TPU kernel packs
//    windows: one tile a head serves them all, where one tile a window
//    would pad each 16 rows to 64. The roundings are K6's: f32 logits,
//    expf, p / Σp correctly rounded (div_rn), then p rounded to bf16
//    (normalised before rounding, unlike K1's route). Each thread reads its
//    fragment of the head's bias once a block, a head ahead.
//
// f32 (and bf16 at other widths): the scalar route (hat_block_kernel). One
// block-wide scalar-FMA loop, a 64 × 64 output tile, 4 × 4 outputs a
// thread, operands staged as f32 through shared memory 32 deep, so that
// fp32 agrees with the plain version up to the order of sums; the
// attention one head at a time on f32 q, k, v in shared memory; the
// context and h1 through the scratch.
//
// Plain C interface, bound with ctypes by fastervit_tpu_torch/ops/
// cuda_hat_block.py, which checks device, dtype, shape and contiguity and
// allocates the output and the scratch.

#include <climits>
#include <cmath>
#include <cstdint>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mutex>

#include "dtype.cuh"
#include "short_tiles.cuh"

namespace {

using fastervit::from_f32;
using fastervit::to_f32;

constexpr int kMaxRows = 64;     // tokens a block holds: _MAX_ROWS in python
constexpr int kMaxSeq = 64;      // MAX_SEQ in ops/cuda_hat_block.py
constexpr int kMaxHeadDim = 64;  // MAX_HEAD_DIM in ops/cuda_hat_block.py
constexpr int kThreads = 256;    // the scalar route's block
constexpr int kWarps = kThreads / 32;
constexpr int kNT = 64;          // output columns of a GEMM tile
constexpr int kKT = 32;          // depth of a GEMM step
constexpr int kTileStride = 65;  // a staged tile's row: 64 + 1 against bank
                                 // conflicts
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
  void* ctx;   // scratch (B·S + 64, C) in T (scalar route)
  void* big;   // scratch: (B·S + 64, max(3C, hidden)) in T, h1 (scalar
               // route); (B·S, 3C) bf16, qkv (tensor-core route)
  const void* bias;   // (H, S, S), f32 or bf16
  const float* dp1;   // (B,), HAS_DP only
  const float* dp2;
  const void* prm[kNumParams];  // matrices in T; vectors f32 or bf16
  CUtensorMap maps[4];  // tensor-core route: qkv_w, proj_w, fc1_w, fc2_w
  int batch, seq, channels, hidden, heads, windows_per_block, stages;
  int vec_bf16, bias_bf16;
  float scale;
};

// A read-only vector's element i as f32 (ld.global.nc: free to be issued
// ahead of the kernel's own stores).
__device__ __forceinline__ float load_vec(const void* p, int i, int bf16) {
  return bf16 ? __bfloat162float(__ldg(static_cast<const __nv_bfloat16*>(p)
                                       + i))
              : __ldg(static_cast<const float*>(p) + i);
}

template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return to_f32(from_f32<T>(v));
}

__device__ __forceinline__ float erf_as(float x) {
  // Abramowitz-Stegun 7.1.26, |error| < 1.5e-7 (pallas_hat_block.py::_erf)
  const float ax = fabsf(x);
  const float t = __frcp_rn(1.f + 0.3275911f * ax);  // = 1 / (...), rounded
  const float poly = t * (0.254829592f + t * (-0.284496736f + t * (
      1.421413741f + t * (-1.453152027f + t * 1.061405429f))));
  const float sign = x > 0.f ? 1.f : (x < 0.f ? -1.f : 0.f);
  return sign * (1.f - poly * expf(-ax * ax));
}

__device__ __forceinline__ float gelu(float x) {
  return 0.5f * x * (1.f + erf_as(x * 0.7071067811865476f));
}

// ---------------------------------------------------------------------------
// The scalar route.

// The row stride of a head's qkv in shared memory: odd, so that a warp
// reading one column of k across its rows hits 32 banks.
__host__ __device__ inline int qkv_stride(int head_dim) {
  return (3 * head_dim) | 1;
}

// The row stride of the scratch's wide part, which holds h1.
__host__ __device__ inline int wide_stride(int channels, int hidden) {
  return max(3 * channels, hidden);
}

// The scalar route's shared memory, in floats: the layout at the top of
// hat_block_kernel
inline size_t smem_floats(int seq, int channels, int heads, int wpb) {
  const size_t rows = size_t(wpb) * seq;
  return rows * channels                  // x32
         + 2 * kMaxRows                   // mean, rstd
         + 2 * size_t(channels)           // a LayerNorm's scale and bias
         + 2 * kKT * kTileStride          // staged A and W tiles
         + rows * qkv_stride(channels / heads)  // one head's qkv
         + rows * seq;                    // the head's logits
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

template <typename T, bool HAS_DP>
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
  const long long row0 = (long long)w0 * seq;
  const int tid = threadIdx.x;

  float* x32 = smem;
  float* mean = x32 + max_rows * channels;       // kMaxRows
  float* rstd = mean + kMaxRows;                 // kMaxRows
  float* lnv = rstd + kMaxRows;                  // 2 × C
  float* As = lnv + 2 * channels;                // kKT × kTileStride
  float* Ws = As + kKT * kTileStride;            // kKT × kTileStride
  float* qkv = Ws + kKT * kTileStride;           // max_rows × ld
  float* logits = qkv + max_rows * ld;           // max_rows × S

  const T* x = static_cast<const T*>(a.x) + row0 * channels;
  T* out = static_cast<T*>(a.out) + row0 * channels;
  T* ctx = static_cast<T*>(a.ctx) + row0 * channels;
  T* big = static_cast<T*>(a.big) + row0 * wide;  // h1
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

  // --- attention branch ----------------------------------------------------
  layer_norm_stats(x32, rows, channels, mean, rstd, lnv, a.prm[kLn1Scale],
                   a.prm[kLn1Bias], vb);
  for (int h = 0; h < a.heads; ++h) {
    // this head's q, k, v: columns part·C + h·hd + d of the qkv product,
    // kept as qkv[m][part·hd + d]
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
  block_gemm<T>(
      rows, channels, channels,
      [&](int m, int k) { return to_f32(ctx[(long long)m * channels + k]); },
      [&](int n) { return proj_w + (long long)n * channels; },
      [&](int m, int n, float acc) {
        float delta = load_vec(a.prm[kGamma3], n, vb)
                      * (acc + load_vec(a.prm[kProjB], n, vb));
        if (HAS_DP) delta *= a.dp1[w0 + m / seq];
        x32[m * channels + n] += delta;
      },
      As, Ws);

  // --- MLP branch -----------------------------------------------------------
  layer_norm_stats(x32, rows, channels, mean, rstd, lnv, a.prm[kLn2Scale],
                   a.prm[kLn2Bias], vb);
  // h1 = GELU(LN2(x32) · fc1_wᵀ + fc1_b), rounded to T, into the scratch
  block_gemm<T>(
      rows, hidden, channels, ln_on_load,
      [&](int n) { return fc1_w + (long long)n * channels; },
      [&](int m, int n, float acc) {
        big[(long long)m * wide + n] =
            from_f32<T>(gelu(acc + load_vec(a.prm[kFc1B], n, vb)));
      },
      As, Ws);
  // x32 += γ4 · (h1 · fc2_wᵀ + fc2_b) · dp2
  block_gemm<T>(
      rows, channels, hidden,
      [&](int m, int k) { return to_f32(big[(long long)m * wide + k]); },
      [&](int n) { return fc2_w + (long long)n * hidden; },
      [&](int m, int n, float acc) {
        float delta = load_vec(a.prm[kGamma4], n, vb)
                      * (acc + load_vec(a.prm[kFc2B], n, vb));
        if (HAS_DP) delta *= a.dp2[w0 + m / seq];
        x32[m * channels + n] += delta;
      },
      As, Ws);

  for (int e = tid; e < rows * channels; e += kThreads)
    out[e] = from_f32<T>(x32[e]);
}

// ---------------------------------------------------------------------------
// The tensor-core route (bf16).
namespace tcr {

namespace st = fastervit::short_tiles;
namespace tc = fastervit::attn_tiles::tc;
using bf16 = __nv_bfloat16;

constexpr int kNt = 128;        // a weight tile's output columns
constexpr int kKt = 64;         // a weight tile's depth
constexpr int kSlotBytes = kNt * kKt * 2;  // one ring slot: 16 KB
constexpr int kMinStages = 3;   // ring slots a plan may have
constexpr int kMaxStages = 8;
constexpr int kWarpgroups = 2;  // consumer warpgroups
constexpr int kConsumers = kWarpgroups * 128;
constexpr int kThreads = kConsumers + 32;  // and the producer warp
constexpr int kHc = 128;        // hidden columns an MLP chunk
constexpr int kAttnStages = 2;  // a warpgroup's q, k, v stages
constexpr int kWidth = 32;      // C and hidden are multiples of this
constexpr int kConsumerBar = 3;  // named barrier of the consumers (0 is
                                 // __syncthreads, 1 + wg a warpgroup's own)
// A wait on a slot longer than this (~5 s) is a fault: trap, not hang.
constexpr long long kHangCycles = 10000000000LL;

// The attention's depth: every hd (<= 64) padded with zeros to 64. (At
// depth 32 the served instance spilled at the 168 registers that 9 warps
// an SM leave a thread; the padding costs only tensor-core work.)
constexpr int kD = 64;

// The x32 region: the block's residual (rows × C, f32), and before the
// proj product the warpgroups' q, k, v stages.
__host__ __device__ inline size_t x_region_bytes(int rows, int channels) {
  const size_t x32 = size_t(rows) * channels * 4;
  const size_t ops = size_t(kWarpgroups) * kAttnStages * 3 * 64 * kD * 2;
  return x32 > ops ? x32 : ops;
}

// The block's dynamic shared memory: the layout at the top of
// hat_block_tc_kernel.
inline size_t smem_bytes(int rows, int channels, int stages) {
  return size_t(stages) * kSlotBytes       // the ring of weight tiles
         + size_t(64) * channels * 2       // A: LN output, then ctx
         + size_t(64) * kHc * 2            // h1, one chunk
         + x_region_bytes(rows, channels)
         + 2 * 64 * 4                      // mean, rstd
         + 2 * size_t(stages) * 8;         // full and empty mbarriers
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  long long t0 = 0;
  for (;;) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
    if (done) return;
    if (t0 == 0) {
      t0 = clock64();
    } else if (clock64() - t0 > kHangCycles) {
      __trap();
    }
  }
}

// bar.sync of the 256 consumer threads alone.
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync %0, %1;\n" ::"n"(kConsumerBar), "n"(kConsumers)
               : "memory");
}

// Element (m, k) of a 64-row bf16 operand of depth `ld` in the core-matrix
// layout [m / 8][k / 8][m % 8][k % 8].
__device__ __forceinline__ int a_index(int m, int k, int ld) {
  return ((m >> 3) * (ld >> 3) + (k >> 3)) * 64 + (m & 7) * 8 + (k & 7);
}

// x32's element (m, n): row-major with n's 8-column chunks permuted by the
// row (XOR of m % 4), so that an accumulator fragment's eight rows of a
// column pair meet no bank twice in a half-warp.
__device__ __forceinline__ int xi(int m, int n, int channels) {
  return m * channels + (n ^ ((m & 3) << 3));
}

// The ring of weight slots. The producer pushes tiles in the order the
// consumers take them; each slot has a `full` barrier (the producer's
// arrival with the slot's byte count, then TMA's bytes) and an `empty`
// one (the 8 consumer warps, after their wgmma has read it). Every thread
// keeps its own cursors.
struct Ring {
  uint16_t* base;
  uint64_t* full;
  uint64_t* empty;
  int stages;
  int slot = 0, phase = 0;    // the producer's next slot to fill, a
                              // consumer's next slot to release
  int wslot = 0, wphase = 0;  // a consumer's next slot to wait for

  __device__ void advance() {
    if (++slot == stages) {
      slot = 0;
      phase ^= 1;
    }
  }

  // Producer (one thread): the box of W's tensor map at rows n0 .. n0 +
  // kNt and columns k0 .. k0 + kKt into the next slot by TMA, rows 128
  // bytes apart with their 16-byte units swizzled (128B); what lies past
  // W's edge arrives as zeros. The slot's full barrier expects its bytes.
  __device__ void push(const CUtensorMap* map, int n0, int k0) {
    mbar_wait(empty + slot, phase ^ 1);
    asm volatile(
        "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
            smem_u32(full + slot)),
        "r"(kSlotBytes)
        : "memory");
    asm volatile(
        "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::"
        "complete_tx::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(
            smem_u32(base + slot * (kSlotBytes / 2))),
        "l"(reinterpret_cast<uint64_t>(map)), "r"(k0), "r"(n0),
        "r"(smem_u32(full + slot))
        : "memory");
    advance();
  }

  // Consumers: the next slot, once it has landed.
  __device__ const uint16_t* wait() {
    mbar_wait(full + wslot, wphase);
    const uint16_t* at = base + wslot * (kSlotBytes / 2);
    if (++wslot == stages) {
      wslot = 0;
      wphase ^= 1;
    }
    return at;
  }
  // Consumers: done with the oldest slot waited for and not yet released
  // (after the wgmma that read it).
  __device__ void release() {
    __syncwarp();
    if ((threadIdx.x & 31) == 0)
      asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
                   ::"r"(smem_u32(empty + slot))
                   : "memory");
    advance();
  }
};

// The wgmma descriptor of a K-major operand in the 128B-swizzled layout TMA
// writes: rows 128 bytes apart, 8-row groups 1024 bytes apart (SBO), the
// k16 step kk 32 bytes on from the row's start.
__device__ __forceinline__ uint64_t desc_sw128(const uint16_t* p) {
  return uint64_t((smem_u32(p) & 0x3FFFF) >> 4) | (uint64_t(1) << 16) |
         (uint64_t(1024 >> 4) << 32) | (uint64_t(1) << 62);
}

__device__ __forceinline__ void wgmma_wait_1() {
  asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
}

// Tiles of a product with N output columns.
__host__ __device__ constexpr int tiles(int N) { return (N + kNt - 1) / kNt; }

// acc (+)= A[:, k0:k0 + 64] · (this warpgroup's 64 rows of the next slot)ᵀ,
// issued and committed as one group: A a 64-row bf16 operand of depth `ld`
// in shared memory in the core-matrix layout; `steps` k16 steps.
__device__ __forceinline__ void slot_product(Ring& ring, const uint16_t* a,
                                             int ld, int k0, int steps,
                                             float (&acc)[32], int wg) {
  const uint16_t* w = ring.wait() + wg * 64 * kKt;  // rows 64wg ..
  tc::fence_operands(acc);
  tc::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kKt / 16; ++kk)
    if (kk < steps)
      tc::wgmma_ss_n64(acc, tc::desc(a + 8 * (k0 + 16 * kk), 128, 16 * ld),
                       desc_sw128(w + 16 * kk), k0 + kk > 0);
  tc::wgmma_commit();
}

// The N tiles n = 0 .. ntiles − 1 of a product A[:, 0:K] · Wᵀ (kNt
// columns each, K a multiple of 32, ceil(K / kKt) ring slots each), both
// warpgroups on every tile, 64 columns each (wgmma m64n64k16, f32 sums),
// each tile handed to epi(acc, n). One slot's group stays in flight while
// the next is issued; each slot is released as soon as its group is done.
template <typename Epi>
__device__ __forceinline__ void product(Ring& ring, const uint16_t* a,
                                        int ld, int K, int ntiles, int wg,
                                        Epi epi) {
  float acc[32];
  for (int n = 0; n < ntiles; ++n) {
    for (int k0 = 0; k0 < K; k0 += kKt) {
      slot_product(ring, a, ld, k0, min(kKt, K - k0) / 16, acc, wg);
      if (k0 > 0) {
        wgmma_wait_1();
        ring.release();
      }
    }
    tc::wgmma_wait_all();
    tc::fence_operands(acc);
    ring.release();
    epi(acc, n);
  }
}

// This thread's 16 columns of the vector p (element off + col) in a tile
// whose warpgroup part starts at col0, all loads issued before any use
// (clamped below n_end; the values past it are never used).
__device__ __forceinline__ void tile_vec(float (&v)[8][2], const void* p,
                                         const st::Frag& f, int col0,
                                         int off, int n_end, int vb) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int col = min(col0 + 8 * j + f.col0, n_end - 2);
    v[j][0] = load_vec(p, off + col, vb);
    v[j][1] = load_vec(p, off + col + 1, vb);
  }
}

// fn(j, col) for each of this thread's column pairs of an m64n64
// accumulator (col, col + 1: entries 4j + 2h + {0, 1} at rows row0 + 8h)
// below n_end; col0 the warpgroup's first column.
template <typename F>
__device__ __forceinline__ void each_col(const st::Frag& f, int col0,
                                         int n_end, F fn) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int col = col0 + 8 * j + f.col0;
    if (col < n_end) fn(j, col);
  }
}

// a / b rounded to nearest, as the division rounds it, for 1 <= b <= 64
// (a softmax row's sum) and y = RN(1 / b): Markstein's correction of a·y
// by the exact remainder a − b·(a·y). Exact wherever nothing underflows:
// a = 0 gives 0, and a nonzero a below 2^-100 takes the division itself.
__device__ __forceinline__ float div_rn(float a, float b, float y) {
  if (fabsf(a) < 0x1p-100f && a != 0.f) return a / b;
  const float q = a * y;
  return fmaf(fmaf(-q, b, a), y, q);
}

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  return tc::pack_bf16(lo, hi);
}

// LayerNorm statistics of x32's rows, one consumer warp a row (the sum in
// x32's own column order).
__device__ void ln_stats(const float* x32, int rows, int channels,
                         float* mean, float* rstd) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int r = warp; r < rows; r += kConsumers / 32) {
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
}

// A = LN(x32) in bf16 (the scalar route's ln_on_load values): consumer
// thread t takes the 16-byte units of 8 columns c8 = t / 8, t / 8 + 32, ...
// at rows ≡ t (mod 8), eight threads a core matrix; it reads its columns'
// scale and bias once.
__device__ void ln_to_a(uint16_t* a_op, const float* x32, int rows,
                        int channels, const float* mean, const float* rstd,
                        const void* scale, const void* bias, int vb) {
  const int m8 = threadIdx.x & 7;
  for (int c8 = threadIdx.x >> 3; c8 < channels / 8; c8 += kConsumers / 8) {
    float sc[8], bi[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      sc[i] = load_vec(scale, 8 * c8 + i, vb);
      bi[i] = load_vec(bias, 8 * c8 + i, vb);
    }
    for (int m = m8; m < rows; m += 8) {
      const float4* xr = reinterpret_cast<const float4*>(
          x32 + m * channels + 8 * (c8 ^ (m & 3)));
      const float4 lo = xr[0], hi = xr[1];
      const float v[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
      uint32_t p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        p[i] = pack2((v[2 * i] - mean[m]) * rstd[m] * sc[2 * i] + bi[2 * i],
                     (v[2 * i + 1] - mean[m]) * rstd[m] * sc[2 * i + 1] +
                         bi[2 * i + 1]);
      *reinterpret_cast<uint4*>(a_op + a_index(m, 8 * c8, channels)) =
          make_uint4(p[0], p[1], p[2], p[3]);
    }
  }
}

// The attention of every head of the block on the tensor cores: warpgroup
// wg takes heads wg, wg + 2, ...; q, k, v from the qkv scratch (rows 3C
// apart) into its two stages `ops` (zeroed: padding rows and columns stay
// zero); ctx rounded to bf16 into a_op's columns h·hd + d.
__device__ void attention(const Args& a, const bf16* qkv, uint16_t* ops,
                          uint16_t* a_op, int rows, int wg) {
  constexpr int kOp = 64 * kD;     // one operand's elements
  constexpr int kStage = 3 * kOp;  // q, k, v
  const int seq = a.seq, channels = a.channels, heads = a.heads;
  const int hd = channels / heads;
  const int t = threadIdx.x & 127;
  const bool wide = hd % 8 == 0;  // 16-byte units: rows 3C apart, C % 32
  const st::Frag f(t);
  uint16_t* mine = ops + wg * kAttnStages * kStage;

  // window and token of this thread's rows and keys (window << 8 | token),
  // -1 past the block's rows
  int rcode[2], kcode[16];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = f.row0 + 8 * hh;
    rcode[hh] = r < rows ? ((r / seq) << 8) | (r % seq) : -1;
  }
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int c = 8 * j + f.col0 + e;
      kcode[2 * j + e] = c < rows ? ((c / seq) << 8) | (c % seq) : -1;
    }
  // fragment entry q = 4j + 2hh + e: its key joins its row's window
  const auto same_window = [&](int j, int hh, int e) {
    return rcode[hh] >= 0 && kcode[2 * j + e] >= 0 &&
           (kcode[2 * j + e] >> 8) == (rcode[hh] >> 8);
  };

  const auto load = [&](int h, uint16_t* dst) {
    const bf16* src = qkv + h * hd;
    st::copy_operand<kD>(dst, src, 3 * channels, rows, hd, wide, t);
    st::copy_operand<kD>(dst + kOp, src + channels, 3 * channels, rows, hd,
                         wide, t);
    st::copy_operand<kD>(dst + 2 * kOp, src + 2 * channels, 3 * channels,
                         rows, hd, wide, t);
    tc::cp_async_commit();
  };

  // the head's bias at this thread's fragment: 32 loads issued at once (in
  // range wherever the entry is masked), a head ahead of its use
  const auto load_bias = [&](int h, float (&bv)[32]) {
    const long long bh = (long long)h * seq * seq;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int at =
              same_window(j, hh, e)
                  ? (rcode[hh] & 255) * seq + (kcode[2 * j + e] & 255)
                  : 0;
          bv[4 * j + 2 * hh + e] =
              a.bias_bf16
                  ? __bfloat162float(
                        __ldg(static_cast<const bf16*>(a.bias) + bh + at))
                  : __ldg(static_cast<const float*>(a.bias) + bh + at);
        }
  };

  float bv[32];
  int h = wg;
  if (h < heads) {
    load(h, mine);
    load_bias(h, bv);
  }
  for (int i = 0; h < heads; ++i, h += kWarpgroups) {
    const uint16_t* cur = mine + (i & 1) * kStage;
    tc::cp_async_wait_all();
    tc::fence_proxy_async();
    st::wg_sync(wg);
    const bool next = h + kWarpgroups < heads;
    if (next) load(h + kWarpgroups, mine + ((i + 1) & 1) * kStage);

    // s = q kᵀ over the tile's 64 rows and 64 keys
    float s[32] = {};
    tc::fence_operands(s);
    tc::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk)
      tc::wgmma_ss_n64(s, st::k_major<kD>(cur, kk),
                       st::k_major<kD>(cur + kOp, kk), kk > 0);
    tc::wgmma_commit();
    tc::wgmma_wait_all();
    tc::fence_operands(s);

    // logits s·scale + bias, the row max, p = exp(l − max), Σp, p / Σp
    // rounded to bf16 pairs: the A fragments of p·v
    uint32_t p[4][4];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int q = 4 * j + 2 * hh + e;
          s[q] = same_window(j, hh, e) ? s[q] * a.scale + bv[q]
                 : rcode[hh] < 0       ? 0.f
                                       : -INFINITY;
          mx = fmaxf(mx, s[q]);
        }
      mx = tc::quad_max(mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int q = 4 * j + 2 * hh + e;
          s[q] = expf(s[q] - mx);
          sum += s[q];
        }
      sum = tc::quad_sum(sum);
      const float inv = __frcp_rn(sum);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int q = 4 * j + 2 * hh + e;
          s[q] = div_rn(s[q], sum, inv);
        }
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int i2 = 0; i2 < 4; ++i2)
        p[kk][i2] = pack2(s[8 * kk + 2 * i2], s[8 * kk + 2 * i2 + 1]);

    // o = p · v, v MN-major (the transpose bit)
    float o[kD / 2];
#pragma unroll
    for (int q = 0; q < kD / 2; ++q) o[q] = 0.f;
    tc::fence_operands(o);
    tc::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      st::rs_t(o, p[kk], st::mn_major<kD>(cur + 2 * kOp, kk), 1);
    tc::wgmma_commit();
    tc::wgmma_wait_all();
    tc::fence_operands(o);

    // ctx = o as bf16 into A's columns h·hd + d, rows below the block's
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = f.row0 + 8 * hh;
      if (row >= rows) continue;
#pragma unroll
      for (int j = 0; j < kD / 8; ++j) {
        const int d = 8 * j + f.col0;
        const float v0 = o[4 * j + 2 * hh], v1 = o[4 * j + 2 * hh + 1];
        if (hd % 2 == 0) {
          if (d < hd)
            *reinterpret_cast<uint32_t*>(
                a_op + a_index(row, h * hd + d, channels)) = pack2(v0, v1);
        } else {
          const __nv_bfloat16 b0 = __float2bfloat16(v0);
          const __nv_bfloat16 b1 = __float2bfloat16(v1);
          if (d < hd)
            a_op[a_index(row, h * hd + d, channels)] =
                *reinterpret_cast<const uint16_t*>(&b0);
          if (d + 1 < hd)
            a_op[a_index(row, h * hd + d + 1, channels)] =
                *reinterpret_cast<const uint16_t*>(&b1);
        }
      }
    }
    if (next) load_bias(h + kWarpgroups, bv);
  }
}

}  // namespace tcr

template <bool HAS_DP>
__global__ void __launch_bounds__(tcr::kThreads, 1)
hat_block_tc_kernel(const __grid_constant__ Args a) {
  using namespace tcr;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const int seq = a.seq, channels = a.channels, hidden = a.hidden;
  const int stages = a.stages;
  const int w0 = blockIdx.x * a.windows_per_block;
  const int rows = min(a.windows_per_block, a.batch - w0) * seq;
  const int max_rows = a.windows_per_block * seq;
  const long long row0 = (long long)w0 * seq;

  // the layout of smem_bytes
  uint16_t* ring_base = reinterpret_cast<uint16_t*>(smem_raw);
  uint16_t* a_op = ring_base + stages * (kSlotBytes / 2);
  uint16_t* h1 = a_op + 64 * channels;
  float* x32 = reinterpret_cast<float*>(h1 + 64 * kHc);
  uint16_t* ops = reinterpret_cast<uint16_t*>(x32);  // until proj
  float* mean = reinterpret_cast<float*>(
      reinterpret_cast<unsigned char*>(x32) +
      x_region_bytes(max_rows, channels));
  float* rstd = mean + 64;
  uint64_t* full = reinterpret_cast<uint64_t*>(rstd + 64);
  uint64_t* empty = full + stages;

  if (threadIdx.x == 0) {
    for (int i = 0; i < stages; ++i) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                       smem_u32(full + i)),
                   "r"(1)
                   : "memory");
      asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                       smem_u32(empty + i)),
                   "r"(kConsumers / 32)
                   : "memory");
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  Ring ring{ring_base, full, empty, stages};

  if (threadIdx.x >= kConsumers) {
    // the producer warp: one thread streams every weight tile of the
    // sub-block, in the order of the consumers' products below
    if (threadIdx.x != kConsumers) return;
    const CUtensorMap* qkv_w = &a.maps[0];
    const CUtensorMap* proj_w = &a.maps[1];
    const CUtensorMap* fc1_w = &a.maps[2];
    const CUtensorMap* fc2_w = &a.maps[3];
    for (int n0 = 0; n0 < 3 * channels; n0 += kNt)
      for (int k0 = 0; k0 < channels; k0 += kKt) ring.push(qkv_w, n0, k0);
    for (int n0 = 0; n0 < channels; n0 += kNt)
      for (int k0 = 0; k0 < channels; k0 += kKt) ring.push(proj_w, n0, k0);
    for (int j0 = 0; j0 < hidden; j0 += kHc) {
      const int jn = min(kHc, hidden - j0);
      for (int k0 = 0; k0 < channels; k0 += kKt) ring.push(fc1_w, j0, k0);
      for (int n0 = 0; n0 < channels; n0 += kNt)
        for (int k0 = 0; k0 < jn; k0 += kKt) ring.push(fc2_w, n0, j0 + k0);
    }
    return;
  }
  const int t = threadIdx.x, wg = t >> 7;
  const st::Frag f(t & 127);
  const int vb = a.vec_bf16;

  const bf16* x = static_cast<const bf16*>(a.x) + row0 * channels;
  bf16* out = static_cast<bf16*>(a.out) + row0 * channels;
  bf16* qkv = static_cast<bf16*>(a.big) + row0 * 3 * channels;
  float dp1[2] = {1.f, 1.f}, dp2[2] = {1.f, 1.f};
  if (HAS_DP) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = f.row0 + 8 * h;
      if (row < rows) {
        dp1[h] = a.dp1[w0 + row / seq];
        dp2[h] = a.dp2[w0 + row / seq];
      }
    }
  }

  // 1. x → x32 (f32); LN1 → A
  for (int e = t; e < rows * channels / 8; e += kConsumers) {
    const int m = e / (channels / 8), c8 = e - m * (channels / 8);
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(
        x + (long long)m * channels + 8 * c8));
    const __nv_bfloat162* b = reinterpret_cast<const __nv_bfloat162*>(&v);
    float4* dst = reinterpret_cast<float4*>(
        x32 + m * channels + 8 * (c8 ^ (m & 3)));
    const float2 f0 = __bfloat1622float2(b[0]), f1 = __bfloat1622float2(b[1]);
    const float2 f2 = __bfloat1622float2(b[2]), f3 = __bfloat1622float2(b[3]);
    dst[0] = make_float4(f0.x, f0.y, f1.x, f1.y);
    dst[1] = make_float4(f2.x, f2.y, f3.x, f3.y);
  }
  consumer_sync();
  ln_stats(x32, rows, channels, mean, rstd);
  consumer_sync();
  ln_to_a(a_op, x32, rows, channels, mean, rstd, a.prm[kLn1Scale],
          a.prm[kLn1Bias], vb);
  tc::fence_proxy_async();
  consumer_sync();

  // 2. qkv = LN1 · qkv_wᵀ + qkv_b, rounded, into the scratch
  product(ring, a_op, channels, channels, tiles(3 * channels), wg,
          [&](float (&acc)[32], int n) {
    const int c0 = n * kNt + 64 * wg;
    float b[8][2];
    tile_vec(b, a.prm[kQkvB], f, c0, 0, 3 * channels, vb);
    each_col(f, c0, 3 * channels, [&](int j, int col) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = f.row0 + 8 * h;
        if (row < rows)
          *reinterpret_cast<uint32_t*>(qkv + (long long)row * 3 * channels +
                                       col) =
              pack2(acc[4 * j + 2 * h] + b[j][0],
                    acc[4 * j + 2 * h + 1] + b[j][1]);
      }
    });
  });
  consumer_sync();  // qkv is whole; A and the x32 region are free

  // 3. the attention, every head, ctx into A
  {
    const int n = kWarpgroups * kAttnStages * 3 * 64 * kD / 8;
    uint4* z = reinterpret_cast<uint4*>(ops);
    for (int i = t; i < n; i += kConsumers) z[i] = make_uint4(0, 0, 0, 0);
  }
  consumer_sync();
  attention(a, qkv, ops, a_op, rows, wg);
  tc::fence_proxy_async();
  consumer_sync();

  // 4. x32 = x + γ3 · (ctx · proj_wᵀ + proj_b) · dp1
  product(ring, a_op, channels, channels, tiles(channels), wg,
          [&](float (&acc)[32], int n) {
    const int c0 = n * kNt + 64 * wg;
    float b[8][2], g[8][2];
    tile_vec(b, a.prm[kProjB], f, c0, 0, channels, vb);
    tile_vec(g, a.prm[kGamma3], f, c0, 0, channels, vb);
    __nv_bfloat162 xv[8][2];  // x at this thread's pairs
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = min(f.row0 + 8 * h, rows - 1);
        const int col = min(c0 + 8 * j + f.col0, channels - 2);
        xv[j][h] = __ldg(reinterpret_cast<const __nv_bfloat162*>(
            x + (long long)row * channels + col));
      }
    each_col(f, c0, channels, [&](int j, int col) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = f.row0 + 8 * h;
        if (row >= rows) continue;
        const float2 xf = __bfloat1622float2(xv[j][h]);
        float d0 = g[j][0] * (acc[4 * j + 2 * h] + b[j][0]);
        float d1 = g[j][1] * (acc[4 * j + 2 * h + 1] + b[j][1]);
        if (HAS_DP) {
          d0 *= dp1[h];
          d1 *= dp1[h];
        }
        float* xr = x32 + xi(row, col, channels);
        xr[0] = xf.x + d0;
        xr[1] = xf.y + d1;
      }
    });
  });
  consumer_sync();  // x32 is whole; ctx is read

  // 5. LN2 → A
  ln_stats(x32, rows, channels, mean, rstd);
  consumer_sync();
  ln_to_a(a_op, x32, rows, channels, mean, rstd, a.prm[kLn2Scale],
          a.prm[kLn2Bias], vb);
  tc::fence_proxy_async();
  consumer_sync();

  // 6. the MLP, a hidden chunk at a time: h1 = GELU(LN2 · fc1_wᵀ + fc1_b)
  //    in bf16 into shared memory, then x32 += γ4 · (h1 · fc2_wᵀ + fc2_b) ·
  //    dp2 over the chunk (fc2_b with the first); the last chunk writes out
  for (int j0 = 0; j0 < hidden; j0 += kHc) {
    const int jn = min(kHc, hidden - j0);
    const bool last = j0 + kHc >= hidden;
    product(ring, a_op, channels, channels, 1, wg,
            [&](float (&acc)[32], int) {
      float b[8][2];
      tile_vec(b, a.prm[kFc1B], f, 64 * wg, j0, jn, vb);
      consumer_sync();  // the previous chunk's fc2 has read h1
      each_col(f, 64 * wg, jn, [&](int j, int col) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = f.row0 + 8 * h;
          if (row < rows)
            *reinterpret_cast<uint32_t*>(h1 + a_index(row, col, kHc)) =
                pack2(gelu(acc[4 * j + 2 * h] + b[j][0]),
                      gelu(acc[4 * j + 2 * h + 1] + b[j][1]));
        }
      });
    });
    tc::fence_proxy_async();
    consumer_sync();
    product(ring, h1, kHc, jn, tiles(channels), wg,
            [&](float (&acc)[32], int n) {
      const int c0 = n * kNt + 64 * wg;
      float b[8][2], g[8][2];
      tile_vec(g, a.prm[kGamma4], f, c0, 0, channels, vb);
      if (j0 == 0) {
        tile_vec(b, a.prm[kFc2B], f, c0, 0, channels, vb);
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j) b[j][0] = b[j][1] = 0.f;
      }
      each_col(f, c0, channels, [&](int j, int col) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = f.row0 + 8 * h;
          if (row >= rows) continue;
          float d0 = g[j][0] * (acc[4 * j + 2 * h] + b[j][0]);
          float d1 = g[j][1] * (acc[4 * j + 2 * h + 1] + b[j][1]);
          if (HAS_DP) {
            d0 *= dp2[h];
            d1 *= dp2[h];
          }
          float* xr = x32 + xi(row, col, channels);
          if (last) {
            *reinterpret_cast<__nv_bfloat162*>(
                out + (long long)row * channels + col) =
                __floats2bfloat162_rn(xr[0] + d0, xr[1] + d1);
          } else {
            xr[0] += d0;
            xr[1] += d1;
          }
        }
      });
    });
  }
}

template <typename T, bool HAS_DP>
cudaError_t launch(const Args& a, size_t smem, unsigned blocks,
                   cudaStream_t stream) {
  auto kernel = hat_block_kernel<T, HAS_DP>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  kernel<<<blocks, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <bool HAS_DP>
cudaError_t launch_tc(const Args& a, size_t smem, unsigned blocks,
                      cudaStream_t stream) {
  auto kernel = hat_block_tc_kernel<HAS_DP>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  kernel<<<blocks, tcr::kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// cuTensorMapEncodeTiled, from the driver through the runtime (the build
// links no libcuda); null where the driver has none.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  static std::once_flag once;
  std::call_once(once, [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  });
  return fn;
}

// The TMA map of a (rows, cols) row-major bf16 matrix in boxes of kNt rows
// × kKt columns (128 bytes, the 128B swizzle's span); false if the driver
// refuses it.
bool weight_map(CUtensorMap* map, const void* w, int rows, int cols) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {cuuint64_t(cols), cuuint64_t(rows)};
  const cuuint64_t strides[1] = {cuuint64_t(cols) * 2};
  const cuuint32_t box[2] = {tcr::kKt, tcr::kNt};
  const cuuint32_t steps[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                const_cast<void*>(w), dims, strides, box, steps,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The dynamic shared memory of a plan: route 1 (tensor cores, `stages`
// ring slots) or 0 (scalar), wpb windows of seq tokens a block.
long long plan_smem(int seq, int channels, int heads, int wpb, int route,
                    int stages) {
  if (route == 1)
    return (long long)tcr::smem_bytes(wpb * seq, channels, stages);
  return (long long)(smem_floats(seq, channels, heads, wpb) * sizeof(float));
}

}  // namespace

extern "C" {

// ptrs: x (batch, seq, channels) and out, both f32 (x_bf16 = 0) or bf16;
// the scratch, in x's type: ctx ((batch·seq + 64), channels) and a wide
// part ((batch·seq + 64), max(3·channels, hidden)) for h1 on the scalar
// route; on the tensor-core route ctx unused and the wide part
// (batch·seq, 3·channels) for qkv; bias (heads, seq, seq), f32 or bf16
// (bias_bf16); dp1 and dp2, (batch,) f32 (read only when has_dp); then the
// 14 params in PARAM_ORDER of ops/hat_block.py: the matrices qkv_w (3C,
// C), proj_w (C, C), fc1_w (hidden, C), fc2_w (C, hidden) in x's type, the
// vectors all f32 (vec_bf16 = 0) or all bf16. plan: the five ints of
// ops/cuda_hat_block.py::plan (route: 1 tensor cores, 0 scalar; windows a
// block; ring stages; consumer warpgroups; dynamic shared memory in
// bytes), checked here, not chosen: a plan this library cannot run is
// refused. Returns the cudaError_t of the launch.
int hat_block_forward(const void* const* ptrs, int batch, int seq,
                      int channels, int hidden, int heads, const int* plan,
                      int x_bf16, int vec_bf16, int bias_bf16, int has_dp,
                      float scale, void* stream) {
  if (!plan || batch <= 0 || seq <= 0 || seq > kMaxSeq || heads <= 0 ||
      channels <= 0 || channels % heads != 0 ||
      channels / heads > kMaxHeadDim || hidden <= 0)
    return int(cudaErrorInvalidValue);
  const int route = plan[0], wpb = plan[1], stages = plan[2];
  const int warpgroups = plan[3], smem = plan[4];
  if (wpb <= 0 || wpb * seq > kMaxRows) return int(cudaErrorInvalidValue);
  if (route == 1) {
    // the tensor-core route: bf16, widths that are multiples of kWidth,
    // every 16-byte unit aligned, a ring of kMinStages..kMaxStages slots
    const int operands[] = {0, 1, 3, 7 + kQkvW, 7 + kProjW, 7 + kFc1W,
                            7 + kFc2W};
    if (!x_bf16 || channels % tcr::kWidth != 0 ||
        hidden % tcr::kWidth != 0 || stages < tcr::kMinStages ||
        stages > tcr::kMaxStages || warpgroups != tcr::kWarpgroups)
      return int(cudaErrorInvalidValue);
    for (int i : operands)
      if (!aligned16(ptrs[i])) return int(cudaErrorInvalidValue);
  } else if (route != 0 || stages != 0 || warpgroups != 0) {
    return int(cudaErrorInvalidValue);
  }
  const long long want = plan_smem(seq, channels, heads, wpb, route, stages);
  const long long blocks = (batch + wpb - 1) / wpb;
  if (smem != want || want > kSmemLimit || blocks > INT_MAX ||
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
  a.stages = stages;
  a.vec_bf16 = vec_bf16;
  a.bias_bf16 = bias_bf16;
  a.scale = scale;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned nb = unsigned(blocks);
  const size_t bytes = size_t(smem);
  if (route == 1) {
    const int shapes[4][3] = {{kQkvW, 3 * channels, channels},
                              {kProjW, channels, channels},
                              {kFc1W, hidden, channels},
                              {kFc2W, channels, hidden}};
    for (int i = 0; i < 4; ++i)
      if (!weight_map(&a.maps[i], ptrs[7 + shapes[i][0]], shapes[i][1],
                      shapes[i][2]))
        return int(cudaErrorInvalidValue);
    return has_dp ? int(launch_tc<true>(a, bytes, nb, s))
                  : int(launch_tc<false>(a, bytes, nb, s));
  }
  if (!x_bf16)
    return has_dp ? int(launch<float, true>(a, bytes, nb, s))
                  : int(launch<float, false>(a, bytes, nb, s));
  return has_dp ? int(launch<__nv_bfloat16, true>(a, bytes, nb, s))
                : int(launch<__nv_bfloat16, false>(a, bytes, nb, s));
}

// The dynamic shared memory, in bytes, of a block that holds wpb windows of
// seq tokens on route 1 (tensor cores, a ring of `stages` slots) or 0
// (scalar): what ops/cuda_hat_block.py::_smem computes, for the plan and
// the tests to hold it to.
long long hat_block_smem_bytes(int seq, int channels, int heads, int wpb,
                               int route, int stages) {
  return plan_smem(seq, channels, heads, wpb, route, stages);
}

}  // extern "C"
