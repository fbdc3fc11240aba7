// Multi-scale deformable attention (MSDA) backward, for Hopper (sm_90a): K7.
//
// It replaces no TPU kernel: the JAX package's MSDA backward is XLA,
// fastervit_tpu/ops/msda.py::_msda_core_bwd (:184-237), whose value
// gradient is two one-hot matmuls a level because the TPU has no fast
// scatter. K7 computes that function as upstream's ms_deform_attn_cuda
// backward does, a col2im: given g = dL/dout (N, Q, M·D), for each batch
// entry n, query q, head m and sample s = (level l, point p) with weight a,
// bilinear corner weights cw_c and corner rows v_c of level l's map,
//
//   dweights[n,q,m,l,p] = ⟨Σ_c cw_c·v_c, g⟩                 (interp · g)
//   dloc[n,q,m,l,p,0]   = a·W·⟨(1−fy)(v01−v00) + fy(v11−v10), g⟩
//   dloc[n,q,m,l,p,1]   = a·H·⟨(1−fx)(v10−v00) + fx(v11−v01), g⟩
//   dvalue[n, corner c, m, :] += cw_c·a·g
//
// with the forward's sampling rule (msda.py::_level_geometry, as in
// msda_fwd.cu): x = loc_x·W − 0.5, y = loc_y·H − 0.5; a corner outside the
// map is a zero row and receives nothing; a sample whose top-left corner
// lies outside [−1, W−1] × [−1, H−1] has zero gradients and writes nothing
// into dvalue. Corners are read from the unpadded map with bounds checks.
//
// Layout: K5's. One launch covers every level; it reads `value` (N, S, M, D)
// as the model holds it, with the levels' (H, W, start) in a small int32
// table on the device. A group of G lanes owns one (n, q, m) row, V
// channels a vector load (csrc/vec.cuh), rows in (n, m, q) order; the plan
// (G, V, channels a lane, rows a warp, warps) is cuda_msda.py::
// msda_bwd_plan's, which is msda_plan's for the narrower of value's and
// grad_out's alignment, and is checked here.
//
// Types: value, weights, grad_out and dweights f32 or bf16; the locations
// and dloc f32 (the wrapper casts dloc to the locations' dtype); dvalue
// summed in an f32 buffer (N, S, M, D) that the wrapper zeroes and, for
// bf16, rounds to bf16 once. All arithmetic is f32.
//
// - dweights and dloc: each lane sums its channels' share of ⟨interp, g⟩
//   and of the two location terms, then the group adds its lanes' shares
//   with width-G xor shuffles in a fixed order; the lane that owns the
//   sample writes it. No atomics: two launches give the same bits.
// - dvalue: each in-range corner of a valid sample adds cw·a·g into the f32
//   buffer with atomics, V channels at a time: red.global.add.v4.f32
//   (CUDA 12's atomicAdd(float4*), sm_90) for four channels, .v2 for two,
//   scalar for one. The order of the additions changes from run to run, so
//   dvalue is reproducible to the order bound c·2⁻²⁴·Σ|terms| (c the most
//   contributions an element has), not bit for bit.
//
// Bound on this card, at DINO-4scale's encoder call (N 2, Q = S = 22,223,
// M 8, D 32, L 4, P 4, bf16 beside f32 locations): bytes. The function
// reads value, grad_out (22.8 MB each), loc (45.5 MB) and weights
// (11.4 MB) and writes dvalue (22.8 MB), dloc (45.5 MB) and dweights
// (11.4 MB): 182 MB, 0.054 ms at 3.35 TB/s. Its 5.7 M samples need at
// least 16 f32 operations a channel (four corner dots ⟨v_c, g⟩, of which
// dweights and both location terms are per-sample combinations, and four
// corner multiply-adds into dvalue) and ~40 a sample: 3.1 GFLOP, 0.047 ms
// at 67 TFLOP/s. The f32 buffer adds its zeroing, the atomics' traffic and
// the cast.
// Each sample's 4 corners are read as 64 B rows and added back as 128 B of
// f32 atomics; this first version takes ~2 ms at that call (PERF.md), ~10×
// K5's forward, which reads the same rows, so the atomics are the likely
// pace-setter (not split: no profiler of the card's units here). Making
// dvalue's order fixed and the walk faster is later work.

#include <climits>
#include <cmath>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "dtype.cuh"
#include "vec.cuh"

namespace {

using fastervit::from_f32;
using fastervit::to_f32;
using fastervit::Vec;

constexpr int kMaxChannels = 64;   // MAX_CHANNELS in cuda_msda.py
constexpr int kMaxWarps = 8;       // warps a block, at most
// two blocks of kMaxWarps an SM: at most 128 registers a thread, so that the
// served instances keep g, the corner rows and the group sums without spills
constexpr int kMinBlocks = 2;
constexpr int kSmemLevels = 64;    // levels whose (H, W, start) a block keeps
constexpr unsigned kFull = 0xffffffffu;

// The launch plan, in the order of cuda_msda.py::MsdaPlan.as_c.
struct Plan {
  int lanes, vec, channels, rows_per_warp, warps;
};

// Sample s of a row: its four corners' token offsets (−1 where the corner,
// or the whole sample, adds nothing), bilinear weights (without the
// attention weight), the fractions fx, fy (0 for an invalid sample) and the
// level's W and H.
struct Sample {
  int off[4];
  float cw[4];
  float fx, fy, w, h;
};

__device__ __forceinline__ Sample geometry(bool has, float2 xy, int l,
                                           const int4* s_levels,
                                           const int* __restrict__ levels) {
  Sample s;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    s.off[c] = -1;
    s.cw[c] = 0.f;
  }
  s.fx = s.fy = s.w = s.h = 0.f;
  if (!has) return s;
  int h, w, start;
  if (l < kSmemLevels) {
    const int4 t = s_levels[l];
    h = t.x, w = t.y, start = t.z;
  } else {
    h = __ldg(levels + 3 * l), w = __ldg(levels + 3 * l + 1);
    start = __ldg(levels + 3 * l + 2);
  }
  s.w = float(w), s.h = float(h);
  const float x = __fsub_rn(__fmul_rn(xy.x, float(w)), 0.5f);
  const float y = __fsub_rn(__fmul_rn(xy.y, float(h)), 0.5f);
  const float x0 = floorf(x), y0 = floorf(y);
  if (x0 >= -1.f && x0 <= float(w - 1) && y0 >= -1.f && y0 <= float(h - 1)) {
    s.fx = __fsub_rn(x, x0), s.fy = __fsub_rn(y, y0);
    const int xi = int(x0), yi = int(y0);
    const float wy[2] = {__fsub_rn(1.f, s.fy), s.fy};
    const float wx[2] = {__fsub_rn(1.f, s.fx), s.fx};
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int yy = yi + (c >> 1), xx = xi + (c & 1);
      s.cw[c] = __fmul_rn(wy[c >> 1], wx[c & 1]);
      if (yy >= 0 && yy < h && xx >= 0 && xx < w)
        s.off[c] = start + yy * w + xx;
    }
  }
  return s;
}

// x[0..V) added into the f32 buffer at p (p aligned to V floats, V <= 8)
template <int V>
__device__ __forceinline__ void add_f32(float* p, const float* x) {
  if constexpr (V % 4 == 0) {
#pragma unroll
    for (int k = 0; k < V / 4; ++k)
      atomicAdd(reinterpret_cast<float4*>(p) + k,
                make_float4(x[4 * k], x[4 * k + 1], x[4 * k + 2],
                            x[4 * k + 3]));
  } else if constexpr (V == 2) {
    atomicAdd(reinterpret_cast<float2*>(p), make_float2(x[0], x[1]));
  } else {
    atomicAdd(p, x[0]);
  }
}

// levels: (num_levels, 3) int32 rows of (H, W, first token). T: value,
// weights, grad_out and dweights. G lanes a row, NV vectors of V channels
// a lane.
template <typename T, int V, int G, int NV>
__global__ void __launch_bounds__(32 * kMaxWarps, kMinBlocks)
msda_bwd_kernel(const T* __restrict__ value, const int* __restrict__ levels,
                const float2* __restrict__ loc, const T* __restrict__ weights,
                const T* __restrict__ grad_out, float* __restrict__ dvalue,
                float2* __restrict__ dloc, T* __restrict__ dweights,
                long long rows, int queries, int seq, int heads,
                int channels, int num_levels, int points) {
  constexpr int kPerLane = NV * V;

  __shared__ int4 s_levels[kSmemLevels];
  for (int l = threadIdx.x; l < min(num_levels, kSmemLevels);
       l += blockDim.x)
    s_levels[l] = make_int4(levels[3 * l], levels[3 * l + 1],
                            levels[3 * l + 2], 0);
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int j = lane % G;  // the lane's place in its row's group
  const long long r =
      ((long long)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5)) *
          (32 / G) + lane / G;
  // a group past the last row keeps walking with the warp (its shuffles
  // need every lane) but reads and writes nothing
  const bool live = r < rows;
  // r runs over (n, m, q); row over (n, q, m), the layout of loc and g
  const long long q = r % queries;
  const int m = int(r / queries % heads);
  const long long n = r / queries / heads;
  const long long row = (n * queries + q) * heads + m;
  const int samples = num_levels * points;
  const float2* loc_r = loc + row * samples;
  const T* w_r = weights + row * samples;
  const long long token_stride = (long long)heads * channels;
  const long long nm = n * seq * token_stride + (long long)m * channels;
  const T* v_nm = value + nm;
  float* dv_nm = dvalue + nm;
  const int c0 = j * kPerLane;  // the lane's first channel
  bool has[NV];
#pragma unroll
  for (int t = 0; t < NV; ++t) has[t] = live && c0 + t * V < channels;

  // the lane's channels of g, f32
  float g[kPerLane];
#pragma unroll
  for (int t = 0; t < NV; ++t) {
    Vec<T, V> gv{};
    if (has[t]) gv.load(grad_out + row * channels + c0 + t * V);
#pragma unroll
    for (int e = 0; e < V; ++e) g[t * V + e] = has[t] ? gv.get(e) : 0.f;
  }

  for (int first = 0; first < samples; first += G) {
    // 1. lane j: the geometry and weight of sample first + j
    const int s = first + j;
    const bool mine = live && s < samples;
    const float2 xy = mine ? __ldg(loc_r + s) : make_float2(0.f, 0.f);
    const float a = mine ? to_f32(w_r[s]) : 0.f;
    const Sample smp = geometry(mine, xy, s / points, s_levels, levels);
    float my_w = 0.f, my_x = 0.f, my_y = 0.f;
    // 2. the group: each sample of the batch in order, every lane its
    //    channels
    const int count = min(G, samples - first);
#pragma unroll 1
    for (int i = 0; i < G; ++i) {
      if (i >= count) break;  // warp-uniform
      int o[4];
      float cw[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        o[c] = __shfl_sync(kFull, smp.off[c], i, G);
        cw[c] = __shfl_sync(kFull, smp.cw[c], i, G);
      }
      const float fx = __shfl_sync(kFull, smp.fx, i, G);
      const float fy = __shfl_sync(kFull, smp.fy, i, G);
      const float ai = __shfl_sync(kFull, a, i, G);
      Vec<T, V> v[4][NV];
#pragma unroll
      for (int c = 0; c < 4; ++c)
#pragma unroll
        for (int t = 0; t < NV; ++t) {
          v[c][t] = Vec<T, V>{};
          if (o[c] >= 0 && has[t])
            v[c][t].load(v_nm + (long long)o[c] * token_stride + c0 + t * V);
        }
      // this lane's share of ⟨interp, g⟩ and of the location terms
      float pw = 0.f, px = 0.f, py = 0.f;
      const float ofx = __fsub_rn(1.f, fx), ofy = __fsub_rn(1.f, fy);
#pragma unroll
      for (int t = 0; t < NV; ++t)
#pragma unroll
        for (int e = 0; e < V; ++e) {
          const float v00 = v[0][t].get(e), v01 = v[1][t].get(e);
          const float v10 = v[2][t].get(e), v11 = v[3][t].get(e);
          const float ge = g[t * V + e];
          float interp = cw[0] * v00;
          interp = fmaf(cw[1], v01, interp);
          interp = fmaf(cw[2], v10, interp);
          interp = fmaf(cw[3], v11, interp);
          pw = fmaf(ge, interp, pw);
          px = fmaf(ge, fmaf(ofy, v01 - v00, fy * (v11 - v10)), px);
          py = fmaf(ge, fmaf(ofx, v10 - v00, fx * (v11 - v01)), py);
        }
      // the group's sums, in a fixed order
#pragma unroll
      for (int k = G / 2; k > 0; k >>= 1) {
        pw += __shfl_xor_sync(kFull, pw, k, G);
        px += __shfl_xor_sync(kFull, px, k, G);
        py += __shfl_xor_sync(kFull, py, k, G);
      }
      if (j == i) my_w = pw, my_x = px, my_y = py;
      // dvalue: each in-range corner's cw·a·g
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        if (o[c] < 0) continue;
        const float k = __fmul_rn(cw[c], ai);
#pragma unroll
        for (int t = 0; t < NV; ++t) {
          if (!has[t]) continue;
          float x[V];
#pragma unroll
          for (int e = 0; e < V; ++e) x[e] = __fmul_rn(k, g[t * V + e]);
          add_f32<V>(dv_nm + (long long)o[c] * token_stride + c0 + t * V, x);
        }
      }
    }
    // 3. lane j writes sample first + j
    if (mine) {
      dweights[row * samples + s] = from_f32<T>(my_w);
      dloc[row * samples + s] = make_float2(__fmul_rn(my_x, a * smp.w),
                                            __fmul_rn(my_y, a * smp.h));
    }
  }
}

template <typename T, int V, int G, int NV>
cudaError_t launch(const void* value, const void* levels, const void* loc,
                   const void* weights, const void* grad_out, void* dvalue,
                   void* dloc, void* dweights, long long rows,
                   long long blocks, int warps, int queries, int seq,
                   int heads, int channels, int num_levels, int points,
                   cudaStream_t stream) {
  msda_bwd_kernel<T, V, G, NV><<<unsigned(blocks), 32 * warps, 0, stream>>>(
      static_cast<const T*>(value), static_cast<const int*>(levels),
      static_cast<const float2*>(loc), static_cast<const T*>(weights),
      static_cast<const T*>(grad_out), static_cast<float*>(dvalue),
      static_cast<float2*>(dloc), static_cast<T*>(dweights), rows, queries,
      seq, heads, channels, num_levels, points);
  return cudaGetLastError();
}

// The arguments every instance takes, so that the dispatch below passes
// one struct.
struct Args {
  const void *value, *levels, *loc, *weights, *grad_out;
  void *dvalue, *dloc, *dweights;
  long long rows, blocks;
  int queries, seq, heads, channels, num_levels, points;
  cudaStream_t stream;
};

// The instance of a plan: K5's (cuda_msda.py::msda_plan): G in {4, 8, 16,
// 32} with G·V at most D's 64; NV 2 only at G 32 and V 1.
template <typename T, int V, int G, int NV>
cudaError_t launch_if(const Plan& p, const Args& a) {
  if constexpr (G * V <= kMaxChannels && (NV == 1 || (G == 32 && V == 1))) {
    if (p.lanes == G && p.channels == NV * V)
      return launch<T, V, G, NV>(a.value, a.levels, a.loc, a.weights,
                                 a.grad_out, a.dvalue, a.dloc, a.dweights,
                                 a.rows, a.blocks, p.warps, a.queries, a.seq,
                                 a.heads, a.channels, a.num_levels, a.points,
                                 a.stream);
  }
  return cudaErrorInvalidValue;
}

template <typename T, int V>
cudaError_t launch_lanes(const Plan& p, const Args& a) {
  cudaError_t (*const instances[])(const Plan&, const Args&) = {
      launch_if<T, V, 4, 1>, launch_if<T, V, 8, 1>, launch_if<T, V, 16, 1>,
      launch_if<T, V, 32, 1>, launch_if<T, V, 32, 2>};
  for (auto run : instances) {
    const cudaError_t err = run(p, a);
    if (err != cudaErrorInvalidValue) return err;
  }
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t launch_plan(const Plan& p, const Args& a) {
  switch (p.vec) {
#define FASTERVIT_MSDA_BWD_VEC(V)                  \
  case V:                                          \
    if constexpr (V * sizeof(T) <= 16)             \
      return launch_lanes<T, V>(p, a);             \
    break;
    FASTERVIT_MSDA_BWD_VEC(1)
    FASTERVIT_MSDA_BWD_VEC(2)
    FASTERVIT_MSDA_BWD_VEC(4)
    FASTERVIT_MSDA_BWD_VEC(8)
#undef FASTERVIT_MSDA_BWD_VEC
  }
  return cudaErrorInvalidValue;
}

bool aligned(const void* p, int bytes) {
  return reinterpret_cast<std::uintptr_t>(p) % unsigned(bytes) == 0;
}

}  // namespace

extern "C" {

// value: (batch, seq, heads, channels); levels: (num_levels, 3) int32 rows
// of (H, W, first token) on the device, Σ H·W = seq; loc: (batch, queries,
// heads, num_levels, points, 2) f32, 8-byte aligned; weights: (batch,
// queries, heads, num_levels, points); grad_out: (batch, queries,
// heads·channels); dvalue: f32 (batch, seq, heads, channels), zeroed by the
// caller, 16-byte aligned; dloc: f32 like loc; dweights: like weights.
// value, weights, grad_out and dweights f32 (bf16 = 0) or bf16 (bf16 = 1).
// plan: the five ints of cuda_msda.py::MsdaPlan.as_c, refused unless an
// instance of this file runs it on these pointers. Returns the cudaError_t
// of the launch.
int msda_backward(const void* value, const void* levels, const void* loc,
                  const void* weights, const void* grad_out, void* dvalue,
                  void* dloc, void* dweights, int batch, int queries,
                  int seq, int heads, int channels, int num_levels,
                  int points, int bf16, const int* plan, void* stream) {
  const Plan p{plan[0], plan[1], plan[2], plan[3], plan[4]};
  const int elem = bf16 ? 2 : 4;
  const long long rows = (long long)batch * queries * heads;
  if (batch <= 0 || queries <= 0 || seq <= 0 || heads <= 0 ||
      channels <= 0 || channels > kMaxChannels || num_levels <= 0 ||
      points <= 0 || (long long)num_levels * points > INT_MAX / 2)
    return int(cudaErrorInvalidValue);
  // the plan: whole vectors of at most 16 bytes that D and the pointers
  // allow (value and grad_out read as V elements, dvalue added to as V
  // floats), groups that cover D, whole warps
  if (p.vec < 1 || p.vec * elem > 16 || channels % p.vec ||
      p.channels % p.vec ||
      (long long)p.lanes * p.channels < channels ||
      p.lanes * p.rows_per_warp != 32 || p.warps < 1 ||
      p.warps > kMaxWarps || !aligned(value, p.vec * elem) ||
      !aligned(grad_out, p.vec * elem) || !aligned(dvalue, 16) ||
      !aligned(loc, 8) || !aligned(dloc, 8))
    return int(cudaErrorInvalidValue);
  const long long per_block = (long long)p.rows_per_warp * p.warps;
  const long long blocks = (rows + per_block - 1) / per_block;
  if (blocks > INT_MAX) return int(cudaErrorInvalidValue);
  const Args a{value, levels, loc, weights, grad_out, dvalue, dloc, dweights,
               rows, blocks, queries, seq, heads, channels, num_levels,
               points, static_cast<cudaStream_t>(stream)};
  if (!bf16) return int(launch_plan<float>(p, a));
  return int(launch_plan<__nv_bfloat16>(p, a));
}

}  // extern "C"
