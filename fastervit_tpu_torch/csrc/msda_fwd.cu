// Multi-scale deformable attention (MSDA) forward, for Hopper (sm_90a).
//
// Replaces fastervit_tpu/ops/msda_pallas.py::fused_bilinear_gather (its
// Pallas kernel _p_kernel and _sample_loop), which msda_forward_pallas runs
// once per level. For each batch entry n, query q and head m:
//
//   out[n, q, m*D + d] = Σ_l Σ_p w[n,q,m,l,p] ·
//                        bilinear(level l of value[n, :, m, :], loc[n,q,m,l,p])[d]
//
// with the sampling rule of fastervit_tpu/ops/msda.py::_level_geometry
// (grid_sample, align_corners=False, zero padding): x = loc_x·W − 0.5 and
// y = loc_y·H − 0.5 (two roundings, as the JAX package computes them); a
// corner outside the map adds 0; a sample whose top-left corner (x0, y0)
// lies outside [−1, W−1] × [−1, H−1] adds exactly 0. Corners are read from
// the unpadded map with bounds checks, so no location, however far out,
// makes the kernel read outside `value`.
//
// One launch covers every level. The TPU kernel needed a zero-padded f32
// copy of each level's map in VMEM, one pallas_call per level, and an XLA
// gather for maps over 6 MB; here the kernel reads `value` (N, S, M, D) as
// the model holds it, with the levels' (H, W, start) in a small int32 table
// on the device, as upstream's ms_deformable_im2col_gpu_kernel does.
//
// Types: value and weights f32 or bf16; the locations f32 always, which is
// what the JAX package's bf16 detector hands its MSDA (f32 reference points
// plus bf16 offsets, fastervit_tpu/ops/msda.py:496-508; the binding widens
// bf16 locations, which is exact). Geometry, corner weights and sums are
// f32 (a bf16 map widened to f32 is exact, so this is the TPU kernel's f32
// upcast, msda_pallas.py:169-178); the output is in value's type.
//
// Bound on this card: bytes. At the served encoder shape (N 2, Q = S =
// 22,223, M 8, D 32, L 4, P 4, bf16 beside f32 locations) a call must read
// value (22.8 MB), loc (45.5 MB) and weights (11.4 MB) and write 22.8 MB:
// about 103 MB, 0.031 ms at 3.35 TB/s; its 5.7 M samples need about 1.5
// GFLOP of f32 arithmetic, about 0.02 ms at 67 TFLOP/s. What sets its pace
// is the gathered corner traffic, 5.7 M × 4 corners × 64 B = 1.46 GB a call
// from L2 and L1 (a head's level-0 map is 1.1 MB), and the latency of those
// loads: the more of them an SM keeps in flight, the faster. Locations that
// sit near each query's own token, as the model's do, come out only ~3%
// faster than uniform ones (PERF.md).
//
// Design, for that memory system (the launch plan is made in Python,
// cuda_msda.py::msda_plan, and checked here):
// - A group of G lanes owns one (n, q, m) row, so a warp holds 32/G rows.
//   Each lane holds NV vectors of V contiguous channels and reads a corner
//   row's share with one 2- to 16-byte load a vector: at D 32, G = 4 and V =
//   8 in bf16 (G = 8, V = 4 in f32), so one warp load instruction fetches
//   one corner for eight rows (four in f32). A D that the widest vector
//   does not divide, or a `value` that is not aligned to it, takes a
//   narrower V, down to 1.
// - Rows are taken in (n, m, q) order, so a warp and a block read one
//   head's map for a run of neighbouring queries, whose corners L1 then
//   serves (loads by ld.global.nc); (n, q, m) order, a query's heads side
//   by side, was ~3% slower at the served encoder call (PERF.md).
// - Geometry on every lane: a row's samples are taken G at a time, lane j
//   of the group computing sample first + j from its float2 location and
//   the level's (H, W, start), which a block reads once into shared memory.
//   The next batch's locations and weights are loaded before the current
//   batch's corners are walked. Each sample's four corner offsets and
//   weights reach the group through width-G shuffles, each of which serves
//   every row of the warp.
// - The walk takes the batch's samples one (16-byte vectors) to four (4
//   bytes and less) at a time: their corners are loaded together (16 to 64
//   bytes a lane in flight), then added in order. At most 64 registers a
//   thread keep four blocks, 32 warps, on an SM.
// - Each lane sums its own channels in f32 in the fixed order level, point,
//   corner (x = loc·W − 0.5 in two roundings, cw = (wy·wx)·a by __fmul_rn,
//   fmaf into the sum), and an out-of-range corner or sample adds nothing
//   at all. There are no atomics and no cross-lane sums, so every plan
//   gives the same bits, and so do two launches.
//
// Plain C interface, bound with ctypes by fastervit_tpu_torch/ops/
// cuda_msda.py, which checks device, dtype, shape and contiguity and makes
// the plan.

#include <climits>
#include <cmath>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "dtype.cuh"
#include "vec.cuh"

namespace {

using fastervit::to_f32;
using fastervit::Vec;

constexpr int kMaxChannels = 64;   // MAX_CHANNELS in cuda_msda.py
constexpr int kMaxWarps = 8;       // warps a block, at most
// blocks of kMaxWarps an SM: at most 64 registers a thread, so that 32 warps
// an SM keep their corner loads in flight (the served encoder call, bf16,
// PERF.md: 0.190 ms; 0.199 at 3 blocks and 80 registers; 0.243 unbounded,
// 88 registers and 16 warps)
constexpr int kMinBlocks = 4;
constexpr int kSmemLevels = 64;    // levels whose (H, W, start) a block keeps
constexpr unsigned kFull = 0xffffffffu;

// The launch plan, in the order of cuda_msda.py::MsdaPlan.as_c: lanes a row
// (G), channels a vector (V), channels a lane (NV·V), rows a warp (32/G) and
// warps a block.
struct Plan {
  int lanes, vec, channels, rows_per_warp, warps;
};

// Sample s of a row: its four corners' token offsets (−1 where the corner,
// or the whole sample, adds nothing) and weights.
__device__ __forceinline__ void geometry(bool has, float2 xy, float a, int l,
                                         const int4* s_levels,
                                         const int* __restrict__ levels,
                                         int off[4], float cw[4]) {
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    off[c] = -1;
    cw[c] = 0.f;
  }
  if (!has) return;
  int h, w, start;
  if (l < kSmemLevels) {
    const int4 t = s_levels[l];
    h = t.x, w = t.y, start = t.z;
  } else {
    h = __ldg(levels + 3 * l), w = __ldg(levels + 3 * l + 1);
    start = __ldg(levels + 3 * l + 2);
  }
  const float x = __fsub_rn(__fmul_rn(xy.x, float(w)), 0.5f);
  const float y = __fsub_rn(__fmul_rn(xy.y, float(h)), 0.5f);
  const float x0 = floorf(x), y0 = floorf(y);
  if (x0 >= -1.f && x0 <= float(w - 1) && y0 >= -1.f && y0 <= float(h - 1)) {
    const float fx = __fsub_rn(x, x0), fy = __fsub_rn(y, y0);
    const int xi = int(x0), yi = int(y0);
    const float wy[2] = {__fsub_rn(1.f, fy), fy};
    const float wx[2] = {__fsub_rn(1.f, fx), fx};
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int yy = yi + (c >> 1), xx = xi + (c & 1);
      if (yy >= 0 && yy < h && xx >= 0 && xx < w) {
        off[c] = start + yy * w + xx;
        cw[c] = __fmul_rn(__fmul_rn(wy[c >> 1], wx[c & 1]), a);
      }
    }
  }
}

// levels: (num_levels, 3) int32 rows of (H, W, first token). T: value,
// weights and out. G lanes a row, NV vectors of V channels a lane.
template <typename T, int V, int G, int NV>
__global__ void __launch_bounds__(32 * kMaxWarps, kMinBlocks)
msda_fwd_kernel(const T* __restrict__ value, const int* __restrict__ levels,
                const float2* __restrict__ loc, const T* __restrict__ weights,
                T* __restrict__ out, long long rows, int queries, int seq,
                int heads, int channels, int num_levels, int points) {
  // samples walked together: their corner loads, 16 to 64 bytes a lane,
  // are in flight at once (one sample of 16-byte vectors, which fits 64
  // registers; two at 80 registers were slower, with fewer warps an SM)
  constexpr int kWords = (V * int(sizeof(T)) + 3) / 4;
  constexpr int kChunk = NV * kWords >= 4 ? 1 : 4 / (NV * kWords);
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
  // r runs over (n, m, q); row over (n, q, m), the layout of loc and out
  const long long q = r % queries;
  const int m = int(r / queries % heads);
  const long long n = r / queries / heads;
  const long long row = (n * queries + q) * heads + m;
  const int samples = num_levels * points;
  const float2* loc_r = loc + row * samples;
  const T* w_r = weights + row * samples;
  const long long token_stride = (long long)heads * channels;
  const T* v_nm = value + n * seq * token_stride + (long long)m * channels;
  const int c0 = j * kPerLane;  // the lane's first channel
  bool has[NV];
#pragma unroll
  for (int t = 0; t < NV; ++t) has[t] = live && c0 + t * V < channels;

  float acc[kPerLane];
#pragma unroll
  for (int e = 0; e < kPerLane; ++e) acc[e] = 0.f;

  // this lane's sample of the first batch
  float2 xy = make_float2(0.f, 0.f);
  float a = 0.f;
  if (live && j < samples) {
    xy = __ldg(loc_r + j);
    a = to_f32(w_r[j]);
  }
  for (int first = 0; first < samples; first += G) {
    // 1. lane j: the geometry of sample first + j, then the next batch's
    //    location and weight
    const int s = first + j;
    int off[4];
    float cw[4];
    geometry(live && s < samples, xy, a, s / points, s_levels, levels, off,
             cw);
    if (live && s + G < samples) {
      xy = __ldg(loc_r + s + G);
      a = to_f32(w_r[s + G]);
    }
    // 2. the group: each sample of the batch in order, kChunk at a time,
    //    every lane its channels (samples past the row's last have no
    //    corners)
    const int count = min(G, samples - first);
#pragma unroll
    for (int i0 = 0; i0 < G; i0 += kChunk) {
      if (i0 >= count) break;  // warp-uniform
      // the corners' offsets, then their loads; each weight is fetched
      // only when its corner is added, so that it holds no register while
      // the loads are in flight
      int o[kChunk][4];
#pragma unroll
      for (int u = 0; u < kChunk; ++u)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          o[u][c] = __shfl_sync(kFull, off[c], i0 + u, G);
      Vec<T, V> v[kChunk][4][NV];
#pragma unroll
      for (int u = 0; u < kChunk; ++u)
#pragma unroll
        for (int c = 0; c < 4; ++c)
#pragma unroll
          for (int t = 0; t < NV; ++t)
            if (o[u][c] >= 0 && has[t])
              v[u][c][t].load(v_nm + (long long)o[u][c] * token_stride + c0 +
                              t * V);
#pragma unroll
      for (int u = 0; u < kChunk; ++u)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const float wc = __shfl_sync(kFull, cw[c], i0 + u, G);
#pragma unroll
          for (int t = 0; t < NV; ++t)
            if (o[u][c] >= 0 && has[t])
#pragma unroll
              for (int e = 0; e < V; ++e)
                acc[t * V + e] = fmaf(wc, v[u][c][t].get(e), acc[t * V + e]);
        }
    }
  }
  T* o_r = out + row * channels + c0;
#pragma unroll
  for (int t = 0; t < NV; ++t) {
    if (!has[t]) continue;
    Vec<T, V> y{};
#pragma unroll
    for (int e = 0; e < V; ++e) y.set(e, acc[t * V + e]);
    y.store(o_r + t * V);
  }
}

template <typename T, int V, int G, int NV>
cudaError_t launch(const void* value, const void* levels, const void* loc,
                   const void* weights, void* out, long long rows,
                   long long blocks, int warps, int queries, int seq,
                   int heads, int channels, int num_levels, int points,
                   cudaStream_t stream) {
  msda_fwd_kernel<T, V, G, NV><<<unsigned(blocks), 32 * warps, 0, stream>>>(
      static_cast<const T*>(value), static_cast<const int*>(levels),
      static_cast<const float2*>(loc), static_cast<const T*>(weights),
      static_cast<T*>(out), rows, queries, seq, heads, channels, num_levels,
      points);
  return cudaGetLastError();
}

// The instance of a plan: G in {4, 8, 16, 32} with G·V at most D's 64
// (cuda_msda.py::msda_plan never takes more lanes than D's vectors need,
// nor fewer than 4); NV 2 only at G 32 and V 1 (D > 32 on scalar loads).
template <typename T, int V, int G, int NV>
cudaError_t launch_if(const Plan& p, const void* value, const void* levels,
                      const void* loc, const void* weights, void* out,
                      long long rows, long long blocks, int queries, int seq,
                      int heads, int channels, int num_levels, int points,
                      cudaStream_t s) {
  if constexpr (G * V <= kMaxChannels && (NV == 1 || (G == 32 && V == 1))) {
    if (p.lanes == G && p.channels == NV * V)
      return launch<T, V, G, NV>(value, levels, loc, weights, out, rows,
                                 blocks, p.warps, queries, seq, heads,
                                 channels, num_levels, points, s);
  }
  return cudaErrorInvalidValue;
}

template <typename T, int V>
cudaError_t launch_lanes(const Plan& p, const void* value, const void* levels,
                         const void* loc, const void* weights, void* out,
                         long long rows, long long blocks, int queries,
                         int seq, int heads, int channels, int num_levels,
                         int points, cudaStream_t s) {
  cudaError_t (*const instances[])(const Plan&, const void*, const void*,
                                   const void*, const void*, void*,
                                   long long, long long, int, int, int, int,
                                   int, int, cudaStream_t) = {
      launch_if<T, V, 4, 1>, launch_if<T, V, 8, 1>, launch_if<T, V, 16, 1>,
      launch_if<T, V, 32, 1>, launch_if<T, V, 32, 2>};
  for (auto run : instances) {
    const cudaError_t err = run(p, value, levels, loc, weights, out, rows,
                                blocks, queries, seq, heads, channels,
                                num_levels, points, s);
    if (err != cudaErrorInvalidValue) return err;
  }
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t launch_plan(const Plan& p, const void* value, const void* levels,
                        const void* loc, const void* weights, void* out,
                        long long rows, long long blocks, int queries,
                        int seq, int heads, int channels, int num_levels,
                        int points, cudaStream_t s) {
  switch (p.vec) {
#define FASTERVIT_MSDA_VEC(V)                                              \
  case V:                                                                  \
    if constexpr (V * sizeof(T) <= 16)                                     \
      return launch_lanes<T, V>(p, value, levels, loc, weights, out, rows, \
                                blocks, queries, seq, heads, channels,     \
                                num_levels, points, s);                    \
    break;
    FASTERVIT_MSDA_VEC(1)
    FASTERVIT_MSDA_VEC(2)
    FASTERVIT_MSDA_VEC(4)
    FASTERVIT_MSDA_VEC(8)
#undef FASTERVIT_MSDA_VEC
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
// heads, num_levels, points, 2), 8-byte aligned; weights: (batch, queries,
// heads, num_levels, points); out: (batch, queries, heads·channels). value,
// weights and out f32 (bf16 = 0) or bf16 (bf16 = 1); loc f32. plan: the five
// ints of cuda_msda.py::MsdaPlan.as_c, refused unless an instance of this
// file runs it on these pointers. Returns the cudaError_t of the launch.
int msda_forward(const void* value, const void* levels, const void* loc,
                 const void* weights, void* out, int batch, int queries,
                 int seq, int heads, int channels, int num_levels,
                 int points, int bf16, const int* plan, void* stream) {
  const Plan p{plan[0], plan[1], plan[2], plan[3], plan[4]};
  const int elem = bf16 ? 2 : 4;
  const long long rows = (long long)batch * queries * heads;
  if (batch <= 0 || queries <= 0 || seq <= 0 || heads <= 0 ||
      channels <= 0 || channels > kMaxChannels || num_levels <= 0 ||
      points <= 0 || (long long)num_levels * points > INT_MAX / 2)
    return int(cudaErrorInvalidValue);
  // the plan: whole vectors of at most 16 bytes that D and both pointers
  // allow, groups that cover D, whole warps
  if (p.vec < 1 || p.vec * elem > 16 || channels % p.vec ||
      p.channels % p.vec ||
      (long long)p.lanes * p.channels < channels ||
      p.lanes * p.rows_per_warp != 32 || p.warps < 1 ||
      p.warps > kMaxWarps ||
      !aligned(value, p.vec * elem) || !aligned(out, p.vec * elem) ||
      !aligned(loc, 8))
    return int(cudaErrorInvalidValue);
  const long long per_block = (long long)p.rows_per_warp * p.warps;
  const long long blocks = (rows + per_block - 1) / per_block;
  if (blocks > INT_MAX) return int(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!bf16)
    return int(launch_plan<float>(p, value, levels, loc, weights, out, rows,
                                  blocks, queries, seq, heads, channels,
                                  num_levels, points, s));
  return int(launch_plan<__nv_bfloat16>(p, value, levels, loc, weights, out,
                                        rows, blocks, queries, seq, heads,
                                        channels, num_levels, points, s));
}

}  // extern "C"
