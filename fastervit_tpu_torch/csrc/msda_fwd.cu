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
// plus bf16 offsets, fastervit_tpu/ops/msda.py:496-508): the location type
// is a template parameter of its own, instantiated as f32 only (the binding
// widens bf16 locations, which is exact). Geometry, corner weights and sums
// are f32 (a bf16
// map widened to f32 is exact, so this is the TPU kernel's f32 upcast,
// msda_pallas.py:169-178); the output is in value's type.
//
// Design: one warp per (n, q, m), one lane per channel (two for D > 32;
// D ≤ 64). The L·P samples of a warp are taken 32 at a time: lane j
// computes sample j's four corner offsets and weights (attention weight
// folded in, out-of-bounds corners marked), then the warp walks the
// samples in order, each lane broadcasting them with __shfl_sync, and
// every lane adds its channel of the four corners in registers. The sum
// order is fixed (level, then point, then corner) and there are no
// atomics, so two launches give the same bits.
//
// Bound on this card: bytes. At the served encoder shape (N 2, Q = S =
// 22,223, M 8, D 32, L 4, P 4, bf16 beside f32 locations) a call must read
// value (22.8 MB), loc (45.5 MB) and weights (11.4 MB) and write 22.8 MB:
// about 103 MB, 0.031 ms
// at 3.35 TB/s; its 5.7 M samples need about 1.5 GFLOP of f32 arithmetic,
// about 0.02 ms at 67 TFLOP/s. But the corner reads are 5.7 M × 4 × 64 B =
// 1.46 GB of gathered traffic, mostly L2 hits (a level-0 map of one head is
// 1.1 MB), and each warp's loads of one sample wait on its geometry: this
// simple kernel sits far from the byte bound, and staging a level tile in
// shared memory or packing queries per warp is later work.
//
// Plain C interface, bound with ctypes by fastervit_tpu_torch/ops/
// cuda_msda.py, which checks device, dtype, shape and contiguity.

#include <climits>
#include <cmath>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "dtype.cuh"

namespace {

using fastervit::from_f32;
using fastervit::to_f32;

constexpr int kMaxChannels = 64;   // MAX_CHANNELS in cuda_msda.py
constexpr int kWarps = 8;          // warps (rows) per block
constexpr int kThreads = 32 * kWarps;
constexpr unsigned kFull = 0xffffffffu;

// levels: (num_levels, 3) int32 rows of (H, W, first token). T: value,
// weights and out; TL: loc.
template <typename T, typename TL>
__global__ void __launch_bounds__(kThreads)
msda_fwd_kernel(const T* __restrict__ value, const int* __restrict__ levels,
                const TL* __restrict__ loc, const T* __restrict__ weights,
                T* __restrict__ out, long long rows, int queries, int seq,
                int heads, int channels, int num_levels, int points) {
  const long long row = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;  // whole warps leave together
  const int lane = threadIdx.x & 31;
  const int m = int(row % heads);
  const long long n = row / heads / queries;
  const int samples = num_levels * points;
  const TL* loc_r = loc + row * samples * 2;
  const T* w_r = weights + row * samples;
  const long long token_stride = (long long)heads * channels;
  const T* v_nm = value + n * seq * token_stride + (long long)m * channels;
  const int d0 = lane, d1 = lane + 32;
  const bool has0 = d0 < channels, has1 = d1 < channels;
  float acc0 = 0.f, acc1 = 0.f;

  for (int first = 0; first < samples; first += 32) {
    // 1. lane j: geometry of sample first + j
    int off[4] = {-1, -1, -1, -1};
    float cw[4] = {0.f, 0.f, 0.f, 0.f};
    const int s = first + lane;
    if (s < samples) {
      const int l = s / points;
      const int h = __ldg(levels + 3 * l), w = __ldg(levels + 3 * l + 1);
      const int start = __ldg(levels + 3 * l + 2);
      const float x = __fsub_rn(__fmul_rn(to_f32(loc_r[2 * s]), float(w)),
                                0.5f);
      const float y = __fsub_rn(__fmul_rn(to_f32(loc_r[2 * s + 1]),
                                          float(h)), 0.5f);
      const float x0 = floorf(x), y0 = floorf(y);
      if (x0 >= -1.f && x0 <= float(w - 1) && y0 >= -1.f &&
          y0 <= float(h - 1)) {
        const float fx = __fsub_rn(x, x0), fy = __fsub_rn(y, y0);
        const float a = to_f32(w_r[s]);
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
    // 2. the warp: each sample in order, every lane its channels
    const int count = min(32, samples - first);
#pragma unroll 4
    for (int j = 0; j < count; ++j) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int o = __shfl_sync(kFull, off[c], j);
        const float wc = __shfl_sync(kFull, cw[c], j);
        if (o >= 0) {  // warp-uniform
          const T* v = v_nm + (long long)o * token_stride;
          if (has0) acc0 = fmaf(wc, to_f32(v[d0]), acc0);
          if (has1) acc1 = fmaf(wc, to_f32(v[d1]), acc1);
        }
      }
    }
  }
  T* o_r = out + row * channels;
  if (has0) o_r[d0] = from_f32<T>(acc0);
  if (has1) o_r[d1] = from_f32<T>(acc1);
}

template <typename T, typename TL>
cudaError_t launch(const void* value, const void* levels, const void* loc,
                   const void* weights, void* out, long long rows,
                   int queries, int seq, int heads, int channels,
                   int num_levels, int points, cudaStream_t stream) {
  const long long blocks = (rows + kWarps - 1) / kWarps;
  msda_fwd_kernel<T, TL><<<unsigned(blocks), kThreads, 0, stream>>>(
      static_cast<const T*>(value), static_cast<const int*>(levels),
      static_cast<const TL*>(loc), static_cast<const T*>(weights),
      static_cast<T*>(out), rows, queries, seq, heads, channels, num_levels,
      points);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// value: (batch, seq, heads, channels); levels: (num_levels, 3) int32 rows
// of (H, W, first token) on the device, Σ H·W = seq; loc: (batch, queries,
// heads, num_levels, points, 2); weights: (batch, queries, heads,
// num_levels, points); out: (batch, queries, heads·channels). value,
// weights and out f32 (bf16 = 0) or bf16 (bf16 = 1); loc f32. Returns the
// cudaError_t of the launch.
int msda_forward(const void* value, const void* levels, const void* loc,
                 const void* weights, void* out, int batch, int queries,
                 int seq, int heads, int channels, int num_levels,
                 int points, int bf16, void* stream) {
  const long long rows = (long long)batch * queries * heads;
  if (batch <= 0 || queries <= 0 || seq <= 0 || heads <= 0 ||
      channels <= 0 || channels > kMaxChannels || num_levels <= 0 ||
      points <= 0 || (rows + kWarps - 1) / kWarps > INT_MAX)
    return int(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!bf16)
    return int(launch<float, float>(value, levels, loc, weights, out, rows,
                                    queries, seq, heads, channels,
                                    num_levels, points, s));
  return int(launch<__nv_bfloat16, float>(value, levels, loc, weights, out,
                                          rows, queries, seq, heads,
                                          channels, num_levels, points, s));
}

}  // extern "C"
