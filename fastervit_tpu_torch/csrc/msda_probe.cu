// The MSDA gather probes' kernels, for Hopper (sm_90a).
//
// Replaces seven Pallas kernels of the JAX package's probes at MOTR's
// streaming geometry:
//   P3a scripts/msda_pallas_probe.py::fused_gather (_fused_kernel),
//   P3b msda_pallas_probe.py::fused_gather_p4 (_p4_kernel),
//   P3c msda_pallas_probe.py::fused_gather_per_head (_fused_kernel_ph),
//   P4a scripts/msda_packed_probe.py::packed_gather (_packed_kernel),
//   P4b scripts/msda_packed_probe2.py::pair_staticr (_pair_staticr_kernel),
//   P4c msda_packed_probe2.py::packed_coeff (_packed_coeff_kernel),
//   P4d msda_packed_probe2.py::packed_wide (_packed_wide_kernel).
//
// Pair mode, P3 and P4b: a head's zero-padded level map vm (M, Hp, Wp, D),
// f32 (P3, P4b) or bf16 (P4b, widened to f32 exactly), and per sample i the
// precomputed (iy, ix, fy, fx, w):
//
//   top = vm[iy, ix]·(1−fx) + vm[iy, ix+1]·fx
//   bot = vm[iy+1, ix]·(1−fx) + vm[iy+1, ix+1]·fx
//   v_i = w·(top·(1−fy) + bot·fy)
//
// and out[q] = v_{qP} + v_{qP+1} + … + v_{qP+P−1}, summed in that order
// (_p4_kernel :124-140, _pair_staticr_kernel :61-65); P = 1 is P3a (one
// output row a sample). P3c is P3a launched once per head by the binding
// (ops/cuda_msda.py). P4b computes P3b's function; its static row index
// removes an integer div/mod of the TPU's scalar unit, which a lane here
// never pays, so on this card P4b is P3b's kernel over an f32 or bf16 map.
//
// Packed mode, P4a: the corner-packed map pm (M, (Hp−1)(Wp−1), 4D) of
// pack_corners, f32 or bf16, whose row fl = iy·(Wp−1) + ix holds the four
// corners [vm[iy,ix] | vm[iy,ix+1] | vm[iy+1,ix] | vm[iy+1,ix+1]], and
//
//   v_i = row[0:D]·c00 + row[D:2D]·c01 + row[2D:3D]·c10 + row[3D:4D]·c11
//
// with the corner weights c00 = (w·gy)·gx, c01 = (w·gy)·fx, c10 = (w·fy)·gx,
// c11 = (w·fy)·fx (gy = 1−fy, gx = 1−fx) formed in the kernel, summed over
// P as above (_packed_kernel :46-66).
//
// Coeff mode, P4c: the same sum with c00 … c11 read from four (M, QP) f32
// streams that the caller made (_packed_coeff_kernel :102-124).
//
// Wide mode, P4d: pm and fl as above and a coefficient row cf (M, QP, 4D)
// f32 a sample; out (M, QP/P, 4D) f32 keeps the four corner groups,
//
//   out[q, k] = Σ_p pm[fl_s, k]·cf[s, k],  s = qP + p, k < 4D,
//
// summed in order (_packed_wide_kernel :157-179); the caller adds the four
// groups. cf is read as it is, never as a broadcast of four scalars.
//
// A bf16 map is widened to f32 (exact); the arithmetic and the output are
// f32. Every product and sum is rounded on its own, in the JAX kernels'
// order (__fmul_rn / __fadd_rn, which nvcc never contracts into an FMA), so
// a launch repeats the plain version's roundings (ops/msda_probes.py).
//
// Out of range. A pair-mode sample with iy outside [0, Hp−2] or ix outside
// [0, Wp−2], or a packed, coeff or wide sample with fl outside
// [0, (Hp−1)(Wp−1)), gives NaN (on all 4D lanes in wide mode, and so does
// its query's sum); the kernel reads nothing for it, so no index makes it
// read outside the map. The JAX probes define nothing there.
//
// Design: the TPU kept a head's whole map resident in VMEM and walked
// chunks of samples. Hopper has no such memory (a block's shared memory is
// 227 KB; only level 3's map, 172.8 KB of f32 a head, would fit), so the
// corners are read through the read-only path from L2, where a head's map
// (10 MB f32 at level 0; 39.6 MB corner-packed) stays: blocks are ordered
// head-major (blockIdx.y is the head), the card's analog of the TPU's
// constant map block index. One warp owns a run of 32 output rows (32·P
// samples). In pair, packed and coeff mode a lane owns a channel (two for
// D > 32; D ≤ 64): lane j loads sample j's scalars with coalesced loads and
// works out its offset and coefficients, then the warp walks the samples in
// order, each lane taking them with __shfl_sync and adding its channel of
// the four corners in registers. A pair sample reads two 2·D-wide runs in
// two map rows; a packed or coeff sample one contiguous 4·D-wide row. In
// wide mode only the offset is shuffled: a lane owns the output lanes
// k = lane + 32·t (up to 8, 4D ≤ 256) and streams each sample's cf row
// beside its map row, both in coalesced 128-byte runs; cf, read once, is
// loaded with the evict-first hint so that it does not push the map out of
// L2. Each output row has one owner and there are no atomics, so two
// launches give the same bits.
//
// Bound on this card: bytes, each input read once and the output written
// once, at 3.35 TB/s. At M 8, QP 408,000, D 32, level 0 (202×386): P3a
// moves 562.9 MB (0.168 ms), 417.8 MB of it the output; P3b and P4b on an
// f32 map 249.6 MB (0.0745 ms); P4a 473.6 MB (0.141 ms), its packed map
// 317 MB; P4c 486.7 MB (0.145 ms); P4d 2,419 MB (0.722 ms), 1,671 MB of it
// cf and 418 MB the output. The gathered corner traffic is 1.67 GB a call
// and comes from L2, not device memory, wherever a head's map fits.
// Staging level tiles in shared memory, several queries a warp and vector
// loads are later work.
//
// Plain C interface, bound with ctypes by fastervit_tpu_torch/ops/
// cuda_msda.py, which checks device, dtype, shape and contiguity, and that
// every tensor holds fewer than 2^31 elements (all offsets here are 32-bit).

#include <climits>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "dtype.cuh"

namespace {

using fastervit::to_f32;

constexpr int kMaxChannels = 64;  // PROBE_MAX_CHANNELS in cuda_msda.py
constexpr int kWarps = 8;         // warps a block
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 32;         // output rows a warp
constexpr int kMaxGridY = 65535;  // heads: CUDA's limit on gridDim.y
constexpr unsigned kFull = 0xffffffffu;

// How a sample's value is formed (see the top of this file).
enum Mode : int {
  kPair,    // P3a-c, P4b: vm; iy, ix, fy, fx, w
  kPacked,  // P4a: pm; fl, fy, fx, w
  kCoeff,   // P4c: pm; fl, c00, c01, c10, c11
  kWide,    // P4d: pm; fl, cf (4D a sample); out 4D wide
};

// The per-sample input streams, each (heads, samples) but cf (heads,
// samples, 4D). ia: iy (pair) or fl; ib: ix (pair only); f: pair and
// packed fy, fx, w; coeff c00, c01, c10, c11; wide cf.
struct Streams {
  const int* ia;
  const int* ib;
  const float* f[4];
};

// A sample as lane j holds it: its map offset (−1 out of range) and five
// coefficients. Pair: (1−fx, fx, 1−fy, fy, w); packed and coeff: the corner
// weights (c00, c01, c10, c11) and an unused fifth; wide: none.
struct Sample {
  int off;
  float c[5];
};

template <Mode kMode>
__device__ __forceinline__ Sample load_sample(const Streams& in, int s,
                                              int hp, int wp, int cells,
                                              int channels) {
  Sample out = {-1, {0.f, 0.f, 0.f, 0.f, 0.f}};
  if (kMode == kPair) {
    const int iy = __ldg(in.ia + s), ix = __ldg(in.ib + s);
    out.off = (iy >= 0 && iy <= hp - 2 && ix >= 0 && ix <= wp - 2)
                  ? (iy * wp + ix) * channels
                  : -1;
  } else {
    const int fl = __ldg(in.ia + s);
    out.off = (fl >= 0 && fl < cells) ? fl * 4 * channels : -1;
  }
  if (kMode == kPair || kMode == kPacked) {
    const float y = __ldg(in.f[0] + s), x = __ldg(in.f[1] + s),
                a = __ldg(in.f[2] + s);
    const float gy = __fsub_rn(1.f, y), gx = __fsub_rn(1.f, x);
    if (kMode == kPacked) {
      const float ay = __fmul_rn(a, gy), by = __fmul_rn(a, y);
      out.c[0] = __fmul_rn(ay, gx);
      out.c[1] = __fmul_rn(ay, x);
      out.c[2] = __fmul_rn(by, gx);
      out.c[3] = __fmul_rn(by, x);
    } else {
      out.c[0] = gx;
      out.c[1] = x;
      out.c[2] = gy;
      out.c[3] = y;
      out.c[4] = a;
    }
  } else if (kMode == kCoeff) {
#pragma unroll
    for (int k = 0; k < 4; ++k) out.c[k] = __ldg(in.f[k] + s);
  }
  return out;
}

// Channel d of one pair, packed or coeff sample, in the JAX kernels' order
// of roundings.
template <Mode kMode, typename T>
__device__ __forceinline__ float sample_value(const T* __restrict__ base,
                                              const float (&c)[5], int d,
                                              int channels, int row_stride) {
  if (kMode != kPair) {
    float v = __fmul_rn(to_f32(__ldg(base + d)), c[0]);
    v = __fadd_rn(v, __fmul_rn(to_f32(__ldg(base + channels + d)), c[1]));
    v = __fadd_rn(v, __fmul_rn(to_f32(__ldg(base + 2 * channels + d)), c[2]));
    return __fadd_rn(v,
                     __fmul_rn(to_f32(__ldg(base + 3 * channels + d)), c[3]));
  }
  const T* low = base + row_stride;
  const float top = __fadd_rn(__fmul_rn(to_f32(__ldg(base + d)), c[0]),
                              __fmul_rn(to_f32(__ldg(base + channels + d)),
                                        c[1]));
  const float bot = __fadd_rn(__fmul_rn(to_f32(__ldg(low + d)), c[0]),
                              __fmul_rn(to_f32(__ldg(low + channels + d)),
                                        c[1]));
  return __fmul_rn(c[4], __fadd_rn(__fmul_rn(top, c[2]),
                                   __fmul_rn(bot, c[3])));
}

// map: pair vm (heads, hp, wp, channels); else pm (heads, cells,
// 4·channels). out: (heads, samples / P, width) f32, width = 4·channels in
// wide mode, else channels. Block (x, head): warp k of block x owns rows
// [(x·kWarps + k)·kRows, +kRows).
template <int P, Mode kMode, typename T>
__global__ void __launch_bounds__(kThreads)
msda_probe_kernel(const T* __restrict__ map, Streams in,
                  float* __restrict__ out, int samples, int hp, int wp,
                  int cells, int channels) {
  static_assert(32 % P == 0, "P divides 32");
  // output lanes a lane owns: a channel and its second (D ≤ 64), or in
  // wide mode k = lane + 32·t over the 4D ≤ 256 of a row
  constexpr int kLanes = kMode == kWide ? 4 * kMaxChannels / 32 : 2;
  const int rows = samples / P;
  const int row0 = (blockIdx.x * kWarps + (threadIdx.x >> 5)) * kRows;
  if (row0 >= rows) return;  // whole warps leave together
  const int lane = threadIdx.x & 31;
  const int m = blockIdx.y;
  const int map_elems = kMode == kPair ? hp * wp * channels
                                       : cells * 4 * channels;
  const int width = kMode == kWide ? 4 * channels : channels;
  const T* map_h = map + m * map_elems;
  const int first = m * samples;  // the head's first sample
  in.ia += first;
  if (kMode == kPair) in.ib += first;
  const float* cf_h = nullptr;  // wide: the head's first cf row
  if (kMode == kWide) {
    cf_h = in.f[0] + first * width;
  } else {
#pragma unroll
    for (int k = 0; k < (kMode == kCoeff ? 4 : 3); ++k) in.f[k] += first;
  }
  float* out_h = out + m * rows * width;
  const int row_stride = wp * channels;  // pair: one map row
  int lanes[kLanes];
  bool has[kLanes];
#pragma unroll
  for (int t = 0; t < kLanes; ++t) {
    lanes[t] = lane + 32 * t;
    has[t] = lanes[t] < width;
  }
  const int row_end = min(rows, row0 + kRows);

  // 32 samples at a time: 32/P whole rows
  for (int row = row0; row < row_end; row += 32 / P) {
    const int base = row * P;
    const int count = min(32, (row_end - row) * P);
    Sample mine = {-1, {0.f, 0.f, 0.f, 0.f, 0.f}};
    if (lane < count)
      mine = load_sample<kMode>(in, base + lane, hp, wp, cells, channels);
    const int nrows = count / P;
#pragma unroll 4
    for (int r = 0; r < nrows; ++r) {
      float acc[kLanes];
#pragma unroll
      for (int p = 0; p < P; ++p) {
        const int j = r * P + p;
        const int off = __shfl_sync(kFull, mine.off, j);
        float v[kLanes];
#pragma unroll
        for (int t = 0; t < kLanes; ++t)
          v[t] = __int_as_float(0x7fffffff);  // NaN
        if (kMode == kWide) {
          if (off >= 0) {  // warp-uniform
            const T* at = map_h + off;
            const float* cf = cf_h + (base + j) * width;
#pragma unroll
            for (int t = 0; t < kLanes; ++t)
              if (has[t])
                v[t] = __fmul_rn(to_f32(__ldg(at + lanes[t])),
                                 __ldcs(cf + lanes[t]));
          }
        } else {
          float c[5];
#pragma unroll
          for (int k = 0; k < (kMode == kPair ? 5 : 4); ++k)
            c[k] = __shfl_sync(kFull, mine.c[k], j);
          if (off >= 0) {  // warp-uniform
            const T* at = map_h + off;
#pragma unroll
            for (int t = 0; t < kLanes; ++t)
              if (has[t])
                v[t] = sample_value<kMode>(at, c, lanes[t], channels,
                                           row_stride);
          }
        }
#pragma unroll
        for (int t = 0; t < kLanes; ++t)
          acc[t] = p == 0 ? v[t] : __fadd_rn(acc[t], v[t]);
      }
      float* o = out_h + (row + r) * width;
#pragma unroll
      for (int t = 0; t < kLanes; ++t)
        if (has[t]) o[lanes[t]] = acc[t];
    }
  }
}

template <Mode kMode, typename T>
cudaError_t launch(const void* map, const Streams& in, void* out, int heads,
                   int samples, int hp, int wp, int cells, int channels,
                   int points, cudaStream_t stream) {
  const int rows_per_block = kWarps * kRows;
  const dim3 grid((samples / points + rows_per_block - 1) / rows_per_block,
                  heads);
#define FASTERVIT_MSDA_PROBE_LAUNCH(P)                                      \
  msda_probe_kernel<P, kMode, T><<<grid, kThreads, 0, stream>>>(            \
      static_cast<const T*>(map), in, static_cast<float*>(out), samples,   \
      hp, wp, cells, channels)
  switch (points) {
    case 1: FASTERVIT_MSDA_PROBE_LAUNCH(1); break;
    case 2: FASTERVIT_MSDA_PROBE_LAUNCH(2); break;
    case 4: FASTERVIT_MSDA_PROBE_LAUNCH(4); break;
    default: return cudaErrorInvalidValue;
  }
#undef FASTERVIT_MSDA_PROBE_LAUNCH
  return cudaGetLastError();
}

// The launch in the map's type: f32 (bf16 = 0) or bf16 (bf16 = 1).
template <Mode kMode>
cudaError_t launch_typed(int bf16, const void* map, const Streams& in,
                         void* out, int heads, int samples, int hp, int wp,
                         int cells, int channels, int points,
                         void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!bf16)
    return launch<kMode, float>(map, in, out, heads, samples, hp, wp, cells,
                                channels, points, s);
  return launch<kMode, __nv_bfloat16>(map, in, out, heads, samples, hp, wp,
                                      cells, channels, points, s);
}

bool bad_shape(int heads, int samples, int channels, int points) {
  return heads <= 0 || heads > kMaxGridY || samples <= 0 || channels <= 0 ||
         channels > kMaxChannels || points <= 0 || samples % points;
}

// A packed map (heads, cells, 4·channels) and per-sample rows of `row`
// values (heads, samples, row) past the 32-bit offsets, or no cell.
bool bad_packed(int heads, int samples, int cells, int channels, int row) {
  return cells < 0 || (long long)heads * cells * 4 * channels > INT_MAX ||
         (long long)heads * samples * row > INT_MAX;
}

}  // namespace

extern "C" {

// P3a, P3b, (one head a call) P3c and P4b. vm: (heads, hp, wp, channels)
// f32 (bf16 = 0; P3 and P4b) or bf16 (bf16 = 1; P4b); iy, ix: (heads,
// samples) int32; fy, fx, w: (heads, samples) f32; out: (heads, samples /
// points, channels) f32; points 1, 2 or 4. Returns the cudaError_t of the
// launch.
int msda_probe_pair(const void* vm, const void* iy, const void* ix,
                    const void* fy, const void* fx, const void* w, void* out,
                    int heads, int samples, int hp, int wp, int channels,
                    int points, int bf16, void* stream) {
  if (bad_shape(heads, samples, channels, points) || hp < 2 || wp < 2 ||
      (long long)heads * hp * wp * channels > INT_MAX ||
      (long long)heads * samples * channels > INT_MAX)
    return int(cudaErrorInvalidValue);
  const Streams in = {static_cast<const int*>(iy),
                      static_cast<const int*>(ix),
                      {static_cast<const float*>(fy),
                       static_cast<const float*>(fx),
                       static_cast<const float*>(w), nullptr}};
  return int(launch_typed<kPair>(bf16, vm, in, out, heads, samples, hp, wp,
                                 0, channels, points, stream));
}

// P4a. pm: (heads, cells, 4·channels) f32 (bf16 = 0) or bf16 (bf16 = 1);
// fl: (heads, samples) int32; fy, fx, w: (heads, samples) f32; out:
// (heads, samples / points, channels) f32; points 1, 2 or 4. Returns
// the cudaError_t of the launch.
int msda_probe_packed(const void* pm, const void* fl, const void* fy,
                      const void* fx, const void* w, void* out, int heads,
                      int samples, int cells, int channels, int points,
                      int bf16, void* stream) {
  if (bad_shape(heads, samples, channels, points) ||
      bad_packed(heads, samples, cells, channels, channels))
    return int(cudaErrorInvalidValue);
  const Streams in = {static_cast<const int*>(fl), nullptr,
                      {static_cast<const float*>(fy),
                       static_cast<const float*>(fx),
                       static_cast<const float*>(w), nullptr}};
  return int(launch_typed<kPacked>(bf16, pm, in, out, heads, samples, 0, 0,
                                   cells, channels, points, stream));
}

// P4c. pm, fl as P4a; c00, c01, c10, c11: (heads, samples) f32, the corner
// weights; out: (heads, samples / points, channels) f32. Returns the
// cudaError_t of the launch.
int msda_probe_coeff(const void* pm, const void* fl, const void* c00,
                     const void* c01, const void* c10, const void* c11,
                     void* out, int heads, int samples, int cells,
                     int channels, int points, int bf16, void* stream) {
  if (bad_shape(heads, samples, channels, points) ||
      bad_packed(heads, samples, cells, channels, channels))
    return int(cudaErrorInvalidValue);
  const Streams in = {static_cast<const int*>(fl), nullptr,
                      {static_cast<const float*>(c00),
                       static_cast<const float*>(c01),
                       static_cast<const float*>(c10),
                       static_cast<const float*>(c11)}};
  return int(launch_typed<kCoeff>(bf16, pm, in, out, heads, samples, 0, 0,
                                  cells, channels, points, stream));
}

// P4d. pm, fl as P4a; cf: (heads, samples, 4·channels) f32, a coefficient
// row a sample; out: (heads, samples / points, 4·channels) f32, the four
// corner groups kept. Returns the cudaError_t of the launch.
int msda_probe_wide(const void* pm, const void* fl, const void* cf,
                    void* out, int heads, int samples, int cells,
                    int channels, int points, int bf16, void* stream) {
  if (bad_shape(heads, samples, channels, points) ||
      bad_packed(heads, samples, cells, channels, 4 * channels))
    return int(cudaErrorInvalidValue);
  const Streams in = {static_cast<const int*>(fl), nullptr,
                      {static_cast<const float*>(cf), nullptr, nullptr,
                       nullptr}};
  return int(launch_typed<kWide>(bf16, pm, in, out, heads, samples, 0, 0,
                                 cells, channels, points, stream));
}

}  // extern "C"
