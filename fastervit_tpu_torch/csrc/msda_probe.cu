// The MSDA gather probes' kernels, for Hopper (sm_90a).
//
// Replaces four Pallas kernels of the JAX package's probes at MOTR's
// streaming geometry:
//   P3a scripts/msda_pallas_probe.py::fused_gather (_fused_kernel),
//   P3b msda_pallas_probe.py::fused_gather_p4 (_p4_kernel),
//   P3c msda_pallas_probe.py::fused_gather_per_head (_fused_kernel_ph),
//   P4a scripts/msda_packed_probe.py::packed_gather (_packed_kernel).
//
// P3 (kPacked false): a head's zero-padded level map vm (M, Hp, Wp, D) f32
// and per sample i the precomputed (iy, ix, fy, fx, w):
//
//   top = vm[iy, ix]·(1−fx) + vm[iy, ix+1]·fx
//   bot = vm[iy+1, ix]·(1−fx) + vm[iy+1, ix+1]·fx
//   v_i = w·(top·(1−fy) + bot·fy)
//
// and out[q] = v_{qP} + v_{qP+1} + … + v_{qP+P−1}, summed in that order
// (_p4_kernel :124-140); P = 1 is P3a (one output row a sample). P3c is
// P3a launched once per head by the binding (ops/cuda_msda.py).
//
// P4 (kPacked true): the corner-packed map pm (M, (Hp−1)(Wp−1), 4D) of
// pack_corners, f32 or bf16, whose row fl = iy·(Wp−1) + ix holds the four
// corners [vm[iy,ix] | vm[iy,ix+1] | vm[iy+1,ix] | vm[iy+1,ix+1]], and
//
//   v_i = row[0:D]·(w·gy·gx) + row[D:2D]·(w·gy·fx)
//       + row[2D:3D]·(w·fy·gx) + row[3D:4D]·(w·fy·fx),  gy = 1−fy, gx = 1−fx
//
// summed over P as above; a bf16 map is widened to f32 (exact) and the
// arithmetic and the output are f32 (_packed_kernel :46-66).
//
// Every product and sum is rounded on its own, in the JAX kernels' order
// (__fmul_rn / __fadd_rn, which nvcc never contracts into an FMA), so a
// launch repeats the plain version's roundings (ops/msda_probes.py).
//
// Out of range. A P3 sample with iy outside [0, Hp−2] or ix outside
// [0, Wp−2], or a P4 sample with fl outside [0, (Hp−1)(Wp−1)), gives NaN
// (and so does its query's sum); the kernel reads nothing for it, so no
// index makes it read outside the map. The JAX probes define nothing there.
//
// Design: the TPU kept a head's whole map resident in VMEM and walked
// chunks of samples. Hopper has no such memory (a block's shared memory is
// 227 KB; only level 3's map, 172.8 KB of f32 a head, would fit), so the
// corners are read through the read-only path from L2, where a head's map
// (10 MB f32 at level 0; 39.6 MB corner-packed) stays: blocks are ordered
// head-major (blockIdx.y is the head), the card's analog of the TPU's
// constant map block index. One warp owns a run of 32 output rows (32·P
// samples), one lane a channel (two for D > 32; D ≤ 64). Lane j loads
// sample j's scalars with coalesced loads and works out its offset and
// coefficients, then the warp walks the samples in order, each lane
// taking them with __shfl_sync and adding its channel of the four corners
// in registers. A P3 sample reads two 2·D-wide runs in two map rows; a P4
// sample one contiguous 4·D-wide row. Each output row has one owner and
// there are no atomics, so two launches give the same bits.
//
// Bound on this card: bytes, each input read once and the output written
// once, at 3.35 TB/s. At M 8, QP 408,000, D 32, level 0 (202×386): P3a
// moves 562.9 MB (0.168 ms), 417.8 MB of it the output; P3b 249.6 MB
// (0.0745 ms); P4a 473.6 MB (0.141 ms), its packed map 317 MB. The
// gathered corner traffic is 1.67 GB a call and comes from L2, not device
// memory, wherever a head's map fits. Staging level tiles in shared
// memory, several queries a warp and vector loads are later work.
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

// A sample as lane j holds it: its map offset (−1 out of range) and five
// coefficients. P3: (1−fx, fx, 1−fy, fy, w); P4: the corner weights
// (w·gy·gx, w·gy·fx, w·fy·gx, w·fy·fx) and an unused fifth.
struct Sample {
  int off;
  float c[5];
};

template <bool kPacked>
__device__ __forceinline__ Sample load_sample(
    const int* __restrict__ ia, const int* __restrict__ ib,
    const float* __restrict__ fy, const float* __restrict__ fx,
    const float* __restrict__ w, int s, int hp, int wp, int cells,
    int channels) {
  Sample out;
  const float y = __ldg(fy + s), x = __ldg(fx + s), a = __ldg(w + s);
  const float gy = __fsub_rn(1.f, y), gx = __fsub_rn(1.f, x);
  if (kPacked) {
    const int fl = __ldg(ia + s);
    out.off = (fl >= 0 && fl < cells) ? fl * 4 * channels : -1;
    const float ay = __fmul_rn(a, gy), by = __fmul_rn(a, y);
    out.c[0] = __fmul_rn(ay, gx);
    out.c[1] = __fmul_rn(ay, x);
    out.c[2] = __fmul_rn(by, gx);
    out.c[3] = __fmul_rn(by, x);
    out.c[4] = 0.f;
  } else {
    const int iy = __ldg(ia + s), ix = __ldg(ib + s);
    out.off = (iy >= 0 && iy <= hp - 2 && ix >= 0 && ix <= wp - 2)
                  ? (iy * wp + ix) * channels
                  : -1;
    out.c[0] = gx;
    out.c[1] = x;
    out.c[2] = gy;
    out.c[3] = y;
    out.c[4] = a;
  }
  return out;
}

// Channel d of one sample, in the JAX kernels' order of roundings.
template <bool kPacked, typename T>
__device__ __forceinline__ float sample_value(const T* __restrict__ base,
                                              const float (&c)[5], int d,
                                              int channels, int row_stride) {
  if (kPacked) {
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

// map: P3 vm (heads, hp, wp, channels); P4 pm (heads, cells, 4·channels).
// ia, ib: P3 iy, ix; P4 fl, and ib unused. ia, ib, fy, fx, w:
// (heads, samples). out: (heads, samples / P, channels) f32. Block
// (x, head): warp k of block x owns rows [(x·kWarps + k)·kRows, +kRows).
template <int P, bool kPacked, typename T>
__global__ void __launch_bounds__(kThreads)
msda_probe_kernel(const T* __restrict__ map, const int* __restrict__ ia,
                  const int* __restrict__ ib, const float* __restrict__ fy,
                  const float* __restrict__ fx, const float* __restrict__ w,
                  float* __restrict__ out, int samples, int hp, int wp,
                  int cells, int channels) {
  static_assert(32 % P == 0, "P divides 32");
  const int rows = samples / P;
  const int row0 = (blockIdx.x * kWarps + (threadIdx.x >> 5)) * kRows;
  if (row0 >= rows) return;  // whole warps leave together
  const int lane = threadIdx.x & 31;
  const int m = blockIdx.y;
  const int map_elems = kPacked ? cells * 4 * channels : hp * wp * channels;
  const T* map_h = map + m * map_elems;
  const int first = m * samples;  // the head's first sample
  ia += first;
  if (!kPacked) ib += first;
  fy += first;
  fx += first;
  w += first;
  float* out_h = out + m * rows * channels;
  const int row_stride = wp * channels;  // P3: one map row
  const int d0 = lane, d1 = lane + 32;
  const bool has0 = d0 < channels, has1 = d1 < channels;
  const int row_end = min(rows, row0 + kRows);

  // 32 samples at a time: 32/P whole rows
  for (int row = row0; row < row_end; row += 32 / P) {
    const int base = row * P;
    const int count = min(32, (row_end - row) * P);
    Sample mine = {-1, {0.f, 0.f, 0.f, 0.f, 0.f}};
    if (lane < count)
      mine = load_sample<kPacked>(ia, ib, fy, fx, w, base + lane, hp, wp,
                                  cells, channels);
    const int nrows = count / P;
#pragma unroll 4
    for (int r = 0; r < nrows; ++r) {
      float acc0 = 0.f, acc1 = 0.f;
#pragma unroll
      for (int p = 0; p < P; ++p) {
        const int j = r * P + p;
        const int off = __shfl_sync(kFull, mine.off, j);
        float c[5];
#pragma unroll
        for (int k = 0; k < (kPacked ? 4 : 5); ++k)
          c[k] = __shfl_sync(kFull, mine.c[k], j);
        float v0 = __int_as_float(0x7fffffff), v1 = v0;  // NaN
        if (off >= 0) {  // warp-uniform
          const T* at = map_h + off;
          if (has0) v0 = sample_value<kPacked>(at, c, d0, channels,
                                               row_stride);
          if (has1) v1 = sample_value<kPacked>(at, c, d1, channels,
                                               row_stride);
        }
        acc0 = p == 0 ? v0 : __fadd_rn(acc0, v0);
        acc1 = p == 0 ? v1 : __fadd_rn(acc1, v1);
      }
      float* o = out_h + (row + r) * channels;
      if (has0) o[d0] = acc0;
      if (has1) o[d1] = acc1;
    }
  }
}

template <bool kPacked, typename T>
cudaError_t launch(const void* map, const void* ia, const void* ib,
                   const void* fy, const void* fx, const void* w, void* out,
                   int heads, int samples, int hp, int wp, int cells,
                   int channels, int points, cudaStream_t stream) {
  const int rows_per_block = kWarps * kRows;
  const dim3 grid((samples / points + rows_per_block - 1) / rows_per_block,
                  heads);
#define FASTERVIT_MSDA_PROBE_LAUNCH(P)                                      \
  msda_probe_kernel<P, kPacked, T><<<grid, kThreads, 0, stream>>>(          \
      static_cast<const T*>(map), static_cast<const int*>(ia),              \
      static_cast<const int*>(ib), static_cast<const float*>(fy),           \
      static_cast<const float*>(fx), static_cast<const float*>(w),          \
      static_cast<float*>(out), samples, hp, wp, cells, channels)
  switch (points) {
    case 1: FASTERVIT_MSDA_PROBE_LAUNCH(1); break;
    case 2: FASTERVIT_MSDA_PROBE_LAUNCH(2); break;
    case 4: FASTERVIT_MSDA_PROBE_LAUNCH(4); break;
    default: return cudaErrorInvalidValue;
  }
#undef FASTERVIT_MSDA_PROBE_LAUNCH
  return cudaGetLastError();
}

bool bad_shape(int heads, int samples, int channels, int points) {
  return heads <= 0 || heads > kMaxGridY || samples <= 0 || channels <= 0 ||
         channels > kMaxChannels || points <= 0 || samples % points;
}

}  // namespace

extern "C" {

// P3a, P3b and (one head a call) P3c. vm: (heads, hp, wp, channels) f32;
// iy, ix: (heads, samples) int32; fy, fx, w: (heads, samples) f32; out:
// (heads, samples / points, channels) f32; points 1, 2 or 4. Returns
// the cudaError_t of the launch.
int msda_probe_gather(const void* vm, const void* iy, const void* ix,
                      const void* fy, const void* fx, const void* w,
                      void* out, int heads, int samples, int hp, int wp,
                      int channels, int points, void* stream) {
  if (bad_shape(heads, samples, channels, points) || hp < 2 || wp < 2 ||
      (long long)heads * hp * wp * channels > INT_MAX ||
      (long long)heads * samples * channels > INT_MAX)
    return int(cudaErrorInvalidValue);
  return int(launch<false, float>(vm, iy, ix, fy, fx, w, out, heads,
                                  samples, hp, wp, 0, channels, points,
                                  static_cast<cudaStream_t>(stream)));
}

// P4a. pm: (heads, cells, 4·channels) f32 (bf16 = 0) or bf16 (bf16 = 1);
// fl: (heads, samples) int32; fy, fx, w: (heads, samples) f32; out:
// (heads, samples / points, channels) f32; points 1, 2 or 4. Returns
// the cudaError_t of the launch.
int msda_probe_packed(const void* pm, const void* fl, const void* fy,
                      const void* fx, const void* w, void* out, int heads,
                      int samples, int cells, int channels, int points,
                      int bf16, void* stream) {
  if (bad_shape(heads, samples, channels, points) || cells < 0 ||
      (long long)heads * cells * 4 * channels > INT_MAX ||
      (long long)heads * samples * channels > INT_MAX)
    return int(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!bf16)
    return int(launch<true, float>(pm, fl, nullptr, fy, fx, w, out, heads,
                                   samples, 0, 0, cells, channels, points,
                                   s));
  return int(launch<true, __nv_bfloat16>(pm, fl, nullptr, fy, fx, w, out,
                                         heads, samples, 0, 0, cells,
                                         channels, points, s));
}

}  // extern "C"
