// The MSDA gather probes' kernels, for Hopper (sm_90a).
//
// Replaces seven Pallas kernels of the JAX package's probes at MOTR's
// streaming geometry:
//   P3a scripts/msda_pallas_probe.py::fused_gather (_fused_kernel :44,
//       pallas_call :102),
//   P3b msda_pallas_probe.py::fused_gather_p4 (_p4_kernel :116,
//       pallas_call :165),
//   P3c msda_pallas_probe.py::fused_gather_per_head (_fused_kernel_ph :178,
//       pallas_call :221),
//   P4a scripts/msda_packed_probe.py::packed_gather (_packed_kernel :46,
//       pallas_call :94),
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
//   v_i = ((row[0:D]·c00 + row[D:2D]·c01) + row[2D:3D]·c10) + row[3D:4D]·c11
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
// order (__fmul_rn / __fadd_rn / __fsub_rn, which nvcc never contracts into
// an FMA), so a launch repeats the plain version's roundings
// (ops/msda_probes.py), channel by channel, whatever its plan.
//
// Out of range. A pair-mode sample with iy outside [0, Hp−2] or ix outside
// [0, Wp−2], or a packed, coeff or wide sample with fl outside
// [0, (Hp−1)(Wp−1)), gives NaN (on all 4D lanes in wide mode, and so does
// its query's sum); the kernel reads nothing for it, so no index makes it
// read outside the map. The JAX probes define nothing there.
//
// Bound on this card: bytes, each input read once and the output written
// once, at 3.35 TB/s. At M 8, QP 408,000, D 32, level 0 (202×386): P3a
// moves 562.9 MB (0.168 ms), 417.8 MB of it the output; P3b and P4b on an
// f32 map 249.6 MB (0.0745 ms); P4a 473.6 MB (0.141 ms), its packed map
// 317 MB; P4c 486.7 MB (0.145 ms); P4d 2,419 MB (0.722 ms), 1,671 MB of it
// cf and 418 MB the output. What sets the pace is not those bytes but the
// gathered corner rows, 1.67 GB a call at level 0 (8 × 408,000 samples ×
// 512 bytes), and the latency of those loads. The TPU kept a head's map in
// VMEM and walked chunks of samples; a Hopper block has at most 227 KB of
// shared memory and the card a 50 MB L2.
//
// Design of pair, packed and coeff mode (msda_probe_vec_kernel; the launch
// plan is made in Python, cuda_msda.py::probe_plan, and checked here):
// - A group of G lanes owns one output row and its P samples, in order, so
//   the P sum stays in registers and no sum crosses groups. Each lane holds
//   V contiguous channels (two vectors for D > 32 on scalar loads) and
//   reads each corner's share with one 2- to 16-byte load: f32 at D 32 G 8,
//   V 4 (a warp load fetches one corner of four rows), bf16 G 4, V 8 (eight
//   rows); a packed or coeff lane makes its four loads at 0, D, 2D, 3D of
//   the 4D-wide row. A D or a map address that the widest vector does not
//   divide takes a narrower V, down to 1.
// - Lane l of a warp loads sample l of its 32/G rows' P·32/G samples (one
//   coalesced load a stream, with the evict-first hint, __ldcs: read once)
//   and forms its map offset; the offset and then the sample's floats (fy,
//   fx, w; in coeff mode the four corner weights) reach the group through
//   shuffles, and each lane of the group forms the coefficients (coeff
//   mode takes the weights as they are). The next chunk's scalars are
//   loaded before this chunk's corners are walked, and each sample's four
//   corner loads are issued before any is added. The output is stored with
//   __stcs (written once), so that neither stream pushes the map out of L2.
// - Route "l2": a persistent grid of a few blocks an SM walks the (head,
//   rows) chunks of 32/G rows in head-major order by grid stride, so the
//   rows in flight at any moment lie within about one head and that head's
//   map stays in L2 (P3b 10 MB, P4a and P4c 39.6 MB f32 and 19.8 MB bf16 at
//   level 0); P3c's one-head launch spreads its head over every SM the same
//   way.
// - Route "smem" (pair mode, where a head's padded map fits a block's
//   dynamic shared memory, as MOTR's level 3 does: 172.8 KB f32, 86.4 KB
//   bf16): block b takes the b-th of gridDim equal runs of the head-major
//   chunks, copies each head's map that its run meets into shared memory
//   by cp.async (once a head a block) and reads every corner from there. A
//   packed map never fits (level 3's f32 one is 652 KB a head).
// - There are no atomics and every output row has one owner, so two
//   launches, and any two plans, give the same bits.
// Wide mode (msda_probe_kernel) keeps the first design: one warp owns a run
// of 32 output rows, lane j loads sample j's map offset, the warp walks the
// samples in order taking them with __shfl_sync, and lane l owns the output
// lanes k = l + 32·t (4D ≤ 256), streaming each sample's cf row with the
// evict-first hint beside its map row; blocks are ordered head-major
// (blockIdx.y is the head).
//
// Plain C interface, bound with ctypes by fastervit_tpu_torch/ops/
// cuda_msda.py, which checks device, dtype, shape and contiguity, and that
// every tensor holds fewer than 2^31 elements (all offsets here are 32-bit).

#include <algorithm>
#include <climits>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "dtype.cuh"
#include "vec.cuh"

namespace {

using fastervit::to_f32;
using fastervit::Vec;

constexpr int kMaxChannels = 64;  // PROBE_MAX_CHANNELS in cuda_msda.py
constexpr int kMaxGridY = 65535;  // heads, at most (_MAX_HEADS in
                                  // cuda_msda.py): wide mode's gridDim.y,
                                  // and the limit of every entry point
constexpr unsigned kFull = 0xffffffffu;

// what an out-of-range sample gives, on every lane
__device__ __forceinline__ float nan_f32() {
  return __int_as_float(0x7fffffff);
}

// The first walk (wide mode)
constexpr int kWarps = 8;         // warps a block
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 32;         // output rows a warp

// The redesigned walk (pair, packed and coeff mode)
constexpr int kMaxWarps = 32;     // warps a block, at most (PROBE_MAX_WARPS)
// at most 64 registers a thread (__launch_bounds__(32·kMaxWarps, 1)), so
// that 32 warps an SM keep their corner loads in flight, in one block or
// several
constexpr int kMinBlocks = 1;
constexpr int kMaxBlocks = 1 << 20;   // a plan's blocks, at most
// a block's dynamic shared memory, at most (PROBE_SMEM_BYTES)
constexpr int kMaxSmemBytes = 232448;

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

// ---------------------------------------------------------------------------
// Pair, packed and coeff mode

// The launch plan, in the order of cuda_msda.py::ProbePlan.as_c: lanes a
// row (G), channels a vector (V), channels a lane (NV·V), rows a warp
// (32/G), warps a block, blocks, and the route (0 "l2", 1 "smem").
struct Plan {
  int lanes, vec, channels, rows_per_warp, warps, blocks, smem;
};

// A launch's sizes: rows = samples / P a head, chunks of rows_per_warp
// rows, chunks_per_head of them a head; map_elems a head's map.
struct Shape {
  int heads, samples, rows, chunks_per_head, hp, wp, cells, channels,
      map_elems;
};

// One sample's scalars as its lane loaded them: a (iy or fl), b (ix, pair
// only) and its floats, y, x, w (fy, fx, w), or in coeff mode y, x, w, z
// (c00, c01, c10, c11). Only coeff mode's Raw has a z: a dead z in the
// other modes' changed the SASS of some of their P 1 instances (about 1%
// slower at MOTR's level 0 on an H100). A lane with no sample holds one out
// of range.
template <Mode kMode>
struct Raw {
  int a, b;
  float y, x, w;
};
template <>
struct Raw<kCoeff> {
  int a, b;
  float y, x, w, z;
};

template <Mode kMode>
__device__ __forceinline__ Raw<kMode> load_raw(const Streams& in, int s,
                                               bool has) {
  Raw<kMode> r = {-1, -1, 0.f, 0.f, 0.f};
  if (has) {
    r.a = __ldcs(in.ia + s);
    if (kMode == kPair) r.b = __ldcs(in.ib + s);
    r.y = __ldcs(in.f[0] + s);
    r.x = __ldcs(in.f[1] + s);
    r.w = __ldcs(in.f[2] + s);
    if constexpr (kMode == kCoeff) r.z = __ldcs(in.f[3] + s);
  }
  return r;
}

// The sample's first element in its head's map (−1 out of range).
template <Mode kMode>
__device__ __forceinline__ int map_offset(const Raw<kMode>& r,
                                          const Shape& sh) {
  if (kMode == kPacked || kMode == kCoeff)
    return r.a >= 0 && r.a < sh.cells ? r.a * 4 * sh.channels : -1;
  return r.a >= 0 && r.a <= sh.hp - 2 && r.b >= 0 && r.b <= sh.wp - 2
             ? (r.a * sh.wp + r.b) * sh.channels
             : -1;
}

// A sample's coefficients from its floats, in the JAX kernels' roundings:
// pair (1−fx, fx, 1−fy, fy, w) and packed the corner weights (c00, c01,
// c10, c11) from y, x, w = fy, fx, w; coeff the corner weights y, x, w, z
// as they were given. Every lane of a group forms them alike.
template <Mode kMode>
__device__ __forceinline__ void coefficients(float y, float x, float w,
                                             float z, float (&c)[5]) {
  if (kMode == kCoeff) {
    c[0] = y;
    c[1] = x;
    c[2] = w;
    c[3] = z;
    c[4] = 0.f;
    return;
  }
  const float gy = __fsub_rn(1.f, y), gx = __fsub_rn(1.f, x);
  if (kMode == kPacked) {
    const float ay = __fmul_rn(w, gy), by = __fmul_rn(w, y);
    c[0] = __fmul_rn(ay, gx);
    c[1] = __fmul_rn(ay, x);
    c[2] = __fmul_rn(by, gx);
    c[3] = __fmul_rn(by, x);
    c[4] = 0.f;
  } else {
    c[0] = gx;
    c[1] = x;
    c[2] = gy;
    c[3] = y;
    c[4] = w;
  }
}

// V f32 values stored with the evict-first hint, in 16-byte pieces or one
// narrower store
template <int V>
__device__ __forceinline__ void store_cs(float* p, const float* x) {
  if constexpr (V >= 4) {
#pragma unroll
    for (int i = 0; i < V; i += 4)
      __stcs(reinterpret_cast<float4*>(p + i),
             make_float4(x[i], x[i + 1], x[i + 2], x[i + 3]));
  } else if constexpr (V == 2) {
    __stcs(reinterpret_cast<float2*>(p), make_float2(x[0], x[1]));
  } else {
    __stcs(p, x[0]);
  }
}

// A warp walks the chunks first, first + step, … below end: each a run of
// 32/G output rows of one head, a group of G lanes a row. map is the
// heads' maps (route l2) or the shared-memory copy of the one head that
// these chunks belong to (route smem).
template <int P, Mode kMode, typename T, int V, int NV, bool kSmem>
__device__ __forceinline__ void walk(const T* __restrict__ map,
                                     const Streams& in,
                                     float* __restrict__ out, int first,
                                     int end, int step, const Shape& sh,
                                     int log2_lanes) {
  constexpr int kPerLane = NV * V;
  const int lane = threadIdx.x & 31;
  const int group = lane >> log2_lanes;            // the row of the chunk
  const int j = lane & ((1 << log2_lanes) - 1);    // the lane in its group
  const int rows_per_warp = 32 >> log2_lanes;
  const int batch = rows_per_warp * P;             // samples a chunk
  const int c0 = j * kPerLane;                     // the lane's first channel
  bool has[NV];
#pragma unroll
  for (int t = 0; t < NV; ++t) has[t] = c0 + t * V < sh.channels;
  const int row_stride = sh.wp * sh.channels;      // pair: one map row

  // lane l's sample of chunk c: sample l of its rows
  auto raw_of = [&](int c) {
    const int h = c / sh.chunks_per_head;
    const int s = (c - h * sh.chunks_per_head) * batch + lane;
    const bool live = c < end && lane < batch && s < sh.samples;
    return load_raw<kMode>(in, live ? h * sh.samples + s : 0, live);
  };
  Raw<kMode> next = raw_of(first);
  for (int c = first; c < end; c += step) {
    const Raw<kMode> mine = next;
    next = raw_of(c + step);  // the next chunk's scalars, in flight now
    const int off = map_offset<kMode>(mine, sh);
    const int h = c / sh.chunks_per_head;
    const int row = (c - h * sh.chunks_per_head) * rows_per_warp + group;
    const T* map_h = kSmem ? map : map + h * sh.map_elems;

    // the samples one at a time (their loop not unrolled: unrolled, the
    // next sample's loads were hoisted and spilled at 64 registers)
    float acc[kPerLane];
#pragma unroll 1
    for (int p = 0; p < P; ++p) {
      const int src = group * P + p;  // the lane that holds sample p
      const int o = __shfl_sync(kFull, off, src);
      // the four corners' loads, issued together; the coefficients are
      // fetched and formed only when they are needed
      Vec<T, V> q[4][NV];
      const T* at = map_h + (o >= 0 ? o : 0) + c0;
#pragma unroll
      for (int k = 0; k < 4; ++k)
#pragma unroll
        for (int t = 0; t < NV; ++t) {
          const T* src_k =
              at + t * V +
              (kMode == kPair ? (k & 1) * sh.channels + (k >> 1) * row_stride
                              : k * sh.channels);
          if (o >= 0 && has[t]) {
            if constexpr (kSmem) q[k][t].load_plain(src_k);
            else q[k][t].load(src_k);
          } else {
            q[k][t].bits = {};
          }
        }
      float z = 0.f;
      if constexpr (kMode == kCoeff) z = __shfl_sync(kFull, mine.z, src);
      float k_[5];
      coefficients<kMode>(
          __shfl_sync(kFull, mine.y, src), __shfl_sync(kFull, mine.x, src),
          __shfl_sync(kFull, mine.w, src), z, k_);
#pragma unroll
      for (int t = 0; t < NV; ++t)
#pragma unroll
        for (int e = 0; e < V; ++e) {
          const float r0 = q[0][t].get(e), r1 = q[1][t].get(e);
          const float r2 = q[2][t].get(e), r3 = q[3][t].get(e);
          float x;
          if (kMode == kPair) {
            const float top = __fadd_rn(__fmul_rn(r0, k_[0]),
                                        __fmul_rn(r1, k_[1]));
            const float bot = __fadd_rn(__fmul_rn(r2, k_[0]),
                                        __fmul_rn(r3, k_[1]));
            x = __fmul_rn(k_[4], __fadd_rn(__fmul_rn(top, k_[2]),
                                           __fmul_rn(bot, k_[3])));
          } else {
            x = __fmul_rn(r0, k_[0]);
            x = __fadd_rn(x, __fmul_rn(r1, k_[1]));
            x = __fadd_rn(x, __fmul_rn(r2, k_[2]));
            x = __fadd_rn(x, __fmul_rn(r3, k_[3]));
          }
          if (o < 0) x = nan_f32();  // out of range: uniform over the group
          float& a = acc[t * V + e];
          a = p == 0 ? x : __fadd_rn(a, x);
        }
    }
    if (row < sh.rows) {
      float* o_r = out + (h * sh.rows + row) * sh.channels + c0;
#pragma unroll
      for (int t = 0; t < NV; ++t)
        if (has[t]) store_cs<V>(o_r + t * V, acc + t * V);
    }
  }
}

// elems elements of src into the shared-memory tile, by cp.async of one
// V-vector a thread at a time (plain loads below 4 bytes)
template <typename T, int V>
__device__ __forceinline__ void copy_to_shared(T* tile,
                                               const T* __restrict__ src,
                                               int elems) {
  constexpr int kBytes = V * int(sizeof(T));
  if constexpr (kBytes >= 4) {
    for (int i = threadIdx.x * V; i < elems; i += blockDim.x * V) {
      const unsigned dst =
          static_cast<unsigned>(__cvta_generic_to_shared(tile + i));
      asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(dst),
                   "l"(src + i), "n"(kBytes)
                   : "memory");
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
  } else {
    for (int i = threadIdx.x; i < elems; i += blockDim.x) tile[i] = src[i];
  }
}

// map: pair vm (heads, hp, wp, channels); packed and coeff pm (heads,
// cells, 4·channels). out: (heads, samples / P, channels) f32.
template <int P, Mode kMode, typename T, int V, int NV, bool kSmem>
__global__ void __launch_bounds__(32 * kMaxWarps, kMinBlocks)
msda_probe_vec_kernel(const T* __restrict__ map, Streams in,
                      float* __restrict__ out, Shape sh, int log2_lanes) {
  static_assert(32 % P == 0, "P divides 32");
  const int warps = blockDim.x >> 5, warp = threadIdx.x >> 5;
  const int chunks = sh.heads * sh.chunks_per_head;
  if constexpr (!kSmem) {
    walk<P, kMode, T, V, NV, false>(map, in, out, blockIdx.x * warps + warp,
                                    chunks, gridDim.x * warps, sh,
                                    log2_lanes);
  } else {
    extern __shared__ __align__(16) unsigned char smem[];
    T* tile = reinterpret_cast<T*>(smem);
    // the block's run of chunks, cut where the head changes
    const int lo = int((long long)blockIdx.x * chunks / gridDim.x);
    const int hi = int((long long)(blockIdx.x + 1) * chunks / gridDim.x);
    for (int c = lo; c < hi;) {
      const int h = c / sh.chunks_per_head;
      const int cut = min(hi, (h + 1) * sh.chunks_per_head);
      __syncthreads();  // the previous head's corners are all read
      copy_to_shared<T, V>(tile, map + h * sh.map_elems, sh.map_elems);
      __syncthreads();
      walk<P, kMode, T, V, NV, true>(tile, in, out, c + warp, cut, warps, sh,
                                     log2_lanes);
      c = cut;
    }
  }
}

template <int P, Mode kMode, typename T, int V, int NV, bool kSmem>
cudaError_t launch_vec(const Plan& p, const void* map, const Streams& in,
                       void* out, const Shape& sh, cudaStream_t stream) {
  const long long chunks = (long long)sh.heads * sh.chunks_per_head;
  int blocks = p.blocks, smem = 0;
  if (kSmem) {
    // every block a run of at least one chunk; the map's copy needs the
    // opt-in past 48 KB, without which the launch is refused
    blocks = int(std::min<long long>(blocks, chunks));
    smem = sh.map_elems * int(sizeof(T));
    const cudaError_t err = cudaFuncSetAttribute(
        msda_probe_vec_kernel<P, kMode, T, V, NV, kSmem>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  } else {
    blocks = int(std::min<long long>(blocks,
                                     (chunks + p.warps - 1) / p.warps));
  }
  msda_probe_vec_kernel<P, kMode, T, V, NV, kSmem>
      <<<blocks, 32 * p.warps, smem, stream>>>(
          static_cast<const T*>(map), in, static_cast<float*>(out), sh,
          __builtin_ctz(unsigned(p.lanes)));
  return cudaGetLastError();
}

// The instance of a plan: V in {1, 2, 4, 8} (at most 16 bytes), two vectors
// a lane only at V 1 (cuda_msda.py::probe_plan: D > 32 on scalar loads)
template <int P, Mode kMode, typename T, bool kSmem>
cudaError_t launch_plan(const Plan& p, const void* map, const Streams& in,
                        void* out, const Shape& sh, cudaStream_t s) {
#define FASTERVIT_PROBE_VEC(V, NV)                                         \
  case V * 4 + NV:                                                          \
    if constexpr (V * sizeof(T) <= 16)                                      \
      return launch_vec<P, kMode, T, V, NV, kSmem>(p, map, in, out, sh, s); \
    break;
  switch (p.vec * 4 + p.channels / p.vec) {
    FASTERVIT_PROBE_VEC(1, 1)
    FASTERVIT_PROBE_VEC(1, 2)
    FASTERVIT_PROBE_VEC(2, 1)
    FASTERVIT_PROBE_VEC(4, 1)
    FASTERVIT_PROBE_VEC(8, 1)
  }
#undef FASTERVIT_PROBE_VEC
  return cudaErrorInvalidValue;
}

template <Mode kMode, typename T>
cudaError_t launch_points(const Plan& p, int points, const void* map,
                          const Streams& in, void* out, const Shape& sh,
                          cudaStream_t s) {
  if constexpr (kMode == kPair) {
    if (p.smem) {
      switch (points) {
        case 1: return launch_plan<1, kMode, T, true>(p, map, in, out, sh, s);
        case 2: return launch_plan<2, kMode, T, true>(p, map, in, out, sh, s);
        case 4: return launch_plan<4, kMode, T, true>(p, map, in, out, sh, s);
      }
      return cudaErrorInvalidValue;
    }
  }
  switch (points) {
    case 1: return launch_plan<1, kMode, T, false>(p, map, in, out, sh, s);
    case 2: return launch_plan<2, kMode, T, false>(p, map, in, out, sh, s);
    case 4: return launch_plan<4, kMode, T, false>(p, map, in, out, sh, s);
  }
  return cudaErrorInvalidValue;
}

bool aligned(const void* p, int bytes) {
  return reinterpret_cast<std::uintptr_t>(p) % unsigned(bytes) == 0;
}

// A plan that no instance runs on these pointers: vectors of at most 16
// bytes that D and the map's address allow, an f32 output the lane's
// stores can reach, groups of 4 to 32 lanes that cover D, whole warps, and
// the shared-memory route only in pair mode for a map that fits.
bool bad_plan(const Plan& p, int channels, int elem, const void* map,
              const void* out, long long map_bytes, bool pair) {
  return p.vec < 1 || p.vec * elem > 16 || channels % p.vec ||
         !(p.channels == p.vec ||
           (p.channels == 2 && p.vec == 1 && p.lanes == 32)) ||
         !(p.lanes == 4 || p.lanes == 8 || p.lanes == 16 || p.lanes == 32) ||
         p.lanes * p.rows_per_warp != 32 ||
         (long long)p.lanes * p.channels < channels || p.warps < 1 ||
         p.warps > kMaxWarps || p.blocks < 1 || p.blocks > kMaxBlocks ||
         !aligned(map, p.vec * elem) ||
         !aligned(out, 4 * (p.vec < 4 ? p.vec : 4)) ||
         (p.smem != 0 && p.smem != 1) ||
         (p.smem && (!pair || map_bytes > kMaxSmemBytes));
}

// The sizes of a launch of plan p; points divides samples.
Shape shape_of(const Plan& p, int heads, int samples, int points, int hp,
               int wp, int cells, int channels, int map_elems) {
  const int rows = samples / points;
  return {heads, samples, rows,
          (rows + p.rows_per_warp - 1) / p.rows_per_warp, hp, wp, cells,
          channels, map_elems};
}

// ---------------------------------------------------------------------------
// Wide mode: the first walk

// The map offset of lane j's sample fl (−1 out of range).
__device__ __forceinline__ int load_offset(const int* fl, int s, int cells,
                                           int channels) {
  const int f = __ldg(fl + s);
  return (f >= 0 && f < cells) ? f * 4 * channels : -1;
}

// map: pm (heads, cells, 4·channels). out: (heads, samples / P,
// 4·channels) f32. Block (x, head): warp k of block x owns rows
// [(x·kWarps + k)·kRows, +kRows).
template <int P, Mode kMode, typename T>
__global__ void __launch_bounds__(kThreads)
msda_probe_kernel(const T* __restrict__ map, Streams in,
                  float* __restrict__ out, int samples, int cells,
                  int channels) {
  static_assert(32 % P == 0, "P divides 32");
  static_assert(kMode == kWide, "the first walk runs wide mode alone");
  // output lanes a lane owns: k = lane + 32·t over the 4D ≤ 256 of a row
  constexpr int kLanes = 4 * kMaxChannels / 32;
  const int rows = samples / P;
  const int row0 = (blockIdx.x * kWarps + (threadIdx.x >> 5)) * kRows;
  if (row0 >= rows) return;  // whole warps leave together
  const int lane = threadIdx.x & 31;
  const int m = blockIdx.y;
  const int width = 4 * channels;
  const T* map_h = map + m * cells * 4 * channels;
  const int first = m * samples;  // the head's first sample
  in.ia += first;
  const float* cf_h = in.f[0] + first * width;  // the head's first cf row
  float* out_h = out + m * rows * width;
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
    int mine = -1;
    if (lane < count) mine = load_offset(in.ia, base + lane, cells, channels);
    const int nrows = count / P;
#pragma unroll 4
    for (int r = 0; r < nrows; ++r) {
      float acc[kLanes];
#pragma unroll
      for (int p = 0; p < P; ++p) {
        const int j = r * P + p;
        const int off = __shfl_sync(kFull, mine, j);
        float v[kLanes];
#pragma unroll
        for (int t = 0; t < kLanes; ++t) v[t] = nan_f32();
        if (off >= 0) {  // warp-uniform
          const T* at = map_h + off;
          const float* cf = cf_h + (base + j) * width;
#pragma unroll
          for (int t = 0; t < kLanes; ++t)
            if (has[t])
              v[t] = __fmul_rn(to_f32(__ldg(at + lanes[t])),
                               __ldcs(cf + lanes[t]));
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
                   int samples, int cells, int channels, int points,
                   cudaStream_t stream) {
  const int rows_per_block = kWarps * kRows;
  const dim3 grid((samples / points + rows_per_block - 1) / rows_per_block,
                  heads);
#define FASTERVIT_MSDA_PROBE_LAUNCH(P)                                      \
  msda_probe_kernel<P, kMode, T><<<grid, kThreads, 0, stream>>>(            \
      static_cast<const T*>(map), in, static_cast<float*>(out), samples,   \
      cells, channels)
  switch (points) {
    case 1: FASTERVIT_MSDA_PROBE_LAUNCH(1); break;
    case 2: FASTERVIT_MSDA_PROBE_LAUNCH(2); break;
    case 4: FASTERVIT_MSDA_PROBE_LAUNCH(4); break;
    default: return cudaErrorInvalidValue;
  }
#undef FASTERVIT_MSDA_PROBE_LAUNCH
  return cudaGetLastError();
}

// The first walk's launch in the map's type: f32 (bf16 = 0) or bf16.
template <Mode kMode>
cudaError_t launch_typed(int bf16, const void* map, const Streams& in,
                         void* out, int heads, int samples, int cells,
                         int channels, int points, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!bf16)
    return launch<kMode, float>(map, in, out, heads, samples, cells,
                                channels, points, s);
  return launch<kMode, __nv_bfloat16>(map, in, out, heads, samples, cells,
                                      channels, points, s);
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

// A packed- or coeff-mode launch (P4a, P4c) of the seven plan ints on pm
// (heads, cells, 4·channels), f32 (bf16 = 0) or bf16, refused unless an
// instance of this file runs the plan on these pointers.
template <Mode kMode>
int launch_packed(const void* pm, const Streams& in, void* out, int heads,
                  int samples, int cells, int channels, int points, int bf16,
                  const int* plan, void* stream) {
  const Plan p{plan[0], plan[1], plan[2], plan[3], plan[4], plan[5], plan[6]};
  const int elem = bf16 ? 2 : 4;
  if (bad_shape(heads, samples, channels, points) ||
      bad_packed(heads, samples, cells, channels, channels) ||
      bad_plan(p, channels, elem, pm, out,
               (long long)cells * 4 * channels * elem, false))
    return int(cudaErrorInvalidValue);
  const Shape sh = shape_of(p, heads, samples, points, 0, 0, cells, channels,
                            cells * 4 * channels);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!bf16)
    return int(launch_points<kMode, float>(p, points, pm, in, out, sh, s));
  return int(
      launch_points<kMode, __nv_bfloat16>(p, points, pm, in, out, sh, s));
}

}  // namespace

extern "C" {

// P3a, P3b, (one head a call) P3c and P4b. vm: (heads, hp, wp, channels)
// f32 (bf16 = 0; P3 and P4b) or bf16 (bf16 = 1; P4b); iy, ix: (heads,
// samples) int32; fy, fx, w: (heads, samples) f32; out: (heads, samples /
// points, channels) f32; points 1, 2 or 4. plan: the seven ints of
// cuda_msda.py::ProbePlan.as_c, refused unless an instance of this file
// runs it on these pointers. Returns the cudaError_t of the launch.
int msda_probe_pair(const void* vm, const void* iy, const void* ix,
                    const void* fy, const void* fx, const void* w, void* out,
                    int heads, int samples, int hp, int wp, int channels,
                    int points, int bf16, const int* plan, void* stream) {
  const Plan p{plan[0], plan[1], plan[2], plan[3], plan[4], plan[5], plan[6]};
  const int elem = bf16 ? 2 : 4;
  if (bad_shape(heads, samples, channels, points) || hp < 2 || wp < 2 ||
      (long long)heads * hp * wp * channels > INT_MAX ||
      (long long)heads * samples * channels > INT_MAX ||
      bad_plan(p, channels, elem, vm, out,
               (long long)hp * wp * channels * elem, true))
    return int(cudaErrorInvalidValue);
  const Streams in = {static_cast<const int*>(iy),
                      static_cast<const int*>(ix),
                      {static_cast<const float*>(fy),
                       static_cast<const float*>(fx),
                       static_cast<const float*>(w), nullptr}};
  const Shape sh = shape_of(p, heads, samples, points, hp, wp, 0, channels,
                            hp * wp * channels);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!bf16)
    return int(launch_points<kPair, float>(p, points, vm, in, out, sh, s));
  return int(
      launch_points<kPair, __nv_bfloat16>(p, points, vm, in, out, sh, s));
}

// P4a. pm: (heads, cells, 4·channels) f32 (bf16 = 0) or bf16 (bf16 = 1);
// fl: (heads, samples) int32; fy, fx, w: (heads, samples) f32; out:
// (heads, samples / points, channels) f32; points 1, 2 or 4; plan as for
// msda_probe_pair (route "l2" only). Returns the cudaError_t of the launch.
int msda_probe_packed(const void* pm, const void* fl, const void* fy,
                      const void* fx, const void* w, void* out, int heads,
                      int samples, int cells, int channels, int points,
                      int bf16, const int* plan, void* stream) {
  const Streams in = {static_cast<const int*>(fl), nullptr,
                      {static_cast<const float*>(fy),
                       static_cast<const float*>(fx),
                       static_cast<const float*>(w), nullptr}};
  return launch_packed<kPacked>(pm, in, out, heads, samples, cells, channels,
                                points, bf16, plan, stream);
}

// P4c. pm, fl as P4a; c00, c01, c10, c11: (heads, samples) f32, the corner
// weights; out: (heads, samples / points, channels) f32; plan as for
// msda_probe_packed. Returns the cudaError_t of the launch.
int msda_probe_coeff(const void* pm, const void* fl, const void* c00,
                     const void* c01, const void* c10, const void* c11,
                     void* out, int heads, int samples, int cells,
                     int channels, int points, int bf16, const int* plan,
                     void* stream) {
  const Streams in = {static_cast<const int*>(fl), nullptr,
                      {static_cast<const float*>(c00),
                       static_cast<const float*>(c01),
                       static_cast<const float*>(c10),
                       static_cast<const float*>(c11)}};
  return launch_packed<kCoeff>(pm, in, out, heads, samples, cells, channels,
                               points, bf16, plan, stream);
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
  return int(launch_typed<kWide>(bf16, pm, in, out, heads, samples, cells,
                                 channels, points, stream));
}

}  // extern "C"
