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
// channels a vector load (csrc/vec.cuh), with K5's G and V; rows in (n, m,
// q) order.
//
// Types: value, weights, grad_out and dweights f32 or bf16; the locations
// and dloc f32 (the wrapper casts dloc to the locations' dtype); dvalue
// summed in an f32 buffer (N, S, M, D) that the wrapper zeroes and, for
// bf16, rounds to bf16 once. All arithmetic is f32.
//
// - dweights and dloc: each lane sums its channels' share of ⟨interp, g⟩
//   and of the two location terms, then the group adds its lanes' shares
//   with width-G xor shuffles in a fixed order; the lane that owns the
//   sample writes it. No atomics: two launches, and any two plans, give the
//   same bits.
// - dvalue: each in-range corner of a valid sample adds cw·a·g, V channels
//   a lane. The order of the additions changes from run to run, so dvalue
//   is reproducible to the order bound c·2⁻²⁴·Σ|terms| (c the most
//   contributions an element has, plus the flushes below), not bit for bit.
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
//
// What set the pace of the first version (PR 17, 1.93 ms at that call, one
// block a run of 64 rows): its dvalue adds, one 16-byte atomic
// (red.global.add.v4.f32) per four channels of every corner, 182 M of them
// (2.9 GB) into L2 a call: the same walk with no adds took 0.36-0.37 ms,
// with one level's adds 0.64-0.72 (PERF.md, PR 18; probes/
// msda_bwd_split.py). The atomics run more slowly where one instruction's
// lanes reach many half-filled lines; and Hopper has no shared-memory
// float add (atomicAdd on a shared float is a compare-and-swap loop,
// slower a float than L2's vector atomics). So this design (the plan is
// made in Python, cuda_msda.py::msda_bwd_plan, and checked here):
// - A persistent grid walks the (n, m, q) rows head-major: in round k block
//   b takes run k·gridDim + b of `run` rows, so that a round covers about
//   one head and the maps its atomics and loads reach stay in L2 (runs of
//   a block's whole share, 16 heads in flight, were 40% slower). A run is
//   cut where the head changes; the block's warps take its chunks of 32/G
//   rows in turn.
// - The adds fill whole lines: a group's atomic instruction covers whole
//   32-byte sectors of its row, and at bf16 D 32 the rows go in pairs whose
//   eight lanes fill one row's 128 bytes an instruction, as f32's eight
//   lanes a row do.
// - Route "smem": each block keeps an f32 tile of dvalue for the coarsest
//   levels that fit (a suffix of the levels, the plan's `tiled`: DINO's
//   level 3, 35 KB a head, beside a second block) of the head it is on. It
//   zeroes the tile when it reaches a head, adds each tiled corner's cw·a·g
//   into it with shared-memory atomics, and flushes it when it leaves the
//   head: each nonzero V-vector is added into the f32 buffer with one
//   vector atomic. In the tile, each add-vector's channels go in an order
//   rotated by the lane's row (its pair's), so that the warp's rows, whose
//   corners lie D floats apart, land on different banks. The SM's atomics
//   then take a quarter of the adds while L2 takes the rest (levels 2 and
//   3, half the adds, in one block of 16 warps, were slower than no tile
//   at all). Route "l2" (no level fits, or too few rows a head to pay a
//   tile's zeroing and flush: the decoder's): every add is global.
// - The walk: the next batch's locations and weights are loaded, and its
//   geometry formed, before its samples are reached; the next sample's four
//   corner loads are issued after this sample's dots and before its adds.
//   The per-row streams (locations, weights, g, dloc, dweights) are read
//   and written with the evict-first hint, to keep L2 for the maps.
// - At most kMaxWarps warps a block, 128 registers a thread: an SM runs
//   two blocks of 8 warps. A lane keeps its sample's dweights and dloc in
//   shared memory from its turn to the batch's write, which the group
//   makes together (held in registers instead, they spilled).
// What sets the pace now: the adds at L2 and the tile's compare-and-swap
// loops, then the walk (its dots, shuffles and corner loads).

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
constexpr int kMaxWarps = 16;      // warps a block, at most (_BWD_MAX_WARPS)
// at most 128 registers a thread, 16 warps an SM in one block or two
constexpr int kMinBlocks = 1;
constexpr int kSmemLevels = 64;    // levels whose (H, W, start) a block keeps
// a block's shared memory, at most: the level table, each thread's results
// (s_out) and the tile (BWD_MAX_TILE_BYTES in cuda_msda.py = this less the
// first two, _BWD_STATIC_BYTES)
constexpr int kMaxSmemBytes = 232448;
constexpr int kMaxTileBytes =
    kMaxSmemBytes - kSmemLevels * 16 - 32 * kMaxWarps * 12;
constexpr int kMaxTileLevels = 30;  // levels a tile's bit mask can name
constexpr unsigned kFull = 0xffffffffu;

// The launch plan, in the order of cuda_msda.py::MsdaBwdPlan.as_c: lanes a
// row (G), channels a vector (V), channels a lane (NV·V), rows a warp
// (32/G), warps a block, blocks, rows a run, runs a block (rounds), the
// route (0 "l2", 1 "smem"), the tiled levels as a bit mask and the tile's
// bytes.
struct Plan {
  int lanes, vec, channels, rows_per_warp, warps, blocks, run, rounds, smem,
      tiled, tile_bytes;
};

// Sample s of a row: its four corners' token offsets (−1 where the corner,
// or the whole sample, adds nothing), the fractions fx, fy (0 for an
// invalid sample) and the level's W and H.
struct Sample {
  int off[4];
  float fx, fy, w, h;
};

// The bilinear weights (without the attention weight) of corners 00, 01,
// 10, 11 from a sample's fractions. An invalid sample's (1, 0, 0, 0) meet
// corner rows of zeros and no adds.
__device__ __forceinline__ void corner_weights(float fx, float fy,
                                               float cw[4]) {
  const float wy[2] = {__fsub_rn(1.f, fy), fy};
  const float wx[2] = {__fsub_rn(1.f, fx), fx};
#pragma unroll
  for (int c = 0; c < 4; ++c) cw[c] = __fmul_rn(wy[c >> 1], wx[c & 1]);
}

__device__ __forceinline__ Sample geometry(bool has, float2 xy, int l,
                                           const int4* s_levels,
                                           const int* __restrict__ levels) {
  Sample s;
#pragma unroll
  for (int c = 0; c < 4; ++c) s.off[c] = -1;
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
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int yy = yi + (c >> 1), xx = xi + (c & 1);
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

// V floats of the shared-memory tile at p (aligned to V floats)
template <int V>
__device__ __forceinline__ void load_f32(const float* p, float* x) {
  if constexpr (V % 4 == 0) {
#pragma unroll
    for (int k = 0; k < V / 4; ++k) {
      const float4 t = reinterpret_cast<const float4*>(p)[k];
      x[4 * k] = t.x, x[4 * k + 1] = t.y, x[4 * k + 2] = t.z,
      x[4 * k + 3] = t.w;
    }
  } else if constexpr (V == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    x[0] = t.x, x[1] = t.y;
  } else {
    x[0] = *p;
  }
}

// The head's tile zeroed by the block (after the previous head's flush)
__device__ __forceinline__ void zero_tile(float* tile, int elems) {
  __syncthreads();
  float4* t4 = reinterpret_cast<float4*>(tile);
  for (int i = threadIdx.x; i < elems / 4; i += blockDim.x)
    t4[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int i = elems / 4 * 4 + threadIdx.x; i < elems; i += blockDim.x)
    tile[i] = 0.f;
  __syncthreads();
}

// The tile of head n·heads + m added into the f32 buffer, a V-vector a
// thread at a time (whole lines a warp), skipping vectors no corner
// reached
template <int V>
__device__ __forceinline__ void flush_tile(const float* tile, float* dvalue,
                                           long long head, int heads,
                                           int seq, int tile_first,
                                           int tokens, int channels,
                                           long long token_stride) {
  __syncthreads();
  const long long n = head / heads;
  float* dv = dvalue + (n * seq + tile_first) * token_stride +
              (head - n * heads) * channels;
  const int vecs = channels / V;
  for (int i = threadIdx.x; i < tokens * vecs; i += blockDim.x) {
    const int t = i / vecs, k = i - t * vecs;
    float x[V];
    load_f32<V>(tile + t * channels + k * V, x);
    bool any = false;
#pragma unroll
    for (int e = 0; e < V; ++e) any |= x[e] != 0.f;
    if (any) add_f32<V>(dv + t * token_stride + k * V, x);
  }
}

// levels: (num_levels, 3) int32 rows of (H, W, first token). T: value,
// weights, grad_out and dweights. G lanes a row, NV vectors of V channels
// a lane. tile_tokens: the tiled levels' tokens (the last of the map), 0
// on route l2.
template <typename T, int V, int G, int NV>
__global__ void __launch_bounds__(32 * kMaxWarps, kMinBlocks)
msda_bwd_kernel(const T* __restrict__ value, const int* __restrict__ levels,
                const float2* __restrict__ loc, const T* __restrict__ weights,
                const T* __restrict__ grad_out, float* __restrict__ dvalue,
                float2* __restrict__ dloc, T* __restrict__ dweights,
                long long rows, int run, int rounds, int queries, int seq,
                int heads, int channels, int num_levels, int points,
                int tile_tokens) {
  constexpr int kPerLane = NV * V;
  constexpr int kRows = 32 / G;  // rows a warp
  // The dvalue adds: A channels an atomic, NA of them a lane. The lane's
  // k-th add covers the A-vector j + G·k of its row, so that the group's
  // atomic instruction fills whole 32-byte sectors; or, for bf16 at D 32
  // (four lanes of two A-vectors a row), the warp's rows go in pairs and
  // the k-th add of both groups of a pair covers row k of the pair, the
  // first group its A-vector j, the second its A-vector j + G, so that one
  // atomic instruction fills each pair's 128-byte row (two a sample and
  // corner, as many as before, on half the lines).
  constexpr int A = V < 4 ? V : 4;
  constexpr int NA = kPerLane / A;
  constexpr bool kPair = G == 4 && NA == 2;
  extern __shared__ __align__(16) float tile[];
  __shared__ int4 s_levels[kSmemLevels];
  // the thread's dweights and dloc of its sample of the batch, kept here
  // from its turn to the batch's write (in registers, the served bf16
  // instance spilled)
  __shared__ float3 s_out[32 * kMaxWarps];
  for (int l = threadIdx.x; l < min(num_levels, kSmemLevels);
       l += blockDim.x)
    s_levels[l] = make_int4(levels[3 * l], levels[3 * l + 1],
                            levels[3 * l + 2], 0);
  __syncthreads();

  const int warps = blockDim.x >> 5, warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int grp = lane / G;  // the lane's row in its warp
  const int j = lane % G;    // the lane's place in its row's group
  const bool odd = kPair && (grp & 1);  // the second group of its pair
  const int c0 = j * kPerLane;  // the lane's first channel
  const int samples = num_levels * points;
  const long long token_stride = (long long)heads * channels;
  const int tile_first = seq - tile_tokens;  // the tile's first token
  // In the tile, each add-vector's A channels go in an order rotated by the
  // lane's row (its pair's), so that the warp's rows, whose corners lie D
  // floats apart, land on different banks.
  const int rot = (kPair ? grp >> 1 : grp) & (A - 1);
  int cv[NA];     // the first channel of the lane's k-th add
  bool adds[NA];  // ... within D
#pragma unroll
  for (int k = 0; k < NA; ++k) {
    cv[k] = A * (j + G * (kPair ? int(odd) : k));
    adds[k] = cv[k] < channels;
  }

  // the block's runs b, b + gridDim, …: `run` consecutive (n, m, q) rows
  // each, cut where the head changes; the tile stays while the head does
  long long tile_head = -1;
  for (int round = 0; round < rounds; ++round) {
    const long long lo =
        ((long long)round * gridDim.x + blockIdx.x) * run;
    if (lo >= rows) break;  // block-uniform
    const long long hi = min(rows, lo + run);
    for (long long seg = lo; seg < hi;) {
      const long long head = seg / queries;  // n·heads + m
      const long long end = min(hi, (head + 1) * queries);
      const long long n = head / heads;
      const int m = int(head - n * heads);
      const long long nm = n * seq * token_stride + (long long)m * channels;
      const T* v_nm = value + nm;
      float* dv_nm = dvalue + nm;
      if (tile_tokens && head != tile_head) {
        if (tile_head >= 0)
          flush_tile<V>(tile, dvalue, tile_head, heads, seq, tile_first,
                        tile_tokens, channels, token_stride);
        zero_tile(tile, tile_tokens * channels);
        tile_head = head;
      }

      const long long chunks = (end - seg + kRows - 1) / kRows;
      for (long long chunk = warp; chunk < chunks; chunk += warps) {
        const long long r = seg + chunk * kRows + grp;
        // a group past the segment's last row keeps walking with the warp
        // (its shuffles need every lane) but reads and writes nothing
        const bool live = r < end;
        // r runs over (n, m, q); row over (n, q, m), the layout of loc and g
        const long long q = r - head * queries;
        const long long row = (n * queries + q) * heads + m;
        const float2* loc_r = loc + row * samples;
        const T* w_r = weights + row * samples;
        const T* g_r = grad_out + row * channels;
        bool has[NV];
#pragma unroll
        for (int t = 0; t < NV; ++t) has[t] = live && c0 + t * V < channels;

        // g, in T: gv, the lane's V-vectors, for the dots; ga, the A-vector
        // of each add's row (pairs: the partner row q ± 1 for one of them),
        // for the adds
        Vec<T, V> gv[NV];
        Vec<T, A> ga[NA];
        bool on[NA];  // the add's row is live
        const bool live_pair = seg + chunk * kRows + (grp ^ 1) < end;
#pragma unroll
        for (int t = 0; t < NV; ++t) {
          gv[t] = Vec<T, V>{};
          if (has[t]) gv[t].load_cs(g_r + c0 + t * V);
        }
#pragma unroll
        for (int k = 0; k < NA; ++k) {
          const bool own = !kPair || k == int(odd);
          on[k] = own ? live : live_pair;
          ga[k] = Vec<T, A>{};
          if (on[k] && adds[k])
            ga[k].load_cs(g_r + cv[k] +  // the partner row: M·D away
                          (own ? 0 : (odd ? -1 : 1) * (long long)heads *
                                         channels));
        }

        // batch 0: lane j's geometry and weight of sample j; then batch 1's
        // location and weight, in flight
        float2 xy = make_float2(0.f, 0.f);
        float a = 0.f;
        if (live && j < samples) {
          xy = __ldcs(loc_r + j);
          a = to_f32(__ldcs(w_r + j));
        }
        // the batch's geometry, and lane j's dloc scales a·W, a·H
        Sample cur = geometry(live && j < samples, xy, j / points, s_levels,
                              levels);
        float a_cur = a, aw = a * cur.w, ah = a * cur.h;
        if (live && j + G < samples) {
          xy = __ldcs(loc_r + j + G);
          a = to_f32(__ldcs(w_r + j + G));
        }
        // sample 0's corners
        int o[4];
        Vec<T, V> v[4][NV];
#pragma unroll
        for (int c = 0; c < 4; ++c)
          o[c] = __shfl_sync(kFull, cur.off[c], 0, G);
#pragma unroll
        for (int c = 0; c < 4; ++c)
#pragma unroll
          for (int t = 0; t < NV; ++t) {
            v[c][t] = Vec<T, V>{};
            if (o[c] >= 0 && has[t])
              v[c][t].load(v_nm + (long long)o[c] * token_stride + c0 +
                           t * V);
          }

        int i = 0;  // the sample's place in its batch of G
#pragma unroll 1
        for (int s = 0; s < samples; ++s) {
          // this sample's scalars from lane i of the group, its corners
          int oc[4];
#pragma unroll
          for (int c = 0; c < 4; ++c) oc[c] = o[c];
          const float fx = __shfl_sync(kFull, cur.fx, i, G);
          const float fy = __shfl_sync(kFull, cur.fy, i, G);
          float cw[4];
          corner_weights(fx, fy, cw);
          const float ai = __shfl_sync(kFull, a_cur, i, G);
          const float sw = aw, sh = ah;  // this batch's, for its writes
          // this lane's share of ⟨interp, g⟩ and of the location terms
          float pw = 0.f, px = 0.f, py = 0.f;
          const float ofx = __fsub_rn(1.f, fx), ofy = __fsub_rn(1.f, fy);
#pragma unroll
          for (int t = 0; t < NV; ++t)
#pragma unroll
            for (int e = 0; e < V; ++e) {
              const float v00 = v[0][t].get(e), v01 = v[1][t].get(e);
              const float v10 = v[2][t].get(e), v11 = v[3][t].get(e);
              const float ge = gv[t].get(e);
              float interp = cw[0] * v00;
              interp = fmaf(cw[1], v01, interp);
              interp = fmaf(cw[2], v10, interp);
              interp = fmaf(cw[3], v11, interp);
              pw = fmaf(ge, interp, pw);
              px = fmaf(ge, fmaf(ofy, v01 - v00, fy * (v11 - v10)), px);
              py = fmaf(ge, fmaf(ofx, v10 - v00, fx * (v11 - v01)), py);
            }
          // the next sample's corner loads, in flight while this one's sums
          // are gathered and its adds issued; the next batch's geometry
          // replaces this one's when its first sample is next (warp-uniform
          // branches)
          if (s + 1 < samples) {
            if (i == G - 1) {
              const int sn = s + 1 + j;
              cur = geometry(live && sn < samples, xy, sn / points, s_levels,
                             levels);
              a_cur = a, aw = a * cur.w, ah = a * cur.h;
              if (live && sn + G < samples) {
                xy = __ldcs(loc_r + sn + G);
                a = to_f32(__ldcs(w_r + sn + G));
              }
#pragma unroll
              for (int c = 0; c < 4; ++c)
                o[c] = __shfl_sync(kFull, cur.off[c], 0, G);
            } else {
#pragma unroll
              for (int c = 0; c < 4; ++c)
                o[c] = __shfl_sync(kFull, cur.off[c], i + 1, G);
            }
#pragma unroll
            for (int c = 0; c < 4; ++c)
#pragma unroll
              for (int t = 0; t < NV; ++t) {
                v[c][t] = Vec<T, V>{};
                if (o[c] >= 0 && has[t])
                  v[c][t].load(v_nm + (long long)o[c] * token_stride + c0 +
                               t * V);
              }
          }
          // the group's sums, in a fixed order
#pragma unroll
          for (int k = G / 2; k > 0; k >>= 1) {
            pw += __shfl_xor_sync(kFull, pw, k, G);
            px += __shfl_xor_sync(kFull, px, k, G);
            py += __shfl_xor_sync(kFull, py, k, G);
          }
          if (j == i)
            s_out[threadIdx.x] =
                make_float3(pw, __fmul_rn(px, sw), __fmul_rn(py, sh));
          // dvalue: each in-range corner's cw·a·g, into the tile where the
          // corner's token is tiled (the same for every row of the warp:
          // the sample's level), else into the f32 buffer
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const float k = __fmul_rn(cw[c], ai);
            // each add's corner and weight (pairs: the partner's, from the
            // lane of the other group; selects, no indexed registers)
            int tok[NA];
            float kk[NA];
#pragma unroll
            for (int u = 0; u < NA; ++u) tok[u] = oc[c], kk[u] = k;
            if constexpr (kPair) {
              const int op = __shfl_xor_sync(kFull, oc[c], G);
              const float kp = __shfl_xor_sync(kFull, k, G);
              tok[0] = odd ? op : oc[c], kk[0] = odd ? kp : k;
              tok[1] = odd ? oc[c] : op, kk[1] = odd ? k : kp;
            }
#pragma unroll
            for (int u = 0; u < NA; ++u) {
              if (!on[u] || !adds[u] || tok[u] < 0) continue;
              if (tok[u] >= tile_first) {
                float* p = tile + (tok[u] - tile_first) * channels + cv[u];
#pragma unroll
                for (int e = 0; e < A; ++e) {
                  const int f = (e + rot) & (A - 1);
                  atomicAdd(p + f, __fmul_rn(kk[u], ga[u].get(f)));
                }
              } else {
                float x[A];
#pragma unroll
                for (int e = 0; e < A; ++e)
                  x[e] = __fmul_rn(kk[u], ga[u].get(e));
                add_f32<A>(dv_nm + (long long)tok[u] * token_stride + cv[u],
                           x);
              }
            }
          }
          // the batch's last sample: lane j writes its sample s − i + j
          if (i == G - 1 || s + 1 == samples) {
            const int sj = s - i + j;
            if (live && sj < samples) {
              const float3 out = s_out[threadIdx.x];
              __stcs(dweights + row * samples + sj, from_f32<T>(out.x));
              __stcs(dloc + row * samples + sj, make_float2(out.y, out.z));
            }
            i = 0;
          } else {
            ++i;
          }
        }
      }
      seg = end;
    }
  }
  if (tile_tokens && tile_head >= 0)
    flush_tile<V>(tile, dvalue, tile_head, heads, seq, tile_first,
                  tile_tokens, channels, token_stride);
}

// The arguments every instance takes, so that the dispatch below passes
// one struct.
struct Args {
  const void *value, *levels, *loc, *weights, *grad_out;
  void *dvalue, *dloc, *dweights;
  long long rows;
  int queries, seq, heads, channels, num_levels, points, tile_tokens;
  cudaStream_t stream;
};

template <typename T, int V, int G, int NV>
cudaError_t launch(const Plan& p, const Args& a) {
  if (p.tile_bytes > 0) {
    // the tile needs the opt-in past 48 KB, without which the launch is
    // refused
    const cudaError_t err = cudaFuncSetAttribute(
        msda_bwd_kernel<T, V, G, NV>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, p.tile_bytes);
    if (err != cudaSuccess) return err;
  }
  msda_bwd_kernel<T, V, G, NV>
      <<<unsigned(p.blocks), 32 * p.warps, p.tile_bytes, a.stream>>>(
      static_cast<const T*>(a.value), static_cast<const int*>(a.levels),
      static_cast<const float2*>(a.loc), static_cast<const T*>(a.weights),
      static_cast<const T*>(a.grad_out), static_cast<float*>(a.dvalue),
      static_cast<float2*>(a.dloc), static_cast<T*>(a.dweights), a.rows,
      p.run, p.rounds, a.queries, a.seq, a.heads, a.channels, a.num_levels,
      a.points, a.tile_tokens);
  return cudaGetLastError();
}

// The instance of a plan: K5's (cuda_msda.py::msda_plan): G in {4, 8, 16,
// 32} with G·V at most D's 64; NV 2 only at G 32 and V 1.
template <typename T, int V, int G, int NV>
cudaError_t launch_if(const Plan& p, const Args& a) {
  if constexpr (G * V <= kMaxChannels && (NV == 1 || (G == 32 && V == 1))) {
    if (p.lanes == G && p.channels == NV * V) return launch<T, V, G, NV>(p, a);
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
// of (H, W, first token) on the device, and shapes the same levels' (H, W)
// pairs on the host, Σ H·W = seq; loc: (batch, queries, heads, num_levels,
// points, 2) f32, 8-byte aligned; weights: (batch, queries, heads,
// num_levels, points); grad_out: (batch, queries, heads·channels); dvalue:
// f32 (batch, seq, heads, channels), zeroed by the caller, 16-byte
// aligned; dloc: f32 like loc; dweights: like weights. value, weights,
// grad_out and dweights f32 (bf16 = 0) or bf16 (bf16 = 1). plan: the
// eleven ints of cuda_msda.py::MsdaBwdPlan.as_c, refused unless an instance of
// this file runs it on these pointers and shapes. Returns the cudaError_t
// of the launch.
int msda_backward(const void* value, const void* levels, const void* loc,
                  const void* weights, const void* grad_out, void* dvalue,
                  void* dloc, void* dweights, int batch, int queries,
                  int seq, int heads, int channels, int num_levels,
                  int points, int bf16, const int* shapes, const int* plan,
                  void* stream) {
  const Plan p{plan[0], plan[1], plan[2], plan[3], plan[4], plan[5],
               plan[6], plan[7], plan[8], plan[9], plan[10]};
  const int elem = bf16 ? 2 : 4;
  const long long rows = (long long)batch * queries * heads;
  if (batch <= 0 || queries <= 0 || seq <= 0 || heads <= 0 ||
      channels <= 0 || channels > kMaxChannels || num_levels <= 0 ||
      points <= 0 || (long long)num_levels * points > INT_MAX / 2)
    return int(cudaErrorInvalidValue);
  long long tokens = 0;
  for (int l = 0; l < num_levels; ++l) {
    if (shapes[2 * l] <= 0 || shapes[2 * l + 1] <= 0)
      return int(cudaErrorInvalidValue);
    tokens += (long long)shapes[2 * l] * shapes[2 * l + 1];
  }
  if (tokens != seq) return int(cudaErrorInvalidValue);
  // the lanes: whole vectors of at most 16 bytes that D and the pointers
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
  // the runs: run r holds rows [r·run, min((r + 1)·run, rows)) and block
  // b takes runs b, b + blocks, … for `rounds` rounds; every row in one
  // run of one round, every block and every round a run
  const long long per_round = (long long)p.blocks * p.run;
  if (p.blocks < 1 || p.run < 1 || p.rounds < 1 ||
      (long long)(p.blocks - 1) * p.run >= rows ||
      (p.rounds - 1) * per_round >= rows || p.rounds * per_round < rows)
    return int(cudaErrorInvalidValue);
  // the route: "l2" tiles nothing; "smem" a suffix of the levels (the
  // coarsest), whose f32 rows of one head are the tile's bytes, within a
  // block's shared memory
  int tile_tokens = 0;
  if (p.smem == 0) {
    if (p.tiled != 0 || p.tile_bytes != 0) return int(cudaErrorInvalidValue);
  } else {
    if (p.smem != 1 || num_levels > kMaxTileLevels || p.tiled <= 0)
      return int(cudaErrorInvalidValue);
    const unsigned all = (1u << num_levels) - 1;
    const int first = __builtin_ctz(unsigned(p.tiled));
    if (unsigned(p.tiled) != (all & ~((1u << first) - 1)))
      return int(cudaErrorInvalidValue);
    long long tiled = 0;
    for (int l = first; l < num_levels; ++l)
      tiled += (long long)shapes[2 * l] * shapes[2 * l + 1];
    if (tiled * channels * 4 != p.tile_bytes || p.tile_bytes > kMaxTileBytes)
      return int(cudaErrorInvalidValue);
    tile_tokens = int(tiled);
  }
  const Args a{value, levels, loc, weights, grad_out, dvalue, dloc, dweights,
               rows, queries, seq, heads, channels, num_levels, points,
               tile_tokens, static_cast<cudaStream_t>(stream)};
  if (!bf16) return int(launch_plan<float>(p, a));
  return int(launch_plan<__nv_bfloat16>(p, a));
}

}  // extern "C"
