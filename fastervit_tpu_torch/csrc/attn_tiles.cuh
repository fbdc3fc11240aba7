// The tile plans and tile steps shared by the long-window attention
// kernels: K3 and P2 (window_mhsa_long.cu) and P1 (attn_online.cu). Each
// kernel has two routes, chosen by the operands' type in a plan that
// ops/cuda_attention.py::long_plan makes and the C entry points check.
//
// q, k, v and out are (B, H, S, hd) operands given by a base pointer and
// element strides (window, head, token), hd contiguous: the packed qkv
// projection output (B, S, 3C) that K3 reads, or separate (B, H, S, hd)
// tensors. Every offset is 64-bit; the token stride is 32-bit (checked by
// `launchable`), so a token's offset is one widening multiply-add.
//
// bf16: the tensor-core route (namespace tc). One block of two consumer
// warpgroups owns kRows = 128 q rows of one (window, head), 64 a
// warpgroup, and streams the keys through shared memory 64 at a time, so
// each K/V tile serves 128 rows. S = q·kᵀ is four (hd ≤ 64) wgmma
// m64n64k16 a tile with q and k from shared memory, both K-major (k is
// stored [key][d], so kᵀ needs no transpose). O += p·v is wgmma
// m64nDk16 with p from registers: the f32 S accumulator, rounded to bf16
// pairs in place, is the A fragment of a k16 step. v is transposed on its
// way into shared memory, so its descriptor is K-major too and no
// transpose bit is needed. hd is padded with zeros in shared memory to
// D = padded_head_dim(hd), the q·kᵀ depth and the p·v width alike:
//
//   hd       D    q·kᵀ and p·v work on zeros
//   32       32    0%  (the any-res carriers)
//   49       64   23%  (the 21k family)
//   80       80    0%  (faster_vit_5)
//   128     128    0%
//
// (any other hd pads to the next of 32, 64, 80, 128). The shared-memory
// layouts are the core-matrix layouts that wgmma descriptors name without
// a swizzle: 8 rows × 16 bytes a core matrix, 128 contiguous bytes. TMA
// cannot load these operands at hd 49 (a head's base in the packed qkv is
// at h·98 bytes, a token of a separate tensor at t·98 bytes: TMA wants 16
// bytes), so the 256 threads stage the next K/V tile in registers, two
// bytes a load, or 16 when hd % 8 == 0 and every pointer and stride is
// aligned; they issue those loads while the current tile's q·kᵀ runs and
// store them into the other of two shared-memory stages while its p·v
// runs. One __syncthreads a tile. K3's and P1's bias tile (128 rows × 64
// keys) comes a tile ahead into one of two more shared-memory stages by
// 16-byte cp.async where its rows allow (S·sizeof(bias) % 16 == 0: every
// served shape), element by element otherwise, and each thread reads its
// fragment's pairs of adjacent keys from there as it adds them to the
// logits in f32. (Read straight from global memory into the fragment's
// positions, bf16x2 a load, the bias's L2 latency lay bare on every tile
// and K3 took more than twice P2's time.)
//
// What sets the pace is not the products (a fifth or so of a tile step's
// cycles at the 21k-768 level-2 call) but the CUDA-core work between
// them, which one block cannot overlap with its own wgmma: the staged
// loads, two bytes each at hd 49, the exponentials (exp2, a third of
// expf's instructions) and the masking (skipped on whole tiles). So an
// instance runs two blocks an SM where its registers (≤ 128 a thread at
// D ≤ 64, the bias read inside `logits`) and shared memory (no bias or a
// bf16 one) allow (`min_blocks`): one block's softmax and loads then run
// beside the other's products. Three designs measured slower and were
// not kept: 4-byte word loads of 2-byte-aligned rows; pairs of 2-byte
// loads put as one 4-byte shared store (half the stores, twice the
// sectors a K load touches); and the next tile's q·kᵀ issued beside the
// current softmax over three K/V stages (its registers).
//
// f32: the scalar route. TF32 would move the logits by ~1e-3, and the
// f32 paths are held to 2e-5, so f32 stays on scalar FMA: one block of
// kThreads = 256 threads owns kTile = 64 q rows; thread (ty, tx) of the
// 16 × 16 holds rows ty + 16i and keys tx + 16j (i, j < 4) of the logits
// tile and rows ty + 16i and columns tx + 16j (j < NJ) of the f32
// accumulator, NJ = hd_pad / 16, fed from f32 shared memory. A row's keys
// lie with the 16 threads of one ty, in one half-warp, so row sums and
// maxima reduce with xor shuffles 8..1.
#pragma once

#include <cmath>
#include <cstddef>
#include <cstdint>
#include <initializer_list>
#include <type_traits>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "dtype.cuh"

namespace fastervit {
namespace attn_tiles {

constexpr int kTile = 64;         // q rows per block, keys per K/V tile
constexpr int kThreads = 256;     // 16 × 16; each thread 4 rows × 4 keys
constexpr int kMaxHeadDim = 128;  // LONG_MAX_HEAD_DIM in cuda_attention.py
constexpr int kLd = kTile + 1;    // padded rows: no bank conflicts on the
                                  // transposed writes and p's two-row reads

// Element strides of a (B, H, S, hd) operand.
struct Strides {
  long long window, head;
  int token;
};

// Shared memory, in floats: q and k transposed (hd × kLd each), p
// (kTile × kLd), v (kTile × hd_pad).
inline size_t smem_floats(int head_dim, int hd_pad) {
  return size_t(2 * head_dim + kTile) * kLd + size_t(kTile) * hd_pad;
}

// The pointers' layout: qt [d][row], kt [d][key], p [row][key], v [key][d].
struct Smem {
  float *qt, *kt, *p, *v;
  __device__ Smem(float* smem, int head_dim)
      : qt(smem), kt(smem + head_dim * kLd), p(kt + head_dim * kLd),
        v(p + kTile * kLd) {}
};

// Offset of (window blockIdx.x, head blockIdx.z) in an operand.
__device__ __forceinline__ long long slab(const Strides& st) {
  return (long long)blockIdx.x * st.window + (long long)blockIdx.z * st.head;
}

// q rows q0 .. q0 + kTile, transposed, rows past S as zeros; and v's
// padding columns above hd as zeros, which no later tile overwrites.
template <int kHdPad>
__device__ __forceinline__ void load_q(const float* __restrict__ q,
                                       int token, int q0, int seq,
                                       int head_dim, const Smem& sm) {
  for (int e = threadIdx.x; e < kTile * head_dim; e += kThreads) {
    const int r = e / head_dim, d = e - r * head_dim;
    const int s = q0 + r;
    sm.qt[d * kLd + r] = s < seq ? q[(long long)s * token + d] : 0.f;
  }
  for (int e = threadIdx.x; e < kTile * (kHdPad - head_dim); e += kThreads) {
    const int c = e / (kHdPad - head_dim);
    sm.v[c * kHdPad + head_dim + (e - c * (kHdPad - head_dim))] = 0.f;
  }
}

// Keys k0 .. k0 + kTile: k transposed, and v if kWithV; keys from `end` on
// as zeros.
template <int kHdPad, bool kWithV>
__device__ __forceinline__ void load_kv(const float* __restrict__ k,
                                        const float* __restrict__ v,
                                        int token, int k0, int end,
                                        int head_dim, const Smem& sm) {
  for (int e = threadIdx.x; e < kTile * head_dim; e += kThreads) {
    const int c = e / head_dim, d = e - c * head_dim;
    const bool in = k0 + c < end;
    const long long at = (long long)(k0 + c) * token + d;
    sm.kt[d * kLd + c] = in ? k[at] : 0.f;
    if (kWithV) sm.v[c * kHdPad + d] = in ? v[at] : 0.f;
  }
}

// This thread's 4×4 logits of the tile at k0: q kᵀ·scale (+ bias) in f32,
// −inf for keys from `end` on. bias_h is the head's (S, S) slab.
template <typename TB, bool kBias>
__device__ __forceinline__ void logits(const Smem& sm,
                                       const TB* __restrict__ bias_h, int q0,
                                       int k0, int end, int seq, int head_dim,
                                       float scale, float (&sc)[4][4]) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < head_dim; ++d) {
    float qa[4], ka[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) qa[i] = sm.qt[d * kLd + ty + 16 * i];
#pragma unroll
    for (int j = 0; j < 4; ++j) ka[j] = sm.kt[d * kLd + tx + 16 * j];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = fmaf(qa[i], ka[j], sc[i][j]);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = min(q0 + ty + 16 * i, seq - 1);  // rows past S: any row
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = k0 + tx + 16 * j;
      if (c >= end) {
        sc[i][j] = -INFINITY;
      } else if constexpr (kBias) {
        sc[i][j] = fmaf(sc[i][j], scale,
                        to_f32(bias_h[(long long)r * seq + c]));
      } else {
        sc[i][j] *= scale;
      }
    }
  }
}

// acc += p · v over the tile's first kn keys.
template <int NJ>
__device__ __forceinline__ void accumulate_pv(const Smem& sm, int kn,
                                              float (&acc)[4][NJ]) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll 4
  for (int c = 0; c < kn; ++c) {
    float pa[4], va[NJ];
#pragma unroll
    for (int i = 0; i < 4; ++i) pa[i] = sm.p[(ty + 16 * i) * kLd + c];
#pragma unroll
    for (int j = 0; j < NJ; ++j) va[j] = sm.v[c * 16 * NJ + tx + 16 * j];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] = fmaf(pa[i], va[j], acc[i][j]);
  }
}

// Sum over the 16 threads that hold one row.
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Max over the 16 threads that hold one row.
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// out = acc / Σp for rows below S and columns below hd.
template <int NJ>
__device__ __forceinline__ void store(float* __restrict__ out, int token,
                                      int q0, int seq, int head_dim,
                                      const float (&acc)[4][NJ],
                                      const float (&l)[4]) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r >= seq) continue;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int d = tx + 16 * j;
      if (d < head_dim)
        out[(long long)r * token + d] = acc[i][j] / l[i];
    }
  }
}

// Whether CUDA can launch the (B, S/kTile, H) grid for these sizes, and
// the token strides fit in 32 bits.
inline bool launchable(int batch, int seq, int heads, int head_dim,
                       long long in_token, long long out_token) {
  return batch > 0 && seq > 0 && heads > 0 && heads <= 65535 &&
         head_dim > 0 && head_dim <= kMaxHeadDim &&
         (seq + kTile - 1) / kTile <= 65535 && in_token > 0 &&
         in_token <= 0x7fffffff && out_token > 0 && out_token <= 0x7fffffff;
}

// f(std::integral_constant<int, NJ>) for NJ = hd_pad / 16, with hd_pad hd
// rounded up to 32, 64, 96 or 128.
template <typename F>
cudaError_t with_nj(int head_dim, F&& f) {
  if (head_dim <= 32) return f(std::integral_constant<int, 2>{});
  if (head_dim <= 64) return f(std::integral_constant<int, 4>{});
  if (head_dim <= 96) return f(std::integral_constant<int, 6>{});
  return f(std::integral_constant<int, 8>{});
}

// Launch a kernel of this plan on the (B, S/kTile, H) grid with the
// shared memory of head_dim and NJ.
template <int NJ, typename... Params, typename... Args>
cudaError_t launch(void (*kernel)(Params...), int batch, int seq, int heads,
                   int head_dim, cudaStream_t stream, Args... args) {
  const size_t smem = smem_floats(head_dim, 16 * NJ) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(unsigned(batch), unsigned((seq + kTile - 1) / kTile),
                  unsigned(heads));
  kernel<<<grid, kThreads, smem, stream>>>(args...);
  return cudaGetLastError();
}


// ---------------------------------------------------------------------------
// The tensor-core route, for bf16 operands.
namespace tc {

using bf16 = __nv_bfloat16;

constexpr int kRows = 128;    // q rows a block: two warpgroups of 64
constexpr int kKeys = 64;     // keys a K/V tile
constexpr int kThreads = 256;
constexpr int kStages = 2;    // K/V tiles in shared memory

// D: hd padded to the q·kᵀ depth and the p·v width, 32, 64, 80 or 128.
constexpr int padded_head_dim(int head_dim) {
  return head_dim <= 32 ? 32 : head_dim <= 64 ? 64 : head_dim <= 80 ? 80
                                                                    : 128;
}

constexpr int kBiasLd = kKeys + 8;  // a bias tile's row, padded: the
                                    // fragment's reads miss no bank twice

// Shared memory: q (kRows × D, bf16), kStages × (k (kKeys × D), vᵀ
// (D × kKeys), bf16), then for K3 and P1 kStages bias tiles
// (kRows × kBiasLd, in the bias's type of `bias_bytes` bytes).
constexpr size_t smem_bytes(int d, int bias_bytes) {
  return size_t(2) * d * (kRows + 2 * kStages * kKeys) +
         size_t(kStages) * kRows * kBiasLd * bias_bytes;
}

template <int kD>
struct Smem {
  uint16_t* base;
  __device__ uint16_t* q() const { return base; }
  __device__ uint16_t* k(int stage) const {
    return base + kRows * kD + stage * 2 * kKeys * kD;
  }
  __device__ uint16_t* vt(int stage) const { return k(stage) + kKeys * kD; }
  template <typename TB>
  __device__ TB* bias(int stage) const {
    return reinterpret_cast<TB*>(k(kStages)) + stage * kRows * kBiasLd;
  }
};

// A wgmma descriptor of a K-major operand without swizzle: core matrices
// of 8 rows × 16 bytes, `lbo` bytes apart along K, `sbo` bytes apart
// along M or N.
__device__ __forceinline__ uint64_t desc(const uint16_t* p, uint32_t lbo,
                                         uint32_t sbo) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  return uint64_t((a & 0x3FFFF) >> 4) | (uint64_t(lbo >> 4) << 16) |
         (uint64_t(sbo >> 4) << 32);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Keep the compiler from moving reads or writes of r across a wgmma
// issue or wait.
template <int N>
__device__ __forceinline__ void fence_operands(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
// Generic-proxy stores to shared memory made visible to wgmma's reads.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4],
                                         uint64_t db);

// d = a · bᵀ (+ d if accumulate), m64n64k16: A and B K-major in shared
// memory, both named by descriptors.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                            uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_rs<32>(float (&d)[16],
                                           const uint32_t (&a)[4],
                                           uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[32],
                                           const uint32_t (&a)[4],
                                           uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<80>(float (&d)[40],
                                           const uint32_t (&a)[4],
                                           uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39}, "
      "{%40, %41, %42, %43}, %44, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<128>(float (&d)[64],
                                           const uint32_t (&a)[4],
                                           uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
      "%58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]),
        "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]),
        "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]),
        "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// One 64-row tile of a (rows, hd) bf16 operand, hd contiguous, rows
// `token` elements apart, staged in registers. A unit is kVec elements:
// kVec 8 loads 16 bytes (hd % 8 == 0, pointers and strides aligned),
// kVec 1 two. Unit e is the e-th 16-byte row (kVec 8) or element (kVec 1)
// of the K-major core-matrix layout [row / 8][d / 8][row % 8][d % 8], so
// a K-major store is linear and bank-conflict free; rows from `end` on
// and columns from hd on are zeros. Thread t holds units t + kThreads·i;
// where the chunk count allows (kSplit), unit i's (row, d) is unit 0's
// plus constants, so a load is one add to a per-thread base.
template <int kD, int kVec>
struct Staged {
  using U = std::conditional_t<kVec == 8, uint4, uint16_t>;
  static constexpr int kChunks = kD / 8;
  static constexpr int kUnits = kKeys * kD / kVec;
  static constexpr int kPer = (kUnits + kThreads - 1) / kThreads;
  static constexpr bool kSplit =
      kVec == 8 ? 32 % kChunks == 0 : kChunks % 4 == 0;
  U r[kPer];

  __device__ static void where(int e, int& row, int& d) {
    const int u = kVec == 8 ? e : e >> 3;
    row = ((u >> 3) / kChunks) * 8 + (u & 7);
    d = ((u >> 3) % kChunks) * 8 + (kVec == 8 ? 0 : (e & 7));
  }
  // Unit i's (row, d) less unit 0's, where kSplit.
  __device__ static constexpr int row_step(int i) {
    return kVec == 8 ? i * 256 / kChunks : 8 * (i / (kChunks / 4));
  }
  __device__ static constexpr int d_step(int i) {
    return kVec == 8 ? 0 : 32 * (i % (kChunks / 4));
  }
  __device__ static void unit(int i, int row0, int d0, int& row, int& d) {
    if constexpr (kSplit) {
      row = row0 + row_step(i);
      d = d0 + d_step(i);
    } else {
      where(threadIdx.x + i * kThreads, row, d);
    }
  }
  __device__ static constexpr bool exists(int i) {
    return kUnits % kThreads == 0 || i + 1 < kPer;
  }

  __device__ __forceinline__ void load(const bf16* __restrict__ src,
                                       int token, int r0, int end,
                                       int head_dim) {
    int row0, d0;
    where(threadIdx.x, row0, d0);
    const uint16_t* s = reinterpret_cast<const uint16_t*>(src) +
                        (long long)(r0 + row0) * token + d0;
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      int row, d;
      unit(i, row0, d0, row, d);
      const bool in = (exists(i) || threadIdx.x + i * kThreads < kUnits) &&
                      r0 + row < end && d < head_dim;
      const uint16_t* at = s + (long long)(row - row0) * token + (d - d0);
      if constexpr (kVec == 8)
        r[i] = in ? *reinterpret_cast<const uint4*>(at)
                  : make_uint4(0u, 0u, 0u, 0u);
      else
        r[i] = in ? *at : uint16_t(0);
    }
  }

  // Into the K-major layout at dst (q, k).
  __device__ __forceinline__ void store(uint16_t* dst) const {
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int e = threadIdx.x + i * kThreads;
      if (!exists(i) && e >= kUnits) continue;
      if constexpr (kVec == 8)
        reinterpret_cast<uint4*>(dst)[e] = r[i];
      else
        dst[e] = r[i];
    }
  }

  // Transposed, into vᵀ's K-major layout [d / 8][key / 8][d % 8][key % 8]
  // (v).
  __device__ __forceinline__ void store_transposed(uint16_t* dst) const {
    int row0, d0;
    where(threadIdx.x, row0, d0);
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      if (!exists(i) && threadIdx.x + i * kThreads >= kUnits) continue;
      int row, d;
      unit(i, row0, d0, row, d);
      uint16_t* at = dst + (d >> 3) * (8 * kKeys) + (row >> 3) * 64 +
                     (d & 7) * 8 + (row & 7);
      if constexpr (kVec == 8) {
        const uint32_t w[4] = {r[i].x, r[i].y, r[i].z, r[i].w};
#pragma unroll
        for (int j = 0; j < 8; ++j)
          at[j * 8] = uint16_t(w[j >> 1] >> (16 * (j & 1)));
      } else {
        *at = r[i];
      }
    }
  }
};

// q rows q0 .. q0 + kRows into shared memory, rows past S as zeros.
template <int kD, int kVec>
__device__ __forceinline__ void load_q(const bf16* __restrict__ q,
                                       int token, int q0, int seq,
                                       int head_dim, const Smem<kD>& sm) {
#pragma unroll
  for (int half = 0; half < kRows / kKeys; ++half) {
    Staged<kD, kVec> st;
    st.load(q, token, q0 + half * kKeys, seq, head_dim);
    st.store(sm.q() + half * kKeys * kD);
  }
}

// This thread's place in the m64nNk16 accumulator of its warpgroup: rows
// row0 and row0 + 8 of the block's q tile, columns 8j + col0 (+1).
struct Fragment {
  int row0, col0;
  __device__ Fragment()
      : row0(64 * (threadIdx.x >> 7) + 16 * ((threadIdx.x >> 5) & 3) +
             ((threadIdx.x & 31) >> 2)),
        col0(2 * (threadIdx.x & 3)) {}
};
// Accumulator entry 4j + 2h + e lies at row row0 + 8h, column
// 8j + col0 + e.

// s = q kᵀ over this warpgroup's 64 rows and the tile's 64 keys, issued
// and committed, not waited for.
template <int kD>
__device__ __forceinline__ void issue_qk(float (&s)[32], const Smem<kD>& sm,
                                         int stage) {
  const uint16_t* qw = sm.q() + (threadIdx.x >> 7) * 64 * kD;
  fence_operands(s);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk)
    wgmma_ss_n64(s, desc(qw + 128 * kk, 128, 16 * kD),
                 desc(sm.k(stage) + 128 * kk, 128, 16 * kD), kk > 0);
  wgmma_commit();
}

// o += p · v over the tile's 64 keys, p the A fragments, issued and
// committed, not waited for.
template <int kD>
__device__ __forceinline__ void issue_pv(float (&o)[kD / 2],
                                         const uint32_t (&p)[4][4],
                                         const Smem<kD>& sm, int stage) {
  fence_operands(o);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_rs<kD>(o, p[kk], desc(sm.vt(stage) + 128 * kk, 128, 16 * kKeys));
  wgmma_commit();
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// The bias tile of the block's q rows and keys k0 .. k0 + kKeys into
// shared memory: bias_h[row][key] for rows clamped to S − 1 (rows past S
// are never stored) and keys below `end` (the rest is left as it was and
// masked by `logits`). With `async`, 16-byte cp.async copies that land
// while the current tile's products run (each row's 16-byte units
// aligned: S·sizeof(TB), k0·sizeof(TB) and the bias 16-byte aligned, and
// `end` a whole unit); otherwise element by element.
template <typename TB>
__device__ __forceinline__ void copy_bias(const TB* __restrict__ bias_h,
                                          TB* dst, int q0, int k0, int end,
                                          int seq, bool async) {
  if (async) {
    constexpr int kUnit = 16 / sizeof(TB), kPerRow = kKeys / kUnit;
    for (int u = threadIdx.x; u < kRows * kPerRow; u += kThreads) {
      const int r = u / kPerRow, c = (u % kPerRow) * kUnit;
      if (k0 + c < end)
        cp_async16(dst + r * kBiasLd + c,
                   bias_h + (long long)min(q0 + r, seq - 1) * seq + k0 + c);
    }
    cp_async_commit();
  } else {
    for (int e = threadIdx.x; e < kRows * kKeys; e += kThreads) {
      const int r = e / kKeys, c = e % kKeys;
      if (k0 + c < end)
        dst[r * kBiasLd + c] =
            bias_h[(long long)min(q0 + r, seq - 1) * seq + k0 + c];
    }
  }
}

// The bias of this thread's logits in row h at keys 8j + col0 and
// 8j + col0 + 1, from a bias tile: a pair of adjacent keys, one load.
template <typename TB>
__device__ __forceinline__ float2 bias_pair(const TB* tile,
                                            const Fragment& f, int h,
                                            int j) {
  const TB* at = tile + (f.row0 + 8 * h) * kBiasLd + 8 * j + f.col0;
  if constexpr (std::is_same_v<TB, float>) {
    return *reinterpret_cast<const float2*>(at);
  } else {
    const __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(at);
    return make_float2(__low2float(v), __high2float(v));
  }
}

// s = s·scale (+ the bias tile's values) in f32, −inf for keys from `end`
// on. The bias is read from shared memory pair by pair as it is added,
// so it holds no registers across the tile.
template <typename TB, bool kBias>
__device__ __forceinline__ void logits(float (&s)[32], const TB* tile,
                                       const Fragment& f, int k0, int end,
                                       float scale) {
  const bool whole = k0 + kKeys <= end;  // a whole tile: no key to mask
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float2 b = make_float2(0.f, 0.f);
      if constexpr (kBias) b = bias_pair(tile, f, h, j);
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float& x = s[4 * j + 2 * h + e];
        x = kBias ? fmaf(x, scale, e ? b.y : b.x) : x * scale;
        if (!whole && k0 + 8 * j + f.col0 + e >= end) x = -INFINITY;
      }
    }
}

// Blocks an SM for a tensor-core instance: two where their registers
// (≤ 128 a thread, for D ≤ 64) and shared memory (≤ 113 KB: no bias or a
// bf16 one) allow it, so one block's softmax and loads run beside the
// other's products; else one.
template <int kD, typename TB, bool kBias>
constexpr int min_blocks() {
  return kD <= 64 && (!kBias || sizeof(TB) == 2) ? 2 : 1;
}

// The largest of this thread's logits in row h.
__device__ __forceinline__ float thread_max(const float (&s)[32], int h) {
  float x = -INFINITY;
#pragma unroll
  for (int j = 0; j < 8; ++j)
    x = fmaxf(x, fmaxf(s[4 * j + 2 * h], s[4 * j + 2 * h + 1]));
  return x;
}

// Max and sum over the 4 threads that hold one row.
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

constexpr float kLog2e = 1.4426950408889634f;

// s = p = exp(s − m[h]) in place, as exp2((s − m[h])·log2 e): within a few
// ulps of expf, at a third of its instructions. sum[h] = row h's Σp of the
// unrounded p (over the 4 threads of the row); p rounded to bf16 pairs
// into the A fragments of the four k16 steps of p·v: the accumulator's
// entries 8kk .. 8kk + 7 are the k16 step kk's A fragment.
__device__ __forceinline__ void probabilities(float (&s)[32],
                                              const float (&m)[2],
                                              float (&sum)[2],
                                              uint32_t (&p)[4][4]) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float& x = s[4 * j + 2 * h + e];
        x = exp2f((x - m[h]) * kLog2e);
        psum += x;
      }
    sum[h] = quad_sum(psum);
  }
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      p[kk][i] = pack_bf16(s[8 * kk + 2 * i], s[8 * kk + 2 * i + 1]);
}

// o *= alpha[h] in row h.
template <int N>
__device__ __forceinline__ void rescale(float (&o)[N],
                                        const float (&alpha)[2]) {
#pragma unroll
  for (int i = 0; i < N; ++i) o[i] *= alpha[(i >> 1) & 1];
}

// out = o / Σp for rows below S and columns below hd, as bf16.
template <int kD>
__device__ __forceinline__ void store(bf16* __restrict__ out, int token,
                                      int q0, int seq, int head_dim,
                                      const Fragment& f,
                                      const float (&o)[kD / 2],
                                      const float (&l)[2]) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = q0 + f.row0 + 8 * h;
    if (r >= seq) continue;
#pragma unroll
    for (int j = 0; j < kD / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int d = 8 * j + f.col0 + e;
        if (d < head_dim)
          out[(long long)r * token + d] =
              __float2bfloat16(o[4 * j + 2 * h + e] / l[h]);
      }
  }
}

// Whether the 16-byte loads apply: hd % 8 == 0 and every operand's base
// and element strides 16-byte aligned.
inline bool wide_loads(int head_dim, const Strides& st,
                       std::initializer_list<const void*> ptrs) {
  if (head_dim % 8 || st.window % 8 || st.head % 8 || st.token % 8)
    return false;
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) % 16) return false;
  return true;
}

// f(std::integral_constant<int, D>) for D = padded_head_dim(hd).
template <typename F>
cudaError_t with_depth(int head_dim, F&& f) {
  switch (padded_head_dim(head_dim)) {
    case 32: return f(std::integral_constant<int, 32>{});
    case 64: return f(std::integral_constant<int, 64>{});
    case 80: return f(std::integral_constant<int, 80>{});
    default: return f(std::integral_constant<int, 128>{});
  }
}

// f(std::integral_constant<int, kVec>) for 16-byte (8) or 2-byte (1)
// loads.
template <typename F>
cudaError_t with_vec(bool wide, F&& f) {
  return wide ? f(std::integral_constant<int, 8>{})
              : f(std::integral_constant<int, 1>{});
}

// Whether copy_bias may use 16-byte copies: the bias 16-byte aligned, a
// row a whole number of 16-byte units, and so is `chunk`, the distance
// between the ends that keys are masked at (S for K3).
inline bool bias_async(const void* bias, int seq, int chunk, int esize) {
  return reinterpret_cast<uintptr_t>(bias) % 16 == 0 &&
         (seq * esize) % 16 == 0 && (chunk * esize) % 16 == 0;
}

// Launch a kernel of this plan on the (B, S/kRows, H) grid with D's
// shared memory and bias tiles of `bias_bytes` (0: none).
template <int kD, typename... Params, typename... Args>
cudaError_t launch(void (*kernel)(Params...), int bias_bytes, int batch,
                   int seq, int heads, cudaStream_t stream, Args... args) {
  const size_t smem = smem_bytes(kD, bias_bytes);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(unsigned(batch), unsigned((seq + kRows - 1) / kRows),
                  unsigned(heads));
  kernel<<<grid, kThreads, smem, stream>>>(args...);
  return cudaGetLastError();
}

}  // namespace tc

// The plan ops/cuda_attention.py::long_plan made, as the C entry points
// take it: route (1 tensor cores, 0 scalar), q rows a block, q·kᵀ depth,
// p·v width, K/V stages, dynamic shared memory in bytes.
struct Plan {
  int tensor_cores, rows, depth, width, stages, smem;
};

// The plan for hd, the operands' type and the bias's size in bytes (0:
// none), as long_plan makes it.
inline Plan plan_for(int head_dim, bool bf16, int bias_bytes) {
  if (bf16) {
    const int d = tc::padded_head_dim(head_dim);
    return {1, tc::kRows, d, d, tc::kStages,
            int(tc::smem_bytes(d, bias_bytes))};
  }
  int nj = 8;
  if (head_dim <= 32) nj = 2;
  else if (head_dim <= 64) nj = 4;
  else if (head_dim <= 96) nj = 6;
  return {0, kTile, head_dim, 16 * nj, 1,
          int(smem_floats(head_dim, 16 * nj) * sizeof(float))};
}

// Whether the caller's plan is this one.
inline bool plan_ok(const int* plan, int head_dim, bool bf16,
                    int bias_bytes) {
  const Plan p = plan_for(head_dim, bf16, bias_bytes);
  return plan && plan[0] == p.tensor_cores && plan[1] == p.rows &&
         plan[2] == p.depth && plan[3] == p.width && plan[4] == p.stages &&
         plan[5] == p.smem;
}

}  // namespace attn_tiles
}  // namespace fastervit
