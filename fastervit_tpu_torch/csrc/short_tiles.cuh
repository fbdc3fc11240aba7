// The warpgroup steps shared by the short-window attention kernels' bf16
// routes on Hopper's tensor cores: K1 (window_mhsa.cu, S <= 128) and K2
// (window_mhsa_bwd.cu, S <= 64), both hd <= 64. Also the plans of both
// kernels' two routes, which ops/cuda_attention.py::short_plan and
// short_bwd_plan make and the C entry points check.
//
// A block owns one head and a run of windows; each of its warpgroups (128
// threads) owns one window at a time, the windows of the run in turn. A
// window's M = 64 q rows (two slabs for 64 < S <= 128) fit one wgmma tile
// and its keys one (or two) 64-key tiles, so the softmax is exact in
// registers: no running max, no rescaling, no statistics pass.
//
// The head's bias is read once a block, not once a window: into shared
// memory as f32 (a bf16 bias widened exactly) in the order of the S
// accumulator's fragment, [tile][j][thread][4], so each thread reads its 32
// values of a 64×64 tile as eight conflict-free float4 loads. Keys from S on
// hold −inf there and rows from S on 0, so no key is masked in the loop and
// no row's max is −inf.
//
// Every bf16 operand of a window, q, k, v (and K2's g), lies in shared
// memory in the core-matrix layout [token / 8][d / 8][token % 8][d % 8]
// (8 × 16-byte core matrices, no swizzle), hd padded with zeros to
// D = 32 or 64. That one layout is K-major for the products whose depth is
// d (q·kᵀ, g·vᵀ) and MN-major for those whose depth is the token (p·v,
// dl·k, dlᵀ·q, Pᵀ·g), which wgmma reads with its transpose bits. So no
// operand is transposed or stored twice. K2's P and dl, rounded to bf16,
// go to shared memory once each in the same layout over [row][key], where
// they are the MN-major A operands of dlᵀ·q and Pᵀ·g. The padding (rows
// from S on, columns from hd on) is zeroed once a block; a window writes
// only its rows below S and columns below hd, so the zeros stay.
//
// The next window's operands come into the warpgroup's other shared-memory
// stage while the current one computes: by 16-byte cp.async where hd % 8
// == 0 and every address is 16-byte aligned ("wide": hd 32, 40, 48, 64),
// else by two-byte loads and stores (hd 49). One bar.sync of the
// warpgroup's own 128 threads a window (two in K2), never of the block.
#pragma once

#include <cmath>
#include <cstddef>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "attn_tiles.cuh"

namespace fastervit {
namespace short_tiles {

namespace tc = attn_tiles::tc;
using tc::bf16;

constexpr int kTile = 64;        // a slab's q rows, a key tile's keys
constexpr int kWgThreads = 128;  // a warpgroup
constexpr int kStages = 2;       // a warpgroup's operand stages
constexpr int kFwdWarpgroups = 2;      // K1's warpgroups a block, S <= 64
constexpr int kFwdLongWarpgroups = 1;  // K1's warpgroups a block, S > 64
constexpr int kBwdWarpgroups = 2;      // K2's warpgroups a block

// D: hd padded to the products' depth or width.
__host__ __device__ constexpr int depth(int head_dim) {
  return head_dim <= 32 ? 32 : 64;
}
// Row slabs and key tiles of a window of S tokens.
__host__ __device__ constexpr int tiles(int seq) {
  return seq <= kTile ? 1 : 2;
}

__host__ __device__ constexpr int fwd_warpgroups(int r) {
  return r == 1 ? kFwdWarpgroups : kFwdLongWarpgroups;
}
// The f32 bias of a block: r × r tiles of 64 × 64.
__host__ __device__ constexpr size_t bias_bytes(int r) {
  return size_t(r) * r * kTile * kTile * sizeof(float);
}
// K1: a stage holds q, k and v of r slabs (bf16 elements).
__host__ __device__ constexpr size_t fwd_stage_elems(int d, int r) {
  return size_t(3) * r * kTile * d;
}
__host__ __device__ constexpr size_t fwd_smem_bytes(int d, int r) {
  return bias_bytes(r) + size_t(fwd_warpgroups(r)) * kStages *
                             fwd_stage_elems(d, r) * sizeof(bf16);
}
// K2: a stage holds q, k, v and g; a warpgroup also keeps P and dl.
__host__ __device__ constexpr size_t bwd_stage_elems(int d) {
  return size_t(4) * kTile * d;
}
__host__ __device__ constexpr size_t bwd_wg_elems(int d) {
  return kStages * bwd_stage_elems(d) + size_t(2) * kTile * kTile;
}
__host__ __device__ constexpr size_t bwd_smem_bytes(int d) {
  return bias_bytes(1) + size_t(kBwdWarpgroups) * bwd_wg_elems(d) *
                             sizeof(bf16);
}

// The plan ops/cuda_attention.py::short_plan (K1) or short_bwd_plan (K2)
// made, as the C entry points take it: route (1 tensor cores, 0 scalar),
// the padded head dim, key tiles (and row slabs) a window, windows in
// flight a block (one a warpgroup), operand stages, dynamic shared memory
// in bytes.
struct Plan {
  int tensor_cores, depth, key_tiles, windows, stages, smem;
};

inline bool plan_ok(const int* plan, const Plan& p) {
  return plan && plan[0] == p.tensor_cores && plan[1] == p.depth &&
         plan[2] == p.key_tiles && plan[3] == p.windows &&
         plan[4] == p.stages && plan[5] == p.smem;
}

// Whether (heads, groups) blocks of per_block windows each cover the batch,
// every group non-empty, in a grid CUDA can launch.
inline bool grid_ok(int batch, int per_block, int groups) {
  return per_block > 0 && groups > 0 && groups <= 65535 &&
         (long long)per_block * groups >= batch &&
         (long long)per_block * (groups - 1) < batch;
}

// This thread's place in a warpgroup's m64nN accumulator: entry
// 4j + 2h + e at row row0 + 8h, column 8j + col0 + e (t: the thread's
// index in its warpgroup).
struct Frag {
  int row0, col0;
  __device__ explicit Frag(int t)
      : row0(16 * (t >> 5) + ((t & 31) >> 2)), col0(2 * (t & 3)) {}
};

// bar.sync of this warpgroup's 128 threads alone (barrier 1 + wg; 0 is
// __syncthreads').
__device__ __forceinline__ void wg_sync(int wg) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(1 + wg), "n"(kWgThreads)
               : "memory");
}

#define FV_ACC16(d)                                                        \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),        \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
#define FV_ACC32(d)                                                           \
  FV_ACC16(d), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),           \
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),       \
      "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),       \
      "+f"(d[30]), "+f"(d[31])

// d = a·b (+ d where acc), m64n64k16 or m64n32k16 by d's size, A and B in
// shared memory named by descriptors, both MN-major (the transpose bits;
// the K-major product is tc::wgmma_ss_n64).
__device__ __forceinline__ void ss_t(float (&d)[32], uint64_t da,
                                     uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31}, "
      "%32, %33, p, 1, 1, 1, 1;\n}\n"
      : FV_ACC32(d)
      : "l"(da), "l"(db), "r"(acc));
}
__device__ __forceinline__ void ss_t(float (&d)[16], uint64_t da,
                                     uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, "
      "%16, %17, p, 1, 1, 1, 1;\n}\n"
      : FV_ACC16(d)
      : "l"(da), "l"(db), "r"(acc));
}

// d = a·b (+ d where acc), A the four registers of bf16 pairs of a k16
// step (the m64n16 accumulator's layout), B in shared memory, MN-major
// (the transpose bit).
__device__ __forceinline__ void rs_t(float (&d)[32], const uint32_t (&a)[4],
                                     uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : FV_ACC32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
}
__device__ __forceinline__ void rs_t(float (&d)[16], const uint32_t (&a)[4],
                                     uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : FV_ACC16(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
}

#undef FV_ACC32
#undef FV_ACC16

// Descriptors of the core-matrix layout [token / 8][d / 8][token % 8]
// [d % 8] of a 64-token operand with D columns, at its k16 step kk:
// K-major over d (q·kᵀ's A and B: the core matrices 128 bytes apart along
// d, 16·D along the tokens) ...
template <int kD>
__device__ __forceinline__ uint64_t k_major(const uint16_t* op, int kk) {
  return tc::desc(op + 128 * kk, 128, 16 * kD);
}
// ... and MN-major over the tokens (p·v's B, and every B whose depth is the
// token): 16·D bytes apart along the tokens, 128 along d.
template <int kD>
__device__ __forceinline__ uint64_t mn_major(const uint16_t* op, int kk) {
  return tc::desc(op + 16 * kD * kk, 16 * kD, 128);
}

// The 64 × 64 bf16 tile [row / 8][key / 8][row % 8][key % 8] of K2's P and
// dl as the MN-major A of a product over the rows (dlᵀ·q, Pᵀ·g): M the
// keys, 128 bytes apart, K the rows, 1024 bytes apart.
__device__ __forceinline__ uint64_t tile_transposed(const uint16_t* tile,
                                                    int kk) {
  return tc::desc(tile + 1024 * kk, 1024, 128);
}

// Zero n bf16 elements at dst (n a multiple of 8), by every thread of the
// block.
__device__ __forceinline__ void zero(uint16_t* dst, int n) {
  uint4* d = reinterpret_cast<uint4*>(dst);
  for (int i = threadIdx.x; i < n / 8; i += blockDim.x)
    d[i] = make_uint4(0u, 0u, 0u, 0u);
}

// The head's bias into dst as f32, in the fragment order of r × r tiles
// of 64 × 64: entry ((tile·8 + j)·128 + t)·4 + c of thread t's entries
// 4j + c of tile (row slab tile / r, key tile tile % r); −inf for keys
// from S on, 0 for rows from S on. By every thread of the block.
__device__ __forceinline__ void fill_bias(float* dst, const void* bias,
                                          int bias_bf16, int h, int seq,
                                          int r) {
  const long long base = (long long)h * seq * seq;
  for (int e = threadIdx.x; e < r * r * kTile * kTile; e += blockDim.x) {
    const int c = e & 3, t = (e >> 2) & 127, j = (e >> 9) & 7;
    const int tile = e >> 12;
    const Frag f(t);
    const int row = (tile / r) * kTile + f.row0 + 8 * (c >> 1);
    const int key = (tile % r) * kTile + 8 * j + f.col0 + (c & 1);
    float v;
    if (key >= seq) {
      v = -INFINITY;
    } else if (row >= seq) {
      v = 0.f;
    } else {
      const long long at = base + (long long)row * seq + key;
      v = bias_bf16 ? __bfloat162float(static_cast<const bf16*>(bias)[at])
                    : static_cast<const float*>(bias)[at];
    }
    dst[e] = v;
  }
}

// One (window, head) operand's rows below S and columns below hd from src
// (rows `token` elements apart, hd contiguous) into the core-matrix layout
// of kD columns at dst, by the warpgroup's thread t: with `wide`, 16-byte
// cp.async copies that land later (cp_async_wait_all); else two-byte loads
// and stores. The rest of dst is left as it was: the zeros of the padding.
template <int kD>
__device__ __forceinline__ void copy_operand(uint16_t* dst, const bf16* src,
                                             int token, int seq,
                                             int head_dim, bool wide, int t) {
  const uint16_t* s = reinterpret_cast<const uint16_t*>(src);
  if (wide) {
    const int chunks = head_dim >> 3;
    for (int u = t; u < seq * chunks; u += kWgThreads) {
      const int row = u / chunks, c = u - row * chunks;
      tc::cp_async16(dst + ((row >> 3) * (kD / 8) + c) * 64 + (row & 7) * 8,
                     s + (long long)row * token + 8 * c);
    }
  } else {
#pragma unroll 4
    for (int e = t; e < seq * head_dim; e += kWgThreads) {
      const int row = e / head_dim, d = e - row * head_dim;
      dst[((row >> 3) * (kD / 8) + (d >> 3)) * 64 + (row & 7) * 8 + (d & 7)] =
          s[(long long)row * token + d];
    }
  }
}

// The fragment's values o[4j + 2h + e]·mul[h], as bf16, into dst's rows
// r0 + row0 + 8h below S and columns 8j + col0 + e below hd (rows `token`
// elements apart): pairs as one 4-byte store where hd is even.
template <int kD>
__device__ __forceinline__ void store_rows(bf16* dst, int token, int r0,
                                           int seq, int head_dim,
                                           const Frag& f,
                                           const float (&o)[kD / 2],
                                           const float (&mul)[2]) {
  const bool pairs = (head_dim & 1) == 0;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = r0 + f.row0 + 8 * h;
    if (row >= seq) continue;
    bf16* at = dst + (long long)row * token;
#pragma unroll
    for (int j = 0; j < kD / 8; ++j) {
      const int d = 8 * j + f.col0;
      const float x = o[4 * j + 2 * h] * mul[h];
      const float y = o[4 * j + 2 * h + 1] * mul[h];
      if (pairs) {
        if (d < head_dim)
          *reinterpret_cast<__nv_bfloat162*>(at + d) =
              __floats2bfloat162_rn(x, y);
      } else {
        if (d < head_dim) at[d] = __float2bfloat16(x);
        if (d + 1 < head_dim) at[d + 1] = __float2bfloat16(y);
      }
    }
  }
}

// Set a kernel's dynamic shared memory above 48 KB where it needs it.
template <typename K>
cudaError_t allow_smem(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
}

}  // namespace short_tiles
}  // namespace fastervit
