// The bf16 tensor-core attention core shared by the flash kernel
// (flash_attention.cu) and the chunked-prefill kernel
// (paged_attention.cu), for Hopper (sm_90a).
//
// What it computes: for the block's query rows, softmax(q k^T * D^-0.5)
// v over the keys a loader names, causal and windowed in absolute
// positions (a query at qpos sees key kpos iff kpos <= k_max, (not
// causal or kpos <= qpos) and (window <= 0 or qpos - kpos < window)),
// with an online softmax across key tiles, f32 scores, statistics and
// accumulator, and the softmax weights rounded to bf16 before the PV
// product (the Pallas kernel's flash.py:76-79).  A row that sees no key
// returns 0 (l clamped to 1e-30, flash.py:84-85).
//
// Rows.  A warp group (4 warps) holds 64 rows: queries times the n_rep
// query heads of one KV head (GQA packing: 8 queries x 8 heads at
// yi-6b's 32/4), so each K/V tile is read once per query group.  Warp w
// holds rows 16w .. 16w + 15; at n_rep 8 one 16-row fragment spans two
// queries, so masks are per row.
//
// Products.  Both run on the tensor cores as warp-group wgmma
// (m64nNk16, bf16 in, f32 accumulate): S = Q K^T with Q and K read
// from shared memory through matrix descriptors, and O += P V with P
// taken from the S accumulator, rounded to bf16 in registers (no
// shared-memory round trip), and V read from shared memory as an
// MN-major operand.  Row maxima are reduced over the quad of lanes
// that holds a row; row sums stay per lane until the end.  The
// contraction is padded with zero columns to a multiple of 16 (D 120 ->
// 128); output columns past D are not stored.
//
// Data movement.  Q, K and V sit in shared memory as bf16 in a wgmma
// layout (see Tile: 128-byte swizzle from D_pad 64 up).  K/V tiles
// fill a two-stage ring by 16-byte cp.async copies (zero-filled past
// the block's key range), so the next stage loads while this one
// computes.  D not a multiple of 8, or an unaligned pointer or stride,
// takes plain element loads into the same layout.
//
// Filling the card (launch_kd).  A block is two warp groups (8 warps,
// one block per SM).  They hold 128 rows (MR 2, so each K/V tile
// serves twice the rows) while that gives the grid 7/8 of a block per
// SM; with fewer query tiles they hold the same 64 rows and split each
// stage's keys (NG 2), combining their (m, l, O) through shared memory
// at the end.  At the chunked engine's B 1 x T 256 chunk with 32/4
// heads that is NG 2: 32 query tiles x 4 KV heads = 128 blocks; flash
// at the 512-token bucket and up is MR 2.  Causal blocks start
// heaviest first.
//
// Shared memory: (64 MR + 4 NG KN) rows of D_pad bf16, KN the keys per
// warp-group tile (tile_keys: 128 at MR 2, 64 at NG 2, 32 above D_pad
// 128): at D 128, 163,840 bytes at MR 2 and 147,456 at NG 2.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

namespace attn_core {

typedef __nv_bfloat16 bf16;

constexpr int kRows = 64;            // query rows per block
constexpr int kGroupThreads = 128;   // one warp group: 4 warps x 16 rows
constexpr int NS = 2;                // stages in the K/V ring
constexpr size_t kMaxSmem = 232448;  // per-block dynamic shared memory

// What a block attends, set up by its kernel from its own arguments.
struct Params {
  const bf16* q;        // this block's batch row: (t, h, d) at
  bf16* out;            //   t * q_ss + h * q_sh + d, out alike
  long long q_ss, q_sh;
  int Sq;               // queries in the row
  int n_rep;            // query heads per KV head
  int kvh;              // the block's KV head
  int D;
  int qt;               // the block's query tile
  int qpos0;            // absolute position of query 0
  int k_max;            // last key position that exists
  int causal, window;
  float scale_log2;     // D^-0.5 * log2(e)
  int vec;              // 16-byte copies allowed
};

// Keys of a contiguous (S, D) slice at stride ss (flash).
struct ContigLoader {
  const bf16* k;
  const bf16* v;
  long long ss;
  __device__ __forceinline__ long long offset(int kpos) const {
    return (long long)kpos * ss;
  }
};

// Keys through a block table over a flat (N, ps, KV, D) pool (chunked
// prefill): position kpos sits in row table[kpos / ps], token kpos % ps.
struct PagedLoader {
  const bf16* k;        // pool base + kvh * D
  const bf16* v;
  const int* table;     // the slot's (P,) row of the block tables
  int ps;
  long long token;      // KV * D: one token's stride in the pool
  __device__ __forceinline__ long long offset(int kpos) const {
    const int p = kpos / ps;
    return ((long long)table[p] * ps + (kpos - p * ps)) * token;
  }
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; zero-filled without a read when !fill
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool fill) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::
                   "r"(smem_u32(dst)), "l"(src), "r"(fill ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// this thread's shared-memory writes become visible to wgmma
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Pins an accumulator register in place across the asynchronous wgmma:
// no read or write of it moves over this point.
__device__ __forceinline__ void fence_reg(float& r) {
  asm volatile("" : "+f"(r)::"memory");
}

// Matrix descriptor of an operand at `p`: `lead` and `stride` byte
// offsets, `swizzle` the layout type (0 none, 1 128-byte).
__device__ __forceinline__ uint64_t desc(const void* p, uint32_t lead,
                                         uint32_t stride, int swizzle) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) |
         ((uint64_t)(lead >> 4) << 16) | ((uint64_t)(stride >> 4) << 32) |
         ((uint64_t)swizzle << 62);
}

// d (64 x N per warp group, f32) = [d +] a (64 x 16) * b (16 x N):
// wgmma_ss_nN with a and b in shared memory, both K-major; wgmma_rs_nN
// with a in registers (the mma.sync A fragment of the warp's 16 rows)
// and b MN-major.  acc = 0 drops the old d.
__device__ __forceinline__ void wgmma_ss_n32(float* d, uint64_t a,
                                             uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(acc));
}

__device__ __forceinline__ void wgmma_ss_n64(float* d, uint64_t a,
                                             uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(acc));
}

__device__ __forceinline__ void wgmma_rs_n16(float* d,
                                             const uint32_t (&a)[4],
                                             uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      :  "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
}

__device__ __forceinline__ void wgmma_rs_n32(float* d,
                                             const uint32_t (&a)[4],
                                             uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      :  "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
}

__device__ __forceinline__ void wgmma_rs_n64(float* d,
                                             const uint32_t (&a)[4],
                                             uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      :  "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
}

__device__ __forceinline__ void wgmma_rs_n128(float* d,
                                             const uint32_t (&a)[4],
                                             uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      :  "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
}

__device__ __forceinline__ void wgmma_ss_n128(float* d, uint64_t a,
                                              uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(acc));
}

template <int N>
__device__ __forceinline__ void wgmma_ss(float* d, uint64_t a, uint64_t b,
                                         int acc) {
  if constexpr (N == 32) wgmma_ss_n32(d, a, b, acc);
  else if constexpr (N == 64) wgmma_ss_n64(d, a, b, acc);
  else wgmma_ss_n128(d, a, b, acc);
}

template <int N>
__device__ __forceinline__ void wgmma_rs(float* d, const uint32_t (&a)[4],
                                         uint64_t b, int acc) {
  static_assert(N == 16 || N == 32 || N == 64 || N == 128, "PV width");
  if constexpr (N == 16) wgmma_rs_n16(d, a, b, acc);
  else if constexpr (N == 32) wgmma_rs_n32(d, a, b, acc);
  else if constexpr (N == 64) wgmma_rs_n64(d, a, b, acc);
  else wgmma_rs_n128(d, a, b, acc);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// exp2 on the special-function unit (2 ulp; flushes subnormal results,
// weights below 2^-126 that a bf16 PV product rounds away anyway)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// The tiles of a head dim padded to 16 KD: their sizes, where (row r,
// column c) of a tile of `rows` rows sits in shared memory, and the
// wgmma descriptors that read it.  From D_pad 64 up:
// 128-byte swizzle, the columns in blocks of 64 (128-byte rows, block
// after block), 16-byte chunk j of row r stored at j ^ (r % 8) (the
// tiles are 1024-byte aligned).  Below: no swizzle, 8 x 8 core matrices
// of 128 contiguous bytes, the columns fastest.  K and V share one
// layout: K is read K-major, V MN-major.
template <int KD>
struct Tile {
  static constexpr int DP = 16 * KD;                // padded head dim
  static constexpr int CQ = DP / 8;                 // 16-byte chunks per row
  static constexpr int PVN = DP < 128 ? DP : 128;   // PV product width
  static constexpr bool kSw = KD >= 4;

  __device__ static __forceinline__ int off(int r, int c, int rows) {
    if constexpr (kSw)
      return (c >> 6) * rows * 64 + r * 64 +
             ((((c >> 3) & 7) ^ (r & 7)) << 3) + (c & 7);
    else
      return ((r >> 3) * CQ + (c >> 3)) * 64 + (r & 7) * 8 + (c & 7);
  }
  // rows r0 .. r0 + 63 (A) or r0 .. r0 + N - 1 (B), contraction
  // columns 16 kd .. 16 kd + 15
  __device__ static __forceinline__ uint64_t k_major(const bf16* t, int rows,
                                                     int r0, int kd) {
    if constexpr (kSw)
      return desc(t + (kd >> 2) * rows * 64 + r0 * 64 + (kd & 3) * 16, 16,
                  1024, 1);
    else
      return desc(t + r0 * DP + kd * 128, 128, CQ * 128, 0);
  }
  // keys r0 + 16 kk .. + 15 (the contraction) by columns h PVN ..
  // (h + 1) PVN - 1
  __device__ static __forceinline__ uint64_t mn_major(const bf16* t, int rows,
                                                      int r0, int kk, int h) {
    if constexpr (kSw)
      return desc(t + h * (PVN / 64) * rows * 64 + (r0 + 16 * kk) * 64,
                  rows * 128, 1024, 1);
    else
      return desc(t + (r0 + 16 * kk) * DP + h * (PVN / 8) * 64, CQ * 128,
                  128, 0);
  }
};

// Queries per block: 64 MR rows over n_rep heads, at most the row's.
__host__ __device__ inline int block_queries(int mr, int n_rep, int sq) {
  const int bq = kRows * mr / n_rep;
  return bq < sq ? bq : sq;
}

// Keys per warp-group tile: 128 (fewer stages, each with its fixed
// cost of a barrier and two waits) where the registers and shared
// memory allow it.
template <int KD, int NG>
__host__ __device__ constexpr int tile_keys() {
  return KD > 8 ? 32 : (NG == 2 ? 64 : 128);
}

template <int KD, int MR, int NG>
constexpr size_t smem_bytes() {
  return sizeof(bf16) *
         (size_t)(kRows * MR + 2 * NS * NG * tile_keys<KD, NG>()) *
         Tile<KD>::DP;
}

// The block's attention: rows of query tile p.qt, keys from `L`.  Its
// two warp groups (MR x NG = 2): group g holds rows 64 (g % MR) .. + 63
// and takes keys KN (g / MR) .. + KN - 1 of each stage.
template <int KD, int MR, int NG, class Loader>
__device__ __forceinline__ void attend(const Params& p, const Loader& L) {
  static_assert(MR * NG == 2, "two warp groups");
  constexpr int DP = Tile<KD>::DP, CQ = Tile<KD>::CQ;
  constexpr int KN = tile_keys<KD, NG>();
  constexpr int BR = kRows * MR;      // rows per block
  constexpr int NT = kGroupThreads * MR * NG;
  constexpr int NKS = NG * KN;        // keys per stage
  constexpr int NS8 = KN / 2;         // S accumulator floats per lane
  constexpr int NO = DP / 2;          // O accumulator floats per lane
  constexpr int PVN = Tile<KD>::PVN;
  using Lay = Tile<KD>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);   // BR x DP
  bf16* ks = qs + BR * DP;                        // [NS][NKS] x DP
  bf16* vs = ks + NS * NKS * DP;                  // [NS][NKS] x DP

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rg = (warp >> 2) % MR, grp = (warp >> 2) / MR;
  const int wr = rg * kRows + (warp & 3) * 16;
  const int n_rep = p.n_rep, D = p.D;
  const int BQ = block_queries(MR, n_rep, p.Sq), R = BQ * n_rep;
  const int t0 = p.qt * BQ;
  const int t_end = min(t0 + BQ, p.Sq);
  const int k_hi = p.causal ? min(p.k_max, p.qpos0 + t_end - 1) : p.k_max;
  const int k_lo = p.window > 0 ? max(0, p.qpos0 + t0 - p.window + 1) : 0;
  const int n_st = k_hi >= k_lo ? (k_hi - k_lo) / NKS + 1 : 0;
  const float sl2 = p.scale_log2;

  if (Lay::kSw && (smem_u32(smem_raw) & 1023)) __trap();

  // zero the padded columns once: the loads never write them
  if (D < DP) {
    const int pw = DP - D;
    for (int i = tid; i < BR * pw; i += NT)
      qs[Lay::off(i / pw, D + i % pw, BR)] = __float2bfloat16(0.f);
    for (int i = tid; i < 2 * NS * NKS * pw; i += NT) {
      const int r = i / pw;
      ks[(r / NKS) * NKS * DP + Lay::off(r % NKS, D + i % pw, NKS)] =
          __float2bfloat16(0.f);
    }
  }

  auto q_row = [&](int r) -> const bf16* {   // null past the block's rows
    const int t = t0 + r / n_rep;
    if (r >= R || t >= p.Sq) return nullptr;
    return p.q + t * p.q_ss + (long long)(p.kvh * n_rep + r % n_rep) * p.q_sh;
  };
  // 16-byte copies: this thread's chunk of each row it loads, every
  // RSTEP-th row (D < D_pad leaves the last chunks to the zeroed pad)
  constexpr int RSTEP = NT / CQ;
  static_assert(NT % CQ == 0, "a pass must cover whole rows");
  const int lc = tid % CQ, lr = tid / CQ;
  const bool chunk_live = lc * 8 < D;
  auto load_q = [&]() {
    if (p.vec) {
#pragma unroll
      for (int r = lr; r < BR; r += RSTEP) {
        const bf16* src = q_row(r);
        if (chunk_live)
          cp_async16(qs + Lay::off(r, lc * 8, BR),
                     src ? src + lc * 8 : p.q, src);
      }
    } else {
      for (int i = tid; i < BR * D; i += NT) {
        const int r = i / D, d = i - r * D;
        const bf16* src = q_row(r);
        qs[Lay::off(r, d, BR)] = src ? src[d] : __float2bfloat16(0.f);
      }
    }
  };
  auto load_kv = [&](int buf, int kbase) {
    bf16* kd = ks + buf * NKS * DP;
    bf16* vd = vs + buf * NKS * DP;
    if (p.vec) {
#pragma unroll
      for (int j = lr; j < NKS; j += RSTEP) {
        const int kpos = kbase + j;
        const bool ok = kpos <= k_hi;
        const long long off = (ok ? L.offset(kpos) : 0) + lc * 8;
        if (chunk_live) {
          cp_async16(kd + Lay::off(j, lc * 8, NKS), L.k + off, ok);
          cp_async16(vd + Lay::off(j, lc * 8, NKS), L.v + off, ok);
        }
      }
    } else {
      for (int i = tid; i < NKS * D; i += NT) {
        const int j = i / D, d = i - j * D;
        const int kpos = kbase + j;
        const bf16 z = __float2bfloat16(0.f);
        const long long off = kpos <= k_hi ? L.offset(kpos) + d : -1;
        kd[Lay::off(j, d, NKS)] = off >= 0 ? L.k[off] : z;
        vd[Lay::off(j, d, NKS)] = off >= 0 ? L.v[off] : z;
      }
    }
  };

  // this lane's two rows (g and g + 8 of the warp's fragment), and the
  // keys visible to every row of the warp (no mask needed there)
  int qpos[2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
    qpos[i] = p.qpos0 + t0 + (wr + 8 * i + (lane >> 2)) / n_rep;
  const int w_tlo = t0 + wr / n_rep;
  const int w_thi = min(t0 + min(wr + 15, R - 1) / n_rep, t_end - 1);
  const bool warp_live = wr < R && w_tlo < t_end;
  const int f_hi = p.causal ? min(k_hi, p.qpos0 + w_tlo) : k_hi;
  const int f_lo =
      p.window > 0 ? max(k_lo, p.qpos0 + w_thi - p.window + 1) : k_lo;

  float o[NO], sc[NS8];
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < NO; ++i) o[i] = 0.f;

  // the ring: stage s sits in buffer s % NS; one barrier per stage
  // frees the buffer of stage s - 1 for stage s + NS - 1
  load_q();
#pragma unroll
  for (int i = 0; i < NS - 1; ++i) {
    if (i < n_st) load_kv(i, k_lo + i * NKS);
    cp_async_commit();
  }

  for (int s = 0; s < n_st; ++s) {
    cp_async_wait<NS - 2>();   // Q and stage s have landed
    fence_proxy_async();
    __syncthreads();
    if (s + NS - 1 < n_st)
      load_kv((s + NS - 1) % NS, k_lo + (s + NS - 1) * NKS);
    cp_async_commit();
    const int kt = k_lo + s * NKS + grp * KN;    // the group's first key
    if (kt > k_hi) continue;                     // the same for the group
    const bf16* kst = ks + (s % NS) * NKS * DP;   // the stage's tiles
    const bf16* vst = vs + (s % NS) * NKS * DP;

    // S = Q K^T, one wgmma per 16 columns of the contraction
    wgmma_fence();
#pragma unroll
    for (int kd = 0; kd < KD; ++kd)
      wgmma_ss<KN>(sc, Lay::k_major(qs, BR, rg * kRows, kd),
                   Lay::k_major(kst, NKS, grp * KN, kd), kd);
    wgmma_commit();
    wgmma_wait();
#pragma unroll
    for (int i = 0; i < NS8; ++i) fence_reg(sc[i]);

    // mask unless every row of the warp sees the whole tile
    if (!(kt >= f_lo && kt + KN - 1 <= f_hi)) {
#pragma unroll
      for (int i = 0; i < NS8; ++i) {
        const int kpos = kt + (i >> 2) * 8 + (lane & 3) * 2 + (i & 1);
        const int qp = qpos[(i >> 1) & 1];
        if (kpos > k_hi || (p.causal && kpos > qp) ||
            (p.window > 0 && qp - kpos >= p.window))
          sc[i] = -INFINITY;
      }
    }

    // online softmax in log2 units (s * scale * log2 e); the row sum
    // takes p unrounded
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = -INFINITY;
#pragma unroll
      for (int n = 0; n < NS8 / 4; ++n)
        mx = fmaxf(mx, fmaxf(sc[4 * n + 2 * r], sc[4 * n + 2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[r], mx);
      const float m_use = m_new == -INFINITY ? 0.f : m_new * sl2;
      const float corr = ex2(m[r] * sl2 - m_use);
      m[r] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int n = 0; n < NS8 / 4; ++n)
#pragma unroll
        for (int e = 2 * r; e < 2 * r + 2; ++e) {
          const float pe = ex2(fmaf(sc[4 * n + e], sl2, -m_use));
          sc[4 * n + e] = pe;
          sum += pe;
        }
      l[r] = l[r] * corr + sum;
#pragma unroll
      for (int n = 0; n < NO / 4; ++n) {
        o[4 * n + 2 * r] *= corr;
        o[4 * n + 2 * r + 1] *= corr;
      }
    }

    // O += P V: P rounded to bf16 in registers as the A operand, 16
    // keys per wgmma
    uint32_t pa[KN / 16][4];
#pragma unroll
    for (int kk = 0; kk < KN / 16; ++kk) {
      pa[kk][0] = pack_bf16(sc[8 * kk], sc[8 * kk + 1]);
      pa[kk][1] = pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]);
      pa[kk][2] = pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]);
      pa[kk][3] = pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7]);
    }
#pragma unroll
    for (int i = 0; i < NO; ++i) fence_reg(o[i]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KN / 16; ++kk)
#pragma unroll
      for (int h = 0; h < DP / PVN; ++h)
        wgmma_rs<PVN>(o + h * (PVN / 2), pa[kk],
                      Lay::mn_major(vst, NKS, grp * KN, kk, h), 1);
    wgmma_commit();
    wgmma_wait();
#pragma unroll
    for (int i = 0; i < NO; ++i) fence_reg(o[i]);
  }
  cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }

  if constexpr (NG == 2) {
    // the second group's (m, l, O) through shared memory, over the ring
    // and Q once every copy has landed and every warp is past them
    constexpr int G = kGroupThreads;
    float* xo = reinterpret_cast<float*>(smem_raw);  // [NO][G]
    float* xm = xo + NO * G;                         // [2][G]
    float* xl = xm + 2 * G;
    const int gl = tid & (G - 1);
    __syncthreads();
    if (grp == 1) {
#pragma unroll
      for (int i = 0; i < NO; ++i) xo[i * G + gl] = o[i];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        xm[r * G + gl] = m[r];
        xl[r * G + gl] = l[r];
      }
    }
    __syncthreads();
    if (grp == 1) return;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m2 = xm[r * G + gl];
      const float mn = fmaxf(m[r], m2);
      const float mu = mn == -INFINITY ? 0.f : mn * sl2;
      const float c1 = ex2(m[r] * sl2 - mu), c2 = ex2(m2 * sl2 - mu);
      l[r] = l[r] * c1 + xl[r * G + gl] * c2;
#pragma unroll
      for (int n = 0; n < NO / 4; ++n)
#pragma unroll
        for (int e = 2 * r; e < 2 * r + 2; ++e)
          o[4 * n + e] = o[4 * n + e] * c1 + xo[(4 * n + e) * G + gl] * c2;
    }
  }

  if (!warp_live) return;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const bf16* src = q_row(wr + 8 * r + (lane >> 2));
    if (!src) continue;
    bf16* orow = p.out + (src - p.q);
    const float inv = 1.f / fmaxf(l[r], 1e-30f);
#pragma unroll
    for (int n = 0; n < NO / 4; ++n) {
      const int col = n * 8 + (lane & 3) * 2;
      const float x0 = o[4 * n + 2 * r] * inv, x1 = o[4 * n + 2 * r + 1] * inv;
      if (p.vec) {
        if (col < D)
          *reinterpret_cast<__nv_bfloat162*>(orow + col) =
              __floats2bfloat162_rn(x0, x1);
      } else {
        if (col < D) orow[col] = __float2bfloat16(x0);
        if (col + 1 < D) orow[col + 1] = __float2bfloat16(x1);
      }
    }
  }
}

// One block: its Problem sets up the rows and the loader from its
// arguments (Problem::Input) and blockIdx.
template <class Problem, int KD, int MR, int NG>
__global__ void __launch_bounds__(kGroupThreads * MR * NG, 1)
tc_kernel(const typename Problem::Input a) {
  Params p;
  typename Problem::Loader L;
  Problem::setup(a, p, L);
  attend<KD, MR, NG>(p, L);
}

constexpr int kMaxDevices = 64;

// The current device and its SM count, looked up once per device.
inline cudaError_t device_sms(int* dev, int* sms) {
  static int cached[kMaxDevices];
  cudaError_t err = cudaGetDevice(dev);
  if (err != cudaSuccess || *dev >= kMaxDevices) return cudaErrorInvalidValue;
  if (!cached[*dev]) {
    err = cudaDeviceGetAttribute(&cached[*dev],
                                 cudaDevAttrMultiProcessorCount, *dev);
    if (err != cudaSuccess) return err;
  }
  *sms = cached[*dev];
  return cudaSuccess;
}

template <class Problem, int KD, int MR, int NG>
cudaError_t launch_cfg(const typename Problem::Input& a, dim3 grid, int dev,
                       cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<KD, MR, NG>();
  static_assert(smem <= kMaxSmem, "tile does not fit in shared memory");
  auto kern = tc_kernel<Problem, KD, MR, NG>;
  static bool smem_set[kMaxDevices];   // the attribute, once per device
  if (!smem_set[dev]) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    smem_set[dev] = true;
  }
  kern<<<grid, kGroupThreads * MR * NG, smem, stream>>>(a);
  return cudaGetLastError();
}

// Grid (query tiles, KV, B) of blocks of two warp groups: on 128 rows
// (MR 2, so each K/V tile serves twice the rows) while that gives 7/8
// of a block per SM, else on 64 rows splitting each stage's keys
// (NG 2), which doubles the blocks.
template <class Problem, int KD>
cudaError_t launch_kd(const typename Problem::Input& a, int Sq, int n_rep,
                      int KV, int B, cudaStream_t stream) {
  int dev = 0, sms = 0;
  cudaError_t err = device_sms(&dev, &sms);
  if (err != cudaSuccess) return err;
  auto grid = [&](int mr) {
    const int bq = block_queries(mr, n_rep, Sq);
    return dim3((Sq + bq - 1) / bq, KV, B);
  };
  auto blocks = [](dim3 g) { return (long long)g.x * g.y * g.z; };
  if (8 * blocks(grid(2)) >= 7LL * sms)
    return launch_cfg<Problem, KD, 2, 1>(a, grid(2), dev, stream);
  return launch_cfg<Problem, KD, 1, 2>(a, grid(1), dev, stream);
}

// Launch for head dim D (at most 256; the contraction is padded to 16,
// 32, 64, 128 or 256) and n_rep at most 64.
template <class Problem>
cudaError_t launch(const typename Problem::Input& a, int Sq, int n_rep,
                   int KV, int B, int D, cudaStream_t stream) {
  if (n_rep < 1 || n_rep > kRows) return cudaErrorInvalidValue;
  const int kd = (D + 15) / 16;
  if (kd <= 1) return launch_kd<Problem, 1>(a, Sq, n_rep, KV, B, stream);
  if (kd <= 2) return launch_kd<Problem, 2>(a, Sq, n_rep, KV, B, stream);
  if (kd <= 4) return launch_kd<Problem, 4>(a, Sq, n_rep, KV, B, stream);
  if (kd <= 8) return launch_kd<Problem, 8>(a, Sq, n_rep, KV, B, stream);
  if (kd <= 16) return launch_kd<Problem, 16>(a, Sq, n_rep, KV, B, stream);
  return cudaErrorInvalidValue;
}

// 16-byte copies need D a multiple of 8 and 16-byte aligned rows
inline bool aligned16(const void* ptr) {
  return reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
}

}  // namespace attn_core
