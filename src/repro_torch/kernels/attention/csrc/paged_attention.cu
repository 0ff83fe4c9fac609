// Paged attention over AGAS block tables, for Hopper (sm_90a).
//
// Replaces the two Pallas TPU kernels of the reference package:
//   * src/repro/kernels/attention/paged.py:paged_attention_bhd
//     (decode: one query per slot at positions[b])
//   * src/repro/kernels/attention/paged.py:paged_prefill_attention_btd
//     (chunked prefill: T queries at start[b] .. start[b] + T - 1)
// The plain PyTorch versions they are held against live beside them in
// kernels/attention/ref.py.
//
// What the kernels compute is the Pallas kernels' function, not their
// grid: each query row attends the keys its block table names, causal
// in absolute positions (key j is visible to a query at position q iff
// j <= q and, with a sliding window, q - j < window), GQA head h reading
// KV head h / n_rep, with an online softmax across pages, f32 statistics
// and an f32 accumulator, the softmax weights rounded to the value dtype
// before the PV product (paged.py:86-87) and l clamped to 1e-30 at the
// flush (paged.py:92).  Keys wholly past a query or wholly behind its
// window are never read (paged.py:60-62, :172-174).  All n_rep query
// heads of a KV head sit in one block, so each K/V row is read from
// device memory once per block instead of once per query head as in the
// Pallas grid (B, H, nP).  A sharded (S, R, ps, KV, D) pool arrives as
// the flat (S*R, ps, KV, D) view, whose row index is already the table's
// `locality * R + slot`.  Every block reads its own block-table entries
// (no scalar prefetch).
//
// Decode (flash-decoding).  One query per slot moves the live K/V rows
// once and does ~2 flops per byte: bound by device-memory bytes, so the
// card has to have enough blocks in flight to keep its memory busy.
//   * Grid (splits, KV x row groups, B).  Each (slot, KV head) is split
//     over key ranges of `pages_per_split` pages, a count the wrapper
//     takes from the table width, the page size, the grid and the SM
//     count (paged.py `decode_split_plan`), never from the clocks, so a
//     call reads nothing back to the host and can be captured in a CUDA
//     graph.  At the serve path's B 8 x (8, 128) tables of 16-token
//     pages with 32/4 heads: 8 pages (128 keys) a split, 16 splits, 512
//     blocks on 132 SMs.  A block reads its split's table entries and
//     its slot's clock together as it starts; a split wholly past the
//     clock or wholly behind the window writes an empty partial (m =
//     -inf, l = 0) and exits without touching K/V.
//   * A block is 4 warps.  Warp w takes tiles w, w + 4, ... of its
//     split's live keys through a warp-private ring of shared-memory
//     stages filled by 16-byte cp.async (K and V in their own dtype), so
//     the next tiles are in flight while this one computes and only
//     __syncwarp orders a ring; no block barrier in the key loop.  D *
//     sizeof(T) not a multiple of 16, or an unaligned pool, takes plain
//     element loads into the same layout; a head dim past D is
//     zero-filled.  Each warp keeps its own f32 online softmax (max in
//     log2 units: scores times D^-0.5 log2 e, then exp2) with p rounded
//     to the value dtype before the PV product; the 4 warps merge
//     through shared memory once, at the end, into the split's partial.
//   * bf16 up to D 128 (`decode_mma_kernel`): the block's up to 16
//     query heads (n_rep 8 at yi-6b; rows past n_rep are zero) are the
//     16 rows of mma.sync m16n8k16 (bf16 in, f32 accumulate): per
//     16-key tile S = Q K^T with Q's A fragments held in registers and
//     K's B fragments by ldmatrix, row maxima over each quad of lanes
//     (two shuffles), O += P V with P's A fragments packed from the S
//     accumulators in registers and V's by ldmatrix.trans.  Tiles of 16
//     keys x D padded to 16, rows padded by 16 bytes (conflict-free
//     ldmatrix), 3 stages: 104,448 bytes a block at D 128.  On the
//     CUDA-core route below, bf16 is bound by instruction issue (its
//     dot products, shuffle sums and per-row softmax: 22.5 of its 26.6
//     us a call remain with the loads taken out, tools/decode_probe.py
//     on an H100), which the tensor cores cut to a few instructions a
//     key (12.5 us).
//   * fp32, and bf16 past D 128 (`decode_fma_kernel`): f32 FMAs on the
//     CUDA cores (TF32 cannot hold the reference's 1e-5).  A warp splits
//     into lane groups of G lanes, G the power of two with 8 G >= D:
//     lane c of a group owns head-dim elements 8c .. 8c + 7, keeps up
//     to 8 query rows for them in registers, and its group takes one key
//     a step; scores are the lanes' partial dot products summed by xor
//     shuffles within the group, each group keeps its own softmax, and
//     groups merge by shuffles at the end.  Tiles of 128 / G keys
//     (1024 elements), 4 stages in bf16 and 2 in fp32: 65,536 bytes a
//     block.
//   * Combine (`decode_combine_kernel`), a second small kernel: one
//     block per (slot, head), a thread per head-dim element, reads the
//     splits' (m, l, o) from an f32 workspace that the wrapper takes
//     from PyTorch's caching allocator, B x H x splits x (D + 2) floats
//     (2.13 MB at the serve path), and writes
//       O = sum_i 2^(m_i - M) o_i / max(sum_i 2^(m_i - M) l_i, 1e-30).
//     A second launch rather than the last split combining after an
//     atomic ticket: a ticket needs counters that are zero before every
//     call, i.e. state that outlives the call and that every stream of
//     the device would share, while the second kernel keeps a call
//     self-contained on its stream and in a CUDA graph, for one
//     dependent launch (about 3 us of device time at the serve path).
//   * Rounding.  Each split rounds p against its own running max, so
//     bf16 results differ from the single-pass reference by a bf16 ulp
//     of each weight, the per-element bound chip_smoke.py holds them
//     to; fp32 is held to 1e-5.
//
// Chunked prefill at T = 256 does ~T/2 flops per K/V byte, above the
// card's ~295 flops/byte ridge: bound by operations, on the tensor
// cores.  Its bf16 instantiation runs the tensor-core core of
// attention_core.cuh (shared with the flash kernel) through a
// block-table loader: key kpos of a key tile is looked up in the slot's
// table (page kpos / ps, token kpos % ps) and its D-wide row (256 bytes
// at D 128) copied from the pool by 16-byte cp.async into a two-stage
// bf16 ring; both products as warp-group wgmma.  At the engine's B 1 x
// T 256 chunk with 32/4 heads, 128-row blocks would be 64 for 132 SMs;
// so it launches 128 blocks of 64 rows (32 query tiles x 4 KV heads)
// whose two warp groups split the keys (8 warps per block), heaviest
// query tile first.  fp32 prefill keeps `attend_block`: one block per
// (slot, KV head, query tile of TQ queries x n_rep heads ~ 64 rows)
// walking the live keys in 64-key tiles, f32 FMAs from shared memory
// (TF32 cannot hold the reference's 1e-5).
//
// The build log (-Xptxas -v) gives registers, stack and spills for
// every instantiation, and chip_smoke.py prints those of the tensor-core
// and the decode kernels.  bf16 at D 128 (CUDA 12.8): chunked prefill
// 211 registers and 163,840 bytes of dynamic shared memory on 128 rows,
// 161 and 147,456 with the keys split; decode 127-154 registers; no
// instantiation at D 128 spills or keeps a stack frame.
//
// C interface (ctypes): pointers and the stream are void*, every launch
// returns cudaGetLastError() and the Python wrapper raises when it is
// not cudaSuccess.  dtype: 0 = float32, 1 = bfloat16.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include "attention_core.cuh"

namespace {

constexpr float kNegInf = -1.0e30f;   // the Pallas kernels' NEG_INF
constexpr int kThreads = 256;
constexpr int kTileKeys = 64;         // keys per tile (NPT * ps)
constexpr int kRowsPrefill = 64;      // query rows per prefill block
constexpr size_t kMaxSmem = 232448;   // per-block dynamic shared memory

template <typename T> __device__ __forceinline__ float to_f(T x);
template <> __device__ __forceinline__ float to_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(
    __nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(
    float x) {
  return __float2bfloat16(x);
}

struct Args {
  const void* q;        // (B, Tq, H, D)
  const void* k;        // (N, ps, KV, D)
  const void* v;        // (N, ps, KV, D)
  const int* tables;    // (B, P)
  const int* qstart;    // (B,) absolute position of query 0
  void* out;            // (B, Tq, H, D)
  int B, Tq, H, KV, D, ps, P, window;
  int TQ;               // queries per block
  int NPT;              // pages per tile
  float scale;
  int vec;              // bf16 prefill: 16-byte copies allowed
};

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

size_t smem_bytes(int rows, int keys, int d) {
  const int dp = d + 1;   // padded row: score reads stay conflict-free
  return sizeof(float) * ((size_t)rows * dp + (size_t)keys * dp +
                          (size_t)keys * d + (size_t)rows * keys +
                          (size_t)rows * d + 3 * (size_t)rows);
}

// One fp32 prefill block: query tile `qt` of slot `b`, KV head `kvh`.
template <typename T>
__device__ void attend_block(const Args& a, int b, int kvh, int qt) {
  extern __shared__ float smem[];
  const int n_rep = a.H / a.KV;
  const int R = a.TQ * n_rep;
  const int D = a.D, Dp = D + 1;
  const int KT = a.NPT * a.ps;
  float* qs = smem;               // R x Dp    queries (f32)
  float* ks = qs + R * Dp;        // KT x Dp   keys of the tile
  float* vs = ks + KT * Dp;       // KT x D    values of the tile
  float* ss = vs + KT * D;        // R x KT    scores, then probabilities
  float* acc = ss + R * KT;       // R x D     output accumulator
  float* m = acc + R * D;         // R         running max
  float* l = m + R;               // R         running denominator
  float* corr = l + R;            // R         rescale of this tile

  const T* q = static_cast<const T*>(a.q);
  const T* kp = static_cast<const T*>(a.k);
  const T* vp = static_cast<const T*>(a.v);
  T* out = static_cast<T*>(a.out);
  const int tid = threadIdx.x, nt = blockDim.x;
  const int t0 = qt * a.TQ;
  const int t_end = min(t0 + a.TQ, a.Tq);
  const int start = a.qstart[b];
  const int qpos_min = start + t0;
  const int qpos_max = start + t_end - 1;

  for (int i = tid; i < R * D; i += nt) {
    const int r = i / D, d = i % D;
    const int t = t0 + r / n_rep, h = kvh * n_rep + r % n_rep;
    float x = 0.f;
    if (t < a.Tq) x = to_f(q[(((size_t)b * a.Tq + t) * a.H + h) * D + d]);
    qs[r * Dp + d] = x;
    acc[i] = 0.f;
  }
  for (int r = tid; r < R; r += nt) {
    m[r] = kNegInf;
    l[r] = 0.f;
  }
  // live pages: at or before the last query, not wholly behind the
  // earliest query's window
  const int p_hi = min(a.P - 1, qpos_max / a.ps);
  int p_lo = 0;
  if (a.window > 0) {
    const int x = qpos_min - a.window - a.ps + 1;
    if (x >= 0) p_lo = x / a.ps + 1;
  }
  __syncthreads();

  const int warp = tid / 32, lane = tid % 32, nw = nt / 32;
  for (int p0 = p_lo; p0 <= p_hi; p0 += a.NPT) {
    for (int i = tid; i < KT * D; i += nt) {
      const int kk = i / D, d = i % D;
      const int p = p0 + kk / a.ps, j = kk % a.ps;
      float kx = 0.f, vx = 0.f;
      if (p <= p_hi) {
        const int row = a.tables[(size_t)b * a.P + p];
        const size_t src = (((size_t)row * a.ps + j) * a.KV + kvh) * D + d;
        kx = to_f(kp[src]);
        vx = to_f(vp[src]);
      }
      ks[kk * Dp + d] = kx;
      vs[kk * D + d] = vx;
    }
    __syncthreads();

    for (int i = tid; i < R * KT; i += nt) {
      const int r = i / KT, kk = i % KT;
      const int t = t0 + r / n_rep;
      const int qpos = start + t;
      const int kpos = p0 * a.ps + kk;
      const bool valid = t < a.Tq && p0 + kk / a.ps <= p_hi &&
                         kpos <= qpos &&
                         (a.window <= 0 || qpos - kpos < a.window);
      float s = kNegInf;
      if (valid) {
        const float* qr = qs + r * Dp;
        const float* kr = ks + kk * Dp;
        float dot = 0.f;
        for (int d = 0; d < D; ++d) dot = fmaf(qr[d], kr[d], dot);
        s = dot * a.scale;
      }
      ss[i] = s;
    }
    __syncthreads();

    for (int r = warp; r < R; r += nw) {
      float* sr = ss + r * KT;
      float mx = kNegInf;
      for (int kk = lane; kk < KT; kk += 32) mx = fmaxf(mx, sr[kk]);
      mx = warp_max(mx);
      const float m_prev = m[r];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int kk = lane; kk < KT; kk += 32) {
        const float s = sr[kk];
        const float pr = s > kNegInf ? expf(s - m_new) : 0.f;
        sum += pr;
        // the PV product takes p in the value dtype, as the reference
        sr[kk] = to_f(from_f<T>(pr));
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float c = expf(m_prev - m_new);
        corr[r] = c;
        l[r] = l[r] * c + sum;
        m[r] = m_new;
      }
    }
    __syncthreads();

    for (int i = tid; i < R * D; i += nt) {
      const int r = i / D, d = i % D;
      const float* pr = ss + r * KT;
      float o = acc[i] * corr[r];
      for (int kk = 0; kk < KT; ++kk) o = fmaf(pr[kk], vs[kk * D + d], o);
      acc[i] = o;
    }
    __syncthreads();
  }

  for (int i = tid; i < R * D; i += nt) {
    const int r = i / D, d = i % D;
    const int t = t0 + r / n_rep, h = kvh * n_rep + r % n_rep;
    if (t < a.Tq)
      out[(((size_t)b * a.Tq + t) * a.H + h) * D + d] =
          from_f<T>(acc[i] / fmaxf(l[r], 1e-30f));
  }
}

// fp32 chunked prefill: grid (ceil(T / TQ), KV, B), one block per
// (slot, KV head, query tile of TQ queries).
__global__ void __launch_bounds__(kThreads)
paged_prefill_kernel(Args a) {
  attend_block<float>(a, blockIdx.z, blockIdx.y, blockIdx.x);
}

// bf16 chunked prefill: the tensor-core core through the block tables,
// grid (ceil(T / TQ), KV, B), heaviest (last) query tile first.
struct PrefillTC {
  using Input = Args;
  using Loader = attn_core::PagedLoader;
  __device__ static void setup(const Args& a, attn_core::Params& p,
                               Loader& L) {
    typedef __nv_bfloat16 T;
    const int b = blockIdx.z, kvh = blockIdx.y;
    const size_t row = (size_t)b * a.Tq * a.H * a.D;
    p.q = static_cast<const T*>(a.q) + row;
    p.out = static_cast<T*>(a.out) + row;
    p.q_ss = (long long)a.H * a.D;
    p.q_sh = a.D;
    p.Sq = a.Tq;
    p.n_rep = a.H / a.KV;
    p.kvh = kvh;
    p.D = a.D;
    p.qt = gridDim.x - 1 - blockIdx.x;
    p.qpos0 = a.qstart[b];
    p.k_max = a.P * a.ps - 1;
    p.causal = 1;
    p.window = a.window;
    p.scale_log2 = a.scale * 1.4426950408889634f;
    p.vec = a.vec;
    L.k = static_cast<const T*>(a.k) + (size_t)kvh * a.D;
    L.v = static_cast<const T*>(a.v) + (size_t)kvh * a.D;
    L.table = a.tables + (size_t)b * a.P;
    L.ps = a.ps;
    L.token = (long long)a.KV * a.D;
  }
};

cudaError_t launch_prefill_f32(Args a, cudaStream_t stream) {
  const int n_rep = a.H / a.KV;
  a.NPT = kTileKeys / a.ps > 0 ? kTileKeys / a.ps : 1;
  const size_t smem = smem_bytes(a.TQ * n_rep, a.NPT * a.ps, a.D);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || dev >= attn_core::kMaxDevices)
    return cudaErrorInvalidValue;
  // the attribute only grows, once per device and size
  static size_t smem_set[attn_core::kMaxDevices];
  if (smem > smem_set[dev]) {
    err = cudaFuncSetAttribute(paged_prefill_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return err;
    smem_set[dev] = smem;
  }
  dim3 grid((a.Tq + a.TQ - 1) / a.TQ, a.KV, a.B);
  paged_prefill_kernel<<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

// -- decode: split over key ranges, then combine --------------------------

namespace decode {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxD = 256;           // 8 elements x 32 lanes

struct Params {
  const void* q;        // (B, H, D)
  const void* k;        // (N, ps, KV, D)
  const void* v;
  const int* tables;    // (B, P)
  const int* pos;       // (B,)
  float* part_o;        // (B, H, splits, D) unnormalised outputs
  float* part_m;        // (B, H, splits) running max, log2 units
  float* part_l;        // (B, H, splits) softmax denominators
  int B, H, KV, D, ps, P, window;
  int pps, splits;      // pages per split, splits per (slot, KV head)
  int rows;             // query heads a block holds (its row group)
  int G;                // CUDA-core kernel: lanes per key, 8 G >= D
  float scale_log2;     // D^-0.5 * log2(e)
};

// What block (blockIdx.x = split, .y = KV head x row group, .z = slot)
// attends: its first query head h0, its live rows, and the split's live
// keys [kb, ke] (its pages, at or before the clock, inside the window).
// An empty range writes an empty partial and the block returns.
// The split's block-table entries are read into shared memory as the
// block starts, beside its clock, so no K/V copy waits on a table read.
struct Split {
  int b, kvh, h0, rows, kb, ke;
  int page0;            // the split's first page
  const int* rows_of;   // pool row of page page0 + i (shared memory)
  size_t part;          // partial of row r: part + r * splits
};

constexpr int kMaxSplitPages = 512;   // paged.py: MAX_SPLIT_KEYS pages

__device__ __forceinline__ bool split_keys(const Params& a, Split& sp) {
  __shared__ int rows_of[kMaxSplitPages];
  const int s = blockIdx.x;
  const int groups = (a.H / a.KV + a.rows - 1) / a.rows;
  const int rg = blockIdx.y % groups;
  sp.kvh = blockIdx.y / groups;
  sp.b = blockIdx.z;
  const int n_rep = a.H / a.KV;
  sp.h0 = sp.kvh * n_rep + rg * a.rows;
  sp.rows = min(a.rows, n_rep - rg * a.rows);
  sp.page0 = s * a.pps;
  sp.rows_of = rows_of;
  const int pos = a.pos[sp.b];
  const int* table = a.tables + (size_t)sp.b * a.P + sp.page0;
  for (int i = threadIdx.x; i < a.pps && sp.page0 + i < a.P; i += blockDim.x)
    rows_of[i] = table[i];
  const int span = a.pps * a.ps;
  sp.kb = sp.page0 * a.ps;
  sp.ke = min(min(sp.kb + span, a.P * a.ps) - 1, pos);
  if (a.window > 0) sp.kb = max(sp.kb, pos - a.window + 1);
  sp.part = ((size_t)sp.b * a.H + sp.h0) * a.splits + s;
  if (sp.kb <= sp.ke) {
    __syncthreads();
    return true;
  }
  if (threadIdx.x < sp.rows) {   // nothing to read: an empty partial
    a.part_m[sp.part + (size_t)threadIdx.x * a.splits] = -INFINITY;
    a.part_l[sp.part + (size_t)threadIdx.x * a.splits] = 0.f;
  }
  return false;
}

// `keys` keys from k0 (none past ke) of the slot's K and V rows into a
// warp's tiles, row kk at kk * ld, dp elements a row (zero past D and
// past ke): 16-byte cp.async copies, or plain element loads.
template <typename T, bool VEC>
__device__ __forceinline__ void load_tile(const Params& a, const Split& sp,
                                          T* ks, T* vs, int keys, int ld,
                                          int dp, int k0, int lane) {
  const T* kp = static_cast<const T*>(a.k) + (size_t)sp.kvh * a.D;
  const T* vp = static_cast<const T*>(a.v) + (size_t)sp.kvh * a.D;
  const long long token = (long long)a.KV * a.D;
  // element offset of key kpos's row in the pool
  auto key_off = [&](int kpos) {
    const int p = kpos / a.ps;
    return ((long long)sp.rows_of[p - sp.page0] * a.ps + (kpos - p * a.ps)) *
           token;
  };
  if constexpr (VEC) {
    constexpr int EPC = 16 / sizeof(T);   // elements per 16 bytes
    const int cpk = dp / EPC;              // chunks per key
    for (int c = lane; c < keys * cpk; c += 32) {
      const int kk = c / cpk, e0 = (c - kk * cpk) * EPC;
      const int kpos = k0 + kk;
      const bool fill = kpos <= sp.ke && e0 < a.D;
      const long long off = fill ? key_off(kpos) + e0 : 0;
      attn_core::cp_async16(ks + kk * ld + e0, kp + off, fill);
      attn_core::cp_async16(vs + kk * ld + e0, vp + off, fill);
    }
  } else {
    for (int c = lane; c < keys * dp; c += 32) {
      const int kk = c / dp, e = c - kk * dp;
      const int kpos = k0 + kk;
      T kx = from_f<T>(0.f), vx = from_f<T>(0.f);
      if (kpos <= sp.ke && e < a.D) {
        const long long off = key_off(kpos) + e;
        kx = kp[off];
        vx = vp[off];
      }
      ks[kk * ld + e] = kx;
      vs[kk * ld + e] = vx;
    }
  }
}

// The block's merge of its warps' partials, each at all + w * stride as
// m[R], l[R], o[R][dp] (a warp that saw no key has m = -inf), into the
// split's partial of each live row.
__device__ __forceinline__ void merge_warps(const Params& a, const Split& sp,
                                            const float* all, int stride,
                                            int nw, int R, int dp) {
  for (int i = threadIdx.x; i < sp.rows * a.D; i += blockDim.x) {
    const int r = i / a.D, d = i - r * a.D;
    float mx = -INFINITY;
    for (int w = 0; w < nw; ++w) mx = fmaxf(mx, all[w * stride + r]);
    float o = 0.f, lsum = 0.f;
    for (int w = 0; w < nw; ++w) {
      const float* wf = all + w * stride;
      if (wf[r] == -INFINITY) continue;
      const float c = exp2f(wf[r] - mx);
      o = fmaf(c, wf[2 * R + r * dp + d], o);
      lsum = fmaf(c, wf[R + r], lsum);
    }
    const size_t idx = sp.part + (size_t)r * a.splits;
    a.part_o[idx * a.D + d] = o;
    if (d == 0) {
      a.part_m[idx] = mx;
      a.part_l[idx] = lsum;
    }
  }
}

// -- fp32 (and bf16 past D 128): f32 FMAs on the CUDA cores --------------

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kSteps = 4;            // keys per lane group and warp tile
constexpr int kTileElems = 1024;     // keys x padded D of a warp tile
constexpr int kFmaRows = 8;          // query heads a block holds

template <typename T> struct Stages;
template <> struct Stages<float> { static constexpr int n = 2; };
template <> struct Stages<__nv_bfloat16> { static constexpr int n = 4; };

// each warp's ring: Stages x (K tile, V tile) of kTileElems elements;
// 65,536 bytes a block in both dtypes
template <typename T>
__host__ __device__ constexpr size_t ring_elems() {
  return (size_t)Stages<T>::n * 2 * kTileElems;
}
template <typename T>
__host__ __device__ constexpr size_t fma_smem_bytes() {
  return kWarps * ring_elems<T>() * sizeof(T);
}

// 8 consecutive elements from shared memory, widened to f32
__device__ __forceinline__ void load8(const float* p, float* f) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  const float4 y = *reinterpret_cast<const float4*>(p + 4);
  f[0] = x.x; f[1] = x.y; f[2] = x.z; f[3] = x.w;
  f[4] = y.x; f[5] = y.y; f[6] = y.z; f[7] = y.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* f) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {   // bf16 is the top half of an f32
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// Lane group of G lanes = one key a step; lane c owns elements 8c ..
// 8c + 7 of up to ROWS query rows (in registers) and of each key; the
// group's dot products are summed by xor shuffles, and each group keeps
// its own online softmax over its keys.
template <typename T, int ROWS, bool VEC>
__global__ void __launch_bounds__(kThreads)
decode_fma_kernel(const Params a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int NS = Stages<T>::n;
  Split sp;
  if (!split_keys(a, sp)) return;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int G = a.G, NGW = 32 / G;   // lanes per key, keys per step
  const int g = lane / G;            // the lane's key in a step
  const int d0 = 8 * (lane % G);     // its head-dim elements d0 .. d0+7
  const int Dp = 8 * G;
  const int TW = kSteps * NGW;       // keys per warp tile
  const int D = a.D;

  float m[ROWS], l[ROWS], acc[ROWS][8];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[r][e] = 0.f;
  }

  // the warp takes tiles warp, warp + 4, ... of the split, tile i of
  // its own into stage i % NS of its ring
  const int n_tiles = (sp.ke - sp.kb + TW) / TW;
  const int mine = warp < n_tiles ? (n_tiles - 1 - warp) / kWarps + 1 : 0;
  T* ring = reinterpret_cast<T*>(smem_raw) + warp * ring_elems<T>();
  auto load = [&](int i) {
    T* ks = ring + (i % NS) * 2 * kTileElems;
    load_tile<T, VEC>(a, sp, ks, ks + kTileElems, TW, Dp, Dp,
                      sp.kb + (warp + i * kWarps) * TW, lane);
  };
#pragma unroll
  for (int i = 0; i < NS - 1; ++i) {
    if (i < mine) load(i);
    attn_core::cp_async_commit();
  }
  // the query rows while the first tiles are in flight
  float qf[ROWS][8];
  {
    const T* q = static_cast<const T*>(a.q) + ((size_t)sp.b * a.H + sp.h0) * D;
#pragma unroll
    for (int r = 0; r < ROWS; ++r)
#pragma unroll
      for (int e = 0; e < 8; ++e)
        qf[r][e] = r < sp.rows && d0 + e < D ? to_f(q[r * D + d0 + e]) : 0.f;
  }
  for (int i = 0; i < mine; ++i) {
    if (i + NS - 1 < mine) load(i + NS - 1);
    attn_core::cp_async_commit();
    attn_core::cp_async_wait<NS - 1>();   // tile i has landed
    __syncwarp();
    const T* ks = ring + (i % NS) * 2 * kTileElems;
    const T* vs = ks + kTileElems;
    const int k0 = sp.kb + (warp + i * kWarps) * TW;
#pragma unroll 1
    for (int st = 0; st < kSteps; ++st) {
      const int kk = st * NGW + g;
      float kf[8];
      load8(ks + kk * Dp + d0, kf);
      float dot[ROWS];
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        float x = 0.f;
#pragma unroll
        for (int e = 0; e < 8; ++e) x = fmaf(qf[r][e], kf[e], x);
        dot[r] = x;
      }
      // the group's sum (every lane takes part: keys past the range
      // are zero-filled and skipped below)
      for (int o = G / 2; o > 0; o >>= 1)
#pragma unroll
        for (int r = 0; r < ROWS; ++r)
          dot[r] += __shfl_xor_sync(kFull, dot[r], o);
      if (k0 + kk <= sp.ke) {
        float vf[8];
        load8(vs + kk * Dp + d0, vf);
#pragma unroll
        for (int r = 0; r < ROWS; ++r) {
          const float sc = dot[r] * a.scale_log2;
          if (sc > m[r]) {
            const float c = exp2f(m[r] - sc);
            l[r] *= c;
#pragma unroll
            for (int e = 0; e < 8; ++e) acc[r][e] *= c;
            m[r] = sc;
          }
          const float p = exp2f(sc - m[r]);
          l[r] += p;
          // the PV product takes p in the value dtype, as the reference
          const float pv = to_f(from_f<T>(p));
#pragma unroll
          for (int e = 0; e < 8; ++e) acc[r][e] = fmaf(pv, vf[e], acc[r][e]);
        }
      }
    }
    __syncwarp();   // the stage is free for tile i + NS
  }
  attn_core::cp_async_wait<0>();

  // merge the warp's lane groups (same elements, other keys)
  for (int o = G; o < 32; o <<= 1) {
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const float mo = __shfl_xor_sync(kFull, m[r], o);
      const float lo = __shfl_xor_sync(kFull, l[r], o);
      const float mx = fmaxf(m[r], mo);
      const float c1 = mx == -INFINITY ? 0.f : exp2f(m[r] - mx);
      const float c2 = mx == -INFINITY ? 0.f : exp2f(mo - mx);
      l[r] = l[r] * c1 + lo * c2;
#pragma unroll
      for (int e = 0; e < 8; ++e)
        acc[r][e] = acc[r][e] * c1 +
                    __shfl_xor_sync(kFull, acc[r][e], o) * c2;
      m[r] = mx;
    }
  }
  // the warp's (m, l, acc) into its own ring, then the block's merge
  constexpr int kWarpFloats = ring_elems<T>() * sizeof(T) / sizeof(float);
  static_assert(kWarpFloats >= 2 * kFmaRows + kFmaRows * kMaxD,
                "a warp's partial must fit in its ring");
  __syncwarp();
  float* wf = reinterpret_cast<float*>(ring);
  if (lane < G) {
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      if (lane == 0) {
        wf[r] = m[r];
        wf[ROWS + r] = l[r];
      }
#pragma unroll
      for (int e = 0; e < 8; ++e) wf[2 * ROWS + r * Dp + d0 + e] = acc[r][e];
    }
  }
  __syncthreads();
  merge_warps(a, sp, reinterpret_cast<const float*>(smem_raw), kWarpFloats,
              kWarps, ROWS, Dp);
}

// -- bf16 up to D 128: both products on the tensor cores ------------------

constexpr int kMmaWarps = 4;
constexpr int kMmaKeys = 16;         // keys per warp tile (one PV k-step)
constexpr int kMmaStages = 3;
constexpr int kMmaRows = 16;         // query heads a block holds

// A warp tile: 16 keys x D_pad (16 KD) bf16, rows padded by 16 bytes so
// that the 8 rows an ldmatrix reads fall in distinct banks.
template <int KD>
struct MmaTile {
  static constexpr int DP = 16 * KD;
  static constexpr int LD = DP + 8;
  static constexpr int elems = kMmaKeys * LD;
  static constexpr int ring = kMmaStages * 2 * elems;   // per warp
};

template <int KD>
__host__ __device__ constexpr size_t mma_smem_bytes() {
  return (size_t)kMmaWarps * MmaTile<KD>::ring * sizeof(__nv_bfloat16);
}

__device__ __forceinline__ void ldsm_x4(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(attn_core::smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(attn_core::smem_u32(p)));
}
// c (16 x 8, f32) += a (16 x 16, bf16, row) b (16 x 8, bf16, col)
__device__ __forceinline__ void mma16816(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A warp's 16 rows are the block's query heads (rows past n_rep are
// zero; HI: some block has more than 8, else rows 8-15 are skipped in
// the softmax).  Per 16-key tile: S (16 x 16) = Q K^T as 2 x KD
// mma.sync m16n8k16 with Q's A fragments held in registers and K's B
// fragments by ldmatrix; row maxima over each quad of lanes; O += P V
// with P's A fragments packed from the S accumulators (rounded to bf16,
// as the reference rounds p) and V's B fragments by ldmatrix.trans.
template <int KD, bool HI, bool VEC>
__global__ void __launch_bounds__(kMmaWarps * 32)
decode_mma_kernel(const Params a) {
  typedef __nv_bfloat16 T;
  using Tile = MmaTile<KD>;
  constexpr int NS = kMmaStages, LD = Tile::LD, DP = Tile::DP;
  constexpr int NH = HI ? 2 : 1;     // row halves: g, g + 8
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Split sp;
  if (!split_keys(a, sp)) return;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, tig = lane & 3;
  const int D = a.D;

  float o[2 * KD][4];
#pragma unroll
  for (int dt = 0; dt < 2 * KD; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[dt][e] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  const int n_tiles = (sp.ke - sp.kb + kMmaKeys) / kMmaKeys;
  const int mine =
      warp < n_tiles ? (n_tiles - 1 - warp) / kMmaWarps + 1 : 0;
  T* ring = reinterpret_cast<T*>(smem_raw) + warp * Tile::ring;
  auto load = [&](int i) {
    T* ks = ring + (i % NS) * 2 * Tile::elems;
    load_tile<T, VEC>(a, sp, ks, ks + Tile::elems, kMmaKeys, LD, DP,
                      sp.kb + (warp + i * kMmaWarps) * kMmaKeys, lane);
  };
  // ldmatrix row addresses: matrix lane / 8, its row lane % 8
  const int mj = lane >> 3, mr = lane & 7;
  const int k_off = ((mj >> 1) * 8 + mr) * LD + (mj & 1) * 8;
  const int v_off = ((mj & 1) * 8 + mr) * LD + (mj >> 1) * 8;
#pragma unroll
  for (int i = 0; i < NS - 1; ++i) {
    if (i < mine) load(i);
    attn_core::cp_async_commit();
  }
  // Q's A fragments while the first tiles are in flight
  uint32_t qa[KD][4];
  {
    const T* q = static_cast<const T*>(a.q) + ((size_t)sp.b * a.H + sp.h0) * D;
    auto qv = [&](int r, int d) {
      return r < sp.rows && d < D ? __bfloat162float(q[r * D + d]) : 0.f;
    };
#pragma unroll
    for (int ks = 0; ks < KD; ++ks) {
      const int c = ks * 16 + tig * 2;
      qa[ks][0] = attn_core::pack_bf16(qv(g, c), qv(g, c + 1));
      qa[ks][1] = attn_core::pack_bf16(qv(g + 8, c), qv(g + 8, c + 1));
      qa[ks][2] = attn_core::pack_bf16(qv(g, c + 8), qv(g, c + 9));
      qa[ks][3] = attn_core::pack_bf16(qv(g + 8, c + 8), qv(g + 8, c + 9));
    }
  }
  for (int i = 0; i < mine; ++i) {
    if (i + NS - 1 < mine) load(i + NS - 1);
    attn_core::cp_async_commit();
    attn_core::cp_async_wait<NS - 1>();   // tile i has landed
    __syncwarp();
    const T* ks = ring + (i % NS) * 2 * Tile::elems;
    const T* vs = ks + Tile::elems;
    const int k0 = sp.kb + (warp + i * kMmaWarps) * kMmaKeys;

    float sc[2][4] = {};   // keys 0-7, 8-15 of the tile
#pragma unroll
    for (int kd = 0; kd < KD; ++kd) {
      uint32_t b[4];
      ldsm_x4(b, ks + k_off + kd * 16);
      mma16816(sc[0], qa[kd], b[0], b[1]);
      mma16816(sc[1], qa[kd], b[2], b[3]);
    }
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kpos = k0 + nt * 8 + tig * 2 + (e & 1);
        sc[nt][e] = kpos <= sp.ke ? sc[nt][e] * a.scale_log2 : -INFINITY;
      }
    uint32_t pa[4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int hh = 0; hh < NH; ++hh) {
      float mx = fmaxf(fmaxf(sc[0][2 * hh], sc[0][2 * hh + 1]),
                       fmaxf(sc[1][2 * hh], sc[1][2 * hh + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 2));
      const float mn = fmaxf(m[hh], mx);   // the tile has a live key
      const float corr = attn_core::ex2(m[hh] - mn);
      m[hh] = mn;
      float p[2][2];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          p[nt][e] = attn_core::ex2(sc[nt][2 * hh + e] - mn);
      l[hh] = l[hh] * corr + ((p[0][0] + p[0][1]) + (p[1][0] + p[1][1]));
#pragma unroll
      for (int dt = 0; dt < 2 * KD; ++dt) {
        o[dt][2 * hh] *= corr;
        o[dt][2 * hh + 1] *= corr;
      }
      // P's A fragment, rounded to bf16 as the reference rounds p
      pa[hh] = attn_core::pack_bf16(p[0][0], p[0][1]);
      pa[2 + hh] = attn_core::pack_bf16(p[1][0], p[1][1]);
    }
#pragma unroll
    for (int kd = 0; kd < KD; ++kd) {
      uint32_t b[4];
      ldsm_x4_t(b, vs + v_off + kd * 16);
      mma16816(o[2 * kd], pa, b[0], b[1]);
      mma16816(o[2 * kd + 1], pa, b[2], b[3]);
    }
    __syncwarp();   // the stage is free for tile i + NS
  }
  attn_core::cp_async_wait<0>();

  // row sums over the quad, the warp's (m, l, o) into its own ring, then
  // the block's merge
  constexpr int kWarpFloats =
      Tile::ring * sizeof(T) / sizeof(float);
  static_assert(kWarpFloats >= 2 * kMmaRows + kMmaRows * DP,
                "a warp's partial must fit in its ring");
  __syncwarp();
  float* wf = reinterpret_cast<float*>(ring);
#pragma unroll
  for (int hh = 0; hh < NH; ++hh) {
    float lsum = l[hh];
    lsum += __shfl_xor_sync(kFull, lsum, 1);
    lsum += __shfl_xor_sync(kFull, lsum, 2);
    const int r = g + 8 * hh;
    if (tig == 0) {
      wf[r] = m[hh];
      wf[kMmaRows + r] = lsum;
    }
#pragma unroll
    for (int dt = 0; dt < 2 * KD; ++dt) {
      wf[2 * kMmaRows + r * DP + dt * 8 + tig * 2] = o[dt][2 * hh];
      wf[2 * kMmaRows + r * DP + dt * 8 + tig * 2 + 1] = o[dt][2 * hh + 1];
    }
  }
  __syncthreads();
  merge_warps(a, sp, reinterpret_cast<const float*>(smem_raw), kWarpFloats,
              kMmaWarps, kMmaRows, DP);
}

// -- combine --------------------------------------------------------------

// One block per (slot, head), a thread per head-dim element (two past
// D 128): O = sum_i 2^(m_i - M) o_i / max(sum_i 2^(m_i - M) l_i, 1e-30)
// over the splits that saw a key (an empty split has l 0 and an o that
// was never written, which weighs 0).  The loads of 16 splits' o are
// issued before their (m, l) are read, so a pass costs one round trip.
constexpr int kCombineSplits = 16;   // splits a pass of the combine takes

template <typename T>
__global__ void __launch_bounds__(kThreads)
decode_combine_kernel(const float* part_o, const float* part_m,
                      const float* part_l, T* out, int D, int splits) {
  constexpr int J = kMaxD / kThreads;
  const size_t base = (size_t)blockIdx.x * splits;
  const int lane = threadIdx.x % 32;
  float mx = -INFINITY, lsum = 0.f, o[J] = {};
  for (int s0 = 0; s0 < splits; s0 += kCombineSplits) {
    float x[kCombineSplits][J];
#pragma unroll
    for (int i = 0; i < kCombineSplits; ++i)
#pragma unroll
      for (int j = 0; j < J; ++j) {
        const int d = threadIdx.x + j * kThreads;
        x[i][j] = s0 + i < splits && d < D ? part_o[(base + s0 + i) * D + d]
                                            : 0.f;
      }
    if (s0 == 0) {   // the max over every split that saw a key
      for (int s = lane; s < splits; s += 32)
        if (part_l[base + s] > 0.f) mx = fmaxf(mx, part_m[base + s]);
      mx = warp_max(mx);
    }
    float c = 0.f;
    if (lane < kCombineSplits && s0 + lane < splits) {
      const float l = part_l[base + s0 + lane];
      if (l > 0.f) {
        c = exp2f(part_m[base + s0 + lane] - mx);
        lsum = fmaf(c, l, lsum);
      }
    }
#pragma unroll
    for (int i = 0; i < kCombineSplits; ++i) {
      const float ci = __shfl_sync(kFull, c, i);
#pragma unroll
      for (int j = 0; j < J; ++j)
        o[j] = fmaf(ci, ci > 0.f ? x[i][j] : 0.f, o[j]);
    }
  }
  const float den = fmaxf(warp_sum(lsum), 1e-30f);
  T* orow = out + (size_t)blockIdx.x * D;
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int d = threadIdx.x + j * kThreads;
    if (d < D) orow[d] = from_f<T>(o[j] / den);
  }
}

// -- launch ---------------------------------------------------------------

// Set a kernel's dynamic shared memory attribute once per device.
template <typename Kern>
cudaError_t allow_smem(Kern kern, size_t smem, bool* done) {
  if (smem <= 48 * 1024) return cudaSuccess;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || dev >= attn_core::kMaxDevices)
    return cudaErrorInvalidValue;
  if (!done[dev]) {
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    done[dev] = true;
  }
  return cudaSuccess;
}

template <typename T>
cudaError_t combine(const Params& a, void* out, cudaStream_t stream) {
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  decode_combine_kernel<T><<<a.B * a.H, kThreads, 0, stream>>>(
      a.part_o, a.part_m, a.part_l, static_cast<T*>(out), a.D, a.splits);
  return cudaGetLastError();
}

template <typename T, int ROWS, bool VEC>
cudaError_t launch_fma(Params a, void* out, cudaStream_t stream) {
  constexpr size_t smem = fma_smem_bytes<T>();
  static_assert(smem <= kMaxSmem, "the rings do not fit");
  static bool done[attn_core::kMaxDevices];
  auto kern = decode_fma_kernel<T, ROWS, VEC>;
  cudaError_t err = allow_smem(kern, smem, done);
  if (err != cudaSuccess) return err;
  a.rows = ROWS;
  const int groups = (a.H / a.KV + ROWS - 1) / ROWS;
  kern<<<dim3(a.splits, a.KV * groups, a.B), kThreads, smem, stream>>>(a);
  return combine<T>(a, out, stream);
}

template <int KD, bool HI, bool VEC>
cudaError_t launch_mma(Params a, void* out, cudaStream_t stream) {
  constexpr size_t smem = mma_smem_bytes<KD>();
  static_assert(smem <= kMaxSmem, "the rings do not fit");
  static bool done[attn_core::kMaxDevices];
  auto kern = decode_mma_kernel<KD, HI, VEC>;
  cudaError_t err = allow_smem(kern, smem, done);
  if (err != cudaSuccess) return err;
  a.rows = kMmaRows;
  const int groups = (a.H / a.KV + kMmaRows - 1) / kMmaRows;
  kern<<<dim3(a.splits, a.KV * groups, a.B), kMmaWarps * 32, smem,
         stream>>>(a);
  return combine<__nv_bfloat16>(a, out, stream);
}

template <int KD>
cudaError_t launch_mma_kd(const Params& a, bool hi, bool vec, void* out,
                          cudaStream_t stream) {
  if (hi) return vec ? launch_mma<KD, true, true>(a, out, stream)
                     : launch_mma<KD, true, false>(a, out, stream);
  return vec ? launch_mma<KD, false, true>(a, out, stream)
             : launch_mma<KD, false, false>(a, out, stream);
}

template <typename T, int ROWS>
cudaError_t launch_fma_rows(const Params& a, bool vec, void* out,
                            cudaStream_t stream) {
  return vec ? launch_fma<T, ROWS, true>(a, out, stream)
             : launch_fma<T, ROWS, false>(a, out, stream);
}

// bf16 up to D 128 on the tensor cores; fp32, and bf16 past D 128, on
// the CUDA cores.
template <typename T>
cudaError_t launch(Params a, void* out, cudaStream_t stream) {
  const int n_rep = a.H / a.KV;
  const bool vec = (a.D * sizeof(T)) % 16 == 0 &&
                   attn_core::aligned16(a.k) && attn_core::aligned16(a.v);
  if (sizeof(T) == 2 && a.D <= 128) {
    const bool hi = n_rep > 8;
    if (a.D <= 16) return launch_mma_kd<1>(a, hi, vec, out, stream);
    if (a.D <= 32) return launch_mma_kd<2>(a, hi, vec, out, stream);
    if (a.D <= 64) return launch_mma_kd<4>(a, hi, vec, out, stream);
    return launch_mma_kd<8>(a, hi, vec, out, stream);
  }
  a.G = 1;
  while (8 * a.G < a.D) a.G *= 2;
  if (n_rep <= 1) return launch_fma_rows<T, 1>(a, vec, out, stream);
  if (n_rep <= 2) return launch_fma_rows<T, 2>(a, vec, out, stream);
  if (n_rep <= 4) return launch_fma_rows<T, 4>(a, vec, out, stream);
  return launch_fma_rows<T, 8>(a, vec, out, stream);
}

}  // namespace decode

}  // namespace

extern "C" {

// q (B, H, D); pages (N, ps, KV, D); tables (B, P) int32;
// positions (B,) int32; out (B, H, D); workspace B * H * splits *
// (D + 2) floats, splits = ceil(P / pages_per_split).
int paged_attention_decode(const void* q, const void* k, const void* v,
                           const void* tables, const void* positions,
                           void* out, void* workspace, int B, int H, int KV,
                           int D, int ps, int P, int window, float scale,
                           int pages_per_split, int dtype, void* stream) {
  if (B <= 0 || KV <= 0 || H <= 0 || H % KV || D <= 0 ||
      D > decode::kMaxD || ps <= 0 || P <= 0 || pages_per_split <= 0 ||
      pages_per_split > decode::kMaxSplitPages)
    return (int)cudaErrorInvalidValue;
  decode::Params a{};
  a.q = q;
  a.k = k;
  a.v = v;
  a.tables = static_cast<const int*>(tables);
  a.pos = static_cast<const int*>(positions);
  a.B = B;
  a.H = H;
  a.KV = KV;
  a.D = D;
  a.ps = ps;
  a.P = P;
  a.window = window;
  a.pps = pages_per_split;
  a.splits = (P + pages_per_split - 1) / pages_per_split;
  const size_t parts = (size_t)B * H * a.splits;
  a.part_o = static_cast<float*>(workspace);
  a.part_m = a.part_o + parts * D;
  a.part_l = a.part_m + parts;
  a.scale_log2 = scale * 1.4426950408889634f;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)decode::launch<float>(a, out, s);
  if (dtype == 1) return (int)decode::launch<__nv_bfloat16>(a, out, s);
  return (int)cudaErrorInvalidValue;
}

// q (B, T, H, D); pages (N, ps, KV, D); tables (B, P) int32;
// start (B,) int32; out (B, T, H, D).
int paged_prefill_attention(const void* q, const void* k, const void* v,
                            const void* tables, const void* start,
                            void* out, int B, int T, int H, int KV, int D,
                            int ps, int P, int window, float scale,
                            int dtype, void* stream) {
  if (B <= 0 || T <= 0 || KV <= 0 || H % KV || D <= 0 || ps <= 0 || P <= 0)
    return (int)cudaErrorInvalidValue;
  const int n_rep = H / KV;
  int tq = kRowsPrefill / (n_rep > 0 ? n_rep : 1);
  if (tq < 1) tq = 1;
  if (tq > T) tq = T;
  using attn_core::aligned16;
  const int vec = D % 8 == 0 && aligned16(q) && aligned16(k) &&
                  aligned16(v) && aligned16(out);
  Args a{q, k, v, static_cast<const int*>(tables),
         static_cast<const int*>(start), out,
         B, T, H, KV, D, ps, P, window, tq, 1, scale, vec};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch_prefill_f32(a, s);
  if (dtype == 1)
    return (int)attn_core::launch<PrefillTC>(a, T, n_rep, KV, B, D, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
