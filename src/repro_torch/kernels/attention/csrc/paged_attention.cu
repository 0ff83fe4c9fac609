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
// and an f32 accumulator.  Pages wholly past the block's last query or
// wholly behind its window are never read (paged.py:60-62, :172-174).
//
// Design.  One block per (slot, KV head[, query tile]).  The block reads
// its own block-table entries (no scalar prefetch) and walks the live
// keys in a loop inside the block (the Pallas grid's sequential page
// axis).  All n_rep query heads of the KV head sit in the block's rows,
// so each K/V page is read from device memory once per block instead
// of once per query head as in the Pallas grid (B, H, nP).  Decode
// blocks hold the n_rep rows of one query; fp32 prefill blocks hold TQ
// queries x n_rep heads (TQ * n_rep ~ 64 rows).  A sharded
// (S, R, ps, KV, D) pool arrives as the flat (S*R, ps, KV, D) view,
// whose row index is already the table's `locality * R + slot`.
//
// What bounds them on the H100, and what each instantiation does.
//   * Chunked prefill at T = 256 does ~T/2 flops per K/V byte, above
//     the card's ~295 flops/byte ridge: bound by operations, on the
//     tensor cores.  Its bf16 instantiation runs the tensor-core core of
//     attention_core.cuh (shared with the flash kernel) through a
//     block-table loader: key kpos of a key tile is looked up in the
//     slot's table (page kpos / ps, token kpos % ps) and its D-wide row
//     (256 bytes at D 128) copied from the pool by 16-byte cp.async into
//     a two-stage bf16 ring; both products as warp-group wgmma.  At the
//     engine's B 1 x T 256 chunk with 32/4 heads, 128-row blocks would
//     be 64 for 132 SMs; so it launches 128 blocks of 64 rows (32 query
//     tiles x 4 KV heads) whose two warp groups split the keys (8 warps
//     per block), heaviest query tile first.
//   * Decode moves the live K/V pages once and does ~2 flops per byte:
//     bound by device-memory bytes; the design's answer is the
//     one-read-per-KV-head layout above.  Decode (both dtypes) and fp32
//     prefill keep `attend_block`: f32 FMAs from shared memory (TF32
//     cannot hold the reference's 1e-5).  Decode's 32 blocks at B 8
//     leave most SMs idle: a split over pages is its next step.
// The build log (-Xptxas -v) gives registers, stack and spills for
// every instantiation, and chip_smoke.py prints them.  bf16 at D 128
// (CUDA 12.8): 211 registers and 163,840 bytes of dynamic shared
// memory on 128 rows, 161 and 147,456 with the keys split; no
// instantiation spills or keeps a stack frame.
//
// C interface (ctypes): pointers and the stream are void*, every launch
// returns cudaGetLastError() and the Python wrapper raises when it is
// not cudaSuccess.  dtype: 0 = float32, 1 = bfloat16.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

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

// One block: query tile `qt` of slot `b`, KV head `kvh`.
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

// Decode: grid (KV, B), one block per (slot, KV head), n_rep rows.
template <typename T>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(Args a) {
  attend_block<T>(a, blockIdx.y, blockIdx.x, 0);
}

// Chunked prefill: grid (ceil(T / TQ), KV, B), one block per (slot,
// KV head, query tile of TQ queries).
template <typename T>
__global__ void __launch_bounds__(kThreads)
paged_prefill_kernel(Args a) {
  attend_block<T>(a, blockIdx.z, blockIdx.y, blockIdx.x);
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

template <typename T>
cudaError_t launch(Args a, bool prefill, cudaStream_t stream) {
  const int n_rep = a.H / a.KV;
  const size_t smem = smem_bytes(a.TQ * n_rep, a.NPT * a.ps, a.D);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  if (prefill) {
    auto kern = paged_prefill_kernel<T>;
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    dim3 grid((a.Tq + a.TQ - 1) / a.TQ, a.KV, a.B);
    kern<<<grid, kThreads, smem, stream>>>(a);
  } else {
    auto kern = paged_decode_kernel<T>;
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    dim3 grid(a.KV, a.B);
    kern<<<grid, kThreads, smem, stream>>>(a);
  }
  return cudaGetLastError();
}

int dispatch(Args a, int dtype, bool prefill, void* stream) {
  if (a.B <= 0 || a.Tq <= 0 || a.KV <= 0 || a.H % a.KV || a.D <= 0 ||
      a.ps <= 0 || a.P <= 0)
    return (int)cudaErrorInvalidValue;
  a.NPT = kTileKeys / a.ps > 0 ? kTileKeys / a.ps : 1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch<float>(a, prefill, s);
  if (dtype == 1 && prefill) {
    return (int)attn_core::launch<PrefillTC>(a, a.Tq, a.H / a.KV, a.KV, a.B,
                                             a.D, s);
  }
  if (dtype == 1) return (int)launch<__nv_bfloat16>(a, prefill, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// q (B, H, D); pages (N, ps, KV, D); tables (B, P) int32;
// positions (B,) int32; out (B, H, D).
int paged_attention_decode(const void* q, const void* k, const void* v,
                           const void* tables, const void* positions,
                           void* out, int B, int H, int KV, int D, int ps,
                           int P, int window, float scale, int dtype,
                           void* stream) {
  Args a{q, k, v, static_cast<const int*>(tables),
         static_cast<const int*>(positions), out,
         B, 1, H, KV, D, ps, P, window, 1, 1, scale, 0};
  return dispatch(a, dtype, false, stream);
}

// q (B, T, H, D); pages (N, ps, KV, D); tables (B, P) int32;
// start (B,) int32; out (B, T, H, D).
int paged_prefill_attention(const void* q, const void* k, const void* v,
                            const void* tables, const void* start,
                            void* out, int B, int T, int H, int KV, int D,
                            int ps, int P, int window, float scale,
                            int dtype, void* stream) {
  const int n_rep = KV > 0 ? H / KV : 1;
  int tq = kRowsPrefill / (n_rep > 0 ? n_rep : 1);
  if (tq < 1) tq = 1;
  if (tq > T) tq = T;
  using attn_core::aligned16;
  const int vec = D % 8 == 0 && aligned16(q) && aligned16(k) &&
                  aligned16(v) && aligned16(out);
  Args a{q, k, v, static_cast<const int*>(tables),
         static_cast<const int*>(start), out,
         B, T, H, KV, D, ps, P, window, tq, 1, scale, vec};
  return dispatch(a, dtype, true, stream);
}

}  // extern "C"
