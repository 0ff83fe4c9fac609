// Flash attention (whole-sequence prefill), for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of the reference package
//   src/repro/kernels/attention/flash.py:flash_attention_bhsd
// The plain PyTorch versions it is held against live in
// kernels/attention/ref.py (flash_attention_ref) and
// models/attention.py (flash_jnp).
//
// What the kernel computes is the Pallas kernel's function, not its
// grid: softmax(q k^T * D^-0.5) v per query head, GQA head h reading KV
// head h / n_rep, with an online softmax across key tiles, f32 scores,
// statistics and accumulator, and the softmax weights rounded to the
// value dtype before the PV product (flash.py:76-79).  Masks compare
// absolute positions: a query at q_offset + i sees key j iff (not
// causal or j <= q_offset + i) and (window <= 0 or
// q_offset + i - j < window) (flash.py:61-69).  A row that sees no key
// returns 0 (l clamped to 1e-30, flash.py:84-85).
//
// Design.  One block per (batch row, KV head, query tile of BQ
// queries).  The block's 64 rows are the BQ queries times the n_rep
// query heads of its KV head (BQ = 64 / n_rep: 8 at yi-6b's 32/4
// heads), so each K/V tile is read from device memory once per query
// group instead of once per query head as in the Pallas grid
// (BH, nq, nk).  The block computes the key range its queries can see
// (causality with q_offset, and the window) and walks only that range:
// tiles with no live element are never read, which is the Pallas
// kernel's pruning (flash.py:44-50) at key granularity.  Query and key
// tails are masked, so any Sq and Sk work (the Pallas wrapper drops a
// tail that is not a multiple of its tile).  Causal blocks are launched
// heaviest first.
//
// What bounds it on the H100, and the two instantiations.  Prefill
// attention over S keys does about S/2 flops per K/V byte, far above
// the card's ~295 flops/byte ridge: bound by operations, on the tensor
// cores.
//   * bf16 runs the tensor-core core of attention_core.cuh (shared with
//     the chunked-prefill kernel, through a contiguous K/V loader): both
//     products as warp-group wgmma, P kept in registers, K/V staged in
//     bf16 by cp.async in a two-stage ring.  At yi-6b's buckets (32/4
//     heads of 128, B 1) launch_kd gives the 256-token bucket 128
//     blocks whose two warp groups split the keys of 64 rows, and 512
//     tokens and up 128-384 blocks of two warp groups on 128 rows.
//     What holds it below the tensor-core bound: each warp group runs
//     its two products and the softmax between them (one exp per score
//     on the special-function unit) one after another, with a
//     block-wide barrier per stage of keys, so only the block's other
//     warp group can keep the tensor cores busy meanwhile.
//   * fp32 stays on the CUDA cores (TF32 cannot hold the reference's
//     2e-5): a 16 x 16 thread grid holds a 4 x 4 block of scores and a
//     4 x ceil(D/16) block of the accumulator per thread in registers;
//     q, the K/V tile and the weights sit in shared memory as f32.
// The build log (-Xptxas -v) gives registers, stack and spills for
// every instantiation, and chip_smoke.py prints them.  bf16 at D 128
// (CUDA 12.8): 207 registers and 163,840 bytes of dynamic shared
// memory on 128 rows, 152 and 147,456 with the keys split; no
// instantiation spills or keeps a stack frame.

// Layout.  Any (batch, sequence, head) element strides with a
// contiguous head dimension: the wrapper reads the reference's
// (B, S, H, D) activations in place, and the Pallas entry's
// (BH, S, D) layout is the same kernel with B = BKV, KV = 1 and
// H = n_rep.  K and V share strides; the output shares q's.
//
// C interface (ctypes): pointers and the stream are void*, the launch
// returns cudaGetLastError() and the Python wrapper raises when it is
// not cudaSuccess.  dtype: 0 = float32, 1 = bfloat16.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

#include "attention_core.cuh"

namespace {

constexpr float kNegInf = -1.0e30f;   // the Pallas kernel's NEG_INF
constexpr int kThreads = 256;         // 16 x 16 thread grid
constexpr int kRows = 64;             // query rows per block
constexpr int kKeys = 64;             // keys per tile
constexpr int kRPT = kRows / 16;      // score / output rows per thread
constexpr int kCPT = kKeys / 16;      // score columns per thread
constexpr int kPStride = kKeys + 1;   // padded weight row (bank spread)
constexpr size_t kMaxSmem = 232448;   // per-block dynamic shared memory

struct Args {
  const void* q;        // (B, Sq, H, D) under the q strides
  const void* k;        // (B, Sk, KV, D) under the k strides
  const void* v;        // as k
  void* out;            // as q
  int B, Sq, Sk, H, KV, D;
  long long q_sb, q_ss, q_sh;   // element strides of q and out
  long long k_sb, k_ss, k_sh;   // element strides of k and v
  int causal, window, q_offset;
  int BQ;               // queries per block
  float scale;
  int vec;              // bf16: 16-byte copies allowed
};

// max / sum over the 16 lanes that hold one row's score columns
__device__ __forceinline__ float row_max(float x) {
  for (int o = 8; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float row_sum(float x) {
  for (int o = 8; o > 0; o >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

size_t smem_bytes(int d, int dpt) {
  const int dp = d + 1;     // padded row: score reads stay conflict-free
  return sizeof(float) * ((size_t)kRows * dp + (size_t)kKeys * dp +
                          (size_t)kKeys * 16 * dpt +
                          (size_t)kRows * kPStride);
}

// The bf16 instantiation: the tensor-core core over contiguous K/V.
struct FlashTC {
  using Input = Args;
  using Loader = attn_core::ContigLoader;
  __device__ static void setup(const Args& a, attn_core::Params& p,
                               Loader& L) {
    typedef __nv_bfloat16 T;
    const int b = blockIdx.z, kvh = blockIdx.y;
    p.q = static_cast<const T*>(a.q) + (size_t)b * a.q_sb;
    p.out = static_cast<T*>(a.out) + (size_t)b * a.q_sb;
    p.q_ss = a.q_ss;
    p.q_sh = a.q_sh;
    p.Sq = a.Sq;
    p.n_rep = a.H / a.KV;
    p.kvh = kvh;
    p.D = a.D;
    p.qt = a.causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
    p.qpos0 = a.q_offset;
    p.k_max = a.Sk - 1;
    p.causal = a.causal;
    p.window = a.window;
    p.scale_log2 = a.scale * 1.4426950408889634f;
    p.vec = a.vec;
    const size_t kv = (size_t)b * a.k_sb + (size_t)kvh * a.k_sh;
    L.k = static_cast<const T*>(a.k) + kv;
    L.v = static_cast<const T*>(a.v) + kv;
    L.ss = a.k_ss;
  }
};

// The fp32 instantiation.  Grid (nq tiles, KV, B).  DPT = output
// columns per thread (16 * DPT >= D).
template <int DPT>
__global__ void __launch_bounds__(kThreads)
flash_kernel(Args a) {
  extern __shared__ float smem[];
  const int n_rep = a.H / a.KV;
  const int D = a.D, Dp = D + 1, Dv = 16 * DPT;
  const int R = a.BQ * n_rep;
  float* qs = smem;               // kRows x Dp   queries (f32)
  float* ks = qs + kRows * Dp;    // kKeys x Dp   keys of the tile
  float* vs = ks + kKeys * Dp;    // kKeys x Dv   values, zero-padded
  float* ps = vs + kKeys * Dv;    // kRows x kPStride  softmax weights

  const float* q = static_cast<const float*>(a.q);
  const float* kp = static_cast<const float*>(a.k);
  const float* vp = static_cast<const float*>(a.v);
  float* out = static_cast<float*>(a.out);
  // causal: the last query tiles see the most keys; start them first
  const int qt = a.causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int t0 = qt * a.BQ;
  const int t_end = min(t0 + a.BQ, a.Sq);
  const int qpos_min = a.q_offset + t0;
  const int qpos_max = a.q_offset + t_end - 1;
  const float* qb = q + (size_t)b * a.q_sb;
  const float* kb = kp + (size_t)b * a.k_sb + (size_t)kvh * a.k_sh;
  const float* vb = vp + (size_t)b * a.k_sb + (size_t)kvh * a.k_sh;

  for (int i = tid; i < kRows * D; i += kThreads) {
    const int r = i / D, d = i % D;
    float x = 0.f;
    if (r < R) {
      const int t = t0 + r / n_rep, h = kvh * n_rep + r % n_rep;
      if (t < a.Sq)
        x = qb[(size_t)t * a.q_ss + (size_t)h * a.q_sh + d];
    }
    qs[r * Dp + d] = x;
  }

  // the keys any query of the tile can see
  int k_hi = a.Sk - 1;
  if (a.causal) k_hi = min(k_hi, qpos_max);
  int k_lo = 0;
  if (a.window > 0) k_lo = max(0, qpos_min - a.window + 1);

  float m[kRPT], l[kRPT], acc[kRPT][DPT];
  int qpos[kRPT];
  bool row_ok[kRPT];
#pragma unroll
  for (int i = 0; i < kRPT; ++i) {
    const int r = ty + 16 * i;
    const int t = t0 + r / n_rep;
    row_ok[i] = r < R && t < a.Sq;
    qpos[i] = a.q_offset + t;
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DPT; ++c) acc[i][c] = 0.f;
  }

  for (int kt0 = k_lo; kt0 <= k_hi; kt0 += kKeys) {
    __syncthreads();    // the previous tile's readers are done
    for (int i = tid; i < kKeys * Dv; i += kThreads) {
      const int kk = i / Dv, d = i % Dv;
      const int j = kt0 + kk;
      float kx = 0.f, vx = 0.f;
      if (j <= k_hi && d < D) {
        const size_t off = (size_t)j * a.k_ss + d;
        kx = kb[off];
        vx = vb[off];
      }
      if (d < D) ks[kk * Dp + d] = kx;
      vs[kk * Dv + d] = vx;
    }
    __syncthreads();

    // scores: rows ty + 16 i, keys tx + 16 j of the tile
    float s[kRPT][kCPT];
#pragma unroll
    for (int i = 0; i < kRPT; ++i)
#pragma unroll
      for (int j = 0; j < kCPT; ++j) s[i][j] = 0.f;
    for (int d = 0; d < D; ++d) {
      float qv[kRPT], kv[kCPT];
#pragma unroll
      for (int i = 0; i < kRPT; ++i) qv[i] = qs[(ty + 16 * i) * Dp + d];
#pragma unroll
      for (int j = 0; j < kCPT; ++j) kv[j] = ks[(tx + 16 * j) * Dp + d];
#pragma unroll
      for (int i = 0; i < kRPT; ++i)
#pragma unroll
        for (int j = 0; j < kCPT; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

    // mask, online softmax; the weights go to shared memory
#pragma unroll
    for (int i = 0; i < kRPT; ++i) {
      bool live[kCPT];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < kCPT; ++j) {
        const int kpos = kt0 + tx + 16 * j;
        live[j] = row_ok[i] && kpos <= k_hi &&
                  (!a.causal || kpos <= qpos[i]) &&
                  (a.window <= 0 || qpos[i] - kpos < a.window);
        s[i][j] = live[j] ? s[i][j] * a.scale : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      mx = row_max(mx);
      const float m_new = fmaxf(m[i], mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kCPT; ++j) {
        const float p = live[j] ? expf(s[i][j] - m_new) : 0.f;
        sum += p;
        ps[(ty + 16 * i) * kPStride + tx + 16 * j] = p;
      }
      sum = row_sum(sum);
      const float corr = expf(m[i] - m_new);
      l[i] = l[i] * corr + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < DPT; ++c) acc[i][c] *= corr;
    }
    __syncthreads();

    // acc += p v over the tile's keys
    for (int kk = 0; kk < kKeys; ++kk) {
      float pv[kRPT], vv[DPT];
#pragma unroll
      for (int i = 0; i < kRPT; ++i) pv[i] = ps[(ty + 16 * i) * kPStride + kk];
#pragma unroll
      for (int c = 0; c < DPT; ++c) vv[c] = vs[kk * Dv + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < kRPT; ++i)
#pragma unroll
        for (int c = 0; c < DPT; ++c) acc[i][c] = fmaf(pv[i], vv[c], acc[i][c]);
    }
  }

  float* ob = out + (size_t)b * a.q_sb;
#pragma unroll
  for (int i = 0; i < kRPT; ++i) {
    if (!row_ok[i]) continue;
    const int r = ty + 16 * i;
    const int t = t0 + r / n_rep, h = kvh * n_rep + r % n_rep;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
    float* orow = ob + (size_t)t * a.q_ss + (size_t)h * a.q_sh;
#pragma unroll
    for (int c = 0; c < DPT; ++c) {
      const int col = tx + 16 * c;
      if (col < D) orow[col] = acc[i][c] * inv;
    }
  }
}

template <int DPT>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const size_t smem = smem_bytes(a.D, DPT);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  auto kern = flash_kernel<DPT>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((a.Sq + a.BQ - 1) / a.BQ, a.KV, a.B);
  kern<<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

cudaError_t launch_d(const Args& a, cudaStream_t stream) {
  const int cols = (a.D + 15) / 16;
  if (cols <= 1) return launch<1>(a, stream);
  if (cols <= 2) return launch<2>(a, stream);
  if (cols <= 4) return launch<4>(a, stream);
  if (cols <= 8) return launch<8>(a, stream);
  if (cols <= 16) return launch<16>(a, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// q, out: (B, Sq, H, D) elements at b*q_sb + s*q_ss + h*q_sh + d;
// k, v:   (B, Sk, KV, D) elements at b*k_sb + s*k_ss + h*k_sh + d.
int flash_attention(const void* q, const void* k, const void* v, void* out,
                    int B, int Sq, int Sk, int H, int KV, int D,
                    long long q_sb, long long q_ss, long long q_sh,
                    long long k_sb, long long k_ss, long long k_sh,
                    int causal, int window, int q_offset, float scale,
                    int dtype, void* stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0 || KV <= 0 || H % KV || D <= 0)
    return (int)cudaErrorInvalidValue;
  const int n_rep = H / KV;
  if (n_rep > kRows) return (int)cudaErrorInvalidValue;
  int bq = kRows / n_rep;
  if (bq > Sq) bq = Sq;
  using attn_core::aligned16;
  const int vec = D % 8 == 0 && q_sb % 8 == 0 && q_ss % 8 == 0 &&
                  q_sh % 8 == 0 && k_sb % 8 == 0 && k_ss % 8 == 0 &&
                  k_sh % 8 == 0 && aligned16(q) && aligned16(k) &&
                  aligned16(v) && aligned16(out);
  Args a{q, k, v, out, B, Sq, Sk, H, KV, D,
         q_sb, q_ss, q_sh, k_sb, k_ss, k_sh,
         causal, window, q_offset, bq, scale, vec};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch_d(a, s);
  if (dtype == 1) {
    return (int)attn_core::launch<FlashTC>(a, Sq, n_rep, KV, B, D, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
