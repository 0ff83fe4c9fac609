// Mamba-1 selective scan, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of the reference package
//   src/repro/kernels/scan/selective_scan.py:selective_scan
// The plain PyTorch versions it is held against live in
// kernels/scan/ref.py (selective_scan_fused_ref, selective_scan_ref).
//
// What it computes.  Per batch row b and channel d, from the state
// h0[b, d, :] (zero when no state is given), for t = 0 .. S-1:
//   da_t  = exp(dt[b,t,d] * a[d,n])                    (n = 0 .. N-1)
//   dbx_t = (dt[b,t,d] * x[b,t,d]) * B[b,t,n]
//   h_t   = da_t * h_{t-1} + dbx_t
//   y[b,t,d] = sum_n h_t[n] * C[b,t,n]
// and the final state hT[b, d, :] = h_{S-1}.  The Pallas kernel takes
// da and dbx precomputed, (B, S, D, N) f32 each, starts from zero and
// drops the final state; with h0 = 0 and the same dt/x/B/a this is its
// function.  Forming da and dbx in registers keeps every (B, S, D, N)
// tensor out of device memory (at d_inner 8192 and state 16 one such
// tensor of a 1536-token prompt is 0.8 GB), and the state in and out
// is what the serving path needs: a prefill starts from zero and the
// decode cache keeps hT, one step at a time from it.  `expf` is the
// accurate one (no --use_fast_math).
//
// Two kernels, one function.  The wrapper (`scan.py`) picks one per
// call with `scan.use_chunked`: the chunked kernel for a prompt (S > 1)
// whose channel count is a multiple of 4, whose dt, x and y are 16-byte
// aligned and whose state size is at most 32 (its shared memory); the
// sequential kernel for a decode step (S = 1) and anything else.
//
// The sequential kernel.  A channel's N states are split over
// G = N / 2 lanes of one warp, two states each in registers; y_t is the
// lanes' partial dots summed by a butterfly of shuffles.  A block of
// 256 threads owns 256 / G channels of one batch row and walks all S
// steps itself.  Per tile of `steps` time steps the block stages B_t
// and C_t (shared by every channel), dt and x of its channels in shared
// memory with coalesced loads, runs the tile, and stores its y tile
// back coalesced.  At the decode batch (8 slots x 1 step) a call moves
// 9.7 MB and its 2,048 blocks fill the card; on a prompt at B = 1 every
// thread walks a chain of S dependent steps and the card's 132 SMs hold
// 16 warps of 64 each (7.9x the bytes bound on an H100).
//
// The chunked kernel runs one channel's recurrence in parallel over
// time.  A block owns 32 channels of one batch row (8 warps, 4 channels
// each) and walks the prompt in tiles of kTile = 128 steps; within a
// tile each channel's 8 lanes ("groups") take kItems = 16 consecutive
// steps each.  Per state n (a loop; the states are independent):
//   1. each lane forms da_k = exp(dt_k a_n) and dbx_k = (dt_k x_k) B_k[n]
//      for its 16 steps, keeps both in registers, and runs them from a
//      zero state (group 0: from the channel's carried state) to its
//      end state H, and the decay product A = da_0 da_1 ... da_15;
//   2. the 8 lanes compose their (A, H) pairs in order by a
//      Hillis-Steele scan of warp shuffles (3 rounds), which leaves in
//      lane g the true state at the end of group g;
//   3. lane g takes group g - 1's end state by one shuffle (group 0 the
//      carried state, which it then replaces by group 7's: the tile's
//      end state) and runs its 16 steps again from it with the da_k and
//      dbx_k it kept, adding h_k C_k[n] into y_k.
// So every exp is evaluated once.  y accumulates over n in registers
// and is stored once per tile.  At B = 1 and d_inner 8192 the grid is
// 256 blocks, two resident on each SM (16 warps, at most 128 registers
// a thread), and each thread has 16 independent exps per state to hide
// latency with.  The kernel is instantiated per state size (2 to 32),
// so its copy loops have fixed trip counts.
//
// Loads: dt and x tiles (128 steps x 32 channels, one 128-byte row a
// step) arrive by 16-byte cp.async, coalesced, into shared memory with
// the 16-byte chunks of row t placed at chunk j ^ group(t), so a lane's
// reads of its own 16 steps hit 32 distinct banks.  B_t and C_t are
// shared by the block's channels; they arrive by 4-byte cp.async
// (consecutive threads, consecutive floats) into a [n][group][item]
// layout, so a lane reads its 16 steps of one state as four float4s.
// Tiles are double-buffered: the next tile's copies are in flight while
// this one computes.  y is written over the tile's x slots (each slot
// is read and written by the same thread) and stored back coalesced.
// The carried states and a live in shared memory.  Steps past S and
// channels past D are zero-filled: dt = 0 gives da = 1 and dbx = 0, so
// they carry the state through unchanged.
//
// Float order.  Within a group the steps run in the sequential order.
// The composition adds, at each group end, at most three roundings (one
// fused multiply-add a scan round) and multiplies by A, the product of
// the same rounded da_k the sequential order multiplies by one at a
// time; `chip_smoke.py`'s `scan_serve_bounds` derives its rounding
// bound for this order.
//
// What bounds it on the H100.  Each input is read once and y, hT are
// written once: 4 (3 B S D + 2 B S N + D N + 2 B D N) bytes, about
// 153 MB for a 1536-token prompt at full width, 46 us at 3.35 TB/s.
// The work is one exp per (t, d, n), 201 M for that prompt; the
// special-function units give 16 a clock per SM, 4.18e12 a second at
// 1.98 GHz, so 48 us: at state 16 the exps, not the bytes, are the
// floor (1.07x).  The accurate expf besides costs seven more
// instructions and its argument one, so the chunked kernel issues
// about 17 instructions per (t, d, n), which the issue rate (four warp
// instructions a clock per SM) makes the harder limit; the sequential
// kernel issues fewer but from too few warps at B = 1.
//
// Layout: dt, x, y contiguous (B, S, D); B, C contiguous (B, S, N);
// a contiguous (D, N); h0, hT contiguous (B, D, N).  hT may alias h0
// (each block reads its channels' states before it writes them): the
// decode step writes the new state over the cache's.  All float32.
//
// C interface (ctypes): pointers and the stream are void*, the launch
// returns cudaGetLastError() (cudaErrorInvalidValue for shapes it does
// not take) and the Python wrapper raises when it is not cudaSuccess.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

// -- the sequential kernel ----------------------------------------------


constexpr int kThreads = 256;
constexpr int kNpl = 2;                  // states per thread
constexpr int kSmemBudget = 48 * 1024;   // the default dynamic limit
constexpr int kMaxSteps = 64;            // time steps per staged tile

__global__ void __launch_bounds__(kThreads)
selective_scan_kernel(const float* __restrict__ dt,
                      const float* __restrict__ x,
                      const float* __restrict__ bm,
                      const float* __restrict__ cm,
                      const float* __restrict__ a, const float* h0,
                      float* __restrict__ y, float* hT, int S, int D, int N,
                      int steps) {
  const int G = N / kNpl;                // lanes per channel
  const int CH = kThreads / G;           // channels per block
  extern __shared__ float smem[];
  float* s_b = smem;                     // [steps][N]
  float* s_c = s_b + steps * N;          // [steps][N]
  float* s_dt = s_c + steps * N;         // [steps][CH]
  float* s_x = s_dt + steps * CH;        // [steps][CH]
  float* s_y = s_x + steps * CH;         // [steps][CH]

  const int tid = threadIdx.x;
  const int ch = tid / G;
  const int lane = tid - ch * G;
  const int bi = blockIdx.y;
  const int d0 = blockIdx.x * CH;
  const int d = d0 + ch;
  const bool live = d < D;
  const int n0 = lane * kNpl;
  const size_t st = ((size_t)bi * D + (live ? d : 0)) * N + n0;

  float h[kNpl], av[kNpl];
#pragma unroll
  for (int k = 0; k < kNpl; ++k) {
    av[k] = live ? a[(size_t)d * N + n0 + k] : 0.f;
    h[k] = (live && h0 != nullptr) ? h0[st + k] : 0.f;
  }

  const size_t row0 = (size_t)bi * S;
  for (int t0 = 0; t0 < S; t0 += steps) {
    const int tn = min(steps, S - t0);
    __syncthreads();                     // the last tile's y is stored
    const size_t bc0 = (row0 + t0) * N;
    for (int i = tid; i < tn * N; i += kThreads) {
      s_b[i] = bm[bc0 + i];
      s_c[i] = cm[bc0 + i];
    }
    for (int i = tid; i < tn * CH; i += kThreads) {
      const int tt = i / CH;
      const int dd = d0 + (i - tt * CH);
      const size_t off = (row0 + t0 + tt) * D + dd;
      s_dt[i] = dd < D ? dt[off] : 0.f;
      s_x[i] = dd < D ? x[off] : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int tt = 0; tt < tn; ++tt) {
      const float dtv = s_dt[tt * CH + ch];
      const float dx = dtv * s_x[tt * CH + ch];
      const float* bt = s_b + tt * N + n0;
      const float* ct = s_c + tt * N + n0;
      float acc = 0.f;
#pragma unroll
      for (int k = 0; k < kNpl; ++k) {
        h[k] = expf(dtv * av[k]) * h[k] + dx * bt[k];
        acc += h[k] * ct[k];
      }
      for (int off = G >> 1; off > 0; off >>= 1)
        acc += __shfl_xor_sync(0xffffffffu, acc, off);
      if (lane == 0) s_y[tt * CH + ch] = acc;
    }
    __syncthreads();
    for (int i = tid; i < tn * CH; i += kThreads) {
      const int tt = i / CH;
      const int dd = d0 + (i - tt * CH);
      if (dd < D) y[(row0 + t0 + tt) * D + dd] = s_y[i];
    }
  }
  if (live) {
#pragma unroll
    for (int k = 0; k < kNpl; ++k) hT[st + k] = h[k];
  }
}


// -- the chunked kernel -------------------------------------------------

constexpr int kGroups = 8;                    // lanes per channel
constexpr int kItems = 16;                    // steps per lane
constexpr int kTile = kGroups * kItems;       // steps per tile
constexpr int kCh = 32;                       // channels per block
constexpr int kChThreads = kCh * kGroups;     // 256: 4 channels a warp
constexpr int kChunks = kCh / 4;              // 16-byte chunks a row
constexpr int kRows = kTile * kCh;            // floats of a dt or x tile
constexpr int kGroupStride = kItems + 4;      // floats of one group's B
constexpr int kStateStride = kGroups * kGroupStride + 4;  // one state's
// each thread's share of a tile's copies: dt and x rows in 16-byte
// chunks, one chunk column a thread, kRowStep rows apart
constexpr int kRowCopies = kTile * kChunks / kChThreads;
constexpr int kRowStep = kChThreads / kChunks;

static_assert(kChunks == kGroups, "the swizzle XORs a chunk by a group");
static_assert(kItems % 4 == 0, "B and C are read as float4");
static_assert(kTile * kChunks % kChThreads == 0, "even row copies");
static_assert(kTile * 2 % kChThreads == 0, "even B and C copies at N 2");

__host__ __device__ constexpr int chunked_smem_floats(int n) {
  // dt and x of two stages, B and C of two stages, carried states, a
  return 4 * kRows + 4 * n * kStateStride + 2 * kCh * n;
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(bytes));
}

// Where step t's chunk j of a dt, x or y tile lies: chunk j ^ group(t).
__device__ __forceinline__ int row_slot(int t, int j) {
  return t * kCh + ((j ^ (t / kItems)) << 2);
}

// Where step t of state n lies in a B or C tile: [n][group][item].
__device__ __forceinline__ int bc_slot(int n, int t) {
  return n * kStateStride + (t / kItems) * kGroupStride + t % kItems;
}

// Start one tile's copies (steps t0 .. t0 + kTile - 1, zero past S and
// past D) into one stage, one commit group.  Each thread takes the same
// slots every tile: dt and x chunk column tid % kChunks of rows
// tid / kChunks + kRowStep r; B and C state tid % N of steps
// tid / N + (kChThreads / N) r.
template <int N>
__device__ __forceinline__ void copy_tile(
    float* s_dt, float* s_x, float* s_b, float* s_c,
    const float* __restrict__ dt, const float* __restrict__ x,
    const float* __restrict__ bm, const float* __restrict__ cm, int S, int D,
    int tile) {
  constexpr int kBcStep = kChThreads / N;
  const int tid = threadIdx.x;
  const int ct = tid / kChunks, cj = tid % kChunks;
  const int bt = tid / N, bn = tid % N;
  const int d0 = blockIdx.x * kCh;
  const int t0 = tile * kTile, tn = min(kTile, S - t0);
  const size_t row = (size_t)blockIdx.y * S + t0;  // the tile's first row
  const bool cols = d0 + 4 * cj < D;
  const size_t first = (row + ct) * D + d0 + 4 * cj;
#pragma unroll
  for (int r = 0; r < kRowCopies; ++r) {
    const int t = ct + kRowStep * r;
    const bool ok = cols && t < tn;
    const size_t off = ok ? first + (size_t)kRowStep * r * D : 0;
    cp_async16(s_dt + row_slot(t, cj), dt + off, ok ? 16 : 0);
    cp_async16(s_x + row_slot(t, cj), x + off, ok ? 16 : 0);
  }
#pragma unroll
  for (int r = 0; r < kTile / kBcStep; ++r) {
    const int t = bt + kBcStep * r;
    const bool ok = t < tn;
    const size_t off = ok ? (row + t) * N + bn : 0;
    cp_async4(s_b + bc_slot(bn, t), bm + off, ok ? 4 : 0);
    cp_async4(s_c + bc_slot(bn, t), cm + off, ok ? 4 : 0);
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__global__ void __launch_bounds__(kChThreads, 2)
selective_scan_chunked_kernel(const float* __restrict__ dt,
                              const float* __restrict__ x,
                              const float* __restrict__ bm,
                              const float* __restrict__ cm,
                              const float* __restrict__ a, const float* h0,
                              float* __restrict__ y, float* hT, int S,
                              int D) {
  constexpr int kBc = N * kStateStride;       // floats of a B or C tile
  extern __shared__ __align__(16) float smem[];
  float* s_h = smem + 4 * kRows + 4 * kBc;    // carried states [c][n]
  float* s_a = s_h + kCh * N;                 // a [c][n]
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane % kGroups;
  const int c = warp * 4 + lane / kGroups;
  const int d0 = blockIdx.x * kCh;
  const size_t row0 = (size_t)blockIdx.y * S;
  const size_t st0 = ((size_t)blockIdx.y * D + d0) * N;  // block's states

  for (int i = tid; i < kCh * N; i += kChThreads) {
    const bool live = d0 + i / N < D;
    s_h[i] = (live && h0 != nullptr) ? h0[st0 + i] : 0.f;
    s_a[i] = live ? a[(size_t)d0 * N + i] : 0.f;
  }
  // this lane's slot of step g * kItems + k in the dt and x tiles
  const int slot = g * kItems * kCh + ((warp ^ g) << 2) + lane / kGroups;
  const unsigned full = 0xffffffffu;
  const int ntiles = (S + kTile - 1) / kTile;
  copy_tile<N>(smem, smem + kRows, smem + 4 * kRows, smem + 4 * kRows + kBc,
               dt, x, bm, cm, S, D, 0);
  for (int tile = 0; tile < ntiles; ++tile) {
    const int stage = tile & 1;
    float* s_dt = smem + stage * 2 * kRows;
    float* s_x = s_dt + kRows;
    const float* s_b = smem + 4 * kRows + stage * 2 * kBc;
    const float* s_c = s_b + kBc;
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();  // this tile has landed; the last tile's y is stored
    if (tile + 1 < ntiles) {
      float* o_dt = smem + (stage ^ 1) * 2 * kRows;
      float* o_b = smem + 4 * kRows + (stage ^ 1) * 2 * kBc;
      copy_tile<N>(o_dt, o_dt + kRows, o_b, o_b + kBc, dt, x, bm, cm, S, D,
                   tile + 1);
    }
    float dtv[kItems], dxv[kItems], yv[kItems];
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      dtv[k] = s_dt[slot + k * kCh];
      dxv[k] = dtv[k] * s_x[slot + k * kCh];
      yv[k] = 0.f;
    }
    const float4* b4 = reinterpret_cast<const float4*>(s_b + g * kGroupStride);
    const float4* c4 = reinterpret_cast<const float4*>(s_c + g * kGroupStride);
#pragma unroll 1
    for (int n = 0; n < N; ++n) {
      const float an = s_a[c * N + n];
      const float carry = g == 0 ? s_h[c * N + n] : 0.f;
      float da[kItems], dbx[kItems];
      float h = carry, A = 1.f;
#pragma unroll
      for (int q = 0; q < kItems / 4; ++q) {
        const float4 bq = b4[n * kStateStride / 4 + q];
        const float bv[4] = {bq.x, bq.y, bq.z, bq.w};
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int k = 4 * q + r;
          da[k] = expf(dtv[k] * an);
          dbx[k] = dxv[k] * bv[r];
          h = fmaf(da[k], h, dbx[k]);
          A *= da[k];
        }
      }
      // inclusive composition over the channel's groups, in order
#pragma unroll
      for (int off = 1; off < kGroups; off <<= 1) {
        const float au = __shfl_up_sync(full, A, off, kGroups);
        const float hu = __shfl_up_sync(full, h, off, kGroups);
        if (g >= off) {
          h = fmaf(A, hu, h);
          A *= au;
        }
      }
      // group g starts from group g - 1's end; group 0 from the carry,
      // which becomes group 7's end: the tile's end state
      const float prev = __shfl_sync(full, h, (lane & ~(kGroups - 1)) |
                                                  ((g + kGroups - 1) %
                                                   kGroups));
      if (g == 0) s_h[c * N + n] = prev;
      h = g == 0 ? carry : prev;
#pragma unroll
      for (int q = 0; q < kItems / 4; ++q) {
        const float4 cq = c4[n * kStateStride / 4 + q];
        const float cv[4] = {cq.x, cq.y, cq.z, cq.w};
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int k = 4 * q + r;
          h = fmaf(da[k], h, dbx[k]);
          yv[k] = fmaf(h, cv[r], yv[k]);
        }
      }
    }
#pragma unroll
    for (int k = 0; k < kItems; ++k) s_x[slot + k * kCh] = yv[k];
    __syncthreads();
    // the y tile, out as the dt rows came in
    const int ct = tid / kChunks, cj = tid % kChunks;
    const int tn = min(kTile, S - tile * kTile);
    float* yt = y + (row0 + (size_t)tile * kTile + ct) * D + d0 + 4 * cj;
#pragma unroll
    for (int r = 0; r < kRowCopies; ++r) {
      const int t = ct + kRowStep * r;
      if (d0 + 4 * cj < D && t < tn)
        *reinterpret_cast<float4*>(yt + (size_t)kRowStep * r * D) =
            *reinterpret_cast<const float4*>(s_x + row_slot(t, cj));
    }
  }
  __syncthreads();
  for (int i = tid; i < kCh * N; i += kChThreads)
    if (d0 + i / N < D) hT[st0 + i] = s_h[i];
}

template <int N>
int launch_chunked(const float* dt, const float* x, const float* b,
                   const float* c, const float* a, const float* h0,
                   float* y, float* hT, int B, int S, int D,
                   cudaStream_t stream) {
  constexpr int kSmem = chunked_smem_floats(N) * (int)sizeof(float);
  static bool sized = false;  // the attributes hold for every launch
  if (!sized) {
    cudaError_t err = cudaFuncSetAttribute(
        selective_scan_chunked_kernel<N>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(
          selective_scan_chunked_kernel<N>,
          cudaFuncAttributePreferredSharedMemoryCarveout,
          cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return err;
    sized = true;
  }
  dim3 grid((D + kCh - 1) / kCh, B);
  selective_scan_chunked_kernel<N><<<grid, kChThreads, kSmem, stream>>>(
      dt, x, b, c, a, h0, y, hT, S, D);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// N must be a power of two with 2 <= N <= 64 (N / 2 lanes of one warp
// per channel).  h0 may be null (zero state).  Returns a cudaError_t.
int selective_scan_sequential(const void* dt, const void* x, const void* b,
                              const void* c, const void* a, const void* h0,
                              void* y, void* hT, int B, int S, int D, int N,
                              void* stream) {
  if (B < 1 || S < 0 || D < 1 || N < kNpl || N > 32 * kNpl ||
      (N & (N - 1)) != 0 || B > 65535)
    return cudaErrorInvalidValue;
  const int CH = kThreads / (N / kNpl);
  const int per_step = (2 * N + 3 * CH) * (int)sizeof(float);
  int steps = kSmemBudget / per_step;
  if (steps > kMaxSteps) steps = kMaxSteps;
  if (steps > S) steps = S > 0 ? S : 1;  // a decode step stages one
  dim3 grid((D + CH - 1) / CH, B);
  selective_scan_kernel<<<grid, kThreads, steps * per_step,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(dt), static_cast<const float*>(x),
      static_cast<const float*>(b), static_cast<const float*>(c),
      static_cast<const float*>(a), static_cast<const float*>(h0),
      static_cast<float*>(y), static_cast<float*>(hT), S, D, N, steps);
  return cudaGetLastError();
}

// S >= 1; D a multiple of 4 with dt, x and y 16-byte aligned; N a power
// of two with 2 <= N <= 32.  h0 may be null (zero state).  Returns a
// cudaError_t.
int selective_scan_chunked(const void* dt, const void* x, const void* b,
                           const void* c, const void* a, const void* h0,
                           void* y, void* hT, int B, int S, int D, int N,
                           void* stream) {
  if (B < 1 || S < 1 || D < 1 || D % 4 != 0 || B > 65535)
    return cudaErrorInvalidValue;
  const auto* f_dt = static_cast<const float*>(dt);
  const auto* f_x = static_cast<const float*>(x);
  const auto* f_b = static_cast<const float*>(b);
  const auto* f_c = static_cast<const float*>(c);
  const auto* f_a = static_cast<const float*>(a);
  const auto* f_h0 = static_cast<const float*>(h0);
  auto* f_y = static_cast<float*>(y);
  auto* f_hT = static_cast<float*>(hT);
  auto* st = static_cast<cudaStream_t>(stream);
  switch (N) {
    case 2:
      return launch_chunked<2>(f_dt, f_x, f_b, f_c, f_a, f_h0, f_y, f_hT, B,
                               S, D, st);
    case 4:
      return launch_chunked<4>(f_dt, f_x, f_b, f_c, f_a, f_h0, f_y, f_hT, B,
                               S, D, st);
    case 8:
      return launch_chunked<8>(f_dt, f_x, f_b, f_c, f_a, f_h0, f_y, f_hT, B,
                               S, D, st);
    case 16:
      return launch_chunked<16>(f_dt, f_x, f_b, f_c, f_a, f_h0, f_y, f_hT,
                                B, S, D, st);
    case 32:
      return launch_chunked<32>(f_dt, f_x, f_b, f_c, f_a, f_h0, f_y, f_hT,
                                B, S, D, st);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // extern "C"
