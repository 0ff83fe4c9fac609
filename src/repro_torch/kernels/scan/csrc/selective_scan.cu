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
// Design.  The recurrence is sequential in time and independent across
// (b, d, n).  A channel's N states are split over G = N / 2 lanes of
// one warp, two states each in registers; y_t is the lanes' partial
// dots summed by a butterfly of shuffles.  A block of 256 threads owns
// 256 / G channels of one batch row and walks all S steps itself (the
// Pallas grid's sequential chunk axis becomes this loop).  Per tile of
// `steps` time steps the block stages B_t and C_t (shared by every
// channel), dt and x of its channels in shared memory with coalesced
// loads, runs the tile, and stores its y tile back coalesced.  Two
// states per thread give one prompt of d_inner 8192 and state 16 256
// blocks (8 lanes per channel), so every one of the H100's 132 SMs
// has work at B = 1.  On an H100 at that prompt, 2 states per thread
// ran 1.4x faster than 1 and 1.2x faster than 4, and at the decode
// batch of 8 slots 2 and 4 tied.
//
// What bounds it on the H100.  Each input is read once and y, hT are
// written once: 4 (3 B S D + 2 B S N + D N + 2 B D N) bytes, about
// 153 MB for a 1536-token prompt at full width, 46 us at 3.35 TB/s.
// The work is one exp and about six flops per (t, d, n), 201 M of each
// for that prompt, 21 us at the 67 TFLOP/s float32 peak; the exps go to
// the special-function units, which that peak does not count.  So the
// bytes bound it on paper.  This first version keeps each thread on a
// chain of S dependent steps and is expected to run well above that.
//
// Layout: dt, x, y contiguous (B, S, D); B, C contiguous (B, S, N);
// a contiguous (D, N); h0, hT contiguous (B, D, N).  hT may alias h0
// (each thread reads its states before it writes them): the decode
// step writes the new state over the cache's.  All float32.
//
// C interface (ctypes): pointers and the stream are void*, the launch
// returns cudaGetLastError() (cudaErrorInvalidValue for shapes it does
// not take) and the Python wrapper raises when it is not cudaSuccess.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

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

}  // namespace

extern "C" {

// N must be a power of two with 2 <= N <= 64 (N / 2 lanes of one warp
// per channel).  h0 may be null (zero state).  Returns a cudaError_t.
int selective_scan(const void* dt, const void* x, const void* b,
                   const void* c, const void* a, const void* h0, void* y,
                   void* hT, int B, int S, int D, int N, void* stream) {
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

}  // extern "C"
