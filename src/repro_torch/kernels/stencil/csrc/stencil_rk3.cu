// Fused three-stage SSP-RK3 step of the semilinear wave equation, one
// AMR block per batch row, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of the reference package
//   src/repro/kernels/stencil/stencil.py:stencil_rk3
// The plain PyTorch version it is held against is
// kernels/stencil/ref.py:stencil_rk3_ref (the batched
// amr/wave.py:fused_rk3_block).
//
// What it computes.  Block b holds u_ext[b] = (chi, Phi, Pi) on W = g + 2H
// cells (H = 3: one stencil radius per stage) at radii r_ext[b], and
// flags[b] = (left_phys, right_phys).  With L the centred-difference
// right-hand side
//   L(u) = (Pi, d_r Pi, (1/r^2) d_r (r^2 Phi) + chi^p)  on cells 1..W-2,
//   zero on cells 0 and W-1,
// where (1/r^2) d_r (r^2 Phi) becomes 3 d_r Phi where |r| < dr/2, and
// R() the physical-ghost refresh (left: cells 0..2 mirror cells 6..4 with
// parity (+, -, +); right: cells W-3..W-1 extrapolate linearly from
// cells W-5 and W-4), it returns cells H..W-H-1 of
//   u0 = R(u_ext);  u1 = R(u0 + dt L(u0));
//   u2 = R(3/4 u0 + 1/4 (u1 + dt L(u1)));
//   u3 = 1/3 u0 + 2/3 (u2 + dt L(u2)).
// (The reference refreshes u3 too; that touches only ghost cells, which
// are not returned.)  Every operation is in the reference's order; dr and
// dt arrive as float32, as the Pallas kernel casts them; chi^p is taken by
// repeated multiplication in the order of JAX's integer_pow; divisions
// are IEEE divisions (no --use_fast_math).  nvcc may contract a*b+c into
// one fma, so results can differ from the plain version in the last bits.
//
// Design.  One CUDA block owns a tile of up to kTile output columns of one
// AMR block: it loads the tile plus H cells per side of the three fields
// and of r into shared memory (coalesced, once), runs the three stages
// there with a barrier between them, and writes its (3, tile) outputs
// once.  At a tile side that is not a physical boundary the valid range
// shrinks by one cell per stage, and the H halo cells absorb exactly
// that.  A tile that holds a physical side of its block refreshes that
// side's ghosts from its own stage values (the left side needs cells
// H+1..2H, the right side cells W-H-2 and W-H-1, and the tile holding
// the side holds those), so tiles need nothing from each other.  The
// Pallas kernel's roll wrap-around is not carried over: it exists only
// because a pallas_call cannot capture array constants.  The tile makes
// any width work: the production grain of 2048, the shrinking widths of
// several steps per exchange, a whole level.
//
// What bounds it on the H100.  Each input is read once and the output
// written once: 4 (3 nb W + nb W + 2 nb + 3 nb g) bytes, 235 MB at the
// production batch (4096 blocks of grain 2048): 70 us at 3.35 TB/s.  The
// arithmetic is about 60 float32 operations per output point, 0.5 GFLOP
// there, 7.5 us at 67 TFLOP/s.  So the bytes bound it.  The halo cells are
// read once per tile (6 of 1030 per field and row), and r is read from
// memory though it is a linear function of the block's start.
//
// Layout: u_ext contiguous (nb, 3, W), r_ext contiguous (nb, W), flags
// contiguous (nb, 2) int32, out contiguous (nb, 3, W - 2H).  All float32.
//
// C interface (ctypes): pointers and the stream are void*, the launch
// returns cudaGetLastError() (cudaErrorInvalidValue for shapes it does not
// take) and the Python wrapper raises when it is not cudaSuccess.

#include <cuda_runtime.h>

namespace {

constexpr int kH = 3;                     // halo: 1 radius x 3 stages
constexpr int kFields = 3;                // chi, Phi, Pi
constexpr int kThreads = 256;
constexpr int kTile = 1024;               // output columns per CUDA block
constexpr int kTW = kTile + 2 * kH;       // loaded columns per CUDA block

// x^p in the order of JAX's integer_pow (binary exponentiation).
__device__ __forceinline__ float ipow(float x, int p) {
  if (p == 0) return 1.0f;
  int y = p < 0 ? -p : p;
  float acc = 0.0f;
  bool have = false;
  while (y > 0) {
    if (y & 1) {
      acc = have ? acc * x : x;
      have = true;
    }
    y >>= 1;
    if (y > 0) x = x * x;
  }
  return p < 0 ? 1.0f / acc : acc;
}

// L(u) at local column c of a tile of width w (zero at its edge cells,
// as the reference's rhs leaves its array's edge cells).
__device__ __forceinline__ void rhs_at(const float (*u)[kTW], const float* r,
                                       int c, int w, float dr, int p,
                                       float out[kFields]) {
  if (c == 0 || c == w - 1) {
    out[0] = out[1] = out[2] = 0.0f;
    return;
  }
  const float two_dr = 2.0f * dr;
  const float phi_m = u[1][c - 1], phi_p = u[1][c + 1];
  const float rm = r[c - 1], rp = r[c + 1], rc = r[c];
  float mono;
  if (fabsf(rc) < 0.5f * dr) {
    mono = 3.0f * (phi_p - phi_m) / two_dr;     // l'Hopital at r = 0
  } else {
    mono = (rp * rp * phi_p - rm * rm * phi_m) / two_dr / (rc * rc);
  }
  out[0] = u[2][c];
  out[1] = (u[2][c + 1] - u[2][c - 1]) / two_dr;
  out[2] = mono + ipow(u[0][c], p);
}

// The physical-ghost refresh of field f of a tile holding the block's
// left side (local column 0 is the block's column 0) and/or its right
// side (local column w-1 is the block's column W-1); one thread per field,
// left before right, as the reference orders them.
__device__ __forceinline__ void refresh(float (*u)[kTW], int f, int w,
                                        bool left, bool right) {
  if (left) {
    const float s = f == 1 ? -1.0f : 1.0f;
    u[f][0] = s * u[f][2 * kH];
    u[f][1] = s * u[f][2 * kH - 1];
    u[f][2] = s * u[f][2 * kH - 2];
  }
  if (right) {
    const float last = u[f][w - kH - 1];
    const float slope = last - u[f][w - kH - 2];
    for (int k = 0; k < kH; ++k) u[f][w - kH + k] = last + (k + 1) * slope;
  }
}

__global__ void __launch_bounds__(kThreads)
stencil_rk3_kernel(const float* __restrict__ u_ext,
                   const float* __restrict__ r_ext,
                   const int* __restrict__ flags, float* __restrict__ out,
                   int w_ext, int tiles, float dr, float dt, int p) {
  __shared__ float s_u0[kFields][kTW];    // stage 0 (refreshed input)
  __shared__ float s_a[kFields][kTW];     // stage 1
  __shared__ float s_b[kFields][kTW];     // stage 2
  __shared__ float s_r[kTW];

  const int g = w_ext - 2 * kH;
  const int b = blockIdx.x / tiles;
  const int tile = blockIdx.x - b * tiles;
  const int o0 = tile * kTile;             // first output column
  const int n_out = min(kTile, g - o0);
  const int w = n_out + 2 * kH;            // local width; local c = ext o0+c
  const bool left = tile == 0 && flags[2 * b] > 0;
  const bool right = tile == tiles - 1 && flags[2 * b + 1] > 0;
  const bool phys = left || right;

  const float* u_row = u_ext + (size_t)b * kFields * w_ext + o0;
  for (int c = threadIdx.x; c < w; c += kThreads) {
    s_r[c] = r_ext[(size_t)b * w_ext + o0 + c];
#pragma unroll
    for (int f = 0; f < kFields; ++f) s_u0[f][c] = u_row[f * w_ext + c];
  }
  __syncthreads();
  if (phys && threadIdx.x < kFields) refresh(s_u0, threadIdx.x, w, left, right);
  __syncthreads();

  // stage 1: u1 = u0 + dt L(u0)
  for (int c = threadIdx.x; c < w; c += kThreads) {
    float l[kFields];
    rhs_at(s_u0, s_r, c, w, dr, p, l);
#pragma unroll
    for (int f = 0; f < kFields; ++f) s_a[f][c] = s_u0[f][c] + dt * l[f];
  }
  __syncthreads();
  if (phys && threadIdx.x < kFields) refresh(s_a, threadIdx.x, w, left, right);
  __syncthreads();

  // stage 2: u2 = 3/4 u0 + 1/4 (u1 + dt L(u1))
  for (int c = threadIdx.x; c < w; c += kThreads) {
    float l[kFields];
    rhs_at(s_a, s_r, c, w, dr, p, l);
#pragma unroll
    for (int f = 0; f < kFields; ++f)
      s_b[f][c] = 0.75f * s_u0[f][c] + 0.25f * (s_a[f][c] + dt * l[f]);
  }
  __syncthreads();
  if (phys && threadIdx.x < kFields) refresh(s_b, threadIdx.x, w, left, right);
  __syncthreads();

  // stage 3: u3 = u0 / 3 + 2/3 (u2 + dt L(u2)), on the tile's outputs
  float* o_row = out + (size_t)b * kFields * g + o0;
  for (int j = threadIdx.x; j < n_out; j += kThreads) {
    const int c = j + kH;
    float l[kFields];
    rhs_at(s_b, s_r, c, w, dr, p, l);
#pragma unroll
    for (int f = 0; f < kFields; ++f)
      o_row[f * g + j] =
          s_u0[f][c] / 3.0f + (2.0f / 3.0f) * (s_b[f][c] + dt * l[f]);
  }
}

}  // namespace

extern "C" int stencil_rk3(const void* u_ext, const void* r_ext,
                           const void* flags, void* out, int nb, int w_ext,
                           float dr, float dt, int p, void* stream) {
  const int g = w_ext - 2 * kH;
  if (nb < 1 || g < 1) return (int)cudaErrorInvalidValue;
  const int tiles = (g + kTile - 1) / kTile;
  if ((long long)nb * tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  stencil_rk3_kernel<<<nb * tiles, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)u_ext, (const float*)r_ext, (const int*)flags,
      (float*)out, w_ext, tiles, dr, dt, p);
  return (int)cudaGetLastError();
}
