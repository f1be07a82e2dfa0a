// Goursat-PDE signature-kernel forward for Hopper (sm_90a), three entry points.
//
// Replaces the Pallas TPU kernels of the JAX package:
//   sigkernel_pde_fwd        <- repro/kernels/sigkernel_pde/kernel.py:fwd_kernel
//                               (+ _wavefront), save_cps=False mode: Delta
//                               precomputed in device memory.
//   sigkernel_pde_fwd_fused  <- kernel.py:fused_fwd_kernel: Delta built in the
//                               kernel from increments, matched pair lists.
//   sigkernel_pde_gram_fused <- kernel.py:fused_gram_kernel: Delta built in the
//                               kernel, one block per (row path, column path).
//
// Design.  One thread block solves one Goursat problem.  The TPU ran the
// strip axis of its grid in order on one core and carried the boundary row in
// VMEM scratch across grid steps; GPU blocks run in no order, so the strip
// loop lives inside the block and the carried boundary row `brow` (length
// ny+T+1; plus `brow2` = the row above it for the order-2 stencil) sits in
// shared memory.  Thread r owns refined row strip_top + r and at wavefront
// step t computes cell (r, c = t - r) when 0 <= c < ny.  The last two
// anti-diagonals are exchanged between lanes through three rotating buffers
// in shared memory with one __syncthreads() per step (this replaces the
// jnp.roll lane shifts of kernel.py:160-177); lanes 0 and 1 read the carried
// rows exactly as the TPU kernel's where(lane == 0/1, ...) does.  Row T-1
// overwrites brow in place (kernel.py:187-191) and row T-2 writes brow2
// (:193-198); reads trail those writes, except for T == 2 where one extra
// barrier orders the reads of a step before its writes.  Dyadic refinement is
// index arithmetic: p = Delta[row >> lam1, col >> lam2] * 2^-(lam1+lam2), and
// the order-2 data-gridline fallback is
// edge = (lane % 2^lam1 == 0) | ((t - lane) % 2^lam2 == 0) (kernel.py:173).
// Rows at or past Lx read p = 0: that is the zero padding of Lx to the strip
// (JAX ops.py:49-54), done by index arithmetic instead of a padded copy, and
// k[nx, ny] is taken from the lane that owns the last real row, so padding
// rows below it never touch the result.
//
// Arithmetic.  Every stencil operation rounds on its own (__fmul_rn and
// friends, never contracted into an FMA) in the order of stencil.py, and the
// fused kernels accumulate the dot product <dx[row], dy[col]> in float64 and
// round it once, which is what the plain version's float64 einsum gives.  So
// each kernel computes every cell bit for bit like its plain PyTorch version
// (bar a dot product within 1e-16 of a float32 rounding boundary), including
// the bf16 interiors, where one flipped rounding would otherwise spread.
//
// What bounds it on an H100.  The precomputed-Delta kernel reads Delta once
// (B*Lx*Ly*4 bytes) and does ~13-19 flops per refined cell, so its bound is
// the 3.35 TB/s memory rate.  Each thread walks its own Delta row, so a warp's
// load at one step touches 32 rows: loads are issued kGroup steps ahead into
// registers, each 32-byte sector read is fully used over those steps, and the
// refined repeats (2^lam2 columns) reuse one load.  The fused kernels read
// only the increments and are bound by operations: this first design
// recomputes the d-long dot product once per refined cell, with the strip's
// dx rows staged in shared memory as float64 at an odd row stride (no bank
// conflicts) and dy rows passing through a float64 ring in shared memory as
// the wavefront moves right; each thread forms the dot products of its next
// kGroup cells together.  Tensor cores are not used yet.  The wavefront
// itself is latency-bound: ny+T-1 dependent steps per strip, each a barrier
// plus a short chain of dependent operations, so few large problems (one
// block per SM) want tall strips and many small problems want short
// strips; ops.py's choose_T picks T accordingly.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kGroup = 8;  // Delta loads issued this many wavefront steps ahead

enum Mode { kDelta = 0, kFusedPairs = 1, kFusedGram = 2 };

template <bool BF16>
__device__ __forceinline__ float round_interior(float x) {
  // f32 -> bf16 -> f32, round to nearest even, as jnp.astype does
  if (BF16) return __bfloat162float(__float2bfloat16_rn(x));
  return x;
}

// Each operation rounds on its own (no FMA contraction), as the plain PyTorch
// version's elementwise ops do: the kernel and its plain version then compute
// every cell bit for bit alike.
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }

// Shared memory bytes the kernel lays out for one block (kernel.py mirrors
// it): fused kernels first hold, as float64 at an odd row stride, the
// strip's R = T >> lam1 rows of dx and a ring of T + kGroup rows of dy; then
// every kernel holds the carried row(s) of ny+T+1 floats and three
// anti-diagonals of T floats.
__host__ __device__ inline int64_t smem_bytes(int mode, bool order2, int T, int ny,
                                              int lam1, int d) {
  int64_t n = 4 * ((order2 ? 2 : 1) * ((int64_t)ny + T + 1) + 3 * (int64_t)T);
  if (mode != kDelta) n += 8 * (int64_t)((T >> lam1) + T + kGroup) * (d | 1);
  return n;
}

template <int MODE, bool ORDER2, bool BF16>
__global__ void __launch_bounds__(kMaxThreads)
goursat_fwd(const float* __restrict__ a, const float* __restrict__ b,
            float* __restrict__ out, int n_cols, int Lx, int Ly, int d,
            int lam1, int lam2) {
  extern __shared__ double smem[];
  const int T = blockDim.x;
  const int r = threadIdx.x;
  const int ny = Ly << lam2;
  const int W = ny + T + 1;
  const int R = T >> lam1;                     // unrefined rows per strip
  const int ds = d | 1;                        // odd stride: no bank conflicts
  const int NR = T + kGroup;                   // dy ring rows
  double* sdx = smem;                          // fused: the strip's dx rows
  double* sdy = smem + R * ds;                 // fused: dy row `col` at col % NR
  float* brow =
      reinterpret_cast<float*>(smem + (MODE == kDelta ? 0 : (int64_t)(R + NR) * ds));
  float* brow2 = brow + W;                     // k[strip_top - 1, c] (order 2)
  float* diag = brow + (ORDER2 ? 2 : 1) * W;   // 3 rotating anti-diagonals

  const int64_t prob = blockIdx.x;
  const float* delta = nullptr;
  const float* dx = nullptr;
  const float* dy = nullptr;
  if (MODE == kDelta) {
    delta = a + prob * (int64_t)Lx * Ly;
  } else {
    const int64_t ia = MODE == kFusedGram ? prob / n_cols : prob;
    const int64_t ib = MODE == kFusedGram ? prob % n_cols : prob;
    dx = a + ia * (int64_t)Lx * d;
    dy = b + ib * (int64_t)Ly * d;
  }
  for (int i = r; i < (ORDER2 ? 2 : 1) * W; i += T) brow[i] = 1.0f;

  const float scale = ldexpf(1.0f, -(lam1 + lam2));  // exact power of two
  const int n_strips = (Lx + R - 1) / R;
  const int steps = ny + T - 1;
  const int m1 = (1 << lam1) - 1;
  const int m2 = (1 << lam2) - 1;
  const int lrow = r >> lam1;              // this thread's unrefined row in the strip
  // lane holding refined row nx-1 in the last strip: its cell (., ny-1) is
  // k[nx, ny], read before any padding row below it
  const int r_out = (Lx << lam1) - 1 - (n_strips - 1) * T;
  const float one = 1.0f, half = 0.5f, sixth = 1.0f / 6.0f, twelfth = 1.0f / 12.0f;

  for (int s = 0; s < n_strips; ++s) {
    const int row = s * R + lrow;
    const bool row_ok = row < Lx;          // rows past Lx: zero padding
    if (MODE != kDelta) {
      for (int i = r; i < R * d; i += T) {
        const int rr = i / d, k = i - rr * d;
        const int gr = s * R + rr;
        sdx[rr * ds + k] = gr < Lx ? (double)dx[(int64_t)gr * d + k] : 0.0;
      }
    }
    __syncthreads();  // ones / staged rows / previous strip's last step

    // pbuf[k]: the unrefined Delta entry of this thread's cell at step t0 + k
    const float* drow =
        (MODE == kDelta && row_ok) ? delta + (int64_t)row * Ly : nullptr;
    float pbuf[kGroup];
    if (MODE == kDelta) {
#pragma unroll
      for (int k = 0; k < kGroup; ++k) {
        const int c = k - r;
        pbuf[k] = (drow && c >= 0 && c < ny) ? __ldg(drow + (c >> lam2)) : 0.0f;
      }
    }
    int loaded = -1;  // fused: highest dy row (unrefined column) in the ring

    for (int t0 = 0; t0 < steps; t0 += kGroup) {
      float pnext[kGroup];
      if (MODE == kDelta) {
#pragma unroll
        for (int k = 0; k < kGroup; ++k) {
          const int c = t0 + kGroup + k - r;
          pnext[k] = (drow && c >= 0 && c < ny) ? __ldg(drow + (c >> lam2)) : 0.0f;
        }
      } else {
        // Bring the group's new dy rows into the ring (coalesced), then form
        // this thread's kGroup dot products <dx[row], dy[col]> at once: dx[q]
        // is read once for all of them, lanes read dy rows at an odd stride.
        // Slots overwritten here held columns below (t0 - T + 1) >> lam2,
        // which no lane needs any more.
        const int hi = min((t0 + kGroup - 1) >> lam2, Ly - 1);
        if (hi > loaded) {  // uniform across the block
          for (int i = r; i < (hi - loaded) * d; i += T) {
            const int col = loaded + 1 + i / d, q = i - (col - loaded - 1) * d;
            sdy[(col % NR) * ds + q] = (double)__ldg(dy + (int64_t)col * d + q);
          }
          loaded = hi;
          __syncthreads();
        }
        int slot[kGroup];
        double acc[kGroup];
#pragma unroll
        for (int k = 0; k < kGroup; ++k) {
          const int c = min(max(t0 + k - r, 0), ny - 1);
          slot[k] = ((c >> lam2) % NR) * ds;
          acc[k] = 0.0;
        }
        const double* xr = sdx + lrow * ds;
        for (int q = 0; q < d; ++q) {
          const double xq = xr[q];
#pragma unroll
          for (int k = 0; k < kGroup; ++k) acc[k] = fma(xq, sdy[slot[k] + q], acc[k]);
        }
#pragma unroll
        for (int k = 0; k < kGroup; ++k) {
          const int c = t0 + k - r;
          // one rounding: the correctly rounded dot product
          pbuf[k] = (row_ok && c >= 0 && c < ny) ? (float)acc[k] : 0.0f;
        }
      }
#pragma unroll
      for (int k = 0; k < kGroup; ++k) {
        const int t = t0 + k;
        if (t >= steps) break;  // uniform across the block
        const int c = t - r;
        float cur = 0.0f;
        if (c >= 0 && c < ny) {
          const float p = mul(pbuf[k], scale);
          const float* prev = diag + ((t + 2) % 3) * T;   // step t-1
          const float* prev2 = diag + ((t + 1) % 3) * T;  // step t-2
          const float left = c == 0 ? one : prev[r];
          const float up = r == 0 ? brow[t + 1] : prev[r - 1];
          const float upleft = c == 0 ? one : (r == 0 ? brow[t] : prev2[r - 1]);
          // A = 1 + p/2 + p²/12 and B1 = 1 − p²/12, in stencil.py's order
          const float p2 = mul(mul(twelfth, p), p);
          const float A = add(add(one, mul(half, p)), p2);
          const float B1 = sub(one, p2);
          if (ORDER2) {
            const bool edge = (r & m1) == 0 || (c & m2) == 0;
            const float Bq = edge ? B1 : add(sub(one, mul(sixth, p)), p2);
            const float Cq = edge ? 0.0f : mul(twelfth, p);
            const float k_dl = c <= 1 ? one : prev2[r];
            const float k_ul = r >= 2 ? prev2[r - 2] : (r == 1 ? brow[t] : brow2[t + 1]);
            cur = sub(sub(mul(add(left, up), A), mul(upleft, Bq)),
                      mul(add(k_dl, k_ul), Cq));
          } else {
            cur = sub(mul(add(left, up), A), mul(upleft, B1));
          }
          cur = round_interior<BF16>(cur);
          if (s == n_strips - 1 && r == r_out && c == ny - 1) out[prob] = cur;
        }
        if (T == 2) __syncthreads();  // lane 1 writes brow[t], which lane 0 read
        diag[(t % 3) * T + r] = cur;
        if (r == T - 1 && t >= T - 1) brow[t - T + 2] = cur;
        if (ORDER2 && r == T - 2 && t >= T - 2) brow2[t - T + 3] = cur;
        __syncthreads();
      }
      if (MODE == kDelta) {
#pragma unroll
        for (int k = 0; k < kGroup; ++k) pbuf[k] = pnext[k];
      }
    }
  }
}

template <int MODE, bool ORDER2, bool BF16>
cudaError_t launch(const float* a, const float* b, float* out, long long n_problems,
                   int n_cols, int Lx, int Ly, int d, int T, int lam1, int lam2,
                   long long smem, cudaStream_t stream) {
  auto kern = goursat_fwd<MODE, ORDER2, BF16>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kern<<<(unsigned)n_problems, T, (size_t)smem, stream>>>(a, b, out, n_cols, Lx, Ly,
                                                          d, lam1, lam2);
  return cudaGetLastError();
}

template <int MODE>
int dispatch(const float* a, const float* b, float* out, long long n_problems,
             int n_cols, int Lx, int Ly, int d, int T, int lam1, int lam2,
             int order2, int bf16, long long smem, void* stream) {
  if (n_problems < 1 || n_problems > 0x7fffffffLL || T < 2 || T > kMaxThreads ||
      (T & (T - 1)) || (T >> lam1) < 1 || Lx < 1 || Ly < 1 ||
      (MODE != kDelta && d < 1) ||
      smem < smem_bytes(MODE, order2 != 0, T, Ly << lam2, lam1, d))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err;
  if (order2)
    err = bf16 ? launch<MODE, true, true>(a, b, out, n_problems, n_cols, Lx, Ly, d, T,
                                          lam1, lam2, smem, s)
               : launch<MODE, true, false>(a, b, out, n_problems, n_cols, Lx, Ly, d, T,
                                           lam1, lam2, smem, s);
  else
    err = bf16 ? launch<MODE, false, true>(a, b, out, n_problems, n_cols, Lx, Ly, d, T,
                                           lam1, lam2, smem, s)
               : launch<MODE, false, false>(a, b, out, n_problems, n_cols, Lx, Ly, d,
                                            T, lam1, lam2, smem, s);
  return (int)err;
}

}  // namespace

extern "C" {

// Each entry point launches on `stream`, does not synchronise and returns
// cudaGetLastError() (0 on success).

int sigkernel_pde_fwd(const float* delta, float* out, long long B, int Lx, int Ly,
                      int T, int lam1, int lam2, int order2, int bf16, long long smem,
                      void* stream) {
  return dispatch<kDelta>(delta, nullptr, out, B, 1, Lx, Ly, 0, T, lam1, lam2, order2,
                          bf16, smem, stream);
}

int sigkernel_pde_fwd_fused(const float* dx, const float* dy, float* out, long long B,
                            int Lx, int Ly, int d, int T, int lam1, int lam2,
                            int order2, int bf16, long long smem, void* stream) {
  return dispatch<kFusedPairs>(dx, dy, out, B, 1, Lx, Ly, d, T, lam1, lam2, order2,
                               bf16, smem, stream);
}

int sigkernel_pde_gram_fused(const float* dX, const float* dY, float* out,
                             long long Bx, long long By, int Lx, int Ly, int d, int T,
                             int lam1, int lam2, int order2, int bf16, long long smem,
                             void* stream) {
  if (By < 1 || By > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  return dispatch<kFusedGram>(dX, dY, out, Bx * By, (int)By, Lx, Ly, d, T, lam1, lam2,
                              order2, bf16, smem, stream);
}

const char* sigkernel_pde_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
