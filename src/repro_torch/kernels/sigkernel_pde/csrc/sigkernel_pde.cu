// Goursat-PDE signature kernel for Hopper (sm_90a), forward and exact
// backward, five entry points.
//
// Replaces the Pallas TPU kernels of the JAX package:
//   sigkernel_pde_fwd        <- repro/kernels/sigkernel_pde/kernel.py:fwd_kernel
//                               (+ _wavefront), save_cps=False mode: Delta
//                               precomputed in device memory.
//   sigkernel_pde_fwd_cps    <- the same kernel's save_cps=True mode: it also
//                               writes each strip's carried row(s) as the
//                               strip begins (kernel.py:134-137).
//   sigkernel_pde_fwd_fused  <- kernel.py:fused_fwd_kernel: Delta built in the
//                               kernel from increments, matched pair lists.
//   sigkernel_pde_gram_fused <- kernel.py:fused_gram_kernel: Delta built in the
//                               kernel, one block per (row path, column path).
//   sigkernel_pde_bwd        <- grad_kernel.py:bwd_kernel: the exact adjoint
//                               (Alg 4); its design is described above
//                               goursat_bwd below.
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
// fused kernels accumulate the dot product <dx[row], dy[col]> in float64 (the
// float32 products are exact there) and round it once, which is what the
// plain version's float64 einsum gives.  So
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
// only the increments and are bound by operations; they build each strip's
// Delta as tile products on the FP64 tensor cores (described above
// goursat_fwd_fused below).  The wavefront itself is latency-bound: ny+T-1
// dependent steps per strip, each a barrier plus a short chain of dependent
// operations, so few large problems (one block per SM) want tall strips and
// many small problems want short strips; ops.py's choose_T picks T
// accordingly.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kBwdMaxThreads = 512;  // the backward's launch bound: 128 registers
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

constexpr float kOne = 1.0f, kHalf = 0.5f, kSixth = 1.0f / 6.0f,
                kTwelfth = 1.0f / 12.0f;

// One forward cell: lane r at wavefront step t computes cell (r, c = t - r)
// of its strip from the two previous anti-diagonals (diag rotates three
// buffers of T) and, in lanes 0 and 1, the carried rows; m1, m2 are the
// masks 2^lam1 - 1, 2^lam2 - 1 of the order-2 data-gridline test.
template <bool ORDER2, bool BF16>
__device__ __forceinline__ float fwd_cell(float p, int r, int c, int t, int T, int m1,
                                          int m2, const float* diag, const float* brow,
                                          const float* brow2) {
  const float* prev = diag + ((t + 2) % 3) * T;   // step t-1
  const float* prev2 = diag + ((t + 1) % 3) * T;  // step t-2
  const float left = c == 0 ? kOne : prev[r];
  const float up = r == 0 ? brow[t + 1] : prev[r - 1];
  const float upleft = c == 0 ? kOne : (r == 0 ? brow[t] : prev2[r - 1]);
  // A = 1 + p/2 + p²/12 and B1 = 1 − p²/12, in stencil.py's order
  const float p2 = mul(mul(kTwelfth, p), p);
  const float A = add(add(kOne, mul(kHalf, p)), p2);
  const float B1 = sub(kOne, p2);
  float cur;
  if (ORDER2) {
    const bool edge = (r & m1) == 0 || (c & m2) == 0;
    const float Bq = edge ? B1 : add(sub(kOne, mul(kSixth, p)), p2);
    const float Cq = edge ? 0.0f : mul(kTwelfth, p);
    const float k_dl = c <= 1 ? kOne : prev2[r];
    const float k_ul = r >= 2 ? prev2[r - 2] : (r == 1 ? brow[t] : brow2[t + 1]);
    cur = sub(sub(mul(add(left, up), A), mul(upleft, Bq)), mul(add(k_dl, k_ul), Cq));
  } else {
    cur = sub(mul(add(left, up), A), mul(upleft, B1));
  }
  return round_interior<BF16>(cur);
}

// The fused kernels' Delta band (see goursat_fwd_fused): kBand wavefront
// steps per band, built from 16 x 8 tiles of unrefined entries out of dx and
// dy rows staged in shared memory as Stage (float32: half the bytes of
// float64, and as fast, PERF.md §5; widened exactly at the operand load).
constexpr int kBand = 32;
using Stage = float;

struct BandGeometry {
  int RP;  // staged dx rows: R = T >> lam1 rounded up to whole 16-row blocks
  int S;   // row stride of the staged dx rows and the dy ring: d padded to a
           // multiple of 8 (the MMA's k), plus 4 (no bank conflicts)
  int NT;  // 8-column tiles per 16-row block and band
  int WB;  // unrefined columns a band row holds
  int BS;  // band row stride (odd)
  int NR;  // dy ring rows: the columns two consecutive bands read
  int NY;  // dy rows a band adds to the ring, at most
};

__host__ __device__ inline BandGeometry band_geometry(int T, int lam1, int lam2, int d) {
  const int m = 1 << lam1;
  BandGeometry g;
  g.RP = ((T >> lam1) + 15) / 16 * 16;
  g.S = (d + 7) / 8 * 8 + 4;
  g.NT = ((((kBand + 16 * m - 2) >> lam2) + 2) + 7) / 8;
  g.WB = ((kBand + m - 2) >> lam2) + 2;
  g.BS = g.WB | 1;
  g.NR = ((kBand + (g.RP - 16) * m) >> lam2) + 8 * g.NT + 1;
  g.NY = (kBand >> lam2) + 1;
  return g;
}

// Shared memory bytes the kernel lays out for one block (kernel.py mirrors
// it): fused kernels first hold, as Stage, the strip's dx rows (RP x S) and
// the dy ring (NR x S), then as float32 two bands (R x BS each) and a band's
// new dy rows (NY x d) on their way in; then every kernel holds the carried
// row(s) of ny+T+1 floats and three anti-diagonals of T floats.
__host__ __device__ inline int64_t smem_bytes(int mode, bool order2, int T, int ny,
                                              int lam1, int lam2, int d) {
  int64_t n = 4 * ((order2 ? 2 : 1) * ((int64_t)ny + T + 1) + 3 * (int64_t)T);
  if (mode != kDelta) {
    const BandGeometry g = band_geometry(T, lam1, lam2, d);
    n += (int64_t)sizeof(Stage) * (g.RP + g.NR) * g.S +
         4 * (2LL * (T >> lam1) * g.BS + (int64_t)g.NY * d);
  }
  return n;
}

// CPS: at the start of strip s the carried row(s) brow (, brow2), contiguous
// in shared memory, are copied to the checkpoint rows
// cps[prob, s * rows + (0, 1), :] (kernel.py:134-137).
template <bool ORDER2, bool BF16, bool CPS>
__global__ void __launch_bounds__(kMaxThreads)
goursat_fwd(const float* __restrict__ delta_all, float* __restrict__ out,
            float* __restrict__ cps, int Lx, int Ly, int lam1, int lam2) {
  extern __shared__ double smem[];
  const int T = blockDim.x;
  const int r = threadIdx.x;
  const int ny = Ly << lam2;
  const int W = ny + T + 1;
  const int R = T >> lam1;                     // unrefined rows per strip
  float* brow = reinterpret_cast<float*>(smem);
  float* brow2 = brow + W;                     // k[strip_top - 1, c] (order 2)
  float* diag = brow + (ORDER2 ? 2 : 1) * W;   // 3 rotating anti-diagonals

  const int64_t prob = blockIdx.x;
  const float* delta = delta_all + prob * (int64_t)Lx * Ly;
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

  for (int s = 0; s < n_strips; ++s) {
    const int row = s * R + lrow;
    const bool row_ok = row < Lx;          // rows past Lx: zero padding
    __syncthreads();  // ones / previous strip's last step
    if (CPS) {
      const int rows = ORDER2 ? 2 : 1;
      float* dst = cps + (prob * n_strips + s) * rows * (int64_t)W;
      for (int i = r; i < rows * W; i += T) dst[i] = brow[i];
      __syncthreads();  // at T = 2, lane 0 writes brow2[1] at step 0
    }

    // pbuf[k]: the unrefined Delta entry of this thread's cell at step t0 + k
    const float* drow = row_ok ? delta + (int64_t)row * Ly : nullptr;
    float pbuf[kGroup];
#pragma unroll
    for (int k = 0; k < kGroup; ++k) {
      const int c = k - r;
      pbuf[k] = (drow && c >= 0 && c < ny) ? __ldg(drow + (c >> lam2)) : 0.0f;
    }

    for (int t0 = 0; t0 < steps; t0 += kGroup) {
      float pnext[kGroup];
#pragma unroll
      for (int k = 0; k < kGroup; ++k) {
        const int c = t0 + kGroup + k - r;
        pnext[k] = (drow && c >= 0 && c < ny) ? __ldg(drow + (c >> lam2)) : 0.0f;
      }
#pragma unroll
      for (int k = 0; k < kGroup; ++k) {
        const int t = t0 + k;
        if (t >= steps) break;  // uniform across the block
        const int c = t - r;
        float cur = 0.0f;
        if (c >= 0 && c < ny) {
          cur = fwd_cell<ORDER2, BF16>(mul(pbuf[k], scale), r, c, t, T, m1, m2, diag,
                                       brow, brow2);
          if (s == n_strips - 1 && r == r_out && c == ny - 1) out[prob] = cur;
        }
        if (T == 2) __syncthreads();  // lane 1 writes brow[t], which lane 0 read
        diag[(t % 3) * T + r] = cur;
        if (r == T - 1 && t >= T - 1) brow[t - T + 2] = cur;
        if (ORDER2 && r == T - 2 && t >= T - 2) brow2[t - T + 3] = cur;
        __syncthreads();
      }
#pragma unroll
      for (int k = 0; k < kGroup; ++k) pbuf[k] = pnext[k];
    }
  }
}

// ---------------------------------------------------------------------------
// The fused-Delta forwards, replacing kernel.py:fused_fwd_kernel (matched
// pairs) and fused_gram_kernel (one block per (row path, column path)).
//
// The wavefront, its carried rows, its three rotating anti-diagonals and its
// one barrier per step are goursat_fwd's.  What differs is where a lane's
// Delta entry comes from.  The TPU kernel builds a strip's Delta block as one
// (R, d) x (d, Ly) product on its MXU (kernel.py:104-105, :337-338); here
// each band of kBand wavefront steps is built as 16 x 8 tile products on the
// FP64 tensor cores (mma.sync m16n8k8, float64 in and out: the float32
// increments widen exactly, the products are exact and the sum rounds once
// to float32), by warps of their own, one band ahead of the wavefront:
//   * Over steps t0 .. t0+kBand-1 the lanes of unrefined row i (refined rows
//     i*m .. i*m+m-1, m = 2^lam1) read unrefined columns jlo(i) .. jhi(i),
//     jlo(i) = (t0 - i*m - m + 1) >> lam2, jhi(i) = (t0 + kBand - 1 - i*m)
//     >> lam2: a parallelogram.  Rows are cut into blocks of 16; block i0
//     .. i0+15 needs columns jlo(i0+15) .. jhi(i0), NT tiles of 8 (at lam = 0
//     and kBand = 32, 6 tiles for 16 x 32 needed entries: 1.5x the work, at
//     full FP64 tensor rate, where the 8 x 8 x 4 shape runs at half rate).
//     Tiles with no column in 0 .. Ly-1 are skipped.
//   * Tile entry (i, j) lands in band[i][j - jlo(i)] (odd row stride BS, so
//     the lanes' reads at one step fall on distinct banks); a lane reads
//     band[i][(c >> lam2) - jlo(i)] for its refined cell (r, c): refinement
//     stays index arithmetic, the band holds unrefined entries.
//   * Roles.  The block has max(T, 32) wavefront threads (whole warps; lanes
//     at or past T only reach the barriers) and band_warps(T) producer warps
//     after them, which never join the per-step barrier (named barrier
//     kSteps, the wavefront threads only).  Two bands alternate; per band n
//     the producers wait until the wavefront has left its buffer (barrier
//     kEmpty + n % 2), build it and arrive on kFull + n % 2, where the
//     wavefront waits before the band's first step (a barrier per parity, so
//     an arrival never meets the previous use of its barrier still open);
//     kProducers orders the producers among themselves.
//   * A producer warp takes whole row blocks: the block's tiles are
//     independent MMA chains sharing one A fragment, issued back to back
//     with no branch between them (two at a time: the tile count is a
//     template parameter).
//   * dx rows are staged once per strip (RP x S, zero past R, past Lx and in
//     the k padding), dy rows pass through a ring (row j at slot j % NR)
//     holding two bands' columns: band n+1's new rows are copied in with
//     cp.async into a staging row block while band n is built, and moved
//     into the ring by the producer that copied them.  Columns
//     outside 0 .. Ly-1 enter the tiles as zeros and are never read by a
//     lane.
//   * Designs measured on the way (PERF.md §5): tiles issued between the
//     wavefront's per-step barriers (a whole tile, or a few k steps, a warp
//     and step) put their latency on the barrier chain; bands built by all
//     warps between bands add the tensor time to the wavefront's; producers
//     that branch before every MMA, or read their operands from device
//     memory, cannot build a band in the time its steps take; 8 x 8 x 4
//     tiles run at half the FP64 tensor rate, and 16-step bands hand over
//     twice as often.  With few problems (one block an SM) the producers
//     hide the band: B4 at (128, 1023, 32) runs at 1.2x the wavefront alone.
//     With many small problems the kernel is held by its blocks an SM and
//     the wavefront's own latency; at d = 8 it is level with the first
//     design's per-lane float64 FMAs.
// ---------------------------------------------------------------------------

// Producer warps of a fused block at strip height T: max(T, 32) + 32 *
// band_warps(T) threads stay within kFusedThreads for T <= kFusedMaxT.
__host__ __device__ inline int band_warps(int T) { return T >= 256 ? 16 : (T >= 128 ? 4 : 2); }
constexpr int kFusedMaxT = 512;
constexpr int kFusedThreads = 1024;
// named barriers of the fused kernels (0 is __syncthreads)
constexpr int kSteps = 1, kFull = 2, kEmpty = 4, kProducers = 6;

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;"
               ::"r"(static_cast<uint32_t>(__cvta_generic_to_shared(dst))), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}

// Named barriers: `n` threads (a multiple of 32) wait, or only arrive.
__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(n) : "memory");
}

// D = A B + D for one 16 x 8 x 8 tile in float64; with g = lane / 4 and
// q = lane % 4: a = A[g, q], A[g+8, q], A[g, q+4], A[g+8, q+4]; b = B[q, g],
// B[q+4, g]; c = D[g, 2q], D[g, 2q+1], D[g+8, 2q], D[g+8, 2q+1].
__device__ __forceinline__ void dmma_16x8x8(double (&c)[4], const double (&a)[4],
                                            const double (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3])
      : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(b[0]), "d"(b[1]));
}

// The highest dy row the band starting at step t0 reads.
__device__ __forceinline__ int band_last_col(int t0, int m, int lam2, int NT) {
  return ((t0 - 16 * m + 1) >> lam2) + 8 * NT - 1;
}

// Tiles u0 .. u0+NTC-1 of the row block whose rows start at i0, for the band
// starting at step t0, into band (the calling warp, whole).  j0 is the
// block's first column.
template <int NTC>
__device__ __forceinline__ void build_tiles(float* band, const Stage* sdx, const Stage* ring,
                                            const BandGeometry& gm, int i0, int j0, int u0,
                                            int t0, int R, int m, int lam2, int Ly,
                                            int kc_n) {
  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
  const int jb = j0 + 8 * u0 + g;            // this lane's B column of the first tile
  int slot = jb % gm.NR;
  slot += slot < 0 ? gm.NR : 0;
  const Stage* xa = sdx + (i0 + g) * gm.S + q;  // rows g and g+8 of A
  const Stage* yb[NTC];
  bool ok[NTC];
#pragma unroll
  for (int u = 0; u < NTC; ++u) {
    int sl = slot + 8 * u;
    sl -= sl >= gm.NR ? gm.NR : 0;
    ok[u] = jb + 8 * u >= 0 && jb + 8 * u < Ly;
    yb[u] = ring + sl * gm.S + q;
  }
  double c[NTC][4];
#pragma unroll
  for (int u = 0; u < NTC; ++u) c[u][0] = c[u][1] = c[u][2] = c[u][3] = 0.0;
  for (int kc = 0; kc < kc_n; ++kc) {
    const int k = 8 * kc;
    const double x[4] = {xa[k], xa[8 * gm.S + k], xa[k + 4], xa[8 * gm.S + k + 4]};
#pragma unroll
    for (int u = 0; u < NTC; ++u) {
      const double y[2] = {ok[u] ? (double)yb[u][k] : 0.0, ok[u] ? (double)yb[u][k + 4] : 0.0};
      dmma_16x8x8(c[u], x, y);
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {              // D rows g and g+8
    const int i = i0 + g + 8 * h;
    if (i < R) {
      const int q0 = j0 + 8 * u0 + 2 * q - ((t0 - i * m - m + 1) >> lam2);  // D column 2q
      float* row = band + i * gm.BS;
#pragma unroll
      for (int u = 0; u < NTC; ++u) {
        const int qq = q0 + 8 * u;
        // one rounding: the correctly rounded dot product
        if (qq >= 0 && qq < gm.WB) row[qq] = (float)c[u][2 * h];
        if (qq + 1 >= 0 && qq + 1 < gm.WB) row[qq + 1] = (float)c[u][2 * h + 1];
      }
    }
  }
}

// A producer warp's row blocks (pw, pw + n_pw, ...) of the band starting at
// step t0; tiles whose columns all fall outside 0 .. Ly-1 are skipped.
__device__ __forceinline__ void build_band(float* band, const Stage* sdx, const Stage* ring,
                                           const BandGeometry& gm, int pw, int n_pw, int t0,
                                           int R, int m, int lam2, int Ly, int kc_n) {
  for (int i0 = 16 * pw; i0 < R; i0 += 16 * n_pw) {
    const int j0 = (t0 - (i0 + 16) * m + 1) >> lam2;  // jlo(i0 + 15)
    const int u_lo = j0 + 7 < 0 ? min(gm.NT, (-j0) / 8) : 0;
    const int u_hi = j0 >= Ly ? 0 : min(gm.NT, (Ly - 1 - j0) / 8 + 1);
    for (int u0 = u_lo; u0 < u_hi; u0 += 2) {
      if (u_hi - u0 >= 2)  // uniform per warp
        build_tiles<2>(band, sdx, ring, gm, i0, j0, u0, t0, R, m, lam2, Ly, kc_n);
      else
        build_tiles<1>(band, sdx, ring, gm, i0, j0, u0, t0, R, m, lam2, Ly, kc_n);
    }
  }
}

template <int MODE, bool ORDER2, bool BF16>
__global__ void __launch_bounds__(kFusedThreads)
goursat_fwd_fused(const float* __restrict__ a, const float* __restrict__ b,
                  float* __restrict__ out, int n_cols, int Lx, int Ly, int d, int T,
                  int lam1, int lam2) {
  extern __shared__ double smem[];
  const int r = threadIdx.x;
  const int nc = T < 32 ? 32 : T;              // wavefront threads
  const int np = blockDim.x - nc;              // producer threads
  const int both = nc + np;
  const int ny = Ly << lam2;
  const int W = ny + T + 1;
  const int R = T >> lam1;                     // unrefined rows per strip
  const int m = 1 << lam1;
  const BandGeometry gm = band_geometry(T, lam1, lam2, d);
  Stage* sdx = reinterpret_cast<Stage*>(smem);  // the strip's dx rows
  Stage* ring = sdx + gm.RP * gm.S;            // dy row j at slot j % NR
  float* band = reinterpret_cast<float*>(ring + gm.NR * gm.S);  // 2 x R x BS
  float* ynew = band + 2 * R * gm.BS;          // a band's new dy rows
  float* brow = ynew + gm.NY * d;
  float* brow2 = brow + W;                     // k[strip_top - 1, c] (order 2)
  float* diag = brow + (ORDER2 ? 2 : 1) * W;   // 3 rotating anti-diagonals

  const int64_t prob = blockIdx.x;
  const int64_t ia = MODE == kFusedGram ? prob / n_cols : prob;
  const int64_t ib = MODE == kFusedGram ? prob % n_cols : prob;
  const float* dx = a + ia * (int64_t)Lx * d;
  const float* dy = b + ib * (int64_t)Ly * d;
  const int n_strips = (Lx + R - 1) / R;
  const int steps = ny + T - 1;
  const int all_bands = n_strips * ((steps + kBand - 1) / kBand);

  if (r >= nc) {  // ---- producers: the bands ----------------------------------
    const int pr = r - nc;
    const int kc_n = (d + 7) / 8;              // k steps of each tile product
    for (int i = pr; i < gm.NR * gm.S; i += np) ring[i] = Stage(0);  // k padding
    for (int s = 0, n = 0; s < n_strips; ++s) {
      bar_sync(kProducers, np);  // k padding / the strip before is built
      for (int i = pr; i < gm.RP * gm.S; i += np) {
        const int rr = i / gm.S, k = i - rr * gm.S;
        const int gr = s * R + rr;
        sdx[i] = rr < R && gr < Lx && k < d ? (Stage)__ldg(dx + (int64_t)gr * d + k) : Stage(0);
      }
      int loaded = min(band_last_col(0, m, lam2, gm.NT), Ly - 1);  // band 0's rows
      for (int i = pr; i < (loaded + 1) * d; i += np) {
        const int j = i / d;
        ring[(j % gm.NR) * gm.S + i - j * d] = (Stage)__ldg(dy + i);
      }
      bar_sync(kProducers, np);
      for (int t0 = 0; t0 < steps; t0 += kBand, ++n) {
        if (n >= 2) bar_sync(kEmpty + (n & 1), both);  // the wavefront left band n-2
        const int hi = t0 + kBand < steps
                           ? min(band_last_col(t0 + kBand, m, lam2, gm.NT), Ly - 1) : loaded;
        const int n_new = (hi - loaded) * d;   // band n+1's new rows, on their way in
        for (int i = pr; i < n_new; i += np)
          cp_async4(ynew + i, dy + (int64_t)(loaded + 1) * d + i);
        build_band(band + (n & 1) * R * gm.BS, sdx, ring, gm, pr >> 5, np >> 5, t0, R, m,
                   lam2, Ly, kc_n);
        cp_async_wait_all();
        for (int i = pr; i < n_new; i += np) {  // the rows this thread copied
          const int j = loaded + 1 + i / d;
          ring[(j % gm.NR) * gm.S + i % d] = (Stage)ynew[i];
        }
        loaded = hi;
        __threadfence_block();
        bar_sync(kProducers, np);  // band n written, band n+1's rows in the ring
        bar_arrive(kFull + (n & 1), both);
      }
    }
    return;
  }

  // ---- the wavefront ----------------------------------------------------------
  for (int i = r; i < (ORDER2 ? 2 : 1) * W; i += nc) brow[i] = 1.0f;
  bar_sync(kSteps, nc);
  const float scale = ldexpf(1.0f, -(lam1 + lam2));  // exact power of two
  const int m1 = m - 1;
  const int m2 = (1 << lam2) - 1;
  const int lrow = r >> lam1;              // this thread's unrefined row in the strip
  const int r_out = (Lx << lam1) - 1 - (n_strips - 1) * T;
  for (int s = 0, n = 0; s < n_strips; ++s) {
    const bool row_ok = r < T && s * R + lrow < Lx;  // rows past Lx: zero padding
    for (int t0 = 0; t0 < steps; t0 += kBand, ++n) {
      bar_sync(kFull + (n & 1), both);  // band n is built
      const float* brow_band = band + (n & 1) * R * gm.BS + lrow * gm.BS;
      const int jlo = (t0 - lrow * m - m + 1) >> lam2;  // band column 0 of this row
      for (int k = 0; k < kBand; ++k) {
        const int t = t0 + k;
        if (t >= steps) break;  // uniform across the block
        const int c = t - r;
        float cur = 0.0f;
        if (r < T && c >= 0 && c < ny) {
          const float p = row_ok ? brow_band[(c >> lam2) - jlo] : 0.0f;
          cur = fwd_cell<ORDER2, BF16>(mul(p, scale), r, c, t, T, m1, m2, diag, brow,
                                       brow2);
          if (s == n_strips - 1 && r == r_out && c == ny - 1) out[prob] = cur;
        }
        if (T == 2) bar_sync(kSteps, nc);  // lane 1 writes brow[t], which lane 0 read
        if (r < T) {
          diag[(t % 3) * T + r] = cur;
          if (r == T - 1 && t >= T - 1) brow[t - T + 2] = cur;
          if (ORDER2 && r == T - 2 && t >= T - 2) brow2[t - T + 3] = cur;
        }
        bar_sync(kSteps, nc);
      }
      if (n + 2 < all_bands) bar_arrive(kEmpty + (n & 1), both);  // its buffer is free
    }
  }
}

// ---------------------------------------------------------------------------
// The exact backward (Alg 4), replacing grad_kernel.py:bwd_kernel.
//
// One block per problem, T threads, the strips bottom-up in a loop inside
// the block.  For each strip:
//   1. Recompute.  The strip's checkpoint row(s) go to shared memory and the
//      forward wavefront (fwd_cell, with the forward's rounding) reruns.
//      Every cell's k̂ goes to a per-block workspace in device memory in the
//      skewed layout ws[t][r] (a row of TS = max(T, 4) floats per step, so
//      every row starts on 16 bytes: coalesced writes here, bulk copies in
//      step 2).  A strip's k̂ is (ny+T-1)·TS floats, MBs at the main path's
//      T = 512, far above the 227 KB of shared memory.
//   2. Reverse sweep.  Lane r computes g(r, c) = ∂F/∂k̂[top+r+1, c+1] at step
//      t = r + c, t from ny+T-2 down to 0.  Every reader of k̂[a, b] is a
//      writer cell w that adds g(w)·coefficient(p_w); instead of fetching
//      its neighbours' Delta (the TPU kernel rolls p_r1, p_r1c1, p_r2 across
//      lanes and reads the strip below), each cell publishes its products
//      gA = g·A(p), gB = g·B(p) and, for order 2, gC = g·C(p) in three
//      rotating anti-diagonals in shared memory, and
//        g(r,c) = gA(r,c+1) + gA(r+1,c) − gB(r+1,c+1) [− gC(r,c+2) − gC(r+2,c)]
//      in the TPU kernel's order of operations.  Lane 0's products (and lane
//      1's gC for order 2) are the rows carried up to the strip above (cA,
//      cB, cC, cC2), overwritten in place: lanes T-1 and T-2 read index i at
//      least T-2 steps before lane 0 writes it, so only T = 2 needs a second
//      barrier per step.  The seed ḡ lands where the forward reads k: cell
//      (nx-1, ny-1), in the lane of the last real row; the strip-padding rows
//      below it keep g = 0 and write nothing.
//   3. dΔ.  Each cell's term g·[(k_left + k_up)·A' − k_upleft·B' − (k_dl +
//      k_ul)·C'] reads k̂ of the two previous skewed rows.  The kGroup+1 ws
//      rows a group of kGroup steps reads are one contiguous span: one thread
//      brings it into shared memory with a bulk copy (cp.async.bulk, the
//      TMA's 1-D form) that completes on an mbarrier, double-buffered, so the
//      next group's rows arrive while this group runs and no thread stages
//      them; the lane's Delta entries of the next group are loaded into
//      registers likewise.  The dyadic fold uses no atomics: a lane sums its
//      2^lam2 consecutive columns in a register, and the 2^lam1 lanes of one
//      unrefined row, which finish the same unrefined column on consecutive
//      steps (highest lane first), pass the partial sum down through a shared
//      slot (one ring of 2^lam1 slots per row group); the lowest lane has the
//      finished entry, scaled.  The sums run in a fixed order, so the result
//      is deterministic; only that order differs from the plain version's
//      fold.
//   4. The dΔ store.  A lane finishes one entry of its own row per step, so
//      storing it at once makes every warp store touch 32 rows: 32 sectors
//      carrying 4 useful bytes each, which cost more than the whole sweep
//      (an ablation of the store, PERF.md §5).  Instead each finished entry
//      goes to a tile in shared memory, [lane][step] for kFlush steps at a
//      stride of kFlush+1 (no bank conflicts on either side), two tiles
//      alternating: while the lanes fill one, every thread writes one entry
//      of the other per step, a warp covering 32 consecutive entries of
//      kFlush-column runs of its rows, so each store is whole sectors of a
//      row; the last two tiles of a strip are written out after its sweep.
// Bound on an H100: reading Delta and writing dΔ (2·B·Lx·Ly·4 bytes) against
// ~40 operations per refined cell makes it byte-bound, but like the forward
// the sweep is latency-bound: 2·(ny+T-1) dependent steps per strip, each
// ending in a barrier.
// ---------------------------------------------------------------------------

constexpr int kFlush = 16;  // steps per dΔ tile

// ws row stride: a multiple of 4 floats, so bulk copies start on 16 bytes
__host__ __device__ inline int ws_stride(int T) { return T < 4 ? 4 : T; }

__host__ __device__ inline int64_t smem_bytes_bwd(bool order2, int T, int ny) {
  const int64_t TS = ws_stride(T);
  return 16 + 4 * (2 * (int64_t)(kGroup + 1) * TS + 2LL * T * (kFlush + 1) +
                   (int64_t)(order2 ? 2 : 1) * (ny + T + 1) + 3LL * T +
                   (order2 ? 4 : 2) * ((int64_t)ny + 2) + (order2 ? 9 : 6) * (int64_t)T + T);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_addr(bar)) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// Copy `bytes` (a multiple of 16, both ends 16-byte aligned) from global to
// shared memory; the copy completes the barrier's current phase.  Zero bytes
// only arrive.
__device__ __forceinline__ void bulk_load(float* dst, const float* src, uint32_t bytes,
                                          uint64_t* bar) {
  if (bytes == 0) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_addr(bar)) : "memory");
    return;
  }
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      ::"r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// Generic-proxy writes of this thread (the ws rows) before later bulk copies
// (the async proxy) read them.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async;" ::: "memory");
}

// The ws rows group `gi` of the reverse sweep reads (steps g0-kGroup-1 ..
// g0-1 as t-1 and t-2, g0 = steps-1-gi·kGroup) into its buffer; rows before
// step 0 are never read and are not copied.
__device__ __forceinline__ void bwd_group_copy(int gi, int steps, int TS, const float* wsb,
                                               float* buf, uint64_t* bar) {
  const int lo = steps - 1 - gi * kGroup - kGroup - 1;
  const int q0 = lo < 0 ? -lo : 0;
  const int n = q0 > kGroup + 1 ? 0 : kGroup + 1 - q0;
  bulk_load(buf + q0 * TS, wsb + (int64_t)(lo + q0) * TS, (uint32_t)(n * TS * 4), bar);
}

// Write entry e (0 <= e < T·kFlush) of the dΔ tile of reverse steps
// u = h·kFlush .. h·kFlush+kFlush-1 (u = steps-1-t) to dd, if a lane
// finished an entry there: lane rr = e / kFlush at step u = h·kFlush + e % kFlush.
__device__ __forceinline__ void bwd_flush(int h, int e, const float* tile, int FS, int T,
                                          int steps, int ny, int m1, int m2, int lam1,
                                          int lam2, int row0, int Lx, int Ly, float* ddprob) {
  const int rr = e / kFlush, kk = e % kFlush;
  const int t = steps - 1 - (h * kFlush + kk);
  const int c = t - rr;
  if (h < 0 || t < 0 || c < 0 || c >= ny || (rr & m1) || (c & m2)) return;
  const int row = row0 + (rr >> lam1);
  if (row < Lx) ddprob[(int64_t)row * Ly + (c >> lam2)] = tile[(h & 1) * T * FS + rr * FS + kk];
}

template <bool ORDER2, bool BF16>
__global__ void __launch_bounds__(kBwdMaxThreads)
goursat_bwd(const float* __restrict__ delta, const float* __restrict__ cps,
            const float* __restrict__ gbar, float* ws, float* __restrict__ dd, int Lx,
            int Ly, int lam1, int lam2) {
  extern __shared__ double smem[];
  const int T = blockDim.x;
  const int r = threadIdx.x;
  const int ny = Ly << lam2;
  const int W = ny + T + 1;
  const int R = T >> lam1;
  const int rows = ORDER2 ? 2 : 1;
  const int NC = ny + 2;
  const int n_prod = ORDER2 ? 3 : 2;
  const int TS = ws_stride(T);
  const int KS = (kGroup + 1) * TS;              // one staged group of ws rows
  const int FS = kFlush + 1;                     // dΔ tile row stride
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);      // 2 mbarriers, one per sK
  float* sK = reinterpret_cast<float*>(smem + 2);         // 2 x kGroup+1 ws rows
  float* tile = sK + 2 * KS;                     // 2 dΔ tiles of T x kFlush
  float* brow = tile + 2 * T * FS;               // checkpoint rows of the strip
  float* brow2 = brow + W;
  float* diag = brow + rows * W;                 // step 1's 3 anti-diagonals
  float* cA = diag + 3 * T;                      // products carried up from row 0
  float* cB = cA + NC;                           // of the strip below (and, for
  float* cC = cB + NC;                           // order 2, gC of its rows 0, 1)
  float* cC2 = cC + NC;
  float* pA = cA + (ORDER2 ? 4 : 2) * NC;        // 3 rotating anti-diagonals each
  float* pB = pA + 3 * T;
  float* pC = pB + 3 * T;
  float* fold = pA + 3 * n_prod * T;             // T slots: a ring per row group

  const int64_t prob = blockIdx.x;
  const float* dprob = delta + prob * (int64_t)Lx * Ly;
  float* ddprob = dd + prob * (int64_t)Lx * Ly;
  const int n_strips = (Lx + R - 1) / R;
  const int steps = ny + T - 1;
  const int n_groups = (steps + kGroup - 1) / kGroup;
  float* wsb = ws + prob * (int64_t)steps * TS;
  const float* cpsb = cps + prob * (int64_t)n_strips * rows * W;
  const float scale = ldexpf(1.0f, -(lam1 + lam2));
  const int m1 = (1 << lam1) - 1;
  const int m2 = (1 << lam2) - 1;
  const int lrow = r >> lam1;
  const int j = r & m1;                          // lane within its row group
  float* slots = fold + (r - j);
  const int r_out = (Lx << lam1) - 1 - (n_strips - 1) * T;
  const float seed = gbar[prob];
  uint32_t phase = 0;                            // bit b: parity bar[b] completes next

  if (r == 0) {
    mbar_init(&bar[0]);
    mbar_init(&bar[1]);
  }
  for (int i = r; i < (ORDER2 ? 4 : 2) * NC; i += T) cA[i] = 0.0f;  // nothing below

  for (int s = n_strips - 1; s >= 0; --s) {
    const int row = s * R + lrow;
    const float* drow = row < Lx ? dprob + (int64_t)row * Ly : nullptr;
    const float* src = cpsb + (int64_t)s * rows * W;
    for (int i = r; i < rows * W; i += T) brow[i] = __ldg(src + i);
    for (int i = r; i < 3 * n_prod * T; i += T) pA[i] = 0.0f;
    __syncthreads();

    // ---- 1. recompute the strip into ws -----------------------------------
    float pbuf[kGroup];
#pragma unroll
    for (int k = 0; k < kGroup; ++k) {
      const int c = k - r;
      pbuf[k] = (drow && c >= 0 && c < ny) ? __ldg(drow + (c >> lam2)) : 0.0f;
    }
    for (int t0 = 0; t0 < steps; t0 += kGroup) {
      float pnext[kGroup];
#pragma unroll
      for (int k = 0; k < kGroup; ++k) {
        const int c = t0 + kGroup + k - r;
        pnext[k] = (drow && c >= 0 && c < ny) ? __ldg(drow + (c >> lam2)) : 0.0f;
      }
#pragma unroll
      for (int k = 0; k < kGroup; ++k) {
        const int t = t0 + k;
        if (t >= steps) break;  // uniform across the block
        const int c = t - r;
        float cur = 0.0f;
        if (c >= 0 && c < ny)
          cur = fwd_cell<ORDER2, BF16>(mul(pbuf[k], scale), r, c, t, T, m1, m2, diag, brow,
                                       brow2);
        diag[(t % 3) * T + r] = cur;
        wsb[(int64_t)t * TS + r] = cur;
        __syncthreads();
      }
#pragma unroll
      for (int k = 0; k < kGroup; ++k) pbuf[k] = pnext[k];
    }
    fence_proxy_async();
    __syncthreads();

    // ---- 2. reverse adjoint sweep, 3. dΔ and the fold, 4. the dΔ store ------
    if (r == 0) {
      bwd_group_copy(0, steps, TS, wsb, sK, &bar[0]);
      if (n_groups > 1) bwd_group_copy(1, steps, TS, wsb, sK + KS, &bar[1]);
    }
    float preg[kGroup];
#pragma unroll
    for (int k = 0; k < kGroup; ++k) {
      const int c = steps - 1 - k - r;
      preg[k] = (drow && c >= 0 && c < ny) ? __ldg(drow + (c >> lam2)) : 0.0f;
    }
    float acc = 0.0f;
    // the step at which this lane's cell (nx-1, ny-1) adds the seed ḡ
    const int t_seed = s == n_strips - 1 && r == r_out ? ny - 1 + r : -1;
    for (int gi = 0; gi < n_groups; ++gi) {
      const int g0 = steps - 1 - gi * kGroup;
      const int b = gi & 1;
      const int m0 = g0 % 3;  // anti-diagonal slot of step g0
      // group gi-1, which read the other buffer, ended with a barrier
      if (r == 0 && gi >= 1 && gi + 1 < n_groups)
        bwd_group_copy(gi + 1, steps, TS, wsb, sK + (b ^ 1) * KS, &bar[b ^ 1]);
      float pcur[kGroup];
#pragma unroll
      for (int k = 0; k < kGroup; ++k) {
        pcur[k] = preg[k];
        const int c = g0 - kGroup - k - r;
        preg[k] = (drow && c >= 0 && c < ny) ? __ldg(drow + (c >> lam2)) : 0.0f;
      }
      mbar_wait(&bar[b], (phase >> b) & 1u);
      phase ^= 1u << b;
      const float* Kg = sK + b * KS;
#pragma unroll
      for (int k = 0; k < kGroup; ++k) {
        const int t = g0 - k;
        if (t < 0) break;  // uniform across the block
        const int u = gi * kGroup + k;           // reverse step: steps-1-t
        // slots of steps t, t+1, t+2 in the rotating anti-diagonals
        int s_t = m0 + (3 - k % 3) % 3, s_1 = s_t + 1, s_2 = s_t + 2;
        s_t -= s_t >= 3 ? 3 : 0;
        s_1 -= s_1 >= 3 ? 3 : 0;
        s_2 -= s_2 >= 6 ? 6 : (s_2 >= 3 ? 3 : 0);
        const int h = u / kFlush;
        // one entry of the previous tile to dd (its lanes are done with it)
        bwd_flush(h - 1, (u % kFlush) * T + r, tile, FS, T, steps, ny, m1, m2, lam1, lam2,
                  s * R, Lx, Ly, ddprob);
        const int c = t - r;
        const bool active = c >= 0 && c < ny;
        float gA = 0.0f, gB = 0.0f, gC = 0.0f;
        if (active) {
          const float* A1 = pA + s_1 * T;  // products at step t+1
          const float* B2 = pB + s_2 * T;  // and t+2
          float g = add(A1[r], r + 1 < T ? A1[r + 1] : cA[c]);
          g = sub(g, r + 1 < T ? B2[r + 1] : cB[c + 1]);
          if (ORDER2) {
            const float* C2 = pC + s_2 * T;
            g = sub(g, C2[r]);
            g = sub(g, r + 2 < T ? C2[r + 2] : (r + 2 == T ? cC[c] : cC2[c]));
          }
          if (t == t_seed) g = add(g, seed);
          const float p = mul(pcur[k], scale);
          const float p2 = mul(mul(kTwelfth, p), p);
          const float A = add(add(kOne, mul(kHalf, p)), p2);
          const float B1 = sub(kOne, p2);
          const float dA = add(kHalf, mul(p, kSixth));
          const float* K1 = Kg + (kGroup - k) * TS;  // ws row t-1
          const float* K2 = K1 - TS;                 // ws row t-2
          const float k_left = c == 0 ? kOne : K1[r];
          const float k_up = r == 0 ? brow[c + 1] : K1[r - 1];
          const float k_upleft = c == 0 ? kOne : (r == 0 ? brow[c] : K2[r - 1]);
          float term;
          if (ORDER2) {
            const bool edge = (r & m1) == 0 || (c & m2) == 0;
            const float Bq = edge ? B1 : add(sub(kOne, mul(kSixth, p)), p2);
            const float Cq = edge ? 0.0f : mul(kTwelfth, p);
            const float dB = edge ? mul(p, -kSixth) : sub(mul(p, kSixth), kSixth);
            const float dC = edge ? 0.0f : kTwelfth;
            const float k_dl = c <= 1 ? kOne : K2[r];
            const float k_ul = r >= 2 ? K2[r - 2] : (r == 1 ? brow[c + 1] : brow2[c + 1]);
            gA = mul(g, A);
            gB = mul(g, Bq);
            gC = mul(g, Cq);
            term = sub(sub(mul(add(k_left, k_up), dA), mul(k_upleft, dB)),
                       mul(add(k_dl, k_ul), dC));
          } else {
            gA = mul(g, A);
            gB = mul(g, B1);
            term = sub(mul(add(k_left, k_up), dA), mul(k_upleft, mul(p, -kSixth)));
          }
          const float contrib = mul(g, term);
          acc = (c & m2) == m2 ? contrib : add(acc, contrib);
          if ((c & m2) == 0) {  // this lane's part of column c >> lam2 is done
            const int col = c >> lam2;
            float* slot = slots + (col & m1);
            const float v = j == m1 ? acc : add(*slot, acc);
            if (j != 0)
              *slot = v;
            else
              tile[(h & 1) * T * FS + r * FS + u % kFlush] = mul(v, scale);
          }
        }
        if (T == 2) __syncthreads();  // lane 0 writes cB[t] / cC[t], which lane 1 read
        pA[s_t * T + r] = gA;
        pB[s_t * T + r] = gB;
        if (ORDER2) pC[s_t * T + r] = gC;
        if (r == 0 && active) {
          cA[c] = gA;
          cB[c] = gB;
          if (ORDER2) cC[c] = gC;
        }
        if (ORDER2 && r == 1 && active) cC2[c] = gC;
        __syncthreads();
      }
    }
    // the strip's last two tiles (the earlier one again: it may be partly
    // written out only)
    const int h_last = (steps - 1) / kFlush;
    for (int h = h_last - 1; h <= h_last; ++h)
      for (int q = 0; q < kFlush; ++q)
        bwd_flush(h, q * T + r, tile, FS, T, steps, ny, m1, m2, lam1, lam2, s * R, Lx, Ly,
                  ddprob);
  }
}

template <int MODE, bool ORDER2, bool BF16, bool CPS>
cudaError_t launch(const float* a, const float* b, float* out, float* cps,
                   long long n_problems, int n_cols, int Lx, int Ly, int d, int T,
                   int lam1, int lam2, long long smem, cudaStream_t stream) {
  if constexpr (MODE == kDelta) {
    auto kern = goursat_fwd<ORDER2, BF16, CPS>;
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    kern<<<(unsigned)n_problems, T, (size_t)smem, stream>>>(a, out, cps, Lx, Ly, lam1,
                                                            lam2);
  } else {
    auto kern = goursat_fwd_fused<MODE, ORDER2, BF16>;
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    // whole warps: strips of fewer than 32 rows get a wavefront warp of 32
    const int threads = (T < 32 ? 32 : T) + 32 * band_warps(T);
    kern<<<(unsigned)n_problems, threads, (size_t)smem, stream>>>(a, b, out, n_cols, Lx, Ly,
                                                                 d, T, lam1, lam2);
  }
  return cudaGetLastError();
}

template <int MODE, bool CPS = false>
int dispatch(const float* a, const float* b, float* out, float* cps, long long n_problems,
             int n_cols, int Lx, int Ly, int d, int T, int lam1, int lam2,
             int order2, int bf16, long long smem, void* stream) {
  if (n_problems < 1 || n_problems > 0x7fffffffLL || T < 2 ||
      T > (MODE == kDelta ? kMaxThreads : kFusedMaxT) || (T & (T - 1)) ||
      (T >> lam1) < 1 || Lx < 1 || Ly < 1 || (MODE != kDelta && d < 1) ||
      smem < smem_bytes(MODE, order2 != 0, T, Ly << lam2, lam1, lam2, d))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err;
  if (order2)
    err = bf16 ? launch<MODE, true, true, CPS>(a, b, out, cps, n_problems, n_cols, Lx, Ly,
                                               d, T, lam1, lam2, smem, s)
               : launch<MODE, true, false, CPS>(a, b, out, cps, n_problems, n_cols, Lx,
                                                Ly, d, T, lam1, lam2, smem, s);
  else
    err = bf16 ? launch<MODE, false, true, CPS>(a, b, out, cps, n_problems, n_cols, Lx,
                                                Ly, d, T, lam1, lam2, smem, s)
               : launch<MODE, false, false, CPS>(a, b, out, cps, n_problems, n_cols, Lx,
                                                 Ly, d, T, lam1, lam2, smem, s);
  return (int)err;
}

template <bool ORDER2, bool BF16>
cudaError_t launch_bwd(const float* delta, const float* cps, const float* gbar,
                       float* ws, float* dd, long long B, int Lx, int Ly, int T,
                       int lam1, int lam2, long long smem, cudaStream_t stream) {
  auto kern = goursat_bwd<ORDER2, BF16>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kern<<<(unsigned)B, T, (size_t)smem, stream>>>(delta, cps, gbar, ws, dd, Lx, Ly, lam1,
                                                 lam2);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Each entry point launches on `stream`, does not synchronise and returns
// cudaGetLastError() (0 on success).

int sigkernel_pde_fwd(const float* delta, float* out, long long B, int Lx, int Ly,
                      int T, int lam1, int lam2, int order2, int bf16, long long smem,
                      void* stream) {
  return dispatch<kDelta>(delta, nullptr, out, nullptr, B, 1, Lx, Ly, 0, T, lam1, lam2,
                          order2, bf16, smem, stream);
}

// cps: (B, n_strips * rows, ny + T + 1), rows = 1 (order 1) or 2 (order 2).
int sigkernel_pde_fwd_cps(const float* delta, float* out, float* cps, long long B, int Lx,
                          int Ly, int T, int lam1, int lam2, int order2, int bf16,
                          long long smem, void* stream) {
  return dispatch<kDelta, true>(delta, nullptr, out, cps, B, 1, Lx, Ly, 0, T, lam1, lam2,
                                order2, bf16, smem, stream);
}

int sigkernel_pde_fwd_fused(const float* dx, const float* dy, float* out, long long B,
                            int Lx, int Ly, int d, int T, int lam1, int lam2,
                            int order2, int bf16, long long smem, void* stream) {
  return dispatch<kFusedPairs>(dx, dy, out, nullptr, B, 1, Lx, Ly, d, T, lam1, lam2,
                               order2, bf16, smem, stream);
}

int sigkernel_pde_gram_fused(const float* dX, const float* dY, float* out,
                             long long Bx, long long By, int Lx, int Ly, int d, int T,
                             int lam1, int lam2, int order2, int bf16, long long smem,
                             void* stream) {
  if (By < 1 || By > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  return dispatch<kFusedGram>(dX, dY, out, nullptr, Bx * By, (int)By, Lx, Ly, d, T, lam1,
                              lam2, order2, bf16, smem, stream);
}

// cps as sigkernel_pde_fwd_cps wrote it at the same T; ws: B * (ny+T-1) *
// max(T, 4) floats of scratch, 16-byte aligned; dd: (B, Lx, Ly), every entry
// written.
int sigkernel_pde_bwd(const float* delta, const float* cps, const float* gbar, float* ws,
                      float* dd, long long B, int Lx, int Ly, int T, int lam1, int lam2,
                      int order2, int bf16, long long smem, void* stream) {
  if (B < 1 || B > 0x7fffffffLL || T < 2 || T > kBwdMaxThreads || (T & (T - 1)) ||
      (T >> lam1) < 1 || Lx < 1 || Ly < 1 ||
      smem < smem_bytes_bwd(order2 != 0, T, Ly << lam2))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err;
  if (order2)
    err = bf16 ? launch_bwd<true, true>(delta, cps, gbar, ws, dd, B, Lx, Ly, T, lam1,
                                        lam2, smem, s)
               : launch_bwd<true, false>(delta, cps, gbar, ws, dd, B, Lx, Ly, T, lam1,
                                         lam2, smem, s);
  else
    err = bf16 ? launch_bwd<false, true>(delta, cps, gbar, ws, dd, B, Lx, Ly, T, lam1,
                                         lam2, smem, s)
               : launch_bwd<false, false>(delta, cps, gbar, ws, dd, B, Lx, Ly, T, lam1,
                                          lam2, smem, s);
  return (int)err;
}

// Shared memory bytes a forward launch needs (mode 0: precomputed Delta, 1:
// fused pairs, 2: fused Gram), as dispatch checks them.
long long sigkernel_pde_smem_bytes(int mode, int order2, int T, int Ly, int lam1, int lam2,
                                   int d) {
  return smem_bytes(mode, order2 != 0, T, Ly << lam2, lam1, lam2, d);
}

const char* sigkernel_pde_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
