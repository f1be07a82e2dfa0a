// Truncated signatures by Horner's scheme (pySigLib Alg 2) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of the JAX package:
//   signature_horner  <- repro/kernels/signature/kernel.py:horner_kernel
//                        (built by build_horner, driven by ops._horner_flat)
//
// What it computes.  For each path, over its increments z_1..z_n in order,
// levels N..1 of the flat signature are updated (A_0 = 1 implicit):
//   for k = N..2:  B = z/k;  B = (B + A_i) (x) z/(k-i) for i = 1..k-2;
//                  A_k = (B + A_{k-1}) (x) z + A_k
//   A_1 = A_1 + z
// where every level read is the value from before the step.
//
// Design: the signature split by its first indices.  Horner's recursion
// never mixes entries whose first indices differ: entry (i1, ..., ik) of
// A_k is built from z and from the entries of A_1..A_{k-1} whose indices
// are prefixes of it (and z[i1]/k starts the chain).  So for a prefix
// P = (i1..ip) the entries of every level that begin with P (the "slice";
// at levels k <= p the one entry P[:k]) evolve on their own, by the same
// operations in the same order as in the whole.  One thread block runs one
// (path, prefix): the launch is B x d^p blocks, with no communication
// between them.  The TPU kernel instead keeps the whole (sig_dim, 128
// paths) tile in VMEM, which no SM can hold at d = 16, N = 4 (69,904 floats
// a path).
//   * The top level's slice, a (d^(N-1-p), d) matrix of up to kTop x 512
//     entries, stays in registers for the whole path: thread (tile, j) owns
//     column j of kTop consecutive rows, and is written to `out` once, at
//     the end.  (Past 512 channels the columns are cut into chunks of jw,
//     one block each, which all run the same lower levels.)  It depends on
//     the rest only through U_t = B_N + A_{N-1} (level N-1's slice): a step
//     stages U_t in shared memory (two slots) and each thread applies
//     A_N[a, j] = U_t[a] * z_t[j] + A_N[a, j] one step behind, kTop/4
//     vector loads of U per kTop multiply-adds.
//   * Levels 1..N-1 (slices of d^(k-p) floats, tiny) sit in shared memory,
//     double-buffered: a step reads one buffer and writes the other, so the
//     levels need no reverse order and a step needs one barrier (against
//     2 + sum max(k-2, 1), 12 at N = 6, when one block ran the whole path).
//     The step's work is a list of items, each a chunk of up to kChunk
//     entries of a row (the entries of one level that differ in their last
//     index only), one item and one top-level tile a thread:
//       A_k[Q, j, l] = (Y_k[Q] * z/2[j] + A_{k-1}[Q, j]) * z[l] + A_k[Q, j, l]
//       U_t[Q, j]    = Y_N[Q] * z/2[j] + A_{N-1}[Q, j],   A_1 = A_1 + z,
//     where Y_k = B_{k-2} + A_{k-2} is the Horner chain from z/k, run by the
//     thread for its item (k-3 stages).  An item's offsets are computed once
//     for the whole path (its chain's in a table in shared memory), rows are
//     padded (row_stride) so that a warp's accesses fall on distinct banks,
//     and an item loads all its entries before it stores any.  What each of
//     these bought, and the designs that lost, is in PERF.md (the Horner
//     ablation, tools/kernel_bench.py ablate-horner).
//   * z/m for m = 2..N is formed once per step and block, by true division
//     (__fdiv_rn), never as a multiplication by a reciprocal.
// p is chosen (ops.geometry) so that a block fits kMaxThreads threads and
// the launch has enough blocks for the SMs (at the paper's sizes 512 /
// 1024 / 2048 blocks of 160 / 288 / 256 threads).  Every operation rounds
// on its own (__fmul_rn/__fadd_rn, never contracted into an FMA), so the
// kernel computes each entry bit for bit as the plain PyTorch scan does
// (kernel.horner_plain), whatever p, the chunks, S and the thread count.
// Zero increments are exact no-ops (A + 0 * x = A).
//
// What bounds it on an H100.  Operations: per path and step Horner does
// ~d^N * 2 of its ~2.3 d^N flops in the top level (149,152 flops at d = 16,
// N = 4), against 67 TFLOP/s FP32; the bytes (the increments in, the
// signature out) are negligible.  Because every multiply and add rounds on
// its own, the kernel issues two instructions where an FMA would be one,
// so half the FP32 rate, twice the operation bound, is the floor it can
// reach.  The top level's update is at that floor's order; the steps'
// latency (a dependent chain of shared loads and rounded operations per
// item, a barrier, kMaxThreads x kMinBlocks threads an SM) is what keeps
// the kernel above it.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 512;
constexpr int kMinBlocks = 2;    // blocks an SM holds at 512 threads: <= 64 registers
constexpr int kMaxDepth = 16;
constexpr int kTop = 16;         // top-level entries per thread (registers)
constexpr int kTile = kTop + 4;  // a staged U row per tile: no bank conflicts
constexpr int kChunk = 4;        // a row's entries per item (the launch's cw), at most

// Each operation rounds on its own, as the plain version's elementwise ops.
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }

long long ipow(long long d, int k) {
  long long r = 1;
  for (int i = 0; i < k; ++i) r *= d;
  return r;
}

// Per-step work items of the lower levels: the rows of each task (A_1,
// A_2..A_{N-1}, then U_t), a row being the entries that differ in their
// last index only, cut into ceil(w / cw) interleaved chunks.
__host__ __device__ inline int row_items(int d, int depth, int p, int cw) {
  if (depth == 1) return 1;
  int n = 0;
  for (int k = 1; k <= depth; ++k) {
    const int m = k == 1 ? 0 : (k < depth ? k - 1 : depth - 2);  // the row's level
    const int lvl = k < depth ? k : depth - 1;                    // its entries' level
    int rows = 1;
    for (int i = p; i < m; ++i) rows *= d;
    n += rows * (lvl > p ? (d + cw - 1) / cw : 1);
  }
  return n;
}

// Shared-memory stride of a row of w entries read by its ceil(w / cw) chunk
// threads, entry c + nch*i by thread c: nch times the least odd u with
// nch*u >= w, so that the rows a warp touches start on distinct banks.
__host__ __device__ inline int row_stride(int w, int cw) {
  const int nch = (w + cw - 1) / cw;
  int u = (w + nch - 1) / nch;
  u += 1 - (u & 1);
  return nch * u;
}

// Floats of level k's slice in a lower buffer: its rows at row_stride(d)
// when its last index is free (k > p), else the one entry.
__host__ __device__ inline long long level_floats(int d, int k, int p, int cw) {
  if (k <= p) return 1;
  long long rows = 1;
  for (int i = p; i < k - 1; ++i) rows *= d;
  return rows * row_stride(d, cw);
}

// Dynamic shared memory in floats (mirrored by kernel.smem_bytes):
//   U      2 * tiles * kTile     U_t of two steps, tiles = ceil(nU / kTop)
//   chain  2 * (N-3) * threads   the Horner chain offsets of the threads' row
//                                items (int2)
//   lower  2 * sum_{k<N} level_floats  the slices of levels 1..N-1, two buffers
//   zs     S * d                 the increments of the length block
//   zq     S * (N-1) * d         z/m for m = 2..N of each staged step
long long smem_floats(int d, int depth, int p, int cw, int S, int threads) {
  const long long nU = depth >= 2 ? ipow(d, depth - 1 - p) : 1;
  const long long tiles = (nU + kTop - 1) / kTop;
  long long lower = 0;
  for (int k = 1; k < depth; ++k) lower += level_floats(d, k, p, cw);
  return 2 * tiles * kTile + 2 * lower + (long long)S * d + (long long)S * (depth - 1) * d +
         2LL * (depth > 3 ? depth - 3 : 0) * threads;
}

// The slice's index arithmetic.  An entry of a level-m slice has local
// index q < d^max(0, m-p); its digits 0..p-1 are the prefix P, the others
// are q's base-d digits.
struct Slice {
  int d, p, rs;      // rs: the stride of a row of d entries in shared memory
  const int* P;      // the prefix digits
  const int* pw;     // pw[k] = d^k
  __device__ __forceinline__ int digit(int q, int m, int pos) const {
    return pos < p ? P[pos] : q / pw[m - 1 - pos] % d;
  }
  // local index in the level-len slice of the entry's first len digits
  __device__ __forceinline__ int prefix(int q, int m, int len) const {
    return len <= p ? 0 : q / pw[m - len];
  }
  __device__ __forceinline__ int size(int m) const { return m > p ? pw[m - p] : 1; }
  // where entry q of the level-m slice sits in its part of a lower buffer
  __device__ __forceinline__ int store(int m, int q) const {
    return m > p ? q / d * rs + q % d : 0;
  }
};

__global__ void __launch_bounds__(kMaxThreads, kMinBlocks)
horner(const float* __restrict__ z, float* __restrict__ out, int n_steps, int d, int depth,
       int p, int jw, int cw, int S) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  __shared__ int pw[kMaxDepth + 1];          // d^k
  __shared__ int P[kMaxDepth];               // the block's prefix
  __shared__ int loff[kMaxDepth + 1];        // level k's slice in a lower buffer
  __shared__ long long goff[kMaxDepth + 1];  // level k in the flat output row
  const int tid = threadIdx.x;
  const int N = depth;
  int C = 1;
  for (int i = 0; i < p; ++i) C *= d;
  const int J = (d + jw - 1) / jw;  // column chunks of the top slice
  const int jc = blockIdx.x % J;
  const long long path = (blockIdx.x / J) / C;
  const int c = (int)((blockIdx.x / J) % C);
  if (tid == 0) {
    long long w = 1;
    for (int k = 0; k <= N; ++k, w *= d) pw[k] = (int)w;  // d^N fits int: sig_dim does
    for (int i = p - 1, q = c; i >= 0; --i, q /= d) P[i] = q % d;
    int lo = 0;
    long long go = 0, s = 1;
    for (int k = 1; k <= N; ++k) {
      s *= d;
      goff[k] = go;
      go += s;
      loff[k] = lo;
      if (k < N) lo += (int)level_floats(d, k, p, cw);
    }
  }
  __syncthreads();
  const Slice sl{d, p, row_stride(d, cw), P, pw};
  const int nU = N >= 2 ? pw[N - 1 - p] : 1;
  const int tiles = (nU + kTop - 1) / kTop;
  const int LW = N >= 2 ? loff[N - 1] + (int)level_floats(d, N - 1, p, cw) : 0;
  const int nI = row_items(d, N, p, cw), nt = blockDim.x;
  float* U = smem;  // 16-byte aligned: the dynamic shared memory's base
  int2* chain_tab = reinterpret_cast<int2*>(U + 2 * tiles * kTile);  // [stage][thread]
  float* lower = reinterpret_cast<float*>(chain_tab + (N > 3 ? N - 3 : 0) * nt);
  float* zs = lower + 2 * LW;
  float* zq = zs + S * d;  // zq[(t * (N-1) + m-2) * d + j] = z_t[j] / m
  const float* zp = z + path * n_steps * d;

  // ---- the thread's row item, fixed for the whole path ----------------------
  // kind 1: A_1 += z; 2: A_k (k >= 2); 3: U_t (N >= 2); 4: U_t = 1 (N = 1);
  // the item's entries are i0, i0 + di, ... below w of its row
  int kind = 0, k = 0, nst = 0, qz0 = 0, yA = 0, bj = 0, bA = 0, oA = 0, l0 = 0, i0 = 0,
      di = 1, w = 0, qU = 0;
  if (tid < nI) {
    int g = tid, n = 0;
    for (k = 1; k <= N; ++k) {  // find the task: the same count as row_items
      const int m = k == 1 ? 0 : (k < N ? k - 1 : N - 2);
      const int lvl = k < N ? k : N - 1;
      const int nch = N == 1 || lvl <= p ? 1 : (d + cw - 1) / cw;
      n = (N == 1 ? 1 : sl.size(m)) * nch;
      if (g < n) {
        const int r = g / nch;
        const bool open = N > 1 && lvl > p;   // the row's last index runs over 0..d-1
        w = open ? d : 1;
        i0 = g % nch;
        di = nch;
        l0 = open || lvl < 1 ? 0 : P[lvl - 1];
        kind = N == 1 ? 4 : (k == 1 ? 1 : (k < N ? 2 : 3));
        oA = loff[lvl] + (open ? r * sl.rs : 0);
        qU = r * w;
        const int kc = k < N ? k : N;         // the Horner chain's level
        if (kind == 2 || kind == 3) {
          if (kc >= 3) {                      // Y_kc at Q, a level-(kc-2) entry
            const int Q = kind == 2 ? sl.prefix(r, k - 1, k - 2) : r;
            const int mm = kc - 2;
            qz0 = (kc - 2) * d + sl.digit(Q, mm, 0);
            nst = mm - 1;
            for (int st = 1; st < mm; ++st)  // its stages' (cur, z/m) offsets
              chain_tab[(st - 1) * nt + tid] =
                  make_int2(loff[st] + sl.store(st, sl.prefix(Q, mm, st)),
                            (kc - st - 2) * d + sl.digit(Q, mm, st));
            yA = loff[mm] + sl.store(mm, Q);
          }
          if (kind == 2) {
            bj = k == 2 ? sl.digit(r, 1, 0) : sl.digit(r, k - 1, k - 2);  // z/2 index
            bA = loff[k - 1] + sl.store(k - 1, r);
          }
        }
        break;
      }
      g -= n;
    }
  }
  for (int e = tid; e < 2 * LW; e += nt) lower[e] = 0.0f;
  // the increments of a length block and their z/m, by every thread
  auto stage = [&](int t0, int s) {
    for (int e = tid; e < s * d; e += nt) zs[e] = zp[(long long)t0 * d + e];
    for (int e = tid; e < s * (N - 1) * d; e += nt) {
      const int t = e / ((N - 1) * d), r = e - t * (N - 1) * d;
      const int m = r / d, jj = r - m * d;
      zq[e] = __fdiv_rn(zp[(long long)(t0 + t) * d + jj], (float)(m + 2));
    }
  };

  // ---- the thread's top-level entries: column j of rows tile*kTop + i -----
  const int j = jc * jw + tid % jw;
  const int tile = j < d ? tid / jw : tiles;
  float acc[kTop];
#pragma unroll
  for (int i = 0; i < kTop; ++i) acc[i] = 0.0f;
  float zprev = 0.0f;  // z_{t-1}[j]
  auto top_step = [&](const float* Ut) {
    const float4* u4 = reinterpret_cast<const float4*>(Ut + tile * kTile);
#pragma unroll
    for (int i = 0; i < kTop / 4; ++i) {
      const float4 u = u4[i];
      acc[4 * i] = add(mul(u.x, zprev), acc[4 * i]);
      acc[4 * i + 1] = add(mul(u.y, zprev), acc[4 * i + 1]);
      acc[4 * i + 2] = add(mul(u.z, zprev), acc[4 * i + 2]);
      acc[4 * i + 3] = add(mul(u.w, zprev), acc[4 * i + 3]);
    }
  };

  // Each step: the thread's row item (step `step`) and its top-level tile
  // (step - 1, whose U_t the barrier before made complete), then a barrier.
  int step = 0;  // steps done: the current levels are in buffer step & 1
  for (int t0 = 0; t0 < n_steps; t0 += S) {
    const int s = min(S, n_steps - t0);
    stage(t0, s);
    __syncthreads();
    for (int t = 0; t < s; ++t, ++step) {
      if (kind != 0) {  // ---- the thread's row item of step `step` -----------
        const float* cur = lower + (step & 1) * LW;
        float* nxt = lower + ((step + 1) & 1) * LW;
        const float* zt = zs + t * d;
        const float* q2 = zq + t * (N - 1) * d;  // q2 + (m-2)*d: z_t / m
        float* Ut = U + (step & 1) * tiles * kTile;
        if (kind == 4) {
          Ut[0] = 1.0f;  // A_1 = 1 (x) z + A_1: the same bits as A_1 + z
        } else {
          // Y = B_{k-2} + A_{k-2}: the Horner chain from z/k, through
          // (B + A_i) (x) z/(k-i), i = 1..k-3
          float y = 0.0f;
          if (k >= 3) {
            const float ya = cur[yA];
            y = q2[qz0];
            for (int st = 0; st < nst; ++st) {
              const int2 o = chain_tab[st * nt + tid];
              y = mul(add(y, cur[o.x]), q2[o.y]);
            }
            y = add(y, ya);
          }
          // A_k: b = Y (x) z/2 + A_{k-1} (z/2 + A_1 at k = 2)
          float b = 0.0f;
          if (kind == 2) b = add(k == 2 ? q2[bj] : mul(y, q2[bj]), cur[bA]);
          // the item's entries i0 + ii*di, ii < kChunk, below w, every load
          // before the first store (the buffers are one array to the
          // compiler, which would otherwise wait out each load behind the
          // previous entry's store):
          //   A_1 += z;  A_k = b (x) z + A_k;  U_t = Y (x) z/2 + A_{N-1}
          const float* zsrc = kind == 3 ? q2 : zt;
          float za[kChunk], aa[kChunk];
#pragma unroll
          for (int ii = 0; ii < kChunk; ++ii) {
            const int i = i0 + ii * di;
            if (i < w) {
              za[ii] = zsrc[l0 + i];
              aa[ii] = cur[oA + i];
            }
          }
#pragma unroll
          for (int ii = 0; ii < kChunk; ++ii) {
            const int i = i0 + ii * di;
            if (i >= w) continue;
            if (kind == 1) {
              nxt[oA + i] = add(aa[ii], za[ii]);
            } else if (kind == 2) {
              nxt[oA + i] = add(mul(b, za[ii]), aa[ii]);
            } else {
              const int q = qU + i;
              Ut[(q / kTop) * kTile + q % kTop] = add(N == 2 ? za[ii] : mul(y, za[ii]), aa[ii]);
            }
          }
        }
      }
      if (tile < tiles) {  // ---- the top level through step - 1 ---------------
        if (step > 0) top_step(U + ((step - 1) & 1) * tiles * kTile);
        zprev = zs[t * d + j];
      }
      __syncthreads();
    }
  }
  if (tile < tiles) {
    top_step(U + ((step - 1) & 1) * tiles * kTile);
    float* top = out + path * (goff[N] + (long long)pw[N]) + goff[N] + (long long)c * pw[N - p];
#pragma unroll
    for (int i = 0; i < kTop; ++i) {
      const int a = tile * kTop + i;
      if (a < nU) top[(long long)a * d + j] = acc[i];
    }
  }

  // ---- levels 1..N-1 of the slice to `out` (the top level is written) ----
  float* op = out + path * (goff[N] + (long long)pw[N]);
  const float* fin = lower + (n_steps & 1) * LW;
  for (int kk = 1; kk < N && jc == 0; ++kk) {
    if (kk <= p) {  // one entry, P[:kk]: written by the block whose other digits are 0
      const int rest = pw[p - kk];
      if (tid == 0 && c % rest == 0) op[goff[kk] + c / rest] = fin[loff[kk]];
    } else {
      const long long o = goff[kk] + (long long)c * pw[kk - p];
      for (int e = tid; e < pw[kk - p]; e += nt) op[o + e] = fin[loff[kk] + sl.store(kk, e)];
    }
  }
}

}  // namespace

extern "C" {

// z: (B, n_steps, d) float32, n_steps >= 1; out: (B, sig_dim(d, depth))
// float32, every entry written.  The launch is B x d^p x ceil(d / jw) blocks
// (path, prefix, column chunk) of `threads`: at least the step's row items
// (rows cut into chunks of cw <= 4 entries, row_items) and jw *
// ceil(d^(N-1-p) / 16), the top level's tiles; S increments are staged per
// length block.
// Launches on `stream`, does not synchronise, returns cudaGetLastError() (0
// on success).
int signature_horner(const float* z, float* out, long long B, int n_steps, int d,
                     int depth, int p, int jw, int cw, int S, int threads, long long smem,
                     void* stream) {
  if (B < 1 || n_steps < 1 || d < 1 || depth < 1 || depth > kMaxDepth || p < 0 ||
      p > (depth >= 2 ? depth - 1 : 0) || jw < 1 || jw > d || cw < 1 || cw > kChunk ||
      S < 1 || threads < 32 || threads > kMaxThreads || threads % 32 != 0)
    return (int)cudaErrorInvalidValue;
  long long sd = 0;
  for (int k = 1; k <= depth; ++k) sd += ipow(d, k);
  const long long nU = depth >= 2 ? ipow(d, depth - 1 - p) : 1;
  const long long blocks = B * ipow(d, p) * ((d + jw - 1) / jw);
  if (sd > 0x7fffffffLL || (long long)n_steps * d > 0x7fffffffLL || blocks > 0x7fffffffLL ||
      threads < row_items(d, depth, p, cw) || threads < jw * ((nU + kTop - 1) / kTop) ||
      smem < 4 * smem_floats(d, depth, p, cw, S, threads))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      horner, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  horner<<<(unsigned)blocks, threads, (size_t)smem, (cudaStream_t)stream>>>(
      z, out, n_steps, d, depth, p, jw, cw, S);
  return (int)cudaGetLastError();
}

const char* signature_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
