// Truncated signatures by Horner's scheme (pySigLib Alg 2) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of the JAX package:
//   signature_horner  <- repro/kernels/signature/kernel.py:horner_kernel
//                        (built by build_horner, driven by ops._horner_flat)
//
// What it computes.  For each path, over its increments z_1..z_n in order,
// levels N..1 of the flat signature are updated in place (A_0 = 1 implicit):
//   for k = N..2:  B = z/k;  B = (B + A_i) (x) z/(k-i) for i = 1..k-2;
//                  A_k = (B + A_{k-1}) (x) z + A_k
//   A_1 = A_1 + z
// where every level read is the value from before the step.
//
// Design.  The TPU kernel keeps a tile of 128 paths on the lanes and their
// whole (sig_dim, 128) signature in VMEM.  A GPU thread cannot hold a path's
// signature (69,904 floats at d = 16, N = 4), so here one thread block owns
// one path and spreads each level's entries over its threads.
//   * Levels 1..N-1 live in shared memory.  The top level A_N does not fit
//     there at d = 16, N = 4 (256 KiB), nor in the block's registers (64 a
//     thread at most at 1024 threads), so it lives in the output row in
//     device memory (it stays in the 50 MB L2 at the paper's sizes) and is
//     updated once per length block: A_N depends on the lower levels only
//     through U_t = B_N + A_{N-1} of each step, so the block stages the
//     increments of S steps and their U_t in shared memory, and each thread
//     then runs its entries of A_N through the S steps in order,
//     A_N[a*d+j] = U_t[a] * z_t[j] + A_N[a*d+j].  This is the operation
//     order of the per-step update, so the result does not depend on S.
//   * Reverse level order in place: a barrier separates the levels, so level
//     k reads the old A_1..A_{k-1} before they change.
//   * The Horner accumulator is staged: B of each level is built in shared
//     memory, one tensor power at a time (ping-pong buffers of d^(N-2)), with
//     a barrier per power; the last power is formed inline by the thread that
//     needs it (recomputed d times, one multiply and one add, instead of
//     another barrier).  Per step that is 2 + sum_{k=2}^{N} max(k-2, 1)
//     barriers, 12 at N = 6.
//   * z/m for m = 2..N is formed once per step, by true division
//     (__fdiv_rn), never as a multiplication by a reciprocal.
// Every operation rounds on its own (__fmul_rn/__fadd_rn, never contracted
// into an FMA), so the kernel computes each entry bit for bit as the plain
// PyTorch scan does (kernel.horner_plain), whatever the length block and
// thread count.  Zero increments are exact no-ops (A + 0 * x = A).
//
// What bounds it on an H100.  Operations: per path and step Horner does
// ~d^N * 2 of its ~2.3 d^N flops in the top level (149,152 flops at d = 16,
// N = 4), against 67 TFLOP/s FP32; the bytes (the increments in, the
// signature out) are negligible.  This first kernel is far from that bound:
// each top-level update reads U_t and z_t from shared memory for one
// multiply and one add, A_N makes one round trip through L2 per length
// block, and the small lower levels are latency-bound on barriers.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kMaxDepth = 16;

// Each operation rounds on its own, as the plain version's elementwise ops.
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }

// e = a * d + j
struct Split {
  int d, shift;  // shift = log2(d) when d is a power of two, else -1
  __device__ __forceinline__ void operator()(int e, int& a, int& j) const {
    if (shift >= 0) {
      a = e >> shift;
      j = e & (d - 1);
    } else {
      a = e / d;
      j = e - a * d;
    }
  }
};

long long ipow(long long d, int k) {
  long long r = 1;
  for (int i = 0; i < k; ++i) r *= d;
  return r;
}

// Dynamic shared memory in floats (mirrored by kernel.smem_bytes):
//   lower  sig_dim(d, N-1)    levels 1..N-1
//   zs     S*d                the increments of the length block
//   zq     (N-1)*d            z/m for m = 2..N of the current step
//   chain  2*d^(N-2), N >= 4  ping-pong buffers of the Horner accumulator
//   U      S*d^(N-1), N >= 2  U_t = B_N + A_{N-1} of each staged step
long long smem_floats(int d, int depth, int S) {
  long long lower = 0;
  for (int k = 1; k < depth; ++k) lower += ipow(d, k);
  long long n = lower + (long long)S * d + (long long)(depth - 1) * d;
  if (depth >= 4) n += 2 * ipow(d, depth - 2);
  if (depth >= 2) n += (long long)S * ipow(d, depth - 1);
  return n;
}

__global__ void __launch_bounds__(kMaxThreads)
horner(const float* __restrict__ z, float* __restrict__ out, int n_steps, int d,
       int depth, int S, int shift) {
  extern __shared__ float smem[];
  __shared__ int size[kMaxDepth + 1];  // size[k] = d^k
  __shared__ int off[kMaxDepth + 1];   // off[k] = offset of level k in the flat row
  const int tid = threadIdx.x, nt = blockDim.x;
  if (tid == 0) {
    int s = 1, o = 0;
    for (int k = 0; k <= depth; ++k) {
      size[k] = s;
      off[k] = o;  // levels 1..k-1 come before level k
      if (k >= 1) o += s;
      s *= d;
    }
  }
  __syncthreads();
  const Split sp{d, shift};
  const int lowN = off[depth];  // floats of levels 1..N-1; the top level follows
  const int dN = size[depth];
  const int dN1 = size[depth - 1];
  const int chain = depth >= 4 ? size[depth - 2] : 0;
  float* lower = smem;
  float* zs = lower + lowN;
  float* zq = zs + S * d;  // row m-2 holds z/m
  float* bufA = zq + (depth - 1) * d;
  float* bufB = bufA + chain;
  float* U = bufB + chain;
  const float* zp = z + (long long)blockIdx.x * n_steps * d;
  float* op = out + (long long)blockIdx.x * (lowN + dN);

  for (int e = tid; e < lowN; e += nt) lower[e] = 0.0f;
  __syncthreads();

  for (int t0 = 0; t0 < n_steps; t0 += S) {
    const int s = min(S, n_steps - t0);
    for (int e = tid; e < s * d; e += nt) zs[e] = zp[(long long)t0 * d + e];
    __syncthreads();
    for (int t = 0; depth >= 2 && t < s; ++t) {
      const float* zt = zs + t * d;
      for (int e = tid; e < (depth - 1) * d; e += nt) {
        int m, j;
        sp(e, m, j);
        zq[e] = __fdiv_rn(zt[j], (float)(m + 2));
      }
      __syncthreads();
      for (int k = depth; k >= 2; --k) {
        const float* cur = zq + (k - 2) * d;  // B = z/k
        float* nxt = bufA;
        for (int i = 1; i <= k - 3; ++i) {  // B = (B + A_i) (x) z/(k-i)
          const float* Ai = lower + off[i];
          const float* zd = zq + (k - i - 2) * d;
          for (int e = tid; e < size[i + 1]; e += nt) {
            int a, j;
            sp(e, a, j);
            nxt[e] = mul(add(cur[a], Ai[a]), zd[j]);
          }
          __syncthreads();
          cur = nxt;
          nxt = nxt == bufA ? bufB : bufA;
        }
        // cur holds B after k-3 powers (k >= 3), or B = z/2 (k == 2)
        const float* Akm1 = lower + off[k - 1];
        const float* Akm2 = lower + off[k - 2];  // used for k >= 3 only
        if (k == depth) {  // stage U_t = B + A_{N-1} for the top level
          float* Ut = U + t * dN1;
          for (int e = tid; e < dN1; e += nt) {
            float b;
            if (k == 2) {
              b = cur[e];
            } else {
              int a, j;
              sp(e, a, j);
              b = mul(add(cur[a], Akm2[a]), zq[j]);  // last power: (x) z/2
            }
            Ut[e] = add(b, Akm1[e]);
          }
        } else {  // A_k = (B + A_{k-1}) (x) z + A_k, in shared memory
          float* Ak = lower + off[k];
          for (int e = tid; e < size[k]; e += nt) {
            int a, j;
            sp(e, a, j);
            float b;
            if (k == 2) {
              b = cur[a];
            } else {
              int a2, j2;
              sp(a, a2, j2);
              b = mul(add(cur[a2], Akm2[a2]), zq[j2]);
            }
            Ak[e] = add(mul(add(b, Akm1[a]), zt[j]), Ak[e]);
          }
        }
        __syncthreads();
      }
      // A_1 += z; the next step's barrier (or the one below) orders it
      for (int e = tid; e < d; e += nt) lower[e] = add(lower[e], zt[e]);
    }
    __syncthreads();
    // the top level through the block's steps, in order
    for (int e = tid; e < dN; e += nt) {
      int a, j;
      sp(e, a, j);
      float acc = t0 == 0 ? 0.0f : op[lowN + e];
      if (depth == 1) {
        for (int t = 0; t < s; ++t) acc = add(acc, zs[t * d + j]);
      } else {
        for (int t = 0; t < s; ++t) acc = add(mul(U[t * dN1 + a], zs[t * d + j]), acc);
      }
      op[lowN + e] = acc;
    }
    __syncthreads();  // zs and U are refilled by the next block
  }
  for (int e = tid; e < lowN; e += nt) op[e] = lower[e];
}

}  // namespace

extern "C" {

// z: (B, n_steps, d) float32, n_steps >= 1; out: (B, sig_dim(d, depth))
// float32, every entry written.  S increments are staged per block; threads
// is a multiple of 32 in [32, 1024].  Launches on `stream`, does not
// synchronise, returns cudaGetLastError() (0 on success).
int signature_horner(const float* z, float* out, long long B, int n_steps, int d,
                     int depth, int S, int threads, long long smem, void* stream) {
  if (B < 1 || B > 0x7fffffffLL || n_steps < 1 || d < 1 || depth < 1 ||
      depth > kMaxDepth || S < 1 || threads < 32 || threads > kMaxThreads ||
      threads % 32 != 0)
    return (int)cudaErrorInvalidValue;
  long long sd = 0;
  for (int k = 1; k <= depth; ++k) sd += ipow(d, k);
  if (sd > 0x7fffffffLL || (long long)n_steps * d > 0x7fffffffLL ||
      smem < 4 * smem_floats(d, depth, S))
    return (int)cudaErrorInvalidValue;
  int shift = (d & (d - 1)) == 0 ? __builtin_ctz((unsigned)d) : -1;
  cudaError_t err = cudaFuncSetAttribute(
      horner, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  horner<<<(unsigned)B, threads, (size_t)smem, (cudaStream_t)stream>>>(
      z, out, n_steps, d, depth, S, shift);
  return (int)cudaGetLastError();
}

const char* signature_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
