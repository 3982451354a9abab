// One-pass Adam update over every trainable f32 leaf, in one launch, for
// Hopper (sm_90a), plain C interface.
//
//   g' = g + wd p                       (L2 weight decay, when wd != 0)
//   m' = b1 m + (1 - b1) g'
//   v' = b2 v + (1 - b2) g' g'
//   p' = p - lr (m' / bc1) / (sqrt(v' / bc2) + eps),   bc = 1 - b**t
//
// p, m and v are updated in place. The leaves are a device table of L rows
// (six int64 arrays of L entries back to back, then one more for the chunk
// starts): p, m, v and g pointers, the leaf's length, and the index of its
// first chunk of CHUNK elements; chunk_start[L] is the total. One block per
// chunk finds its leaf by binary search. A null g is a zero gradient (a leaf
// the loss does not reach).
//
// Bytes bound it: 7 f32 passes (read p, m, v, g; write p, m, v). Every step is
// an IEEE-rounded intrinsic (no FMA contraction) in the order of the TPU
// kernel (simple3dformer_tpu/kernels/adam.py _adam_kernel), with the bias
// corrections divided, not multiplied by a reciprocal; the f32 constants
// (1 - b1, 1 - b2, bc1, bc2) come from the host as the JAX package rounds them.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = kThreads * 16;

struct AdamScalars {
  float lr, bc1, bc2, b1, b2, c1, c2, eps, wd;
};

__global__ void __launch_bounds__(kThreads)
adam_kernel(const long long* __restrict__ table, int L, AdamScalars k) {
  const long long* P = table;
  const long long* Mo = table + L;
  const long long* V = table + 2 * L;
  const long long* G = table + 3 * L;
  const long long* NUM = table + 4 * L;
  const long long* START = table + 5 * L;  // L + 1 entries
  const long long c = blockIdx.x;
  int lo = 0, hi = L - 1;  // the last leaf whose first chunk is <= c
  while (lo < hi) {
    const int mid = (lo + hi + 1) / 2;
    if (START[mid] <= c) {
      lo = mid;
    } else {
      hi = mid - 1;
    }
  }
  float* p = reinterpret_cast<float*>(P[lo]);
  float* m = reinterpret_cast<float*>(Mo[lo]);
  float* v = reinterpret_cast<float*>(V[lo]);
  const float* g = reinterpret_cast<const float*>(G[lo]);
  const long long n = NUM[lo];
  const long long begin = (c - START[lo]) * kChunk;
  const long long end = begin + kChunk < n ? begin + kChunk : n;
  for (long long i = begin + threadIdx.x; i < end; i += kThreads) {
    const float pi = p[i];
    float gi = g != nullptr ? g[i] : 0.f;
    if (k.wd != 0.f) gi = __fadd_rn(gi, __fmul_rn(k.wd, pi));
    const float mi = __fadd_rn(__fmul_rn(k.b1, m[i]), __fmul_rn(k.c1, gi));
    const float vi = __fadd_rn(__fmul_rn(k.b2, v[i]), __fmul_rn(__fmul_rn(k.c2, gi), gi));
    const float mhat = __fdiv_rn(mi, k.bc1);
    const float vhat = __fdiv_rn(vi, k.bc2);
    const float step = __fdiv_rn(__fmul_rn(k.lr, mhat), __fadd_rn(__fsqrt_rn(vhat), k.eps));
    p[i] = __fsub_rn(pi, step);
    m[i] = mi;
    v[i] = vi;
  }
}

}  // namespace

extern "C" {

// Elements per chunk (one block each); the host counts chunks with it.
int s3f_adam_chunk() { return kChunk; }

// table: device int64 [6 * L + 1] as above; chunks: chunk_start[L].
// c1 = f32(1 - b1), c2 = f32(1 - b2), bc1, bc2 = f32 bias corrections.
int s3f_adam(const void* table, int L, long long chunks, float lr, float bc1, float bc2, float b1,
             float b2, float c1, float c2, float eps, float wd, void* stream) {
  if (L < 1 || chunks < 1) return cudaErrorInvalidValue;
  const AdamScalars k{lr, bc1, bc2, b1, b2, c1, c2, eps, wd};
  adam_kernel<<<static_cast<unsigned>(chunks), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(table), L, k);
  return cudaGetLastError();
}

}  // extern "C"
