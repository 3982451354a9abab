// Farthest point sampling for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel simple3dformer_tpu/kernels/fps.py (_fps_kernel,
// pallas_call in fps_pallas). For each batch element, starting from start[b]:
//
//   out[0] = start
//   dist   = 1e10 everywhere
//   for i in 1 .. npoint-1:
//     c      = xyz[out[i-1]]
//     dist   = min(dist, ((x - cx)^2 + (y - cy)^2) + (z - cz)^2)
//     out[i] = argmax(dist), the smallest index among equal maxima
//
// The distance is computed with IEEE-rounded intrinsics in that order (no FMA
// contraction), so the indices equal those of the plain version, which rounds
// after every operation, bit for bit.
//
// Design: npoint iterations depend on each other, so FPS is bound by the
// latency of one iteration, not by bytes or operations. One block per batch
// element; xyz sits in shared memory (12 bytes a point) and each thread keeps
// the running distance of its PER points in registers. Each iteration is a
// distance update and a block-wide argmax over (value, index): warp shuffles,
// then one warp over the per-warp winners.
//
// Every entry returns the first CUDA error of its launches (0 on success).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;

// (v, i) beats (w, j) when it is larger, or equal with a smaller index.
__device__ __forceinline__ bool beats(float v, int i, float w, int j) {
  return v > w || (v == w && i < j);
}

__device__ __forceinline__ void warp_argmax(float& v, int& i) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float w = __shfl_xor_sync(0xffffffffu, v, off);
    const int j = __shfl_xor_sync(0xffffffffu, i, off);
    if (beats(w, j, v, i)) {
      v = w;
      i = j;
    }
  }
}

template <int PER>
__global__ void __launch_bounds__(kThreads)
fps_kernel(const float* __restrict__ xyz, const int* __restrict__ start, int* __restrict__ out,
           int N, int npoint) {
  extern __shared__ float smem[];
  float* sx = smem;
  float* sy = sx + N;
  float* sz = sy + N;
  __shared__ float warp_v[kWarps];
  __shared__ int warp_i[kWarps];
  __shared__ int far_s;

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const float* p = xyz + static_cast<size_t>(b) * N * 3;
  for (int n = tid; n < N; n += kThreads) {
    sx[n] = p[3 * n];
    sy[n] = p[3 * n + 1];
    sz[n] = p[3 * n + 2];
  }
  float dist[PER];
#pragma unroll
  for (int j = 0; j < PER; ++j) dist[j] = 1e10f;
  int far = start != nullptr ? start[b] : 0;
  int* o = out + static_cast<size_t>(b) * npoint;
  __syncthreads();

  for (int it = 0; it < npoint; ++it) {
    if (tid == 0) o[it] = far;
    if (it + 1 == npoint) break;
    const float cx = sx[far], cy = sy[far], cz = sz[far];
    float best_v = -1.f;
    int best_i = N;
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const int n = j * kThreads + tid;  // ascending per thread: ties keep the first
      if (n < N) {
        const float dx = __fsub_rn(sx[n], cx);
        const float dy = __fsub_rn(sy[n], cy);
        const float dz = __fsub_rn(sz[n], cz);
        const float d = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                                  __fmul_rn(dz, dz));
        dist[j] = fminf(dist[j], d);
        if (dist[j] > best_v) {
          best_v = dist[j];
          best_i = n;
        }
      }
    }
    warp_argmax(best_v, best_i);
    const int warp = tid / 32, lane = tid % 32;
    if (lane == 0) {
      warp_v[warp] = best_v;
      warp_i[warp] = best_i;
    }
    __syncthreads();
    if (warp == 0) {
      float v = lane < kWarps ? warp_v[lane] : -1.f;
      int i = lane < kWarps ? warp_i[lane] : N;
      warp_argmax(v, i);
      if (lane == 0) far_s = i;
    }
    __syncthreads();
    far = far_s;
  }
}

template <int PER>
int launch(const float* xyz, const int* start, int* out, int B, int N, int npoint,
           cudaStream_t s) {
  const size_t smem = static_cast<size_t>(N) * 3 * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(fps_kernel<PER>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  fps_kernel<PER><<<B, kThreads, smem, s>>>(xyz, start, out, N, npoint);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The largest N one launch takes (PER = 32 points a thread).
int s3f_fps_max_points() { return 32 * kThreads; }

// xyz: [B, N, 3] f32 contiguous; start: [B] int32 or null (all 0); out:
// [B, npoint] int32. 1 <= npoint, 1 <= N <= s3f_fps_max_points().
int s3f_fps(const void* xyz, const void* start, void* out, int B, int N, int npoint,
            void* stream) {
  if (B < 1 || N < 1 || npoint < 1 || N > 32 * kThreads) return cudaErrorInvalidValue;
  const float* x = static_cast<const float*>(xyz);
  const int* st = static_cast<const int*>(start);
  int* o = static_cast<int*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int per = (N + kThreads - 1) / kThreads;
  if (per <= 1) return launch<1>(x, st, o, B, N, npoint, s);
  if (per <= 2) return launch<2>(x, st, o, B, N, npoint, s);
  if (per <= 4) return launch<4>(x, st, o, B, N, npoint, s);
  if (per <= 8) return launch<8>(x, st, o, B, N, npoint, s);
  if (per <= 16) return launch<16>(x, st, o, B, N, npoint, s);
  return launch<32>(x, st, o, B, N, npoint, s);
}

}  // extern "C"
