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
// What bounds it on this card: the npoint iterations depend on each other, so
// the latency of one iteration bounds it, not bytes or operations: its chain
// of shared-memory reads, reductions and a barrier; and, where N is large, the
// N distance updates (about 12 instructions a point) that the one SM holding
// the batch element issues each iteration (4096 points: some 400 cycles).
//
// Design: one block per batch element, THREADS and PER picked by N (the
// fastest of those timed on the card at the point paths' N by
// point_kernel_variants.py; up to 128 points one warp, which needs no
// barrier). Each thread keeps the running distance of its PER points (point
// j * THREADS + tid) in registers, and their coordinates too up to 4096
// points; xyz also sits in shared memory, where every warp reads the centroid
// by its index. An
// iteration is one barrier: each warp reduces its (distance, index) argmax
// with Hopper's redux.sync (distances are non-negative floats, which order as
// their unsigned bits: __reduce_max_sync on the bits, then __reduce_min_sync
// on the index among the lanes holding that maximum), writes it to a
// double-buffered shared slot, crosses the barrier, and reduces the warps'
// winners itself the same way, so every warp knows the next centroid without
// a second barrier or a broadcast. A slot is written again two iterations
// later, after a barrier that every reader of it has passed. A cluster of
// 2-8 blocks a batch element, the winners exchanged through distributed
// shared memory behind one cluster barrier an iteration, was slower at every
// shape tried: the cluster barrier costs more than the updates it spreads.
//
// Every entry returns the first CUDA error of its launches (0 on success).

#include <cuda_runtime.h>

#include "smem_once.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned kNoIndex = 0x7fffffffu;
constexpr int kMaxPoints = 16384;

// The warp's (largest distance, smallest index among its holders); d >= 0.
__device__ __forceinline__ void warp_argmax(unsigned& bits, unsigned& index) {
  const unsigned top = __reduce_max_sync(kFull, bits);
  index = __reduce_min_sync(kFull, bits == top ? index : kNoIndex);
  bits = top;
}

template <int THREADS, int PER>
__global__ void __launch_bounds__(THREADS)
fps_kernel(const float* __restrict__ xyz, const int* __restrict__ start, int* __restrict__ out,
           int N, int npoint) {
  constexpr int kWarps = THREADS / 32;
  // coordinates in registers up to 4096 points a block (3 * PER registers a
  // thread: 48 at 256 threads, 12 at 1024); else read from shared memory
  constexpr bool kRegs = THREADS * PER <= 4096;
  extern __shared__ float smem[];
  float* sx = smem;
  float* sy = sx + N;
  float* sz = sy + N;
  __shared__ uint2 slots[2][kWarps];  // the warps' winners: (distance bits, index)

  const int b = blockIdx.x;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const float* p = xyz + static_cast<size_t>(b) * N * 3;
  for (int n = tid; n < N; n += THREADS) {
    sx[n] = p[3 * n];
    sy[n] = p[3 * n + 1];
    sz[n] = p[3 * n + 2];
  }
  __syncthreads();
  float px[kRegs ? PER : 1], py[kRegs ? PER : 1], pz[kRegs ? PER : 1], dist[PER];
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const int n = j * THREADS + tid;
    if (kRegs) {
      px[j] = sx[min(n, N - 1)];
      py[j] = sy[min(n, N - 1)];
      pz[j] = sz[min(n, N - 1)];
    }
    dist[j] = n < N ? 1e10f : 0.f;  // past N: 0, never ahead of a real point
  }
  int far = start != nullptr ? start[b] : 0;
  int* o = out + static_cast<size_t>(b) * npoint;
  if (tid == 0) o[0] = far;

  for (int it = 1; it < npoint; ++it) {
    const float cx = sx[far], cy = sy[far], cz = sz[far];
    float best = -1.f;
    unsigned index = kNoIndex;
#pragma unroll
    for (int j = 0; j < PER; ++j) {  // ascending index: a tie keeps the first
      const int n = j * THREADS + tid;
      const float x = kRegs ? px[j] : sx[min(n, N - 1)];
      const float y = kRegs ? py[j] : sy[min(n, N - 1)];
      const float z = kRegs ? pz[j] : sz[min(n, N - 1)];
      const float dx = __fsub_rn(x, cx), dy = __fsub_rn(y, cy), dz = __fsub_rn(z, cz);
      const float d =
          __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
      dist[j] = fminf(dist[j], d);  // d >= 0: a point past N stays at 0
      if (dist[j] > best) {
        best = dist[j];
        index = n;
      }
    }
    unsigned bits = __float_as_uint(best);
    warp_argmax(bits, index);
    if (kWarps > 1) {
      const int slot = it & 1;
      if (lane == 0) slots[slot][warp] = make_uint2(bits, index);
      __syncthreads();
      const uint2 w = lane < kWarps ? slots[slot][lane] : make_uint2(0u, kNoIndex);
      bits = w.x;
      index = w.y;
      warp_argmax(bits, index);
    }
    far = static_cast<int>(index);
    if (tid == 0) o[it] = far;
  }
}

template <int THREADS, int PER>
int launch(const float* xyz, const int* start, int* out, int B, int N, int npoint,
           cudaStream_t s) {
  auto kernel = fps_kernel<THREADS, PER>;
  static SmemOnce once;  // the most this instantiation takes: THREADS * PER points
  const int err = once(kernel, static_cast<size_t>(THREADS) * PER * 3 * sizeof(float));
  if (err) return err;
  kernel<<<B, THREADS, static_cast<size_t>(N) * 3 * sizeof(float), s>>>(xyz, start, out, N,
                                                                       npoint);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The largest N one launch takes.
int s3f_fps_max_points() { return kMaxPoints; }

// xyz: [B, N, 3] f32 contiguous; start: [B] int32 in [0, N) or null (all 0);
// out: [B, npoint] int32. 1 <= npoint, 1 <= N <= s3f_fps_max_points().
int s3f_fps(const void* xyz, const void* start, void* out, int B, int N, int npoint,
            void* stream) {
  if (B < 1 || N < 1 || npoint < 1 || N > kMaxPoints) return cudaErrorInvalidValue;
  const float* x = static_cast<const float*>(xyz);
  const int* st = static_cast<const int*>(start);
  int* o = static_cast<int*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (N <= 32) return launch<32, 1>(x, st, o, B, N, npoint, s);
  if (N <= 128) return launch<32, 4>(x, st, o, B, N, npoint, s);
  if (N <= 256) return launch<128, 2>(x, st, o, B, N, npoint, s);
  if (N <= 1024) return launch<128, 8>(x, st, o, B, N, npoint, s);
  if (N <= 2048) return launch<512, 4>(x, st, o, B, N, npoint, s);
  if (N <= 4096) return launch<512, 8>(x, st, o, B, N, npoint, s);
  if (N <= 8192) return launch<1024, 8>(x, st, o, B, N, npoint, s);
  return launch<1024, 16>(x, st, o, B, N, npoint, s);
}

}  // extern "C"
