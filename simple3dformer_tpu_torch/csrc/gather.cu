// Row gather and its backward (scatter-add) for Hopper (sm_90a), plain C
// interface.
//
// Replaces the TPU kernels simple3dformer_tpu/kernels/gather.py: _fwd_kernel
// (pallas_call in _fwd_impl) and _bwd_kernel (pallas_call in _bwd).
//
//   forward:  out[b, r, :] = points[b, clamp(idx[b, r], 0, N-1), :]
//   backward: gp[b, n, :]  = sum over r with clamp(idx[b, r]) == n of g[b, r, :]   (f32)
//
// Out-of-range indices clamp, as the JAX package's XLA path (take_along_axis)
// does; the TPU one-hot kernel gave zero rows for them instead.
//
// Forward: the TPU kernel is a one-hot matmul on the MXU. Here it is a plain
// row copy, one warp per output row, lanes over the channels, for any 2- or
// 4-byte element type (the bits are copied). Bytes bound it: each output row
// is read once and written once.
//
// Backward: the TPU kernel adds each grid step's transposed one-hot product
// into one f32 block per batch element across a sequential grid. Hopper blocks
// run in no order, and float atomics would change the bits from run to run.
// Here one block owns (batch element, tile of kRows point rows, tile of
// kThreads channels) and keeps those sums in shared memory. It scans the
// batch element's R indices in order, kThreads at a time: a block-wide
// compaction (warp ballots, then a prefix over the warps) lists the chunk's
// hits on its tile in source order, and each thread then adds, for its
// channel, the gradient row of every hit in that order. So every sum runs in
// source order, the order of index_add_ on the CPU, and two runs give the same
// bits. Each block reads all R indices of its batch element, so the index
// reads grow with N / kRows; at the partseg shapes that is a few MB, from L2.
//
// Every entry returns the first CUDA error of its launches (0 on success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kFwdWarps = 8;
constexpr int kThreads = 128;  // backward: channels a block, and indices a chunk
constexpr int kRows = 32;      // backward: point rows a block

template <typename T>
__global__ void __launch_bounds__(kFwdWarps * 32)
gather_fwd_kernel(const T* __restrict__ points, const int* __restrict__ idx, T* __restrict__ out,
                  int B, int N, int R, int C) {
  const long long row = static_cast<long long>(blockIdx.x) * kFwdWarps + threadIdx.x / 32;
  if (row >= static_cast<long long>(B) * R) return;
  const int b = static_cast<int>(row / R);
  int n = idx[row];
  n = n < 0 ? 0 : (n >= N ? N - 1 : n);
  const T* src = points + (static_cast<size_t>(b) * N + n) * C;
  T* dst = out + static_cast<size_t>(row) * C;
  for (int c = threadIdx.x % 32; c < C; c += 32) dst[c] = src[c];
}

template <typename T>
__device__ __forceinline__ float to_f32(T v);
template <>
__device__ __forceinline__ float to_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
gather_bwd_kernel(const int* __restrict__ idx, const T* __restrict__ g, float* __restrict__ gp,
                  int N, int R, int C) {
  __shared__ float acc[kRows][kThreads];
  __shared__ int hit_r[kThreads];
  __shared__ int hit_row[kThreads];
  __shared__ int warp_count[kThreads / 32];
  const int b = blockIdx.z;
  const int row0 = blockIdx.x * kRows;
  const int c = blockIdx.y * kThreads + threadIdx.x;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
#pragma unroll
  for (int j = 0; j < kRows; ++j) acc[j][tid] = 0.f;
  const int* ib = idx + static_cast<size_t>(b) * R;
  const T* gb = g + static_cast<size_t>(b) * R * C;

  for (int r0 = 0; r0 < R; r0 += kThreads) {
    const int r = r0 + tid;
    int row = -1;
    if (r < R) {
      int n = ib[r];
      n = n < 0 ? 0 : (n >= N ? N - 1 : n);
      row = n - row0;
    }
    const bool hit = row >= 0 && row < kRows;
    const unsigned mask = __ballot_sync(0xffffffffu, hit);
    if (lane == 0) warp_count[warp] = __popc(mask);
    __syncthreads();
    int base = 0, total = 0;
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) {
      base += w < warp ? warp_count[w] : 0;
      total += warp_count[w];
    }
    if (hit) {
      const int pos = base + __popc(mask & ((1u << lane) - 1u));
      hit_r[pos] = r;
      hit_row[pos] = row;
    }
    __syncthreads();
    if (c < C) {
      for (int e = 0; e < total; ++e) {
        acc[hit_row[e]][tid] += to_f32(gb[static_cast<size_t>(hit_r[e]) * C + c]);
      }
    }
    __syncthreads();  // hit lists and counts are rewritten by the next chunk
  }
  if (c >= C) return;
  for (int j = 0; j < kRows && row0 + j < N; ++j) {
    gp[(static_cast<size_t>(b) * N + row0 + j) * C + c] = acc[j][tid];
  }
}

}  // namespace

extern "C" {

// points: [B, N, C], out: [B, R, C], contiguous, elements of elem_bytes (2 or
// 4) bytes; idx: [B, R] int32.
int s3f_gather_fwd(const void* points, const void* idx, void* out, int B, int N, int R, int C,
                   int elem_bytes, void* stream) {
  if (B < 1 || N < 1 || R < 1 || C < 1) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long rows = static_cast<long long>(B) * R;
  const unsigned blocks = static_cast<unsigned>((rows + kFwdWarps - 1) / kFwdWarps);
  const int* i = static_cast<const int*>(idx);
  if (elem_bytes == 4) {
    gather_fwd_kernel<uint32_t><<<blocks, kFwdWarps * 32, 0, s>>>(
        static_cast<const uint32_t*>(points), i, static_cast<uint32_t*>(out), B, N, R, C);
  } else if (elem_bytes == 2) {
    gather_fwd_kernel<uint16_t><<<blocks, kFwdWarps * 32, 0, s>>>(
        static_cast<const uint16_t*>(points), i, static_cast<uint16_t*>(out), B, N, R, C);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

// idx: [B, R] int32; g: [B, R, C] contiguous, f32 (g_dtype 0) or bf16 (1);
// gp: [B, N, C] f32, every element written.
int s3f_gather_bwd(const void* idx, const void* g, void* gp, int B, int N, int R, int C,
                   int g_dtype, void* stream) {
  if (B < 1 || N < 1 || R < 1 || C < 1 || B > 65535) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((N + kRows - 1) / kRows, (C + kThreads - 1) / kThreads, B);
  const int* i = static_cast<const int*>(idx);
  float* out = static_cast<float*>(gp);
  if (g_dtype == 0) {
    gather_bwd_kernel<float><<<grid, kThreads, 0, s>>>(i, static_cast<const float*>(g), out, N,
                                                       R, C);
  } else if (g_dtype == 1) {
    gather_bwd_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        i, static_cast<const __nv_bfloat16*>(g), out, N, R, C);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // extern "C"
