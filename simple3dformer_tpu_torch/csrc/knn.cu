// k nearest neighbours for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel simple3dformer_tpu/kernels/knn.py (_knn_kernel,
// pallas_call in knn_pallas). For each query q of batch b, over the points p
// of the same batch element:
//
//   d(q, p) = max((|q|^2 + |p|^2) - 2 q.p, 0),   |v|^2 = (vx vx + vy vy) + vz vz
//   idx[b, s, :k] = the k smallest d, ascending; equal d keep the smaller index
//   dist[b, s, :k] = those d
//
// the matmul form of simple3dformer_tpu/ops/pointops.square_distance, each
// operation IEEE-rounded (no FMA contraction).
//
// Design: the TPU kernel computes a [tile, N] distance block on the MXU and
// runs k rounds of masked argmin over it. Here one thread owns one query and
// keeps its sorted k-list in registers; the batch element's points pass
// through shared memory in tiles of kTile, in index order, with |p|^2
// computed once per point as the tile is loaded. A candidate enters the list
// only when its distance is strictly smaller than the list's last, and moves
// up past every entry that is larger, or equal with a larger index, so the
// list is sorted by (distance, index): the order of a stable sort, and of the
// TPU kernel's masked-argmin rounds. The work is B*S*N distance evaluations
// (about 10 operations each) plus insertions, so f32 operations bound it; at
// the partseg shapes it is small, and launch latency matters as much.
//
// Every entry returns the first CUDA error of its launches (0 on success).

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 128;
constexpr int kTile = 1024;

template <int KMAX>
__global__ void __launch_bounds__(kThreads)
knn_kernel(const float* __restrict__ query, const float* __restrict__ points,
           int* __restrict__ out_idx, float* __restrict__ out_dist, int S, int N, int k) {
  __shared__ float px[kTile], py[kTile], pz[kTile], pp[kTile];
  const int b = blockIdx.y;
  const int s = blockIdx.x * kThreads + threadIdx.x;
  const bool live = s < S;
  float qx = 0.f, qy = 0.f, qz = 0.f;
  if (live) {
    const float* q = query + (static_cast<size_t>(b) * S + s) * 3;
    qx = q[0];
    qy = q[1];
    qz = q[2];
  }
  const float qq = __fadd_rn(__fadd_rn(__fmul_rn(qx, qx), __fmul_rn(qy, qy)), __fmul_rn(qz, qz));
  float bd[KMAX];
  int bi[KMAX];
#pragma unroll
  for (int j = 0; j < KMAX; ++j) {
    bd[j] = CUDART_INF_F;
    bi[j] = 0x7fffffff;
  }
  float worst = CUDART_INF_F;  // bd[k - 1], kept apart so the list stays in registers
  const float* p = points + static_cast<size_t>(b) * N * 3;
  for (int t0 = 0; t0 < N; t0 += kTile) {
    const int tn = min(kTile, N - t0);
    __syncthreads();
    for (int n = threadIdx.x; n < tn; n += kThreads) {
      const float x = p[3 * (t0 + n)], y = p[3 * (t0 + n) + 1], z = p[3 * (t0 + n) + 2];
      px[n] = x;
      py[n] = y;
      pz[n] = z;
      pp[n] = __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)), __fmul_rn(z, z));
    }
    __syncthreads();
    if (!live) continue;
    for (int n = 0; n < tn; ++n) {
      const float cross =
          __fadd_rn(__fadd_rn(__fmul_rn(qx, px[n]), __fmul_rn(qy, py[n])), __fmul_rn(qz, pz[n]));
      const float d = fmaxf(__fsub_rn(__fadd_rn(qq, pp[n]), __fmul_rn(2.f, cross)), 0.f);
      if (!(d < worst)) continue;  // strictly smaller, or it stays out
      float cd = d;
      int ci = t0 + n;
#pragma unroll
      for (int j = 0; j < KMAX; ++j) {  // one bubble pass keeps (distance, index) order
        if (j < k && (cd < bd[j] || (cd == bd[j] && ci < bi[j]))) {
          const float td = bd[j];
          const int ti = bi[j];
          bd[j] = cd;
          bi[j] = ci;
          cd = td;
          ci = ti;
        }
      }
#pragma unroll
      for (int j = 0; j < KMAX; ++j) {
        if (j == k - 1) worst = bd[j];
      }
    }
  }
  if (!live) return;
  const size_t o = (static_cast<size_t>(b) * S + s) * k;
#pragma unroll
  for (int j = 0; j < KMAX; ++j) {
    if (j < k) {
      out_idx[o + j] = bi[j];
      out_dist[o + j] = bd[j];
    }
  }
}

template <int KMAX>
int launch(const float* q, const float* p, int* idx, float* dist, int B, int S, int N, int k,
           cudaStream_t s) {
  const dim3 grid((S + kThreads - 1) / kThreads, B);
  knn_kernel<KMAX><<<grid, kThreads, 0, s>>>(q, p, idx, dist, S, N, k);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The largest k one launch takes.
int s3f_knn_max_k() { return 32; }

// query: [B, S, 3] f32, points: [B, N, 3] f32, both contiguous; idx: [B, S, k]
// int32, dist: [B, S, k] f32. 1 <= k <= min(N, s3f_knn_max_k()).
int s3f_knn(const void* query, const void* points, void* idx, void* dist, int B, int S, int N,
            int k, void* stream) {
  if (B < 1 || S < 1 || N < 1 || k < 1 || k > N || k > 32) return cudaErrorInvalidValue;
  const float* q = static_cast<const float*>(query);
  const float* p = static_cast<const float*>(points);
  int* i = static_cast<int*>(idx);
  float* d = static_cast<float*>(dist);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (k <= 4) return launch<4>(q, p, i, d, B, S, N, k, s);
  if (k <= 8) return launch<8>(q, p, i, d, B, S, N, k, s);
  if (k <= 16) return launch<16>(q, p, i, d, B, S, N, k, s);
  return launch<32>(q, p, i, d, B, S, N, k, s);
}

}  // extern "C"
