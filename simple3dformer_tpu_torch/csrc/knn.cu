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
// operation IEEE-rounded (no FMA contraction), q.p summed as (qx px + qy py) + qz pz.
//
// What bounds it on this card: B*S*N distance evaluations of about 10 f32
// operations each, and the selection; the bytes are few (2.5 MB at the
// partseg shape). Issue slots and the latency of the selection set its time,
// and there must be enough queries in flight to fill 132 SMs.
//
// Design: one warp per query. The warp holds the query's sorted k-list across
// its lanes, lane j entry j (k <= 32). The block's 8 queries belong to one
// batch element, whose points pass through shared memory in tiles of kTile,
// staged once per block as (x, y, z, |p|^2), 16 bytes a point. Lanes take the
// candidates 32 at a time, lane l point c + l, in index order, two chunks a
// step so that one vote passes both when neither holds a candidate nearer than
// the list's last entry (the common case once the list has filled). In a chunk
// a ballot finds the lanes whose distance is strictly smaller than the last
// entry. Few of them (under kMergeAt) are inserted one at a time in lane order,
// each at the number of entries not greater than it (__popc of a ballot), the
// tail moving up a lane (__shfl_up_sync), the ballot narrowed after each to the
// lanes that still beat the new last entry. Many of them (the first chunks) are
// sorted by a bitonic network across the lanes and merged with the list in
// one bitonic merge, where k is large enough that single inserts would cost
// more: a chunk inserts about min(entering, k) one at a time, since the ballot
// narrows once the list is full, so the merge is taken when that reaches
// kMergeAt (k = 16 merges, 3-NN never; point_kernel_variants.py times both
// ways at every launch of the paths). Since candidates come in index order,
// the entries equal to a candidate have smaller indices and stay before it:
// the list is sorted by (distance, index), the order of a stable sort and of
// the TPU kernel's masked-argmin rounds, and that order is total, so the
// result is the same whichever way a candidate enters, bit for bit the
// exact-order plain version (kernels/knn.py, knn_reference_exact). Lanes past
// a ragged last chunk carry an infinite distance, which never enters; lanes
// at k and above hold no entry.
//
// Past 32 (a list longer than a warp: PointNet++'s MSG groups 128), a second
// kernel takes the call, one block a query: the candidates' (distance, index)
// pairs, computed in the same operations, fill a shared-memory buffer of M
// pairs (a power of two, at most kSortMax), a bitonic network sorts it by the
// same total order, and its first k are the list; for N above the buffer the
// list's k entries stay at its front and each round fills the rest with the
// next candidates. A total order gives one result however the candidates are
// grouped, so it too is bit for bit the exact-order plain version.
//
// Every entry returns the first CUDA error of its launches (0 on success).

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kWarps = 8;  // queries a block
constexpr int kThreads = 32 * kWarps;
constexpr int kTile = 2048;  // points a stage: 32 KB, under the 48 KB default
constexpr unsigned kFull = 0xffffffffu;
constexpr int kNoIndex = 0x7fffffff;
// a chunk with min(entering candidates, k) this large is sorted and merged at
// once; point_kernel_variants.py builds it at 33 (never) to time the merge path
#ifndef S3F_KNN_MERGE_AT
#define S3F_KNN_MERGE_AT 8
#endif
constexpr int kMergeAt = S3F_KNN_MERGE_AT;

__device__ __forceinline__ float norm2(float x, float y, float z) {
  return __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)), __fmul_rn(z, z));
}

// (d, i) before (e, j) in the list's order
__device__ __forceinline__ bool before(float d, int i, float e, int j) {
  return d < e || (d == e && i < j);
}

// A compare-exchange of a bitonic network between lanes lane and lane ^ stride:
// the lane keeps the earlier of the two pairs if keep_earlier, else the later.
__device__ __forceinline__ void exchange(float& d, int& i, int stride, bool keep_earlier) {
  const float od = __shfl_xor_sync(kFull, d, stride);
  const int oi = __shfl_xor_sync(kFull, i, stride);
  if (keep_earlier == before(od, oi, d, i)) {
    d = od;
    i = oi;
  }
}

// The warp's 32 pairs sorted ascending across the lanes: a bitonic sort.
__device__ __forceinline__ void bitonic_sort(float& d, int& i, int lane) {
#pragma unroll
  for (int size = 2; size <= 32; size *= 2) {
#pragma unroll
    for (int stride = size / 2; stride > 0; stride /= 2)
      exchange(d, i, stride, ((lane & size) == 0) == ((lane & stride) == 0));
  }
}

// The same for 32 pairs that rise then fall across the lanes: the sort's last round.
__device__ __forceinline__ void bitonic_merge(float& d, int& i, int lane) {
#pragma unroll
  for (int stride = 16; stride > 0; stride /= 2) exchange(d, i, stride, (lane & stride) == 0);
}

// One query's k-list, entry j in lane j < k, and the last entry in every lane.
struct KList {
  float d;
  int i;
  float worst;

  // The chunk whose lane l holds candidate first + l at distance cd (infinite
  // in a lane past the points) taken into the list.
  __device__ __forceinline__ void take(float cd, int first, int lane, int k) {
    unsigned enter = __ballot_sync(kFull, cd < worst);  // strictly smaller, or it stays out
    if (min(__popc(enter), k) >= kMergeAt) {
      // the entering candidates sorted, reversed against the list (entries
      // past k emptied) and the earlier of each pair kept: the 32 first of
      // both, rising then falling, which the bitonic merge sorts
      float md = CUDART_INF_F;
      int mi = kNoIndex;
      if (cd < worst) {
        md = cd;
        mi = first + lane;
      }
      bitonic_sort(md, mi, lane);
      const float rd = __shfl_sync(kFull, md, 31 - lane);
      const int ri = __shfl_sync(kFull, mi, 31 - lane);
      if (lane >= k) {
        d = CUDART_INF_F;
        i = kNoIndex;
      }
      if (before(rd, ri, d, i)) {
        d = rd;
        i = ri;
      }
      bitonic_merge(d, i, lane);
      worst = __shfl_sync(kFull, d, k - 1);
      return;
    }
    while (enter) {
      const int src = __ffs(enter) - 1;
      const float nd = __shfl_sync(kFull, cd, src);
      const int pos = __popc(__ballot_sync(kFull, lane < k && d <= nd));
      const float up_d = __shfl_up_sync(kFull, d, 1);
      const int up_i = __shfl_up_sync(kFull, i, 1);
      if (lane == pos) {
        d = nd;
        i = first + src;
      } else if (lane > pos) {
        d = up_d;
        i = up_i;
      }
      worst = __shfl_sync(kFull, d, k - 1);
      enter &= __ballot_sync(kFull, cd < worst) & (kFull << src << 1);  // lanes after src
    }
  }
};

__global__ void __launch_bounds__(kThreads)
knn_kernel(const float* __restrict__ query, const float* __restrict__ points,
           int* __restrict__ out_idx, float* __restrict__ out_dist, int S, int N, int k) {
  extern __shared__ float4 tile[];  // min(N, kTile) points: x, y, z, |p|^2
  const int b = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int s = blockIdx.x * kWarps + threadIdx.x / 32;
  const bool live = s < S;  // the same for the whole warp
  float qx = 0.f, qy = 0.f, qz = 0.f;
  if (live) {
    const float* q = query + (static_cast<size_t>(b) * S + s) * 3;
    qx = q[0];
    qy = q[1];
    qz = q[2];
  }
  const float qq = norm2(qx, qy, qz);
  // d(q, tile[n]), infinite past tn
  auto distance = [&](int n, int tn) {
    if (n >= tn) return CUDART_INF_F;
    const float4 v = tile[n];
    const float cross =
        __fadd_rn(__fadd_rn(__fmul_rn(qx, v.x), __fmul_rn(qy, v.y)), __fmul_rn(qz, v.z));
    return fmaxf(__fsub_rn(__fadd_rn(qq, v.w), __fmul_rn(2.f, cross)), 0.f);
  };
  KList list{CUDART_INF_F, kNoIndex, CUDART_INF_F};
  const float* p = points + static_cast<size_t>(b) * N * 3;
  for (int t0 = 0; t0 < N; t0 += kTile) {
    const int tn = min(kTile, N - t0);
    __syncthreads();
    for (int n = threadIdx.x; n < tn; n += kThreads) {
      const float* v = p + 3 * static_cast<size_t>(t0 + n);
      const float x = v[0], y = v[1], z = v[2];
      tile[n] = make_float4(x, y, z, norm2(x, y, z));
    }
    __syncthreads();
    if (!live) continue;
    for (int c = 0; c < tn; c += 64) {  // two chunks a step: one vote when neither enters
      const float d0 = distance(c + lane, tn), d1 = distance(c + 32 + lane, tn);
      if (!__any_sync(kFull, d0 < list.worst || d1 < list.worst)) continue;
      list.take(d0, t0 + c, lane, k);
      list.take(d1, t0 + c + 32, lane, k);
    }
  }
  if (live && lane < k) {
    const size_t o = (static_cast<size_t>(b) * S + s) * k + lane;
    out_idx[o] = list.i;
    out_dist[o] = list.d;
  }
}

constexpr int kSortThreads = 256;
constexpr int kSortMax = 4096;  // pairs a buffer: 32 KB
constexpr int kSortMaxK = 1024;

// k > 32: one block a query; d, i: the shared buffer of M pairs.
__global__ void __launch_bounds__(kSortThreads)
knn_sort_kernel(const float* __restrict__ query, const float* __restrict__ points,
                int* __restrict__ out_idx, float* __restrict__ out_dist, int S, int N, int k,
                int M) {
  extern __shared__ float buf[];
  float* d = buf;
  int* i = reinterpret_cast<int*>(buf + M);
  const int b = blockIdx.y, s = blockIdx.x;
  const float* q = query + (static_cast<size_t>(b) * S + s) * 3;
  const float qx = q[0], qy = q[1], qz = q[2];
  const float qq = norm2(qx, qy, qz);
  const float* p = points + static_cast<size_t>(b) * N * 3;
  int have = 0;  // the list's entries at the buffer's front
  for (int next = 0; next < N;) {
    const int cnt = min(M - have, N - next);
    for (int j = threadIdx.x; j < M - have; j += kSortThreads) {
      float dj = CUDART_INF_F;
      int ij = kNoIndex;
      if (j < cnt) {
        const float* v = p + 3 * static_cast<size_t>(next + j);
        const float x = v[0], y = v[1], z = v[2];
        const float cross =
            __fadd_rn(__fadd_rn(__fmul_rn(qx, x), __fmul_rn(qy, y)), __fmul_rn(qz, z));
        dj = fmaxf(__fsub_rn(__fadd_rn(qq, norm2(x, y, z)), __fmul_rn(2.f, cross)), 0.f);
        ij = next + j;
      }
      d[have + j] = dj;
      i[have + j] = ij;
    }
    __syncthreads();
    for (int size = 2; size <= M; size *= 2) {
      for (int stride = size / 2; stride > 0; stride /= 2) {
        for (int a = threadIdx.x; a < M; a += kSortThreads) {
          const int c = a ^ stride;
          if (c > a) {
            const bool up = (a & size) == 0;  // this pair's half sorts ascending
            if (before(d[c], i[c], d[a], i[a]) == up) {
              const float td = d[a];
              const int ti = i[a];
              d[a] = d[c];
              i[a] = i[c];
              d[c] = td;
              i[c] = ti;
            }
          }
        }
        __syncthreads();
      }
    }
    next += cnt;
    have = k;
  }
  for (int j = threadIdx.x; j < k; j += kSortThreads) {
    const size_t o = (static_cast<size_t>(b) * S + s) * k + j;
    out_idx[o] = i[j];
    out_dist[o] = d[j];
  }
}

}  // namespace

extern "C" {

// The largest k one launch takes: a warp's list up to 32, the sorting kernel past it.
int s3f_knn_max_k() { return kSortMaxK; }

// query: [B, S, 3] f32, points: [B, N, 3] f32, both contiguous; idx: [B, S, k]
// int32, dist: [B, S, k] f32. 1 <= k <= min(N, s3f_knn_max_k()), B <= 65535.
int s3f_knn(const void* query, const void* points, void* idx, void* dist, int B, int S, int N,
            int k, void* stream) {
  if (B < 1 || B > 65535 || S < 1 || N < 1 || k < 1 || k > N || k > kSortMaxK)
    return cudaErrorInvalidValue;
  if (k > 32) {
    int m = 64;
    while (m < N && m < kSortMax) m *= 2;
    knn_sort_kernel<<<dim3(S, B), kSortThreads, static_cast<size_t>(m) * 8,
                      static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(query), static_cast<const float*>(points),
        static_cast<int*>(idx), static_cast<float*>(dist), S, N, k, m);
    return cudaGetLastError();
  }
  const dim3 grid((S + kWarps - 1) / kWarps, B);
  const size_t smem = static_cast<size_t>(N < kTile ? N : kTile) * sizeof(float4);
  knn_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(query), static_cast<const float*>(points), static_cast<int*>(idx),
      static_cast<float*>(dist), S, N, k);
  return cudaGetLastError();
}

}  // extern "C"
