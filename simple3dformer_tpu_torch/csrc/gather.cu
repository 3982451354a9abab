// Row gather and its backward for Hopper (sm_90a), plain C interface.
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
// What bounds them on the H100: bytes. Neither does arithmetic worth counting,
// so the least time is the bytes over the memory rate: the forward reads each
// point row and writes each output row once, the backward reads each
// gradient row and writes each point row once. The TPU kernels' one-hot
// matmuls on the MXU are not carried over.
//
// Forward (gather_fwd_kernel): one flat copy over the output's vectors.
// Thread t copies vector j of output row r, (r, j) = divmod(t, vectors a
// row), so neighbouring threads cover neighbouring addresses across row
// boundaries and every lane works at C = 3 as at C = 512. A vector is the
// widest of 16, 8, 4 or 2 bytes that divides the row's bytes and both
// pointers. One tile of kFwdThreads * kFwdItems vectors a block, the blocks
// in order, so the rows in flight are a narrow window of the output and the
// point rows they read stay in L2; the output is written with streaming
// stores. Positions split with 64-bit division once a block and advance by
// adding precomputed steps. Any 2- or 4-byte element type: bits are copied.
//
// Backward: an inverse index, then one ordered sum per point row. No float
// atomics: each sum runs in ascending r from 0, the order of index_add_ on
// the CPU, so the result equals index_add_ on the CPU bit for bit and two
// runs give the same bits.
//   1. gather_bwd_sort_kernel, a stable counting sort of the clamped indices
//      of each batch element, parallel over R, in one cooperative launch of
//      four phases parted by grid barriers: (1) every chunk of rows counts
//      its rows per point (a histogram in shared memory, integer atomics)
//      into counts [B, N, chunks]; (2) a group of lanes a point turns its
//      chunk counts into an exclusive prefix; (3) a block a batch element
//      scans the points' totals into start [B, N + 1]; (4) every chunk
//      places its rows: within a warp __match_any_sync ranks equal keys by
//      lane, each warp keeps its own running count per point, and the warps
//      of a chunk take a prefix of those counts in row order. perm [B, R]
//      then lists the rows of each point in ascending r, point after point.
//   2. gather_bwd_sum_kernel: a group of lanes sized to the row (up to a
//      warp) owns one point row. It walks the point's stretch of perm in
//      order, loads each gradient row as the widest vectors that divide it
//      (bf16 widened to f32) with streaming loads, a few rows ahead, adds
//      them in order into f32 registers with __fadd_rn, and writes the row
//      once, zero where no row names the point. Every gradient row is read
//      once in all, and no block rescans the indices.
// Beside the gradient rows the backward moves a few idx-sized arrays of ints
// (idx twice, perm twice, the counts). The sort's cost does not depend on C
// (about 19 us on the H100 at B = 16, R = 16384), so at C = 3 it is most of
// the time.
//
// The scratch (perm, start, counts) comes from the caller;
// s3f_gather_bwd_scratch gives its size in ints. Every entry returns the
// first CUDA error of its launches (0 on success).

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>

namespace {

constexpr int kFwdThreads = 256;
constexpr int kFwdItems = 4;       // vectors a thread keeps in flight
constexpr long long kMaxBlocks = 2147483647LL;  // grid x limit; the loop strides past it
constexpr int kSortThreads = 256;
constexpr int kWarpRows = 256;  // rows a warp places, 32 at a time
constexpr int kChunk = kSortThreads / 32 * kWarpRows;  // rows a chunk when N <= kSmemPoints
// points whose sort state (a first slot, and a count a warp) fits in shared
// memory: 20 bytes a point, 160 KB at most; beyond, a chunk is one warp's rows
// and its counts stay in the count matrix
constexpr int kSmemPoints = 8192;
constexpr int kScanItems = 8;  // totals a thread scans a tile
constexpr int kSumThreads = 256;

template <typename T, int E>
struct alignas(sizeof(T) * E) Pack {
  T e[E];
};

__device__ __forceinline__ int clamp_index(int n, int N) { return n < 0 ? 0 : (n >= N ? N - 1 : n); }

// A distance of t vectors in the forward's output, split as t = (b * R + r) * vpr + j.
struct Pos {
  long long b;
  int r, j;
};

__device__ __forceinline__ Pos split(long long t, int vpr, int R) {
  const long long row = t / vpr;
  const long long b = row / R;
  return {b, static_cast<int>(row - b * R), static_cast<int>(t - row * vpr)};
}

// p += d, both split; p.j < vpr, p.r < R and d likewise, so one carry each suffices.
__device__ __forceinline__ void advance(Pos& p, const Pos& d, int vpr, int R) {
  p.b += d.b;
  p.r += d.r;
  p.j += d.j;
  if (p.j >= vpr) {
    p.j -= vpr;
    ++p.r;
  }
  if (p.r >= R) {
    p.r -= R;
    ++p.b;
  }
}

template <typename V>
__global__ void __launch_bounds__(kFwdThreads)
gather_fwd_kernel(const V* __restrict__ points, const int* __restrict__ idx, V* __restrict__ out,
                  long long total, int N, int R, int vpr) {
  constexpr long long kTile = static_cast<long long>(kFwdThreads) * kFwdItems;
  __shared__ Pos first, d_item, d_tile;  // 64-bit divisions once a block
  if (threadIdx.x == 0) {
    first = split(blockIdx.x * kTile, vpr, R);
    d_item = split(kFwdThreads, vpr, R);
    d_tile = split(gridDim.x * kTile, vpr, R);
  }
  __syncthreads();
  const int row = threadIdx.x / vpr;  // this thread's offset in the block's tile, split
  Pos p = first;
  advance(p, Pos{row / R, row % R, static_cast<int>(threadIdx.x) - row * vpr}, vpr, R);
  for (long long t = blockIdx.x * kTile + threadIdx.x; t < total; t += gridDim.x * kTile) {
    Pos q[kFwdItems];
    int n[kFwdItems];
    V v[kFwdItems];
    q[0] = p;
#pragma unroll
    for (int k = 1; k < kFwdItems; ++k) {
      q[k] = q[k - 1];
      advance(q[k], d_item, vpr, R);
    }
#pragma unroll
    for (int k = 0; k < kFwdItems; ++k) {
      n[k] = t + k * kFwdThreads < total ? clamp_index(idx[q[k].b * R + q[k].r], N) : 0;
    }
#pragma unroll
    for (int k = 0; k < kFwdItems; ++k) {
      if (t + k * kFwdThreads < total) v[k] = points[(q[k].b * N + n[k]) * vpr + q[k].j];
    }
#pragma unroll
    for (int k = 0; k < kFwdItems; ++k) {
      if (t + k * kFwdThreads < total) __stcs(out + t + k * kFwdThreads, v[k]);  // write-once
    }
    advance(p, d_tile, vpr, R);
  }
}

// Lanes a group, a power of two up to 32, for a row of n items.
__host__ __device__ __forceinline__ int group_lanes(int n) {
  int lanes = 1;
  while (lanes < 32 && lanes < n) lanes *= 2;
  return lanes;
}

// The sort's arguments: idx [B, R]; counts [B, N, nchunks] (chunks of
// chunk_rows rows), then in place each (point, chunk)'s slot relative to the
// point's first; start [B, N + 1], the first slot of each point and R; perm
// [B, R], the rows of each point in ascending r, point after point.
struct SortArgs {
  const int* idx;
  int* counts;
  int* start;
  int* perm;
  int B, N, R, nchunks;
};

// The stable counting sort in one cooperative launch, four phases parted by
// grid-wide barriers; every phase strides over its work items. kShared: a
// chunk is a block's kChunk rows and its histogram and place state live in
// shared memory; else (large N) a chunk is one warp's kWarpRows rows and its
// column of counts serves as both.
template <bool kShared>
__global__ void __launch_bounds__(kSortThreads) gather_bwd_sort_kernel(const SortArgs a) {
  namespace cg = cooperative_groups;
  extern __shared__ int smem[];
  constexpr int kWarps = kSortThreads / 32, kSteps = kWarpRows / 32;
  constexpr int chunk_rows = kShared ? kChunk : kWarpRows;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int N = a.N, R = a.R, nchunks = a.nchunks;
  const long long chunk_items = static_cast<long long>(a.B) * nchunks;

  // 1. counts[b, n, c]: the rows of chunk c that name point n
  for (long long it = blockIdx.x; it < chunk_items; it += gridDim.x) {
    const long long b = it / nchunks;
    const int c = static_cast<int>(it - b * nchunks), r0 = c * chunk_rows;
    const int r1 = min(R, r0 + chunk_rows);
    int* col = a.counts + b * N * nchunks + c;  // counts[b, n, c] = col[n * nchunks]
    int* hist = kShared ? smem : col;
    const int hs = kShared ? 1 : nchunks;
    for (int n = tid; n < N; n += kSortThreads) hist[static_cast<long long>(n) * hs] = 0;
    __syncthreads();
    for (int r = r0 + tid; r < r1; r += kSortThreads) {
      atomicAdd(&hist[static_cast<long long>(clamp_index(a.idx[b * R + r], N)) * hs], 1);
    }
    __syncthreads();
    if (kShared) {
      for (int n = tid; n < N; n += kSortThreads) col[static_cast<long long>(n) * nchunks] = hist[n];
      __syncthreads();
    }
  }
  cg::this_grid().sync();

  // 2. per point, a group of lanes over its chunks: counts become the
  // exclusive prefix over the chunks, in place; start[b, n] takes the
  // point's total for now
  const int G = group_lanes(nchunks), sub = lane & (G - 1);
  const unsigned gmask = G == 32 ? 0xffffffffu : ((1u << G) - 1u) << (lane / G * G);
  const long long points = static_cast<long long>(a.B) * N;
  for (long long p = (static_cast<long long>(blockIdx.x) * kSortThreads + tid) / G; p < points;
       p += static_cast<long long>(gridDim.x) * (kSortThreads / G)) {
    int* row = a.counts + p * nchunks;
    int carry = 0;
    for (int c0 = 0; c0 < nchunks; c0 += G) {
      const int c = c0 + sub, v = c < nchunks ? row[c] : 0;
      int x = v;  // inclusive scan over the group
      for (int d = 1; d < G; d *= 2) {
        const int y = __shfl_up_sync(gmask, x, d, G);
        if (sub >= d) x += y;
      }
      if (c < nchunks) row[c] = carry + x - v;
      carry += __shfl_sync(gmask, x, G - 1, G);
    }
    if (sub == 0) a.start[p + p / N] = carry;
  }
  cg::this_grid().sync();

  // 3. per batch element: start[b] becomes the exclusive scan of the totals
  __shared__ int warp_sums[kWarps];
  for (long long b = blockIdx.x; b < a.B; b += gridDim.x) {
    int* sb = a.start + b * (N + 1LL);
    int carry = 0;
    for (int n0 = 0; n0 < N; n0 += kSortThreads * kScanItems) {
      const int first = n0 + tid * kScanItems;
      int v[kScanItems], s = 0;
#pragma unroll
      for (int i = 0; i < kScanItems; ++i) {
        v[i] = first + i < N ? sb[first + i] : 0;
        s += v[i];
      }
      int x = s;  // inclusive scan over the warp
#pragma unroll
      for (int d = 1; d < 32; d *= 2) {
        const int y = __shfl_up_sync(0xffffffffu, x, d);
        if (lane >= d) x += y;
      }
      if (lane == 31) warp_sums[warp] = x;
      __syncthreads();
      int before = carry, total = carry;
      for (int w = 0; w < kWarps; ++w) {
        before += w < warp ? warp_sums[w] : 0;
        total += warp_sums[w];
      }
      int excl = before + x - s;
#pragma unroll
      for (int i = 0; i < kScanItems; ++i) {
        if (first + i < N) sb[first + i] = excl;
        excl += v[i];
      }
      carry = total;
      __syncthreads();  // warp_sums is rewritten by the next tile
    }
    if (tid == 0) sb[N] = R;
  }
  cg::this_grid().sync();

  // 4. perm[b, start + prefix + rank] = r. A warp takes kWarpRows consecutive
  // rows, 32 at a time: __match_any_sync ranks the lanes of equal keys and the
  // warp keeps a running count per point, its own (uint16 [warps][N] in
  // shared memory, then a prefix over the warps in row order) or, for large N,
  // its chunk's column of counts.
  const unsigned lower = (1u << lane) - 1u;
  int* base = smem;                                                  // [N]
  uint16_t* wh = reinterpret_cast<uint16_t*>(smem + (kShared ? N : 0)) +
                 static_cast<long long>(warp) * N;                   // [warps][N]
  const long long place_items = kShared ? chunk_items : a.B * ((nchunks + kWarps - 1LL) / kWarps);
  const long long per_b = place_items / a.B;
  for (long long it = blockIdx.x; it < place_items; it += gridDim.x) {
    const long long b = it / per_b;
    const int bc = static_cast<int>(it - b * per_b);
    const int c = kShared ? bc : bc * kWarps + warp;
    const int r0 = kShared ? c * kChunk + warp * kWarpRows : c * kWarpRows;
    int* col = a.counts + b * N * nchunks + c;
    const int* sb = a.start + b * (N + 1LL);
    if (kShared) {
      for (int n = tid; n < N; n += kSortThreads) {
        base[n] = sb[n] + col[static_cast<long long>(n) * nchunks];
      }
      for (int n = lane; n < N; n += 32) wh[n] = 0;
    }
    int key[kSteps], rank[kSteps];
#pragma unroll
    for (int k = 0; k < kSteps; ++k) {
      const int r = r0 + k * 32 + lane;
      key[k] = r < R && (kShared || c < nchunks) ? clamp_index(a.idx[b * R + r], N) : -1;
    }
    if (kShared) __syncthreads();
#pragma unroll
    for (int k = 0; k < kSteps; ++k) {
      const unsigned same = __match_any_sync(0xffffffffu, key[k]);
      const int leader = __ffs(same) - 1;
      int old = 0;
      if (lane == leader && key[k] >= 0) {
        if (kShared) {
          old = wh[key[k]];
          wh[key[k]] = static_cast<uint16_t>(old + __popc(same));
        } else {
          int* cursor = col + static_cast<long long>(key[k]) * nchunks;
          old = *cursor;
          *cursor = old + __popc(same);
          old += sb[key[k]];
        }
      }
      rank[k] = __shfl_sync(0xffffffffu, old, leader) + __popc(same & lower);
      __syncwarp();  // the leaders' counts before the next step reads them
    }
    if (kShared) {
      __syncthreads();
      uint16_t* h = reinterpret_cast<uint16_t*>(smem + N);
      for (int n = tid; n < N; n += kSortThreads) {  // exclusive over the warps, in row order
        int acc = 0;
        for (int w = 0; w < kWarps; ++w) {
          const int t = h[static_cast<long long>(w) * N + n];
          h[static_cast<long long>(w) * N + n] = static_cast<uint16_t>(acc);
          acc += t;
        }
      }
      __syncthreads();
    }
#pragma unroll
    for (int k = 0; k < kSteps; ++k) {
      if (key[k] >= 0) {
        const int first = kShared ? base[key[k]] + wh[key[k]] : 0;
        a.perm[b * R + first + rank[k]] = r0 + k * 32 + lane;
      }
    }
    if (kShared) __syncthreads();  // base and wh are rewritten for the next item
  }
}

// A load that streams past the caches (each gradient row is read once).
template <typename P>
__device__ __forceinline__ P load_once(const P* p) {
  P out;
  if constexpr (sizeof(P) == 16) {
    const uint4 t = __ldcs(reinterpret_cast<const uint4*>(p));
    memcpy(&out, &t, sizeof(P));
  } else if constexpr (sizeof(P) == 8) {
    const uint2 t = __ldcs(reinterpret_cast<const uint2*>(p));
    memcpy(&out, &t, sizeof(P));
  } else if constexpr (sizeof(P) == 4) {
    const unsigned t = __ldcs(reinterpret_cast<const unsigned*>(p));
    memcpy(&out, &t, sizeof(P));
  } else {
    const unsigned short t = __ldcs(reinterpret_cast<const unsigned short*>(p));
    memcpy(&out, &t, sizeof(P));
  }
  return out;
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(uint16_t v) {  // bf16 bits, widened exactly
  return __uint_as_float(static_cast<uint32_t>(v) << 16);
}

// The sum kernel's arguments: start [B, N + 1] and perm [B, R] from the sort,
// g [B, R, C] as vpr vectors a row, gp [B, N, C] f32.
struct SumArgs {
  const int* start;
  const int* perm;
  const void* g;
  float* gp;
  int B, N, R, vpr, lanes;
};

// One group of `lanes` lanes (a power of two, up to 32) a point row; each
// lane holds NV vectors of E elements of the row a pass, so a pass covers
// lanes * NV vectors and longer rows take more passes. T is float or uint16_t
// (bf16 bits).
template <typename T, int E, int NV>
__global__ void __launch_bounds__(kSumThreads) gather_bwd_sum_kernel(const SumArgs a) {
  using In = Pack<T, E>;
  using Out = Pack<float, E>;
  // gradient rows a group has in flight: fewer for long rows (more rows of
  // 2 KB in flight at once were slower on the H100)
  constexpr int kAhead = NV == 4 ? 1 : (NV == 2 ? 2 : 4);
  const int lanes = a.lanes, vpr = a.vpr;
  const int lane = threadIdx.x % 32, sub = lane & (lanes - 1);
  const unsigned gmask =
      lanes == 32 ? 0xffffffffu : ((1u << lanes) - 1u) << (lane / lanes * lanes);
  const long long p = (static_cast<long long>(blockIdx.x) * kSumThreads + threadIdx.x) / lanes;
  if (p >= static_cast<long long>(a.B) * a.N) return;  // whole groups leave together
  const long long b = p / a.N;
  const int* sp = a.start + p + b;  // start[b, n], then start[b, n + 1]
  const int s = sp[0], e = sp[1];
  const int* pb = a.perm + b * a.R;
  const In* gb = static_cast<const In*>(a.g) + b * a.R * vpr;
  Out* out = reinterpret_cast<Out*>(a.gp) + p * vpr;
  for (int v0 = 0; v0 < vpr; v0 += lanes * NV) {
    float acc[NV][E];
#pragma unroll
    for (int v = 0; v < NV; ++v) {
#pragma unroll
      for (int i = 0; i < E; ++i) acc[v][i] = 0.f;
    }
    for (int j0 = s; j0 < e; j0 += lanes) {
      const int cnt = min(lanes, e - j0);
      const int mine = sub < cnt ? pb[j0 + sub] : 0;
      for (int k = 0; k < cnt; k += kAhead) {
        In x[kAhead][NV];
#pragma unroll
        for (int u = 0; u < kAhead; ++u) {
          const long long r = __shfl_sync(gmask, mine, k + u, lanes);
#pragma unroll
          for (int v = 0; v < NV; ++v) {
            const int jv = v0 + sub + v * lanes;
            if (k + u < cnt && jv < vpr) x[u][v] = load_once(gb + r * vpr + jv);
          }
        }
#pragma unroll
        for (int u = 0; u < kAhead; ++u) {  // in ascending r
          if (k + u >= cnt) break;
#pragma unroll
          for (int v = 0; v < NV; ++v) {
#pragma unroll
            for (int i = 0; i < E; ++i) acc[v][i] = __fadd_rn(acc[v][i], to_f32(x[u][v].e[i]));
          }
        }
      }
    }
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      const int jv = v0 + sub + v * lanes;
      if (jv < vpr) {
        Out o;
#pragma unroll
        for (int i = 0; i < E; ++i) o.e[i] = acc[v][i];
        out[jv] = o;
      }
    }
  }
}

// The widest of 16, 8, 4, 2 bytes that divides the row's bytes and every
// pointer, but no narrower than one element.
int vector_bytes(long long row_bytes, int elem_bytes, const void* a, const void* b) {
  int w = 16;
  const auto pa = reinterpret_cast<uintptr_t>(a), pb = reinterpret_cast<uintptr_t>(b);
  while (w > elem_bytes && (row_bytes % w || pa % w || pb % w)) w /= 2;
  return w;
}

int sm_count() {  // of the current card
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) {
    return 1;
  }
  return sms;
}

// One tile a block: the card runs the blocks in order, so the rows in flight
// stay a narrow window of the output and the points they gather stay in L2
// (a grid of resident blocks striding over the output drifts apart and
// spreads over every batch element's points).
template <typename V>
int launch_fwd(const void* points, const int* idx, void* out, int B, int N, int R,
               long long row_bytes, cudaStream_t s) {
  const int vpr = static_cast<int>(row_bytes / sizeof(V));
  const long long total = static_cast<long long>(B) * R * vpr;
  const long long tiles = (total + kFwdThreads * kFwdItems - 1) / (kFwdThreads * kFwdItems);
  const unsigned blocks = static_cast<unsigned>(tiles < kMaxBlocks ? tiles : kMaxBlocks);
  gather_fwd_kernel<V><<<blocks, kFwdThreads, 0, s>>>(static_cast<const V*>(points), idx,
                                                      static_cast<V*>(out), total, N, R, vpr);
  return cudaGetLastError();
}

template <bool kShared>
int launch_sort(const SortArgs& a, cudaStream_t s) {
  const int smem = kShared ? a.N * (sizeof(int) + kSortThreads / 32 * sizeof(uint16_t)) : 0;
  int err = 0;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(gather_bwd_sort_kernel<kShared>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err) return err;
  }
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, gather_bwd_sort_kernel<kShared>,
                                                      kSortThreads, smem);
  if (err) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  // a block a chunk (phases 1 and 4), at least one an SM for phases 2 and 3;
  // more blocks than chunks made every grid barrier slower
  const int sms = sm_count();
  long long items = static_cast<long long>(a.B) * a.nchunks;
  items = items > sms ? items : sms;
  const long long cap = static_cast<long long>(per_sm) * sms;
  const unsigned blocks = static_cast<unsigned>(items < cap ? items : cap);
  void* args[] = {const_cast<SortArgs*>(&a)};
  return cudaLaunchCooperativeKernel(reinterpret_cast<void*>(gather_bwd_sort_kernel<kShared>),
                                     dim3(blocks), dim3(kSortThreads), args, smem, s);
}

template <typename T, int E>
int launch_sum(const SumArgs& a, int nv, cudaStream_t s) {
  const long long threads = static_cast<long long>(a.B) * a.N * a.lanes;
  const unsigned blocks = static_cast<unsigned>((threads + kSumThreads - 1) / kSumThreads);
  if (nv == 1) {
    gather_bwd_sum_kernel<T, E, 1><<<blocks, kSumThreads, 0, s>>>(a);
  } else if (nv == 2) {
    gather_bwd_sum_kernel<T, E, 2><<<blocks, kSumThreads, 0, s>>>(a);
  } else {
    gather_bwd_sum_kernel<T, E, 4><<<blocks, kSumThreads, 0, s>>>(a);
  }
  return cudaGetLastError();
}

template <typename T>
int launch_sum_any(const SumArgs& a, int vbytes, int nv, cudaStream_t s) {
  switch (vbytes / static_cast<int>(sizeof(T))) {
    case 1:
      return launch_sum<T, 1>(a, nv, s);
    case 2:
      return launch_sum<T, 2>(a, nv, s);
    case 4:
      return launch_sum<T, 4>(a, nv, s);
    default:
      if constexpr (sizeof(T) == 2) return launch_sum<T, 8>(a, nv, s);
      return cudaErrorInvalidValue;
  }
}

// Chunks of the sort: kChunk rows where the histograms fit in shared memory,
// else one warp's kWarpRows.
bool shared_sort(int N) { return N <= kSmemPoints; }
int chunk_rows(int N) { return shared_sort(N) ? kChunk : kWarpRows; }
int chunks_of(int N, int R) { return (R + chunk_rows(N) - 1) / chunk_rows(N); }

}  // namespace

extern "C" {

// points: [B, N, C], out: [B, R, C], contiguous, elements of elem_bytes (2 or
// 4) bytes; idx: [B, R] int32.
int s3f_gather_fwd(const void* points, const void* idx, void* out, int B, int N, int R, int C,
                   int elem_bytes, void* stream) {
  if (B < 1 || N < 1 || R < 1 || C < 1 || (elem_bytes != 2 && elem_bytes != 4)) {
    return cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long row_bytes = static_cast<long long>(C) * elem_bytes;
  const int* i = static_cast<const int*>(idx);
  switch (vector_bytes(row_bytes, elem_bytes, points, out)) {
    case 16:
      return launch_fwd<uint4>(points, i, out, B, N, R, row_bytes, s);
    case 8:
      return launch_fwd<uint2>(points, i, out, B, N, R, row_bytes, s);
    case 4:
      return launch_fwd<uint32_t>(points, i, out, B, N, R, row_bytes, s);
    default:
      return launch_fwd<uint16_t>(points, i, out, B, N, R, row_bytes, s);
  }
}

// The ints of scratch s3f_gather_bwd needs: perm [B, R], start [B, N + 1] and
// the count matrix [B, N, chunks].
long long s3f_gather_bwd_scratch(int B, int N, int R) {
  return static_cast<long long>(B) *
         (R + N + 1LL + static_cast<long long>(N) * chunks_of(N, R));
}

// idx: [B, R] int32; g: [B, R, C] contiguous, f32 (g_dtype 0) or bf16 (1);
// gp: [B, N, C] f32, every element written; scratch: s3f_gather_bwd_scratch ints.
int s3f_gather_bwd(const void* idx, const void* g, void* gp, void* scratch, int B, int N, int R,
                   int C, int g_dtype, void* stream) {
  if (B < 1 || N < 1 || R < 1 || C < 1 || (g_dtype != 0 && g_dtype != 1)) {
    return cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nchunks = chunks_of(N, R);
  int* perm = static_cast<int*>(scratch);
  int* start = perm + static_cast<long long>(B) * R;
  int* counts = start + static_cast<long long>(B) * (N + 1);
  const SortArgs sa{static_cast<const int*>(idx), counts, start, perm, B, N, R, nchunks};
  const int err = shared_sort(N) ? launch_sort<true>(sa, s) : launch_sort<false>(sa, s);
  if (err) return err;

  const int elem = g_dtype == 0 ? 4 : 2;
  int vbytes = vector_bytes(static_cast<long long>(C) * elem, elem, g, g);
  // gp holds vbytes / elem f32 a vector
  while (vbytes > elem && reinterpret_cast<uintptr_t>(gp) % (vbytes / elem * 4)) vbytes /= 2;
  SumArgs a{start, perm, g, static_cast<float*>(gp), B, N, R, C * elem / vbytes, 0};
  a.lanes = group_lanes(a.vpr);
  const int per_lane = (a.vpr + a.lanes - 1) / a.lanes;
  const int nv = per_lane <= 1 ? 1 : (per_lane <= 2 ? 2 : 4);
  return g_dtype == 0 ? launch_sum_any<float>(a, vbytes, nv, s)
                      : launch_sum_any<uint16_t>(a, vbytes, nv, s);
}

}  // extern "C"
