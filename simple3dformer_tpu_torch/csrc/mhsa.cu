// Multi-head self-attention, forward and backward, on Hopper's tensor cores
// (sm_90a), plain C interface.
//
// Replaces the TPU kernels of simple3dformer_tpu/kernels/mhsa.py: the forward
// (_fwd_kernel :69 over _probs :57, pallas_call :120) and the backward
// (_bwd_kernel :74, pallas_call :144). Per (sample, head), on rows of q, k, v,
// g [N, dh]:
//
//   s = (q k^T) * scale                     f32
//   p = exp(s - rowmax(s)) / rowsum(...)     f32
//   o = round(p) v                           round() = to the input dtype
//   dv = round(p)^T g;  dp = g v^T;  ds = p * (dp - delta) * scale
//   dq = round(ds) k;   dk = round(ds)^T q   every product summed in f32
//
// What bounds it: the products. At the S3DIS shape (B=4, N=1025, H=3, dh=256)
// the forward's two products are 12.9 GFLOP against 50 MB moved, the backward's
// five 32 GFLOP: operations, at the tensor cores' rate. Every product here is
// an mma.sync on the tensor cores, f32 sums in registers:
//
//   f32   mma.sync.m16n8k8 .tf32, 3-pass: each f32 operand x splits into
//         big = tf32(x) (round to nearest, ties away, as cvt.rna.tf32.f32) and
//         small = x - big, and a product is a_small b_big + a_big b_small +
//         a_big b_big (CUTLASS's OpMultiplyAddFastF32). One pass keeps about 10
//         bits of each operand and misses 1e-4 of the largest value at dh =
//         256 (the CPU test tests/test_torch_port_mhsa.py pins that); three
//         keep about 21. The split is made where a fragment leaves shared
//         memory or the score registers, so shared memory holds each tile
//         once. The bound is the 3-pass rate, 495 / 3 = 165 TFLOP/s.
//   bf16  mma.sync.m16n8k16 .bf16, one pass: a bf16 x bf16 product is exact in
//         f32. The bound is the bf16 rate, 989 TFLOP/s.
//
// mma.sync and not wgmma: wgmma's .tf32 form wants both operands K-major, and
// p v's B operand v is [keys, dh] with dh contiguous (MN-major), as are k in
// ds k and q, g in ds^T q, p^T g; mma.sync reads any layout from shared memory,
// one element or pair at a time (bf16: ldmatrix.trans for the MN-major
// operands). Tiles are copied with cp.async (16 bytes a thread, zero fill
// beyond N), each load overlapping a product. What the design does about the
// products' cost: no product is computed twice in f32's forward; the backward
// keeps ds in device memory so that dq is one product, not three; and the
// blocks run 8 warps, the mma chains of a warp kept short (the small terms
// summed apart), since one warp per scheduler left most of the time in
// latency.
//
//   mhsa_fwd_kernel   one block (8 warps) per (sample*head, 64 query rows):
//                     two warp groups of 4 share the rows (16 a warp) and split
//                     each 64-key tile, their sums joined at the end. f32: one
//                     pass with an online softmax (running max and sum, the
//                     accumulator rescaled when a max grows, one division at
//                     the end): rounding p to f32 is the identity, so only the
//                     order of the sums changes. bf16: the TPU kernel rounds
//                     the normalised p before p v, and a one-pass kernel would
//                     round exp(s - running max) instead, another function; so
//                     a first pass computes only the row statistics (q k^T,
//                     one product) and a second forms round(p) and p v. The
//                     final (max, sum) of each row goes to `stats` [B*H, N, 2].
//   mhsa_go_kernel    f32: delta = rowsum(g * o), equal in real arithmetic to
//                     the TPU kernel's rowsum(dp * p) (g_i . o_i = sum_j p_ij
//                     dp_ij), at O(dh) a row; one warp a row.
//   mhsa_delta_kernel bf16: o was formed from round(p) and is itself rounded,
//                     so delta = rowsum(dp * p), the TPU kernel's form: q k^T
//                     and g v^T over the keys, one block per 64 query rows.
//   mhsa_dkdv_kernel  one block (8 warps) per (sample*head, 32 key rows), over
//                     every query tile of 32 in order, dk and dv in f32
//                     registers: no float atomics, two runs give the same bits.
//                     It also writes round(ds) to scratch [B*H, N, ldn].
//   mhsa_dq_kernel    dq = round(ds) k, one block (8 warps) per (sample*head,
//                     64 query rows), over the key tiles in order.
//
// Products per (query, key) pair. Forward: f32 2 (q k^T, p v), bf16 3 (q k^T
// again for the statistics). Backward: 5 in f32 (dkdv kernel k q^T, v g^T,
// p^T g, ds^T q; dq kernel ds k), each three mma passes, 7 in bf16 (the delta
// kernel's two), one pass each: the TPU kernel's 5, which its sequential grid
// reaches by carrying dk and dv across query tiles, here by the round trip of
// ds through device memory (B*H*N*ldn values of the input dtype, 50 MB at the
// S3DIS shape in f32). PR 5's FMA kernels had 3 and 9.
//
// N runs from 1 up with no padding: rows at or beyond N load as zeros and
// score columns beyond N are left out of every sum (the TPU's pad-to-128 and
// -1e30 mask). q, k, v and g are read in place through their (sample, token,
// head) strides, which the caller keeps 16-byte aligned; o, dq, dk and dv are
// written contiguous [B, N, H, dh].
//
// Every entry returns the first CUDA error of its launches (0 on success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstdint>
#include <type_traits>

#include "tensor_core.cuh"

namespace {

constexpr int BQ = 64;       // query rows of a forward, delta or dq block
constexpr int BK = 32;       // key rows of a delta or dq block's tile
constexpr int BKV = 32;      // key rows of a dkdv block
constexpr int BQ_KV = 32;    // query rows a dkdv block holds at a time
constexpr int LDP = BQ_KV + 8;  // a dkdv score tile's row: conflict-free float2
constexpr float LOG2E = 1.4426950408889634f;

template <typename T>
constexpr bool is_bf16 = std::is_same_v<T, bf16>;

// A tile row in shared memory: DH values and 16 bytes of pad, so rows stay
// 16-byte aligned and consecutive rows start 4 banks apart.
template <typename T, int DH>
constexpr int LD = DH + 16 / static_cast<int>(sizeof(T));

__device__ __forceinline__ float ex(float x) { return exp2f(x * LOG2E); }

// The sum and max over the 4 lanes of a quad, which hold one row of a tile.
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

// Start copying `rows` rows of DH values from src (row stride `stride`
// elements) into dst (row stride LD); rows at or beyond `valid` are zero-filled.
// Every thread of the block takes part; the caller commits the group.
template <typename T, int DH, int ROWS>
__device__ __forceinline__ void load_rows(T* dst, const T* src, long long stride, int valid) {
  constexpr int PER = 16 / sizeof(T);  // elements a 16-byte copy moves
  constexpr int CPR = DH / PER;        // copies a row
  for (int i = threadIdx.x; i < ROWS * CPR; i += blockDim.x) {
    const int r = i / CPR, c = (i % CPR) * PER;
    const bool ok = r < valid;
    cp_async16(dst + r * LD<T, DH> + c, src + (ok ? r : 0) * stride + c, ok);
  }
}

// acc[j] += A B^T over KLEN (DH unless given) for one warp: A is 16 rows at
// A, B the rows 8j .. 8j+7 at B, both with the contraction contiguous (row
// stride LD): the score products q k^T, g v^T, k q^T and v g^T. f32 splits
// each A fragment once for all NT columns, and sums the small terms apart
// from the big ones (added at the end): twice the independent mma chains.
template <typename T, int DH, int NT, int KLEN = DH>
__device__ __forceinline__ void scores(const T* A, const T* B, float (&acc)[NT][4]) {
  constexpr int L = LD<T, DH>;
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  if constexpr (is_bf16<T>) {
#pragma unroll 4
    for (int k = 0; k < KLEN; k += 16) {
      const uint32_t a[4] = {ld32(A + g * L + k + 2 * t), ld32(A + (g + 8) * L + k + 2 * t),
                             ld32(A + g * L + k + 8 + 2 * t),
                             ld32(A + (g + 8) * L + k + 8 + 2 * t)};
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const bf16* r = B + (8 * j + g) * L + k + 2 * t;
        const uint32_t b[2] = {ld32(r), ld32(r + 8)};
        mma_bf16(acc[j], a, b);
      }
    }
  } else {
    float lo[NT][4] = {};
#pragma unroll 2
    for (int k = 0; k < KLEN; k += 8) {
      uint32_t ab[4], as[4];
      split(A[g * L + k + t], ab[0], as[0]);
      split(A[(g + 8) * L + k + t], ab[1], as[1]);
      split(A[g * L + k + t + 4], ab[2], as[2]);
      split(A[(g + 8) * L + k + t + 4], ab[3], as[3]);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const float* r = B + (8 * j + g) * L + k + t;
        uint32_t bb[2], bs[2];
        split(r[0], bb[0], bs[0]);
        split(r[4], bb[1], bs[1]);
        mma_tf32(lo[j], as, bb);
        mma_tf32(lo[j], ab, bs);
        mma_tf32(acc[j], ab, bb);
      }
    }
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] += lo[j][e];
  }
}

// acc[j] += P B for one warp: P [16 x 8 KT] f32 in C-fragment registers (p[c]
// holds columns 8c .. 8c+7), B the rows 0 .. 8 KT - 1 at B (row stride LD),
// columns 8j .. 8j+7: p v, ds k, and in the dkdv kernel p^T g, ds^T q. P is
// rounded to bf16 (bf16) or split (f32) here. f32: within each 8 columns the
// contraction order is permuted, A column t being column 2t and column t+4
// column 2t+1, so the C fragment serves as the A fragment with no shuffles and
// B's reads (rows 2t, 2t+1, column g) fall in 32 distinct banks.
template <typename T, int DH, int KT, int NT>
__device__ __forceinline__ void accumulate(const float (&p)[KT][4], const T* B,
                                           float (&acc)[NT][4]) {
  constexpr int L = LD<T, DH>;
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  if constexpr (is_bf16<T>) {
    static_assert(KT % 2 == 0 && NT % 2 == 0, "bf16 takes 16 columns of P, 16 of B at a time");
#pragma unroll
    for (int kk = 0; kk < KT / 2; ++kk) {
      const uint32_t a[4] = {pack(p[2 * kk][0], p[2 * kk][1]), pack(p[2 * kk][2], p[2 * kk][3]),
                             pack(p[2 * kk + 1][0], p[2 * kk + 1][1]),
                             pack(p[2 * kk + 1][2], p[2 * kk + 1][3])};
      // lane i gives row (i % 8) + 8 ((i / 8) % 2) of column block i / 16
      const bf16* row = B + (16 * kk + (lane & 7) + ((lane >> 3) & 1) * 8) * L + (lane >> 4) * 8;
#pragma unroll
      for (int j = 0; j < NT; j += 2) {
        uint32_t r[4];
        ldsm_x4_t(r, row + 8 * j);
        const uint32_t b0[2] = {r[0], r[1]}, b1[2] = {r[2], r[3]};
        mma_bf16(acc[j], a, b0);
        mma_bf16(acc[j + 1], a, b1);
      }
    }
  } else {
#pragma unroll
    for (int kk = 0; kk < KT; ++kk) {
      uint32_t ab[4], as[4];
      split(p[kk][0], ab[0], as[0]);
      split(p[kk][2], ab[1], as[1]);
      split(p[kk][1], ab[2], as[2]);
      split(p[kk][3], ab[3], as[3]);
      const float* r = B + (8 * kk + 2 * t) * L + g;
#pragma unroll
      for (int j = 0; j < NT; ++j) mma3(acc[j], ab, as, r[8 * j], r[8 * j + L]);
    }
  }
}

// One [B, N, H, dh] operand: element (b, n, h, d) at p[b*sb + n*sn + h*sh + d].
template <typename T>
struct Rows {
  const T* p;
  long long sb, sn, sh;
  __device__ __forceinline__ const T* head(int b, int h) const { return p + b * sb + h * sh; }
};

// Write a warp's 16 rows of C fragments, times mul[0] (row g) and mul[1] (row
// g + 8), to row n0 on of the contiguous [B, N, H, DH] out; rows at or beyond N
// are left out.
template <typename T, int DH, int NT>
__device__ __forceinline__ void store_rows(T* out, const float (&acc)[NT][4], const float (&mul)[2],
                                           int b, int n0, int h, int N, int H) {
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int n = n0 + g + 8 * r;
    if (n >= N) continue;
    T* row = out + ((static_cast<size_t>(b) * N + n) * H + h) * DH + 2 * t;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const float x = acc[j][2 * r] * mul[r], y = acc[j][2 * r + 1] * mul[r];
      if constexpr (is_bf16<T>) {
        *reinterpret_cast<__nv_bfloat162*>(row + 8 * j) = __floats2bfloat162_rn(x, y);
      } else {
        *reinterpret_cast<float2*>(row + 8 * j) = make_float2(x, y);
      }
    }
  }
}

// Scale a warp's score tile (columns k0 ..) and mask the columns at or beyond N
// to -inf, so that exp() makes their p zero.
template <int KT>
__device__ __forceinline__ void scale_mask(float (&s)[KT][4], int k0, int N, float scale) {
  const int t = threadIdx.x % 4;
#pragma unroll
  for (int c = 0; c < KT; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      s[c][e] = k0 + 8 * c + 2 * t + (e & 1) < N ? __fmul_rn(s[c][e], scale) : -CUDART_INF_F;
}

// The online softmax's step for a warp's two rows (g, g + 8) over its columns
// of a tile: the running max m takes the tile's, the per-lane partial sums l
// are rescaled and take this tile's exp(s - m), left in s; returns the rescale
// factors.
template <int KT>
__device__ __forceinline__ void online_step(float (&s)[KT][4], float (&m)[2], float (&l)[2],
                                            float (&alpha)[2]) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float mx = -CUDART_INF_F;
#pragma unroll
    for (int c = 0; c < KT; ++c) mx = fmaxf(mx, fmaxf(s[c][2 * r], s[c][2 * r + 1]));
    const float mnew = fmaxf(m[r], quad_max(mx));
    // a warp group that has met no key yet (N <= 32) keeps m = -inf and l = 0
    const float base = mnew == -CUDART_INF_F ? 0.f : mnew;
    alpha[r] = ex(m[r] - base);
    float sum = 0.f;
#pragma unroll
    for (int c = 0; c < KT; ++c)
#pragma unroll
      for (int e = 2 * r; e < 2 * r + 2; ++e) {
        s[c][e] = ex(s[c][e] - base);
        sum += s[c][e];
      }
    l[r] = l[r] * alpha[r] + sum;
    m[r] = mnew;
  }
}

// ---------------------------------------------------------------------------
// Forward: o and the row statistics (max, sum).
// ---------------------------------------------------------------------------

// Two warp groups of 4 share a block's 64 query rows and split each key tile:
// warp w takes rows 16 (w % 4) and the keys of half w / 4. Their partial
// results meet at the end through per-lane slots in shared memory: value i of
// lane slot s at X[i * 128 + s], where a warp pair (w, w + 4) shares slot
// (w % 4) * 32 + lane.
__device__ __forceinline__ int lane_slot() {
  return (threadIdx.x / 32 % 4) * 32 + threadIdx.x % 32;
}

template <int NT>
__device__ __forceinline__ void put(float* X, const float (&acc)[NT][4]) {
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) X[(4 * j + e) * 128 + lane_slot()] = acc[j][e];
}

template <int NT>
__device__ __forceinline__ void add(const float* X, float (&acc)[NT][4]) {
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] += X[(4 * j + e) * 128 + lane_slot()];
}

// The (max, sum) of both groups' keys from each group's own: every warp leaves
// its pair in XS [8][128] and takes group 0's and group 1's, combined in that
// order, so both warps of a pair hold the same bits. Ends with a barrier.
__device__ __forceinline__ void combine_stats(float* XS, float (&m)[2], float (&l)[2]) {
  const int half = threadIdx.x / 128, s = lane_slot();
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    XS[(4 * half + r) * 128 + s] = m[r];
    XS[(4 * half + 2 + r) * 128 + s] = l[r];
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float m0 = XS[r * 128 + s], m1 = XS[(4 + r) * 128 + s];
    const float l0 = XS[(2 + r) * 128 + s], l1 = XS[(6 + r) * 128 + s];
    m[r] = fmaxf(m0, m1);
    l[r] = l0 * ex(m0 - m[r]) + l1 * ex(m1 - m[r]);
  }
  __syncthreads();
}

constexpr int BKF = 64;  // key rows of a forward tile: 32 a warp group

template <typename T, int DH>
constexpr size_t fwd_smem_bytes() {
  return static_cast<size_t>(BQ + 2 * BKF) * LD<T, DH> * sizeof(T) + 8 * 128 * sizeof(float);
}

template <typename T, int DH>
__global__ void __launch_bounds__(256)
mhsa_fwd_kernel(Rows<T> q, Rows<T> k, Rows<T> v, T* __restrict__ o, float* __restrict__ stats,
                int N, int H, float scale) {
  constexpr int L = LD<T, DH>, KT = 4, NT = DH / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  T* Qs = reinterpret_cast<T*>(smem);  // [BQ][L]
  T* Ks = Qs + BQ * L;                 // [BKF][L]
  T* Vs = Ks + BKF * L;                // [BKF][L]
  float* XS = reinterpret_cast<float*>(Vs + BKF * L);  // [8][128] statistics exchange
  float* X = reinterpret_cast<float*>(Ks);             // [4 NT][128] after the loop

  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * BQ, warp = threadIdx.x / 32, half = warp / 4;
  const int n0 = q0 + (warp % 4) * 16, kofs = 32 * half;
  const T* kh = k.head(b, h);
  const T* vh = v.head(b, h);
  const T* Qw = Qs + (warp % 4) * 16 * L;
  const int tiles = (N + BKF - 1) / BKF;

  load_rows<T, DH, BQ>(Qs, q.head(b, h) + q0 * q.sn, q.sn, N - q0);
  load_rows<T, DH, BKF>(Ks, kh, k.sn, N);
  cp_commit();

  float m[2] = {-CUDART_INF_F, -CUDART_INF_F}, l[2] = {0.f, 0.f}, alpha[2];
  if constexpr (is_bf16<T>) {
    // pass 1: the row statistics alone, k's tiles alternating between Ks and Vs
    for (int j = 0; j < tiles; ++j) {
      cp_wait<0>();
      __syncthreads();
      const T* cur = (j & 1) ? Vs : Ks;
      if (j + 1 < tiles)
        load_rows<T, DH, BKF>((j & 1) ? Ks : Vs, kh + (j + 1) * BKF * k.sn, k.sn,
                              N - (j + 1) * BKF);
      cp_commit();
      float s[KT][4] = {};
      scores<T, DH, KT>(Qw, cur + kofs * L, s);
      scale_mask<KT>(s, j * BKF + kofs, N, scale);
      online_step<KT>(s, m, l, alpha);
    }
    l[0] = quad_sum(l[0]);
    l[1] = quad_sum(l[1]);
    cp_wait<0>();
    combine_stats(XS, m, l);  // its barriers also end every warp's reads of Ks and Vs
    load_rows<T, DH, BKF>(Ks, kh, k.sn, N);
    cp_commit();
  }
  load_rows<T, DH, BKF>(Vs, vh, v.sn, N);
  cp_commit();
  const float inv_l[2] = {1.f / l[0], 1.f / l[1]};  // bf16 only

  // pending copy groups at the top of each step: k's tile j, then v's
  float acc[NT][4] = {};
  for (int j = 0; j < tiles; ++j) {
    cp_wait<1>();
    __syncthreads();
    float s[KT][4] = {};
    scores<T, DH, KT>(Qw, Ks + kofs * L, s);
    __syncthreads();  // every warp is done with Ks
    if (j + 1 < tiles)
      load_rows<T, DH, BKF>(Ks, kh + (j + 1) * BKF * k.sn, k.sn, N - (j + 1) * BKF);
    cp_commit();
    scale_mask<KT>(s, j * BKF + kofs, N, scale);
    if constexpr (is_bf16<T>) {
      // p = exp(s - max) / sum, rounded to bf16 where accumulate() packs it
#pragma unroll
      for (int c = 0; c < KT; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[c][e] = ex(s[c][e] - m[e / 2]) * inv_l[e / 2];
    } else {
      online_step<KT>(s, m, l, alpha);
      // rescale only when some row's max grew (a product by 1 changes nothing)
      if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[n][e] *= alpha[e / 2];
      }
    }
    cp_wait<1>();
    __syncthreads();
    accumulate<T, DH, KT, NT>(s, Vs + kofs * L, acc);
    __syncthreads();  // every warp is done with Vs
    if (j + 1 < tiles)
      load_rows<T, DH, BKF>(Vs, vh + (j + 1) * BKF * v.sn, v.sn, N - (j + 1) * BKF);
    cp_commit();
  }
  cp_wait<0>();

  // group 1's partial sums join group 0's, which writes the rows
  float mul[2] = {1.f, 1.f};
  if constexpr (!is_bf16<T>) {
    l[0] = quad_sum(l[0]);
    l[1] = quad_sum(l[1]);
    const float m_own[2] = {m[0], m[1]};
    combine_stats(XS, m, l);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      alpha[r] = ex(m_own[r] - m[r]);  // this group's share of the combined sum
      mul[r] = 1.f / l[r];
    }
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] *= alpha[e / 2];
  }
  if (half == 1) put<NT>(X, acc);
  __syncthreads();
  if (half == 1) return;
  add<NT>(X, acc);
  store_rows<T, DH, NT>(o, acc, mul, b, n0, h, N, H);
  const int lane = threadIdx.x % 32;
  if (lane % 4 == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int n = n0 + lane / 4 + 8 * r;
      if (n < N) {
        float* st = stats + (static_cast<size_t>(bh) * N + n) * 2;
        st[0] = m[r];
        st[1] = l[r];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Backward: delta, then dk, dv and ds, then dq = round(ds) k.
// ---------------------------------------------------------------------------

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// f32: delta = rowsum(g * o), equal to rowsum(dp * p) in real arithmetic
// (g_i . o_i = sum_j p_ij dp_ij), one warp a row.
template <int DH>
__global__ void __launch_bounds__(256)
mhsa_go_kernel(Rows<float> g, const float* __restrict__ o, float* __restrict__ delta, int N,
               int H) {
  const int bh = blockIdx.y, b = bh / H, h = bh % H, lane = threadIdx.x % 32;
  const int n = blockIdx.x * 8 + threadIdx.x / 32;
  if (n >= N) return;
  const float* gr = g.head(b, h) + n * g.sn;
  const float* orow = o + ((static_cast<size_t>(b) * N + n) * H + h) * DH;
  float sum = 0.f;
#pragma unroll
  for (int d = lane; d < DH; d += 32) sum = fmaf(gr[d], orow[d], sum);
  sum = warp_sum(sum);
  if (lane == 0) delta[static_cast<size_t>(bh) * N + n] = sum;
}

template <int DH>
constexpr size_t delta_smem_bytes() {
  return static_cast<size_t>(2 * BQ + 2 * BK) * LD<bf16, DH> * sizeof(bf16) +
         4 * 128 * sizeof(float);
}

// bf16: o was formed from round(p) and is itself rounded, so delta =
// rowsum(dp * p), the TPU kernel's form, for 64 query rows over the key tiles:
// two products. As in the forward, two warp groups split each key tile (16
// keys a warp) and their sums meet at the end.
template <int DH>
__global__ void __launch_bounds__(256)
mhsa_delta_kernel(Rows<bf16> q, Rows<bf16> k, Rows<bf16> v, Rows<bf16> g,
                  const float* __restrict__ stats, float* __restrict__ delta, int N, int H,
                  float scale) {
  using T = bf16;
  constexpr int L = LD<T, DH>, KT = 2;
  extern __shared__ __align__(16) unsigned char smem[];
  T* Qs = reinterpret_cast<T*>(smem);  // [BQ][L]
  T* Gs = Qs + BQ * L;                 // [BQ][L]
  T* Ks = Gs + BQ * L;                 // [BK][L]
  T* Vs = Ks + BK * L;                 // [BK][L]
  float* XS = reinterpret_cast<float*>(Vs + BK * L);  // [4][128]

  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * BQ, warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int half = warp / 4, kofs = 16 * half;
  const int n0 = q0 + (warp % 4) * 16, gi = lane / 4;
  const T* kh = k.head(b, h);
  const T* vh = v.head(b, h);
  const T* Qw = Qs + (warp % 4) * 16 * L;
  const T* Gw = Gs + (warp % 4) * 16 * L;
  const int tiles = (N + BK - 1) / BK;

  load_rows<T, DH, BQ>(Qs, q.head(b, h) + q0 * q.sn, q.sn, N - q0);
  load_rows<T, DH, BQ>(Gs, g.head(b, h) + q0 * g.sn, g.sn, N - q0);
  cp_commit();
  load_rows<T, DH, BK>(Vs, vh, v.sn, N);
  cp_commit();
  load_rows<T, DH, BK>(Ks, kh, k.sn, N);
  cp_commit();

  float m[2], inv_l[2], dl[2] = {0.f, 0.f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int n = n0 + gi + 8 * r;
    const float* st = stats + (static_cast<size_t>(bh) * N + n) * 2;
    m[r] = n < N ? st[0] : 0.f;
    inv_l[r] = n < N ? 1.f / st[1] : 1.f;
  }
  // pending copy groups at the top of each step: v's tile j, then k's
  for (int j = 0; j < tiles; ++j) {
    cp_wait<1>();
    __syncthreads();
    float dp[KT][4] = {};
    scores<T, DH, KT>(Gw, Vs + kofs * L, dp);
    __syncthreads();  // every warp is done with Vs
    if (j + 1 < tiles)
      load_rows<T, DH, BK>(Vs, vh + (j + 1) * BK * v.sn, v.sn, N - (j + 1) * BK);
    cp_commit();
    cp_wait<1>();
    __syncthreads();
    float s[KT][4] = {};
    scores<T, DH, KT>(Qw, Ks + kofs * L, s);
    scale_mask<KT>(s, j * BK + kofs, N, scale);
#pragma unroll
    for (int c = 0; c < KT; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        dl[e / 2] = fmaf(dp[c][e], ex(s[c][e] - m[e / 2]) * inv_l[e / 2], dl[e / 2]);
    __syncthreads();  // every warp is done with Ks
    if (j + 1 < tiles)
      load_rows<T, DH, BK>(Ks, kh + (j + 1) * BK * k.sn, k.sn, N - (j + 1) * BK);
    cp_commit();
  }
  cp_wait<0>();
  const int s = lane_slot();
#pragma unroll
  for (int r = 0; r < 2; ++r) XS[(2 * half + r) * 128 + s] = quad_sum(dl[r]);
  __syncthreads();
  if (half == 0 && lane % 4 == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int n = n0 + gi + 8 * r;
      if (n < N) delta[static_cast<size_t>(bh) * N + n] = XS[r * 128 + s] + XS[(2 + r) * 128 + s];
    }
  }
}

// The C-fragment layout of a warp's 16 x 8 KT tile from a row-major tile in
// shared memory (rows S, S + ld, ...): f32 or bf16 pairs, conflict-free for ld
// = 32 + 8.
template <int KT, typename T>
__device__ __forceinline__ void load_frag(const T* S, int ld, float (&a)[KT][4]) {
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
#pragma unroll
  for (int c = 0; c < KT; ++c)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const T* p = S + (g + 8 * r) * ld + 8 * c + 2 * t;
      float2 x;
      if constexpr (is_bf16<T>) {
        x = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
      } else {
        x = *reinterpret_cast<const float2*>(p);
      }
      a[c][2 * r] = x.x;
      a[c][2 * r + 1] = x.y;
    }
}

template <typename T>
__device__ __forceinline__ float rounded(float x) {
  if constexpr (is_bf16<T>) {
    return __bfloat162float(__float2bfloat16(x));
  } else {
    return x;
  }
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(bf16* p, float v) { *p = __float2bfloat16(v); }

template <typename T, int DH>
constexpr size_t dkdv_smem_bytes() {
  return static_cast<size_t>(2 * BKV + 4 * BQ_KV) * LD<T, DH> * sizeof(T) +
         (4 * static_cast<size_t>(BKV) * LDP + 3 * BQ_KV) * sizeof(float);
}

// dk and dv for 32 key rows, summed in f32 over every query tile of 32 in
// order, and round(ds) for the dq kernel; q's and g's tiles double-buffered,
// the next tile's statistics read a step ahead.
// Step A: the transposed tiles (keys as rows) s^T = k q^T (warps 0-3) and
// dp^T = v g^T (warps 4-7), each warp 16 keys by 32 queries over half of dh,
// the halves summed in the elementwise step, which forms round(p)^T and
// round(ds)^T in shared memory. Step B: warps 0-3 add round(ds)^T q to dk,
// warps 4-7 round(p)^T g to dv, 16 key rows by half of dh each. ds [B*H, N,
// ldn] (query rows, key columns; ldn = N rounded up to 32) gets this block's
// columns, zeros beyond N.
template <typename T, int DH>
__global__ void __launch_bounds__(256)
mhsa_dkdv_kernel(Rows<T> q, Rows<T> k, Rows<T> v, Rows<T> g, const float* __restrict__ stats,
                 const float* __restrict__ delta, T* __restrict__ ds, T* __restrict__ dk,
                 T* __restrict__ dv, int N, int ldn, int H, float scale) {
  constexpr int L = LD<T, DH>, NT = DH / 16, KT = BQ_KV / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  T* Ks = reinterpret_cast<T*>(smem);   // [BKV][L]
  T* Vs = Ks + BKV * L;                 // [BKV][L]
  T* Qs = Vs + BKV * L;                 // [2][BQ_KV][L]
  T* Gs = Qs + 2 * BQ_KV * L;           // [2][BQ_KV][L]
  // [4][BKV][LDP]: s^T and dp^T over each half of dh; the first of each pair
  // then holds round(p)^T and round(ds)^T
  float* Sp = reinterpret_cast<float*>(Gs + 2 * BQ_KV * L);
  float* Ps = Sp;
  float* Ds = Sp + 2 * BKV * LDP;
  float* ms = Sp + 4 * BKV * LDP;  // [BQ_KV] the tile's max,
  float* ils = ms + BQ_KV;         // 1 / sum
  float* dls = ils + BQ_KV;        // and delta

  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int j0 = blockIdx.x * BKV, warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int role = warp / 4, kh = (warp / 2) % 2, rg = warp % 2, gi = lane / 4, t = lane % 4;
  const T* qh = q.head(b, h);
  const T* gh = g.head(b, h);
  const float* st = stats + static_cast<size_t>(bh) * N * 2;
  const float* de = delta + static_cast<size_t>(bh) * N;
  T* dsh = ds + static_cast<size_t>(bh) * N * ldn;
  const int tiles = (N + BQ_KV - 1) / BQ_KV;

  load_rows<T, DH, BKV>(Ks, k.head(b, h) + j0 * k.sn, k.sn, N - j0);
  load_rows<T, DH, BKV>(Vs, v.head(b, h) + j0 * v.sn, v.sn, N - j0);
  load_rows<T, DH, BQ_KV>(Qs, qh, q.sn, N);
  load_rows<T, DH, BQ_KV>(Gs, gh, g.sn, N);
  cp_commit();

  // thread c < BQ_KV reads query c's (max, 1 / sum, delta) of a tile
  float nm = 0.f, nl = 1.f, nd = 0.f;
  auto fetch = [&](int i0) {
    const int c = threadIdx.x;
    if (c < BQ_KV && i0 + c < N) {
      nm = st[(i0 + c) * 2];
      nl = 1.f / st[(i0 + c) * 2 + 1];
      nd = de[i0 + c];
    } else {
      nm = 0.f, nl = 1.f, nd = 0.f;
    }
  };
  fetch(0);
  if (threadIdx.x < BQ_KV) ms[threadIdx.x] = nm, ils[threadIdx.x] = nl, dls[threadIdx.x] = nd;

  float acc[NT][4] = {};  // dk (role 0) or dv (role 1)
  for (int i = 0; i < tiles; ++i) {
    const int i0 = i * BQ_KV, buf = i & 1;
    const T* Qi = Qs + buf * BQ_KV * L;
    const T* Gi = Gs + buf * BQ_KV * L;
    // the next tile into the other buffer, whose readers finished last step
    if (i + 1 < tiles) {
      load_rows<T, DH, BQ_KV>(Qs + (buf ^ 1) * BQ_KV * L, qh + (i0 + BQ_KV) * q.sn, q.sn,
                              N - i0 - BQ_KV);
      load_rows<T, DH, BQ_KV>(Gs + (buf ^ 1) * BQ_KV * L, gh + (i0 + BQ_KV) * g.sn, g.sn,
                              N - i0 - BQ_KV);
      fetch(i0 + BQ_KV);
    }
    cp_commit();
    cp_wait<1>();
    __syncthreads();
    // step A: s^T (role 0) or dp^T (role 1), keys 16 rg .., half kh of dh
    {
      float x[KT][4] = {};
      const int d0 = kh * (DH / 2);
      scores<T, DH, KT, DH / 2>((role ? Vs : Ks) + rg * 16 * L + d0, (role ? Gi : Qi) + d0, x);
      float* out = Sp + (2 * role + kh) * BKV * LDP;
#pragma unroll
      for (int c = 0; c < KT; ++c)
#pragma unroll
        for (int r = 0; r < 2; ++r)
          *reinterpret_cast<float2*>(out + (rg * 16 + gi + 8 * r) * LDP + 8 * c + 2 * t) =
              make_float2(x[c][2 * r], x[c][2 * r + 1]);
    }
    __syncthreads();
    // s, dp: the halves' sum; p = exp(s scale - max) / sum, ds = p (dp - delta)
    // scale; round(p) and round(ds) into Ps and Ds, round(ds) also to ds. A
    // warp takes 4 queries by 8 keys: its stores fill 32-byte sectors, its
    // reads of the tiles meet at most two to a bank.
    for (int idx = threadIdx.x; idx < BKV * BQ_KV; idx += blockDim.x) {
      const int c = (idx & 3) | (((idx >> 5) & 7) << 2);  // query column
      const int r = ((idx >> 2) & 7) | ((idx >> 8) << 3);  // key row
      const int at = r * LDP + c;
      const float x = Ps[at] + Ps[BKV * LDP + at], dp = Ds[at] + Ds[BKV * LDP + at];
      const float p = i0 + c < N ? ex(__fmul_rn(x, scale) - ms[c]) * ils[c] : 0.f;
      const float d = rounded<T>(__fmul_rn(__fmul_rn(p, __fsub_rn(dp, dls[c])), scale));
      Ps[at] = rounded<T>(p);
      Ds[at] = d;
      if (i0 + c < N) store(dsh + static_cast<size_t>(i0 + c) * ldn + j0 + r, j0 + r < N ? d : 0.f);
    }
    __syncthreads();
    // step B: dk += round(ds)^T q, dv += round(p)^T g; half kh of dh
    float a[KT][4];
    load_frag<KT>((role ? Ps : Ds) + rg * 16 * LDP, LDP, a);
    accumulate<T, DH, KT, NT>(a, (role ? Gi : Qi) + kh * (DH / 2), acc);
    __syncthreads();  // every warp is done with this buffer, Sp and the statistics
    if (threadIdx.x < BQ_KV) ms[threadIdx.x] = nm, ils[threadIdx.x] = nl, dls[threadIdx.x] = nd;
  }
  cp_wait<0>();
  const float one[2] = {1.f, 1.f};
  store_rows<T, DH, NT>((role ? dv : dk) + kh * (DH / 2), acc, one, b, j0 + rg * 16, h, N, H);
}

constexpr int LDA = BK + 8;  // a ds tile's row in shared memory

template <typename T, int DH>
constexpr size_t dq_smem_bytes() {
  return 2 * static_cast<size_t>(BQ * LDA + BK * LD<T, DH>) * sizeof(T);
}

// dq = round(ds) k for 64 query rows: warp w adds rows 16 (w % 4) by half w / 4
// of dh over the key tiles of 32, the ds and k tiles double-buffered.
template <typename T, int DH>
__global__ void __launch_bounds__(256)
mhsa_dq_kernel(Rows<T> k, const T* __restrict__ ds, T* __restrict__ dq, int N, int ldn, int H) {
  constexpr int L = LD<T, DH>, KT = BK / 8, NT = DH / 16, PER = 16 / sizeof(T);
  extern __shared__ __align__(16) unsigned char smem[];
  T* As = reinterpret_cast<T*>(smem);  // [2][BQ][LDA]
  T* Ks = As + 2 * BQ * LDA;           // [2][BK][L]

  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * BQ, warp = threadIdx.x / 32, half = warp / 4;
  const T* dsh = ds + (static_cast<size_t>(bh) * N + q0) * ldn;
  const T* kh = k.head(b, h);
  const int tiles = (N + BK - 1) / BK, rows = N - q0;

  auto load = [&](int j, int buf) {
    T* A = As + buf * BQ * LDA;
    for (int i = threadIdx.x; i < BQ * BK / PER; i += blockDim.x) {
      const int r = i / (BK / PER), c = (i % (BK / PER)) * PER;
      const bool ok = r < rows;
      cp_async16(A + r * LDA + c, dsh + static_cast<size_t>(ok ? r : 0) * ldn + j * BK + c, ok);
    }
    load_rows<T, DH, BK>(Ks + buf * BK * L, kh + j * BK * k.sn, k.sn, N - j * BK);
    cp_commit();
  };
  load(0, 0);
  float acc[NT][4] = {};
  for (int j = 0; j < tiles; ++j) {
    if (j + 1 < tiles) {
      load(j + 1, (j + 1) & 1);
    } else {
      cp_commit();
    }
    cp_wait<1>();
    __syncthreads();
    float a[KT][4];
    load_frag<KT>(As + (j & 1) * BQ * LDA + (warp % 4) * 16 * LDA, LDA, a);
    accumulate<T, DH, KT, NT>(a, Ks + (j & 1) * BK * L + half * (DH / 2), acc);
    __syncthreads();  // every warp is done with buffer j & 1 before it is refilled
  }
  cp_wait<0>();
  const float one[2] = {1.f, 1.f};
  store_rows<T, DH, NT>(dq + half * (DH / 2), acc, one, b, q0 + (warp % 4) * 16, h, N, H);
}

#define S3F_TRY(expr)                     \
  do {                                    \
    const cudaError_t err_ = (expr);      \
    if (err_ != cudaSuccess) return err_; \
  } while (0)

template <typename T>
Rows<T> rows(const void* p, const long long* s) {
  return Rows<T>{static_cast<const T*>(p), s[0], s[1], s[2]};
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <typename T, int DH>
cudaError_t forward(const void* q, const void* k, const void* v, const long long* strides,
                    void* o, float* stats, int B, int N, int H, float scale, cudaStream_t stream) {
  constexpr size_t smem = fwd_smem_bytes<T, DH>();
  S3F_TRY(allow_smem(mhsa_fwd_kernel<T, DH>, smem));
  const dim3 grid((N + BQ - 1) / BQ, B * H);
  mhsa_fwd_kernel<T, DH><<<grid, 256, smem, stream>>>(
      rows<T>(q, strides), rows<T>(k, strides + 3), rows<T>(v, strides + 6), static_cast<T*>(o),
      stats, N, H, scale);
  return cudaGetLastError();
}

template <typename T, int DH>
cudaError_t backward(const void* q, const void* k, const void* v, const void* g, const void* o,
                     const long long* strides, const float* stats, float* delta, void* ds,
                     void* dq, void* dk, void* dv, int B, int N, int H, float scale,
                     cudaStream_t stream) {
  const Rows<T> rq = rows<T>(q, strides), rk = rows<T>(k, strides + 3),
                rv = rows<T>(v, strides + 6), rg = rows<T>(g, strides + 9);
  const int ldn = (N + BK - 1) / BK * BK;
  if constexpr (is_bf16<T>) {
    constexpr size_t smem = delta_smem_bytes<DH>();
    S3F_TRY(allow_smem(mhsa_delta_kernel<DH>, smem));
    mhsa_delta_kernel<DH><<<dim3((N + BQ - 1) / BQ, B * H), 256, smem, stream>>>(
        rq, rk, rv, rg, stats, delta, N, H, scale);
  } else {
    mhsa_go_kernel<DH><<<dim3((N + 7) / 8, B * H), 256, 0, stream>>>(
        rg, static_cast<const float*>(o), delta, N, H);
  }
  S3F_TRY(cudaGetLastError());
  constexpr size_t smem_kv = dkdv_smem_bytes<T, DH>();
  S3F_TRY(allow_smem(mhsa_dkdv_kernel<T, DH>, smem_kv));
  mhsa_dkdv_kernel<T, DH><<<dim3((N + BKV - 1) / BKV, B * H), 256, smem_kv, stream>>>(
      rq, rk, rv, rg, stats, delta, static_cast<T*>(ds), static_cast<T*>(dk),
      static_cast<T*>(dv), N, ldn, H, scale);
  S3F_TRY(cudaGetLastError());
  constexpr size_t smem_dq = dq_smem_bytes<T, DH>();
  S3F_TRY(allow_smem(mhsa_dq_kernel<T, DH>, smem_dq));
  mhsa_dq_kernel<T, DH><<<dim3((N + BQ - 1) / BQ, B * H), 256, smem_dq, stream>>>(
      rk, static_cast<const T*>(ds), static_cast<T*>(dq), N, ldn, H);
  return cudaGetLastError();
}

template <typename T>
cudaError_t forward_dh(int dh, const void* q, const void* k, const void* v,
                       const long long* strides, void* o, float* stats, int B, int N, int H,
                       float scale, cudaStream_t stream) {
  switch (dh) {
    case 64: return forward<T, 64>(q, k, v, strides, o, stats, B, N, H, scale, stream);
    case 128: return forward<T, 128>(q, k, v, strides, o, stats, B, N, H, scale, stream);
    case 192: return forward<T, 192>(q, k, v, strides, o, stats, B, N, H, scale, stream);
    case 256: return forward<T, 256>(q, k, v, strides, o, stats, B, N, H, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t backward_dh(int dh, const void* q, const void* k, const void* v, const void* g,
                        const void* o, const long long* strides, const float* stats,
                        float* delta, void* ds, void* dq, void* dk, void* dv, int B, int N,
                        int H, float scale, cudaStream_t stream) {
#define S3F_BWD(D) \
  backward<T, D>(q, k, v, g, o, strides, stats, delta, ds, dq, dk, dv, B, N, H, scale, stream)
  switch (dh) {
    case 64: return S3F_BWD(64);
    case 128: return S3F_BWD(128);
    case 192: return S3F_BWD(192);
    case 256: return S3F_BWD(256);
    default: return cudaErrorInvalidValue;
  }
#undef S3F_BWD
}

}  // namespace

extern "C" {

// q, k, v: [B, N, H, dh] of f32 (bf16 = 0) or bf16 (bf16 = 1), read through
// strides[9] = (sample, token, head) element strides of q, k, v, the head_dim
// stride being 1; each pointer and each stride's bytes a multiple of 16. o:
// contiguous [B, N, H, dh] of the same type; stats: [B*H, N, 2] f32 (row max,
// row sum). 1 <= N; dh in {64, 128, 192, 256}.
int s3f_mhsa_fwd(const void* q, const void* k, const void* v, const long long* strides, void* o,
                 float* stats, int B, int N, int H, int dh, int bf16, float scale,
                 cudaStream_t stream) {
  return bf16 ? forward_dh<__nv_bfloat16>(dh, q, k, v, strides, o, stats, B, N, H, scale, stream)
              : forward_dh<float>(dh, q, k, v, strides, o, stats, B, N, H, scale, stream);
}

// g: the gradient of o, read through strides[9..11] under the same alignment;
// o and stats from s3f_mhsa_fwd (o read in f32 only); delta: scratch [B*H, N]
// f32; ds: scratch [B*H, N, ldn] of q's type, ldn = N rounded up to 32; dq, dk,
// dv: contiguous [B, N, H, dh] of q's type.
int s3f_mhsa_bwd(const void* q, const void* k, const void* v, const void* g, const void* o,
                 const long long* strides, const float* stats, float* delta, void* ds, void* dq,
                 void* dk, void* dv, int B, int N, int H, int dh, int bf16, float scale,
                 cudaStream_t stream) {
  return bf16 ? backward_dh<__nv_bfloat16>(dh, q, k, v, g, o, strides, stats, delta, ds, dq, dk,
                                           dv, B, N, H, scale, stream)
              : backward_dh<float>(dh, q, k, v, g, o, strides, stats, delta, ds, dq, dk, dv, B,
                                   N, H, scale, stream);
}

}  // extern "C"
