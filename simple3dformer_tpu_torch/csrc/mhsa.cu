// Multi-head self-attention, forward and backward, for Hopper (sm_90a), plain C
// interface.
//
// Replaces the TPU kernels of simple3dformer_tpu/kernels/mhsa.py: the forward
// (_fwd_kernel :69 over _probs :57, pallas_call :120) and the backward
// (_bwd_kernel :74, pallas_call :144). Per (sample, head), on rows of q, k, v,
// g [N, dh]:
//
//   s = (q k^T) * scale                     f32
//   p = exp(s - rowmax(s)) / rowsum(...)     f32, normalised exactly
//   o = round(p) v                           round() = to the input dtype
//   dv = round(p)^T g;  dp = g v^T;  ds = p * (dp - rowsum(dp * p)) * scale
//   dq = round(ds) k;   dk = round(ds)^T q   every product summed in f32
//
// The TPU kernel holds a whole (sample, head) row of k and v in VMEM (1 MB in
// f32 at N = 1025, dh = 256) and carries dk, dv across a sequential grid axis.
// A Hopper block has 227 KB of shared memory and blocks run in no order, so
// here k, v, q and g stream through shared memory in tiles, and the sums that
// cross tiles are owned by one block each:
//
//   mhsa_fwd_kernel   one block per (sample*head, 64 query rows). Two passes
//                     over the key tiles: the first finds each row's max and
//                     sum (online, the sum rescaled when the max grows), the
//                     second recomputes the scores, forms p = exp(s - max) / sum,
//                     rounds it to the input dtype and adds p v. This gives the
//                     TPU kernel's normalised-then-rounded p; a one-pass
//                     (flash-style) kernel would round p differently in bf16.
//                     The row (max, sum) pairs go to `stats` [B*H, N, 2] f32 for
//                     the backward.
//   mhsa_dq_kernel    one block per (sample*head, 64 query rows): a sweep over
//                     the key tiles for delta = rowsum(dp * p), the TPU kernel's
//                     form (not rowsum(g * o)), then a second sweep for ds and
//                     dq. delta goes to scratch [B*H, N] f32.
//   mhsa_dkdv_kernel  one block per (sample*head, 32 key rows), looping over all
//                     query tiles in order and keeping dk, dv in f32 registers.
//                     No float atomics: two runs give the same bits.
//
// N runs from 1 up with no padding: loads beyond N read zeros and the score
// columns beyond N are left out of every sum (the TPU's pad-to-128 and -1e30
// mask). q, k, v and g are read in place through their (sample, token, head)
// strides, so the views of one packed qkv projection need no copies; o, dq, dk
// and dv are written contiguous [B, N, H, dh], o ready for the output
// projection as [B, N, H*dh].
//
// What bounds it: the products. At the S3DIS shape (B=4, N=1025, H=3, dh=256,
// f32) the forward's two products are 12.9 GFLOP against 50 MB moved, so the
// operation count bounds it on this card, not bytes. This first port runs every
// product as f32 FMA from shared-memory tiles (a 16 x 16 thread grid, 4 x 4
// outputs a thread, float4 reads): the forward computes the scores twice and
// the backward nine tile products where the TPU kernel has five. bf16 tensor
// cores (wgmma) and TMA are later work.
//
// Every entry returns the first CUDA error of its launches (0 on success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <type_traits>

namespace {

constexpr int THREADS = 256;  // a 16 x 16 grid: rows ty + 16 i, columns tx + 16 j
constexpr int TQ = 64;        // query rows of a forward or dq block
constexpr int TK = 64;        // score-tile columns (keys, or queries in dkdv)
constexpr int TKV = 32;       // key rows of a dkdv block
constexpr int KC = 32;        // contraction chunk staged in shared memory
constexpr int LDC = KC + 4;   // staged row: 16-byte aligned, conflict-free float4 reads
constexpr int LDT = TK + 4;   // a score tile's row in shared memory

__device__ __forceinline__ float load(const float* p) { return *p; }
__device__ __forceinline__ float load(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// a value rounded to T, as the TPU kernel's astype(dtype) before a product
template <typename T>
__device__ __forceinline__ float operand(float v) {
  if constexpr (std::is_same_v<T, __nv_bfloat16>) {
    return __bfloat162float(__float2bfloat16(v));
  } else {
    return v;
  }
}

// sum and max over the 16 threads of one row (tx = lane % 16)
__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float row_max(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// One [B, N, H, dh] operand: element (b, n, h, d) at p[b*sb + n*sn + h*sh + d].
template <typename T>
struct Rows {
  const T* p;
  long long sb, sn, sh;
  __device__ __forceinline__ const T* head(int b, int h) const { return p + b * sb + h * sh; }
};

// acc[i][j] += sum_k A[ty + 16 i][k] * B[tx + 16 j][k] for k < K (K % 4 == 0):
// A and B in shared memory with the contraction contiguous; the k order is
// sequential, one fmaf at a time.
template <int RA, int CB>
__device__ __forceinline__ void mac(const float* A, int lda, const float* B, int ldb, int K,
                                    float (&acc)[RA][CB]) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  for (int k = 0; k < K; k += 4) {
    float4 a[RA];
#pragma unroll
    for (int i = 0; i < RA; ++i)
      a[i] = *reinterpret_cast<const float4*>(A + (ty + 16 * i) * lda + k);
#pragma unroll
    for (int j = 0; j < CB; ++j) {
      const float4 b = *reinterpret_cast<const float4*>(B + (tx + 16 * j) * ldb + k);
#pragma unroll
      for (int i = 0; i < RA; ++i) {
        float s = acc[i][j];
        s = fmaf(a[i].x, b.x, s);
        s = fmaf(a[i].y, b.y, s);
        s = fmaf(a[i].z, b.z, s);
        s = fmaf(a[i].w, b.w, s);
        acc[i][j] = s;
      }
    }
  }
}

// acc[i][j] += sum_d A[a0 + ty + 16 i][d] * B[b0 + tx + 16 j][d] over d < DH:
// a [16 RA x DH] by [64 x DH]^T tile product with both operands read from
// device memory row by row (rows at or beyond na / nb read as zero) and staged
// KC columns at a time in As [16 RA][LDC] and Bs [64][LDC]. Starts with a
// barrier, so the caller's earlier readers of the staging buffers are done.
template <typename T, int RA, int DH>
__device__ __forceinline__ void rows_product(const T* A, long long lda, int na, const T* B,
                                             long long ldb, int nb, float* As, float* Bs,
                                             float (&acc)[RA][4]) {
  constexpr int MR = 16 * RA;
  for (int d0 = 0; d0 < DH; d0 += KC) {
    __syncthreads();
    for (int idx = threadIdx.x; idx < MR * KC; idx += THREADS) {
      const int r = idx / KC, k = idx % KC;
      As[r * LDC + k] = r < na ? load(A + r * lda + d0 + k) : 0.f;
    }
    for (int idx = threadIdx.x; idx < TK * KC; idx += THREADS) {
      const int r = idx / KC, k = idx % KC;
      Bs[r * LDC + k] = r < nb ? load(B + r * ldb + d0 + k) : 0.f;
    }
    __syncthreads();
    mac<RA, 4>(As, LDC, Bs, LDC, KC, acc);
  }
}

// Stage rows r0 .. r0+KC-1 of X (rows at or beyond n read as zero) transposed:
// Bs[d][kk] = X[r0 + kk][d], d < DH. Barriers on both sides.
template <typename T, int DH>
__device__ __forceinline__ void stage_transposed(const T* X, long long ldx, int r0, int n,
                                                 float* Bs) {
  __syncthreads();
  for (int idx = threadIdx.x; idx < KC * DH; idx += THREADS) {
    const int kk = idx / DH, d = idx % DH;
    const int r = r0 + kk;
    Bs[d * LDC + kk] = r < n ? load(X + r * ldx + d) : 0.f;
  }
  __syncthreads();
}

template <int DH>
constexpr size_t stage_floats(int rows) {
  return static_cast<size_t>(rows) * LDC + static_cast<size_t>(DH > TK ? DH : TK) * LDC;
}

// ---------------------------------------------------------------------------
// Forward: o and the row statistics (max, sum).
// ---------------------------------------------------------------------------

template <int DH>
constexpr size_t fwd_smem_bytes() {
  return (stage_floats<DH>(TQ) + static_cast<size_t>(TQ) * LDT) * sizeof(float);
}

template <typename T, int DH>
__global__ void __launch_bounds__(THREADS)
mhsa_fwd_kernel(Rows<T> q, Rows<T> k, Rows<T> v, T* __restrict__ o, float* __restrict__ stats,
                int N, int H, float scale) {
  constexpr int CD = DH / 16;
  extern __shared__ __align__(16) float smem[];
  float* As = smem;                      // [TQ][LDC]
  float* Bs = As + TQ * LDC;             // [max(TK, DH)][LDC]
  float* Ps = Bs + (DH > TK ? DH : TK) * LDC;  // [TQ][LDT]

  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * TQ, nq = min(TQ, N - q0);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const T* qh = q.head(b, h) + q0 * q.sn;
  const T* kh = k.head(b, h);
  const T* vh = v.head(b, h);

  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -CUDART_INF_F;
    l[i] = 0.f;
  }
  // pass 1: row max and sum
  for (int k0 = 0; k0 < N; k0 += TK) {
    const int nk = min(TK, N - k0);
    float s[4][4] = {};
    rows_product<T, 4, DH>(qh, q.sn, nq, kh + k0 * k.sn, k.sn, nk, As, Bs, s);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = -CUDART_INF_F;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = __fmul_rn(s[i][j], scale);
        if (tx + 16 * j < nk) mx = fmaxf(mx, s[i][j]);
      }
      const float mnew = fmaxf(m[i], row_max(mx));
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (tx + 16 * j < nk) sum += expf(__fsub_rn(s[i][j], mnew));
      l[i] = l[i] * expf(__fsub_rn(m[i], mnew)) + row_sum(sum);
      m[i] = mnew;
    }
  }

  // pass 2: p = exp(s - max) / sum rounded to T, o += p v
  float acc[4][CD] = {};
  for (int k0 = 0; k0 < N; k0 += TK) {
    const int nk = min(TK, N - k0);
    float s[4][4] = {};
    rows_product<T, 4, DH>(qh, q.sn, nq, kh + k0 * k.sn, k.sn, nk, As, Bs, s);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const float p = expf(__fsub_rn(__fmul_rn(s[i][j], scale), m[i])) / l[i];
        Ps[(ty + 16 * i) * LDT + c] = c < nk ? operand<T>(p) : 0.f;
      }
    for (int c0 = 0; c0 < TK; c0 += KC) {
      stage_transposed<T, DH>(vh, v.sn, k0 + c0, N, Bs);
      mac<4, CD>(Ps + c0, LDT, Bs, LDC, KC, acc);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    if (r >= nq) continue;
    const size_t row = (static_cast<size_t>(b) * N + q0 + r) * H + h;
#pragma unroll
    for (int j = 0; j < CD; ++j) store(o + row * DH + tx + 16 * j, acc[i][j]);
    if (tx == 0) {
      float* st = stats + (static_cast<size_t>(bh) * N + q0 + r) * 2;
      st[0] = m[i];
      st[1] = l[i];
    }
  }
}

// ---------------------------------------------------------------------------
// Backward.
// ---------------------------------------------------------------------------

template <int DH>
constexpr size_t dq_smem_bytes() {
  return (stage_floats<DH>(TQ) + static_cast<size_t>(TQ) * LDT) * sizeof(float);
}

// dq and delta = rowsum(dp * p) for 64 query rows.
template <typename T, int DH>
__global__ void __launch_bounds__(THREADS)
mhsa_dq_kernel(Rows<T> q, Rows<T> k, Rows<T> v, Rows<T> g, const float* __restrict__ stats,
               float* __restrict__ delta, T* __restrict__ dq, int N, int H, float scale) {
  constexpr int CD = DH / 16;
  extern __shared__ __align__(16) float smem[];
  float* As = smem;
  float* Bs = As + TQ * LDC;
  float* Ps = Bs + (DH > TK ? DH : TK) * LDC;

  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * TQ, nq = min(TQ, N - q0);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const T* qh = q.head(b, h) + q0 * q.sn;
  const T* gh = g.head(b, h) + q0 * g.sn;
  const T* kh = k.head(b, h);
  const T* vh = v.head(b, h);

  float m[4], l[4], dl[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    const float* st = stats + (static_cast<size_t>(bh) * N + q0 + r) * 2;
    m[i] = r < nq ? st[0] : 0.f;
    l[i] = r < nq ? st[1] : 1.f;
    dl[i] = 0.f;
  }

  // sweep 1: delta
  for (int k0 = 0; k0 < N; k0 += TK) {
    const int nk = min(TK, N - k0);
    float s[4][4] = {}, dp[4][4] = {};
    rows_product<T, 4, DH>(qh, q.sn, nq, kh + k0 * k.sn, k.sn, nk, As, Bs, s);
    rows_product<T, 4, DH>(gh, g.sn, nq, vh + k0 * v.sn, v.sn, nk, As, Bs, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (tx + 16 * j < nk) {
          const float p = expf(__fsub_rn(__fmul_rn(s[i][j], scale), m[i])) / l[i];
          dl[i] = fmaf(dp[i][j], p, dl[i]);
        }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) dl[i] = row_sum(dl[i]);

  // sweep 2: ds = p (dp - delta) scale rounded to T, dq += ds k
  float acc[4][CD] = {};
  for (int k0 = 0; k0 < N; k0 += TK) {
    const int nk = min(TK, N - k0);
    float s[4][4] = {}, dp[4][4] = {};
    rows_product<T, 4, DH>(qh, q.sn, nq, kh + k0 * k.sn, k.sn, nk, As, Bs, s);
    rows_product<T, 4, DH>(gh, g.sn, nq, vh + k0 * v.sn, v.sn, nk, As, Bs, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const float p = expf(__fsub_rn(__fmul_rn(s[i][j], scale), m[i])) / l[i];
        const float ds = __fmul_rn(__fmul_rn(p, __fsub_rn(dp[i][j], dl[i])), scale);
        Ps[(ty + 16 * i) * LDT + c] = c < nk ? operand<T>(ds) : 0.f;
      }
    for (int c0 = 0; c0 < TK; c0 += KC) {
      stage_transposed<T, DH>(kh, k.sn, k0 + c0, N, Bs);
      mac<4, CD>(Ps + c0, LDT, Bs, LDC, KC, acc);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    if (r >= nq) continue;
    const size_t row = (static_cast<size_t>(b) * N + q0 + r) * H + h;
#pragma unroll
    for (int j = 0; j < CD; ++j) store(dq + row * DH + tx + 16 * j, acc[i][j]);
    if (tx == 0) delta[static_cast<size_t>(bh) * N + q0 + r] = dl[i];
  }
}

template <int DH>
constexpr size_t dkdv_smem_bytes() {
  return (stage_floats<DH>(TKV) + 2 * static_cast<size_t>(TKV) * LDT + 3 * TK) * sizeof(float);
}

// dk and dv for 32 key rows, summed in f32 over every query tile in order.
// Here the score tile is transposed: rows are keys, columns queries.
template <typename T, int DH>
__global__ void __launch_bounds__(THREADS)
mhsa_dkdv_kernel(Rows<T> q, Rows<T> k, Rows<T> v, Rows<T> g, const float* __restrict__ stats,
                 const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv, int N,
                 int H, float scale) {
  constexpr int CD = DH / 16;
  extern __shared__ __align__(16) float smem[];
  float* As = smem;                                // [TKV][LDC]
  float* Bs = As + TKV * LDC;                      // [max(TK, DH)][LDC]
  float* Ps = Bs + (DH > TK ? DH : TK) * LDC;      // [TKV][LDT]  round(p)^T
  float* Ds = Ps + TKV * LDT;                      // [TKV][LDT]  round(ds)^T
  float* ms = Ds + TKV * LDT;                      // [TK] the query tile's max, sum, delta
  float* ls = ms + TK;
  float* dls = ls + TK;

  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int j0 = blockIdx.x * TKV, nj = min(TKV, N - j0);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const T* qh = q.head(b, h);
  const T* gh = g.head(b, h);
  const T* kh = k.head(b, h) + j0 * k.sn;
  const T* vh = v.head(b, h) + j0 * v.sn;
  const float* st = stats + static_cast<size_t>(bh) * N * 2;
  const float* de = delta + static_cast<size_t>(bh) * N;

  float acc_k[2][CD] = {}, acc_v[2][CD] = {};
  for (int q0 = 0; q0 < N; q0 += TK) {
    const int nq = min(TK, N - q0);
    __syncthreads();  // the previous tile's readers of ms, ls, dls are done
    for (int c = threadIdx.x; c < TK; c += THREADS) {
      ms[c] = c < nq ? st[(q0 + c) * 2] : 0.f;
      ls[c] = c < nq ? st[(q0 + c) * 2 + 1] : 1.f;
      dls[c] = c < nq ? de[q0 + c] : 0.f;
    }
    float s[2][4] = {}, dp[2][4] = {};
    rows_product<T, 2, DH>(kh, k.sn, nj, qh + q0 * q.sn, q.sn, nq, As, Bs, s);
    rows_product<T, 2, DH>(vh, v.sn, nj, gh + q0 * g.sn, g.sn, nq, As, Bs, dp);
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const float p = expf(__fsub_rn(__fmul_rn(s[i][j], scale), ms[c])) / ls[c];
        const float ds = __fmul_rn(__fmul_rn(p, __fsub_rn(dp[i][j], dls[c])), scale);
        Ps[(ty + 16 * i) * LDT + c] = c < nq ? operand<T>(p) : 0.f;
        Ds[(ty + 16 * i) * LDT + c] = c < nq ? operand<T>(ds) : 0.f;
      }
    for (int c0 = 0; c0 < TK; c0 += KC) {
      stage_transposed<T, DH>(gh, g.sn, q0 + c0, N, Bs);
      mac<2, CD>(Ps + c0, LDT, Bs, LDC, KC, acc_v);
      stage_transposed<T, DH>(qh, q.sn, q0 + c0, N, Bs);
      mac<2, CD>(Ds + c0, LDT, Bs, LDC, KC, acc_k);
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = ty + 16 * i;
    if (r >= nj) continue;
    const size_t row = (static_cast<size_t>(b) * N + j0 + r) * H + h;
#pragma unroll
    for (int j = 0; j < CD; ++j) {
      store(dk + row * DH + tx + 16 * j, acc_k[i][j]);
      store(dv + row * DH + tx + 16 * j, acc_v[i][j]);
    }
  }
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

template <typename T, int DH>
cudaError_t forward(const void* q, const void* k, const void* v, const long long* strides,
                    void* o, float* stats, int B, int N, int H, float scale, cudaStream_t stream) {
  constexpr size_t smem = fwd_smem_bytes<DH>();
  S3F_TRY((cudaFuncSetAttribute(mhsa_fwd_kernel<T, DH>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                static_cast<int>(smem))));
  const dim3 grid((N + TQ - 1) / TQ, B * H);
  mhsa_fwd_kernel<T, DH><<<grid, THREADS, smem, stream>>>(
      rows<T>(q, strides), rows<T>(k, strides + 3), rows<T>(v, strides + 6), static_cast<T*>(o),
      stats, N, H, scale);
  return cudaGetLastError();
}

template <typename T, int DH>
cudaError_t backward(const void* q, const void* k, const void* v, const void* g,
                     const long long* strides, const float* stats, float* delta, void* dq,
                     void* dk, void* dv, int B, int N, int H, float scale, cudaStream_t stream) {
  const Rows<T> rq = rows<T>(q, strides), rk = rows<T>(k, strides + 3),
                rv = rows<T>(v, strides + 6), rg = rows<T>(g, strides + 9);
  constexpr size_t smem_dq = dq_smem_bytes<DH>();
  S3F_TRY((cudaFuncSetAttribute(mhsa_dq_kernel<T, DH>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                static_cast<int>(smem_dq))));
  mhsa_dq_kernel<T, DH><<<dim3((N + TQ - 1) / TQ, B * H), THREADS, smem_dq, stream>>>(
      rq, rk, rv, rg, stats, delta, static_cast<T*>(dq), N, H, scale);
  S3F_TRY(cudaGetLastError());
  constexpr size_t smem_kv = dkdv_smem_bytes<DH>();
  S3F_TRY((cudaFuncSetAttribute(mhsa_dkdv_kernel<T, DH>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                static_cast<int>(smem_kv))));
  mhsa_dkdv_kernel<T, DH><<<dim3((N + TKV - 1) / TKV, B * H), THREADS, smem_kv, stream>>>(
      rq, rk, rv, rg, stats, delta, static_cast<T*>(dk), static_cast<T*>(dv), N, H, scale);
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
                        const long long* strides, const float* stats, float* delta, void* dq,
                        void* dk, void* dv, int B, int N, int H, float scale,
                        cudaStream_t stream) {
  switch (dh) {
    case 64:
      return backward<T, 64>(q, k, v, g, strides, stats, delta, dq, dk, dv, B, N, H, scale, stream);
    case 128:
      return backward<T, 128>(q, k, v, g, strides, stats, delta, dq, dk, dv, B, N, H, scale,
                              stream);
    case 192:
      return backward<T, 192>(q, k, v, g, strides, stats, delta, dq, dk, dv, B, N, H, scale,
                              stream);
    case 256:
      return backward<T, 256>(q, k, v, g, strides, stats, delta, dq, dk, dv, B, N, H, scale,
                              stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// q, k, v: [B, N, H, dh] of f32 (bf16 = 0) or bf16 (bf16 = 1), read through
// strides[9] = (sample, token, head) element strides of q, k, v, the head_dim
// stride being 1. o: contiguous [B, N, H, dh] of the same type; stats: [B*H,
// N, 2] f32 (row max, row sum). 1 <= N; dh in {64, 128, 192, 256}.
int s3f_mhsa_fwd(const void* q, const void* k, const void* v, const long long* strides, void* o,
                 float* stats, int B, int N, int H, int dh, int bf16, float scale,
                 cudaStream_t stream) {
  return bf16 ? forward_dh<__nv_bfloat16>(dh, q, k, v, strides, o, stats, B, N, H, scale, stream)
              : forward_dh<float>(dh, q, k, v, strides, o, stats, B, N, H, scale, stream);
}

// g: the gradient of o, read through strides[9..11]; stats from s3f_mhsa_fwd;
// delta: scratch [B*H, N] f32; dq, dk, dv: contiguous [B, N, H, dh] of q's type.
int s3f_mhsa_bwd(const void* q, const void* k, const void* v, const void* g,
                 const long long* strides, const float* stats, float* delta, void* dq, void* dk,
                 void* dv, int B, int N, int H, int dh, int bf16, float scale,
                 cudaStream_t stream) {
  return bf16 ? backward_dh<__nv_bfloat16>(dh, q, k, v, g, strides, stats, delta, dq, dk, dv, B,
                                           N, H, scale, stream)
              : backward_dh<float>(dh, q, k, v, g, strides, stats, delta, dq, dk, dv, B, N, H,
                                   scale, stream);
}

}  // extern "C"
