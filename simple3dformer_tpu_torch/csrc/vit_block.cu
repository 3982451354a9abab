// Fused pre-norm ViT block, forward and backward, for Hopper (sm_90a), plain C
// interface.
//
//   h = x + proj(MHA(LN1(x)))      qkv = LN1(x) Wqkv^T + bqkv
//   y = h + fc2(gelu_tanh(fc1(LN2(h))))
//
// Forward: a chain of five launches from one entry point:
//   1. gemm<LN, BIAS>        qkv = LN1(x) Wqkv^T + bqkv             -> f32 [M, 3D]
//   2. attention<DH>         one block per (query tile, head, sample) -> f32 [M, D]
//   3. gemm<-, BIAS_RES>     h = x + (o Wproj^T + bproj)             -> f32 [M, D]
//   4. gemm<LN, BIAS_GELU>   g = gelu_tanh(LN2(h) W1^T + b1)          -> f32 [M, 4D]
//   5. gemm<-, BIAS_RES>     y = h + (g W2^T + b2)                   -> x.dtype [M, D]
// The training forward is the same chain that also keeps a1 = LN2(h) W1^T + b1
// (fc1 before GELU) and the softmax probabilities [B, H, N, N].
//
// Backward from those residuals (the TPU kernel's _bwd_kernel_res): LayerNorm
// statistics are re-derived from x and h1, then each product of the chain
// runs as a grad_gemm (dX = dY W, and dW = dY^T X summed over the M token
// rows in one block per output tile), the attention backward runs per (tile,
// head, sample) in two passes (query rows, then key rows), and bias and
// LayerNorm gradients are column sums in a fixed order. No float atomics: two
// runs give the same bits. The recompute backward runs the training forward
// into scratch first and then the same backward.
//
// M = B*N token rows. Weights are f32 in nn.Linear layout [out, in]; LayerNorm
// statistics, softmax, GELU, residuals and every sum are f32. Matmul operands
// are rounded to bf16 (round to nearest even) when the compute dtype is bf16,
// and products accumulate in f32 FMA (no TF32, no tensor cores).
//
// Every entry returns the first CUDA error of its launches (0 on success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <algorithm>
#include <cstddef>
#include <cstdint>
#include <type_traits>

namespace {

constexpr float kEps = 1e-6f;
constexpr float kGeluC = 0.7978845608028654f;  // sqrt(2/pi)
constexpr float kGeluA = 0.044715f;

template <bool ROUND>
__device__ __forceinline__ float operand(float v) {
  if constexpr (ROUND) {
    return __bfloat162float(__float2bfloat16(v));
  } else {
    return v;
  }
}

__device__ __forceinline__ float load(const float* p) { return *p; }
__device__ __forceinline__ float load(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float gelu_tanh(float a) {
  const float u = kGeluC * (a + kGeluA * a * a * a);
  return 0.5f * a * (1.0f + tanhf(u));
}

__device__ __forceinline__ float gelu_tanh_grad(float a) {
  const float u = kGeluC * (a + kGeluA * a * a * a);
  const float t = tanhf(u);
  return 0.5f * (1.0f + t) + 0.5f * a * (1.0f - t * t) * kGeluC * (1.0f + 3.0f * kGeluA * a * a);
}

// ---------------------------------------------------------------------------
// Tiled GEMM: out[m, n] = epilogue(sum_k prologue(A)[m, k] * W[n, k] + bias[n])
// A [M, K] row-major; W [Nout, K] (nn.Linear layout); K % BK == 0.
// 64x64 output tile per block, 256 threads, 4x4 outputs per thread.
// With EPI_BIAS_GELU and a non-null `pre`, the value before GELU goes there.
// ---------------------------------------------------------------------------

constexpr int BM = 64, BN = 64, BK = 16, GEMM_THREADS = 256;

enum Epilogue { EPI_BIAS = 0, EPI_BIAS_GELU = 1, EPI_BIAS_RES = 2 };

template <typename TA, typename TR, typename TO, bool LN, int EPI, bool ROUND>
__global__ void __launch_bounds__(GEMM_THREADS)
gemm_kernel(const TA* __restrict__ A, const float* __restrict__ ln_s,
            const float* __restrict__ ln_b, const float* __restrict__ W,
            const float* __restrict__ bias, const TR* __restrict__ R,
            TO* __restrict__ out, float* __restrict__ pre, int M, int Nout, int K) {
  // +4 keeps each row 16-byte aligned for the float4 reads and staggers banks
  __shared__ __align__(16) float As[BK][BM + 4];
  __shared__ __align__(16) float Bs[BK][BN + 4];
  __shared__ float mean_s[BM];
  __shared__ float rstd_s[BM];

  const int tid = threadIdx.x;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;

  if constexpr (LN) {
    // centred two-pass statistics of this block's rows, one warp per row
    const int warp = tid / 32, lane = tid % 32;
    for (int r = warp; r < BM; r += GEMM_THREADS / 32) {
      const int m = m0 + r;
      float mu = 0.f, rs = 0.f;
      if (m < M) {
        const TA* row = A + static_cast<size_t>(m) * K;
        float s = 0.f;
        for (int k = lane; k < K; k += 32) s += load(row + k);
        mu = warp_sum(s) / K;
        float v = 0.f;
        for (int k = lane; k < K; k += 32) {
          const float d = load(row + k) - mu;
          v += d * d;
        }
        rs = rsqrtf(warp_sum(v) / K + kEps);
      }
      if (lane == 0) {
        mean_s[r] = mu;
        rstd_s[r] = rs;
      }
    }
    __syncthreads();
  }

  // loader mapping: 4 consecutive k of one row per thread
  const int lr = tid / 4;
  const int lk = (tid % 4) * 4;
  // compute mapping: rows ty*4.., columns tx*4..
  const int tx = tid % 16, ty = tid / 16;
  float acc[4][4] = {};

  for (int k0 = 0; k0 < K; k0 += BK) {
    {
      const int m = m0 + lr;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int k = k0 + lk + i;
        float v = 0.f;
        if (m < M) {
          v = load(A + static_cast<size_t>(m) * K + k);
          if constexpr (LN) v = (v - mean_s[lr]) * rstd_s[lr] * ln_s[k] + ln_b[k];
          v = operand<ROUND>(v);
        }
        As[lk + i][lr] = v;
      }
    }
    {
      const int n = n0 + lr;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int k = k0 + lk + i;
        Bs[lk + i][lr] = n < Nout ? operand<ROUND>(W[static_cast<size_t>(n) * K + k]) : 0.f;
      }
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n >= Nout) continue;
      const size_t at = static_cast<size_t>(m) * Nout + n;
      float v = acc[i][j] + bias[n];
      if constexpr (EPI == EPI_BIAS_GELU) {
        if (pre != nullptr) pre[at] = v;
        v = gelu_tanh(v);
      }
      if constexpr (EPI == EPI_BIAS_RES) v = load(R + at) + v;
      store(out + at, v);
    }
  }
}

// ---------------------------------------------------------------------------
// Attention of one sample and one head for a tile of BQ queries.
// qkv [B*N, 3D] f32 with columns (q | k | v), head h at h*DH inside each.
// The whole [BQ, N] score tile stays in shared memory (N <= 512), so the
// softmax is the exact max-subtracted one, with no cross-sample mask.
// A non-null P receives the probabilities, f32 [B, H, N, N], before rounding.
// ---------------------------------------------------------------------------

constexpr int BQ = 16, BKV = 32, ATT_THREADS = 256;
constexpr int kMaxN = 512;

template <int DH>
constexpr size_t attention_smem_bytes(int n) {
  return (static_cast<size_t>(BQ + BKV) * (DH + 1) + static_cast<size_t>(BQ) * n) * sizeof(float);
}

template <int DH, bool ROUND>
__global__ void __launch_bounds__(ATT_THREADS)
attention_kernel(const float* __restrict__ qkv, float* __restrict__ o, float* __restrict__ P,
                 int N, int D, float scale) {
  static_assert((BQ * DH) % ATT_THREADS == 0, "outputs must split evenly over threads");
  constexpr int LD = DH + 1;  // padded rows: a warp walking j reads 32 banks
  constexpr int PER = BQ * DH / ATT_THREADS;
  extern __shared__ float smem[];
  float* Qs = smem;              // [BQ][LD]
  float* KVs = Qs + BQ * LD;     // [BKV][LD], K chunk then V chunk
  float* S = KVs + BKV * LD;     // [BQ][N]

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int nq = min(BQ, N - q0);
  const size_t ld = 3 * static_cast<size_t>(D);
  const float* base = qkv + static_cast<size_t>(b) * N * ld;

  for (int idx = tid; idx < BQ * DH; idx += ATT_THREADS) {
    const int i = idx / DH, d = idx % DH;
    Qs[i * LD + d] = i < nq ? operand<ROUND>(base[(q0 + i) * ld + h * DH + d]) : 0.f;
  }

  for (int k0 = 0; k0 < N; k0 += BKV) {
    const int nk = min(BKV, N - k0);
    __syncthreads();
    for (int idx = tid; idx < BKV * DH; idx += ATT_THREADS) {
      const int j = idx / DH, d = idx % DH;
      KVs[j * LD + d] = j < nk ? operand<ROUND>(base[(k0 + j) * ld + D + h * DH + d]) : 0.f;
    }
    __syncthreads();
    for (int idx = tid; idx < BQ * BKV; idx += ATT_THREADS) {
      const int i = idx / BKV, j = idx % BKV;
      if (i < nq && j < nk) {
        float s = 0.f;
#pragma unroll 8
        for (int d = 0; d < DH; ++d) s = fmaf(Qs[i * LD + d], KVs[j * LD + d], s);
        S[i * N + k0 + j] = s * scale;
      }
    }
  }
  __syncthreads();

  {
    const int warp = tid / 32, lane = tid % 32;
    for (int i = warp; i < nq; i += ATT_THREADS / 32) {
      float* row = S + i * N;
      float mx = -CUDART_INF_F;
      for (int j = lane; j < N; j += 32) mx = fmaxf(mx, row[j]);
      mx = warp_max(mx);
      float sum = 0.f;
      for (int j = lane; j < N; j += 32) {
        const float e = expf(row[j] - mx);
        row[j] = e;
        sum += e;
      }
      sum = warp_sum(sum);
      float* prow = P == nullptr ? nullptr
                                 : P + ((static_cast<size_t>(b) * gridDim.y + h) * N + q0 + i) * N;
      for (int j = lane; j < N; j += 32) {
        const float p = row[j] / sum;
        if (prow != nullptr) prow[j] = p;
        row[j] = operand<ROUND>(p);
      }
    }
  }

  float acc[PER];
#pragma unroll
  for (int r = 0; r < PER; ++r) acc[r] = 0.f;

  for (int k0 = 0; k0 < N; k0 += BKV) {
    const int nk = min(BKV, N - k0);
    __syncthreads();
    for (int idx = tid; idx < BKV * DH; idx += ATT_THREADS) {
      const int j = idx / DH, d = idx % DH;
      KVs[j * LD + d] = j < nk ? operand<ROUND>(base[(k0 + j) * ld + 2 * D + h * DH + d]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < PER; ++r) {
      const int idx = tid + r * ATT_THREADS;
      const int i = idx / DH, d = idx % DH;
      if (i < nq) {
        float a = acc[r];
        for (int j = 0; j < nk; ++j) a = fmaf(S[i * N + k0 + j], KVs[j * LD + d], a);
        acc[r] = a;
      }
    }
  }

#pragma unroll
  for (int r = 0; r < PER; ++r) {
    const int idx = tid + r * ATT_THREADS;
    const int i = idx / DH, d = idx % DH;
    if (i < nq) o[(static_cast<size_t>(b) * N + q0 + i) * D + h * DH + d] = acc[r];
  }
}

#define S3F_TRY(expr)                          \
  do {                                         \
    const cudaError_t err_ = (expr);           \
    if (err_ != cudaSuccess) return err_;      \
  } while (0)

template <typename TA, typename TR, typename TO, bool LN, int EPI, bool ROUND>
cudaError_t launch_gemm(const TA* A, const float* ln_s, const float* ln_b, const float* W,
                        const float* bias, const TR* R, TO* out, float* pre, int M, int Nout,
                        int K, cudaStream_t stream) {
  const dim3 grid((Nout + BN - 1) / BN, (M + BM - 1) / BM);
  gemm_kernel<TA, TR, TO, LN, EPI, ROUND>
      <<<grid, GEMM_THREADS, 0, stream>>>(A, ln_s, ln_b, W, bias, R, out, pre, M, Nout, K);
  return cudaGetLastError();
}

template <int DH, bool ROUND>
cudaError_t launch_attention(const float* qkv, float* o, float* P, int B, int N, int D, int H,
                             cudaStream_t stream) {
  const size_t smem = attention_smem_bytes<DH>(N);
  S3F_TRY((cudaFuncSetAttribute(attention_kernel<DH, ROUND>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                static_cast<int>(smem))));
  const dim3 grid((N + BQ - 1) / BQ, H, B);
  const float scale = 1.0f / sqrtf(static_cast<float>(DH));
  attention_kernel<DH, ROUND><<<grid, ATT_THREADS, smem, stream>>>(qkv, o, P, N, D, scale);
  return cudaGetLastError();
}

struct BlockWeights {
  const float *ln1_s, *ln1_b, *wqkv, *bqkv, *wproj, *bproj;
  const float *ln2_s, *ln2_b, *w1, *b1, *w2, *b2;
};

// The forward chain. a1 and probs are null when serving; the training forward
// passes both and keeps them for the backward.
template <typename T, bool ROUND>
cudaError_t vit_block(const T* x, T* y, int B, int N, int D, int H, const BlockWeights& w,
                      float* qkv, float* o, float* h1, float* g1, float* a1, float* probs,
                      cudaStream_t stream) {
  const int M = B * N;
  const int dh = D / H;
  S3F_TRY((launch_gemm<T, float, float, true, EPI_BIAS, ROUND>(
      x, w.ln1_s, w.ln1_b, w.wqkv, w.bqkv, nullptr, qkv, nullptr, M, 3 * D, D, stream)));
  switch (dh) {
    case 64: S3F_TRY((launch_attention<64, ROUND>(qkv, o, probs, B, N, D, H, stream))); break;
    case 128: S3F_TRY((launch_attention<128, ROUND>(qkv, o, probs, B, N, D, H, stream))); break;
    case 256: S3F_TRY((launch_attention<256, ROUND>(qkv, o, probs, B, N, D, H, stream))); break;
    default: return cudaErrorInvalidValue;
  }
  S3F_TRY((launch_gemm<float, T, float, false, EPI_BIAS_RES, ROUND>(
      o, nullptr, nullptr, w.wproj, w.bproj, x, h1, nullptr, M, D, D, stream)));
  S3F_TRY((launch_gemm<float, float, float, true, EPI_BIAS_GELU, ROUND>(
      h1, w.ln2_s, w.ln2_b, w.w1, w.b1, nullptr, g1, a1, M, 4 * D, D, stream)));
  return launch_gemm<float, float, T, false, EPI_BIAS_RES, ROUND>(
      g1, nullptr, nullptr, w.w2, w.b2, h1, y, nullptr, M, D, 4 * D, stream);
}

// ---------------------------------------------------------------------------
// Backward building blocks.
// ---------------------------------------------------------------------------

constexpr int ROW_THREADS = 256;  // row kernels: one warp per row

template <typename T>
__global__ void to_f32_kernel(const T* __restrict__ in, float* __restrict__ out, size_t n) {
  for (size_t i = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x; i < n;
       i += static_cast<size_t>(gridDim.x) * blockDim.x) {
    out[i] = load(in + i);
  }
}

// LayerNorm statistics of each row of X [M, K], the forward's centred two-pass form.
__global__ void __launch_bounds__(ROW_THREADS)
row_stats_kernel(const float* __restrict__ X, float* __restrict__ mean,
                 float* __restrict__ rstd, int M, int K) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int m = blockIdx.x * (ROW_THREADS / 32) + warp;
  if (m >= M) return;
  const float* row = X + static_cast<size_t>(m) * K;
  float s = 0.f;
  for (int k = lane; k < K; k += 32) s += row[k];
  const float mu = warp_sum(s) / K;
  float v = 0.f;
  for (int k = lane; k < K; k += 32) {
    const float d = row[k] - mu;
    v += d * d;
  }
  const float rs = rsqrtf(warp_sum(v) / K + kEps);
  if (lane == 0) {
    mean[m] = mu;
    rstd[m] = rs;
  }
}

// The LayerNorm input gradient (the TPU kernel's _ln_bwd) plus a residual:
//   out = res + rstd * (g_xh - mean(g_xh) - xhat * mean(g_xh * xhat)),
//   g_xh = gz * ln_s, xhat = (X - mean) * rstd; one warp per row.
template <typename TO>
__global__ void __launch_bounds__(ROW_THREADS)
ln_bwd_kernel(const float* __restrict__ gz, const float* __restrict__ X,
              const float* __restrict__ mean, const float* __restrict__ rstd,
              const float* __restrict__ ln_s, const float* __restrict__ res,
              TO* __restrict__ out, int M, int D) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int m = blockIdx.x * (ROW_THREADS / 32) + warp;
  if (m >= M) return;
  const size_t base = static_cast<size_t>(m) * D;
  const float mu = mean[m], rs = rstd[m];
  float s1 = 0.f, s2 = 0.f;
  for (int d = lane; d < D; d += 32) {
    const float gxh = gz[base + d] * ln_s[d];
    const float xh = (X[base + d] - mu) * rs;
    s1 += gxh;
    s2 += gxh * xh;
  }
  const float m1 = warp_sum(s1) / D;
  const float m2 = warp_sum(s2) / D;
  for (int d = lane; d < D; d += 32) {
    const float gxh = gz[base + d] * ln_s[d];
    const float xh = (X[base + d] - mu) * rs;
    store(out + base + d, res[base + d] + rs * (gxh - m1 - xh * m2));
  }
}

// Column sums over the M token rows: out_b[n] = sum_m G[m, n], and with LN also
// out_s[n] = sum_m G[m, n] * xhat[m, n], xhat = (X - mean) * rstd. A block
// takes 32 columns; its 32 thread rows take every 32nd token row, and the 32
// partial sums add up in a fixed order (no atomics: the same bits every run).
constexpr int CS_COLS = 32, CS_ROWS = 32;

template <bool LN>
__global__ void __launch_bounds__(CS_COLS * CS_ROWS)
colsum_kernel(const float* __restrict__ G, const float* __restrict__ X,
              const float* __restrict__ mean, const float* __restrict__ rstd,
              float* __restrict__ out_s, float* __restrict__ out_b, int M, int ncols) {
  __shared__ float sb[CS_ROWS][CS_COLS];
  __shared__ float ss[CS_ROWS][CS_COLS];
  const int tx = threadIdx.x % CS_COLS, ty = threadIdx.x / CS_COLS;
  const int n = blockIdx.x * CS_COLS + tx;
  float b = 0.f, s = 0.f;
  if (n < ncols) {
#pragma unroll 4
    for (int m = ty; m < M; m += CS_ROWS) {
      const size_t at = static_cast<size_t>(m) * ncols + n;
      const float g = G[at];
      b += g;
      if constexpr (LN) s += g * ((X[at] - mean[m]) * rstd[m]);
    }
  }
  sb[ty][tx] = b;
  ss[ty][tx] = s;
  __syncthreads();
  if (ty == 0 && n < ncols) {
    float tb = 0.f, ts = 0.f;
    for (int r = 0; r < CS_ROWS; ++r) {
      tb += sb[r][tx];
      ts += ss[r][tx];
    }
    out_b[n] = tb;
    if constexpr (LN) out_s[n] = ts;
  }
}

// The backward's products: out[i, j] = epilogue(sum_k A(i, k) * prologue(B)(k, j)).
//   A(i, k) = A[i * lda + k] (A_KMAJOR false: a gradient [M, K] times a weight), or
//             A[k * lda + i] (A_KMAJOR true: a gradient transposed, the sum runs
//             over the M token rows and gives a weight gradient [out, in]).
//   B is [K, J] row-major: a Linear weight [out, in] read as (k = out, j = in),
//   or token rows through a prologue: PRO_LN gives the LayerNorm output
//   (B - mean[k]) * rstd[k] * ln_s[j] + ln_b[j], PRO_GELU gives gelu_tanh(B).
//   GEPI_GELU_GRAD multiplies the sum by gelu_tanh'(aux[i, j]).
// Both operands are rounded to the compute dtype after the prologue. The same
// 64x64 tiles and 4x4 outputs per thread as gemm_kernel; every edge is masked.
enum Prologue { PRO_NONE = 0, PRO_LN = 1, PRO_GELU = 2 };
enum GradEpilogue { GEPI_STORE = 0, GEPI_GELU_GRAD = 1 };

template <bool A_KMAJOR, int PRO, int EPI, bool ROUND>
__global__ void __launch_bounds__(GEMM_THREADS)
grad_gemm_kernel(const float* __restrict__ A, int lda, const float* __restrict__ Bm, int ldb,
                 const float* __restrict__ mean, const float* __restrict__ rstd,
                 const float* __restrict__ ln_s, const float* __restrict__ ln_b,
                 const float* __restrict__ aux, float* __restrict__ out, int I, int J, int K) {
  __shared__ __align__(16) float As[BK][BM + 4];
  __shared__ __align__(16) float Bs[BK][BN + 4];

  const int tid = threadIdx.x;
  const int i0 = blockIdx.y * BM;
  const int j0 = blockIdx.x * BN;
  const int tx = tid % 16, ty = tid / 16;
  float acc[4][4] = {};

  for (int k0 = 0; k0 < K; k0 += BK) {
    if constexpr (A_KMAJOR) {
      // 4 consecutive i of one k row per thread
      const int lk = tid / 16, li = (tid % 16) * 4;
      const int k = k0 + lk;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int i = i0 + li + q;
        As[lk][li + q] =
            (k < K && i < I) ? operand<ROUND>(A[static_cast<size_t>(k) * lda + i]) : 0.f;
      }
    } else {
      // 4 consecutive k of one i row per thread
      const int lr = tid / 4, lk = (tid % 4) * 4;
      const int i = i0 + lr;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int k = k0 + lk + q;
        As[lk + q][lr] =
            (k < K && i < I) ? operand<ROUND>(A[static_cast<size_t>(i) * lda + k]) : 0.f;
      }
    }
    {
      const int lk = tid / 16, lj = (tid % 16) * 4;
      const int k = k0 + lk;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int j = j0 + lj + q;
        float v = 0.f;
        if (k < K && j < J) {
          v = Bm[static_cast<size_t>(k) * ldb + j];
          if constexpr (PRO == PRO_LN) v = (v - mean[k]) * rstd[k] * ln_s[j] + ln_b[j];
          if constexpr (PRO == PRO_GELU) v = gelu_tanh(v);
          v = operand<ROUND>(v);
        }
        Bs[lk][lj + q] = v;
      }
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = i0 + ty * 4 + i;
    if (r >= I) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = j0 + tx * 4 + j;
      if (c >= J) continue;
      const size_t at = static_cast<size_t>(r) * J + c;
      float v = acc[i][j];
      if constexpr (EPI == GEPI_GELU_GRAD) v = v * gelu_tanh_grad(aux[at]);
      out[at] = v;
    }
  }
}

// Attention backward, pass 1: one block per (query tile, head, sample), the
// [BQ, N] tile of g_p in shared memory as the forward holds its scores:
//   g_p = g_o v^T,  g_s = p * (g_p - sum_j g_p p) * scale   (f32, also to gS),
//   g_q = g_s k     -> columns [h*DH, (h+1)*DH) of g_qkv.
template <int DH, bool ROUND>
__global__ void __launch_bounds__(ATT_THREADS)
attn_bwd_rows_kernel(const float* __restrict__ qkv, const float* __restrict__ P,
                     const float* __restrict__ g_o, float* __restrict__ gS,
                     float* __restrict__ g_qkv, int N, int D, float scale) {
  static_assert((BQ * DH) % ATT_THREADS == 0, "outputs must split evenly over threads");
  constexpr int LD = DH + 1;
  constexpr int PER = BQ * DH / ATT_THREADS;
  extern __shared__ float smem[];
  float* Gs = smem;             // [BQ][LD] rows of g_o
  float* KVs = Gs + BQ * LD;    // [BKV][LD], a V chunk, later a K chunk
  float* S = KVs + BKV * LD;    // [BQ][N], g_p, then g_s rounded

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int nq = min(BQ, N - q0);
  const size_t ld = 3 * static_cast<size_t>(D);
  const float* base = qkv + static_cast<size_t>(b) * N * ld;
  const float* gbase = g_o + static_cast<size_t>(b) * N * D;
  const size_t pbase = (static_cast<size_t>(b) * gridDim.y + h) * N * N;

  for (int idx = tid; idx < BQ * DH; idx += ATT_THREADS) {
    const int i = idx / DH, d = idx % DH;
    Gs[i * LD + d] = i < nq ? operand<ROUND>(gbase[(q0 + i) * static_cast<size_t>(D) + h * DH + d])
                            : 0.f;
  }

  for (int k0 = 0; k0 < N; k0 += BKV) {
    const int nk = min(BKV, N - k0);
    __syncthreads();
    for (int idx = tid; idx < BKV * DH; idx += ATT_THREADS) {
      const int j = idx / DH, d = idx % DH;
      KVs[j * LD + d] = j < nk ? operand<ROUND>(base[(k0 + j) * ld + 2 * D + h * DH + d]) : 0.f;
    }
    __syncthreads();
    for (int idx = tid; idx < BQ * BKV; idx += ATT_THREADS) {
      const int i = idx / BKV, j = idx % BKV;
      if (i < nq && j < nk) {
        float s = 0.f;
#pragma unroll 8
        for (int d = 0; d < DH; ++d) s = fmaf(Gs[i * LD + d], KVs[j * LD + d], s);
        S[i * N + k0 + j] = s;
      }
    }
  }
  __syncthreads();

  {
    const int warp = tid / 32, lane = tid % 32;
    for (int i = warp; i < nq; i += ATT_THREADS / 32) {
      float* row = S + i * N;
      const float* prow = P + pbase + static_cast<size_t>(q0 + i) * N;
      float r = 0.f;
      for (int j = lane; j < N; j += 32) r += row[j] * prow[j];
      r = warp_sum(r);
      float* grow = gS + pbase + static_cast<size_t>(q0 + i) * N;
      for (int j = lane; j < N; j += 32) {
        const float gs = prow[j] * (row[j] - r) * scale;
        grow[j] = gs;
        row[j] = operand<ROUND>(gs);
      }
    }
  }

  float acc[PER];
#pragma unroll
  for (int r = 0; r < PER; ++r) acc[r] = 0.f;

  for (int k0 = 0; k0 < N; k0 += BKV) {
    const int nk = min(BKV, N - k0);
    __syncthreads();
    for (int idx = tid; idx < BKV * DH; idx += ATT_THREADS) {
      const int j = idx / DH, d = idx % DH;
      KVs[j * LD + d] = j < nk ? operand<ROUND>(base[(k0 + j) * ld + D + h * DH + d]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < PER; ++r) {
      const int idx = tid + r * ATT_THREADS;
      const int i = idx / DH, d = idx % DH;
      if (i < nq) {
        float a = acc[r];
        for (int j = 0; j < nk; ++j) a = fmaf(S[i * N + k0 + j], KVs[j * LD + d], a);
        acc[r] = a;
      }
    }
  }

#pragma unroll
  for (int r = 0; r < PER; ++r) {
    const int idx = tid + r * ATT_THREADS;
    const int i = idx / DH, d = idx % DH;
    if (i < nq) g_qkv[(static_cast<size_t>(b) * N + q0 + i) * ld + h * DH + d] = acc[r];
  }
}

// Attention backward, pass 2: one block per (key tile of BJ, head, sample),
// summing over every query in chunks of BI:
//   g_k = g_s^T q -> columns D + [h*DH, ...),  g_v = p^T g_o -> columns 2D + [h*DH, ...).
constexpr int BJ = 16, BI = 16;

template <int DH, bool ROUND>
__global__ void __launch_bounds__(ATT_THREADS)
attn_bwd_cols_kernel(const float* __restrict__ qkv, const float* __restrict__ P,
                     const float* __restrict__ g_o, const float* __restrict__ gS,
                     float* __restrict__ g_qkv, int N, int D) {
  static_assert((BJ * DH) % ATT_THREADS == 0, "outputs must split evenly over threads");
  constexpr int LD = DH + 1;
  constexpr int PER = BJ * DH / ATT_THREADS;
  __shared__ float Pc[BI][BJ];
  __shared__ float Gc[BI][BJ];
  __shared__ float GOc[BI * LD];
  __shared__ float Qc[BI * LD];

  const int j0 = blockIdx.x * BJ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int nj = min(BJ, N - j0);
  const size_t ld = 3 * static_cast<size_t>(D);
  const float* base = qkv + static_cast<size_t>(b) * N * ld;
  const float* gbase = g_o + static_cast<size_t>(b) * N * D;
  const size_t pbase = (static_cast<size_t>(b) * gridDim.y + h) * N * N;

  float acc_k[PER], acc_v[PER];
#pragma unroll
  for (int r = 0; r < PER; ++r) acc_k[r] = acc_v[r] = 0.f;

  for (int i0 = 0; i0 < N; i0 += BI) {
    const int ni = min(BI, N - i0);
    __syncthreads();
    for (int idx = tid; idx < BI * BJ; idx += ATT_THREADS) {
      const int ii = idx / BJ, jj = idx % BJ;
      const bool ok = ii < ni && jj < nj;
      const size_t at = pbase + static_cast<size_t>(i0 + ii) * N + j0 + jj;
      Pc[ii][jj] = ok ? operand<ROUND>(P[at]) : 0.f;
      Gc[ii][jj] = ok ? operand<ROUND>(gS[at]) : 0.f;
    }
    for (int idx = tid; idx < BI * DH; idx += ATT_THREADS) {
      const int ii = idx / DH, d = idx % DH;
      const bool ok = ii < ni;
      GOc[ii * LD + d] =
          ok ? operand<ROUND>(gbase[(i0 + ii) * static_cast<size_t>(D) + h * DH + d]) : 0.f;
      Qc[ii * LD + d] = ok ? operand<ROUND>(base[(i0 + ii) * ld + h * DH + d]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < PER; ++r) {
      const int idx = tid + r * ATT_THREADS;
      const int jj = idx / DH, d = idx % DH;
      float ak = acc_k[r], av = acc_v[r];
      for (int ii = 0; ii < ni; ++ii) {
        ak = fmaf(Gc[ii][jj], Qc[ii * LD + d], ak);
        av = fmaf(Pc[ii][jj], GOc[ii * LD + d], av);
      }
      acc_k[r] = ak;
      acc_v[r] = av;
    }
  }

#pragma unroll
  for (int r = 0; r < PER; ++r) {
    const int idx = tid + r * ATT_THREADS;
    const int jj = idx / DH, d = idx % DH;
    if (jj < nj) {
      const size_t row = (static_cast<size_t>(b) * N + j0 + jj) * ld;
      g_qkv[row + D + h * DH + d] = acc_k[r];
      g_qkv[row + 2 * D + h * DH + d] = acc_v[r];
    }
  }
}

template <bool A_KMAJOR, int PRO, int EPI, bool ROUND>
cudaError_t launch_grad_gemm(const float* A, int lda, const float* Bm, int ldb,
                             const float* mean, const float* rstd, const float* ln_s,
                             const float* ln_b, const float* aux, float* out, int I, int J,
                             int K, cudaStream_t stream) {
  const dim3 grid((J + BN - 1) / BN, (I + BM - 1) / BM);
  grad_gemm_kernel<A_KMAJOR, PRO, EPI, ROUND><<<grid, GEMM_THREADS, 0, stream>>>(
      A, lda, Bm, ldb, mean, rstd, ln_s, ln_b, aux, out, I, J, K);
  return cudaGetLastError();
}

template <bool LN>
cudaError_t launch_colsum(const float* G, const float* X, const float* mean, const float* rstd,
                          float* out_s, float* out_b, int M, int ncols, cudaStream_t stream) {
  colsum_kernel<LN><<<(ncols + CS_COLS - 1) / CS_COLS, CS_COLS * CS_ROWS, 0, stream>>>(
      G, X, mean, rstd, out_s, out_b, M, ncols);
  return cudaGetLastError();
}

template <int DH, bool ROUND>
cudaError_t launch_attention_bwd(const float* qkv, const float* P, const float* g_o, float* gS,
                                 float* g_qkv, int B, int N, int D, int H, cudaStream_t stream) {
  const size_t smem = attention_smem_bytes<DH>(N);
  S3F_TRY((cudaFuncSetAttribute(attn_bwd_rows_kernel<DH, ROUND>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                static_cast<int>(smem))));
  const float scale = 1.0f / sqrtf(static_cast<float>(DH));
  attn_bwd_rows_kernel<DH, ROUND><<<dim3((N + BQ - 1) / BQ, H, B), ATT_THREADS, smem, stream>>>(
      qkv, P, g_o, gS, g_qkv, N, D, scale);
  S3F_TRY(cudaGetLastError());
  attn_bwd_cols_kernel<DH, ROUND><<<dim3((N + BJ - 1) / BJ, H, B), ATT_THREADS, 0, stream>>>(
      qkv, P, g_o, gS, g_qkv, N, D);
  return cudaGetLastError();
}

struct Residuals {  // what the training forward keeps, all f32
  float *qkv, *probs, *o, *h1, *a1;
};

struct BlockGrads {  // f32, in the weights' layout
  float *ln1_s, *ln1_b, *wqkv, *bqkv, *wproj, *bproj;
  float *ln2_s, *ln2_b, *w1, *b1, *w2, *b2;
};

size_t residual_floats(int B, int N, int D, int H) {
  const size_t md = static_cast<size_t>(B) * N * D;
  return 9 * md + static_cast<size_t>(B) * H * N * N;  // qkv 3, o, h1, a1 4; probs
}

size_t backward_floats(int B, int N, int D, int H) {
  const size_t m = static_cast<size_t>(B) * N;
  const size_t md = m * D;
  // x and g in f32, LayerNorm stats, g_a1 4, g_z2, g_h1, g_o, g_z1, g_s, g_qkv 3
  return 2 * md + 4 * m + 4 * md + 4 * md + static_cast<size_t>(B) * H * N * N + 3 * md;
}

template <typename T>
cudaError_t to_f32(const T* in, float* out, size_t n, cudaStream_t stream) {
  const int blocks = static_cast<int>(std::min<size_t>((n + 255) / 256, 4096));
  to_f32_kernel<T><<<blocks, 256, 0, stream>>>(in, out, n);
  return cudaGetLastError();
}

// The backward from the residuals (the TPU kernel's _bwd_kernel_res :394).
template <typename T, bool ROUND>
cudaError_t vit_block_bwd(const T* x, const T* g, T* gx, int B, int N, int D, int H,
                          const BlockWeights& w, const Residuals& r, const BlockGrads& gw,
                          float* scratch, cudaStream_t s) {
  const int M = B * N;
  const size_t md = static_cast<size_t>(M) * D;
  float* xf_buf = scratch;
  float* gy_buf = xf_buf + md;
  float* mean1 = gy_buf + md;
  float* rstd1 = mean1 + M;
  float* mean2 = rstd1 + M;
  float* rstd2 = mean2 + M;
  float* ga1 = rstd2 + M;
  float* gz2 = ga1 + 4 * md;
  float* gh1 = gz2 + md;
  float* go = gh1 + md;
  float* gz1 = go + md;
  float* gs = gz1 + md;
  float* gqkv = gs + static_cast<size_t>(B) * H * N * N;

  const float* xf;
  const float* gy;
  if constexpr (std::is_same_v<T, float>) {
    xf = x;
    gy = g;
  } else {
    S3F_TRY(to_f32(x, xf_buf, md, s));
    S3F_TRY(to_f32(g, gy_buf, md, s));
    xf = xf_buf;
    gy = gy_buf;
  }
  const int row_blocks = (M + ROW_THREADS / 32 - 1) / (ROW_THREADS / 32);
  row_stats_kernel<<<row_blocks, ROW_THREADS, 0, s>>>(xf, mean1, rstd1, M, D);
  S3F_TRY(cudaGetLastError());
  row_stats_kernel<<<row_blocks, ROW_THREADS, 0, s>>>(r.h1, mean2, rstd2, M, D);
  S3F_TRY(cudaGetLastError());

  // MLP branch
  S3F_TRY((launch_grad_gemm<false, PRO_NONE, GEPI_GELU_GRAD, ROUND>(  // g_a1 = (g_y W2) gelu'(a1)
      gy, D, w.w2, 4 * D, nullptr, nullptr, nullptr, nullptr, r.a1, ga1, M, 4 * D, D, s)));
  S3F_TRY((launch_grad_gemm<true, PRO_GELU, GEPI_STORE, ROUND>(  // dW2 = g_y^T gelu(a1)
      gy, D, r.a1, 4 * D, nullptr, nullptr, nullptr, nullptr, nullptr, gw.w2, D, 4 * D, M, s)));
  S3F_TRY(launch_colsum<false>(gy, nullptr, nullptr, nullptr, nullptr, gw.b2, M, D, s));
  S3F_TRY((launch_grad_gemm<false, PRO_NONE, GEPI_STORE, ROUND>(  // g_z2 = g_a1 W1
      ga1, 4 * D, w.w1, D, nullptr, nullptr, nullptr, nullptr, nullptr, gz2, M, D, 4 * D, s)));
  S3F_TRY((launch_grad_gemm<true, PRO_LN, GEPI_STORE, ROUND>(  // dW1 = g_a1^T LN2(h1)
      ga1, 4 * D, r.h1, D, mean2, rstd2, w.ln2_s, w.ln2_b, nullptr, gw.w1, 4 * D, D, M, s)));
  S3F_TRY(launch_colsum<false>(ga1, nullptr, nullptr, nullptr, nullptr, gw.b1, M, 4 * D, s));
  S3F_TRY(launch_colsum<true>(gz2, r.h1, mean2, rstd2, gw.ln2_s, gw.ln2_b, M, D, s));
  ln_bwd_kernel<float><<<row_blocks, ROW_THREADS, 0, s>>>(  // g_h1 = g_y + LN2'(g_z2)
      gz2, r.h1, mean2, rstd2, w.ln2_s, gy, gh1, M, D);
  S3F_TRY(cudaGetLastError());

  // attention branch
  S3F_TRY((launch_grad_gemm<false, PRO_NONE, GEPI_STORE, ROUND>(  // g_o = g_h1 Wproj
      gh1, D, w.wproj, D, nullptr, nullptr, nullptr, nullptr, nullptr, go, M, D, D, s)));
  S3F_TRY((launch_grad_gemm<true, PRO_NONE, GEPI_STORE, ROUND>(  // dWproj = g_h1^T o
      gh1, D, r.o, D, nullptr, nullptr, nullptr, nullptr, nullptr, gw.wproj, D, D, M, s)));
  S3F_TRY(launch_colsum<false>(gh1, nullptr, nullptr, nullptr, nullptr, gw.bproj, M, D, s));
  switch (D / H) {
    case 64: S3F_TRY((launch_attention_bwd<64, ROUND>(r.qkv, r.probs, go, gs, gqkv, B, N, D, H, s))); break;
    case 128: S3F_TRY((launch_attention_bwd<128, ROUND>(r.qkv, r.probs, go, gs, gqkv, B, N, D, H, s))); break;
    case 256: S3F_TRY((launch_attention_bwd<256, ROUND>(r.qkv, r.probs, go, gs, gqkv, B, N, D, H, s))); break;
    default: return cudaErrorInvalidValue;
  }
  S3F_TRY((launch_grad_gemm<false, PRO_NONE, GEPI_STORE, ROUND>(  // g_z1 = g_qkv Wqkv
      gqkv, 3 * D, w.wqkv, D, nullptr, nullptr, nullptr, nullptr, nullptr, gz1, M, D, 3 * D, s)));
  S3F_TRY((launch_grad_gemm<true, PRO_LN, GEPI_STORE, ROUND>(  // dWqkv = g_qkv^T LN1(x)
      gqkv, 3 * D, xf, D, mean1, rstd1, w.ln1_s, w.ln1_b, nullptr, gw.wqkv, 3 * D, D, M, s)));
  S3F_TRY(launch_colsum<false>(gqkv, nullptr, nullptr, nullptr, nullptr, gw.bqkv, M, 3 * D, s));
  S3F_TRY(launch_colsum<true>(gz1, xf, mean1, rstd1, gw.ln1_s, gw.ln1_b, M, D, s));
  ln_bwd_kernel<T><<<row_blocks, ROW_THREADS, 0, s>>>(  // g_x = g_h1 + LN1'(g_z1)
      gz1, xf, mean1, rstd1, w.ln1_s, gh1, gx, M, D);
  return cudaGetLastError();
}

// Calls fn(T{}, std::integral_constant<bool, ROUND>{}) for the dtypes asked for.
template <typename Fn>
cudaError_t dispatch(int x_bf16, int cdt_bf16, Fn&& fn) {
  if (x_bf16) {
    return cdt_bf16 ? fn(__nv_bfloat16{}, std::true_type{}) : fn(__nv_bfloat16{}, std::false_type{});
  }
  return cdt_bf16 ? fn(float{}, std::true_type{}) : fn(float{}, std::false_type{});
}

bool bad_shape(int B, int N, int D, int H) {
  return B < 1 || N < 1 || N > kMaxN || H < 1 || D % H != 0 || D % BK != 0;
}

BlockWeights weights_of(const void* const* p) {
  const auto f = [p](int i) { return static_cast<const float*>(p[i]); };
  return BlockWeights{f(0), f(1), f(2), f(3), f(4), f(5), f(6), f(7), f(8), f(9), f(10), f(11)};
}

BlockGrads grads_of(void* const* p) {
  const auto f = [p](int i) { return static_cast<float*>(p[i]); };
  return BlockGrads{f(0), f(1), f(2), f(3), f(4), f(5), f(6), f(7), f(8), f(9), f(10), f(11)};
}

// Residual buffers carved from one f32 region, in the order qkv, probs, o, h1, a1.
Residuals residuals_in(float* base, int B, int N, int D, int H) {
  const size_t md = static_cast<size_t>(B) * N * D;
  Residuals r;
  r.qkv = base;
  r.probs = r.qkv + 3 * md;
  r.o = r.probs + static_cast<size_t>(B) * H * N * N;
  r.h1 = r.o + md;
  r.a1 = r.h1 + md;
  return r;
}

}  // namespace

extern "C" {

// x, y: [B, N, D] contiguous, f32 (x_bf16 == 0) or bf16 (x_bf16 == 1).
// cdt_bf16: round matmul operands to bf16. Weights f32 contiguous, Linear
// weights [out, in]. Scratch f32: qkv [B*N, 3D], o [B*N, D], h1 [B*N, D],
// g1 [B*N, 4D]. Limits: 1 <= N <= 512, D % 16 == 0, D / H in {64, 128, 256}.
int s3f_vit_block_fwd(const void* x, void* y, int x_bf16, int cdt_bf16, int B, int N, int D,
                      int H, const void* ln1_s, const void* ln1_b, const void* wqkv,
                      const void* bqkv, const void* wproj, const void* bproj,
                      const void* ln2_s, const void* ln2_b, const void* w1, const void* b1,
                      const void* w2, const void* b2, void* qkv, void* o, void* h1, void* g1,
                      void* stream) {
  if (bad_shape(B, N, D, H)) return cudaErrorInvalidValue;
  const void* const wp[12] = {ln1_s, ln1_b, wqkv, bqkv, wproj, bproj,
                              ln2_s, ln2_b, w1,   b1,   w2,    b2};
  const BlockWeights w = weights_of(wp);
  float* fq = static_cast<float*>(qkv);
  float* fo = static_cast<float*>(o);
  float* fh = static_cast<float*>(h1);
  float* fg = static_cast<float*>(g1);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dispatch(x_bf16, cdt_bf16, [&](auto tag, auto round) {
    using T = decltype(tag);
    return vit_block<T, decltype(round)::value>(static_cast<const T*>(x), static_cast<T*>(y), B,
                                                N, D, H, w, fq, fo, fh, fg, nullptr, nullptr, s);
  });
}

// The training forward: as s3f_vit_block_fwd, and it keeps the residuals in
// `res`, f32, in the order qkv [B*N, 3D], probs [B, H, N, N], o [B*N, D],
// h1 [B*N, D], a1 [B*N, 4D] (s3f_vit_block_residual_floats of them).
// weights: the twelve weight pointers in the order of the entry above.
// g1: scratch f32 [B*N, 4D].
int s3f_vit_block_fwd_res(const void* x, void* y, int x_bf16, int cdt_bf16, int B, int N, int D,
                          int H, const void* const* weights, void* res, void* g1, void* stream) {
  if (bad_shape(B, N, D, H)) return cudaErrorInvalidValue;
  const BlockWeights w = weights_of(weights);
  const Residuals r = residuals_in(static_cast<float*>(res), B, N, D, H);
  float* fg = static_cast<float*>(g1);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dispatch(x_bf16, cdt_bf16, [&](auto tag, auto round) {
    using T = decltype(tag);
    return vit_block<T, decltype(round)::value>(static_cast<const T*>(x), static_cast<T*>(y), B,
                                                N, D, H, w, r.qkv, r.o, r.h1, fg, r.a1, r.probs,
                                                s);
  });
}

long long s3f_vit_block_residual_floats(int B, int N, int D, int H) {
  return static_cast<long long>(residual_floats(B, N, D, H));
}

// f32 scratch of s3f_vit_block_bwd_res, and of s3f_vit_block_bwd (recompute).
long long s3f_vit_block_bwd_scratch_floats(int B, int N, int D, int H, int recompute) {
  size_t n = backward_floats(B, N, D, H);
  if (recompute) n += residual_floats(B, N, D, H) + 5 * static_cast<size_t>(B) * N * D;  // g1, y
  return static_cast<long long>(n);
}

// The residual backward: g [B, N, D] in x's dtype; gx out in x's dtype;
// grads: twelve f32 outputs in the weights' shapes and order (overwritten);
// res: the training forward's residuals.
int s3f_vit_block_bwd_res(const void* x, const void* g, void* gx, int x_bf16, int cdt_bf16,
                          int B, int N, int D, int H, const void* const* weights,
                          const void* res, void* const* grads, void* scratch, void* stream) {
  if (bad_shape(B, N, D, H)) return cudaErrorInvalidValue;
  const BlockWeights w = weights_of(weights);
  const Residuals r = residuals_in(const_cast<float*>(static_cast<const float*>(res)), B, N, D, H);
  const BlockGrads gw = grads_of(grads);
  float* sc = static_cast<float*>(scratch);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dispatch(x_bf16, cdt_bf16, [&](auto tag, auto round) {
    using T = decltype(tag);
    return vit_block_bwd<T, decltype(round)::value>(static_cast<const T*>(x),
                                                    static_cast<const T*>(g),
                                                    static_cast<T*>(gx), B, N, D, H, w, r, gw,
                                                    sc, s);
  });
}

// The recompute backward (the TPU kernel's _bwd_kernel :153): only x and the
// weights come from the forward; the training forward runs again into scratch.
int s3f_vit_block_bwd(const void* x, const void* g, void* gx, int x_bf16, int cdt_bf16, int B,
                      int N, int D, int H, const void* const* weights, void* const* grads,
                      void* scratch, void* stream) {
  if (bad_shape(B, N, D, H)) return cudaErrorInvalidValue;
  const BlockWeights w = weights_of(weights);
  const BlockGrads gw = grads_of(grads);
  const size_t md = static_cast<size_t>(B) * N * D;
  float* sc = static_cast<float*>(scratch);
  const Residuals r = residuals_in(sc, B, N, D, H);
  float* g1 = sc + residual_floats(B, N, D, H);
  float* y = g1 + 4 * md;
  float* bwd = y + md;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dispatch(x_bf16, cdt_bf16, [&](auto tag, auto round) {
    using T = decltype(tag);
    constexpr bool R = decltype(round)::value;
    const T* xt = static_cast<const T*>(x);
    S3F_TRY((vit_block<T, R>(xt, reinterpret_cast<T*>(y), B, N, D, H, w, r.qkv, r.o, r.h1, g1,
                             r.a1, r.probs, s)));
    return vit_block_bwd<T, R>(xt, static_cast<const T*>(g), static_cast<T*>(gx), B, N, D, H, w,
                               r, gw, bwd, s);
  });
}

}  // extern "C"
