// Fused pre-norm ViT block forward for Hopper (sm_90a), plain C interface.
//
//   h = x + proj(MHA(LN1(x)))      qkv = LN1(x) Wqkv^T + bqkv
//   y = h + fc2(gelu_tanh(fc1(LN2(h))))
//
// A chain of five launches from one entry point:
//   1. gemm<LN, BIAS>        qkv = LN1(x) Wqkv^T + bqkv             -> f32 [M, 3D]
//   2. attention<DH>         one block per (query tile, head, sample) -> f32 [M, D]
//   3. gemm<-, BIAS_RES>     h = x + (o Wproj^T + bproj)             -> f32 [M, D]
//   4. gemm<LN, BIAS_GELU>   g = gelu_tanh(LN2(h) W1^T + b1)          -> f32 [M, 4D]
//   5. gemm<-, BIAS_RES>     y = h + (g W2^T + b2)                   -> x.dtype [M, D]
// M = B*N token rows. Weights are f32 in nn.Linear layout [out, in]; LayerNorm
// statistics, softmax, GELU, residuals and every sum are f32. Matmul operands
// are rounded to bf16 (round to nearest even) when the compute dtype is bf16,
// and products accumulate in f32 FMA (no TF32, no tensor cores).
//
// Every entry returns the first CUDA error of its launches (0 on success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstddef>
#include <cstdint>

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

// ---------------------------------------------------------------------------
// Tiled GEMM: out[m, n] = epilogue(sum_k prologue(A)[m, k] * W[n, k] + bias[n])
// A [M, K] row-major; W [Nout, K] (nn.Linear layout); K % BK == 0.
// 64x64 output tile per block, 256 threads, 4x4 outputs per thread.
// ---------------------------------------------------------------------------

constexpr int BM = 64, BN = 64, BK = 16, GEMM_THREADS = 256;

enum Epilogue { EPI_BIAS = 0, EPI_BIAS_GELU = 1, EPI_BIAS_RES = 2 };

template <typename TA, typename TR, typename TO, bool LN, int EPI, bool ROUND>
__global__ void __launch_bounds__(GEMM_THREADS)
gemm_kernel(const TA* __restrict__ A, const float* __restrict__ ln_s,
            const float* __restrict__ ln_b, const float* __restrict__ W,
            const float* __restrict__ bias, const TR* __restrict__ R,
            TO* __restrict__ out, int M, int Nout, int K) {
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
      if constexpr (EPI == EPI_BIAS_GELU) v = gelu_tanh(v);
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
// ---------------------------------------------------------------------------

constexpr int BQ = 16, BKV = 32, ATT_THREADS = 256;
constexpr int kMaxN = 512;

template <int DH>
constexpr size_t attention_smem_bytes(int n) {
  return (static_cast<size_t>(BQ + BKV) * (DH + 1) + static_cast<size_t>(BQ) * n) * sizeof(float);
}

template <int DH, bool ROUND>
__global__ void __launch_bounds__(ATT_THREADS)
attention_kernel(const float* __restrict__ qkv, float* __restrict__ o, int N, int D, float scale) {
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
      for (int j = lane; j < N; j += 32) row[j] = operand<ROUND>(row[j] / sum);
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

template <typename TA, typename TR, typename TO, bool LN, int EPI, bool ROUND>
cudaError_t launch_gemm(const TA* A, const float* ln_s, const float* ln_b, const float* W,
                        const float* bias, const TR* R, TO* out, int M, int Nout, int K,
                        cudaStream_t stream) {
  const dim3 grid((Nout + BN - 1) / BN, (M + BM - 1) / BM);
  gemm_kernel<TA, TR, TO, LN, EPI, ROUND>
      <<<grid, GEMM_THREADS, 0, stream>>>(A, ln_s, ln_b, W, bias, R, out, M, Nout, K);
  return cudaGetLastError();
}

template <int DH, bool ROUND>
cudaError_t launch_attention(const float* qkv, float* o, int B, int N, int D, int H,
                             cudaStream_t stream) {
  const size_t smem = attention_smem_bytes<DH>(N);
  cudaError_t err = cudaFuncSetAttribute(attention_kernel<DH, ROUND>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((N + BQ - 1) / BQ, H, B);
  const float scale = 1.0f / sqrtf(static_cast<float>(DH));
  attention_kernel<DH, ROUND><<<grid, ATT_THREADS, smem, stream>>>(qkv, o, N, D, scale);
  return cudaGetLastError();
}

struct BlockWeights {
  const float *ln1_s, *ln1_b, *wqkv, *bqkv, *wproj, *bproj;
  const float *ln2_s, *ln2_b, *w1, *b1, *w2, *b2;
};

template <typename T, bool ROUND>
cudaError_t vit_block(const T* x, T* y, int B, int N, int D, int H, const BlockWeights& w,
                      float* qkv, float* o, float* h1, float* g1, cudaStream_t stream) {
  const int M = B * N;
  const int dh = D / H;
  cudaError_t err = launch_gemm<T, float, float, true, EPI_BIAS, ROUND>(
      x, w.ln1_s, w.ln1_b, w.wqkv, w.bqkv, nullptr, qkv, M, 3 * D, D, stream);
  if (err != cudaSuccess) return err;
  switch (dh) {
    case 64: err = launch_attention<64, ROUND>(qkv, o, B, N, D, H, stream); break;
    case 128: err = launch_attention<128, ROUND>(qkv, o, B, N, D, H, stream); break;
    case 256: err = launch_attention<256, ROUND>(qkv, o, B, N, D, H, stream); break;
    default: return cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return err;
  err = launch_gemm<float, T, float, false, EPI_BIAS_RES, ROUND>(
      o, nullptr, nullptr, w.wproj, w.bproj, x, h1, M, D, D, stream);
  if (err != cudaSuccess) return err;
  err = launch_gemm<float, float, float, true, EPI_BIAS_GELU, ROUND>(
      h1, w.ln2_s, w.ln2_b, w.w1, w.b1, nullptr, g1, M, 4 * D, D, stream);
  if (err != cudaSuccess) return err;
  return launch_gemm<float, float, T, false, EPI_BIAS_RES, ROUND>(
      g1, nullptr, nullptr, w.w2, w.b2, h1, y, M, D, 4 * D, stream);
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
  if (B < 1 || N < 1 || N > kMaxN || H < 1 || D % H != 0 || D % BK != 0) {
    return cudaErrorInvalidValue;
  }
  const BlockWeights w{
      static_cast<const float*>(ln1_s), static_cast<const float*>(ln1_b),
      static_cast<const float*>(wqkv),  static_cast<const float*>(bqkv),
      static_cast<const float*>(wproj), static_cast<const float*>(bproj),
      static_cast<const float*>(ln2_s), static_cast<const float*>(ln2_b),
      static_cast<const float*>(w1),    static_cast<const float*>(b1),
      static_cast<const float*>(w2),    static_cast<const float*>(b2)};
  float* fq = static_cast<float*>(qkv);
  float* fo = static_cast<float*>(o);
  float* fh = static_cast<float*>(h1);
  float* fg = static_cast<float*>(g1);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_bf16) {
    const auto* xb = static_cast<const __nv_bfloat16*>(x);
    auto* yb = static_cast<__nv_bfloat16*>(y);
    return cdt_bf16 ? vit_block<__nv_bfloat16, true>(xb, yb, B, N, D, H, w, fq, fo, fh, fg, s)
                    : vit_block<__nv_bfloat16, false>(xb, yb, B, N, D, H, w, fq, fo, fh, fg, s);
  }
  const auto* xf = static_cast<const float*>(x);
  auto* yf = static_cast<float*>(y);
  return cdt_bf16 ? vit_block<float, true>(xf, yf, B, N, D, H, w, fq, fo, fh, fg, s)
                  : vit_block<float, false>(xf, yf, B, N, D, H, w, fq, fo, fh, fg, s);
}

}  // extern "C"
