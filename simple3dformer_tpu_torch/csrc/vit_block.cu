// Fused pre-norm ViT block, forward and backward, for Hopper (sm_90a), plain C
// interface.
//
//   h = x + proj(MHA(LN1(x)))      qkv = LN1(x) Wqkv^T + bqkv
//   y = h + fc2(gelu_tanh(fc1(LN2(h))))
//
// Replaces the TPU kernels of simple3dformer_tpu/kernels/vit_block.py: the
// forward (_fwd_kernel :145, pallas_call :264), the recompute backward
// (_bwd_kernel :153, :290), the training forward keeping its residuals
// (_fwd_kernel_res :336, :366) and the backward from them (_bwd_kernel_res
// :394, :477).
//
// Forward: a chain of launches from one entry point:
//   row_stats(x)                  LayerNorm statistics of each token row, once
//   qkv  = LN1(x) Wqkv^T + bqkv                                      -> f32 [M, 3D]
//   attention<DH>                 one block per (query rows, head, sample) -> f32 [M, D]
//   h1   = x + (o Wproj^T + bproj)                                   -> f32 [M, D]
//   row_stats(h1)
//   g1   = gelu_tanh(LN2(h1) W1^T + b1)                              -> f32 [M, 4D]
//   y    = h1 + (g1 W2^T + b2)                                       -> x.dtype [M, D]
// The training forward is the same chain that also keeps a1 = LN2(h1) W1^T +
// b1 (fc1 before GELU) and the softmax probabilities [B, H, N, N].
//
// Backward from those residuals (the TPU kernel's _bwd_kernel_res): LayerNorm
// statistics are re-derived from x and h1, then each product of the chain runs
// as a GEMM (dX = dY W; dW = dY^T X summed over the M token rows in fixed row
// chunks, the bias gradient, the column sum of dY, in the same pass), the
// attention backward runs per (rows, head, sample) in two kernels (query rows,
// then key rows, g_s passed between them in the compute dtype), and the
// LayerNorm gradients are column sums in a fixed order. No float atomics: two
// runs give the same bits. The recompute backward runs the training forward
// into scratch first and then the same backward.
//
// The attention kernels run every product on the tensor cores too (mma.sync,
// the same two routes; the section "Attention on the tensor cores" below). At
// B=64, N=197, D=384, 6 heads the forward reads qkv (58 MB) and writes o and
// the f32 probabilities (79 MB), 3.8 GFLOP of products: 0.041 ms of bytes
// against 0.023 of 3-pass TF32 products, so bytes bound it; the backward moves
// about 195 MB (0.058 ms) for 7.6 GFLOP (0.046 ms). The score row stays whole
// in shared memory (N <= 512), so the softmax is the exact max-subtracted
// one and only the order of the products' f32 sums changes.
//
// Every GEMM runs on the tensor-core core of tc_gemm.cuh (tc_gemm_kernel, 64 x
// 64 output tiles, 8 warps of 32 x 16): 3-pass TF32 mma.sync when the compute
// dtype is f32, bf16 mma.sync when it is bf16 (the operands rounded to nearest
// even where they are staged, as the plain version rounds them; the f32 sums
// differ in order only). The operands are read where they lie: activations
// K-major, a weight K-major in its Linear layout [out, in] in the forward and
// MN-major in the backward's row GEMMs, and both factors of a weight gradient
// MN-major with the token rows as the contraction. LayerNorm (from each row's
// statistics, computed once), GELU and the rounding are applied to a staged
// tile in shared memory. At the flagship shape (B=32, N=26, D=384) the four
// forward GEMMs are 2.94 GFLOP on M = 832 rows and 7 MB of weights: the
// products bound a call on this card (0.018 ms at 165 TFLOP/s of 3-pass TF32),
// not bytes. Small M makes small grids: where a GEMM's output tiles do not fill
// a wave of the 132 SMs, its contraction is split in fixed chunks (blockIdx.z),
// each chunk writes its partial sums, and a second pass adds them in chunk order
// and applies the epilogue (split_of). LayerNorm statistics, softmax, GELU,
// residuals and every sum outside the tensor cores are f32; weights are f32.
//
// Every entry returns the first CUDA error of its launches (0 on success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <algorithm>
#include <cstddef>
#include <cstdint>
#include <type_traits>

#include "tc_gemm.cuh"

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
// The GEMMs: tc_gemm_kernel at 64 x 64 output tiles (8 warps of 32 x 16, two
// blocks an SM), the products' route P (Tf32x3 or Bf16Mma) by the compute dtype.
// ---------------------------------------------------------------------------

using BlkTile = TcTile<64, 2, 4, 2>;
constexpr int kSMs = 132;  // H100 SXM

// LayerNorm of a staged f32 operand from each token row's mean and rstd, the
// value (v - mean) * rstd * s + b: on K-major rows (m the token row, k the
// channel) or, COLS, on MN-major rows of a weight gradient (k the token row, m
// the channel)
template <bool COLS>
struct LnXf {
  static constexpr bool ACTIVE = true;
  const float *mean, *rstd, *s, *b;
  __device__ __forceinline__ float4 operator()(float4 v, int m, int k) const {
    const int row = COLS ? k : m, col = COLS ? m : k;
    const float mu = mean[row], rs = rstd[row];
    const float4 sc = load4(s + col), bi = load4(b + col);
    return make_float4((v.x - mu) * rs * sc.x + bi.x, (v.y - mu) * rs * sc.y + bi.y,
                       (v.z - mu) * rs * sc.z + bi.z, (v.w - mu) * rs * sc.w + bi.w);
  }
};

// gelu_tanh of a staged f32 operand (a1 as the right factor of W2's gradient)
struct GeluXf {
  static constexpr bool ACTIVE = true;
  __device__ __forceinline__ float4 operator()(float4 v, int, int) const {
    return make_float4(gelu_tanh(v.x), gelu_tanh(v.y), gelu_tanh(v.z), gelu_tanh(v.w));
  }
};

// f32 rows [.., ld] as an operand of route P: K-major (activation rows, or a
// weight in its Linear layout) or MN-major (a weight read transposed, or a
// weight gradient's factor), transformed by XF; a weight gradient's left
// factor sums its values for the bias gradient
template <class P, bool KMAJOR, class XF = NoXf>
using Rows = TcRows<BlkTile, typename P::T, float, KMAJOR, false, false, XF>;

// Elementwise epilogues: out(m, n, v) takes the sums of row m, columns n .. n
// + 3 (n a multiple of 4, all inside the output).

// out = v + bias
struct OutBias {
  const float* bias;
  float* out;
  int ld;
  __device__ __forceinline__ void operator()(int m, int n, float4 v) const {
    const float4 b = load4(bias + n);
    store4(out + static_cast<long long>(m) * ld + n, v.x + b.x, v.y + b.y, v.z + b.z, v.w + b.w);
  }
};

// a = v + bias (kept in pre where not null), out = gelu_tanh(a)
struct OutBiasGelu {
  const float* bias;
  float* pre;
  float* out;
  int ld;
  __device__ __forceinline__ void operator()(int m, int n, float4 v) const {
    const float4 b = load4(bias + n);
    const float a0 = v.x + b.x, a1 = v.y + b.y, a2 = v.z + b.z, a3 = v.w + b.w;
    const long long at = static_cast<long long>(m) * ld + n;
    if (pre != nullptr) store4(pre + at, a0, a1, a2, a3);
    store4(out + at, gelu_tanh(a0), gelu_tanh(a1), gelu_tanh(a2), gelu_tanh(a3));
  }
};

// out = res + (v + bias), out of type TO
template <class TO>
struct OutBiasRes {
  const float* bias;
  const float* res;
  TO* out;
  int ld;
  __device__ __forceinline__ void operator()(int m, int n, float4 v) const {
    const float4 b = load4(bias + n);
    const long long at = static_cast<long long>(m) * ld + n;
    const float4 r = load4(res + at);
    store4(out + at, r.x + (v.x + b.x), r.y + (v.y + b.y), r.z + (v.z + b.z), r.w + (v.w + b.w));
  }
};

// out = v
struct OutStore {
  float* out;
  int ld;
  __device__ __forceinline__ void operator()(int m, int n, float4 v) const {
    store4(out + static_cast<long long>(m) * ld + n, v.x, v.y, v.z, v.w);
  }
};

// out = v * gelu_tanh'(aux)
struct OutGeluGrad {
  const float* aux;
  float* out;
  int ld;
  __device__ __forceinline__ void operator()(int m, int n, float4 v) const {
    const long long at = static_cast<long long>(m) * ld + n;
    const float4 a = load4(aux + at);
    store4(out + at, v.x * gelu_tanh_grad(a.x), v.y * gelu_tanh_grad(a.y),
           v.z * gelu_tanh_grad(a.z), v.w * gelu_tanh_grad(a.w));
  }
};

// A split contraction's chunks meet in the last block of a tile to arrive:
// each block writes its chunk's partial sums, and the block that finds itself
// the last of its tile's gridDim.z blocks on the tile's arrival counter (an
// integer atomic) adds the chunks' partials in chunk order and writes the
// result; it leaves the counter zero again for the next launch. The order of
// the sums does not depend on the order of arrival: two runs give the same
// bits.
__device__ __forceinline__ bool last_to_arrive(unsigned* counter) {
  __shared__ bool last;
  __threadfence();  // this block's partial sums, visible before it is counted
  __syncthreads();
  if (threadIdx.x == 0) {
    last = atomicAdd(counter, 1u) == gridDim.z - 1;
    if (last) *counter = 0;
  }
  __syncthreads();
  if (last) __threadfence();
  return last;
}

__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float4 add_rn(float4 a, float4 b) {
  return make_float4(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y), __fadd_rn(a.z, b.z),
                     __fadd_rn(a.w, b.w));
}

// the sum over the chunks of the partial (a float or 4 consecutive floats, V)
// at p, chunk stride `stride`, added in chunk order; read past the L1 cache
// (other blocks wrote them), four chunks' loads in flight at a time
template <class V>
__device__ __forceinline__ V chunk_sum(const float* p, long long stride) {
  V s{};
  const unsigned n = gridDim.z;
  unsigned c = 0;
  for (; c + 4 <= n; c += 4) {
    V v[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) v[u] = __ldcg(reinterpret_cast<const V*>(p + (c + u) * stride));
#pragma unroll
    for (int u = 0; u < 4; ++u) s = add_rn(s, v[u]);
  }
  for (; c < n; ++c) s = add_rn(s, __ldcg(reinterpret_cast<const V*>(p + c * stride)));
  return s;
}

// The core's epilogue for a row GEMM [rows, cols]: each thread takes float4
// runs of the tile C and hands them to out; when the contraction is split
// (gridDim.z > 1), through the chunks' partials [chunks][rows][cols] and the
// tile's arrival counter (one a column-major tile, blockIdx.x)
template <class Out>
struct BlkEpi {
  Out out;
  float* partial;
  unsigned* arrivals;
  int rows, cols;
  __device__ __forceinline__ void operator()(float* C, const float*, bool, int m0, int n0, int,
                                             int) const {
    constexpr int PER_ROW = BlkTile::BN / 4, RUNS = BlkTile::BM * PER_ROW / BlkTile::THREADS;
    const long long count = static_cast<long long>(rows) * cols;
#pragma unroll
    for (int i = 0; i < RUNS; ++i) {
      const int a = threadIdx.x + i * BlkTile::THREADS, r = a / PER_ROW, c = a % PER_ROW * 4;
      const int m = m0 + r, n = n0 + c;
      if (m >= rows || n >= cols) continue;
      const float4 v = *reinterpret_cast<const float4*>(C + r * BlkTile::LDC + c);
      if (gridDim.z == 1)
        out(m, n, v);
      else
        store4(partial + blockIdx.z * count + static_cast<long long>(m) * cols + n, v.x, v.y,
               v.z, v.w);
    }
    if (gridDim.z == 1 || !last_to_arrive(arrivals + blockIdx.x)) return;
#pragma unroll
    for (int i = 0; i < RUNS; ++i) {
      const int a = threadIdx.x + i * BlkTile::THREADS, r = a / PER_ROW, c = a % PER_ROW * 4;
      const int m = m0 + r, n = n0 + c;
      if (m >= rows || n >= cols) continue;
      out(m, n, chunk_sum<float4>(partial + static_cast<long long>(m) * cols + n, count));
    }
  }
};

// The core's epilogue for a weight gradient: gw [d, n] and, from the first
// column tile, gb [d] (the sums of the left factor's rows, the thread groups'
// partials added in a fixed order). With a split contraction, each chunk's
// partial sums go to partial + chunk * (d n + d) (gb's after gw's), and the
// tile's last block to arrive adds them in chunk order.
struct BlkEpiWgrad {
  float *gw, *gb, *partial;
  unsigned* arrivals;
  int d, n;
  __device__ __forceinline__ void operator()(float* C, const float* part, bool sums, int m0,
                                             int n0, int nt, int) const {
    constexpr int PER_ROW = BlkTile::BN / 4, RUNS = BlkTile::BM * PER_ROW / BlkTile::THREADS;
    const long long nw = static_cast<long long>(d) * n, stride = nw + d;
    const bool split = gridDim.z > 1, bias = sums && nt == 0;
    float* w = split ? partial + blockIdx.z * stride : gw;
    float* b = split ? partial + blockIdx.z * stride + nw : gb;
#pragma unroll
    for (int i = 0; i < RUNS; ++i) {
      const int a = threadIdx.x + i * BlkTile::THREADS, r = a / PER_ROW, c = a % PER_ROW * 4;
      const int o = m0 + r, col = n0 + c;
      if (o >= d || col >= n) continue;
      const float4 v = *reinterpret_cast<const float4*>(C + r * BlkTile::LDC + c);
      store4(w + static_cast<long long>(o) * n + col, v.x, v.y, v.z, v.w);
    }
    if (bias) {
      for (int r = threadIdx.x; r < BlkTile::BM; r += BlkTile::THREADS) {
        if (m0 + r >= d) continue;
        float s = 0.f;
#pragma unroll
        for (int g = 0; g < BlkTile::GROUPS; ++g) s = __fadd_rn(s, part[g * BlkTile::BM + r]);
        b[m0 + r] = s;
      }
    }
    if (!split || !last_to_arrive(arrivals + blockIdx.x)) return;
#pragma unroll
    for (int i = 0; i < RUNS; ++i) {
      const int a = threadIdx.x + i * BlkTile::THREADS, r = a / PER_ROW, c = a % PER_ROW * 4;
      const int o = m0 + r, col = n0 + c;
      if (o >= d || col >= n) continue;
      const long long at = static_cast<long long>(o) * n + col;
      const float4 s = chunk_sum<float4>(partial + at, stride);
      store4(gw + at, s.x, s.y, s.z, s.w);
    }
    if (bias) {
      for (int r = threadIdx.x; r < BlkTile::BM; r += BlkTile::THREADS) {
        if (m0 + r < d) gb[m0 + r] = chunk_sum<float>(partial + nw + m0 + r, stride);
      }
    }
  }
};

// How a GEMM of `tiles` output tiles splits its contraction of k: chunks of a
// multiple of TBK rows, doubled in number while the grid has fewer than
// `waves` waves of blocks (one a SM) and each chunk keeps at least 4 stages.
// A function of the shapes alone, so every run splits the same way. A split
// GEMM has fewer than kMaxSplitTiles output tiles, one arrival counter each.
struct Split {
  int chunks, chunk;
};
Split split_of(int tiles, int k, int waves) {
  int s = 1;
  while (tiles * s < waves * kSMs && k / (2 * s) >= 4 * TBK) s *= 2;
  const int chunk = ((k + s - 1) / s + TBK - 1) / TBK * TBK;
  return Split{(k + chunk - 1) / chunk, chunk};
}

int tiles_of(int rows, int cols) {
  return ((rows + BlkTile::BM - 1) / BlkTile::BM) * ((cols + BlkTile::BN - 1) / BlkTile::BN);
}

// the row GEMMs fill one wave; the weight gradients, pure sums, two
constexpr int kRowWaves = 1, kWgradWaves = 2;
constexpr int kMaxSplitTiles = kWgradWaves * kSMs;

// f32 scratch of a row GEMM's partials, and of a weight gradient's
size_t row_partial_floats(int rows, int cols, int k) {
  const Split sp = split_of(tiles_of(rows, cols), k, kRowWaves);
  return sp.chunks > 1 ? static_cast<size_t>(sp.chunks) * rows * cols : 0;
}
size_t wgrad_partial_floats(int rows, int d, int n) {
  const Split sp = split_of(tiles_of(d, n), rows, kWgradWaves);
  return sp.chunks > 1 ? static_cast<size_t>(sp.chunks) * (static_cast<size_t>(d) * n + d) : 0;
}

// out(C) for C [rows, cols] = A B^T over a contraction of k; partial and
// arrivals (kMaxSplitTiles counters, zero) serve a split contraction
template <class P, class OpA, class OpB, class Out>
cudaError_t blk_gemm(OpA a, OpB b, Out out, int rows, int cols, int k, float* partial,
                     unsigned* arrivals, cudaStream_t stream) {
  const int ncol = (cols + BlkTile::BN - 1) / BlkTile::BN, tiles = tiles_of(rows, cols);
  const Split sp = split_of(tiles, k, kRowWaves);
  return static_cast<cudaError_t>(tc_launch<P, BlkTile>(
      a, b, BlkEpi<Out>{out, partial, arrivals, rows, cols}, dim3(tiles, 1, sp.chunks),
      BlkTile::BM, ncol, k, sp.chunk, stream));
}

// gw [d, n] = g^T x and gb [d] = the column sums of g, over `rows` token rows in
// chunks: g [rows, d] f32, x an MN-major operand [rows, n]
template <class P, class OpX>
cudaError_t blk_wgrad(const float* g, OpX x, int rows, int d, int n, float* partial,
                      unsigned* arrivals, float* gw, float* gb, cudaStream_t stream) {
  using SumRows = TcRows<BlkTile, typename P::T, float, false, false, true>;
  const int ncol = (n + BlkTile::BN - 1) / BlkTile::BN, tiles = tiles_of(d, n);
  const Split sp = split_of(tiles, rows, kWgradWaves);
  return static_cast<cudaError_t>(tc_launch<P, BlkTile>(
      SumRows{g, d, d}, x, BlkEpiWgrad{gw, gb, partial, arrivals, d, n},
      dim3(tiles, 1, sp.chunks), BlkTile::BM, ncol, rows, sp.chunk, stream));
}

// ---------------------------------------------------------------------------
// Attention on the tensor cores, per (sample, head), q, k and v read in place
// from qkv [B*N, 3D] f32 (columns q | k | v, head h at h*DH inside each):
//
//   attention_kernel      one block per (BQ query rows, head, sample): s = q k^T
//                         scale over the key tiles into a [BQ, N] f32 tile in
//                         shared memory (N <= 512), the exact max-subtracted
//                         softmax on it (a non-null P receives the
//                         probabilities, f32 [B, H, N, N], before rounding),
//                         then o = cdt(p) v.
//   attn_bwd_rows_kernel  the same walk for g_o's rows: g_p = g_o v^T into the
//                         tile, g_s = p (g_p - rowsum(g_p p)) scale with p read
//                         from P, cdt(g_s) to gS, then g_q = cdt(g_s) k.
//   attn_bwd_cols_kernel  one block per (BJ key rows, head, sample), over the
//                         query tiles of BI in order: warps 0-3 g_k += cdt(g_s)^T
//                         q, warps 4-7 g_v += cdt(p)^T g_o, the sums in
//                         registers (no float atomics: two runs give the same
//                         bits).
//
// Every product is an mma.sync: 3-pass TF32 (tensor_core.cuh's split) in f32,
// bf16 in the ROUND route, each operand rounded to nearest even where its
// fragment leaves shared memory (qkv, P and g_o are f32 in memory; only gS is
// kept in the compute dtype). Tiles are staged with cp.async, double-buffered,
// so a tile's copy overlaps the products of the one before; the second
// product's first tile is in flight through the softmax (or the g_s step).
// Shared-memory reads are conflict-free by pitch: K-major tiles (the
// contraction contiguous: q, k, g_o, v as the right factor of g_o v^T, and the
// score tile) are read as float2 at (row g, column 2t), pitch 8 mod 32; for
// TF32 the contraction column t is read at 2t and t + 4 at 2t + 1, the same
// permutation on both sides of a product. MN-major tiles (v and k as the
// right factor, the column kernel's four tiles) are read as scalars at (rows
// 2t and 2t + 1, column g), pitch 4 mod 32 (f32) or 8 mod 64 (bf16).
// ---------------------------------------------------------------------------

constexpr int ATT_THREADS = 256;  // 8 warps
constexpr int kMaxN = 512;

// The attention tiles by head_dim. A row block: BQ query rows (shared memory
// at N = 512 under 227 KB), key tiles of BK rows, its 8 warps WR row groups of
// 16 by WC column groups (keys of a tile in the first product, output columns
// in the second). A column block: BJ key rows (the accumulators in registers),
// BI query rows a stage, each role's 4 warps WRJ row groups by WCJ.
template <int DH>
struct Att {
  static constexpr int BQ = DH == 256 ? 32 : 64;
  static constexpr int BK = DH == 64 ? 64 : 32;
  static constexpr int WR = BQ / 16, WC = 8 / WR;
  static constexpr int BJ = DH == 256 ? 32 : 64;
  static constexpr int BI = 32;
  static constexpr int WRJ = BJ / 16, WCJ = 4 / WRJ;
  static constexpr int LDK = DH + 8;  // a K-major row, floats
  static constexpr int LDN = DH + 4;  // an MN-major row, floats
};

// g_s as the column kernel reads it: in the compute dtype
template <bool ROUND>
using GsT = std::conditional_t<ROUND, bf16, float>;

// g_s's row pitch in gS [B*H, N, ldn]: 16-byte rows in either type
int gs_ld(int n) { return (n + 7) / 8 * 8; }

__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src),
               "r"(valid ? 4 : 0));
}

__device__ __forceinline__ float2 ld2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ uint32_t pack2(float2 v) { return pack(v.x, v.y); }

// two values at p and q rounded to bf16 in one register, p's in the low half
__device__ __forceinline__ uint32_t pair(const float* p, const float* q) { return pack(*p, *q); }
__device__ __forceinline__ uint32_t pair(const bf16* p, const bf16* q) {
  return static_cast<uint32_t>(*reinterpret_cast<const unsigned short*>(p)) |
         static_cast<uint32_t>(*reinterpret_cast<const unsigned short*>(q)) << 16;
}

// c[j] += a b_j, j < NT, in 3-pass TF32: a split already, b_j = (b[j][0],
// b[j][1]) split here. Pass by pass over the NT products, so that consecutive
// mma.sync are independent; every sum takes its terms in the same order.
template <int NT>
__device__ __forceinline__ void mma3n(float (*c)[4], const uint32_t (&ab)[4],
                                      const uint32_t (&as)[4], const float (&b)[NT][2]) {
  uint32_t bb[NT][2], bs[NT][2];
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    split(b[j][0], bb[j][0], bs[j][0]);
    split(b[j][1], bb[j][1], bs[j][1]);
  }
#pragma unroll
  for (int j = 0; j < NT; ++j) mma_tf32(c[j], as, bb[j]);
#pragma unroll
  for (int j = 0; j < NT; ++j) mma_tf32(c[j], ab, bs[j]);
#pragma unroll
  for (int j = 0; j < NT; ++j) mma_tf32(c[j], ab, bb[j]);
}

// ROWS rows of DH f32 from src (row stride ld) into dst (pitch LD), 16 bytes a
// copy; rows at or beyond `valid` (at least 1) are zero-filled. Every thread
// takes part; the caller commits the group.
template <int DH, int ROWS, int LD>
__device__ __forceinline__ void stage_rows(float* dst, const float* src, long long ld,
                                           int valid) {
  constexpr int CPR = DH / 4;
  for (int i = threadIdx.x; i < ROWS * CPR; i += ATT_THREADS) {
    const int r = i / CPR, c = i % CPR * 4;
    const bool ok = r < valid;
    cp_async16(dst + r * LD + c, src + (ok ? r * ld : 0) + c, ok);
  }
}

// acc[j] += A B_j^T for one warp over a contraction of DH: A the 16 rows at A,
// B_j the 8 rows at B + 8 j LD, both K-major (pitch LD)
template <bool ROUND, int NT, int DH, int LD>
__device__ __forceinline__ void mma_kmajor(const float* A, const float* B, float (&acc)[NT][4]) {
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const float* a0 = A + g * LD + 2 * t;
  const float* a1 = a0 + 8 * LD;
  const float* b = B + g * LD + 2 * t;
  if constexpr (ROUND) {
#pragma unroll 4
    for (int k = 0; k < DH; k += 16) {
      const uint32_t a[4] = {pack2(ld2(a0 + k)), pack2(ld2(a1 + k)), pack2(ld2(a0 + k + 8)),
                             pack2(ld2(a1 + k + 8))};
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const uint32_t bj[2] = {pack2(ld2(b + 8 * j * LD + k)), pack2(ld2(b + 8 * j * LD + k + 8))};
        mma_bf16(acc[j], a, bj);
      }
    }
  } else {
#pragma unroll 2
    for (int k = 0; k < DH; k += 8) {
      const float2 x0 = ld2(a0 + k), x1 = ld2(a1 + k);
      uint32_t ab[4], as[4];
      split(x0.x, ab[0], as[0]);
      split(x1.x, ab[1], as[1]);
      split(x0.y, ab[2], as[2]);
      split(x1.y, ab[3], as[3]);
      float bv[NT][2];
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const float2 y = ld2(b + 8 * j * LD + k);
        bv[j][0] = y.x;
        bv[j][1] = y.y;
      }
      mma3n<NT>(acc, ab, as, bv);
    }
  }
}

// acc[j] += A B for one warp over the contraction rows [0, klen), a multiple
// of 16: A the 16 rows at A (pitch lda, K-major: the score tile), B MN-major
// (pitch LD: rows the contraction), columns 8 j + g
template <bool ROUND, int NT, int LD>
__device__ __forceinline__ void mma_mnmajor(const float* A, int lda, const float* B, int klen,
                                            float (&acc)[NT][4]) {
  static_assert(NT % 4 == 0, "TF32 takes the columns four fragments at a time");
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const float* a0 = A + g * lda + 2 * t;
  const float* a1 = a0 + 8 * lda;
  const float* b = B + 2 * t * LD + g;
  if constexpr (ROUND) {
#pragma unroll 2
    for (int k = 0; k < klen; k += 16) {
      const uint32_t a[4] = {pack2(ld2(a0 + k)), pack2(ld2(a1 + k)), pack2(ld2(a0 + k + 8)),
                             pack2(ld2(a1 + k + 8))};
      const float* bk = b + k * LD;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const uint32_t bj[2] = {pair(bk + 8 * j, bk + LD + 8 * j),
                                pair(bk + 8 * LD + 8 * j, bk + 9 * LD + 8 * j)};
        mma_bf16(acc[j], a, bj);
      }
    }
  } else {
#pragma unroll 2
    for (int k = 0; k < klen; k += 8) {
      const float2 x0 = ld2(a0 + k), x1 = ld2(a1 + k);
      uint32_t ab[4], as[4];
      split(x0.x, ab[0], as[0]);
      split(x1.x, ab[1], as[1]);
      split(x0.y, ab[2], as[2]);
      split(x1.y, ab[3], as[3]);
      const float* bk = b + k * LD;
#pragma unroll
      for (int j0 = 0; j0 < NT; j0 += 4) {
        float bv[4][2];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          bv[j][0] = bk[8 * (j0 + j)];
          bv[j][1] = bk[LD + 8 * (j0 + j)];
        }
        mma3n<4>(acc + j0, ab, as, bv);
      }
    }
  }
}

// acc[j] += A^T B for one warp over KLEN contraction rows: A the columns
// 0 .. 15 at A of a tile [rows][columns] (pitch LDA, MN-major), B MN-major
// (pitch LDB), columns 8 j + g
template <bool ROUND, int NT, int KLEN, int LDA, int LDB, typename TA>
__device__ __forceinline__ void mma_cols(const TA* A, const float* B, float (&acc)[NT][4]) {
  static_assert(NT % 4 == 0, "TF32 takes the columns four fragments at a time");
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const TA* a = A + 2 * t * LDA + g;
  const float* b = B + 2 * t * LDB + g;
#pragma unroll
  for (int k = 0; k < KLEN; k += ROUND ? 16 : 8) {
    const TA* ak = a + k * LDA;
    const float* bk = b + k * LDB;
    if constexpr (ROUND) {
      const uint32_t af[4] = {pair(ak, ak + LDA), pair(ak + 8, ak + LDA + 8),
                              pair(ak + 8 * LDA, ak + 9 * LDA),
                              pair(ak + 8 * LDA + 8, ak + 9 * LDA + 8)};
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const uint32_t bj[2] = {pair(bk + 8 * j, bk + LDB + 8 * j),
                                pair(bk + 8 * LDB + 8 * j, bk + 9 * LDB + 8 * j)};
        mma_bf16(acc[j], af, bj);
      }
    } else {
      uint32_t ab[4], as[4];
      split(ak[0], ab[0], as[0]);
      split(ak[8], ab[1], as[1]);
      split(ak[LDA], ab[2], as[2]);
      split(ak[LDA + 8], ab[3], as[3]);
#pragma unroll
      for (int j0 = 0; j0 < NT; j0 += 4) {
        float bv[4][2];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          bv[j][0] = bk[8 * (j0 + j)];
          bv[j][1] = bk[LDB + 8 * (j0 + j)];
        }
        mma3n<4>(acc + j0, ab, as, bv);
      }
    }
  }
}

// A row block (attention_kernel, BWD false; attn_bwd_rows_kernel, BWD true):
// rows A (q, or g_o), pitch lda, from this block's sample and head; B1 and B2
// the key rows of the two products (k then v, or v then k), pitch ldb; out
// (o, or g_q), pitch ldo. P: the probabilities [B, H, N, N], written (forward,
// when not null) or read (backward); gS [B, H, N, ldn] receives cdt(g_s).
template <int DH, bool ROUND, bool BWD>
__device__ __forceinline__ void attention_rows(const float* __restrict__ A, long long lda,
                                               const float* __restrict__ B1,
                                               const float* __restrict__ B2, long long ldb,
                                               float* __restrict__ P, GsT<ROUND>* __restrict__ gS,
                                               int ldn, float* __restrict__ out, long long ldo,
                                               int N, float scale) {
  using C = Att<DH>;
  constexpr int BQ = C::BQ, BK = C::BK, LDK = C::LDK, LDN = C::LDN;
  constexpr int KW = BK / C::WC, NT1 = KW / 8;  // a warp's keys of a tile
  constexpr int CW = DH / C::WC, NT2 = CW / 8;  // a warp's output columns
  extern __shared__ __align__(16) float smem[];
  const int npad = (N + 15) / 16 * 16, lds = npad + 8;  // lds: 8 mod 16
  float* S = smem;            // [BQ][lds] scores or g_p, then cdt(p) or cdt(g_s)
  float* As = S + BQ * lds;   // [BQ][LDK]
  float* Bs = As + BQ * LDK;  // [2][BK][LDK] key tiles, K-major then MN-major
  const int q0 = blockIdx.x * BQ, nq = min(BQ, N - q0);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int wr = warp % C::WR, wc = warp / C::WR;
  const bool live = 16 * wr < nq;  // the warp's rows hold queries
  const int tiles = (N + BK - 1) / BK;
  const auto buf = [&](int i) { return Bs + (i & 1) * BK * LDK; };

  stage_rows<DH, BQ, LDK>(As, A + q0 * lda, lda, nq);
  stage_rows<DH, BK, LDK>(buf(0), B1, ldb, N);
  cp_commit();
  for (int j = 0; j < tiles; ++j) {
    if (j + 1 < tiles)
      stage_rows<DH, BK, LDK>(buf(j + 1), B1 + (j + 1) * BK * ldb, ldb, N - (j + 1) * BK);
    else  // the second product's first tile, in flight through the row step
      stage_rows<DH, BK, LDN>(buf(j + 1), B2, ldb, N);
    cp_commit();
    cp_wait<1>();
    __syncthreads();
    const int k0 = j * BK + wc * KW;
    if (live && k0 < N) {
      float acc[NT1][4] = {};
      mma_kmajor<ROUND, NT1, DH, LDK>(As + 16 * wr * LDK, buf(j) + wc * KW * LDK, acc);
      float* s = S + (16 * wr + g) * lds + k0 + 2 * t;
#pragma unroll
      for (int c = 0; c < NT1; ++c) {
        if (k0 + 8 * c >= npad) break;
        float x[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) x[e] = BWD ? acc[c][e] : __fmul_rn(acc[c][e], scale);
        *reinterpret_cast<float2*>(s + 8 * c) = make_float2(x[0], x[1]);
        *reinterpret_cast<float2*>(s + 8 * lds + 8 * c) = make_float2(x[2], x[3]);
      }
    }
    __syncthreads();
  }

  // the row step, a warp a row: columns N .. npad end as zeros
  const size_t row0 = (static_cast<size_t>(blockIdx.z) * gridDim.y + blockIdx.y) * N + q0;
  for (int i = warp; i < nq; i += ATT_THREADS / 32) {
    float* row = S + i * lds;
    if constexpr (!BWD) {
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
      float* prow = P == nullptr ? nullptr : P + (row0 + i) * N;
      for (int j = lane; j < N; j += 32) {
        const float p = row[j] / sum;
        if (prow != nullptr) prow[j] = p;
        row[j] = operand<ROUND>(p);
      }
    } else {
      const float* prow = P + (row0 + i) * N;
      float r = 0.f;
      for (int j = lane; j < N; j += 32) r += row[j] * prow[j];
      r = warp_sum(r);
      GsT<ROUND>* grow = gS + (row0 + i) * ldn;
      for (int j = lane; j < N; j += 32) {
        const float gs = prow[j] * (row[j] - r) * scale;
        store(grow + j, gs);
        row[j] = operand<ROUND>(gs);
      }
      for (int j = N + lane; j < ldn; j += 32) store(grow + j, 0.f);
    }
    for (int j = N + lane; j < npad; j += 32) row[j] = 0.f;
  }
  __syncthreads();

  float acc[NT2][4] = {};
  for (int j = 0; j < tiles; ++j) {
    if (j + 1 < tiles)
      stage_rows<DH, BK, LDN>(buf(tiles + j + 1), B2 + (j + 1) * BK * ldb, ldb,
                              N - (j + 1) * BK);
    cp_commit();
    cp_wait<1>();
    __syncthreads();
    if (live)
      mma_mnmajor<ROUND, NT2, LDN>(S + 16 * wr * lds + j * BK, lds, buf(tiles + j) + wc * CW,
                                   min(BK, npad - j * BK), acc);
    __syncthreads();
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int q = q0 + 16 * wr + g + 8 * r;
    if (!live || q >= N) continue;
    float* o = out + q * ldo + wc * CW + 2 * t;
#pragma unroll
    for (int c = 0; c < NT2; ++c)
      *reinterpret_cast<float2*>(o + 8 * c) = make_float2(acc[c][2 * r], acc[c][2 * r + 1]);
  }
}

// The row kernels: two blocks an SM (at head_dim 64 their shared memory
// allows no more once N > 64), so up to 128 registers a thread; ptxas left
// to itself held some of them at 64 and spilled.
template <int DH, bool ROUND>
__global__ void __launch_bounds__(ATT_THREADS, 2)
attention_kernel(const float* __restrict__ qkv, float* __restrict__ o, float* __restrict__ P,
                 int N, int D, float scale) {
  const long long ld = 3LL * D, row0 = static_cast<long long>(blockIdx.z) * N;
  const float* base = qkv + row0 * ld + blockIdx.y * DH;
  attention_rows<DH, ROUND, false>(base, ld, base + D, base + 2 * D, ld, P, nullptr, 0,
                                   o + row0 * D + blockIdx.y * DH, D, N, scale);
}

template <int DH, bool ROUND>
__global__ void __launch_bounds__(ATT_THREADS, 2)
attn_bwd_rows_kernel(const float* __restrict__ qkv, const float* __restrict__ P,
                     const float* __restrict__ g_o, GsT<ROUND>* __restrict__ gS, int ldn,
                     float* __restrict__ g_qkv, int N, int D, float scale) {
  const long long ld = 3LL * D, row0 = static_cast<long long>(blockIdx.z) * N;
  const float* base = qkv + row0 * ld + blockIdx.y * DH;
  attention_rows<DH, ROUND, true>(g_o + row0 * D + blockIdx.y * DH, D, base + 2 * D, base + D, ld,
                                  const_cast<float*>(P), gS, ldn,
                                  g_qkv + row0 * ld + blockIdx.y * DH, ld, N, scale);
}

// A column block's stage: the tiles of g_s (in the compute dtype) and of p,
// [BI][BJ] each, and of q and g_o, [BI][DH]
template <int DH, bool ROUND>
struct ColsStage {
  using C = Att<DH>;
  using TG = GsT<ROUND>;
  static constexpr int LDG = C::BJ + 16 / static_cast<int>(sizeof(TG)), LDP = C::BJ + 4;
  static constexpr int G_BYTES = C::BI * LDG * static_cast<int>(sizeof(TG));
  static constexpr int P_FLOATS = C::BI * LDP, R_FLOATS = C::BI * C::LDN;
  static constexpr int BYTES = G_BYTES + 4 * (P_FLOATS + 2 * R_FLOATS);
};

template <int DH, bool ROUND>
__global__ void __launch_bounds__(ATT_THREADS)
attn_bwd_cols_kernel(const float* __restrict__ qkv, const float* __restrict__ P,
                     const float* __restrict__ g_o, const GsT<ROUND>* __restrict__ gS, int ldn,
                     float* __restrict__ g_qkv, int N, int D) {
  using C = Att<DH>;
  using St = ColsStage<DH, ROUND>;
  using TG = GsT<ROUND>;
  constexpr int BI = C::BI, BJ = C::BJ, LDN = C::LDN;
  constexpr int CW = DH / C::WCJ, NT = CW / 8;
  extern __shared__ __align__(16) unsigned char raw[];
  const int j0 = blockIdx.x * BJ, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int role = warp / 4, wr = warp % 4 % C::WRJ, wc = warp % 4 / C::WRJ;
  const bool live = j0 + 16 * wr < N;
  const long long ld = 3LL * D;
  const size_t bh = static_cast<size_t>(b) * gridDim.y + h;
  const float* qh = qkv + b * N * ld + h * DH;
  const float* gh = g_o + static_cast<long long>(b) * N * D + h * DH;
  const float* ph = P + bh * N * N + j0;
  const TG* sh = gS + bh * N * ldn + j0;
  const auto at = [&](int s) { return raw + (s & 1) * St::BYTES; };

  // query rows i0 .. i0 + BI - 1 into a stage; rows at or beyond N, and
  // columns at or beyond N of p and g_s, zero-filled
  const auto load = [&](int i0, unsigned char* st) {
    TG* Gt = reinterpret_cast<TG*>(st);
    float* Pt = reinterpret_cast<float*>(st + St::G_BYTES);
    float* Qt = Pt + St::P_FLOATS;
    const int rows = N - i0;
    constexpr int PER = 16 / static_cast<int>(sizeof(TG)), CPR = BJ / PER;
    for (int e = threadIdx.x; e < BI * CPR; e += ATT_THREADS) {
      const int r = e / CPR, c = e % CPR * PER;
      const bool ok = r < rows && j0 + c < N;
      cp_async16(Gt + r * St::LDG + c, sh + (ok ? static_cast<long long>(i0 + r) * ldn + c : 0),
                 ok);
    }
    for (int e = threadIdx.x; e < BI * BJ; e += ATT_THREADS) {
      const int r = e / BJ, c = e % BJ;
      const bool ok = r < rows && j0 + c < N;
      cp_async4(Pt + r * St::LDP + c, ph + (ok ? static_cast<long long>(i0 + r) * N + c : 0), ok);
    }
    stage_rows<DH, BI, LDN>(Qt, qh + i0 * ld, ld, rows);
    stage_rows<DH, BI, LDN>(Qt + St::R_FLOATS, gh + static_cast<long long>(i0) * D, D, rows);
  };

  const int steps = (N + BI - 1) / BI;
  load(0, at(0));
  cp_commit();
  float acc[NT][4] = {};  // g_k (role 0) or g_v (role 1)
  for (int s = 0; s < steps; ++s) {
    if (s + 1 < steps) load((s + 1) * BI, at(s + 1));
    cp_commit();
    cp_wait<1>();
    __syncthreads();
    if (live) {
      const unsigned char* st = at(s);
      const float* Pt = reinterpret_cast<const float*>(st + St::G_BYTES);
      const float* Qt = Pt + St::P_FLOATS;
      if (role == 0)
        mma_cols<ROUND, NT, BI, St::LDG, LDN>(reinterpret_cast<const TG*>(st) + 16 * wr,
                                              Qt + wc * CW, acc);
      else
        mma_cols<ROUND, NT, BI, St::LDP, LDN>(Pt + 16 * wr, Qt + St::R_FLOATS + wc * CW, acc);
    }
    __syncthreads();
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int j = j0 + 16 * wr + g + 8 * r;
    if (!live || j >= N) continue;
    float* o = g_qkv + (static_cast<long long>(b) * N + j) * ld + (role + 1) * D + h * DH +
               wc * CW + 2 * t;
#pragma unroll
    for (int c = 0; c < NT; ++c)
      *reinterpret_cast<float2*>(o + 8 * c) = make_float2(acc[c][2 * r], acc[c][2 * r + 1]);
  }
}

template <int DH>
size_t rows_smem_bytes(int n) {
  using C = Att<DH>;
  return sizeof(float) * (static_cast<size_t>(C::BQ) * ((n + 15) / 16 * 16 + 8) +
                          static_cast<size_t>(C::BQ + 2 * C::BK) * C::LDK);
}

#define S3F_TRY(expr)                          \
  do {                                         \
    const cudaError_t err_ = (expr);           \
    if (err_ != cudaSuccess) return err_;      \
  } while (0)

template <int DH, bool ROUND>
cudaError_t launch_attention(const float* qkv, float* o, float* P, int B, int N, int D, int H,
                             cudaStream_t stream) {
  static SmemOnce once;
  S3F_TRY(static_cast<cudaError_t>(once(attention_kernel<DH, ROUND>, rows_smem_bytes<DH>(kMaxN))));
  const dim3 grid((N + Att<DH>::BQ - 1) / Att<DH>::BQ, H, B);
  const float scale = 1.0f / sqrtf(static_cast<float>(DH));
  attention_kernel<DH, ROUND><<<grid, ATT_THREADS, rows_smem_bytes<DH>(N), stream>>>(
      qkv, o, P, N, D, scale);
  return cudaGetLastError();
}

struct BlockWeights {
  const float *ln1_s, *ln1_b, *wqkv, *bqkv, *wproj, *bproj;
  const float *ln2_s, *ln2_b, *w1, *b1, *w2, *b2;
};

constexpr int ROW_THREADS = 256;  // row kernels: one warp per row

template <typename T>
__global__ void to_f32_kernel(const T* __restrict__ in, float* __restrict__ out, size_t n) {
  for (size_t i = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x; i < n;
       i += static_cast<size_t>(gridDim.x) * blockDim.x) {
    out[i] = load(in + i);
  }
}

template <typename T>
cudaError_t to_f32(const T* in, float* out, size_t n, cudaStream_t stream) {
  const int blocks = static_cast<int>(std::min<size_t>((n + 255) / 256, 4096));
  to_f32_kernel<T><<<blocks, 256, 0, stream>>>(in, out, n);
  return cudaGetLastError();
}

// LayerNorm statistics of each row of X [M, K], centred two-pass; first the
// nzero counters at zero are set to zero (the split GEMMs' arrivals).
__global__ void __launch_bounds__(ROW_THREADS)
row_stats_kernel(const float* __restrict__ X, float* __restrict__ mean,
                 float* __restrict__ rstd, int M, int K, unsigned* __restrict__ zero,
                 int nzero) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < nzero; i += gridDim.x * blockDim.x)
    zero[i] = 0;
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

cudaError_t row_stats(const float* X, float* mean, float* rstd, int M, int K, cudaStream_t s,
                      unsigned* zero = nullptr, int nzero = 0) {
  const int blocks = (M + ROW_THREADS / 32 - 1) / (ROW_THREADS / 32);
  row_stats_kernel<<<blocks, ROW_THREADS, 0, s>>>(X, mean, rstd, M, K, zero, nzero);
  return cudaGetLastError();
}

// the forward's GEMM partials: the largest of its four GEMMs'
size_t forward_partial_floats(int M, int D) {
  return std::max({row_partial_floats(M, 3 * D, D), row_partial_floats(M, D, D),
                   row_partial_floats(M, 4 * D, D), row_partial_floats(M, D, 4 * D)});
}

// f32 scratch of the forward chain: g1 [M, 4D], x in f32 [M, D] (a bf16 x),
// the GEMMs' partials, the arrival counters, the LayerNorm statistics [4 M];
// serving also qkv, o, h1
size_t forward_floats(int B, int N, int D, int serving) {
  const int M = B * N;
  const size_t md = static_cast<size_t>(M) * D;
  return 5 * md + forward_partial_floats(M, D) + kMaxSplitTiles + 4 * static_cast<size_t>(M) +
         (serving ? 5 * md : 0);
}

// The forward chain. a1 and probs are null when serving; the training forward
// passes both and keeps them for the backward. work: forward_floats(.., 0).
template <typename T, class P>
cudaError_t vit_block(const T* x, T* y, int B, int N, int D, int H, const BlockWeights& w,
                      float* qkv, float* o, float* h1, float* a1, float* probs, float* work,
                      cudaStream_t stream) {
  constexpr bool ROUND = std::is_same<P, Bf16Mma>::value;
  const int M = B * N;
  const size_t md = static_cast<size_t>(M) * D;
  float* g1 = work;
  float* xf_buf = g1 + 4 * md;
  float* partial = xf_buf + md;
  unsigned* arrivals = reinterpret_cast<unsigned*>(partial + forward_partial_floats(M, D));
  float* mean1 = reinterpret_cast<float*>(arrivals + kMaxSplitTiles);
  float* rstd1 = mean1 + M;
  float* mean2 = rstd1 + M;
  float* rstd2 = mean2 + M;
  const float* xf;
  if constexpr (std::is_same_v<T, float>) {
    xf = x;
  } else {
    S3F_TRY(to_f32(x, xf_buf, md, stream));
    xf = xf_buf;
  }
  S3F_TRY(row_stats(xf, mean1, rstd1, M, D, stream, arrivals, kMaxSplitTiles));
  S3F_TRY((blk_gemm<P>(  // qkv = LN1(x) Wqkv^T + bqkv
      Rows<P, true, LnXf<false>>{xf, D, M, {mean1, rstd1, w.ln1_s, w.ln1_b}},
      Rows<P, true>{w.wqkv, D, 3 * D}, OutBias{w.bqkv, qkv, 3 * D}, M, 3 * D, D, partial,
      arrivals, stream)));
  switch (D / H) {
    case 64: S3F_TRY((launch_attention<64, ROUND>(qkv, o, probs, B, N, D, H, stream))); break;
    case 128: S3F_TRY((launch_attention<128, ROUND>(qkv, o, probs, B, N, D, H, stream))); break;
    case 256: S3F_TRY((launch_attention<256, ROUND>(qkv, o, probs, B, N, D, H, stream))); break;
    default: return cudaErrorInvalidValue;
  }
  S3F_TRY((blk_gemm<P>(  // h1 = x + (o Wproj^T + bproj)
      Rows<P, true>{o, D, M}, Rows<P, true>{w.wproj, D, D},
      OutBiasRes<float>{w.bproj, xf, h1, D}, M, D, D, partial, arrivals, stream)));
  S3F_TRY(row_stats(h1, mean2, rstd2, M, D, stream));
  S3F_TRY((blk_gemm<P>(  // g1 = gelu(a1), a1 = LN2(h1) W1^T + b1
      Rows<P, true, LnXf<false>>{h1, D, M, {mean2, rstd2, w.ln2_s, w.ln2_b}},
      Rows<P, true>{w.w1, D, 4 * D}, OutBiasGelu{w.b1, a1, g1, 4 * D}, M, 4 * D, D, partial,
      arrivals, stream)));
  return blk_gemm<P>(  // y = h1 + (g1 W2^T + b2)
      Rows<P, true>{g1, 4 * D, M}, Rows<P, true>{w.w2, 4 * D, D},
      OutBiasRes<T>{w.b2, h1, y, D}, M, D, 4 * D, partial, arrivals, stream);
}

// ---------------------------------------------------------------------------
// Backward building blocks.
// ---------------------------------------------------------------------------

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

// The LayerNorm's weight gradients, column sums over the M token rows:
// out_b[n] = sum_m G[m, n] and out_s[n] = sum_m G[m, n] * xhat[m, n], xhat =
// (X - mean) * rstd. A block takes 32 columns; its 32 thread rows take every
// 32nd token row, and the 32 partial sums add up in a fixed order (no atomics:
// the same bits every run).
constexpr int CS_COLS = 32, CS_ROWS = 32;

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
      s += g * ((X[at] - mean[m]) * rstd[m]);
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
    out_s[n] = ts;
  }
}

cudaError_t ln_grads(const float* G, const float* X, const float* mean, const float* rstd,
                     float* out_s, float* out_b, int M, int ncols, cudaStream_t stream) {
  colsum_kernel<<<(ncols + CS_COLS - 1) / CS_COLS, CS_COLS * CS_ROWS, 0, stream>>>(
      G, X, mean, rstd, out_s, out_b, M, ncols);
  return cudaGetLastError();
}

// The attention backward: the row kernel (g_q, and cdt(g_s) to gs, B*H*N*ldn
// values of the compute dtype), then the column kernel (g_k, g_v).
template <int DH, bool ROUND>
cudaError_t launch_attention_bwd(const float* qkv, const float* P, const float* g_o, float* gs,
                                 float* g_qkv, int B, int N, int D, int H, cudaStream_t stream) {
  using C = Att<DH>;
  constexpr size_t cols_smem = 2 * ColsStage<DH, ROUND>::BYTES;
  static SmemOnce rows_once, cols_once;
  S3F_TRY(static_cast<cudaError_t>(rows_once(attn_bwd_rows_kernel<DH, ROUND>,
                                             rows_smem_bytes<DH>(kMaxN))));
  S3F_TRY(static_cast<cudaError_t>(cols_once(attn_bwd_cols_kernel<DH, ROUND>, cols_smem)));
  GsT<ROUND>* gst = reinterpret_cast<GsT<ROUND>*>(gs);
  const int ldn = gs_ld(N);
  const float scale = 1.0f / sqrtf(static_cast<float>(DH));
  attn_bwd_rows_kernel<DH, ROUND><<<dim3((N + C::BQ - 1) / C::BQ, H, B), ATT_THREADS,
                                    rows_smem_bytes<DH>(N), stream>>>(qkv, P, g_o, gst, ldn,
                                                                      g_qkv, N, D, scale);
  S3F_TRY(cudaGetLastError());
  attn_bwd_cols_kernel<DH, ROUND><<<dim3((N + C::BJ - 1) / C::BJ, H, B), ATT_THREADS, cols_smem,
                                    stream>>>(qkv, P, g_o, gst, ldn, g_qkv, N, D);
  return cudaGetLastError();
}

struct Residuals {  // what the training forward keeps, all f32
  float *qkv, *o, *h1, *a1, *probs;
};

struct BlockGrads {  // f32, in the weights' layout
  float *ln1_s, *ln1_b, *wqkv, *bqkv, *wproj, *bproj;
  float *ln2_s, *ln2_b, *w1, *b1, *w2, *b2;
};

size_t residual_floats(int B, int N, int D, int H) {
  const size_t md = static_cast<size_t>(B) * N * D;
  return 9 * md + static_cast<size_t>(B) * H * N * N;  // qkv 3, o, h1, a1 4; probs
}

// n floats rounded up to a 16-byte multiple: what follows starts aligned
size_t aligned4(size_t n) { return (n + 3) / 4 * 4; }

// the backward's GEMM partials: the largest of its four row GEMMs' and four
// weight gradients'
size_t backward_partial_floats(int M, int D) {
  return std::max({row_partial_floats(M, 4 * D, D), row_partial_floats(M, D, 4 * D),
                   row_partial_floats(M, D, D), row_partial_floats(M, D, 3 * D),
                   wgrad_partial_floats(M, D, 4 * D), wgrad_partial_floats(M, 4 * D, D),
                   wgrad_partial_floats(M, D, D), wgrad_partial_floats(M, 3 * D, D)});
}

// g_s in the compute dtype, [B*H, N, gs_ld(N)], in floats
size_t gs_floats(int B, int N, int H, int cdt_bf16) {
  const size_t n = static_cast<size_t>(B) * H * N * gs_ld(N);
  return cdt_bf16 ? (n + 1) / 2 : n;
}

size_t backward_floats(int B, int N, int D, int H, int cdt_bf16) {
  const int M = B * N;
  const size_t md = static_cast<size_t>(M) * D;
  // x and g in f32, g_a1 4, g_z2, g_h1, g_o, g_z1, g_qkv 3; the partials; the
  // arrival counters; LayerNorm stats; g_s
  return 2 * md + 4 * md + 4 * md + 3 * md + backward_partial_floats(M, D) + kMaxSplitTiles +
         4 * static_cast<size_t>(M) + gs_floats(B, N, H, cdt_bf16);
}

// The backward from the residuals (the TPU kernel's _bwd_kernel_res :394).
template <typename T, class P>
cudaError_t vit_block_bwd(const T* x, const T* g, T* gx, int B, int N, int D, int H,
                          const BlockWeights& w, const Residuals& r, const BlockGrads& gw,
                          float* scratch, cudaStream_t s) {
  constexpr bool ROUND = std::is_same<P, Bf16Mma>::value;
  const int M = B * N;
  const size_t md = static_cast<size_t>(M) * D;
  float* xf_buf = scratch;
  float* gy_buf = xf_buf + md;
  float* ga1 = gy_buf + md;
  float* gz2 = ga1 + 4 * md;
  float* gh1 = gz2 + md;
  float* go = gh1 + md;
  float* gz1 = go + md;
  float* gqkv = gz1 + md;
  float* partial = gqkv + 3 * md;
  unsigned* arrivals = reinterpret_cast<unsigned*>(partial + backward_partial_floats(M, D));
  float* mean1 = reinterpret_cast<float*>(arrivals + kMaxSplitTiles);
  float* rstd1 = mean1 + M;
  float* mean2 = rstd1 + M;
  float* rstd2 = mean2 + M;
  float* gs = rstd2 + M;

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
  S3F_TRY(row_stats(xf, mean1, rstd1, M, D, s, arrivals, kMaxSplitTiles));
  S3F_TRY(row_stats(r.h1, mean2, rstd2, M, D, s));
  const int row_blocks = (M + ROW_THREADS / 32 - 1) / (ROW_THREADS / 32);

  // MLP branch
  S3F_TRY((blk_gemm<P>(  // g_a1 = (g_y W2) gelu'(a1)
      Rows<P, true>{gy, D, M}, Rows<P, false>{w.w2, 4 * D, 4 * D}, OutGeluGrad{r.a1, ga1, 4 * D},
      M, 4 * D, D, partial, arrivals, s)));
  S3F_TRY((blk_wgrad<P>(  // dW2 = g_y^T gelu(a1), db2
      gy, Rows<P, false, GeluXf>{r.a1, 4 * D, 4 * D}, M, D, 4 * D, partial, arrivals, gw.w2,
      gw.b2, s)));
  S3F_TRY((blk_gemm<P>(  // g_z2 = g_a1 W1
      Rows<P, true>{ga1, 4 * D, M}, Rows<P, false>{w.w1, D, D}, OutStore{gz2, D}, M, D, 4 * D,
      partial, arrivals, s)));
  S3F_TRY((blk_wgrad<P>(  // dW1 = g_a1^T LN2(h1), db1
      ga1, Rows<P, false, LnXf<true>>{r.h1, D, D, {mean2, rstd2, w.ln2_s, w.ln2_b}}, M, 4 * D, D,
      partial, arrivals, gw.w1, gw.b1, s)));
  S3F_TRY(ln_grads(gz2, r.h1, mean2, rstd2, gw.ln2_s, gw.ln2_b, M, D, s));
  ln_bwd_kernel<float><<<row_blocks, ROW_THREADS, 0, s>>>(  // g_h1 = g_y + LN2'(g_z2)
      gz2, r.h1, mean2, rstd2, w.ln2_s, gy, gh1, M, D);
  S3F_TRY(cudaGetLastError());

  // attention branch
  S3F_TRY((blk_gemm<P>(  // g_o = g_h1 Wproj
      Rows<P, true>{gh1, D, M}, Rows<P, false>{w.wproj, D, D}, OutStore{go, D}, M, D, D, partial,
      arrivals, s)));
  S3F_TRY((blk_wgrad<P>(  // dWproj = g_h1^T o, dbproj
      gh1, Rows<P, false>{r.o, D, D}, M, D, D, partial, arrivals, gw.wproj, gw.bproj, s)));
  switch (D / H) {
    case 64: S3F_TRY((launch_attention_bwd<64, ROUND>(r.qkv, r.probs, go, gs, gqkv, B, N, D, H, s))); break;
    case 128: S3F_TRY((launch_attention_bwd<128, ROUND>(r.qkv, r.probs, go, gs, gqkv, B, N, D, H, s))); break;
    case 256: S3F_TRY((launch_attention_bwd<256, ROUND>(r.qkv, r.probs, go, gs, gqkv, B, N, D, H, s))); break;
    default: return cudaErrorInvalidValue;
  }
  S3F_TRY((blk_gemm<P>(  // g_z1 = g_qkv Wqkv
      Rows<P, true>{gqkv, 3 * D, M}, Rows<P, false>{w.wqkv, D, D}, OutStore{gz1, D}, M, D, 3 * D,
      partial, arrivals, s)));
  S3F_TRY((blk_wgrad<P>(  // dWqkv = g_qkv^T LN1(x), dbqkv
      gqkv, Rows<P, false, LnXf<true>>{xf, D, D, {mean1, rstd1, w.ln1_s, w.ln1_b}}, M, 3 * D, D,
      partial, arrivals, gw.wqkv, gw.bqkv, s)));
  S3F_TRY(ln_grads(gz1, xf, mean1, rstd1, gw.ln1_s, gw.ln1_b, M, D, s));
  ln_bwd_kernel<T><<<row_blocks, ROW_THREADS, 0, s>>>(  // g_x = g_h1 + LN1'(g_z1)
      gz1, xf, mean1, rstd1, w.ln1_s, gh1, gx, M, D);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Tensor-parallel halves: the chains above cut where the sums over the model
// ranks fall (Megatron's column- then row-parallel pair). A rank holds H of
// the heads (DL = H * DH columns of each of q, k and v, and the same inputs of
// proj) and F of fc1's outputs (fc2's inputs); D stays the model width. Every
// activation is f32 [M, *], M = B * N token rows.
//
//   tp_attn_fwd  row_stats(x); qkv = LN1(x) Wqkv^T + bqkv [M, 3 DL]; the
//                attention over the H heads; partial = o Wproj^T [M, D], no
//                bias and no residual (the caller sums it over the ranks)
//   tp_mlp_fwd   row_stats(h1); a1 = LN2(h1) W1^T + b1 [M, F], g1 =
//                gelu(a1); partial = g1 W2^T [M, D], no bias, no residual
//   tp_mlp_bwd   g_a1 = (g_y W2) gelu'(a1); dW2, db2; partial g_z2 = g_a1 W1;
//                dW1, db1
//   tp_attn_bwd  g_o = g_h1 Wproj; dWproj, dbproj; the attention backward;
//                partial g_z1 = g_qkv Wqkv; dWqkv, dbqkv
//   tp_ln_bwd    the LayerNorm backward with its residual, once the partial
//                is summed: out = res + LN'(g_z), and LN's weight gradients
//
// The GEMMs, the attention kernels and the row kernels are the whole block's,
// so a rank with all the heads and all of fc1 computes the whole block's
// numbers but for where the bias and the residual are added.
// ---------------------------------------------------------------------------

size_t tp_attn_fwd_floats(int M, int D, int DL) {
  return std::max(row_partial_floats(M, 3 * DL, D), row_partial_floats(M, D, DL)) +
         kMaxSplitTiles + 2 * static_cast<size_t>(M);
}

size_t tp_mlp_fwd_floats(int M, int D, int F) {
  return static_cast<size_t>(M) * F +
         std::max(row_partial_floats(M, F, D), row_partial_floats(M, D, F)) + kMaxSplitTiles +
         2 * static_cast<size_t>(M);
}

size_t tp_mlp_bwd_floats(int M, int D, int F) {
  return static_cast<size_t>(M) * F +
         std::max({row_partial_floats(M, F, D), wgrad_partial_floats(M, D, F),
                   row_partial_floats(M, D, F), wgrad_partial_floats(M, F, D)}) +
         kMaxSplitTiles + 2 * static_cast<size_t>(M);
}

size_t tp_attn_bwd_floats(int B, int N, int D, int H, int DL, int cdt_bf16) {
  const int M = B * N;
  return 4 * static_cast<size_t>(M) * DL + aligned4(gs_floats(B, N, H, cdt_bf16)) +
         std::max({row_partial_floats(M, DL, D), wgrad_partial_floats(M, D, DL),
                   row_partial_floats(M, D, 3 * DL), wgrad_partial_floats(M, 3 * DL, D)}) +
         kMaxSplitTiles + 2 * static_cast<size_t>(M);
}

template <class P>
cudaError_t attention_of(int DH, const float* qkv, float* o, float* probs, int B, int N, int DL,
                         int H, cudaStream_t s) {
  constexpr bool ROUND = std::is_same<P, Bf16Mma>::value;
  switch (DH) {
    case 64: return launch_attention<64, ROUND>(qkv, o, probs, B, N, DL, H, s);
    case 128: return launch_attention<128, ROUND>(qkv, o, probs, B, N, DL, H, s);
    case 256: return launch_attention<256, ROUND>(qkv, o, probs, B, N, DL, H, s);
    default: return cudaErrorInvalidValue;
  }
}

template <class P>
cudaError_t attention_bwd_of(int DH, const float* qkv, const float* probs, const float* go,
                             float* gs, float* gqkv, int B, int N, int DL, int H,
                             cudaStream_t s) {
  constexpr bool ROUND = std::is_same<P, Bf16Mma>::value;
  switch (DH) {
    case 64: return launch_attention_bwd<64, ROUND>(qkv, probs, go, gs, gqkv, B, N, DL, H, s);
    case 128: return launch_attention_bwd<128, ROUND>(qkv, probs, go, gs, gqkv, B, N, DL, H, s);
    case 256: return launch_attention_bwd<256, ROUND>(qkv, probs, go, gs, gqkv, B, N, DL, H, s);
    default: return cudaErrorInvalidValue;
  }
}

// w: ln1_s, ln1_b, wqkv [3 DL, D], bqkv [3 DL], wproj [D, DL]
template <class P>
cudaError_t tp_attn_fwd(const float* x, float* out, int B, int N, int D, int H, int DH,
                        const float* const* w, float* qkv, float* o, float* probs, float* work,
                        cudaStream_t s) {
  const int M = B * N, DL = H * DH;
  float* partial = work;
  unsigned* arrivals = reinterpret_cast<unsigned*>(
      partial + std::max(row_partial_floats(M, 3 * DL, D), row_partial_floats(M, D, DL)));
  float* mean1 = reinterpret_cast<float*>(arrivals + kMaxSplitTiles);
  float* rstd1 = mean1 + M;
  S3F_TRY(row_stats(x, mean1, rstd1, M, D, s, arrivals, kMaxSplitTiles));
  S3F_TRY((blk_gemm<P>(  // qkv = LN1(x) Wqkv^T + bqkv, the rank's heads
      Rows<P, true, LnXf<false>>{x, D, M, {mean1, rstd1, w[0], w[1]}},
      Rows<P, true>{w[2], D, 3 * DL}, OutBias{w[3], qkv, 3 * DL}, M, 3 * DL, D, partial,
      arrivals, s)));
  S3F_TRY(attention_of<P>(DH, qkv, o, probs, B, N, DL, H, s));
  return blk_gemm<P>(  // partial = o Wproj^T over the rank's DL inputs
      Rows<P, true>{o, DL, M}, Rows<P, true>{w[4], DL, D}, OutStore{out, D}, M, D, DL, partial,
      arrivals, s);
}

// w: ln2_s, ln2_b, w1 [F, D], b1 [F], w2 [D, F]
template <class P>
cudaError_t tp_mlp_fwd(const float* h1, float* out, int B, int N, int D, int F,
                       const float* const* w, float* a1, float* work, cudaStream_t s) {
  const int M = B * N;
  float* g1 = work;
  float* partial = g1 + static_cast<size_t>(M) * F;
  unsigned* arrivals = reinterpret_cast<unsigned*>(
      partial + std::max(row_partial_floats(M, F, D), row_partial_floats(M, D, F)));
  float* mean2 = reinterpret_cast<float*>(arrivals + kMaxSplitTiles);
  float* rstd2 = mean2 + M;
  S3F_TRY(row_stats(h1, mean2, rstd2, M, D, s, arrivals, kMaxSplitTiles));
  S3F_TRY((blk_gemm<P>(  // g1 = gelu(a1), a1 = LN2(h1) W1^T + b1, the rank's F columns
      Rows<P, true, LnXf<false>>{h1, D, M, {mean2, rstd2, w[0], w[1]}},
      Rows<P, true>{w[2], D, F}, OutBiasGelu{w[3], a1, g1, F}, M, F, D, partial, arrivals, s)));
  return blk_gemm<P>(  // partial = g1 W2^T over the rank's F inputs
      Rows<P, true>{g1, F, M}, Rows<P, true>{w[4], F, D}, OutStore{out, D}, M, D, F, partial,
      arrivals, s);
}

// w: ln2_s, ln2_b, w1 [F, D], w2 [D, F]; gw: w1, b1, w2, b2
template <class P>
cudaError_t tp_mlp_bwd(const float* gy, const float* h1, const float* a1, float* gz2, int B,
                       int N, int D, int F, const float* const* w, float* const* gw, float* work,
                       cudaStream_t s) {
  const int M = B * N;
  float* ga1 = work;
  float* partial = ga1 + static_cast<size_t>(M) * F;
  unsigned* arrivals = reinterpret_cast<unsigned*>(
      partial + std::max({row_partial_floats(M, F, D), wgrad_partial_floats(M, D, F),
                          row_partial_floats(M, D, F), wgrad_partial_floats(M, F, D)}));
  float* mean2 = reinterpret_cast<float*>(arrivals + kMaxSplitTiles);
  float* rstd2 = mean2 + M;
  S3F_TRY(row_stats(h1, mean2, rstd2, M, D, s, arrivals, kMaxSplitTiles));
  S3F_TRY((blk_gemm<P>(  // g_a1 = (g_y W2) gelu'(a1)
      Rows<P, true>{gy, D, M}, Rows<P, false>{w[3], F, F}, OutGeluGrad{a1, ga1, F}, M, F, D,
      partial, arrivals, s)));
  S3F_TRY((blk_wgrad<P>(  // dW2 = g_y^T gelu(a1), db2
      gy, Rows<P, false, GeluXf>{a1, F, F}, M, D, F, partial, arrivals, gw[2], gw[3], s)));
  S3F_TRY((blk_gemm<P>(  // partial g_z2 = g_a1 W1
      Rows<P, true>{ga1, F, M}, Rows<P, false>{w[2], D, D}, OutStore{gz2, D}, M, D, F, partial,
      arrivals, s)));
  return blk_wgrad<P>(  // dW1 = g_a1^T LN2(h1), db1
      ga1, Rows<P, false, LnXf<true>>{h1, D, D, {mean2, rstd2, w[0], w[1]}}, M, F, D, partial,
      arrivals, gw[0], gw[1], s);
}

// w: ln1_s, ln1_b, wqkv [3 DL, D], wproj [D, DL]; gw: wqkv, bqkv, wproj, bproj
template <class P>
cudaError_t tp_attn_bwd(const float* x, const float* gh1, const float* qkv, const float* o,
                        const float* probs, float* gz1, int B, int N, int D, int H, int DH,
                        const float* const* w, float* const* gw, float* work, cudaStream_t s) {
  constexpr bool ROUND = std::is_same<P, Bf16Mma>::value;
  const int M = B * N, DL = H * DH;
  const size_t mdl = static_cast<size_t>(M) * DL;
  float* go = work;
  float* gqkv = go + mdl;
  float* gs = gqkv + 3 * mdl;
  float* partial = gs + aligned4(gs_floats(B, N, H, ROUND));
  unsigned* arrivals = reinterpret_cast<unsigned*>(
      partial + std::max({row_partial_floats(M, DL, D), wgrad_partial_floats(M, D, DL),
                          row_partial_floats(M, D, 3 * DL), wgrad_partial_floats(M, 3 * DL, D)}));
  float* mean1 = reinterpret_cast<float*>(arrivals + kMaxSplitTiles);
  float* rstd1 = mean1 + M;
  S3F_TRY(row_stats(x, mean1, rstd1, M, D, s, arrivals, kMaxSplitTiles));
  S3F_TRY((blk_gemm<P>(  // g_o = g_h1 Wproj, the rank's DL columns
      Rows<P, true>{gh1, D, M}, Rows<P, false>{w[3], DL, DL}, OutStore{go, DL}, M, DL, D,
      partial, arrivals, s)));
  S3F_TRY((blk_wgrad<P>(  // dWproj = g_h1^T o, dbproj
      gh1, Rows<P, false>{o, DL, DL}, M, D, DL, partial, arrivals, gw[2], gw[3], s)));
  S3F_TRY(attention_bwd_of<P>(DH, qkv, probs, go, gs, gqkv, B, N, DL, H, s));
  S3F_TRY((blk_gemm<P>(  // partial g_z1 = g_qkv Wqkv
      Rows<P, true>{gqkv, 3 * DL, M}, Rows<P, false>{w[2], D, D}, OutStore{gz1, D}, M, D, 3 * DL,
      partial, arrivals, s)));
  return blk_wgrad<P>(  // dWqkv = g_qkv^T LN1(x), dbqkv
      gqkv, Rows<P, false, LnXf<true>>{x, D, D, {mean1, rstd1, w[0], w[1]}}, M, 3 * DL, D,
      partial, arrivals, gw[0], gw[1], s);
}

// out = res + LN'(g_z) for the LayerNorm of X (statistics re-derived), and
// the LayerNorm's weight gradients gs = sum g_z xhat, gb = sum g_z
cudaError_t tp_ln_bwd(const float* gz, const float* X, const float* ln_s, const float* res,
                      float* out, float* gs, float* gb, int M, int D, float* work,
                      cudaStream_t s) {
  float* mean = work;
  float* rstd = mean + M;
  S3F_TRY(row_stats(X, mean, rstd, M, D, s));
  S3F_TRY(ln_grads(gz, X, mean, rstd, gs, gb, M, D, s));
  const int row_blocks = (M + ROW_THREADS / 32 - 1) / (ROW_THREADS / 32);
  ln_bwd_kernel<float><<<row_blocks, ROW_THREADS, 0, s>>>(gz, X, mean, rstd, ln_s, res, out, M, D);
  return cudaGetLastError();
}

// the products' route P alone: Tf32x3 for an f32 compute dtype, Bf16Mma for bf16
template <typename Fn>
cudaError_t dispatch_route(int cdt_bf16, Fn&& fn) {
  return cdt_bf16 ? fn(Bf16Mma{}) : fn(Tf32x3{});
}

bool bad_tp_shape(int B, int N, int D, int H, int DH) {
  return B < 1 || N < 1 || N > kMaxN || H < 1 || D < 4 || D % 4 != 0 ||
         (DH != 64 && DH != 128 && DH != 256);
}

bool bad_tp_mlp(int B, int N, int D, int F) {
  return B < 1 || N < 1 || D < 4 || D % 4 != 0 || F < 4 || F % 4 != 0;
}

// Calls fn(T{}, P{}) for x's dtype T and the products' route P (Tf32x3 for an
// f32 compute dtype, Bf16Mma for bf16).
template <typename Fn>
cudaError_t dispatch(int x_bf16, int cdt_bf16, Fn&& fn) {
  if (x_bf16) {
    return cdt_bf16 ? fn(__nv_bfloat16{}, Bf16Mma{}) : fn(__nv_bfloat16{}, Tf32x3{});
  }
  return cdt_bf16 ? fn(float{}, Bf16Mma{}) : fn(float{}, Tf32x3{});
}

// D % 4: the epilogues' float4 runs (a head_dim of 64, 128 or 256 makes D a
// multiple of 64)
bool bad_shape(int B, int N, int D, int H) {
  return B < 1 || N < 1 || N > kMaxN || H < 1 || D % H != 0 || D % 4 != 0;
}

BlockWeights weights_of(const void* const* p) {
  const auto f = [p](int i) { return static_cast<const float*>(p[i]); };
  return BlockWeights{f(0), f(1), f(2), f(3), f(4), f(5), f(6), f(7), f(8), f(9), f(10), f(11)};
}

BlockGrads grads_of(void* const* p) {
  const auto f = [p](int i) { return static_cast<float*>(p[i]); };
  return BlockGrads{f(0), f(1), f(2), f(3), f(4), f(5), f(6), f(7), f(8), f(9), f(10), f(11)};
}

// Residual buffers carved from one f32 region, in the order qkv, o, h1, a1,
// probs (each of the first four starts on a 16-byte boundary for cp.async).
Residuals residuals_in(float* base, int B, int N, int D) {
  const size_t md = static_cast<size_t>(B) * N * D;
  Residuals r;
  r.qkv = base;
  r.o = r.qkv + 3 * md;
  r.h1 = r.o + md;
  r.a1 = r.h1 + md;
  r.probs = r.a1 + 4 * md;
  return r;
}

}  // namespace

extern "C" {

// x, y: [B, N, D] contiguous, f32 (x_bf16 == 0) or bf16 (x_bf16 == 1), 16-byte
// aligned. cdt_bf16: round matmul operands to bf16. weights: the twelve f32
// weight pointers (contiguous, 16-byte aligned; Linear weights [out, in]) in
// the order ln1_s, ln1_b, wqkv, bqkv, wproj, bproj, ln2_s, ln2_b, w1, b1, w2,
// b2. scratch: s3f_vit_block_fwd_scratch_floats(B, N, D, H, 1) f32. Limits:
// 1 <= N <= 512, D / H in {64, 128, 256}.
int s3f_vit_block_fwd(const void* x, void* y, int x_bf16, int cdt_bf16, int B, int N, int D,
                      int H, const void* const* weights, void* scratch, void* stream) {
  if (bad_shape(B, N, D, H)) return cudaErrorInvalidValue;
  const BlockWeights w = weights_of(weights);
  const size_t md = static_cast<size_t>(B) * N * D;
  float* qkv = static_cast<float*>(scratch);
  float* o = qkv + 3 * md;
  float* h1 = o + md;
  float* work = h1 + md;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dispatch(x_bf16, cdt_bf16, [&](auto tag, auto route) {
    using T = decltype(tag);
    return vit_block<T, decltype(route)>(static_cast<const T*>(x), static_cast<T*>(y), B, N, D, H,
                                         w, qkv, o, h1, nullptr, nullptr, work, s);
  });
}

// The training forward: as s3f_vit_block_fwd, and it keeps the residuals in
// `res`, f32, in the order qkv [B*N, 3D], o [B*N, D], h1 [B*N, D], a1
// [B*N, 4D], probs [B, H, N, N] (s3f_vit_block_residual_floats of them).
// scratch: s3f_vit_block_fwd_scratch_floats(B, N, D, H, 0) f32.
int s3f_vit_block_fwd_res(const void* x, void* y, int x_bf16, int cdt_bf16, int B, int N, int D,
                          int H, const void* const* weights, void* res, void* scratch,
                          void* stream) {
  if (bad_shape(B, N, D, H)) return cudaErrorInvalidValue;
  const BlockWeights w = weights_of(weights);
  const Residuals r = residuals_in(static_cast<float*>(res), B, N, D);
  float* work = static_cast<float*>(scratch);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dispatch(x_bf16, cdt_bf16, [&](auto tag, auto route) {
    using T = decltype(tag);
    return vit_block<T, decltype(route)>(static_cast<const T*>(x), static_cast<T*>(y), B, N, D, H,
                                         w, r.qkv, r.o, r.h1, r.a1, r.probs, work, s);
  });
}

long long s3f_vit_block_residual_floats(int B, int N, int D, int H) {
  return static_cast<long long>(residual_floats(B, N, D, H));
}

// f32 scratch of s3f_vit_block_fwd (serving 1) and of s3f_vit_block_fwd_res (0).
long long s3f_vit_block_fwd_scratch_floats(int B, int N, int D, int H, int serving) {
  (void)H;
  return static_cast<long long>(forward_floats(B, N, D, serving));
}

// The grid of each GEMM of the chain at this shape: (output tiles, contraction
// chunks) of qkv, proj, fc1, fc2, g_a1, g_z2, g_o, g_z1, dW2, dW1, dWproj,
// dWqkv, in that order (24 ints to out).
void s3f_vit_block_gemm_grids(int B, int N, int D, int* out) {
  const int M = B * N;
  const int shapes[12][4] = {  // rows, cols, contraction, weight gradient
      {M, 3 * D, D, 0}, {M, D, D, 0},     {M, 4 * D, D, 0}, {M, D, 4 * D, 0},
      {M, 4 * D, D, 0}, {M, D, 4 * D, 0}, {M, D, D, 0},     {M, D, 3 * D, 0},
      {D, 4 * D, M, 1}, {4 * D, D, M, 1}, {D, D, M, 1},     {3 * D, D, M, 1}};
  for (int i = 0; i < 12; ++i) {
    const int tiles = tiles_of(shapes[i][0], shapes[i][1]);
    out[2 * i] = tiles;
    out[2 * i + 1] = split_of(tiles, shapes[i][2], shapes[i][3] ? kWgradWaves : kRowWaves).chunks;
  }
}

// f32 scratch of s3f_vit_block_bwd_res, and of s3f_vit_block_bwd (recompute),
// for the compute dtype cdt_bf16 (g_s is kept in it).
long long s3f_vit_block_bwd_scratch_floats(int B, int N, int D, int H, int recompute,
                                           int cdt_bf16) {
  size_t n = backward_floats(B, N, D, H, cdt_bf16);
  if (recompute)  // the residuals, the forward's scratch and y
    n += aligned4(residual_floats(B, N, D, H)) + forward_floats(B, N, D, 0) +
         static_cast<size_t>(B) * N * D;
  return static_cast<long long>(n);
}

// The residual backward: g [B, N, D] in x's dtype; gx out in x's dtype;
// grads: twelve f32 outputs in the weights' shapes and order (overwritten);
// res: the training forward's residuals. All 16-byte aligned.
int s3f_vit_block_bwd_res(const void* x, const void* g, void* gx, int x_bf16, int cdt_bf16,
                          int B, int N, int D, int H, const void* const* weights,
                          const void* res, void* const* grads, void* scratch, void* stream) {
  if (bad_shape(B, N, D, H)) return cudaErrorInvalidValue;
  const BlockWeights w = weights_of(weights);
  const Residuals r = residuals_in(const_cast<float*>(static_cast<const float*>(res)), B, N, D);
  const BlockGrads gw = grads_of(grads);
  float* sc = static_cast<float*>(scratch);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dispatch(x_bf16, cdt_bf16, [&](auto tag, auto route) {
    using T = decltype(tag);
    return vit_block_bwd<T, decltype(route)>(static_cast<const T*>(x), static_cast<const T*>(g),
                                             static_cast<T*>(gx), B, N, D, H, w, r, gw, sc, s);
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
  float* sc = static_cast<float*>(scratch);
  const Residuals r = residuals_in(sc, B, N, D);
  float* work = sc + aligned4(residual_floats(B, N, D, H));
  float* y = work + forward_floats(B, N, D, 0);
  float* bwd = y + static_cast<size_t>(B) * N * D;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dispatch(x_bf16, cdt_bf16, [&](auto tag, auto route) {
    using T = decltype(tag);
    using P = decltype(route);
    const T* xt = static_cast<const T*>(x);
    S3F_TRY((vit_block<T, P>(xt, reinterpret_cast<T*>(y), B, N, D, H, w, r.qkv, r.o, r.h1, r.a1,
                             r.probs, work, s)));
    return vit_block_bwd<T, P>(xt, static_cast<const T*>(g), static_cast<T*>(gx), B, N, D, H, w,
                               r, gw, bwd, s);
  });
}

// Tensor-parallel halves (see "Tensor-parallel halves" above). Every
// activation and output is f32, contiguous, 16-byte aligned; M = B * N.
// H heads of DH (64, 128 or 256) a rank, DL = H * DH; F of fc1's outputs a
// rank (a multiple of 4). weights / grads: f32, in the orders stated.

// x [M, D] -> out [M, D] (the attention branch's partial sum, before bias and
// residual); keeps qkv [M, 3 DL], o [M, DL] and probs [B, H, N, N].
// weights: ln1_s, ln1_b, wqkv [3 DL, D], bqkv, wproj [D, DL].
int s3f_vit_block_tp_attn_fwd(const void* x, void* out, int cdt_bf16, int B, int N, int D,
                              int H, int DH, const void* const* weights, void* qkv, void* o,
                              void* probs, void* scratch, void* stream) {
  if (bad_tp_shape(B, N, D, H, DH)) return cudaErrorInvalidValue;
  const float* const* w = reinterpret_cast<const float* const*>(weights);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dispatch_route(cdt_bf16, [&](auto route) {
    return tp_attn_fwd<decltype(route)>(
        static_cast<const float*>(x), static_cast<float*>(out), B, N, D, H, DH, w,
        static_cast<float*>(qkv), static_cast<float*>(o), static_cast<float*>(probs),
        static_cast<float*>(scratch), s);
  });
}

// h1 [M, D] -> out [M, D] (the MLP's partial sum, before bias and residual);
// keeps a1 [M, F] where a1 is not null. weights: ln2_s, ln2_b, w1 [F, D],
// b1, w2 [D, F].
int s3f_vit_block_tp_mlp_fwd(const void* h1, void* out, int cdt_bf16, int B, int N, int D, int F,
                             const void* const* weights, void* a1, void* scratch, void* stream) {
  if (bad_tp_mlp(B, N, D, F)) return cudaErrorInvalidValue;
  const float* const* w = reinterpret_cast<const float* const*>(weights);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dispatch_route(cdt_bf16, [&](auto route) {
    return tp_mlp_fwd<decltype(route)>(static_cast<const float*>(h1), static_cast<float*>(out), B,
                                       N, D, F, w, static_cast<float*>(a1),
                                       static_cast<float*>(scratch), s);
  });
}

// g [M, D], h1, a1 [M, F] -> gz2 [M, D] (the partial g_z2); grads: w1, b1,
// w2, b2 (overwritten). weights: ln2_s, ln2_b, w1, w2.
int s3f_vit_block_tp_mlp_bwd(const void* g, const void* h1, const void* a1, void* gz2,
                             int cdt_bf16, int B, int N, int D, int F, const void* const* weights,
                             void* const* grads, void* scratch, void* stream) {
  if (bad_tp_mlp(B, N, D, F)) return cudaErrorInvalidValue;
  const float* const* w = reinterpret_cast<const float* const*>(weights);
  float* const* gw = reinterpret_cast<float* const*>(grads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dispatch_route(cdt_bf16, [&](auto route) {
    return tp_mlp_bwd<decltype(route)>(static_cast<const float*>(g), static_cast<const float*>(h1),
                                       static_cast<const float*>(a1), static_cast<float*>(gz2), B,
                                       N, D, F, w, gw, static_cast<float*>(scratch), s);
  });
}

// x, gh1 [M, D], the forward's qkv, o, probs -> gz1 [M, D] (the partial
// g_z1); grads: wqkv, bqkv, wproj, bproj (overwritten). weights: ln1_s,
// ln1_b, wqkv, wproj.
int s3f_vit_block_tp_attn_bwd(const void* x, const void* gh1, const void* qkv, const void* o,
                              const void* probs, void* gz1, int cdt_bf16, int B, int N, int D,
                              int H, int DH, const void* const* weights, void* const* grads,
                              void* scratch, void* stream) {
  if (bad_tp_shape(B, N, D, H, DH)) return cudaErrorInvalidValue;
  const float* const* w = reinterpret_cast<const float* const*>(weights);
  float* const* gw = reinterpret_cast<float* const*>(grads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dispatch_route(cdt_bf16, [&](auto route) {
    return tp_attn_bwd<decltype(route)>(
        static_cast<const float*>(x), static_cast<const float*>(gh1),
        static_cast<const float*>(qkv), static_cast<const float*>(o),
        static_cast<const float*>(probs), static_cast<float*>(gz1), B, N, D, H, DH, w, gw,
        static_cast<float*>(scratch), s);
  });
}

// out [M, D] = res + LN'(gz) for the LayerNorm of X [M, D] with scale ln_s;
// gs, gb [D]: the LayerNorm's weight gradients.
int s3f_vit_block_tp_ln_bwd(const void* gz, const void* X, const void* ln_s, const void* res,
                            void* out, void* gs, void* gb, int M, int D, void* scratch,
                            void* stream) {
  if (M < 1 || D < 1) return cudaErrorInvalidValue;
  return tp_ln_bwd(static_cast<const float*>(gz), static_cast<const float*>(X),
                   static_cast<const float*>(ln_s), static_cast<const float*>(res),
                   static_cast<float*>(out), static_cast<float*>(gs), static_cast<float*>(gb), M,
                   D, static_cast<float*>(scratch), static_cast<cudaStream_t>(stream));
}

// f32 scratch of the halves: which 0 attention forward, 1 MLP forward, 2 MLP
// backward, 3 attention backward, 4 LayerNorm backward; W is DL for the
// attention halves, F for the MLP halves.
long long s3f_vit_block_tp_scratch_floats(int which, int B, int N, int D, int H, int W,
                                          int cdt_bf16) {
  const int M = B * N;
  switch (which) {
    case 0: return static_cast<long long>(tp_attn_fwd_floats(M, D, W));
    case 1: return static_cast<long long>(tp_mlp_fwd_floats(M, D, W));
    case 2: return static_cast<long long>(tp_mlp_bwd_floats(M, D, W));
    case 3: return static_cast<long long>(tp_attn_bwd_floats(B, N, D, H, W, cdt_bf16));
    default: return 2LL * M;
  }
}

}  // extern "C"
