// Point-Transformer vector attention on pre-gathered neighbours, forward and
// backward, for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernels of simple3dformer_tpu/kernels/vector_attention.py on
// its f32 route, fused_vector_attention_pregathered: the forward (_fwd_kernel_pg
// :374 over _chain_fwd :80, pallas_call :473) and the backward (_bwd_kernel_pg
// :387, pallas_call :506). Rows r = (point, neighbour) of R = B*N*K, D channels,
// weights in the Linear layout [out, in]:
//
//   hd  = relu(rel[r] . wd1[i] + bd1[i])           fc_delta's first layer, 3 -> D
//   pos = hd wd2^T + bd2;  x = q[r / K] - k + pos;  u = v + pos
//   hg  = relu(x wg1^T + bg1);  z = (hg wg2^T + bg2) * (1 / sqrt(D))
//   a   = softmax of z over the K rows of a point, per channel
//   out[p] = sum over the K rows of p of a * u
//
// Backward from g [B*N, D] and the forward's x, u, hg, a:
//
//   gv = a g;  gl = a (g u - sum_K(a g u)) / sqrt(D)
//   g_hg = (gl wg2) [hg > 0];   g_x = g_hg wg1;  gk = -g_x;  gq = sum_K g_x
//   g_pos = g_x + gv;  g_hd = (g_pos wd2) [hd > 0];  grel = g_hd wd1
//   gwg2 = gl^T hg, gwg1 = g_hg^T x, gwd2 = g_pos^T hd, gwd1 = g_hd^T rel,
//   each bias gradient the column sum of the same left factor.
//
// The TPU kernel runs the whole chain per tile of 32 points in VMEM, its four
// weight matrices resident. Here D = 512 makes each weight matrix 1 MB in f32
// and a block has 227 KB of shared memory, so the chain is a sequence of tiled
// GEMM launches with f32 [R, D] intermediates in device memory:
//
//   forward   pos GEMM (hd formed from rel while the operand is staged; x and u
//             written by the epilogue), hg GEMM, logits GEMM whose epilogue takes
//             the softmax over K and the sum over K of a * u: its row tile holds
//             whole groups of K rows (128 / K points). x, u, hg and (for training)
//             a stay for the backward, as the TPU's _resid variant keeps them;
//             the backward recomputes nothing but hd.
//   backward  the softmax backward (one thread per point and channel), three
//             GEMMs against the weights (g_hg, g_x with gk, g_pos and the group
//             sum gq in its epilogue, g_hd), four weight-gradient GEMMs, and
//             fc_delta's first layer (grel, gwd1, gbd1) by row reductions.
//
// Every product is an f32 FMA GEMM tile of 128 x 128 outputs, 256 threads with
// 8 x 8 outputs each, the contraction staged 8 at a time in shared memory and
// double-buffered (the next tile's loads in flight during the current one's
// products). At B=64, N=1024, K=16, D=512 the products are 1.65 TFLOP a
// forward against 4.4 GB of inputs: the operation count bounds it on this card,
// not bytes. bf16 tensor cores (wgmma) and TMA are later work.
//
// The weight gradients sum over all R rows (1,048,576 at level 0) into D x D
// outputs: one block per output tile would give 16 blocks at D = 512. So each
// sum is split into fixed chunks of rows (blockIdx.z), each writes its partial
// sums, and a second pass adds the partials in chunk order. No float atomics:
// two runs give the same bits. Rows are bounds-checked, never padded.
//
// Every entry returns the first CUDA error of its launches (0 on success).

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int BM = 128, BN = 128, BK = 8, THREADS = 256;
constexpr int LDS = BM + 4;  // a staged row of 128: 16-byte aligned, conflict-free stores
constexpr int LDE = BN + 4;  // a row of the epilogue tile
constexpr int STAGE_FLOATS = 2 * 2 * BK * LDS;  // A and B, two buffers each
constexpr size_t STAGE_BYTES = STAGE_FLOATS * sizeof(float);
constexpr size_t GROUP_BYTES = static_cast<size_t>(BM) * LDE * sizeof(float);

// fc_delta's first layer before the ReLU, the same expression wherever it is
// formed (the pos GEMM's operand, the wd2 gradient's operand, the g_hd mask)
__device__ __forceinline__ float hd_pre(const float* rel, const float* w, float b) {
  return __fadd_rn(fmaf(rel[2], w[2], fmaf(rel[1], w[1], __fmul_rn(rel[0], w[0]))), b);
}

// ---------------------------------------------------------------------------
// GEMM operands. Each fills one staged tile S[BK][LDS] with S[kk][m] =
// element(m0 + m, k0 + kk), zero outside the matrix, in two steps: fetch (device
// memory to four registers a thread) and put (registers to shared memory).
// ---------------------------------------------------------------------------

// element (m, k) = p[m * ld + k]: the contraction contiguous (rows of
// activations, weights as Linear layers hold them). k0 + 8 <= the contraction
// length, a multiple of 8.
struct KRows {
  const float* p;
  long long ld;
  int m_lim;
  __device__ __forceinline__ void fetch(float4& r, int m0, int k0, int) const {
    const int m = threadIdx.x >> 1, kk = (threadIdx.x & 1) * 4;
    r = m0 + m < m_lim
            ? *reinterpret_cast<const float4*>(p + static_cast<long long>(m0 + m) * ld + k0 + kk)
            : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  __device__ __forceinline__ void put(float* S, const float4& r) const {
    const int m = threadIdx.x >> 1, kk = (threadIdx.x & 1) * 4;
    S[(kk + 0) * LDS + m] = r.x;
    S[(kk + 1) * LDS + m] = r.y;
    S[(kk + 2) * LDS + m] = r.z;
    S[(kk + 3) * LDS + m] = r.w;
  }
};

// element (m, k) = p[k * ld + m]: the tile's m contiguous (a weight read
// transposed; the rows of an activation as the contraction of a weight
// gradient). m_lim is a multiple of 4; rows k at or beyond k_lim read as zero.
struct MRows {
  const float* p;
  long long ld;
  int m_lim;
  __device__ __forceinline__ void fetch(float4& r, int m0, int k0, int k_lim) const {
    const int kk = threadIdx.x >> 5, m = (threadIdx.x & 31) * 4;
    r = (k0 + kk < k_lim && m0 + m < m_lim)
            ? *reinterpret_cast<const float4*>(p + static_cast<long long>(k0 + kk) * ld + m0 + m)
            : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  __device__ __forceinline__ void put(float* S, const float4& r) const {
    const int kk = threadIdx.x >> 5, m = (threadIdx.x & 31) * 4;
    *reinterpret_cast<float4*>(S + kk * LDS + m) = r;
  }
};

// hd = relu(hd_pre) computed from rel [R, 3], wd1 [D, 3], bd1 [D].
struct Hd {
  const float* rel;
  const float* wd1;
  const float* bd1;
  int rows, d;
  __device__ __forceinline__ float at(const float* rr, int i) const {
    return fmaxf(hd_pre(rr, wd1 + 3 * i, bd1[i]), 0.f);
  }
};

// hd as the A operand of the pos GEMM: element (m = row, k = channel)
struct HdByRow : Hd {
  __device__ __forceinline__ void fetch(float4& r, int m0, int k0, int) const {
    const int m = threadIdx.x >> 1, kk = (threadIdx.x & 1) * 4;
    const int row = m0 + m, i = k0 + kk;
    if (row < rows) {
      const float* rr = rel + 3LL * row;
      r = make_float4(at(rr, i), at(rr, i + 1), at(rr, i + 2), at(rr, i + 3));
    } else {
      r = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
  __device__ __forceinline__ void put(float* S, const float4& r) const {
    KRows{}.put(S, r);
  }
};

// hd as the B operand of wd2's weight gradient: element (m = channel, k = row)
struct HdByChannel : Hd {
  __device__ __forceinline__ void fetch(float4& r, int m0, int k0, int k_lim) const {
    const int kk = threadIdx.x >> 5, m = (threadIdx.x & 31) * 4;
    const int row = k0 + kk, i = m0 + m;
    if (row < k_lim && i < d) {
      const float* rr = rel + 3LL * row;
      r = make_float4(at(rr, i), at(rr, i + 1), at(rr, i + 2), at(rr, i + 3));
    } else {
      r = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
  __device__ __forceinline__ void put(float* S, const float4& r) const {
    MRows{}.put(S, r);
  }
};

// A thread's outputs: rows (i < 4 ? 0 : 64) + 4 ty + i % 4 and columns
// (j < 4 ? 0 : 64) + 4 tx + j % 4 of the tile, ty = thread / 16, tx = thread % 16.
__device__ __forceinline__ int row_of(int i) {
  return (i < 4 ? 0 : 64) + (threadIdx.x >> 4) * 4 + (i & 3);
}
__device__ __forceinline__ int col_of(int j) {
  return (j < 4 ? 0 : 64) + (threadIdx.x & 15) * 4 + (j & 3);
}

// One 128 x 128 tile of C = sum_k A(m, k) B(n, k) over k in [kb, ke), with
// tile_rows rows a tile (the epilogue may take fewer than BM), ncol column
// tiles (blockIdx.x = row tile * ncol + column tile), chunk rows of the
// contraction per blockIdx.z. SUM_A: the first column tile's blocks also sum A
// over k for each of its rows (a bias gradient beside a weight gradient).
template <class OpA, class OpB, class Epi, bool SUM_A>
__global__ void __launch_bounds__(THREADS)
va_gemm_kernel(OpA opa, OpB opb, Epi epi, int tile_rows, int ncol, int k_len, int chunk) {
  extern __shared__ __align__(16) float smem[];
  float* As = smem;
  float* Bs = smem + 2 * BK * LDS;
  const int mt = blockIdx.x / ncol, nt = blockIdx.x % ncol;
  const int m0 = mt * tile_rows, n0 = nt * BN;
  const int kb = blockIdx.z * chunk, ke = min(kb + chunk, k_len);
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const bool sum_a = SUM_A && nt == 0 && tx == 0;

  float acc[8][8];
  float asum[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    asum[i] = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  }
  float4 ra, rb;
  if (kb < ke) {
    opa.fetch(ra, m0, kb, ke);
    opb.fetch(rb, n0, kb, ke);
    opa.put(As, ra);
    opb.put(Bs, rb);
  }
  __syncthreads();
  int buf = 0;
  for (int k0 = kb; k0 < ke; k0 += BK) {
    const bool more = k0 + BK < ke;
    if (more) {
      opa.fetch(ra, m0, k0 + BK, ke);
      opb.fetch(rb, n0, k0 + BK, ke);
    }
    const float* as = As + buf * BK * LDS;
    const float* bs = Bs + buf * BK * LDS;
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(as + kk * LDS + ty * 4);
      const float4 a1 = *reinterpret_cast<const float4*>(as + kk * LDS + 64 + ty * 4);
      const float4 b0 = *reinterpret_cast<const float4*>(bs + kk * LDS + tx * 4);
      const float4 b1 = *reinterpret_cast<const float4*>(bs + kk * LDS + 64 + tx * 4);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      if (sum_a) {
#pragma unroll
        for (int i = 0; i < 8; ++i) asum[i] = __fadd_rn(asum[i], av[i]);
      }
    }
    if (more) {
      opa.put(As + (buf ^ 1) * BK * LDS, ra);
      opb.put(Bs + (buf ^ 1) * BK * LDS, rb);
    }
    __syncthreads();
    buf ^= 1;
  }
  epi(acc, asum, sum_a, m0, n0, tile_rows, smem);
}

// ---------------------------------------------------------------------------
// Epilogues: (acc, asum, has_asum, m0, n0, tile_rows, shared memory). The
// columns of a row come in runs of 4 (D is a multiple of 8): float4 access.
// ---------------------------------------------------------------------------

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ void st4(float* p, float a, float b, float c, float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}

// pos = acc + bd2; x = q[row / K] - k + pos; u = v + pos
struct VaEpiPos {
  const float *q, *k, *v, *bd2;
  float *x, *u;
  int rows, d, kk;
  __device__ void operator()(float (&acc)[8][8], float (&)[8], bool, int m0, int n0, int,
                             float*) const {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = m0 + row_of(i);
      if (r >= rows) continue;
      const long long ro = static_cast<long long>(r) * d;
      const long long qo = static_cast<long long>(r / kk) * d;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int c = n0 + col_of(4 * h);
        if (c >= d) continue;
        const float4 b = ld4(bd2 + c), qv = ld4(q + qo + c), kv = ld4(k + ro + c),
                     vv = ld4(v + ro + c);
        const float p0 = __fadd_rn(acc[i][4 * h + 0], b.x), p1 = __fadd_rn(acc[i][4 * h + 1], b.y),
                    p2 = __fadd_rn(acc[i][4 * h + 2], b.z), p3 = __fadd_rn(acc[i][4 * h + 3], b.w);
        st4(x + ro + c, __fadd_rn(__fsub_rn(qv.x, kv.x), p0), __fadd_rn(__fsub_rn(qv.y, kv.y), p1),
            __fadd_rn(__fsub_rn(qv.z, kv.z), p2), __fadd_rn(__fsub_rn(qv.w, kv.w), p3));
        st4(u + ro + c, __fadd_rn(vv.x, p0), __fadd_rn(vv.y, p1), __fadd_rn(vv.z, p2),
            __fadd_rn(vv.w, p3));
      }
    }
  }
};

// hg = relu(acc + bg1)
struct VaEpiBiasRelu {
  const float* bias;
  float* out;
  int rows, d;
  __device__ void operator()(float (&acc)[8][8], float (&)[8], bool, int m0, int n0, int,
                             float*) const {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = m0 + row_of(i);
      if (r >= rows) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int c = n0 + col_of(4 * h);
        if (c >= d) continue;
        const float4 b = ld4(bias + c);
        st4(out + static_cast<long long>(r) * d + c,
            fmaxf(__fadd_rn(acc[i][4 * h + 0], b.x), 0.f),
            fmaxf(__fadd_rn(acc[i][4 * h + 1], b.y), 0.f),
            fmaxf(__fadd_rn(acc[i][4 * h + 2], b.z), 0.f),
            fmaxf(__fadd_rn(acc[i][4 * h + 3], b.w), 0.f));
      }
    }
  }
};

// the tile's values (rows below tile_rows) to the shared tile E [BM][LDE], after
// every thread is done with the staging buffers it overlays
template <class F>
__device__ __forceinline__ void to_group_tile(float (&acc)[8][8], int n0, int tile_rows, int d,
                                              float* E, F value) {
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int rl = row_of(i);
    if (rl >= tile_rows) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int cl = col_of(4 * h);
      if (n0 + cl >= d) continue;
      st4(E + rl * LDE + cl, value(acc[i][4 * h + 0], n0 + cl + 0),
          value(acc[i][4 * h + 1], n0 + cl + 1), value(acc[i][4 * h + 2], n0 + cl + 2),
          value(acc[i][4 * h + 3], n0 + cl + 3));
    }
  }
  __syncthreads();
}

// z = (acc + bg2) * scale; per point and channel: a = softmax of z over its K
// rows (written when a is kept), out = sum over the K rows of a * u
struct VaEpiSoftmax {
  const float *bg2, *u;
  float *a, *out;
  int npts, d, kk;
  float scale;
  __device__ void operator()(float (&acc)[8][8], float (&)[8], bool, int m0, int n0,
                             int tile_rows, float* E) const {
    to_group_tile(acc, n0, tile_rows, d, E,
                  [&](float s, int c) { return __fmul_rn(__fadd_rn(s, bg2[c]), scale); });
    const int per = tile_rows / kk;
    for (int idx = threadIdx.x; idx < per * BN; idx += THREADS) {
      const int p = idx / BN, c = idx % BN;
      const int pt = m0 / kk + p, col = n0 + c;
      if (pt >= npts || col >= d) continue;
      float* e = E + p * kk * LDE + c;
      float mx = -CUDART_INF_F;
      for (int j = 0; j < kk; ++j) mx = fmaxf(mx, e[j * LDE]);
      float sum = 0.f;
      for (int j = 0; j < kk; ++j) {
        const float ex = expf(__fsub_rn(e[j * LDE], mx));
        e[j * LDE] = ex;
        sum = __fadd_rn(sum, ex);
      }
      float o = 0.f;
      const long long r0 = static_cast<long long>(pt) * kk;
      for (int j = 0; j < kk; ++j) {
        const long long off = (r0 + j) * d + col;
        const float aw = __fdiv_rn(e[j * LDE], sum);
        if (a != nullptr) a[off] = aw;
        o = __fadd_rn(o, __fmul_rn(aw, u[off]));
      }
      out[static_cast<long long>(pt) * d + col] = o;
    }
  }
};

// out = acc where mask > 0 (ReLU's backward through relu(hg) > 0), else 0
struct VaEpiMask {
  const float* mask;
  float* out;
  int rows, d;
  __device__ void operator()(float (&acc)[8][8], float (&)[8], bool, int m0, int n0, int,
                             float*) const {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = m0 + row_of(i);
      if (r >= rows) continue;
      const long long ro = static_cast<long long>(r) * d;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int c = n0 + col_of(4 * h);
        if (c >= d) continue;
        const float4 mk = ld4(mask + ro + c);
        st4(out + ro + c, mk.x > 0.f ? acc[i][4 * h + 0] : 0.f,
            mk.y > 0.f ? acc[i][4 * h + 1] : 0.f, mk.z > 0.f ? acc[i][4 * h + 2] : 0.f,
            mk.w > 0.f ? acc[i][4 * h + 3] : 0.f);
      }
    }
  }
};

// g_x = acc: gk = -g_x, g_pos = g_x + gv, gq[point] = sum over its K rows of g_x
struct VaEpiGx {
  const float* gv;
  float *gk, *gpos, *gq;
  int npts, d, kk;
  __device__ void operator()(float (&acc)[8][8], float (&)[8], bool, int m0, int n0,
                             int tile_rows, float* E) const {
    const int rows = npts * kk;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int rl = row_of(i), r = m0 + rl;
      if (rl >= tile_rows || r >= rows) continue;
      const long long ro = static_cast<long long>(r) * d;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int c = n0 + col_of(4 * h);
        if (c >= d) continue;
        const float4 g = ld4(gv + ro + c);
        const float s0 = acc[i][4 * h + 0], s1 = acc[i][4 * h + 1], s2 = acc[i][4 * h + 2],
                    s3 = acc[i][4 * h + 3];
        st4(gk + ro + c, -s0, -s1, -s2, -s3);
        st4(gpos + ro + c, __fadd_rn(s0, g.x), __fadd_rn(s1, g.y), __fadd_rn(s2, g.z),
            __fadd_rn(s3, g.w));
      }
    }
    to_group_tile(acc, n0, tile_rows, d, E, [](float s, int) { return s; });
    const int per = tile_rows / kk;
    for (int idx = threadIdx.x; idx < per * BN; idx += THREADS) {
      const int p = idx / BN, c = idx % BN;
      const int pt = m0 / kk + p, col = n0 + c;
      if (pt >= npts || col >= d) continue;
      const float* e = E + p * kk * LDE + c;
      float s = 0.f;
      for (int j = 0; j < kk; ++j) s = __fadd_rn(s, e[j * LDE]);
      gq[static_cast<long long>(pt) * d + col] = s;
    }
  }
};

// g_hd = acc where hd_pre(row, channel) > 0, else 0
struct VaEpiHdMask {
  Hd hd;
  float* out;
  __device__ void operator()(float (&acc)[8][8], float (&)[8], bool, int m0, int n0, int,
                             float*) const {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = m0 + row_of(i);
      if (r >= hd.rows) continue;
      const float* rr = hd.rel + 3LL * r;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = n0 + col_of(j);
        if (c >= hd.d) continue;
        const float pre = hd_pre(rr, hd.wd1 + 3 * c, hd.bd1[c]);
        out[static_cast<long long>(r) * hd.d + c] = pre > 0.f ? acc[i][j] : 0.f;
      }
    }
  }
};

// a chunk's partial weight gradient [M, N] (and, from the first column tile,
// the partial bias gradient [M]) at partial + chunk * (M * N + M)
struct VaEpiPartial {
  float* partial;
  int m, n;
  __device__ void operator()(float (&acc)[8][8], float (&asum)[8], bool has_asum, int m0,
                             int n0, int, float*) const {
    float* w = partial + static_cast<long long>(blockIdx.z) * (static_cast<long long>(m) * n + m);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int o = m0 + row_of(i);
      if (o >= m) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int c = n0 + col_of(4 * h);
        if (c >= n) continue;
        st4(w + static_cast<long long>(o) * n + c, acc[i][4 * h + 0], acc[i][4 * h + 1],
            acc[i][4 * h + 2], acc[i][4 * h + 3]);
      }
      if (has_asum) w[static_cast<long long>(m) * n + o] = asum[i];
    }
  }
};

// out[e] = sum over s of partial[s * stride + e], s in order
__global__ void va_sum_chunks_kernel(const float* __restrict__ partial, int chunks,
                                  long long stride, long long count, float* __restrict__ out) {
  const long long e = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= count) return;
  float s = 0.f;
  for (int c = 0; c < chunks; ++c) s = __fadd_rn(s, partial[c * stride + e]);
  out[e] = s;
}

// the softmax backward, one thread per (point, channel): gv = a g,
// gl = a (g u - sum_K(a g u)) * scale
__global__ void va_softmax_bwd_kernel(const float* __restrict__ g, const float* __restrict__ a,
                                   const float* __restrict__ u, float* __restrict__ gl,
                                   float* __restrict__ gv, int npts, int kk, int d, float scale) {
  const long long e = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= static_cast<long long>(npts) * d) return;
  const long long pt = e / d;
  const int c = static_cast<int>(e % d);
  const float gval = g[e];
  const long long r0 = pt * kk;
  float s = 0.f;
  for (int j = 0; j < kk; ++j) {
    const long long off = (r0 + j) * d + c;
    s = __fadd_rn(s, __fmul_rn(a[off], __fmul_rn(gval, u[off])));
  }
  for (int j = 0; j < kk; ++j) {
    const long long off = (r0 + j) * d + c;
    const float aw = a[off];
    const float ga = __fmul_rn(gval, u[off]);
    gl[off] = __fmul_rn(__fmul_rn(aw, __fsub_rn(ga, s)), scale);
    gv[off] = __fmul_rn(aw, gval);
  }
}

// fc_delta's first layer backward, the weight side: per chunk of rows and per
// channel o, sum of g_hd[r, o] rel[r, j] (j < 3) and of g_hd[r, o], to
// partial[chunk][o][4]
__global__ void va_rel_wgrad_kernel(const float* __restrict__ ghd, const float* __restrict__ rel,
                                 int rows, int d, int chunk, float* __restrict__ partial) {
  const int o = blockIdx.x * blockDim.x + threadIdx.x;
  if (o >= d) return;
  const int r0 = blockIdx.y * chunk, r1 = min(r0 + chunk, rows);
  float s0 = 0.f, s1 = 0.f, s2 = 0.f, sb = 0.f;
#pragma unroll 4
  for (int r = r0; r < r1; ++r) {
    const float gh = ghd[static_cast<long long>(r) * d + o];
    const float* rr = rel + 3LL * r;
    s0 = fmaf(gh, rr[0], s0);
    s1 = fmaf(gh, rr[1], s1);
    s2 = fmaf(gh, rr[2], s2);
    sb = __fadd_rn(sb, gh);
  }
  float* p = partial + (static_cast<long long>(blockIdx.y) * d + o) * 4;
  p[0] = s0;
  p[1] = s1;
  p[2] = s2;
  p[3] = sb;
}

// gwd1 [D, 3] and gbd1 [D] from the chunks' partials, in chunk order
__global__ void va_rel_wgrad_sum_kernel(const float* __restrict__ partial, int chunks, int d,
                                     float* __restrict__ gwd1, float* __restrict__ gbd1) {
  const int o = blockIdx.x * blockDim.x + threadIdx.x;
  if (o >= d) return;
  float s[4] = {0.f, 0.f, 0.f, 0.f};
  for (int c = 0; c < chunks; ++c)
    for (int j = 0; j < 4; ++j)
      s[j] = __fadd_rn(s[j], partial[(static_cast<long long>(c) * d + o) * 4 + j]);
  gwd1[3 * o + 0] = s[0];
  gwd1[3 * o + 1] = s[1];
  gwd1[3 * o + 2] = s[2];
  gbd1[o] = s[3];
}

// grel[r, j] = sum over o of g_hd[r, o] wd1[o, j]: one warp a row, lanes over o,
// a fixed shuffle tree
__global__ void va_rel_grad_kernel(const float* __restrict__ ghd, const float* __restrict__ wd1,
                                int rows, int d, float* __restrict__ grel) {
  const long long r = (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x & 31;
  if (r >= rows) return;
  float s0 = 0.f, s1 = 0.f, s2 = 0.f;
  for (int o = lane; o < d; o += 32) {
    const float gh = ghd[r * d + o];
    s0 = fmaf(gh, wd1[3 * o + 0], s0);
    s1 = fmaf(gh, wd1[3 * o + 1], s1);
    s2 = fmaf(gh, wd1[3 * o + 2], s2);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    s0 = __fadd_rn(s0, __shfl_xor_sync(0xffffffffu, s0, off));
    s1 = __fadd_rn(s1, __shfl_xor_sync(0xffffffffu, s1, off));
    s2 = __fadd_rn(s2, __shfl_xor_sync(0xffffffffu, s2, off));
  }
  if (lane == 0) {
    grel[3 * r + 0] = s0;
    grel[3 * r + 1] = s1;
    grel[3 * r + 2] = s2;
  }
}

int first_error(int err) { return err ? err : static_cast<int>(cudaGetLastError()); }

// C[rows, n] = A B^T tiles over row tiles of tile_rows rows, contraction k_len
template <class OpA, class OpB, class Epi>
int gemm(OpA a, OpB b, Epi epi, int rows, int tile_rows, int n, int k_len, size_t smem,
         cudaStream_t stream) {
  auto kernel = va_gemm_kernel<OpA, OpB, Epi, false>;
  int err = 0;
  if (smem > 48 * 1024)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
  if (err) return err;
  const int ncol = (n + BN - 1) / BN, nrow = (rows + tile_rows - 1) / tile_rows;
  kernel<<<dim3(nrow * ncol, 1, 1), THREADS, smem, stream>>>(a, b, epi, tile_rows, ncol, k_len,
                                                             k_len);
  return static_cast<int>(cudaGetLastError());
}

// a weight gradient g^T x over `rows` rows in chunks, and the bias gradient, then
// the chunk sums in order: gw [d, n], gb [d]
template <class OpX>
int wgrad(const float* g, OpX x, int rows, int d, int n, int chunk, float* partial, float* gw,
          float* gb, cudaStream_t stream) {
  auto kernel = va_gemm_kernel<MRows, OpX, VaEpiPartial, true>;
  const int chunks = (rows + chunk - 1) / chunk;
  const int ncol = (n + BN - 1) / BN, nrow = (d + BM - 1) / BM;
  kernel<<<dim3(nrow * ncol, 1, chunks), THREADS, STAGE_BYTES, stream>>>(
      MRows{g, d, d}, x, VaEpiPartial{partial, d, n}, BM, ncol, rows, chunk);
  int err = static_cast<int>(cudaGetLastError());
  const long long stride = static_cast<long long>(d) * n + d;
  const long long nw = static_cast<long long>(d) * n;
  va_sum_chunks_kernel<<<static_cast<unsigned>((nw + 255) / 256), 256, 0, stream>>>(
      partial, chunks, stride, nw, gw);
  err = first_error(err);
  va_sum_chunks_kernel<<<(d + 255) / 256, 256, 0, stream>>>(partial + nw, chunks, stride, d, gb);
  return first_error(err);
}

}  // namespace

extern "C" {

// w: wd1, bd1, wd2, bd2, wg1, bg1, wg2, bg2 (Linear layout). x, u, hg: [R, D]
// outputs (scratch when nothing is kept); a: [R, D] or null (not kept);
// out: [npts, D]. R = npts * kk.
int s3f_va_fwd(const float* q, const float* k, const float* v, const float* rel,
               const float* const* w, float* x, float* u, float* hg, float* a, float* out,
               int npts, int kk, int d, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int rows = npts * kk;
  const Hd hd{rel, w[0], w[1], rows, d};
  if (npts <= 0) return 0;
  int err = gemm(HdByRow{hd}, KRows{w[2], d, d},
                 VaEpiPos{q, k, v, w[3], x, u, rows, d, kk}, rows, BM, d, d, STAGE_BYTES, stream);
  err = first_error(err);
  if (!err)
    err = gemm(KRows{x, d, rows}, KRows{w[4], d, d}, VaEpiBiasRelu{w[5], hg, rows, d}, rows, BM, d,
               d, STAGE_BYTES, stream);
  const int tile_rows = (BM / kk) * kk;
  if (!err)
    err = gemm(KRows{hg, d, rows}, KRows{w[6], d, d},
               VaEpiSoftmax{w[7], u, a, out, npts, d, kk, 1.0f / sqrtf(static_cast<float>(d))},
               rows, tile_rows, d, d, GROUP_BYTES, stream);
  return err;
}

// x, u, hg, a: the forward's kept [R, D]; g: [npts, D]; outputs gq [npts, D], gk
// and gv [R, D], grel [R, 3] or null (not wanted), gw: the eight gradients in
// w's order; s1, s2: [R, D] scratch; chunk: rows a chunk of the weight
// gradients' sums, a multiple of 8; partial: the larger of ceil(R / chunk) *
// (D * D + D) and ceil(R / (chunk / 8)) * D * 4 floats.
int s3f_va_bwd(const float* rel, const float* const* w, const float* x, const float* u,
               const float* hg, const float* a, const float* g, float* gq, float* gk, float* gv,
               float* grel, float* const* gw, float* s1, float* s2, float* partial, int npts,
               int kk, int d, int chunk, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int rows = npts * kk;
  const float scale = 1.0f / sqrtf(static_cast<float>(d));
  const Hd hd{rel, w[0], w[1], rows, d};
  const int tile_rows = (BM / kk) * kk;
  const long long elems = static_cast<long long>(npts) * d;
  if (npts <= 0) return 0;
  int err = 0;
  // gl -> s1, gv
  va_softmax_bwd_kernel<<<static_cast<unsigned>((elems + 255) / 256), 256, 0, stream>>>(
      g, a, u, s1, gv, npts, kk, d, scale);
  err = first_error(err);
  // gwg2 = gl^T hg, gbg2; g_hg = (gl wg2) [hg > 0] -> s2
  if (!err) err = wgrad(s1, MRows{hg, d, d}, rows, d, d, chunk, partial, gw[6], gw[7], stream);
  if (!err)
    err = gemm(KRows{s1, d, rows}, MRows{w[6], d, d}, VaEpiMask{hg, s2, rows, d}, rows, BM, d, d,
               STAGE_BYTES, stream);
  // gwg1 = g_hg^T x, gbg1; g_x = g_hg wg1: gk, g_pos -> s1, gq
  if (!err) err = wgrad(s2, MRows{x, d, d}, rows, d, d, chunk, partial, gw[4], gw[5], stream);
  if (!err)
    err = gemm(KRows{s2, d, rows}, MRows{w[4], d, d}, VaEpiGx{gv, gk, s1, gq, npts, d, kk}, rows,
               tile_rows, d, d, GROUP_BYTES, stream);
  // gwd2 = g_pos^T hd, gbd2; g_hd = (g_pos wd2) [hd > 0] -> s2
  if (!err)
    err = wgrad(s1, HdByChannel{hd}, rows, d, d, chunk, partial, gw[2], gw[3], stream);
  if (!err)
    err = gemm(KRows{s1, d, rows}, MRows{w[2], d, d}, VaEpiHdMask{hd, s2}, rows, BM, d, d,
               STAGE_BYTES, stream);
  // gwd1 = g_hd^T rel, gbd1 (chunks of chunk / 8 rows: one thread a channel and
  // chunk walks its rows); grel = g_hd wd1
  const int rel_chunk = chunk / 8, rel_chunks = (rows + rel_chunk - 1) / rel_chunk;
  if (!err) {
    va_rel_wgrad_kernel<<<dim3((d + 127) / 128, rel_chunks), 128, 0, stream>>>(
        s2, rel, rows, d, rel_chunk, partial);
    err = first_error(err);
    va_rel_wgrad_sum_kernel<<<(d + 127) / 128, 128, 0, stream>>>(partial, rel_chunks, d, gw[0],
                                                              gw[1]);
    err = first_error(err);
  }
  if (!err && grel != nullptr) {
    const unsigned blocks = static_cast<unsigned>((static_cast<long long>(rows) * 32 + 255) / 256);
    va_rel_grad_kernel<<<blocks, 256, 0, stream>>>(s2, w[0], rows, d, grel);
    err = first_error(err);
  }
  return err;
}

}  // extern "C"
