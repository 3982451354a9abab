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
// GEMM launches with [R, D] intermediates in device memory:
//
//   forward   pos GEMM (hd formed from rel as its operand is staged; x and u
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
// Every product is a GEMM tile of 128 x 128 outputs, 256 threads, on the
// tensor-core core of tc_gemm.cuh (tc_gemm_kernel): mma.sync, 3-pass TF32 on
// this route and bf16 on the bf16 route. At B=64, N=1024, K=16, D=512
// the products are 1.65 TFLOP a forward against 4.4 GB of inputs: the
// operation count bounds it on this card, not bytes.
//
// The weight gradients sum over all R rows (1,048,576 at level 0) into D x D
// outputs: one block per output tile would give 16 blocks at D = 512. So each
// sum is split into fixed chunks of rows (blockIdx.z), each writes its partial
// sums, and a second pass adds the partials in chunk order. No float atomics:
// two runs give the same bits. Rows are bounds-checked, never padded.
//
// Every entry returns the first CUDA error of its launches (0 on success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <type_traits>

#include "tc_gemm.cuh"

namespace {

// Element types: f32 on the f32 route, bf16 (with f32 scratch) on the bf16 route.
__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
template <class T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float x) { return __float2bfloat16_rn(x); }
// an f32 value as a product's operand on the route whose tensors are of the
// pointer's type: as it is on the f32 route, rounded to bf16 on the bf16 route
__device__ __forceinline__ float operand(float x, const float*) { return x; }
__device__ __forceinline__ float operand(float x, const bf16*) { return bf16r(x); }

// out[e] = sum over s of partial[s * stride + e], s in order
__global__ void va_sum_chunks_kernel(const float* __restrict__ partial, int chunks,
                                  long long stride, long long count, float* __restrict__ out) {
  const long long e = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= count) return;
  float s = 0.f;
  for (int c = 0; c < chunks; ++c) s = __fadd_rn(s, partial[c * stride + e]);
  out[e] = s;
}

// the core's tile here: 128 x 128 outputs, 8 warps of 64 x 32, two blocks an SM
using VaTile = TcTile<128, 2, 4, 2>;
constexpr int BM = VaTile::BM, BN = VaTile::BN, THREADS = VaTile::THREADS;
constexpr int LDE = BN + 4;  // a row of the epilogues' group tile
constexpr size_t GROUP_BYTES = static_cast<size_t>(BM) * LDE * sizeof(float);

// fc_delta's first layer from rel [R, 3] and wd1 [D, 3] of type T, bd1 [D] f32:
// hd_pre in f32, the same expression wherever it is formed (the pos GEMM's
// operand, the wd2 gradient's operand, the g_hd mask); hd = relu(hd_pre) as a
// product's operand (rounded to bf16 on the bf16 route)
template <class T>
struct Hd {
  const T* rel;
  const T* wd1;
  const float* bd1;
  int rows, d;
  __device__ __forceinline__ void row(long long r, float (&v)[3]) const {
    v[0] = to_f(rel[3 * r]);
    v[1] = to_f(rel[3 * r + 1]);
    v[2] = to_f(rel[3 * r + 2]);
  }
  // hd_pre from a row's rel values and a channel's weights w0, w1, w2 and bias b
  __device__ __forceinline__ static float pre_of(const float (&v)[3], float w0, float w1, float w2,
                                                 float b) {
    return __fadd_rn(fmaf(v[2], w2, fmaf(v[1], w1, __fmul_rn(v[0], w0))), b);
  }
  // hd as a product's operand, from hd_pre
  __device__ __forceinline__ float op(float pre) const { return operand(fmaxf(pre, 0.f), rel); }
};

// An epilogue's outputs a thread, acc[i][j]: rows (i < 4 ? 0 : 64) + 4 ty + i %
// 4 and columns (j < 4 ? 0 : 64) + 4 tx + j % 4 of the tile, ty = thread / 16,
// tx = thread % 16.
__device__ __forceinline__ int row_of(int i) {
  return (i < 4 ? 0 : 64) + (threadIdx.x >> 4) * 4 + (i & 3);
}
__device__ __forceinline__ int col_of(int j) {
  return (j < 4 ? 0 : 64) + (threadIdx.x & 15) * 4 + (j & 3);
}

// ---------------------------------------------------------------------------
// Epilogues: (acc, asum, has_asum, m0, n0, tile_rows, shared memory). The
// columns of a row come in runs of 4 (D is a multiple of 8): 4-wide access.
// Each takes its tensors' element types as template arguments: f32 on the f32
// route, bf16 where the bf16 route keeps bf16.
// ---------------------------------------------------------------------------

// pos = acc + bd2; x = q[row / K] - k + pos; u = v + pos (the f32 route: k and
// v pre-gathered [R, D])
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
        const float4 b = load4(bd2 + c), qv = load4(q + qo + c), kv = load4(k + ro + c),
                     vv = load4(v + ro + c);
        const float p0 = __fadd_rn(acc[i][4 * h + 0], b.x), p1 = __fadd_rn(acc[i][4 * h + 1], b.y),
                    p2 = __fadd_rn(acc[i][4 * h + 2], b.z), p3 = __fadd_rn(acc[i][4 * h + 3], b.w);
        store4(x + ro + c, __fadd_rn(__fsub_rn(qv.x, kv.x), p0),
               __fadd_rn(__fsub_rn(qv.y, kv.y), p1), __fadd_rn(__fsub_rn(qv.z, kv.z), p2),
               __fadd_rn(__fsub_rn(qv.w, kv.w), p3));
        store4(u + ro + c, __fadd_rn(vv.x, p0), __fadd_rn(vv.y, p1), __fadd_rn(vv.z, p2),
               __fadd_rn(vv.w, p3));
      }
    }
  }
};

// hg = acc + bias to out of type TO, through the ReLU where WITH_RELU (the f32
// route keeps relu(hg); the bf16 route keeps hg_pre and takes the ReLU where it
// reads it)
template <class TO, bool WITH_RELU>
struct VaEpiBias {
  const float* bias;
  TO* out;
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
        const float4 b = load4(bias + c);
        float v[4] = {__fadd_rn(acc[i][4 * h + 0], b.x), __fadd_rn(acc[i][4 * h + 1], b.y),
                      __fadd_rn(acc[i][4 * h + 2], b.z), __fadd_rn(acc[i][4 * h + 3], b.w)};
        if (WITH_RELU) {
#pragma unroll
          for (int j = 0; j < 4; ++j) v[j] = fmaxf(v[j], 0.f);
        }
        store4(out + static_cast<long long>(r) * d + c, v[0], v[1], v[2], v[3]);
      }
    }
  }
};

// the tile's values (rows below tile_rows) to the shared tile E [BM][LDE], after
// every thread is done with the core's accumulator tile it overlays
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
      store4(E + rl * LDE + cl, value(acc[i][4 * h + 0], n0 + cl + 0),
             value(acc[i][4 * h + 1], n0 + cl + 1), value(acc[i][4 * h + 2], n0 + cl + 2),
             value(acc[i][4 * h + 3], n0 + cl + 3));
    }
  }
  __syncthreads();
}

// z = (acc + bg2) * scale; per point and channel: a = softmax of z over its K
// rows, out = sum over the K rows of a * u (u f32), stored as TO; kept where
// not null: a in f32 (a32) or bf16 (a16), u in bf16 (u16)
template <class TO>
struct VaEpiSoftmax {
  const float *bg2, *u;
  float* a32;
  bf16 *a16, *u16;
  TO* out;
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
        const float aw = __fdiv_rn(e[j * LDE], sum), uv = u[off];
        if (a32 != nullptr) a32[off] = aw;
        if (a16 != nullptr) a16[off] = __float2bfloat16_rn(aw);
        if (u16 != nullptr) u16[off] = __float2bfloat16_rn(uv);
        o = __fadd_rn(o, __fmul_rn(aw, uv));
      }
      out[static_cast<long long>(pt) * d + col] = from_f<TO>(o);
    }
  }
};

// out = acc where mask (of type TM: relu(hg) or hg_pre) > 0, else 0 (ReLU's backward)
template <class TM>
struct VaEpiMask {
  const TM* mask;
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
        const float4 mk = load4(mask + ro + c);
        store4(out + ro + c, mk.x > 0.f ? acc[i][4 * h + 0] : 0.f,
               mk.y > 0.f ? acc[i][4 * h + 1] : 0.f, mk.z > 0.f ? acc[i][4 * h + 2] : 0.f,
               mk.w > 0.f ? acc[i][4 * h + 3] : 0.f);
      }
    }
  }
};

// the value gradient of a row (offset ro) of a point (offset go), 4 channels
// from c: read from gv [R, D] (the f32 route, from the softmax backward) ...
struct GvRows {
  const float* gv;
  __device__ __forceinline__ float4 at(long long ro, long long, int c) const {
    return load4(gv + ro + c);
  }
};
// ... or formed as a g from a [R, D] of type TR and g [npts, D] bf16 (the bf16 route)
template <class TR>
struct GvProduct {
  const TR* a;
  const bf16* g;
  __device__ __forceinline__ float4 at(long long ro, long long go, int c) const {
    const float4 av = load4(a + ro + c), gv = load4(g + go + c);
    return make_float4(__fmul_rn(av.x, gv.x), __fmul_rn(av.y, gv.y), __fmul_rn(av.z, gv.z),
                       __fmul_rn(av.w, gv.w));
  }
};

// g_x = acc: gk = -g_x and gq[point] = sum over its K rows of g_x, stored as TK;
// g_pos = g_x + gv (f32)
template <class GV, class TK>
struct VaEpiGx {
  GV gv;
  TK *gk, *gq;
  float* gpos;
  int npts, d, kk;
  __device__ void operator()(float (&acc)[8][8], float (&)[8], bool, int m0, int n0,
                             int tile_rows, float* E) const {
    const int rows = npts * kk;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int rl = row_of(i), r = m0 + rl;
      if (rl >= tile_rows || r >= rows) continue;
      const long long ro = static_cast<long long>(r) * d;
      const long long go = static_cast<long long>(r / kk) * d;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int c = n0 + col_of(4 * h);
        if (c >= d) continue;
        const float4 g = gv.at(ro, go, c);
        const float s0 = acc[i][4 * h + 0], s1 = acc[i][4 * h + 1], s2 = acc[i][4 * h + 2],
                    s3 = acc[i][4 * h + 3];
        store4(gk + ro + c, -s0, -s1, -s2, -s3);
        store4(gpos + ro + c, __fadd_rn(s0, g.x), __fadd_rn(s1, g.y), __fadd_rn(s2, g.z),
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
      gq[static_cast<long long>(pt) * d + col] = from_f<TK>(s);
    }
  }
};

// g_hd = acc where hd_pre(row, channel) > 0, else 0; each of the thread's 8
// channels' weights and bias read once
template <class T>
struct VaEpiHdMask {
  Hd<T> hd;
  float* out;
  __device__ void operator()(float (&acc)[8][8], float (&)[8], bool, int m0, int n0, int,
                             float*) const {
    float w[8][3], b[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = min(n0 + col_of(j), hd.d - 1);
      w[j][0] = to_f(hd.wd1[3 * c]);
      w[j][1] = to_f(hd.wd1[3 * c + 1]);
      w[j][2] = to_f(hd.wd1[3 * c + 2]);
      b[j] = hd.bd1[c];
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = m0 + row_of(i);
      if (r >= hd.rows) continue;
      float v[3];
      hd.row(r, v);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int c = n0 + col_of(4 * h);
        if (c >= hd.d) continue;
        float o[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int jj = 4 * h + j;
          o[j] = Hd<T>::pre_of(v, w[jj][0], w[jj][1], w[jj][2], b[jj]) > 0.f ? acc[i][jj] : 0.f;
        }
        store4(out + static_cast<long long>(r) * hd.d + c, o[0], o[1], o[2], o[3]);
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
        store4(w + static_cast<long long>(o) * n + c, acc[i][4 * h + 0], acc[i][4 * h + 1],
               acc[i][4 * h + 2], acc[i][4 * h + 3]);
      }
      if (has_asum) w[static_cast<long long>(m) * n + o] = asum[i];
    }
  }
};

// ===========================================================================
// Every GEMM of both routes' forwards and backwards runs on the tensor-core
// core of tc_gemm.cuh (tc_gemm_kernel) at 128 x 128 output tiles (a row tile
// may hand its epilogue fewer rows: whole groups of K), the weight gradients'
// rows in chunks (blockIdx.z). bf16 route: the TPU kernel's operands (the
// inputs, saves and weights in bf16, hd and the f32 scratch s1, s2 rounded to
// bf16 as they are staged, ReLU applied to hg_pre). f32 route: 3-pass TF32;
// the weight gradients sum over all R rows (1,048,576 at level 0):
// tests/test_torch_port_va_tf32.py measures what one pass loses.
// fc_delta's hidden layer is formed from rel held in registers (TcHdCols reads
// a stage's rel a stage ahead, TcHdRows its block's rows once). (Every
// transformed operand through registers, loaded a stage ahead, was slower in
// both backwards.) The accumulators go through shared memory into the
// epilogues' per-thread acc[8][8] layout (row_of, col_of: VaAcc); the
// epilogues that take sums over a group of K rows then build their group tile
// in the same shared memory.
// ===========================================================================

template <class T, class S, bool KMAJOR, bool RELU = false, bool SUM = false>
using VaRows = TcRows<VaTile, T, S, KMAJOR, RELU, SUM>;

// hd as the B operand of wd2's weight gradient, MN-major: element (n = channel,
// k = row) formed from rel as Hd::at forms it. A thread keeps channels n0 + 4
// (thread % 32) .. + 3, their weights and biases read once (setup), and takes
// rows k0 + thread / 32 + 8 i: fetch reads their rel into registers, prepare
// forms and stores the values.
template <class T, class S>
struct TcHdCols {
  Hd<S> hd;
  static constexpr bool K_MAJOR = false, SUMS = false;
  static constexpr int LD = tile_ld<VaTile, T, false>();
  static constexpr int RAW = 0, COOKED = tile_bytes<VaTile, T, false>();
  struct Regs {
    float v[4][3], w[4][3], b[4];
  };
  __device__ __forceinline__ void setup(Regs& r, int n0) const {
    const int c = n0 + (threadIdx.x & 31) * 4;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int cj = min(c + j, hd.d - 1);
      r.w[j][0] = to_f(hd.wd1[3 * cj]);
      r.w[j][1] = to_f(hd.wd1[3 * cj + 1]);
      r.w[j][2] = to_f(hd.wd1[3 * cj + 2]);
      r.b[j] = hd.bd1[cj];
    }
  }
  __device__ __forceinline__ void issue(unsigned char*, int, int, int) const {}
  __device__ __forceinline__ void fetch(Regs& r, int, int k0, int k_lim) const {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int rr = k0 + (threadIdx.x >> 5) + 8 * i;
      if (rr < k_lim) {
        hd.row(rr, r.v[i]);
      } else {
        r.v[i][0] = r.v[i][1] = r.v[i][2] = 0.f;
      }
    }
  }
  __device__ __forceinline__ void prepare(unsigned char*, T* cooked, const Regs& r, int n0,
                                          int k0, int k_lim, float (&)[4]) const {
    const int cl = (threadIdx.x & 31) * 4;
    const bool in = n0 + cl < hd.d;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = (threadIdx.x >> 5) + 8 * i;
      const bool ok = in && k0 + row < k_lim;
      float h[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        h[j] = ok ? hd.op(Hd<S>::pre_of(r.v[i], r.w[j][0], r.w[j][1], r.w[j][2], r.b[j])) : 0.f;
      store4(cooked + row * LD + cl, h[0], h[1], h[2], h[3]);
    }
  }
  __device__ __forceinline__ const T* tile(const unsigned char*, const T* cooked) const {
    return cooked;
  }
};

// hd as the A operand of the pos GEMM, K-major: element (m = row, k = channel)
// formed from rel as Hd forms it. A block's rows are fixed: a thread
// keeps rows m0 + thread / 8 + 32 i (i < 4), their rel read once (setup), and
// takes channels k0 + 4 (thread % 8) .. + 3: prepare reads their weights and
// biases (small, L1-resident), then forms and stores the values.
template <class T, class S>
struct TcHdRows {
  Hd<S> hd;
  static constexpr bool K_MAJOR = true, SUMS = false;
  static constexpr int LD = tile_ld<VaTile, T, true>();
  static constexpr int RAW = 0, COOKED = tile_bytes<VaTile, T, true>();
  struct Regs {
    float v[4][3];
  };
  __device__ __forceinline__ void setup(Regs& r, int m0) const {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int rr = m0 + (threadIdx.x >> 3) + 32 * i;
      if (rr < hd.rows) {
        hd.row(rr, r.v[i]);
      } else {
        r.v[i][0] = r.v[i][1] = r.v[i][2] = 0.f;
      }
    }
  }
  __device__ __forceinline__ void issue(unsigned char*, int, int, int) const {}
  __device__ __forceinline__ void fetch(Regs&, int, int, int) const {}
  __device__ __forceinline__ void prepare(unsigned char*, T* cooked, const Regs& r, int m0,
                                          int k0, int k_lim, float (&)[4]) const {
    const int cl = (threadIdx.x & 7) * 4;
    const bool in = k0 + cl < k_lim;  // k_lim (D) is a multiple of 4
    float w[4][3], b[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = min(k0 + cl + j, hd.d - 1);
      w[j][0] = to_f(hd.wd1[3 * c]);
      w[j][1] = to_f(hd.wd1[3 * c + 1]);
      w[j][2] = to_f(hd.wd1[3 * c + 2]);
      b[j] = hd.bd1[c];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = (threadIdx.x >> 3) + 32 * i;
      const bool ok = in && m0 + row < hd.rows;
      float h[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        h[j] = ok ? hd.op(Hd<S>::pre_of(r.v[i], w[j][0], w[j][1], w[j][2], b[j])) : 0.f;
      store4(cooked + row * LD + cl, h[0], h[1], h[2], h[3]);
    }
  }
  __device__ __forceinline__ const T* tile(const unsigned char*, const T* cooked) const {
    return cooked;
  }
};

// A vector-attention epilogue (acc, asum, has_asum, m0, n0, tile_rows, shared
// memory) fed by the core: each thread takes its acc[8][8] from the tile C and,
// in the first column tile where A sums, its rows' sums from the partials,
// added in a fixed order
template <class Epi>
struct VaAcc {
  Epi epi;
  __device__ __forceinline__ void operator()(float* C, const float* part, bool sums, int m0,
                                             int n0, int nt, int tile_rows) const {
    constexpr int LDC = VaTile::LDC;
    float out[8][8], osum[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      osum[i] = 0.f;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float4 v = *reinterpret_cast<const float4*>(C + row_of(i) * LDC + col_of(4 * h));
        out[i][4 * h + 0] = v.x;
        out[i][4 * h + 1] = v.y;
        out[i][4 * h + 2] = v.z;
        out[i][4 * h + 3] = v.w;
      }
    }
    const bool sum_a = sums && nt == 0 && (threadIdx.x & 15) == 0;
    if (sum_a) {
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int w = 0; w < VaTile::GROUPS; ++w)
          osum[i] = __fadd_rn(osum[i], part[w * BM + row_of(i)]);
    }
    epi(out, osum, sum_a, m0, n0, tile_rows, C);
  }
};

// the softmax backward, one thread per (point, channel): gl = a (g u - sum_K(a g
// u)) * scale, and gv = a g where gv is not null; g of type TG, u and a of type TR
template <class TG, class TR>
__global__ void va_softmax_bwd_kernel(const TG* __restrict__ g, const TR* __restrict__ a,
                                      const TR* __restrict__ u, float* __restrict__ gl,
                                      float* __restrict__ gv, int npts, int kk, int d,
                                      float scale) {
  const long long e = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= static_cast<long long>(npts) * d) return;
  const long long pt = e / d;
  const int c = static_cast<int>(e % d);
  const float gval = to_f(g[e]);
  const long long r0 = pt * kk;
  float s = 0.f;
  for (int j = 0; j < kk; ++j) {
    const long long off = (r0 + j) * d + c;
    s = __fadd_rn(s, __fmul_rn(to_f(a[off]), __fmul_rn(gval, to_f(u[off]))));
  }
  for (int j = 0; j < kk; ++j) {
    const long long off = (r0 + j) * d + c;
    const float aw = to_f(a[off]);
    const float ga = __fmul_rn(gval, to_f(u[off]));
    gl[off] = __fmul_rn(__fmul_rn(aw, __fsub_rn(ga, s)), scale);
    if (gv != nullptr) gv[off] = __fmul_rn(aw, gval);
  }
}

// fc_delta's first layer backward, the weight side: per chunk of rows and per
// channel o, sum of g_hd[r, o] rel[r, j] (j < 3; g_hd as a product's operand)
// and of g_hd[r, o], to partial[chunk][o][4]
template <class T>
__global__ void va_rel_wgrad_kernel(const float* __restrict__ ghd, const T* __restrict__ rel,
                                    int rows, int d, int chunk, float* __restrict__ partial) {
  const int o = blockIdx.x * blockDim.x + threadIdx.x;
  if (o >= d) return;
  const int r0 = blockIdx.y * chunk, r1 = min(r0 + chunk, rows);
  float s0 = 0.f, s1 = 0.f, s2 = 0.f, sb = 0.f;
#pragma unroll 4
  for (int r = r0; r < r1; ++r) {
    const float gh = ghd[static_cast<long long>(r) * d + o], gho = operand(gh, rel);
    const T* rr = rel + 3LL * r;
    s0 = fmaf(gho, to_f(rr[0]), s0);
    s1 = fmaf(gho, to_f(rr[1]), s1);
    s2 = fmaf(gho, to_f(rr[2]), s2);
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

// grel[r, j] = sum over o of g_hd[r, o] wd1[o, j] (g_hd as a product's operand),
// stored as T: one warp a row, lanes over o, a fixed shuffle tree
template <class T>
__global__ void va_rel_grad_kernel(const float* __restrict__ ghd, const T* __restrict__ wd1,
                                   int rows, int d, T* __restrict__ grel) {
  const long long r = (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x & 31;
  if (r >= rows) return;
  float s0 = 0.f, s1 = 0.f, s2 = 0.f;
  for (int o = lane; o < d; o += 32) {
    const float gh = operand(ghd[r * d + o], wd1);
    s0 = fmaf(gh, to_f(wd1[3 * o + 0]), s0);
    s1 = fmaf(gh, to_f(wd1[3 * o + 1]), s1);
    s2 = fmaf(gh, to_f(wd1[3 * o + 2]), s2);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    s0 = __fadd_rn(s0, __shfl_xor_sync(0xffffffffu, s0, off));
    s1 = __fadd_rn(s1, __shfl_xor_sync(0xffffffffu, s1, off));
    s2 = __fadd_rn(s2, __shfl_xor_sync(0xffffffffu, s2, off));
  }
  if (lane == 0) {
    grel[3 * r + 0] = from_f<T>(s0);
    grel[3 * r + 1] = from_f<T>(s1);
    grel[3 * r + 2] = from_f<T>(s2);
  }
}

int first_error(int err) { return err ? err : static_cast<int>(cudaGetLastError()); }

// tc_gemm_kernel at VaTile over a grid (blockIdx.z: chunks of `chunk` contraction rows)
template <class P, class OpA, class OpB, class Epi>
int va_launch(OpA a, OpB b, Epi epi, dim3 grid, int tile_rows, int ncol, int k_len, int chunk,
              cudaStream_t stream) {
  static_assert(tc_smem_bytes<P, VaTile, OpA, OpB>() >= GROUP_BYTES,
                "an epilogue's group tile overlays the core's shared memory");
  return tc_launch<P, VaTile>(a, b, VaAcc<Epi>{epi}, grid, tile_rows, ncol, k_len, chunk,
                              stream);
}

// a row GEMM: C[rows, n] = A B^T over row tiles of tile_rows rows, contraction
// d, A [rows, d] K-major; B a weight: K-major in the forwards (x W^T, the
// Linear layout), MN-major in the backwards (g W)
template <class P, class OpA, class OpB, class Epi>
int tc_gemm(OpA a, OpB b, Epi epi, int rows, int tile_rows, int n, int d, cudaStream_t stream) {
  const int ncol = (n + BN - 1) / BN, nrow = (rows + tile_rows - 1) / tile_rows;
  return va_launch<P>(a, b, epi, dim3(nrow * ncol), tile_rows, ncol, d, d, stream);
}

// the f32 scratch s1, s2 [rows, d] as the A operand of a backward row GEMM
template <class P>
using Scratch = VaRows<typename P::T, float, true>;

// a weight gradient g^T x over `rows` rows in chunks, and the bias gradient, then
// the chunk sums in order: gw [d, n], gb [d]; g [rows, d] f32 (rounded to bf16
// for the products on the bf16 route, summed as it is for the bias gradient)
template <class P, class OpX>
int wgrad(const float* g, OpX x, int rows, int d, int n, int chunk, float* partial, float* gw,
          float* gb, cudaStream_t stream) {
  const int chunks = (rows + chunk - 1) / chunk;
  const int ncol = (n + BN - 1) / BN, nrow = (d + BM - 1) / BM;
  int err = va_launch<P>(VaRows<typename P::T, float, false, false, true>{g, d, d}, x,
                         VaEpiPartial{partial, d, n}, dim3(nrow * ncol, 1, chunks), BM, ncol,
                         rows, chunk, stream);
  if (err) return err;
  const long long stride = static_cast<long long>(d) * n + d;
  const long long nw = static_cast<long long>(d) * n;
  va_sum_chunks_kernel<<<static_cast<unsigned>((nw + 255) / 256), 256, 0, stream>>>(
      partial, chunks, stride, nw, gw);
  err = first_error(err);
  va_sum_chunks_kernel<<<(d + 255) / 256, 256, 0, stream>>>(partial + nw, chunks, stride, d, gb);
  return first_error(err);
}

// ===========================================================================
// The bf16 route: the in-kernel-gather chain (fused_vector_attention, its
// forward _fwd_kernel :123 at pallas_call :254 and recompute backward
// _bwd_kernel :137 at :290) and its residual-saving pair
// (fused_vector_attention_resid: _fwd_kernel_res :572 at :689, _bwd_kernel_res
// :590 at :722). q, k_all, v_all [B*N, D] bf16, idx [B*N*K] int32 (a point of
// the same batch element), rel [R, 3] bf16; the four weight matrices arrive
// rounded to bf16 (wd1 [D, 3], wd2, wg1, wg2 [D, D], Linear layout), the
// biases in f32.
//
// The TPU kernel's precision policy, exactly: every product takes operands
// rounded to bf16 and sums in f32 (a bf16 x bf16 product is exact in f32; the
// core's bf16 mma.sync forms it); biases, ReLU, softmax, x = q - k + pos and u
// = v + pos are f32; out is rounded once at the end. k and v rows are read by
// index in the pos GEMM's epilogue (nothing [B, N, K, D] is an input); an
// index outside [0, N) reads a zero row and scatters nowhere, as the one-hot
// product does. The operands, epilogues and helper kernels are the f32
// route's, instantiated with bf16 element types; only the by-index pos
// epilogue, the inverse index and the scatter are the bf16 route's own.
//
// Forward (three GEMMs, as the f32 route, on bf16 tensor cores): hd rounded to
// bf16 as it is formed; x and hg_pre written in bf16 (exact for what reads
// them: the next GEMM's operand and the ReLU's sign), u in f32 for the sum
// over K. Training keeps x, u, hg_pre and a in bf16 (the _resid saves); the
// recompute backward runs the forward keeping u and a in f32. Backward: the
// f32 route's steps with rounded operands, on bf16 tensor cores; the bias
// gradients sum the f32 values, the weight gradients their bf16 roundings.
// gk_all and gv_all sum the rounded row gradients bf16(-g_x) and bf16(a g) of
// every (point, neighbour) row that names a point: an inverse index (a stable
// counting sort of idx per batch element, integer counts only) then a sum over
// each point's rows in row order. No float atomics: reruns give the same bits.
// ===========================================================================

// pos = acc + bd2; k, v = rows idx[r] of k_all, v_all; x = bf16((q - k) + pos),
// u = v + pos (f32)
struct VagEpiPos {
  const bf16 *q, *kall, *vall;
  const int* idx;
  const float* bd2;
  bf16* x;
  float* u;
  int rows, d, kk, n;
  __device__ void operator()(float (&acc)[8][8], float (&)[8], bool, int m0, int n0, int,
                             float*) const {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = m0 + row_of(i);
      if (r >= rows) continue;
      const long long ro = static_cast<long long>(r) * d;
      const int pt = r / kk, j = idx[r];
      const bool in = j >= 0 && j < n;
      const long long qo = static_cast<long long>(pt) * d;
      const long long so = (static_cast<long long>(pt / n) * n + (in ? j : 0)) * d;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int c = n0 + col_of(4 * h);
        if (c >= d) continue;
        const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
        const float4 b = load4(bd2 + c), qv = load4(q + qo + c),
                     kv = in ? load4(kall + so + c) : zero, vv = in ? load4(vall + so + c) : zero;
        const float p0 = __fadd_rn(acc[i][4 * h + 0], b.x), p1 = __fadd_rn(acc[i][4 * h + 1], b.y),
                    p2 = __fadd_rn(acc[i][4 * h + 2], b.z), p3 = __fadd_rn(acc[i][4 * h + 3], b.w);
        store4(x + ro + c, __fadd_rn(__fsub_rn(qv.x, kv.x), p0),
               __fadd_rn(__fsub_rn(qv.y, kv.y), p1), __fadd_rn(__fsub_rn(qv.z, kv.z), p2),
               __fadd_rn(__fsub_rn(qv.w, kv.w), p3));
        store4(u + ro + c, __fadd_rn(vv.x, p0), __fadd_rn(vv.y, p1), __fadd_rn(vv.z, p2),
               __fadd_rn(vv.w, p3));
      }
    }
  }
};

// The inverse of idx per batch element (one block each): start [n + 1] (the
// first slot of each point) and perm [nk] (the rows naming each point, in row
// order), from integer counts in cnt [n]. The placement runs in one warp, 32
// rows at a time in row order: equal points among them take slots by lane.
__global__ void vag_inverse_kernel(const int* __restrict__ idx, int n, int nk, int* cnt_all,
                                   int* __restrict__ start_all, int* __restrict__ perm_all) {
  const int b = blockIdx.x;
  const int* ib = idx + static_cast<long long>(b) * nk;
  int* cnt_w = cnt_all + static_cast<long long>(b) * n;
  volatile int* cnt = cnt_w;
  int* start = start_all + static_cast<long long>(b) * (n + 1);
  int* perm = perm_all + static_cast<long long>(b) * nk;
  for (int j = threadIdx.x; j < n; j += blockDim.x) cnt[j] = 0;
  __syncthreads();
  for (int r = threadIdx.x; r < nk; r += blockDim.x) {
    const int j = ib[r];
    if (j >= 0 && j < n) atomicAdd(cnt_w + j, 1);
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int s = 0;
    for (int j = 0; j < n; ++j) {
      const int c = cnt[j];
      start[j] = s;
      cnt[j] = s;
      s += c;
    }
    start[n] = s;
  }
  __syncthreads();
  if (threadIdx.x >= 32) return;
  const int lane = threadIdx.x;
  for (int r0 = 0; r0 < nk; r0 += 32) {
    const int r = r0 + lane;
    const int j = r < nk ? ib[r] : -1;
    const bool in = j >= 0 && j < n;
    const int key = in ? j : -1 - lane;  // a key of its own for a row that scatters nowhere
    const unsigned same = __match_any_sync(0xffffffffu, key);
    const int rank = __popc(same & ((1u << lane) - 1u));
    const int slot = in ? cnt[j] + rank : 0;
    __syncwarp();
    if (in && rank == 0) cnt[j] = slot + __popc(same);
    __syncwarp();
    if (in) perm[slot] = r;
  }
}

// gk_all, gv_all [B*N, D] bf16: for each point and pair of channels, the f32
// sum in row order over the rows naming the point of gkr (bf16(-g_x)) and of
// bf16(a g), rounded to bf16
template <class TR>
__global__ void vag_scatter_kernel(const bf16* __restrict__ gkr, const TR* __restrict__ a,
                                   const bf16* __restrict__ g, const int* __restrict__ start_all,
                                   const int* __restrict__ perm_all, int npts, int n, int kk,
                                   int d, bf16* __restrict__ gk, bf16* __restrict__ gv) {
  const long long e = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int half = d / 2;
  if (e >= static_cast<long long>(npts) * half) return;
  const long long tgt = e / half;
  const int c = static_cast<int>(e % half) * 2;
  const int b = static_cast<int>(tgt / n), j = static_cast<int>(tgt % n);
  const int* start = start_all + static_cast<long long>(b) * (n + 1);
  const int* perm = perm_all + static_cast<long long>(b) * n * kk;
  float k0 = 0.f, k1 = 0.f, v0 = 0.f, v1 = 0.f;
  for (int t = start[j]; t < start[j + 1]; ++t) {
    const long long r = static_cast<long long>(b) * n * kk + perm[t];
    const long long ro = r * d + c, go = (r / kk) * d + c;
    const float2 kr = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(gkr + ro));
    k0 = __fadd_rn(k0, kr.x);
    k1 = __fadd_rn(k1, kr.y);
    v0 = __fadd_rn(v0, bf16r(__fmul_rn(to_f(a[ro]), __bfloat162float(g[go]))));
    v1 = __fadd_rn(v1, bf16r(__fmul_rn(to_f(a[ro + 1]), __bfloat162float(g[go + 1]))));
  }
  const long long o = tgt * d + c;
  *reinterpret_cast<__nv_bfloat162*>(gk + o) = __floats2bfloat162_rn(k0, k1);
  *reinterpret_cast<__nv_bfloat162*>(gv + o) = __floats2bfloat162_rn(v0, v1);
}

// the forward: x16, hgp16 [R, D] bf16 and u32 [R, D] f32 always written (kept
// or scratch); a32, a16, u16 where not null; out16 [npts, D]
int vag_forward(const bf16* q, const bf16* kall, const bf16* vall, const int* idx,
                const bf16* rel, const bf16* const* wh, const float* const* bias, bf16* x16,
                bf16* hgp16, float* u32, float* a32, bf16* a16, bf16* u16, bf16* out16,
                int npts, int n, int kk, int d, cudaStream_t stream) {
  const int rows = npts * kk;
  const Hd<bf16> hd{rel, wh[0], bias[0], rows, d};
  using P = Bf16Mma;
  using Rows = VaRows<bf16, bf16, true>;
  int err = tc_gemm<P>(TcHdRows<bf16, bf16>{hd}, Rows{wh[1], d, d},
                       VagEpiPos{q, kall, vall, idx, bias[1], x16, u32, rows, d, kk, n}, rows, BM,
                       d, d, stream);
  if (!err)
    err = tc_gemm<P>(Rows{x16, d, rows}, Rows{wh[2], d, d},
                     VaEpiBias<bf16, false>{bias[2], hgp16, rows, d}, rows, BM, d, d, stream);
  const int tile_rows = (BM / kk) * kk;
  if (!err)
    err = tc_gemm<P>(VaRows<bf16, bf16, true, true>{hgp16, d, rows}, Rows{wh[3], d, d},
                     VaEpiSoftmax<bf16>{bias[3], u32, a32, a16, u16, out16, npts, d, kk,
                                        1.0f / sqrtf(static_cast<float>(d))},
                     rows, tile_rows, d, d, stream);
  return err;
}

// the backward from x16, hgp16 and u, a of type TR (f32 from the recompute,
// bf16 from the saves); s1, s2 [R, D] f32 and gkr [R, D] bf16 scratch; ints:
// cnt [B*N], start [B*(N+1)], perm [R]
template <class TR>
int vag_backward(const int* idx, const bf16* rel, const bf16* const* wh,
                 const float* const* bias, const bf16* x16, const bf16* hgp16, const TR* u,
                 const TR* a, const bf16* g, bf16* gq, bf16* gk, bf16* gv, bf16* grel,
                 float* const* gw, float* s1, float* s2, bf16* gkr, float* partial, int* ints,
                 int npts, int n, int kk, int d, int chunk, cudaStream_t stream) {
  const int rows = npts * kk;
  const float scale = 1.0f / sqrtf(static_cast<float>(d));
  const Hd<bf16> hd{rel, wh[0], bias[0], rows, d};
  const int tile_rows = (BM / kk) * kk;
  const long long elems = static_cast<long long>(npts) * d;
  int err = 0;
  // gl -> s1
  va_softmax_bwd_kernel<bf16, TR><<<static_cast<unsigned>((elems + 255) / 256), 256, 0, stream>>>(
      g, a, u, s1, nullptr, npts, kk, d, scale);
  err = first_error(err);
  // gwg2 = bf16(gl)^T relu(hg_pre), gbg2; g_hg = (bf16(gl) wg2) [hg_pre > 0] -> s2
  using P = Bf16Mma;
  using Cols = VaRows<bf16, bf16, false>;
  if (!err)
    err = wgrad<P>(s1, VaRows<bf16, bf16, false, true>{hgp16, d, d}, rows, d, d, chunk, partial,
                   gw[6], gw[7], stream);
  if (!err)
    err = tc_gemm<P>(Scratch<P>{s1, d, rows}, Cols{wh[3], d, d},
                     VaEpiMask<bf16>{hgp16, s2, rows, d}, rows, BM, d, d, stream);
  // gwg1 = bf16(g_hg)^T x, gbg1; g_x = bf16(g_hg) wg1: gkr, g_pos -> s1, gq
  if (!err)
    err = wgrad<P>(s2, Cols{x16, d, d}, rows, d, d, chunk, partial, gw[4], gw[5], stream);
  if (!err)
    err = tc_gemm<P>(Scratch<P>{s2, d, rows}, Cols{wh[2], d, d},
                     VaEpiGx<GvProduct<TR>, bf16>{GvProduct<TR>{a, g}, gkr, gq, s1, npts, d, kk},
                     rows, tile_rows, d, d, stream);
  // gwd2 = bf16(g_pos)^T hd, gbd2; g_hd = (bf16(g_pos) wd2) [hd_pre > 0] -> s2
  if (!err)
    err = wgrad<P>(s1, TcHdCols<bf16, bf16>{hd}, rows, d, d, chunk, partial, gw[2], gw[3], stream);
  if (!err)
    err = tc_gemm<P>(Scratch<P>{s1, d, rows}, Cols{wh[1], d, d}, VaEpiHdMask<bf16>{hd, s2}, rows,
                     BM, d, d, stream);
  // gwd1 = bf16(g_hd)^T rel, gbd1; grel = bf16(bf16(g_hd) wd1)
  const int rel_chunk = chunk / 8, rel_chunks = (rows + rel_chunk - 1) / rel_chunk;
  if (!err) {
    va_rel_wgrad_kernel<bf16><<<dim3((d + 127) / 128, rel_chunks), 128, 0, stream>>>(
        s2, rel, rows, d, rel_chunk, partial);
    err = first_error(err);
    va_rel_wgrad_sum_kernel<<<(d + 127) / 128, 128, 0, stream>>>(partial, rel_chunks, d, gw[0],
                                                                 gw[1]);
    err = first_error(err);
  }
  if (!err && grel != nullptr) {
    const unsigned blocks = static_cast<unsigned>((static_cast<long long>(rows) * 32 + 255) / 256);
    va_rel_grad_kernel<bf16><<<blocks, 256, 0, stream>>>(s2, wh[0], rows, d, grel);
    err = first_error(err);
  }
  // gk_all, gv_all through the inverse index
  const int b = npts / n;
  int* cnt = ints;
  int* start = cnt + static_cast<long long>(b) * n;
  int* perm = start + static_cast<long long>(b) * (n + 1);
  if (!err) {
    vag_inverse_kernel<<<b, 256, 0, stream>>>(idx, n, n * kk, cnt, start, perm);
    err = first_error(err);
    const long long pairs = static_cast<long long>(npts) * (d / 2);
    vag_scatter_kernel<TR><<<static_cast<unsigned>((pairs + 255) / 256), 256, 0, stream>>>(
        gkr, a, g, start, perm, npts, n, kk, d, gk, gv);
    err = first_error(err);
  }
  return err;
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
  const Hd<float> hd{rel, w[0], w[1], rows, d};
  if (npts <= 0) return 0;
  using P = Tf32x3;
  using Rows = VaRows<float, float, true>;
  int err = tc_gemm<P>(TcHdRows<float, float>{hd}, Rows{w[2], d, d},
                       VaEpiPos{q, k, v, w[3], x, u, rows, d, kk}, rows, BM, d, d, stream);
  if (!err)
    err = tc_gemm<P>(Rows{x, d, rows}, Rows{w[4], d, d},
                     VaEpiBias<float, true>{w[5], hg, rows, d}, rows, BM, d, d, stream);
  const int tile_rows = (BM / kk) * kk;
  if (!err)
    err = tc_gemm<P>(Rows{hg, d, rows}, Rows{w[6], d, d},
                     VaEpiSoftmax<float>{w[7], u, a, nullptr, nullptr, out, npts, d, kk,
                                         1.0f / sqrtf(static_cast<float>(d))},
                     rows, tile_rows, d, d, stream);
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
  const Hd<float> hd{rel, w[0], w[1], rows, d};
  const int tile_rows = (BM / kk) * kk;
  const long long elems = static_cast<long long>(npts) * d;
  if (npts <= 0) return 0;
  int err = 0;
  // gl -> s1, gv
  const unsigned pc_blocks = static_cast<unsigned>((elems + 255) / 256);
  va_softmax_bwd_kernel<float, float><<<pc_blocks, 256, 0, stream>>>(g, a, u, s1, gv, npts, kk,
                                                                     d, scale);
  err = first_error(err);
  // gwg2 = gl^T hg, gbg2; g_hg = (gl wg2) [hg > 0] -> s2
  using P = Tf32x3;
  using Cols = VaRows<float, float, false>;
  if (!err) err = wgrad<P>(s1, Cols{hg, d, d}, rows, d, d, chunk, partial, gw[6], gw[7], stream);
  if (!err)
    err = tc_gemm<P>(Scratch<P>{s1, d, rows}, Cols{w[6], d, d},
                     VaEpiMask<float>{hg, s2, rows, d}, rows, BM, d, d, stream);
  // gwg1 = g_hg^T x, gbg1; g_x = g_hg wg1: gk, g_pos -> s1, gq
  if (!err) err = wgrad<P>(s2, Cols{x, d, d}, rows, d, d, chunk, partial, gw[4], gw[5], stream);
  if (!err)
    err = tc_gemm<P>(Scratch<P>{s2, d, rows}, Cols{w[4], d, d},
                     VaEpiGx<GvRows, float>{GvRows{gv}, gk, gq, s1, npts, d, kk}, rows, tile_rows,
                     d, d, stream);
  // gwd2 = g_pos^T hd, gbd2; g_hd = (g_pos wd2) [hd > 0] -> s2
  if (!err)
    err = wgrad<P>(s1, TcHdCols<float, float>{hd}, rows, d, d, chunk, partial, gw[2], gw[3],
                   stream);
  if (!err)
    err = tc_gemm<P>(Scratch<P>{s1, d, rows}, Cols{w[2], d, d}, VaEpiHdMask<float>{hd, s2}, rows,
                     BM, d, d, stream);
  // gwd1 = g_hd^T rel, gbd1 (chunks of chunk / 8 rows: one thread a channel and
  // chunk walks its rows); grel = g_hd wd1
  const int rel_chunk = chunk / 8, rel_chunks = (rows + rel_chunk - 1) / rel_chunk;
  if (!err) {
    va_rel_wgrad_kernel<float><<<dim3((d + 127) / 128, rel_chunks), 128, 0, stream>>>(
        s2, rel, rows, d, rel_chunk, partial);
    err = first_error(err);
    va_rel_wgrad_sum_kernel<<<(d + 127) / 128, 128, 0, stream>>>(partial, rel_chunks, d, gw[0],
                                                              gw[1]);
    err = first_error(err);
  }
  if (!err && grel != nullptr) {
    const unsigned blocks = static_cast<unsigned>((static_cast<long long>(rows) * 32 + 255) / 256);
    va_rel_grad_kernel<float><<<blocks, 256, 0, stream>>>(s2, w[0], rows, d, grel);
    err = first_error(err);
  }
  return err;
}


// The bf16 route (see the section above). wh: wd1, wd2, wg1, wg2 rounded to
// bf16 (Linear layout); bias: bd1, bd2, bg1, bg2 in f32.

// forward: x16, hgp16 [R, D] bf16 and u32 [R, D] f32 (scratch, or x16 and
// hgp16 kept); u16, a16 [R, D] bf16 kept, or null (nothing kept); out16
// [npts, D]. R = npts * kk, npts = B * n.
int s3f_vag_fwd(const __nv_bfloat16* q, const __nv_bfloat16* kall, const __nv_bfloat16* vall,
                const int* idx, const __nv_bfloat16* rel, const __nv_bfloat16* const* wh,
                const float* const* bias, __nv_bfloat16* x16, __nv_bfloat16* hgp16, float* u32,
                __nv_bfloat16* u16, __nv_bfloat16* a16, __nv_bfloat16* out16, int npts, int n,
                int kk, int d, void* stream_ptr) {
  if (npts <= 0) return 0;
  return vag_forward(q, kall, vall, idx, rel, wh, bias, x16, hgp16, u32, nullptr, a16, u16, out16,
                     npts, n, kk, d, static_cast<cudaStream_t>(stream_ptr));
}

// recompute backward: the forward again (x16, hgp16, u32, a32 scratch; its
// output into gq, which the backward then writes), then the backward with u
// and a in f32. Outputs gq, gk, gv [npts, D] bf16, grel [R, 3] bf16 or null,
// gw the eight f32 gradients in w's order. Scratch: s1, s2 [R, D] f32, gkr
// [R, D] bf16, partial as s3f_va_bwd's, ints B * (2 n + 1) + R.
int s3f_vag_bwd(const __nv_bfloat16* q, const __nv_bfloat16* kall, const __nv_bfloat16* vall,
                const int* idx, const __nv_bfloat16* rel, const __nv_bfloat16* const* wh,
                const float* const* bias, const __nv_bfloat16* g, __nv_bfloat16* gq,
                __nv_bfloat16* gk, __nv_bfloat16* gv, __nv_bfloat16* grel, float* const* gw,
                __nv_bfloat16* x16, __nv_bfloat16* hgp16, float* u32, float* a32, float* s1,
                float* s2, __nv_bfloat16* gkr, float* partial, int* ints, int npts, int n, int kk,
                int d, int chunk, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (npts <= 0) return 0;
  int err = vag_forward(q, kall, vall, idx, rel, wh, bias, x16, hgp16, u32, a32, nullptr,
                        nullptr, gq, npts, n, kk, d, stream);
  if (!err)
    err = vag_backward<float>(idx, rel, wh, bias, x16, hgp16, u32, a32, g, gq, gk, gv, grel, gw,
                              s1, s2, gkr, partial, ints, npts, n, kk, d, chunk, stream);
  return err;
}

// backward from the saves x16, u16, hgp16, a16 [R, D] bf16; outputs and
// scratch as s3f_vag_bwd's
int s3f_vag_bwd_res(const int* idx, const __nv_bfloat16* rel, const __nv_bfloat16* const* wh,
                    const float* const* bias, const __nv_bfloat16* x16,
                    const __nv_bfloat16* u16, const __nv_bfloat16* hgp16,
                    const __nv_bfloat16* a16, const __nv_bfloat16* g, __nv_bfloat16* gq,
                    __nv_bfloat16* gk, __nv_bfloat16* gv, __nv_bfloat16* grel, float* const* gw,
                    float* s1, float* s2, __nv_bfloat16* gkr, float* partial, int* ints,
                    int npts, int n, int kk, int d, int chunk, void* stream_ptr) {
  if (npts <= 0) return 0;
  return vag_backward<__nv_bfloat16>(idx, rel, wh, bias, x16, hgp16, u16, a16, g, gq, gk, gv,
                                     grel, gw, s1, s2, gkr, partial, ints, npts, n, kk, d, chunk,
                                     static_cast<cudaStream_t>(stream_ptr));
}

}  // extern "C"
