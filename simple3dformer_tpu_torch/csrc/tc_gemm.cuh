// The GEMM core on the tensor cores shared by vector_attention.cu (128 x 128
// output tiles) and vit_block.cu (64 x 64). Device code and launch helpers
// only, each translation unit's own copy (an unnamed namespace).
//
// tc_gemm_kernel computes one output tile of C = sum_k A(m, k) B(n, k) over
// the contraction chunk of its blockIdx.z, with f32 sums in registers:
//
//   bf16 route  mma.sync m16n8k16 .bf16 on operands rounded to bf16 (a bf16 x
//               bf16 product is exact in f32, so the f32 sums differ from a plain
//               version's in their order only). Bound: 989 TFLOP/s.
//   f32 route   mma.sync m16n8k8 .tf32 in 3 passes (tensor_core.cuh's split: a
//               product is a_small b_big + a_big b_small + a_big b_big), the
//               split made where a fragment leaves shared memory. One pass keeps
//               about 10 bits of each operand; tests/test_torch_port_va_tf32.py
//               and tests/test_torch_port_vit_block_tf32.py measure what it
//               loses. Bound: 495 / 3 = 165 TFLOP/s.
//
// A block is WARPS_M x WARPS_N warps, each owning a (BM / WARPS_M) x (BN /
// WARPS_N) piece of the tile, and stages the contraction TBK = 32 rows at a
// time, its cp.async copies in flight STAGES - 1 stages ahead. An operand is
// any type with the interface of TcRows below (setup, issue, fetch, prepare,
// tile): an operand transformed on the way (rounded to bf16, ReLU, LayerNorm,
// GELU, the bias gradients' sums of the unrounded f32 values) is transformed
// in shared memory by the thread that copied it, once its copy has landed, a
// stage before its products. A staged tile keeps its device-memory layout:
// K-major [BM][TBK + pad] (the contraction contiguous: an activation's rows,
// and a weight in the Linear layout as the right factor of x W^T) or MN-major
// [TBK][BM + 8] (a weight read transposed, g W, and both operands of a weight
// gradient, whose contraction is the row axis); ldmatrix reads the fragments
// (.trans for MN-major bf16; MN-major f32 by 32-bit loads on banks 8 t + g),
// the pads keeping each conflict-free. At the end the accumulators go to an f32
// tile C [BM][BN + 8] in shared memory, the A operand's sums (where it sums)
// to a row of partials per thread group, and the epilogue takes it from there.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

#include "smem_once.cuh"
#include "tensor_core.cuh"

namespace {

// x rounded to the nearest bf16 (ties to even), as a float
__device__ __forceinline__ float bf16r(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const bf16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}
__device__ __forceinline__ void store4(float* p, float a, float b, float c, float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}
__device__ __forceinline__ void store4(bf16* p, float a, float b, float c, float d) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(a, b), hi = __floats2bfloat162_rn(c, d);
  uint2 raw;
  raw.x = *reinterpret_cast<const unsigned*>(&lo);
  raw.y = *reinterpret_cast<const unsigned*>(&hi);
  *reinterpret_cast<uint2*>(p) = raw;
}

struct Bf16Mma {  // the bf16 route's products
  using T = bf16;
  static constexpr int STAGES = 3;
};
struct Tf32x3 {  // the f32 route's products
  using T = float;
  static constexpr int STAGES = 3;
};

// A block's output tile: S x S outputs, WM x WN warps, at least MINB blocks an
// SM (__launch_bounds__)
template <int S, int WM, int WN, int MINB>
struct TcTile {
  static constexpr int BM = S, BN = S, WARPS_M = WM, WARPS_N = WN;
  static constexpr int THREADS = 32 * WM * WN, MIN_BLOCKS = MINB;
  static constexpr int WTM = BM / WM, WTN = BN / WN;  // a warp's outputs
  static constexpr int MI = WTM / 16, NJ = WTN / 8;   // its C fragments
  static constexpr int LDC = BN + 8;  // a row of the accumulator tile: conflict-free float2 stores
  static constexpr int GROUPS = THREADS / (BM / 4);  // rows of A's partial sums
  static_assert(WTM % 16 == 0 && WTN % 16 == 0, "a warp takes 16 x 16 fragment pairs");
};

constexpr int TBK = 32;  // contraction rows a stage

// a staged row: K-major rows 16 bytes longer than TBK values, MN-major rows 8
// values longer than BM (either way consecutive rows start 4 banks apart)
template <class Tile, class T, bool KMAJOR>
__host__ __device__ constexpr int tile_ld() {
  return KMAJOR ? TBK + 16 / static_cast<int>(sizeof(T)) : Tile::BM + 8;
}
// bytes of a staged tile
template <class Tile, class T, bool KMAJOR>
__host__ __device__ constexpr int tile_bytes() {
  return (KMAJOR ? Tile::BM : TBK) * tile_ld<Tile, T, KMAJOR>() * static_cast<int>(sizeof(T));
}

__device__ __forceinline__ uint32_t relu2(uint32_t x) {
  const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&x));
  const __nv_bfloat162 r = __floats2bfloat162_rn(fmaxf(f.x, 0.f), fmaxf(f.y, 0.f));
  return *reinterpret_cast<const uint32_t*>(&r);
}

// No transform of an f32 operand's values (XF of TcRows)
struct NoXf {
  static constexpr bool ACTIVE = false;
  __device__ __forceinline__ float4 operator()(float4 v, int, int) const { return v; }
};

// An operand from rows of type S: element (m, k) = p[m * ld + k] (KMAJOR) or
// p[k * ld + m], zero at m >= m_lim or k >= k_lim, staged as T (an f32 value
// staged as bf16 is rounded), through ReLU where RELU. XF: a transform of an
// f32 operand's values, xf(v, m, k) on the four values at (m, k) .. (m, k + 3)
// (KMAJOR) or (m .. m + 3, k), before rounding. SUM: the f32 values before XF
// and rounding go into the bias gradient's sums (an MN-major f32 operand, whose
// thread keeps columns 4 (thread % (BM / 4)) .. + 3 throughout). A stage is
// copied as it is (RAW bytes), then, where it is transformed, each thread
// transforms what it copied: in place, or (rounding) into a bf16 tile of
// COOKED bytes. Copies are 16 bytes of the source; copy i of a thread is tile
// row (a / PER_ROW), column (a % PER_ROW) E, a = thread + i THREADS.
template <class Tile, class T, class S, bool KMAJOR, bool RELU = false, bool SUM = false,
          class XF = NoXf>
struct TcRows {
  const S* p;
  long long ld;
  int m_lim;
  XF xf = XF{};
  static constexpr bool K_MAJOR = KMAJOR, SUMS = SUM;
  static constexpr bool ROUND = !std::is_same<T, S>::value;
  static constexpr int LD = tile_ld<Tile, T, KMAJOR>(), LDR = tile_ld<Tile, S, KMAJOR>();
  static constexpr int RAW = tile_bytes<Tile, S, KMAJOR>();
  static constexpr int COOKED = ROUND ? tile_bytes<Tile, T, KMAJOR>() : 0;
  static constexpr int E = 16 / static_cast<int>(sizeof(S));
  static constexpr int PER_ROW = (KMAJOR ? TBK : Tile::BM) / E;
  static constexpr int N = Tile::BM * TBK / E / Tile::THREADS;
  static_assert(!SUM || (!KMAJOR && E == 4), "the bias sums take an MN-major f32 operand");
  static_assert(!SUM || Tile::THREADS % PER_ROW == 0, "a thread keeps its columns");
  static_assert(!RELU || std::is_same<S, bf16>::value, "ReLU is applied to bf16 rows");
  static_assert(!XF::ACTIVE || E == 4, "transforms take f32 rows");
  static_assert(!ROUND || (std::is_same<T, bf16>::value && E == 4), "f32 rows round to bf16");
  struct Regs {};

  __device__ __forceinline__ void setup(Regs&, int) const {}
  __device__ __forceinline__ void issue(unsigned char* raw, int m0, int k0, int k_lim) const {
    S* dst = reinterpret_cast<S*>(raw);
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const int a = threadIdx.x + i * Tile::THREADS, row = a / PER_ROW, col = a % PER_ROW * E;
      const int m = m0 + (KMAJOR ? row : col), k = k0 + (KMAJOR ? col : row);
      const bool in = m < m_lim && k < k_lim;
      const long long off = KMAJOR ? static_cast<long long>(m) * ld + k
                                   : static_cast<long long>(k) * ld + m;
      cp_async16(dst + row * LDR + col, in ? p + off : p, in);
    }
  }
  __device__ __forceinline__ void fetch(Regs&, int, int, int) const {}
  __device__ __forceinline__ void prepare(unsigned char* raw, T* cooked, const Regs&, int m0,
                                          int k0, int k_lim, float (&asum)[4]) const {
    if constexpr (ROUND || RELU || SUM || XF::ACTIVE) {
      S* src = reinterpret_cast<S*>(raw);
#pragma unroll
      for (int i = 0; i < N; ++i) {
        const int a = threadIdx.x + i * Tile::THREADS, row = a / PER_ROW, col = a % PER_ROW * E;
        if constexpr (E == 4) {
          float4 f = *reinterpret_cast<const float4*>(src + row * LDR + col);
          if constexpr (SUM) {
            asum[0] = __fadd_rn(asum[0], f.x);
            asum[1] = __fadd_rn(asum[1], f.y);
            asum[2] = __fadd_rn(asum[2], f.z);
            asum[3] = __fadd_rn(asum[3], f.w);
          }
          if constexpr (XF::ACTIVE) {
            const int m = m0 + (KMAJOR ? row : col), k = k0 + (KMAJOR ? col : row);
            // a zero-filled copy stays zero
            if (m < m_lim && k < k_lim) f = xf(f, m, k);
          }
          if constexpr (ROUND)
            store4(cooked + row * LD + col, f.x, f.y, f.z, f.w);
          else if constexpr (XF::ACTIVE)
            *reinterpret_cast<float4*>(src + row * LDR + col) = f;
        } else {
          uint4* v = reinterpret_cast<uint4*>(src + row * LDR + col);
          *v = make_uint4(relu2(v->x), relu2(v->y), relu2(v->z), relu2(v->w));
        }
      }
    }
  }
  // the stage's tile as the products read it
  __device__ __forceinline__ const T* tile(const unsigned char* raw, const T* cooked) const {
    if constexpr (ROUND)
      return cooked;
    else
      return reinterpret_cast<const T*>(raw);
  }
};

// shared memory: STAGES copies (A then B), two transformed tiles of each
// operand that has them, or the accumulator tile and the sums' partials
template <class P, class Tile, class OpA, class OpB>
constexpr size_t tc_smem_bytes() {
  const size_t stages = static_cast<size_t>(P::STAGES) * (OpA::RAW + OpB::RAW) +
                        2ull * (OpA::COOKED + OpB::COOKED);
  const size_t out =
      (static_cast<size_t>(Tile::BM) * Tile::LDC + Tile::GROUPS * Tile::BM) * sizeof(float);
  return stages > out ? stages : out;
}

// The 16 (mn) x 16 (k) block at (mn, k) of a staged bf16 tile as four 8 x 8
// fragments, in the A fragment's order: (mn, k), (mn + 8, k), (mn, k + 8),
// (mn + 8, k + 8); as B fragments, {r0, r2} are columns mn .. mn + 7 and
// {r1, r3} columns mn + 8 .. mn + 15.
template <class Tile, bool KMAJOR>
__device__ __forceinline__ void frag(uint32_t (&r)[4], const bf16* S, int mn, int k) {
  constexpr int L = tile_ld<Tile, bf16, KMAJOR>();
  const int lane = threadIdx.x & 31, j = lane >> 3, i = lane & 7;
  if constexpr (KMAJOR)
    ldsm_x4(r, S + (mn + (j & 1) * 8 + i) * L + k + (j >> 1) * 8);
  else
    ldsm_x4_t(r, S + (k + (j >> 1) * 8 + i) * L + mn + (j & 1) * 8);
}

// The 16 (mn) x 8 (k) block of a staged f32 tile in the tf32 A fragment's
// order: (g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4); as B fragments, {r0,
// r2} are columns mn .. mn + 7 and {r1, r3} columns mn + 8 .. mn + 15.
template <class Tile, bool KMAJOR>
__device__ __forceinline__ void frag(uint32_t (&r)[4], const float* S, int mn, int k) {
  constexpr int L = tile_ld<Tile, float, KMAJOR>();
  const int lane = threadIdx.x & 31;
  if constexpr (KMAJOR) {
    const int j = lane >> 3, i = lane & 7;
    ldsm_x4(r, S + (mn + (j & 1) * 8 + i) * L + k + (j >> 1) * 4);
  } else {
    const float* s = S + (k + (lane & 3)) * L + mn + (lane >> 2);
    r[0] = __float_as_uint(s[0]);
    r[1] = __float_as_uint(s[8]);
    r[2] = __float_as_uint(s[4 * L]);
    r[3] = __float_as_uint(s[4 * L + 8]);
  }
}

// acc += one stage's products for this warp's WTM x WTN outputs: acc[mi][nj]
// is the C fragment of rows 16 mi, columns 8 nj of the warp's piece
template <class P, class Tile, bool KA, bool KB>
__device__ __forceinline__ void tc_products(const typename P::T* As, const typename P::T* Bs,
                                            float (&acc)[Tile::MI][Tile::NJ][4]) {
  constexpr int MI = Tile::MI, NJ = Tile::NJ;
  const int w = threadIdx.x >> 5;
  const int wm = (w / Tile::WARPS_N) * Tile::WTM, wn = (w % Tile::WARPS_N) * Tile::WTN;
  if constexpr (std::is_same<typename P::T, bf16>::value) {
#pragma unroll
    for (int k = 0; k < TBK; k += 16) {
      uint32_t b[NJ][2];
#pragma unroll
      for (int p = 0; p < NJ / 2; ++p) {
        uint32_t r[4];
        frag<Tile, KB>(r, Bs, wn + 16 * p, k);
        b[2 * p][0] = r[0];
        b[2 * p][1] = r[2];
        b[2 * p + 1][0] = r[1];
        b[2 * p + 1][1] = r[3];
      }
#pragma unroll
      for (int mi = 0; mi < MI; ++mi) {
        uint32_t a[4];
        frag<Tile, KA>(a, As, wm + 16 * mi, k);
#pragma unroll
        for (int nj = 0; nj < NJ; ++nj) mma_bf16(acc[mi][nj], a, b[nj]);
      }
    }
  } else {
#pragma unroll
    for (int k = 0; k < TBK; k += 8) {
      uint32_t bb[NJ][2], bs[NJ][2];
#pragma unroll
      for (int p = 0; p < NJ / 2; ++p) {
        uint32_t r[4];
        frag<Tile, KB>(r, Bs, wn + 16 * p, k);
        split(__uint_as_float(r[0]), bb[2 * p][0], bs[2 * p][0]);
        split(__uint_as_float(r[2]), bb[2 * p][1], bs[2 * p][1]);
        split(__uint_as_float(r[1]), bb[2 * p + 1][0], bs[2 * p + 1][0]);
        split(__uint_as_float(r[3]), bb[2 * p + 1][1], bs[2 * p + 1][1]);
      }
#pragma unroll
      for (int mi = 0; mi < MI; ++mi) {
        uint32_t r[4], ab[4], as[4];
        frag<Tile, KA>(r, As, wm + 16 * mi, k);
#pragma unroll
        for (int e = 0; e < 4; ++e) split(__uint_as_float(r[e]), ab[e], as[e]);
        // the three passes of these 8 contraction rows from zero, the small
        // terms first, consecutive products on different accumulators; then
        // one f32 add (round to nearest) into acc. The tensor core's own f32
        // additions truncate: over a weight gradient's chunk of 16,384 rows
        // they drifted 1e-4 of the largest value when they carried the sum.
        float part[NJ][4] = {};
#pragma unroll
        for (int nj = 0; nj < NJ; ++nj) mma_tf32(part[nj], as, bb[nj]);
#pragma unroll
        for (int nj = 0; nj < NJ; ++nj) mma_tf32(part[nj], ab, bs[nj]);
#pragma unroll
        for (int nj = 0; nj < NJ; ++nj) mma_tf32(part[nj], ab, bb[nj]);
#pragma unroll
        for (int nj = 0; nj < NJ; ++nj)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mi][nj][e] = __fadd_rn(acc[mi][nj][e], part[nj][e]);
      }
    }
  }
}

// One BM x BN tile of C = sum_k A(m, k) B(n, k) over k in [kb, ke), with
// tile_rows rows a tile (an epilogue may take fewer than BM), ncol column
// tiles (blockIdx.x = row tile * ncol + column tile), chunk rows of the
// contraction per blockIdx.z. Where OpA sums (a weight gradient's left
// factor), each thread group's sums of A over k for each row m go to the
// partials part[group][m]. Stage s: issue (copies started, STAGES - 1 stages
// ahead), fetch (registers, one stage ahead), prepare (once the thread's
// copies have landed, one stage ahead), products. Then the epilogue:
// epi(C, part, sums, m0, n0, nt, tile_rows), C the f32 tile [BM][LDC].
template <class P, class Tile, class OpA, class OpB, class Epi>
__global__ void __launch_bounds__(Tile::THREADS, Tile::MIN_BLOCKS)
tc_gemm_kernel(OpA opa, OpB opb, Epi epi, int tile_rows, int ncol, int k_len, int chunk) {
  using T = typename P::T;
  constexpr int STAGES = P::STAGES, RAW = OpA::RAW + OpB::RAW, BM = Tile::BM, BN = Tile::BN;
  constexpr int MI = Tile::MI, NJ = Tile::NJ, LDC = Tile::LDC;
  extern __shared__ __align__(128) unsigned char tc_smem[];
  T* const cooked_a = reinterpret_cast<T*>(tc_smem + STAGES * RAW);
  T* const cooked_b = reinterpret_cast<T*>(tc_smem + STAGES * RAW + 2 * OpA::COOKED);
  const int mt = blockIdx.x / ncol, nt = blockIdx.x % ncol;
  const int m0 = mt * tile_rows, n0 = nt * BN;
  const int kb = blockIdx.z * chunk, ke = min(kb + chunk, k_len);
  const int nk = ke > kb ? (ke - kb + TBK - 1) / TBK : 0;
  auto raw_a = [&](int s) { return tc_smem + (s % STAGES) * RAW; };
  auto raw_b = [&](int s) { return tc_smem + (s % STAGES) * RAW + OpA::RAW; };
  auto cook_a = [&](int s) { return cooked_a + (s & 1) * (OpA::COOKED / sizeof(T)); };
  auto cook_b = [&](int s) { return cooked_b + (s & 1) * (OpB::COOKED / sizeof(T)); };

  float acc[MI][NJ][4];
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
  float asum[4] = {0.f, 0.f, 0.f, 0.f}, unused[4];
  typename OpA::Regs ra;
  typename OpB::Regs rb;
  opa.setup(ra, m0);
  opb.setup(rb, n0);
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) {
      opa.issue(raw_a(s), m0, kb + s * TBK, ke);
      opb.issue(raw_b(s), n0, kb + s * TBK, ke);
    }
    cp_commit();
  }
  if (nk > 0) {
    opa.fetch(ra, m0, kb, ke);
    opb.fetch(rb, n0, kb, ke);
    cp_wait<STAGES - 2>();
    opa.prepare(raw_a(0), cook_a(0), ra, m0, kb, ke, asum);
    opb.prepare(raw_b(0), cook_b(0), rb, n0, kb, ke, unused);
  }
  for (int it = 0; it < nk; ++it) {
    // each thread's copies of stage it have landed (the wait before its
    // prepare): now all are visible, and every thread is done with stage it - 1
    __syncthreads();
    const int nx = it + STAGES - 1;
    if (nx < nk) {
      opa.issue(raw_a(nx), m0, kb + nx * TBK, ke);
      opb.issue(raw_b(nx), n0, kb + nx * TBK, ke);
    }
    cp_commit();
    const bool more = it + 1 < nk;
    const int k1 = kb + (it + 1) * TBK;
    if (more) {
      opa.fetch(ra, m0, k1, ke);
      opb.fetch(rb, n0, k1, ke);
    }
    tc_products<P, Tile, OpA::K_MAJOR, OpB::K_MAJOR>(opa.tile(raw_a(it), cook_a(it)),
                                                     opb.tile(raw_b(it), cook_b(it)), acc);
    if (more) {
      cp_wait<STAGES - 2>();
      opa.prepare(raw_a(it + 1), cook_a(it + 1), ra, m0, k1, ke, asum);
      opb.prepare(raw_b(it + 1), cook_b(it + 1), rb, n0, k1, ke, unused);
    }
  }
  cp_wait<0>();
  __syncthreads();

  // the accumulators to the tile C [BM][LDC], the thread's column sums to
  // part[group][m]
  float* C = reinterpret_cast<float*>(tc_smem);
  float* part = C + BM * LDC;
  {
    const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int r0 = (w / Tile::WARPS_N) * Tile::WTM + (lane >> 2);
    const int c0 = (w % Tile::WARPS_N) * Tile::WTN + 2 * (lane & 3);
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int nj = 0; nj < NJ; ++nj) {
        float* c = C + (r0 + 16 * mi) * LDC + c0 + 8 * nj;
        *reinterpret_cast<float2*>(c) = make_float2(acc[mi][nj][0], acc[mi][nj][1]);
        *reinterpret_cast<float2*>(c + 8 * LDC) = make_float2(acc[mi][nj][2], acc[mi][nj][3]);
      }
    if constexpr (OpA::SUMS) {
      constexpr int PER_ROW = BM / 4;
      *reinterpret_cast<float4*>(part + (threadIdx.x / PER_ROW) * BM +
                                 (threadIdx.x % PER_ROW) * 4) =
          make_float4(asum[0], asum[1], asum[2], asum[3]);
    }
  }
  __syncthreads();
  epi(C, part, OpA::SUMS, m0, n0, nt, tile_rows);
}

// tc_gemm_kernel over a grid (blockIdx.z: chunks of `chunk` contraction rows)
template <class P, class Tile, class OpA, class OpB, class Epi>
int tc_launch(OpA a, OpB b, Epi epi, dim3 grid, int tile_rows, int ncol, int k_len, int chunk,
              cudaStream_t stream) {
  auto kernel = tc_gemm_kernel<P, Tile, OpA, OpB, Epi>;
  constexpr size_t smem = tc_smem_bytes<P, Tile, OpA, OpB>();
  static SmemOnce once;
  const int err = once(kernel, smem);
  if (err) return err;
  kernel<<<grid, Tile::THREADS, smem, stream>>>(a, b, epi, tile_rows, ncol, k_len, chunk);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
