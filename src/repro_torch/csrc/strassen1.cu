// Fused one-level Strassen on quadrant layout:
// (mb, 4, M2, K2) x (mb, 4, K2, N2) -> (mb, 4, M2, N2).
//
// Replaces strassen1_matmul_pallas (src/repro/kernels/strassen/strassen.py:155,
// body _strassen1_kernel at :128). As there, the r operand sums, the r
// products and the combine never touch device memory: A and B quadrant
// tiles are read, and only the 4 C quadrant tiles are written.
//
// What bounds it: r * 2*M2*N2*K2 flops per leaf against 4*(M2*K2 + K2*N2 +
// M2*N2) elements of device memory; at the main path's shapes (M2 = K2 = N2
// >= 4096) that is thousands of flops per byte, so the bound is the bf16
// tensor-core rate (989 TFLOP/s) for bf16 and the fp32 CUDA-core rate (67
// TFLOP/s; TF32 would change the result) for fp32. Inside the card the
// limits are the L2 and the CUDA cores: a block re-reads the quadrant tiles
// of every nonzero operand coefficient of every product (12 + 12 tile reads
// for Strassen's 7 products against 4 + 4 quadrants, 25 flops a byte for a
// 128 x 64 bf16 tile), and forms the operand sums on the CUDA cores.
//
// Design: one block per (leaf, 128 x 64 output tile) of all four C
// quadrants, with the K loop inside the block. The block walks the r
// products one at a time (p = 0 .. r-1), and for each product its K steps:
//   1. one thread has the TMA copy the nonzero A- and B-quadrant tiles of
//      a_coef[p] and b_coef[p] for step s + ns - 1 into a ring of ns raw
//      stages (as many as shared memory holds, 2 to 8), each completing on
//      its own mbarrier; ragged edges arrive zero-filled;
//   2. the block forms the operand-sum tiles of step s + 1 from the ring:
//      adds over q in ascending order, zeros skipped, no contraction, each
//      term and each partial sum rounded to the storage type (the Pallas
//      kernel forms its operands in the input dtype, one rounding per op;
//      in fp32 these roundings do nothing), into a double-buffered sum tile;
//   3. meanwhile the product M_p accumulates step s in fp32;
//   4. after M_p's last K step, c_coef[k][p] * M_p goes into the C
//      accumulator of each quadrant k where it is nonzero: the first nonzero
//      term is assigned and later ones added, in ascending p, with __fmul_rn
//      and __fadd_rn (signed_sum's order, so the combine rounds as before);
//   5. C is written as fp32 or bf16 (out_dtype, whatever the operands):
//      the fp32 accumulators as they are, or rounded once to bf16, as the
//      Pallas kernel's _flush casts its fp32 combine to o_ref's dtype.
// Only one product accumulator and the four C accumulators are live.
//
//   bf16: two warpgroups, each owning 64 x 64 of the tile, multiply with
//   wgmma.mma_async m64n64k16 (fp32 accumulate) reading both operands from
//   shared memory: the A operand K-major and the B operand N-major (the
//   transpose bit), both in the 128-byte swizzle in which the TMA lands the
//   raw tiles, so that forming a sum is elementwise over the same offsets.
//   An operand with one nonzero coefficient of +-1 is the raw tile itself:
//   wgmma reads it in place and its sign moves into the combine coefficient
//   (negation is exact, so M_p and the combine round as before). A sum of
//   two +-1 terms is one bf16x2 FMA, x0 * c0 + c1 * x1, rounded once: equal
//   bit for bit to the fp32 sum rounded to bf16 (two bf16 values' exact sum
//   is an fp32 value unless their exponents lie more than 16 apart, and then
//   both roundings give the larger term). The product's 32 and the C quadrants'
//   4 x 32 fp32 registers share wgmma's fragment layout, so the combine is
//   register to register. The wgmma of step s runs on the tensor cores
//   while the same threads form step s + 1's sums. K step 64.
//
//   fp32: 256 threads on the CUDA cores (FMA, never TF32), each an 8 x 4
//   micro-tile of M_p (32 registers; rows in two groups of 4, 64 apart, so
//   each k reads two float4 of the k-major A sum and one of the B sum) and
//   the same 8 x 4 of the four C accumulators (128 registers). K step 32.
//
// Shapes whose rows are not a multiple of 16 bytes (K2 or N2 ragged), which
// the TMA cannot address, load tiles element by element into the same ring
// and layout.
#include <algorithm>
#include <cmath>

#include "hopper.cuh"

namespace repro {
namespace {

constexpr int MAXR = 8;
constexpr int MAX_STAGES = 8;

struct Strassen1Coefs {
  float c[4][MAXR];
  // The nonzero operand terms of each product, in ascending q.
  int na[MAXR], nb[MAXR];
  int aq[MAXR][4], bq[MAXR][4];
  float av[MAXR][4], bv[MAXR][4];
  int first[4];  // the first p with c[k][p] != 0 (-1 if none)
  // bf16: an operand of one +-1 term is read raw; sign[p] is the product of
  // the raw operands' signs, folded into the combine coefficients.
  int raw_a[MAXR], raw_b[MAXR];
  float sign[MAXR];
};

template <typename T>
struct Cfg;
template <>
struct Cfg<__nv_bfloat16> {
  static constexpr int BM = 128, BN = 64, BK = 64, THREADS = 256;
};
template <>
struct Cfg<float> {
  static constexpr int BM = 128, BN = 64, BK = 32, THREADS = 256;
  static constexpr int PAD = 4;  // rows of the k-major A sum stay float4-aligned
};

// ------------------------------------------------------------ shared parts
struct Shape {
  int64_t M2, K2, N2, a_quad, b_quad, c_quad;
  int tiles_m, tiles_n, tiles;  // output tiles of one leaf
  int nk;                       // K steps per product
  bool tma;                     // rows are whole 16-byte chunks: TMA; else element loads
};

struct Tile {
  int64_t row0, col0;
  int leaf;
};

// Offset of element (r, c) in a raw or sum tile with rows of W elements:
// the 128-byte swizzle (16-byte chunk k of row r at k ^ (r % 8)) for bf16,
// plain row-major for fp32.
template <typename T, int W>
__device__ __forceinline__ int tile_offset(int r, int c) {
  if constexpr (sizeof(T) == 2) {
    return r * W + ((((c >> 3) ^ r) & 7) << 3) + (c & 7);
  } else {
    return r * W + c;
  }
}

// Starts the copies of step (p, k0)'s raw quadrant tiles into one ring stage:
// na A tiles [BM][BK] then nb B tiles [BK][BN], zero-filled past the edges.
// With the TMA, thread 0 issues them and they complete on bar; else every
// thread copies elements, visible after the next __syncthreads.
template <typename T, int BM, int BN, int BK, int THREADS>
__device__ __forceinline__ void load_step(T* stage, const T* __restrict__ A, const T* __restrict__ B,
                                          const CUtensorMap* map_a, const CUtensorMap* map_b,
                                          uint64_t* bar, const Shape& sh, const Tile& t,
                                          const Strassen1Coefs& cf, int p, int64_t k0) {
  const int na = cf.na[p], nb = cf.nb[p];
  if (sh.tma) {
    if (threadIdx.x == 0) {
      mbar_expect_tx(bar, static_cast<uint32_t>((na * BM * BK + nb * BK * BN) * sizeof(T)));
      for (int j = 0; j < na; ++j)
        tma_load(stage + j * BM * BK, map_a, bar, static_cast<int>(k0), static_cast<int>(t.row0),
                 t.leaf * 4 + cf.aq[p][j]);
      for (int j = 0; j < nb; ++j)
        tma_load(stage + na * BM * BK + j * BK * BN, map_b, bar, static_cast<int>(t.col0),
                 static_cast<int>(k0), t.leaf * 4 + cf.bq[p][j]);
    }
    return;
  }
  for (int j = 0; j < na; ++j) {
    const T* src = A + (t.leaf * 4 + cf.aq[p][j]) * sh.a_quad;
    T* dst = stage + j * BM * BK;
    for (int e = threadIdx.x; e < BM * BK; e += THREADS) {
      const int r = e / BK, c = e % BK;
      const int64_t gr = t.row0 + r, gc = k0 + c;
      dst[tile_offset<T, BK>(r, c)] = (gr < sh.M2 && gc < sh.K2) ? src[gr * sh.K2 + gc] : from_f32<T>(0.f);
    }
  }
  for (int j = 0; j < nb; ++j) {
    const T* src = B + (t.leaf * 4 + cf.bq[p][j]) * sh.b_quad;
    T* dst = stage + na * BM * BK + j * BK * BN;
    for (int e = threadIdx.x; e < BK * BN; e += THREADS) {
      const int r = e / BN, c = e % BN;
      const int64_t gr = k0 + r, gc = t.col0 + c;
      dst[tile_offset<T, BN>(r, c)] = (gr < sh.K2 && gc < sh.N2) ? src[gr * sh.N2 + gc] : from_f32<T>(0.f);
    }
  }
}

// Signed sum of n raw VEC-element chunks (stride apart) in ascending order:
// the first term assigned, later ones added, no contraction, each term and
// each partial sum rounded to T (as the Pallas kernel's sums in T are).
template <typename T, int VEC>
__device__ __forceinline__ void chunk_sum(float* acc, const T* src, int stride, const float* cv, int n) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if (j >= n) break;
    float x[VEC];
    Vec<T, VEC>::load(x, src + j * stride);
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      const float term = round_to<T>(__fmul_rn(cv[j], x[i]));
      acc[i] = j == 0 ? term : round_to<T>(__fadd_rn(acc[i], term));
    }
  }
}

// The operand sum of n bf16 tiles (stride apart) over `chunks` 16-byte
// chunks at the same offsets, written to dst: one bf16x2 FMA a pair when it
// is two +-1 terms, else chunk_sum's sum, rounded after each term.
template <int THREADS>
__device__ __forceinline__ void form_bf16(__nv_bfloat16* dst, const __nv_bfloat16* src, int stride,
                                          int chunks, const float* cv, int n) {
  const bool pair = n == 2 && fabsf(cv[0]) == 1.f && fabsf(cv[1]) == 1.f;
  if (pair) {
    const __nv_bfloat162 c0 = __float2bfloat162_rn(cv[0]);
    const uint32_t flip = cv[1] < 0.f ? 0x80008000u : 0u;  // exact negation of the second term
    for (int e = threadIdx.x; e < chunks; e += THREADS) {
      const uint4 x0 = *reinterpret_cast<const uint4*>(src + e * 8);
      uint4 x1 = *reinterpret_cast<const uint4*>(src + stride + e * 8);
      x1.x ^= flip; x1.y ^= flip; x1.z ^= flip; x1.w ^= flip;
      uint4 out;
      const __nv_bfloat162* a = reinterpret_cast<const __nv_bfloat162*>(&x0);
      const __nv_bfloat162* b = reinterpret_cast<const __nv_bfloat162*>(&x1);
      __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(&out);
#pragma unroll
      for (int i = 0; i < 4; ++i) o[i] = __hfma2(a[i], c0, b[i]);
      *reinterpret_cast<uint4*>(dst + e * 8) = out;
    }
    return;
  }
  for (int e = threadIdx.x; e < chunks; e += THREADS) {
    float v[8];
    chunk_sum<__nv_bfloat16, 8>(v, src + e * 8, stride, cv, n);
    Vec<__nv_bfloat16, 8>::store(dst + e * 8, v);
  }
}

template <int BM, int BN, int BK>
__device__ __forceinline__ Shape make_shape(int64_t M2, int64_t K2, int64_t N2, bool tma) {
  Shape sh;
  sh.M2 = M2; sh.K2 = K2; sh.N2 = N2;
  sh.a_quad = M2 * K2; sh.b_quad = K2 * N2; sh.c_quad = M2 * N2;
  sh.tiles_m = static_cast<int>((M2 + BM - 1) / BM);
  sh.tiles_n = static_cast<int>((N2 + BN - 1) / BN);
  sh.tiles = sh.tiles_m * sh.tiles_n;
  sh.nk = static_cast<int>((K2 + BK - 1) / BK);
  sh.tma = tma;
  return sh;
}

// Block u's tile: leaf u / tiles, tiles row-major within a leaf. (A grouped
// raster order for L2 reuse measured no different on the card.)
template <int BM, int BN>
__device__ __forceinline__ Tile tile_at(const Shape& sh, int u) {
  const int bid = u % sh.tiles;
  Tile t;
  t.row0 = static_cast<int64_t>(bid / sh.tiles_n) * BM;
  t.col0 = static_cast<int64_t>(bid % sh.tiles_n) * BN;
  t.leaf = u / sh.tiles;
  return t;
}

// One K step of one product, with its ring stage and that stage's mbarrier
// phase, advanced by counting (no division in the loop).
struct Step {
  int p = 0, ks = 0, slot = 0, phase = 0;
  __device__ __forceinline__ void next(int nk, int ns) {
    if (++ks == nk) { ks = 0; ++p; }
    if (++slot == ns) { slot = 0; phase ^= 1; }
  }
};

// ------------------------------------------------------------ bf16 kernel
template <int R, typename OutT>
__global__ void __launch_bounds__(256, 1)
strassen1_wgmma_kernel(const __grid_constant__ CUtensorMap map_a, const __grid_constant__ CUtensorMap map_b,
                       const __nv_bfloat16* __restrict__ AQ, const __nv_bfloat16* __restrict__ BQ,
                       OutT* __restrict__ CQ, int64_t M2, int64_t K2, int64_t N2,
                       int stage_elems, int ns, bool tma, const Strassen1Coefs coef) {
  using T = __nv_bfloat16;
  using C = Cfg<T>;
  constexpr int BM = C::BM, BN = C::BN, BK = C::BK, THREADS = C::THREADS;
  constexpr int SUM_A = BM * BK, SUM_B = BK * BN;  // elements of one tile
  __shared__ Strassen1Coefs cf;
  __shared__ __align__(8) uint64_t full[MAX_STAGES];  // a stage's tiles have landed
  extern __shared__ uint8_t smem_raw[];
  // Swizzled tiles must start on 1024 bytes.
  T* smem = reinterpret_cast<T*>(smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023));
  T* sums = smem;                          // 2 x (A sum, B sum)
  T* ring = smem + 2 * (SUM_A + SUM_B);    // ns raw stages

  const int tid = threadIdx.x;
  if (tid == 0) {
    cf = coef;
    for (int i = 0; i < ns; ++i) mbar_init(&full[i]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  const Shape sh = make_shape<BM, BN, BK>(M2, K2, N2, tma);
  const Tile t = tile_at<BM, BN>(sh, blockIdx.x);
  __syncthreads();

  const int wg = tid / 128, warp = (tid / 32) % 4, lane = tid % 32;
  float acc[32];
  float cacc[4][32];
#pragma unroll
  for (int k = 0; k < 4; ++k)
#pragma unroll
    for (int i = 0; i < 32; ++i) cacc[k][i] = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;

  // Step s's raw tiles go to ring stage s % ns, ns - 1 steps ahead of its sums.
  const int S = R * sh.nk;
  Step ld;
  int loaded = 0;
  auto issue = [&]() {
    if (loaded == S) return;
    load_step<T, BM, BN, BK, THREADS>(ring + ld.slot * stage_elems, AQ, BQ, &map_a, &map_b, &full[ld.slot],
                                      sh, t, cf, ld.p, static_cast<int64_t>(ld.ks) * BK);
    ld.next(sh.nk, ns);
    ++loaded;
  };
  auto arrived = [&](const Step& st) {
    if (sh.tma) mbar_wait(&full[st.slot], st.phase);
  };
  // Forms a step's operand sums (those not read raw) into sum buffer buf.
  auto form = [&](const Step& st, int buf) {
    const int p = st.p;
    const T* raw = ring + st.slot * stage_elems;
    T* sa = sums + buf * (SUM_A + SUM_B);
    if (!cf.raw_a[p]) form_bf16<THREADS>(sa, raw, SUM_A, SUM_A / 8, cf.av[p], cf.na[p]);
    if (!cf.raw_b[p]) form_bf16<THREADS>(sa + SUM_A, raw + cf.na[p] * SUM_A, SUM_B, SUM_B / 8, cf.bv[p], cf.nb[p]);
  };

  for (int i = 0; i < ns - 1; ++i) issue();
  Step cur, nxt;
  nxt.next(sh.nk, ns);
  arrived(cur);
  __syncthreads();
  form(cur, 0);
  fence_proxy_async();
  __syncthreads();

  for (int s = 0; s < S; ++s) {
    const int p = cur.p, buf = s & 1;
    issue();  // into the stage that step s - 1 has left
    {
      const T* raw = ring + cur.slot * stage_elems;
      const T* sum = sums + buf * (SUM_A + SUM_B);
      const T* sa = (cf.raw_a[p] ? raw : sum) + wg * 64 * BK;
      const T* sb = cf.raw_b[p] ? raw + cf.na[p] * SUM_A : sum + SUM_A;
      const uint32_t a_addr = smem_u32(sa), b_addr = smem_u32(sb);
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        // A advances 16 elements (32 bytes) along its rows; B 16 rows (2048 bytes).
        wgmma_64x64x16(acc, sw128_desc(a_addr + kk * 32), sw128_desc(b_addr + kk * 2048),
                       (cur.ks > 0 || kk > 0) ? 1 : 0);
      }
      wgmma_commit();
    }
    if (s + 1 < S) {
      arrived(nxt);
      if (!sh.tma) __syncthreads();
      form(nxt, buf ^ 1);
    }
    wgmma_wait<0>();
    fence_regs(acc);
    fence_proxy_async();
    __syncthreads();
    if (cur.ks == sh.nk - 1) {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float cv = cf.c[k][p] * cf.sign[p];
        if (cv == 0.f) continue;
        const bool assign = p == cf.first[k];
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const float term = __fmul_rn(cv, acc[i]);
          cacc[k][i] = assign ? term : __fadd_rn(cacc[k][i], term);
        }
      }
    }
    cur = nxt;
    nxt.next(sh.nk, ns);
  }

  // Store C, rounded once to OutT. wgmma's accumulator layout: register
  // 4i + 2h + j of lane l in warp w is row 16w + l/4 + 8h, column
  // 8i + 2(l%4) + j of the warpgroup's 64 x 64. A pair is one store of 4
  // (bf16) or 8 (fp32) bytes.
  OutT* cq = CQ + static_cast<int64_t>(t.leaf) * 4 * sh.c_quad;
  const bool pairs = N2 % 2 == 0 && reinterpret_cast<uintptr_t>(CQ) % (2 * sizeof(OutT)) == 0;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int64_t r = t.row0 + wg * 64 + warp * 16 + lane / 4 + 8 * h;
    if (r >= M2) continue;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int64_t c = t.col0 + 8 * i + 2 * (lane % 4);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        OutT* dst = cq + k * sh.c_quad + r * N2 + c;
        const float v[2] = {cacc[k][4 * i + 2 * h], cacc[k][4 * i + 2 * h + 1]};
        if (pairs && c + 1 < N2) {
          store_vec<OutT, 2>(dst, v);
        } else {
          if (c < N2) dst[0] = from_f32<OutT>(v[0]);
          if (c + 1 < N2) dst[1] = from_f32<OutT>(v[1]);
        }
      }
    }
  }
}

// ------------------------------------------------------------ fp32 kernel
template <int R, typename OutT>
__global__ void __launch_bounds__(256, 1)
strassen1_fma_kernel(const __grid_constant__ CUtensorMap map_a, const __grid_constant__ CUtensorMap map_b,
                     const float* __restrict__ AQ, const float* __restrict__ BQ, OutT* __restrict__ CQ,
                     int64_t M2, int64_t K2, int64_t N2, int stage_elems, int ns, bool tma,
                     const Strassen1Coefs coef) {
  using T = float;
  using C = Cfg<T>;
  constexpr int BM = C::BM, BN = C::BN, BK = C::BK, THREADS = C::THREADS, LDA = BM + C::PAD;
  constexpr int SUM_A = BK * LDA, SUM_B = BK * BN;
  __shared__ Strassen1Coefs cf;
  __shared__ __align__(8) uint64_t full[MAX_STAGES];
  extern __shared__ uint8_t smem_raw[];
  // TMA destinations must start on 128 bytes.
  float* sums = reinterpret_cast<float*>(smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023));
  float* ring = sums + 2 * (SUM_A + SUM_B);  // ns raw stages

  const int tid = threadIdx.x;
  if (tid == 0) {
    cf = coef;
    for (int i = 0; i < ns; ++i) mbar_init(&full[i]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  const Shape sh = make_shape<BM, BN, BK>(M2, K2, N2, tma);
  const Tile t = tile_at<BM, BN>(sh, blockIdx.x);
  __syncthreads();

  // Micro-tile: rows ty*4 + {0..3} and 64 + ty*4 + {0..3} (i = 0..7),
  // columns tx*4 + {0..3} (j); element (i, j) of acc[i * 4 + j].
  const int tx = tid % 16, ty = tid / 16;
  float acc[32], cacc[4][32];
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    acc[i] = 0.f;
#pragma unroll
    for (int k = 0; k < 4; ++k) cacc[k][i] = 0.f;
  }

  const int S = R * sh.nk;
  Step ld;
  int loaded = 0;
  auto issue = [&]() {
    if (loaded == S) return;
    load_step<T, BM, BN, BK, THREADS>(ring + ld.slot * stage_elems, AQ, BQ, &map_a, &map_b, &full[ld.slot],
                                      sh, t, cf, ld.p, static_cast<int64_t>(ld.ks) * BK);
    ld.next(sh.nk, ns);
    ++loaded;
  };
  auto arrived = [&](const Step& st) {
    if (sh.tma) mbar_wait(&full[st.slot], st.phase);
  };
  auto form = [&](const Step& st, int buf) {
    const int p = st.p;
    const float* raw = ring + st.slot * stage_elems;
    float* sa = sums + buf * (SUM_A + SUM_B);
    float* sb = sa + SUM_A;
    const int na = cf.na[p], nb = cf.nb[p];
#pragma unroll
    for (int e = tid; e < BM * BK / 4; e += THREADS) {
      const int r = e / (BK / 4), c = (e % (BK / 4)) * 4;
      float v[4];
      chunk_sum<float, 4>(v, raw + r * BK + c, BM * BK, cf.av[p], na);
#pragma unroll
      for (int i = 0; i < 4; ++i) sa[(c + i) * LDA + r] = v[i];
    }
    const float* rawb = raw + na * BM * BK;
#pragma unroll
    for (int e = tid; e < BK * BN / 4; e += THREADS) {
      float v[4];
      chunk_sum<float, 4>(v, rawb + e * 4, BK * BN, cf.bv[p], nb);
      Vec<float, 4>::store(sb + e * 4, v);
    }
  };

  for (int i = 0; i < ns - 1; ++i) issue();
  Step cur, nxt;
  nxt.next(sh.nk, ns);
  arrived(cur);
  __syncthreads();
  form(cur, 0);
  __syncthreads();

  for (int s = 0; s < S; ++s) {
    const int p = cur.p, buf = s & 1;
    issue();  // into the stage that step s - 1's sums have left
    {
      const float* sa = sums + buf * (SUM_A + SUM_B);
      const float* sb = sa + SUM_A;
#pragma unroll
      for (int kk = 0; kk < BK; ++kk) {
        float a[8], b[4];
        ld4(a, sa + kk * LDA + ty * 4);
        ld4(a + 4, sa + kk * LDA + 64 + ty * 4);
        ld4(b, sb + kk * BN + tx * 4);
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i * 4 + j] = fmaf(a[i], b[j], acc[i * 4 + j]);
      }
    }
    if (s + 1 < S) {
      arrived(nxt);
      if (!sh.tma) __syncthreads();
      form(nxt, buf ^ 1);
    }
    fence_proxy_async();  // this step's raw stage is refilled by the TMA later
    __syncthreads();
    if (cur.ks == sh.nk - 1) {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float cv = cf.c[k][p];
        if (cv == 0.f) continue;
        const bool assign = p == cf.first[k];
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const float term = __fmul_rn(cv, acc[i]);
          cacc[k][i] = assign ? term : __fadd_rn(cacc[k][i], term);
        }
      }
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[i] = 0.f;
    }
    cur = nxt;
    nxt.next(sh.nk, ns);
  }

  OutT* cq = CQ + static_cast<int64_t>(t.leaf) * 4 * sh.c_quad;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int64_t r = t.row0 + (i / 4) * 64 + ty * 4 + i % 4;
    if (r >= M2) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int64_t c = t.col0 + tx * 4 + j;
      if (c >= N2) continue;
#pragma unroll
      for (int k = 0; k < 4; ++k) cq[k * sh.c_quad + r * N2 + c] = from_f32<OutT>(cacc[k][i * 4 + j]);
    }
  }
}

// ------------------------------------------------------------------- host
// Elements of one raw ring stage: the largest over p of the product's
// nonzero A tiles plus B tiles (1024-byte multiples, for the swizzle base).
template <typename T>
int stage_elems(const Strassen1Coefs& c, int r) {
  using C = Cfg<T>;
  int most = 0;
  for (int p = 0; p < r; ++p) most = std::max(most, c.na[p] * C::BM * C::BK + c.nb[p] * C::BK * C::BN);
  const int per_kb = 1024 / static_cast<int>(sizeof(T));
  return (most + per_kb - 1) / per_kb * per_kb;
}

// Raw ring stages that fit beside the fixed shared memory: 2 to MAX_STAGES.
int ring_stages(int fixed_bytes, int stage_bytes) {
  constexpr int kLimit = 232448 - static_cast<int>(sizeof(Strassen1Coefs)) - 8 * MAX_STAGES;  // per block
  return std::max(2, std::min(MAX_STAGES, (kLimit - fixed_bytes) / stage_bytes));
}

template <int R, typename T, typename OutT, typename Kernel>
cudaError_t launch(Kernel kernel, int fixed_bytes, const void* aq, const void* bq, void* cq, int64_t mb,
                   int64_t m2, int64_t k2, int64_t n2, const Strassen1Coefs& coef, cudaStream_t stream) {
  using C = Cfg<T>;
  constexpr int VEC = 16 / sizeof(T);
  const int stage = stage_elems<T>(coef, R);
  const int ns = ring_stages(fixed_bytes, stage * sizeof(T));
  const int smem = fixed_bytes + ns * stage * static_cast<int>(sizeof(T));
  // The TMA addresses rows of whole 16-byte chunks from 16-byte-aligned bases.
  const bool tma = aligned16(aq) && aligned16(bq) && k2 % VEC == 0 && n2 % VEC == 0;
  CUtensorMap map_a = {}, map_b = {};
  if (tma) {
    if (!make_map<T>(&map_a, aq, 4 * mb, m2, k2, C::BM, C::BK) ||
        !make_map<T>(&map_b, bq, 4 * mb, k2, n2, C::BK, C::BN)) {
      return cudaErrorInvalidValue;
    }
  }
  const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int64_t blocks = (m2 + C::BM - 1) / C::BM * ((n2 + C::BN - 1) / C::BN) * mb;
  if (blocks > INT32_MAX) return cudaErrorInvalidValue;
  kernel<<<static_cast<unsigned>(blocks), C::THREADS, smem, stream>>>(
      map_a, map_b, static_cast<const T*>(aq), static_cast<const T*>(bq), static_cast<OutT*>(cq), m2, k2, n2,
      stage, ns, tma, coef);
  return cudaGetLastError();
}

template <int R, typename OutT>
cudaError_t launch_rank(int dtype, const void* aq, const void* bq, void* cq, int64_t mb, int64_t m2,
                        int64_t k2, int64_t n2, const Strassen1Coefs& coef, cudaStream_t stream) {
  if (dtype == kBF16) {
    using C = Cfg<__nv_bfloat16>;
    const int fixed = 1024 + 2 * (C::BM * C::BK + C::BK * C::BN) * 2;  // alignment slack + 2 sum tiles
    return launch<R, __nv_bfloat16, OutT>(strassen1_wgmma_kernel<R, OutT>, fixed, aq, bq, cq, mb, m2, k2, n2,
                                          coef, stream);
  }
  if (dtype == kF32) {
    using C = Cfg<float>;
    const int fixed = 1024 + 2 * (C::BK * (C::BM + C::PAD) + C::BK * C::BN) * 4;
    return launch<R, float, OutT>(strassen1_fma_kernel<R, OutT>, fixed, aq, bq, cq, mb, m2, k2, n2, coef,
                                  stream);
  }
  return cudaErrorInvalidValue;
}

template <int R>
cudaError_t launch_out(int dtype, int out_dtype, const void* aq, const void* bq, void* cq, int64_t mb,
                       int64_t m2, int64_t k2, int64_t n2, const Strassen1Coefs& coef, cudaStream_t stream) {
  if (out_dtype == kF32) return launch_rank<R, float>(dtype, aq, bq, cq, mb, m2, k2, n2, coef, stream);
  if (out_dtype == kBF16) return launch_rank<R, __nv_bfloat16>(dtype, aq, bq, cq, mb, m2, k2, n2, coef, stream);
  return cudaErrorInvalidValue;
}

}  // namespace
}  // namespace repro

// aq, bq of type dtype; cq of type out_dtype (fp32 or bf16, either way).
// coefs: host array of the scheme's a_coef (r, 4), b_coef (r, 4) and
// c_coef (4, r), each row-major, one after the other.
extern "C" int repro_strassen1(const void* aq, const void* bq, void* cq, int dtype, int out_dtype, int r,
                               int64_t mb, int64_t m2, int64_t k2, int64_t n2, const float* coefs,
                               void* stream) {
  using namespace repro;
  if (r < 1 || r > MAXR || mb < 1 || mb > 65535 || m2 > INT32_MAX || k2 > INT32_MAX || n2 > INT32_MAX) {
    return cudaErrorInvalidValue;
  }
  Strassen1Coefs c = {};
  for (int p = 0; p < r; ++p) {
    for (int q = 0; q < 4; ++q) {
      const float a = coefs[p * 4 + q], b = coefs[r * 4 + p * 4 + q];
      if (a != 0.f) { c.aq[p][c.na[p]] = q; c.av[p][c.na[p]++] = a; }
      if (b != 0.f) { c.bq[p][c.nb[p]] = q; c.bv[p][c.nb[p]++] = b; }
    }
    if (c.na[p] == 0 || c.nb[p] == 0) return cudaErrorInvalidValue;  // a zero operand row
    c.raw_a[p] = dtype == kBF16 && c.na[p] == 1 && std::fabs(c.av[p][0]) == 1.f;
    c.raw_b[p] = dtype == kBF16 && c.nb[p] == 1 && std::fabs(c.bv[p][0]) == 1.f;
    c.sign[p] = (c.raw_a[p] ? c.av[p][0] : 1.f) * (c.raw_b[p] ? c.bv[p][0] : 1.f);
  }
  for (int k = 0; k < 4; ++k) {
    c.first[k] = -1;
    for (int p = 0; p < r; ++p) {
      c.c[k][p] = coefs[r * 8 + k * r + p];
      if (c.c[k][p] != 0.f && c.first[k] < 0) c.first[k] = p;
    }
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (r == 7) {
    err = launch_out<7>(dtype, out_dtype, aq, bq, cq, mb, m2, k2, n2, c, s);
  } else if (r == 8) {
    err = launch_out<8>(dtype, out_dtype, aq, bq, cq, mb, m2, k2, n2, c, s);
  } else {
    return cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}
