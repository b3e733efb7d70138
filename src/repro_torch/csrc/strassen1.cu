// Fused one-level Strassen on quadrant layout:
// (mb, 4, M2, K2) x (mb, 4, K2, N2) -> (mb, 4, M2, N2).
//
// Replaces strassen1_matmul_pallas (src/repro/kernels/strassen/strassen.py:155,
// body _strassen1_kernel at :128). As there, the r operand sums, the r
// products and the combine never touch device memory: A and B quadrant
// tiles are read once, and only the 4 C quadrant tiles are written.
//
// What bounds it: r * 2*M2*N2*K2 flops per leaf against 4*(M2*K2 + K2*N2 +
// M2*N2) elements moved; at the main path's shapes (M2 = K2 = N2 >= 4096)
// that is thousands of flops per byte, so fp32 FMA throughput (67 TFLOP/s on
// the CUDA cores; TF32 would change the result) is the bound. Register
// pressure is the design constraint: r fp32 accumulator micro-tiles live in
// registers for the whole K loop.
//
// Design: one block per (leaf, 64x64 output tile), with the K loop inside
// the block (the TPU kernel's sequential K grid axis). Each K step of 8
// reads the 4 A-quadrant and 4 B-quadrant tiles from device memory, forms
// the r operand-sum tiles as it stores them to shared memory, and each of
// the 256 threads adds r 4x4 outer products into r*16 fp32 accumulators
// (128 registers for r = 8). r is a template parameter so the p loops
// unroll; the coefficient values come in at launch from the Python Scheme.
// After the last K step the accumulators are combined into the 4 C
// quadrants in registers and rounded once to the storage type.
//
// Numerics: operand sums run over q in ascending order, skip zero
// coefficients, are never contracted into an FMA, and are rounded to the
// storage type before the product (a no-op for fp32, one rounding for bf16,
// as the Pallas kernel multiplies bf16 sums). Products accumulate in fp32
// with fp32 FMA, never TF32.
#include "common.cuh"

namespace repro {
namespace {

constexpr int BM = 64, BN = 64, BK = 8, THREADS = 256, MAXR = 8;
constexpr int PAD = 4;  // keeps the transposed A-sum stores free of bank conflicts

struct Strassen1Coefs {
  float a[MAXR][4];
  float b[MAXR][4];
  float c[4][MAXR];
};

// Signed sum over n terms in ascending order, zeros skipped, no contraction.
template <int N>
__device__ __forceinline__ float signed_sum(const float* cf, const float* x) {
  float acc = 0.f;
  bool any = false;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    if (cf[i] != 0.f) {
      const float term = __fmul_rn(cf[i], x[i]);
      acc = any ? __fadd_rn(acc, term) : term;
      any = true;
    }
  }
  return acc;
}

template <typename T, int R>
__global__ void __launch_bounds__(THREADS, 1)
strassen1_kernel(const T* __restrict__ AQ, const T* __restrict__ BQ, T* __restrict__ CQ,
                 int64_t M2, int64_t K2, int64_t N2, const Strassen1Coefs coef) {
  __shared__ __align__(16) float SA[R][BK][BM + PAD];  // operand sums of A, k-major
  __shared__ __align__(16) float SB[R][BK][BN];        // operand sums of B
  const int64_t leaf = blockIdx.z;
  const int64_t a_quad = M2 * K2, b_quad = K2 * N2, c_quad = M2 * N2;
  AQ += leaf * 4 * a_quad;
  BQ += leaf * 4 * b_quad;
  CQ += leaf * 4 * c_quad;
  const int64_t row0 = static_cast<int64_t>(blockIdx.y) * BM;
  const int64_t col0 = static_cast<int64_t>(blockIdx.x) * BN;
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;  // micro-tile rows ty*4+{0..3}, cols tx*4+{0..3}

  float acc[R][4][4];
#pragma unroll
  for (int p = 0; p < R; ++p)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[p][i][j] = 0.f;

  // The next K step's quadrant elements are loaded into registers while the
  // current step computes, so device-memory latency overlaps the FMA loop.
  float qa[BM * BK / THREADS][4], qb[BK * BN / THREADS][4];
  auto load = [&](int64_t k0) {
#pragma unroll
    for (int s = 0; s < BM * BK / THREADS; ++s) {
      const int e = tid + s * THREADS;
      const int64_t gr = row0 + e / BK, gc = k0 + e % BK;
      const bool ok = gr < M2 && gc < K2;
#pragma unroll
      for (int qi = 0; qi < 4; ++qi) qa[s][qi] = ok ? to_f32(AQ[qi * a_quad + gr * K2 + gc]) : 0.f;
    }
#pragma unroll
    for (int s = 0; s < BK * BN / THREADS; ++s) {
      const int e = tid + s * THREADS;
      const int64_t gr = k0 + e / BN, gc = col0 + e % BN;
      const bool ok = gr < K2 && gc < N2;
#pragma unroll
      for (int qi = 0; qi < 4; ++qi) qb[s][qi] = ok ? to_f32(BQ[qi * b_quad + gr * N2 + gc]) : 0.f;
    }
  };

  load(0);
  for (int64_t k0 = 0; k0 < K2; k0 += BK) {
#pragma unroll
    for (int s = 0; s < BM * BK / THREADS; ++s) {
      const int e = tid + s * THREADS;
#pragma unroll
      for (int p = 0; p < R; ++p)
        SA[p][e % BK][e / BK] = round_to<T>(signed_sum<4>(coef.a[p], qa[s]));
    }
#pragma unroll
    for (int s = 0; s < BK * BN / THREADS; ++s) {
      const int e = tid + s * THREADS;
#pragma unroll
      for (int p = 0; p < R; ++p)
        SB[p][e / BN][e % BN] = round_to<T>(signed_sum<4>(coef.b[p], qb[s]));
    }
    __syncthreads();
    if (k0 + BK < K2) load(k0 + BK);
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
#pragma unroll
      for (int p = 0; p < R; ++p) {
        float a[4], b[4];
        ld4(a, &SA[p][kk][ty * 4]);
        ld4(b, &SB[p][kk][tx * 4]);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[p][i][j] = fmaf(a[i], b[j], acc[p][i][j]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int64_t r = row0 + ty * 4 + i;
    if (r >= M2) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int64_t c = col0 + tx * 4 + j;
      if (c >= N2) continue;
      float prods[R];
#pragma unroll
      for (int p = 0; p < R; ++p) prods[p] = acc[p][i][j];
#pragma unroll
      for (int k = 0; k < 4; ++k)
        CQ[k * c_quad + r * N2 + c] = from_f32<T>(signed_sum<R>(coef.c[k], prods));
    }
  }
}

template <typename T, int R>
void launch(const void* aq, const void* bq, void* cq, int64_t mb, int64_t m2, int64_t k2,
            int64_t n2, const Strassen1Coefs& coef, cudaStream_t stream) {
  const dim3 grid((n2 + BN - 1) / BN, (m2 + BM - 1) / BM, mb);
  strassen1_kernel<T, R><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(aq), static_cast<const T*>(bq), static_cast<T*>(cq), m2, k2, n2, coef);
}

template <typename T>
int dispatch_rank(int r, const void* aq, const void* bq, void* cq, int64_t mb, int64_t m2,
                  int64_t k2, int64_t n2, const Strassen1Coefs& coef, cudaStream_t stream) {
  if (r == 7) {
    launch<T, 7>(aq, bq, cq, mb, m2, k2, n2, coef, stream);
  } else if (r == 8) {
    launch<T, 8>(aq, bq, cq, mb, m2, k2, n2, coef, stream);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaSuccess;
}

}  // namespace
}  // namespace repro

// coefs: host array of the scheme's a_coef (r, 4), b_coef (r, 4) and
// c_coef (4, r), each row-major, one after the other.
extern "C" int repro_strassen1(const void* aq, const void* bq, void* cq, int dtype, int r,
                               int64_t mb, int64_t m2, int64_t k2, int64_t n2, const float* coefs,
                               void* stream) {
  using namespace repro;
  if (r < 1 || r > MAXR) return cudaErrorInvalidValue;
  Strassen1Coefs c = {};
  for (int p = 0; p < r; ++p)
    for (int q = 0; q < 4; ++q) {
      c.a[p][q] = coefs[p * 4 + q];
      c.b[p][q] = coefs[r * 4 + p * 4 + q];
    }
  for (int k = 0; k < 4; ++k)
    for (int p = 0; p < r; ++p) c.c[k][p] = coefs[r * 8 + k * r + p];
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  int err;
  if (dtype == kF32) {
    err = dispatch_rank<float>(r, aq, bq, cq, mb, m2, k2, n2, c, s);
  } else if (dtype == kBF16) {
    err = dispatch_rank<__nv_bfloat16>(r, aq, bq, cq, mb, m2, k2, n2, c, s);
  } else {
    return cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}
