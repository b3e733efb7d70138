// Batched matmul (mb, m, k) x (mb, k, n) -> (mb, m, n) with fp32 accumulation.
//
// Replaces batched_matmul_pallas (src/repro/kernels/matmul/matmul.py:95),
// Stark's leaf stage batched over the 7^depth tag index, and matmul_pallas
// (:43), which is this kernel launched with mb = 1.
//
// What bounds it: at the leaf shapes of the main path (e.g. 49 x 4096^3) the
// work is 2*m*n*k*mb flops against (m*k + k*n + m*n)*mb elements moved, far
// above the card's balance point, so fp32 FMA throughput (67 TFLOP/s on the
// CUDA cores; TF32 tensor cores would change the result) is the bound.
//
// Design: one 128x128 output tile per block, 256 threads with an 8x8
// register micro-tile each, K walked in steps of 8 through shared memory.
// bf16 operands are widened to fp32 as they are staged, so both types share
// one FMA loop; the output is rounded once to the storage type. Edges are
// masked, so any (mb, m, k, n) is taken. This is the simple version: no
// tensor cores, no cp.async/TMA pipeline.
#include "common.cuh"

namespace repro {
namespace {

constexpr int BM = 128, BN = 128, BK = 8, THREADS = 256;
constexpr int PAD = 4;  // keeps the transposed A stores free of bank conflicts

template <typename T>
__global__ void __launch_bounds__(THREADS, 2)
batched_matmul_kernel(const T* __restrict__ A, const T* __restrict__ B, T* __restrict__ C,
                      int64_t M, int64_t K, int64_t N) {
  __shared__ __align__(16) float As[BK][BM + PAD];  // k-major, so rows load as float4
  __shared__ __align__(16) float Bs[BK][BN];
  const int64_t batch = blockIdx.z;
  A += batch * M * K;
  B += batch * K * N;
  C += batch * M * N;
  const int64_t row0 = static_cast<int64_t>(blockIdx.y) * BM;
  const int64_t col0 = static_cast<int64_t>(blockIdx.x) * BN;
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;  // rows ty*4+{0..3}, 64+ty*4+{0..3}; same for cols

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  // The next K step's elements are loaded into registers while the current
  // step computes, so device-memory latency overlaps the FMA loop.
  float ra[BM * BK / THREADS], rb[BK * BN / THREADS];
  auto load = [&](int64_t k0) {
#pragma unroll
    for (int s = 0; s < BM * BK / THREADS; ++s) {
      const int e = tid + s * THREADS;
      const int64_t gr = row0 + e / BK, gc = k0 + e % BK;
      ra[s] = (gr < M && gc < K) ? to_f32(A[gr * K + gc]) : 0.f;
    }
#pragma unroll
    for (int s = 0; s < BK * BN / THREADS; ++s) {
      const int e = tid + s * THREADS;
      const int64_t gr = k0 + e / BN, gc = col0 + e % BN;
      rb[s] = (gr < K && gc < N) ? to_f32(B[gr * N + gc]) : 0.f;
    }
  };

  load(0);
  for (int64_t k0 = 0; k0 < K; k0 += BK) {
#pragma unroll
    for (int s = 0; s < BM * BK / THREADS; ++s) {
      const int e = tid + s * THREADS;
      As[e % BK][e / BK] = ra[s];
    }
#pragma unroll
    for (int s = 0; s < BK * BN / THREADS; ++s) {
      const int e = tid + s * THREADS;
      Bs[e / BN][e % BN] = rb[s];
    }
    __syncthreads();
    if (k0 + BK < K) load(k0 + BK);
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[8], b[8];
      ld4(a, &As[kk][ty * 4]);
      ld4(a + 4, &As[kk][64 + ty * 4]);
      ld4(b, &Bs[kk][tx * 4]);
      ld4(b + 4, &Bs[kk][64 + tx * 4]);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int64_t r = row0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
    if (r >= M) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int64_t c = col0 + (j < 4 ? tx * 4 + j : 64 + tx * 4 + j - 4);
      if (c < N) C[r * N + c] = from_f32<T>(acc[i][j]);
    }
  }
}

template <typename T>
void launch(const void* a, const void* b, void* c, int64_t mb, int64_t m, int64_t k, int64_t n,
            cudaStream_t stream) {
  const dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM, mb);
  batched_matmul_kernel<T><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), static_cast<T*>(c), m, k, n);
}

}  // namespace
}  // namespace repro

extern "C" int repro_batched_matmul(const void* a, const void* b, void* c, int dtype, int64_t mb,
                                    int64_t m, int64_t k, int64_t n, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == repro::kF32) {
    repro::launch<float>(a, b, c, mb, m, k, n, s);
  } else if (dtype == repro::kBF16) {
    repro::launch<__nv_bfloat16>(a, b, c, mb, m, k, n, s);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}
