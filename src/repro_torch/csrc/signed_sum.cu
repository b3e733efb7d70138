// One divide or combine level: out[b, p] = sum_q coef[p, q] * x[b, q] over planes.
//
// Replaces divide_pallas (src/repro/kernels/strassen/strassen.py:68), which
// maps (m, 4, h, w) quadrants to (m, r, h, w) operand sums, and
// combine_pallas (:105), which maps (m, r, h, w) products to (m, 4, h, w)
// C quadrants. Both are the same signed-sum map with the coefficient rows
// passed in at launch, so one kernel serves both.
//
// What bounds it: each output element costs at most 8 adds against 4 to 8
// elements read and 1 written, so device-memory bandwidth (3.35 TB/s) is the
// bound. Design: every input element is read once and every output written
// once; a thread handles 16 bytes of each plane (a float4 of fp32 or eight
// bf16) when the plane width and the pointers allow, one element otherwise.
//
// Numerics: each sum runs over q in ascending order, skips zero
// coefficients and is never contracted into an FMA, so fp32 results are
// bit-identical to the plain PyTorch version; bf16 inputs are summed in fp32
// and rounded once.
#include "common.cuh"

namespace repro {
namespace {

constexpr int MAXQ = 8, MAXP = 8, THREADS = 256;

struct SumCoefs {
  float c[MAXP][MAXQ];
};

template <typename T, int VEC>
struct Vec;

template <typename T>
struct Vec<T, 1> {
  static __device__ __forceinline__ void load(float* dst, const T* src) { dst[0] = to_f32(*src); }
  static __device__ __forceinline__ void store(T* dst, const float* src) { *dst = from_f32<T>(src[0]); }
};

template <>
struct Vec<float, 4> {
  static __device__ __forceinline__ void load(float* dst, const float* src) {
    const float4 v = *reinterpret_cast<const float4*>(src);
    dst[0] = v.x; dst[1] = v.y; dst[2] = v.z; dst[3] = v.w;
  }
  static __device__ __forceinline__ void store(float* dst, const float* src) {
    *reinterpret_cast<float4*>(dst) = make_float4(src[0], src[1], src[2], src[3]);
  }
};

template <>
struct Vec<__nv_bfloat16, 8> {
  static __device__ __forceinline__ void load(float* dst, const __nv_bfloat16* src) {
    const uint4 v = *reinterpret_cast<const uint4*>(src);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      dst[2 * i] = f.x;
      dst[2 * i + 1] = f.y;
    }
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* dst, const float* src) {
    uint4 v;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(src[2 * i], src[2 * i + 1]);
    *reinterpret_cast<uint4*>(dst) = v;
  }
};

template <typename T, int VEC>
__global__ void __launch_bounds__(THREADS)
signed_sum_kernel(const T* __restrict__ x, T* __restrict__ out, int64_t m, int q, int p,
                  int64_t plane, const SumCoefs coef) {
  const int64_t nvec = plane / VEC;
  const int64_t total = m * nvec;
  for (int64_t t = static_cast<int64_t>(blockIdx.x) * THREADS + threadIdx.x; t < total;
       t += static_cast<int64_t>(gridDim.x) * THREADS) {
    const int64_t b = t / nvec, off = (t % nvec) * VEC;
    const T* xb = x + b * q * plane + off;
    T* ob = out + b * p * plane + off;
    float in[MAXQ][VEC];
#pragma unroll
    for (int qi = 0; qi < MAXQ; ++qi)
      if (qi < q) Vec<T, VEC>::load(in[qi], xb + qi * plane);
#pragma unroll
    for (int pi = 0; pi < MAXP; ++pi) {
      if (pi >= p) break;
      float o[VEC];
#pragma unroll
      for (int v = 0; v < VEC; ++v) {
        float acc = 0.f;
        bool any = false;
#pragma unroll
        for (int qi = 0; qi < MAXQ; ++qi) {
          const float cf = coef.c[pi][qi];
          if (qi < q && cf != 0.f) {
            const float term = __fmul_rn(cf, in[qi][v]);
            acc = any ? __fadd_rn(acc, term) : term;
            any = true;
          }
        }
        o[v] = acc;
      }
      Vec<T, VEC>::store(ob + pi * plane, o);
    }
  }
}

template <typename T, int VEC>
void launch(const void* x, void* out, int64_t m, int q, int p, int64_t plane,
            const SumCoefs& coef, cudaStream_t stream) {
  const int64_t total = m * (plane / VEC);
  const int64_t blocks = (total + THREADS - 1) / THREADS;
  const unsigned grid = static_cast<unsigned>(blocks < (1 << 16) ? blocks : (1 << 16));
  signed_sum_kernel<T, VEC><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(out), m, q, p, plane, coef);
}

bool aligned16(const void* ptr) { return reinterpret_cast<uintptr_t>(ptr) % 16 == 0; }

}  // namespace
}  // namespace repro

// coef: host array of p*q floats, row-major (p, q).
extern "C" int repro_signed_sum(const void* x, void* out, int dtype, int64_t m, int q, int p,
                                int64_t plane, const float* coef, void* stream) {
  using namespace repro;
  if (q < 1 || q > MAXQ || p < 1 || p > MAXP || m < 1 || plane < 1) return cudaErrorInvalidValue;
  SumCoefs c = {};
  for (int i = 0; i < p; ++i)
    for (int j = 0; j < q; ++j) c.c[i][j] = coef[i * q + j];
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec_ok = aligned16(x) && aligned16(out);
  if (dtype == kF32) {
    if (vec_ok && plane % 4 == 0) {
      launch<float, 4>(x, out, m, q, p, plane, c, s);
    } else {
      launch<float, 1>(x, out, m, q, p, plane, c, s);
    }
  } else if (dtype == kBF16) {
    if (vec_ok && plane % 8 == 0) {
      launch<__nv_bfloat16, 8>(x, out, m, q, p, plane, c, s);
    } else {
      launch<__nv_bfloat16, 1>(x, out, m, q, p, plane, c, s);
    }
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}
