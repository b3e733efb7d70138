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
// bf16) when the plane width and the pointers allow, one element otherwise
// (and for bf16 with coefficients other than 0 and +-1, which no scheme has).
//
// Numerics: each sum runs over q in ascending order, skips zero
// coefficients and is never contracted into an FMA. As the Pallas kernels'
// _signed_sum adds in the input dtype, each term and each partial sum is
// rounded to the storage type (the identity in fp32, one round-to-nearest-even
// per add in bf16), so results are bit-identical to the plain PyTorch version.
//
// bf16 in 16-byte chunks with coefficients of 0 and +-1 (every scheme's) runs
// on packed bf16x2 pairs, never unpacked to fp32: a -1 term is its sign bit
// flipped, exact as the plain version's product, and __hadd2 is the plain
// version's rounded fp32 add (an fp32 sum of two bf16 values, rounded to
// bf16, is the correctly rounded bf16 sum: double rounding is innocuous when
// the wider format holds 2 x 8 + 2 bits). Unpacked to fp32 with each add
// rounded, the same chunks ran 22-31% slower than summed in fp32 and rounded
// once; packed, about twice as fast (at 16384^2, tools/signed_sum_variants.py).
#include "common.cuh"

namespace repro {
namespace {

constexpr int MAXQ = 8, MAXP = 8, THREADS = 256;

struct SumCoefs {
  float c[MAXP][MAXQ];
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
            const float term = round_to<T>(__fmul_rn(cf, in[qi][v]));
            acc = any ? round_to<T>(__fadd_rn(acc, term)) : term;
            any = true;
          }
        }
        o[v] = acc;
      }
      Vec<T, VEC>::store(ob + pi * plane, o);
    }
  }
}

// bf16 in 16-byte chunks (eight values, four bf16x2 pairs); nvec chunks a plane.
__global__ void __launch_bounds__(THREADS)
signed_sum_bf16x2_kernel(const uint4* __restrict__ x, uint4* __restrict__ out, int64_t m, int q,
                         int p, int64_t nvec, const SumCoefs coef) {
  const int64_t total = m * nvec;
  for (int64_t t = static_cast<int64_t>(blockIdx.x) * THREADS + threadIdx.x; t < total;
       t += static_cast<int64_t>(gridDim.x) * THREADS) {
    const int64_t b = t / nvec, off = t % nvec;
    const uint4* xb = x + b * q * nvec + off;
    uint4* ob = out + b * p * nvec + off;
    uint4 in[MAXQ];
#pragma unroll
    for (int qi = 0; qi < MAXQ; ++qi)
      if (qi < q) in[qi] = xb[qi * nvec];
#pragma unroll
    for (int pi = 0; pi < MAXP; ++pi) {
      if (pi >= p) break;
      uint4 acc = make_uint4(0u, 0u, 0u, 0u);
      __nv_bfloat162* a = reinterpret_cast<__nv_bfloat162*>(&acc);
      bool any = false;
#pragma unroll
      for (int qi = 0; qi < MAXQ; ++qi) {
        const float cf = coef.c[pi][qi];
        if (qi < q && cf != 0.f) {
          const uint32_t flip = cf < 0.f ? 0x80008000u : 0u;  // both halves' sign bits
          uint4 term = in[qi];
          term.x ^= flip; term.y ^= flip; term.z ^= flip; term.w ^= flip;
          if (any) {
            const __nv_bfloat162* tv = reinterpret_cast<const __nv_bfloat162*>(&term);
#pragma unroll
            for (int i = 0; i < 4; ++i) a[i] = __hadd2(a[i], tv[i]);
          } else {
            acc = term;
          }
          any = true;
        }
      }
      ob[pi * nvec] = acc;
    }
  }
}

unsigned grid_for(int64_t total) {
  const int64_t blocks = (total + THREADS - 1) / THREADS;
  return static_cast<unsigned>(blocks < (1 << 16) ? blocks : (1 << 16));
}

template <typename T, int VEC>
void launch(const void* x, void* out, int64_t m, int q, int p, int64_t plane,
            const SumCoefs& coef, cudaStream_t stream) {
  signed_sum_kernel<T, VEC><<<grid_for(m * (plane / VEC)), THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(out), m, q, p, plane, coef);
}

// True when every coefficient is 0, 1 or -1.
bool signs_only(const SumCoefs& coef, int p, int q) {
  for (int i = 0; i < p; ++i)
    for (int j = 0; j < q; ++j)
      if (coef.c[i][j] != 0.f && coef.c[i][j] != 1.f && coef.c[i][j] != -1.f) return false;
  return true;
}

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
    if (vec_ok && plane % 8 == 0 && signs_only(c, p, q)) {
      const int64_t nvec = plane / 8;
      signed_sum_bf16x2_kernel<<<grid_for(m * nvec), THREADS, 0, s>>>(
          static_cast<const uint4*>(x), static_cast<uint4*>(out), m, q, p, nvec, c);
    } else {
      launch<__nv_bfloat16, 1>(x, out, m, q, p, plane, c, s);
    }
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}
