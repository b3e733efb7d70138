// RMSNorm over the rows of an (R, D) array: y = x * rsqrt(mean(x^2) + eps) * w.
//
// Replaces rmsnorm_pallas (src/repro/kernels/rmsnorm/rmsnorm.py:29), which
// tiles rows into VMEM and keeps the reduction and the rescale there. Here
// one block of 256 threads owns a row (one warp owns a row when D <= 1024,
// eight rows to a block), so nothing is shared between blocks.
//
// What bounds it: two flops per element against one element read and one
// written, so device-memory bandwidth (3.35 TB/s) is the bound. Design: each
// thread moves 16 bytes at a time (a float4 of fp32 or eight bf16) when D and
// the pointers allow, one element otherwise. The second pass over a row
// re-reads it from L2 (a row of the model is 6 KB), so device memory sees
// each element read once and written once.
//
// Numerics: sum x^2 in fp32 (warp shuffles, then a shared-memory step across
// warps), mean = sum / D, then (x * rsqrtf(mean + eps)) * w in fp32 and one
// rounding to x's type. w is fp32 or x's type.
#include "common.cuh"

namespace repro {
namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// VEC weights as floats: w has x's type, or fp32 beside bf16 x (two float4).
template <typename W, int VEC>
__device__ __forceinline__ void load_w(float* dst, const W* src) {
  if constexpr (VEC == 8 && sizeof(W) == 4) {
    Vec<float, 4>::load(dst, src);
    Vec<float, 4>::load(dst + 4, src + 4);
  } else {
    Vec<W, VEC>::load(dst, src);
  }
}

template <typename T, typename W, int VEC, bool WARP_ROW>
__global__ void __launch_bounds__(THREADS)
rmsnorm_kernel(const T* __restrict__ x, const W* __restrict__ w, T* __restrict__ out,
               int64_t rows, int64_t d, float eps) {
  const int64_t row = WARP_ROW ? static_cast<int64_t>(blockIdx.x) * WARPS + threadIdx.x / 32
                               : static_cast<int64_t>(blockIdx.x);
  const int lane = WARP_ROW ? threadIdx.x % 32 : threadIdx.x;
  const int stride = WARP_ROW ? 32 : THREADS;
  if (row >= rows) return;  // only whole warps of a WARP_ROW block return here
  const T* xr = x + row * d;
  T* orow = out + row * d;
  const int64_t nvec = d / VEC;

  float ss = 0.f;
  for (int64_t i = lane; i < nvec; i += stride) {
    float v[VEC];
    Vec<T, VEC>::load(v, xr + i * VEC);
#pragma unroll
    for (int e = 0; e < VEC; ++e) ss = fmaf(v[e], v[e], ss);
  }
  ss = warp_sum(ss);
  if (!WARP_ROW) {
    __shared__ float part[WARPS];
    __shared__ float total;
    if (lane % 32 == 0) part[lane / 32] = ss;
    __syncthreads();
    if (lane < 32) {
      float t = lane < WARPS ? part[lane] : 0.f;
      t = warp_sum(t);
      if (lane == 0) total = t;
    }
    __syncthreads();
    ss = total;
  }
  const float inv = rsqrtf(ss / static_cast<float>(d) + eps);

  for (int64_t i = lane; i < nvec; i += stride) {
    float v[VEC], wv[VEC], o[VEC];
    Vec<T, VEC>::load(v, xr + i * VEC);
    load_w<W, VEC>(wv, w + i * VEC);
#pragma unroll
    for (int e = 0; e < VEC; ++e) o[e] = __fmul_rn(__fmul_rn(v[e], inv), wv[e]);
    Vec<T, VEC>::store(orow + i * VEC, o);
  }
}

template <typename T, typename W, int VEC>
void launch(const void* x, const void* w, void* out, int64_t rows, int64_t d, float eps,
            cudaStream_t stream) {
  const T* xp = static_cast<const T*>(x);
  const W* wp = static_cast<const W*>(w);
  T* op = static_cast<T*>(out);
  if (d <= 1024) {
    const unsigned grid = static_cast<unsigned>((rows + WARPS - 1) / WARPS);
    rmsnorm_kernel<T, W, VEC, true><<<grid, THREADS, 0, stream>>>(xp, wp, op, rows, d, eps);
  } else {
    const unsigned grid = static_cast<unsigned>(rows);
    rmsnorm_kernel<T, W, VEC, false><<<grid, THREADS, 0, stream>>>(xp, wp, op, rows, d, eps);
  }
}

}  // namespace
}  // namespace repro

// x, out: (rows, d) of type dtype; w: (d,) of type wdtype (fp32, or dtype).
extern "C" int repro_rmsnorm(const void* x, const void* w, void* out, int dtype, int wdtype,
                             int64_t rows, int64_t d, float eps, void* stream) {
  using namespace repro;
  if (rows < 1 || d < 1 || rows > 0x7fffffffLL) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec_ok = aligned16(x) && aligned16(w) && aligned16(out);
  if (dtype == kF32 && wdtype == kF32) {
    if (vec_ok && d % 4 == 0) {
      launch<float, float, 4>(x, w, out, rows, d, eps, s);
    } else {
      launch<float, float, 1>(x, w, out, rows, d, eps, s);
    }
  } else if (dtype == kBF16 && wdtype == kBF16) {
    if (vec_ok && d % 8 == 0) {
      launch<__nv_bfloat16, __nv_bfloat16, 8>(x, w, out, rows, d, eps, s);
    } else {
      launch<__nv_bfloat16, __nv_bfloat16, 1>(x, w, out, rows, d, eps, s);
    }
  } else if (dtype == kBF16 && wdtype == kF32) {
    if (vec_ok && d % 8 == 0) {
      launch<__nv_bfloat16, float, 8>(x, w, out, rows, d, eps, s);
    } else {
      launch<__nv_bfloat16, float, 1>(x, w, out, rows, d, eps, s);
    }
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}
