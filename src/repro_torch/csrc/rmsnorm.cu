// RMSNorm over the rows of an (R, D) array: y = x * rsqrt(mean(x^2) + eps) * w.
//
// Replaces rmsnorm_pallas (src/repro/kernels/rmsnorm/rmsnorm.py:29), which
// tiles rows into VMEM and keeps the reduction and the rescale there.
//
// What bounds it: two flops per element against one element read and one
// written, so device-memory bandwidth (3.35 TB/s) is the bound: a kernel
// that reads each row once, writes it once and keeps enough bytes in flight.
//
// Design: the row lives in registers. ROW threads own a row, ROW the
// smallest power of two from 32 to 512 that leaves each thread at most
// MAXV vectors of 16 bytes: a warp a row up to 1024 bf16, 128 threads at
// phi4's 3072, 256 at qwen2-vl's 8192; up to 16384 bf16 or 8192 fp32
// (wider rows are refused: 1024 threads a row spilled registers). Rows of fewer than 128 threads share a block of
// 128. Each thread issues all of its loads first, its row's vectors and the
// matching w (16-byte vectors through the read-only path, where w stays in
// L1 across rows), then forms its sum of squares; the row is never read
// again. Few vectors a thread keep the serial part short: the time of a
// call is one memory latency and the launch, not a chain of dependent loads
// and adds. (A warp a row up to 16 vectors a lane, 4096 bf16, ran slower:
// tools/rmsnorm_variants.py.) D not a multiple of the vector, or pointers
// off 16 bytes, take the same kernels with one element a vector.
//
// Numerics: sum x^2 in fp32 (each thread over its vectors in order, warp
// shuffles, then a shared-memory step across the warps of a row), mean =
// sum / D, then (x * rsqrtf(mean + eps)) * w in fp32 and one rounding to x's
// type. w is fp32 or x's type.
#include "common.cuh"

namespace repro {
namespace {

constexpr int MAXV = 4;         // vectors a thread holds
constexpr int BLOCK_MIN = 128;  // threads of a block of rows narrower than this

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// VEC consecutive elements of T, held as loaded (16 bytes, or one element).
template <typename T, int VEC>
struct Chunk {
  T v;
  __device__ __forceinline__ void load(const T* p) { v = *p; }
  __device__ __forceinline__ void get(float* f) const { f[0] = to_f32(v); }
};
template <>
struct Chunk<float, 4> {
  float4 v;
  __device__ __forceinline__ void load(const float* p) { v = *reinterpret_cast<const float4*>(p); }
  __device__ __forceinline__ void get(float* f) const { f[0] = v.x; f[1] = v.y; f[2] = v.z; f[3] = v.w; }
};
template <>
struct Chunk<__nv_bfloat16, 8> {
  uint4 v;
  __device__ __forceinline__ void load(const __nv_bfloat16* p) { v = *reinterpret_cast<const uint4*>(p); }
  __device__ __forceinline__ void get(float* f) const {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 x = __bfloat1622float2(h[i]);
      f[2 * i] = x.x;
      f[2 * i + 1] = x.y;
    }
  }
};

// VEC weights as floats through the read-only path: w has x's type, or fp32
// beside bf16 x (two float4).
template <typename W, int VEC>
__device__ __forceinline__ void load_w(float* dst, const W* src) {
  if constexpr (VEC == 1) {
    dst[0] = to_f32(__ldg(src));
  } else if constexpr (sizeof(W) == 4) {
#pragma unroll
    for (int q = 0; q < VEC / 4; ++q) {
      const float4 v = __ldg(reinterpret_cast<const float4*>(src) + q);
      dst[4 * q] = v.x; dst[4 * q + 1] = v.y; dst[4 * q + 2] = v.z; dst[4 * q + 3] = v.w;
    }
  } else {
    Chunk<W, VEC> c;
    c.v = __ldg(reinterpret_cast<const uint4*>(src));
    c.get(dst);
  }
}

// ROW threads own a row; a block holds BLOCK / ROW rows.
template <typename T, typename W, int VEC, int ROW, int BLOCK>
__global__ void __launch_bounds__(BLOCK)
rmsnorm_kernel(const T* __restrict__ x, const W* __restrict__ w, T* __restrict__ out, int64_t rows,
               int64_t d, float eps) {
  constexpr int WARPS = ROW / 32;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * (BLOCK / ROW) + threadIdx.x / ROW;
  const int lane = threadIdx.x % ROW;
  const T* xr = x + row * d;
  T* orow = out + row * d;
  // A row past the last takes part in the block's barrier and touches nothing.
  const int nvec = row < rows ? static_cast<int>(d / VEC) : 0;

  Chunk<T, VEC> xs[MAXV];
  float wv[MAXV][VEC];
#pragma unroll
  for (int j = 0; j < MAXV; ++j) {
    const int i = lane + j * ROW;
    if (i < nvec) {
      xs[j].load(xr + static_cast<int64_t>(i) * VEC);
      load_w<W, VEC>(wv[j], w + static_cast<int64_t>(i) * VEC);
    }
  }
  float ss = 0.f;
#pragma unroll
  for (int j = 0; j < MAXV; ++j) {
    if (lane + j * ROW < nvec) {
      float v[VEC];
      xs[j].get(v);
#pragma unroll
      for (int e = 0; e < VEC; ++e) ss = fmaf(v[e], v[e], ss);
    }
  }
  ss = warp_sum(ss);
  if constexpr (WARPS > 1) {
    __shared__ float part[BLOCK / 32];
    const int first = (threadIdx.x / ROW) * WARPS;  // this row's warps in the block
    if (lane % 32 == 0) part[first + lane / 32] = ss;
    __syncthreads();
    ss = 0.f;
#pragma unroll
    for (int i = 0; i < WARPS; ++i) ss += part[first + i];
  }
  const float inv = rsqrtf(ss / static_cast<float>(d) + eps);

#pragma unroll
  for (int j = 0; j < MAXV; ++j) {
    const int i = lane + j * ROW;
    if (i < nvec) {
      float v[VEC], o[VEC];
      xs[j].get(v);
#pragma unroll
      for (int e = 0; e < VEC; ++e) o[e] = __fmul_rn(__fmul_rn(v[e], inv), wv[j][e]);
      Vec<T, VEC>::store(orow + static_cast<int64_t>(i) * VEC, o);
    }
  }
}

template <typename T, typename W, int VEC, int ROW>
void launch_rows(const T* x, const W* w, T* out, int64_t rows, int64_t d, float eps, cudaStream_t stream) {
  constexpr int BLOCK = ROW < BLOCK_MIN ? BLOCK_MIN : ROW;
  constexpr int PER_BLOCK = BLOCK / ROW;
  const unsigned grid = static_cast<unsigned>((rows + PER_BLOCK - 1) / PER_BLOCK);
  rmsnorm_kernel<T, W, VEC, ROW, BLOCK><<<grid, BLOCK, 0, stream>>>(x, w, out, rows, d, eps);
}

template <typename T, typename W, int VEC>
cudaError_t launch(const void* x, const void* w, void* out, int64_t rows, int64_t d, float eps,
                   cudaStream_t stream) {
  const T* xp = static_cast<const T*>(x);
  const W* wp = static_cast<const W*>(w);
  T* op = static_cast<T*>(out);
  const int64_t nvec = d / VEC;
  if (nvec <= 32 * MAXV) {
    launch_rows<T, W, VEC, 32>(xp, wp, op, rows, d, eps, stream);
  } else if (nvec <= 64 * MAXV) {
    launch_rows<T, W, VEC, 64>(xp, wp, op, rows, d, eps, stream);
  } else if (nvec <= 128 * MAXV) {
    launch_rows<T, W, VEC, 128>(xp, wp, op, rows, d, eps, stream);
  } else if (nvec <= 256 * MAXV) {
    launch_rows<T, W, VEC, 256>(xp, wp, op, rows, d, eps, stream);
  } else if (nvec <= 512 * MAXV) {
    launch_rows<T, W, VEC, 512>(xp, wp, op, rows, d, eps, stream);
  } else {
    return cudaErrorInvalidValue;  // a row wider than a block's registers hold
  }
  return cudaSuccess;
}

// ------------------------------------------------------------------ backward
//
// No TPU kernel to replace: the JAX package differentiates its pure-JAX
// rmsnorm (src/repro/models/layers.py:61) and has no Pallas backward. The
// train step runs the forward kernel above, so its gradient is a kernel too.
// With xh = x * rstd, rstd = rsqrt(mean(x^2) + eps):
//   dx = rstd * (w * dy - xh * mean(xh * w * dy)),   dw = sum over rows of dy * xh.
// What bounds it: x and dy read once, dx written once (w and dw are one row
// each), so device-memory bandwidth, as the forward.
//
// Design: one launch of persistent blocks, BWD_PER_SM an SM (the plan,
// rmsnorm_bwd_plan in rmsnorm.py, sets `groups` to at most that many per
// SM, so all are resident at once). Rows are owned as in the forward (ROW
// threads a row, the row in registers); a block of BWD_BLOCK threads walks
// rows blockIdx.x * SLOTS, + gridDim.x * SLOTS, ... in its SLOTS row slots,
// each thread adding dy * xh of its columns into registers. dw is reduced
// without atomics on the data, so two runs give the same bits: the slots of
// a block add into shared memory in slot order, and each block writes one
// row of fp32 partials (in L2: 264 x 3072 floats at phi4's width). Each
// block then takes a ticket from a count; the last `reducers` blocks to
// arrive wait until every block has, and each adds the partials of its own
// 64-column slices in block order (BWD_BLOCK / 64 slices of rows, added in
// slice order), then the last of them resets the count for the next call.
// One launch, and partial rows few enough to stay in L2. A thread holds at
// most BWD_MAXV vectors of x and of dy (and as many of w and of its dw sums).
constexpr int BWD_MAXV = 4;
constexpr int BWD_THREADS = 256;  // threads of a block, unless a row takes more

template <int ROW>
struct BwdShape {
  static constexpr int BLOCK = ROW < BWD_THREADS ? BWD_THREADS : ROW;
  static constexpr int SLOTS = BLOCK / ROW;
  static constexpr int PER_SM = BLOCK <= BWD_THREADS ? 2 : 1;  // resident blocks an SM
};

// The fp32 partial rows of columns [c0, c1), added in block order into dw:
// slice s of the block's BLOCK / 64 adds partial rows s, s + slices, ... of
// column c0 + threadIdx.x % 64, and the slices' sums are added in order.
template <typename W, int BLOCK>
__device__ __forceinline__ void reduce_columns(const float* __restrict__ partial, W* __restrict__ dw,
                                               int64_t groups, int64_t d, int64_t c0, int64_t c1) {
  constexpr int SLICES = BLOCK / 64;
  __shared__ float red[SLICES][64];
  const int slice = threadIdx.x / 64;
  for (int64_t base = c0; base < c1; base += 64) {
    const int64_t col = base + threadIdx.x % 64;
    float s = 0.f;
    if (col < c1) {
      for (int64_t g = slice; g < groups; g += SLICES) s += __ldcg(partial + g * d + col);
    }
    red[slice][threadIdx.x % 64] = s;
    __syncthreads();
    if (slice == 0 && col < c1) {
      float total = 0.f;
#pragma unroll
      for (int i = 0; i < SLICES; ++i) total += red[i][threadIdx.x];
      dw[col] = from_f32<W>(total);
    }
    __syncthreads();
  }
}

template <typename T, typename W, int VEC, int ROW>
__global__ void __launch_bounds__(BwdShape<ROW>::BLOCK, BwdShape<ROW>::PER_SM)
rmsnorm_bwd_kernel(const T* __restrict__ x, const W* __restrict__ w, const T* __restrict__ dy,
                   T* __restrict__ dx, W* __restrict__ dw_out, float* __restrict__ partial,
                   int* __restrict__ counts, int64_t rows, int64_t d, int reducers, float eps) {
  constexpr int BLOCK = BwdShape<ROW>::BLOCK, WARPS = ROW / 32, SLOTS = BwdShape<ROW>::SLOTS;
  const int slot = threadIdx.x / ROW, lane = threadIdx.x % ROW;
  const int nvec = static_cast<int>(d / VEC);

  float wv[BWD_MAXV][VEC], dw[BWD_MAXV][VEC];
#pragma unroll
  for (int j = 0; j < BWD_MAXV; ++j) {
#pragma unroll
    for (int e = 0; e < VEC; ++e) dw[j][e] = 0.f;
    if (lane + j * ROW < nvec) load_w<W, VEC>(wv[j], w + static_cast<int64_t>(lane + j * ROW) * VEC);
  }
  __shared__ float part[2][WARPS > 1 ? BLOCK / 32 : 1];

  // Every thread of the block takes the same number of turns (the barriers).
  for (int64_t base = static_cast<int64_t>(blockIdx.x) * SLOTS; base < rows;
       base += static_cast<int64_t>(gridDim.x) * SLOTS) {
    const int64_t row = base + slot;
    const int nv = row < rows ? nvec : 0;
    Chunk<T, VEC> xs[BWD_MAXV], gs[BWD_MAXV];
#pragma unroll
    for (int j = 0; j < BWD_MAXV; ++j) {
      const int i = lane + j * ROW;
      if (i < nv) {
        xs[j].load(x + row * d + static_cast<int64_t>(i) * VEC);
        gs[j].load(dy + row * d + static_cast<int64_t>(i) * VEC);
      }
    }
    float ss = 0.f, xwg = 0.f;  // sum x^2, sum x * w * dy
#pragma unroll
    for (int j = 0; j < BWD_MAXV; ++j) {
      if (lane + j * ROW < nv) {
        float v[VEC], g[VEC];
        xs[j].get(v);
        gs[j].get(g);
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          ss = fmaf(v[e], v[e], ss);
          xwg = fmaf(v[e], wv[j][e] * g[e], xwg);
        }
      }
    }
    ss = warp_sum(ss);
    xwg = warp_sum(xwg);
    if constexpr (WARPS > 1) {
      const int first = slot * WARPS;
      if (lane % 32 == 0) {
        part[0][first + lane / 32] = ss;
        part[1][first + lane / 32] = xwg;
      }
      __syncthreads();
      ss = 0.f;
      xwg = 0.f;
#pragma unroll
      for (int i = 0; i < WARPS; ++i) {
        ss += part[0][first + i];
        xwg += part[1][first + i];
      }
      __syncthreads();  // every row has read part before the next turn writes it
    }
    const float inv_d = 1.f / static_cast<float>(d);
    const float rstd = rsqrtf(ss * inv_d + eps);
    const float c = rstd * xwg * inv_d;  // mean(xh * w * dy)
#pragma unroll
    for (int j = 0; j < BWD_MAXV; ++j) {
      const int i = lane + j * ROW;
      if (i < nv) {
        float v[VEC], g[VEC], o[VEC];
        xs[j].get(v);
        gs[j].get(g);
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          const float xh = v[e] * rstd;
          o[e] = rstd * (wv[j][e] * g[e] - xh * c);
          dw[j][e] = fmaf(g[e], xh, dw[j][e]);
        }
        Vec<T, VEC>::store(dx + row * d + static_cast<int64_t>(i) * VEC, o);
      }
    }
  }

  float* prow = partial + static_cast<int64_t>(blockIdx.x) * d;
  if constexpr (SLOTS == 1) {
#pragma unroll
    for (int j = 0; j < BWD_MAXV; ++j) {
      const int i = lane + j * ROW;
      if (i < nvec) {
#pragma unroll
        for (int e = 0; e < VEC; ++e) __stcg(prow + static_cast<int64_t>(i) * VEC + e, dw[j][e]);
      }
    }
  } else {
    // Rows of at most ROW * BWD_MAXV * VEC columns: the slots' sums meet in shared memory.
    __shared__ float red[SLOTS][ROW * BWD_MAXV * VEC];
#pragma unroll
    for (int j = 0; j < BWD_MAXV; ++j) {
      const int i = lane + j * ROW;
      if (i < nvec) {
#pragma unroll
        for (int e = 0; e < VEC; ++e) red[slot][i * VEC + e] = dw[j][e];
      }
    }
    __syncthreads();
    for (int col = threadIdx.x; col < d; col += BLOCK) {
      float s = 0.f;
#pragma unroll
      for (int k = 0; k < SLOTS; ++k) s += red[k][col];
      __stcg(prow + col, s);
    }
  }

  // The last `reducers` blocks to arrive add the partials, a share of the
  // columns each, once every block's row is in.
  __shared__ int ticket;
  __syncthreads();
  if (threadIdx.x == 0) ticket = arrive_count(&counts[0]);
  __syncthreads();
  const int64_t groups = gridDim.x;
  const int64_t j = ticket - (groups - reducers);
  if (j < 0) return;
  if (threadIdx.x == 0) wait_for(&counts[0], static_cast<int>(groups));
  __syncthreads();
  const int64_t per = (d + reducers - 1) / reducers;
  const int64_t c0 = j * per, c1 = c0 + per < d ? c0 + per : d;
  reduce_columns<W, BLOCK>(partial, dw_out, groups, d, c0, c1);
  if (threadIdx.x == 0 && atomicAdd(&counts[1], 1) == reducers - 1) {
    counts[0] = 0;  // every reducer has passed its wait: ready for the next call
    counts[1] = 0;
  }
}

template <typename T, typename W, int VEC, int ROW>
void launch_bwd_rows(const T* x, const W* w, const T* dy, T* dx, W* dw, float* partial, int* counts,
                     int64_t groups, int reducers, int64_t rows, int64_t d, float eps, cudaStream_t stream) {
  rmsnorm_bwd_kernel<T, W, VEC, ROW><<<static_cast<unsigned>(groups), BwdShape<ROW>::BLOCK, 0, stream>>>(
      x, w, dy, dx, dw, partial, counts, rows, d, reducers, eps);
}

template <typename T, typename W, int VEC>
cudaError_t launch_bwd(const void* x, const void* w, const void* dy, void* dx, void* dw, float* partial,
                       int* counts, int64_t groups, int reducers, int64_t rows, int64_t d, float eps,
                       cudaStream_t stream) {
  const T* xp = static_cast<const T*>(x);
  const W* wp = static_cast<const W*>(w);
  const T* gp = static_cast<const T*>(dy);
  T* op = static_cast<T*>(dx);
  W* dwp = static_cast<W*>(dw);
  const int64_t nvec = d / VEC;
  if (nvec <= 32 * BWD_MAXV) {
    launch_bwd_rows<T, W, VEC, 32>(xp, wp, gp, op, dwp, partial, counts, groups, reducers, rows, d, eps, stream);
  } else if (nvec <= 64 * BWD_MAXV) {
    launch_bwd_rows<T, W, VEC, 64>(xp, wp, gp, op, dwp, partial, counts, groups, reducers, rows, d, eps, stream);
  } else if (nvec <= 128 * BWD_MAXV) {
    launch_bwd_rows<T, W, VEC, 128>(xp, wp, gp, op, dwp, partial, counts, groups, reducers, rows, d, eps, stream);
  } else if (nvec <= 256 * BWD_MAXV) {
    launch_bwd_rows<T, W, VEC, 256>(xp, wp, gp, op, dwp, partial, counts, groups, reducers, rows, d, eps, stream);
  } else if (nvec <= 512 * BWD_MAXV) {
    launch_bwd_rows<T, W, VEC, 512>(xp, wp, gp, op, dwp, partial, counts, groups, reducers, rows, d, eps, stream);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaSuccess;
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
  cudaError_t err;
  if (dtype == kF32 && wdtype == kF32) {
    err = vec_ok && d % 4 == 0 ? launch<float, float, 4>(x, w, out, rows, d, eps, s)
                               : launch<float, float, 1>(x, w, out, rows, d, eps, s);
  } else if (dtype == kBF16 && wdtype == kBF16) {
    err = vec_ok && d % 8 == 0 ? launch<__nv_bfloat16, __nv_bfloat16, 8>(x, w, out, rows, d, eps, s)
                               : launch<__nv_bfloat16, __nv_bfloat16, 1>(x, w, out, rows, d, eps, s);
  } else if (dtype == kBF16 && wdtype == kF32) {
    err = vec_ok && d % 8 == 0 ? launch<__nv_bfloat16, float, 8>(x, w, out, rows, d, eps, s)
                               : launch<__nv_bfloat16, float, 1>(x, w, out, rows, d, eps, s);
  } else {
    return cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// x, dy, dx: (rows, d) of type dtype; w, dw: (d,) of type wdtype (fp32, or
// dtype); partial: (groups, d) fp32 scratch, groups the number of blocks.
extern "C" int repro_rmsnorm_bwd(const void* x, const void* w, const void* dy, void* dx, void* dw,
                                 void* partial, void* counts, int dtype, int wdtype, int64_t rows,
                                 int64_t d, int64_t groups, int reducers, float eps, void* stream) {
  using namespace repro;
  if (rows < 1 || d < 1 || groups < 1 || groups > 0x7fffffffLL || reducers < 1 || reducers > groups) {
    return cudaErrorInvalidValue;
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* p = static_cast<float*>(partial);
  int* c = static_cast<int*>(counts);
  const bool vec_ok = aligned16(x) && aligned16(w) && aligned16(dy) && aligned16(dx);
  cudaError_t err;
  if (dtype == kF32 && wdtype == kF32) {
    err = vec_ok && d % 4 == 0
              ? launch_bwd<float, float, 4>(x, w, dy, dx, dw, p, c, groups, reducers, rows, d, eps, s)
              : launch_bwd<float, float, 1>(x, w, dy, dx, dw, p, c, groups, reducers, rows, d, eps, s);
  } else if (dtype == kBF16 && wdtype == kBF16) {
    err = vec_ok && d % 8 == 0
              ? launch_bwd<__nv_bfloat16, __nv_bfloat16, 8>(x, w, dy, dx, dw, p, c, groups, reducers, rows, d, eps, s)
              : launch_bwd<__nv_bfloat16, __nv_bfloat16, 1>(x, w, dy, dx, dw, p, c, groups, reducers, rows, d, eps, s);
  } else if (dtype == kBF16 && wdtype == kF32) {
    err = vec_ok && d % 8 == 0
              ? launch_bwd<__nv_bfloat16, float, 8>(x, w, dy, dx, dw, p, c, groups, reducers, rows, d, eps, s)
              : launch_bwd<__nv_bfloat16, float, 1>(x, w, dy, dx, dw, p, c, groups, reducers, rows, d, eps, s);
  } else {
    return cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}
