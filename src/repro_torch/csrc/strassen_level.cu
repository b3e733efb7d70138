// One Strassen divide or combine level, reading or writing the quadrants where they lie.
//
// Stands for the JAX package's einsum levels, divide_level and combine_level
// in src/repro/core/strassen.py (split_quadrants, then jnp.einsum against the
// scheme's coefficient matrix; the combine then merge_quadrants), whose
// Pallas counterparts are divide_pallas and combine_pallas
// (src/repro/kernels/strassen/strassen.py:68 and :105, here signed_sum.cu).
// Those take the quadrants as contiguous planes, so each level pays a split
// or merge copy besides its sums. This kernel addresses the quadrants in
// place instead:
//
//   divide  (m, 2hr, 2hc) -> (m*p, hr, hc): out[b*p + i] = sum_k coef[i][k] * X_k[b]
//   combine (m*q, hr, hc) -> (m, 2hr, 2hc): C_i[b]       = sum_k coef[i][k] * in[b*q + k]
//
// where X_k[b] is quadrant k (row-major [11, 12, 21, 22]) of block b: rows
// (k/2)*hr.., columns (k%2)*hc.. of the (2hr, 2hc) block. A quadrant row is
// hc contiguous elements, so a warp's loads and stores stay coalesced.
//
// What bounds it: each output element costs at most 8 adds against 4 to 8
// elements read and 1 written, so device-memory bandwidth (3.35 TB/s) is the
// bound: every input element is read once and every output element written
// once, the least bytes a level must move (kernels/cost.py:signed_sum).
//
// Design (a pure streaming kernel): a thread takes one 16-byte chunk (four
// fp32 or eight bf16) at the same (row, column) of every input plane, issues
// all of those loads before any add (64 bytes in flight a thread for a
// divide, 112 for a Strassen combine), forms every output's signed sum from
// registers and stores each output chunk once, 16 bytes. Neighbouring threads
// take neighbouring chunks. Each coefficient is tested once per output chunk
// (a branch the whole grid takes alike), so a term costs an element one
// multiply and one add and a zero costs nothing: tested per element, the
// general table made the bf16 divide issue-bound at 43% of its bound (H100,
// at the levels of a 16384^2 multiply). The grid has a block for every 256
// chunks (up to 2^20 blocks, which then stride): a grid of one wave of
// resident blocks striding over the chunks read 4-6 points of the bound less
// there. Where hc is not a multiple of a chunk or a pointer is not 16-byte
// aligned, the same kernel runs one element a thread. The coefficients (any scheme, up to 8 planes each side) come at launch, so
// the gradient of a divide level is this kernel's combine addressing with the
// transposed table, and that of a combine level the divide addressing.
//
// Numerics: the sum of each output runs over k in ascending order in fp32,
// skips zero coefficients, is never contracted into an FMA, and is rounded
// once to the storage type on the store. That is the einsum route's
// arithmetic (fp32 accumulation of bf16 operands, TF32 off in fp32), which
// this kernel replaces on backend kind strassen's path. signed_sum.cu rounds
// each add to bf16 instead, as divide_pallas does, for the staged pipeline
// that stands for the Pallas kernels; each pipeline keeps its own rounding.
#include "common.cuh"

namespace repro {
namespace {

constexpr int MAXT = 8, THREADS = 256;
// A block for every THREADS chunks, up to this many; beyond, the blocks stride.
constexpr int64_t MAX_BLOCKS = int64_t{1} << 20;

struct LevelCoefs {
  float c[MAXT][MAXT];  // (outputs, inputs)
};

// VEC elements of storage type T as loaded: one element, or one 16-byte word
// (four fp32 or eight bf16) kept packed until each element is summed.
template <typename T, int VEC>
struct Chunk;

template <typename T>
struct Chunk<T, 1> {
  T v;
  __device__ __forceinline__ void load(const T* p) { v = *p; }
  __device__ __forceinline__ float at(int) const { return to_f32(v); }
};

template <>
struct Chunk<float, 4> {
  float4 v;
  __device__ __forceinline__ void load(const float* p) { v = *reinterpret_cast<const float4*>(p); }
  __device__ __forceinline__ float at(int i) const { return (&v.x)[i]; }
};

template <>
struct Chunk<__nv_bfloat16, 8> {
  uint4 v;
  __device__ __forceinline__ void load(const __nv_bfloat16* p) {
    v = *reinterpret_cast<const uint4*>(p);
  }
  // bf16 element i is the low (even i) or high half of 32-bit word i / 2.
  __device__ __forceinline__ float at(int i) const {
    const uint32_t w = (&v.x)[i >> 1];
    return __uint_as_float(i & 1 ? w & 0xffff0000u : w << 16);
  }
};

// Offset of plane k from plane 0: quadrant k of a (2hr, 2hc) block, or plane
// k of a run of contiguous (hr, hc) planes.
template <bool QUAD, typename I>
__device__ __forceinline__ I plane_at(int k, I hr, I hc) {
  return QUAD ? static_cast<I>(k >> 1) * 2 * hr * hc + static_cast<I>(k & 1) * hc
              : static_cast<I>(k) * hr * hc;
}

// DIVIDE reads quadrants and writes planes; otherwise (combine) the reverse.
template <typename T, int VEC, bool DIVIDE, typename I>
__global__ void __launch_bounds__(THREADS)
strassen_level_kernel(const T* __restrict__ x, T* __restrict__ out, I m, int q, int p, I hr,
                      I hc, const LevelCoefs coef) {
  const I nv = hc / VEC, total = m * hr * nv, plane = hr * hc;
  for (I t = static_cast<I>(blockIdx.x) * THREADS + threadIdx.x; t < total;
       t += static_cast<I>(gridDim.x) * THREADS) {
    const I row = t / nv, j = (t - row * nv) * VEC;
    const I b = row / hr, i = row - b * hr;
    const I quad = b * 4 * plane + i * 2 * hc + j;  // (row i, column j) of quadrant 0 of block b
    const T* xs = x + (DIVIDE ? quad : b * q * plane + i * hc + j);
    T* os = out + (DIVIDE ? b * p * plane + i * hc + j : quad);
    Chunk<T, VEC> in[MAXT];
#pragma unroll
    for (int k = 0; k < MAXT; ++k)
      if (k < q) in[k].load(xs + plane_at<DIVIDE>(k, hr, hc));
#pragma unroll
    for (int o = 0; o < MAXT; ++o) {
      if (o >= p) break;
      // One (uniform) test of each coefficient for the whole chunk, so that
      // a term costs each element one multiply and one add, and a zero none.
      float sum[VEC] = {};
      bool any = false;
#pragma unroll
      for (int k = 0; k < MAXT; ++k) {
        const float cf = coef.c[o][k];
        if (k >= q || cf == 0.f) continue;
        if (any) {
#pragma unroll
          for (int v = 0; v < VEC; ++v) sum[v] = __fadd_rn(sum[v], __fmul_rn(cf, in[k].at(v)));
        } else {
#pragma unroll
          for (int v = 0; v < VEC; ++v) sum[v] = __fmul_rn(cf, in[k].at(v));
        }
        any = true;
      }
      Vec<T, VEC>::store(os + plane_at<!DIVIDE>(o, hr, hc), sum);
    }
  }
}

template <typename T, int VEC, bool DIVIDE, typename I>
void launch(const void* x, void* out, int64_t m, int q, int p, int64_t hr, int64_t hc,
            const LevelCoefs& coef, cudaStream_t stream) {
  const int64_t blocks = (m * hr * (hc / VEC) + THREADS - 1) / THREADS;
  strassen_level_kernel<T, VEC, DIVIDE, I>
      <<<static_cast<unsigned>(blocks < MAX_BLOCKS ? blocks : MAX_BLOCKS), THREADS, 0, stream>>>(
          static_cast<const T*>(x), static_cast<T*>(out), static_cast<I>(m), q, p,
          static_cast<I>(hr), static_cast<I>(hc), coef);
}

// 32-bit indices where every offset of both tensors, and the grid stride
// (at most 2^28 chunks) past the last, fits; 64-bit otherwise.
template <typename T, int VEC, bool DIVIDE>
void launch_indexed(const void* x, void* out, int64_t m, int q, int p, int64_t hr, int64_t hc,
                    const LevelCoefs& coef, cudaStream_t stream) {
  const int64_t most = m * (q > p ? q : p) * hr * hc;
  if (most < (int64_t{1} << 31)) {
    launch<T, VEC, DIVIDE, uint32_t>(x, out, m, q, p, hr, hc, coef, stream);
  } else {
    launch<T, VEC, DIVIDE, int64_t>(x, out, m, q, p, hr, hc, coef, stream);
  }
}

template <typename T, int VEC>
void launch_level(bool divide, const void* x, void* out, int64_t m, int q, int p, int64_t hr,
                  int64_t hc, const LevelCoefs& coef, cudaStream_t stream) {
  if (divide) {
    launch_indexed<T, VEC, true>(x, out, m, q, p, hr, hc, coef, stream);
  } else {
    launch_indexed<T, VEC, false>(x, out, m, q, p, hr, hc, coef, stream);
  }
}

}  // namespace
}  // namespace repro

// divide: x (m, 2hr, 2hc) -> out (m*p, hr, hc), q = 4; combine (divide = 0):
// x (m*q, hr, hc) -> out (m, 2hr, 2hc), p = 4. coef: host array of p*q
// floats, row-major (p, q).
extern "C" int repro_strassen_level(const void* x, void* out, int dtype, int divide, int64_t m,
                                    int q, int p, int64_t hr, int64_t hc, const float* coef,
                                    void* stream) {
  using namespace repro;
  if (q < 1 || q > MAXT || p < 1 || p > MAXT || m < 1 || hr < 1 || hc < 1 ||
      (divide ? q : p) != 4)
    return cudaErrorInvalidValue;
  LevelCoefs c = {};
  for (int i = 0; i < p; ++i)
    for (int j = 0; j < q; ++j) c.c[i][j] = coef[i * q + j];
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec_ok = aligned16(x) && aligned16(out);
  if (dtype == kF32) {
    if (vec_ok && hc % 4 == 0) {
      launch_level<float, 4>(divide, x, out, m, q, p, hr, hc, c, s);
    } else {
      launch_level<float, 1>(divide, x, out, m, q, p, hr, hc, c, s);
    }
  } else if (dtype == kBF16) {
    if (vec_ok && hc % 8 == 0) {
      launch_level<__nv_bfloat16, 8>(divide, x, out, m, q, p, hr, hc, c, s);
    } else {
      launch_level<__nv_bfloat16, 1>(divide, x, out, m, q, p, hr, hc, c, s);
    }
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}
