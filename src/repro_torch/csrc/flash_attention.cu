// Flash (online-softmax) attention: O = softmax(Q K^T * scale + mask) V for
// Q (B, Hq, Sq, D) against K, V (B, Hkv, Sk, D), never forming (Sq, Sk).
//
// Replaces flash_attention_pallas
// (src/repro/kernels/flash_attention/flash_attention.py:105), whose grid runs
// the KV blocks of one query block in order and carries the running max m,
// the running sum l and the accumulator in VMEM scratch. On Hopper the blocks
// of a grid run in no order, so the KV sweep is a loop inside one block: a
// block owns one (batch, query head, 64-row query tile), with m, l and the
// 64 x D accumulator in fp32 registers, and stages 32-key tiles of K and V in
// shared memory (as fp32, 2 * 32 * D * 4 bytes: 64 KB at D = 256, above the
// static 48 KB, so the launch raises the dynamic shared-memory limit).
//
// Semantics kept from the TPU kernel: query head h reads KV head h / (Hq/Hkv)
// (GQA, MQA); causal keeps row >= col, counted from 0 for both; a window
// keeps row - col < window; masked scores are -1e30 (not -inf) and their
// probabilities are forced to 0, so a row with no live key ends with l == 0,
// which is then divided as 1 and gives 0, never NaN; KV tiles that the
// causal or window mask empties entirely are skipped. Unlike the TPU kernel,
// no tile has to divide Sq or Sk: rows past Sq are not stored and keys past
// Sk are masked.
//
// What bounds it: 4 * Sq * Sk * D flops per head (halved by the causal mask)
// against (2 Sq + 2 Sk) * D elements moved, so at prefill lengths it is
// bound by operations. This first version computes on the CUDA cores in fp32
// (FMA): each query row is split over D/32 threads (one thread below D = 64),
// each holding 32 interleaved head-dim elements of q and of the accumulator,
// with the partial dot products joined by warp shuffles. Tensor cores
// (mma/wgmma) are later work.
#include "common.cuh"

namespace repro {
namespace {

constexpr int BQ = 64;  // query rows per block
constexpr int BK = 32;  // keys per shared-memory tile (keeps 32 scores in registers)
constexpr float kNegInf = -1e30f;

template <int D>
struct Geometry {
  static constexpr int TPR = D >= 64 ? D / 32 : 1;  // threads per query row
  static constexpr int CHUNKS = D / (4 * TPR);      // float4 chunks of the head dim per thread
  static constexpr int THREADS = BQ * TPR;
};

__device__ __forceinline__ bool is_live(int64_t row, int64_t col, int64_t sk, bool causal,
                                        int64_t window) {
  return col < sk && (!causal || row >= col) && (window < 0 || row - col < window);
}

// Copies keys [k_off, k_off + BK) of one head into shared memory as fp32;
// keys past sk become zeros (their scores are masked anyway).
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int64_t k_off, int64_t sk) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int NV = BK * D / VEC;
  for (int e = threadIdx.x; e < NV; e += Geometry<D>::THREADS) {
    const int j = e * VEC / D;
    float vals[VEC];
    if (k_off + j < sk) {
      Vec<T, VEC>::load(vals, src + (k_off + j) * D + (e * VEC) % D);
    } else {
#pragma unroll
      for (int i = 0; i < VEC; ++i) vals[i] = 0.f;
    }
#pragma unroll
    for (int i = 0; i < VEC; i += 4) Vec<float, 4>::store(dst + e * VEC + i, vals + i);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(Geometry<D>::THREADS)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
             T* __restrict__ out, int hq, int group, int64_t sq, int64_t sk, bool causal,
             int64_t window, float scale) {
  using G = Geometry<D>;
  extern __shared__ float4 smem4[];
  float* ks = reinterpret_cast<float*>(smem4);  // BK x D
  float* vs = ks + BK * D;                      // BK x D

  const int row = threadIdx.x / G::TPR;  // query row within the tile
  const int r = threadIdx.x % G::TPR;    // this thread's chunks: r, r + TPR, ...
  const int64_t q_off = static_cast<int64_t>(blockIdx.x) * BQ;
  const int64_t qrow = q_off + row;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hkv = hq / group;
  const int64_t kv_head = static_cast<int64_t>(b) * hkv + h / group;
  const T* qh = q + (static_cast<int64_t>(b) * hq + h) * sq * D;
  const T* kh = k + kv_head * sk * D;
  const T* vh = v + kv_head * sk * D;
  T* oh = out + (static_cast<int64_t>(b) * hq + h) * sq * D;

  float qv[G::CHUNKS][4], acc[G::CHUNKS][4];
#pragma unroll
  for (int c = 0; c < G::CHUNKS; ++c) {
    const int col = 4 * (r + G::TPR * c);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      qv[c][e] = qrow < sq ? to_f32(qh[qrow * D + col + e]) : 0.f;
      acc[c][e] = 0.f;
    }
  }
  float m = kNegInf, l = 0.f;

  const int64_t ntiles = (sk + BK - 1) / BK;
  for (int64_t t = 0; t < ntiles; ++t) {
    const int64_t k_off = t * BK;
    // Tile-level skip, the same for every thread of the block.
    if (causal && k_off > q_off + BQ - 1) break;  // every later tile is masked too
    if (window >= 0 && k_off + BK - 1 <= q_off - window) continue;
    __syncthreads();  // every thread is done with the previous tile
    load_tile<T, D>(ks, kh, k_off, sk);
    load_tile<T, D>(vs, vh, k_off, sk);
    __syncthreads();

    float s[BK];
    float m_tile = kNegInf;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      const float4* kr = reinterpret_cast<const float4*>(ks + j * D);
      float part = 0.f;
#pragma unroll
      for (int c = 0; c < G::CHUNKS; ++c) {
        const float4 kk = kr[r + G::TPR * c];
        part = fmaf(qv[c][0], kk.x, part);
        part = fmaf(qv[c][1], kk.y, part);
        part = fmaf(qv[c][2], kk.z, part);
        part = fmaf(qv[c][3], kk.w, part);
      }
#pragma unroll
      for (int off = G::TPR / 2; off > 0; off >>= 1) part += __shfl_xor_sync(0xffffffffu, part, off);
      s[j] = is_live(qrow, k_off + j, sk, causal, window) ? part * scale : kNegInf;
      m_tile = fmaxf(m_tile, s[j]);
    }
    const float m_new = fmaxf(m, m_tile);
    const float alpha = expf(m - m_new);
#pragma unroll
    for (int c = 0; c < G::CHUNKS; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[c][e] *= alpha;
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      const float p = is_live(qrow, k_off + j, sk, causal, window) ? expf(s[j] - m_new) : 0.f;
      psum += p;
      const float4* vr = reinterpret_cast<const float4*>(vs + j * D);
#pragma unroll
      for (int c = 0; c < G::CHUNKS; ++c) {
        const float4 vv = vr[r + G::TPR * c];
        acc[c][0] = fmaf(p, vv.x, acc[c][0]);
        acc[c][1] = fmaf(p, vv.y, acc[c][1]);
        acc[c][2] = fmaf(p, vv.z, acc[c][2]);
        acc[c][3] = fmaf(p, vv.w, acc[c][3]);
      }
    }
    l = alpha * l + psum;
    m = m_new;
  }

  if (qrow < sq) {
    const float l_safe = l == 0.f ? 1.f : l;
#pragma unroll
    for (int c = 0; c < G::CHUNKS; ++c) {
      const int col = 4 * (r + G::TPR * c);
#pragma unroll
      for (int e = 0; e < 4; ++e) oh[qrow * D + col + e] = from_f32<T>(acc[c][e] / l_safe);
    }
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, int64_t b,
                   int64_t hq, int64_t hkv, int64_t sq, int64_t sk, bool causal,
                   int64_t window, float scale, cudaStream_t stream) {
  const int smem = 2 * BK * D * static_cast<int>(sizeof(float));
  const cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>((sq + BQ - 1) / BQ), static_cast<unsigned>(hq),
                  static_cast<unsigned>(b));
  flash_kernel<T, D><<<grid, Geometry<D>::THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), static_cast<int>(hq), static_cast<int>(hq / hkv), sq, sk, causal,
      window, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int64_t d, const void* q, const void* k, const void* v, void* out,
                     int64_t b, int64_t hq, int64_t hkv, int64_t sq, int64_t sk, bool causal,
                     int64_t window, float scale, cudaStream_t s) {
  switch (d) {
    case 16: return launch<T, 16>(q, k, v, out, b, hq, hkv, sq, sk, causal, window, scale, s);
    case 32: return launch<T, 32>(q, k, v, out, b, hq, hkv, sq, sk, causal, window, scale, s);
    case 64: return launch<T, 64>(q, k, v, out, b, hq, hkv, sq, sk, causal, window, scale, s);
    case 128: return launch<T, 128>(q, k, v, out, b, hq, hkv, sq, sk, causal, window, scale, s);
    case 256: return launch<T, 256>(q, k, v, out, b, hq, hkv, sq, sk, causal, window, scale, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace repro

// q, out: (b, hq, sq, d); k, v: (b, hkv, sk, d); contiguous, 16-byte aligned,
// all of type dtype. window < 0 means no window.
extern "C" int repro_flash_attention(const void* q, const void* k, const void* v, void* out,
                                     int dtype, int64_t b, int64_t hq, int64_t hkv, int64_t sq,
                                     int64_t sk, int64_t d, int causal, int64_t window,
                                     float scale, void* stream) {
  using namespace repro;
  if (b < 1 || b > 65535 || hkv < 1 || hq < 1 || hq > 65535 || hq % hkv != 0 || sq < 1 ||
      sk < 0 || (sq + BQ - 1) / BQ > 0x7fffffffLL) {
    return cudaErrorInvalidValue;
  }
  if (!(aligned16(q) && aligned16(k) && aligned16(v) && aligned16(out))) {
    return cudaErrorMisalignedAddress;
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == kF32) {
    err = dispatch<float>(d, q, k, v, out, b, hq, hkv, sq, sk, causal != 0, window, scale, s);
  } else if (dtype == kBF16) {
    err = dispatch<__nv_bfloat16>(d, q, k, v, out, b, hq, hkv, sq, sk, causal != 0, window,
                                  scale, s);
  } else {
    return cudaErrorInvalidValue;
  }
  return err != cudaSuccess ? err : cudaGetLastError();
}
