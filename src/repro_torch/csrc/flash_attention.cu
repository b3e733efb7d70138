// Flash (online-softmax) attention: O = softmax(Q K^T * scale + mask) V for
// Q (B, Hq, Sq, D) against K, V (B, Hkv, Sk, D), never forming (Sq, Sk).
//
// Replaces flash_attention_pallas
// (src/repro/kernels/flash_attention/flash_attention.py:105), whose grid runs
// the KV blocks of one query block in order and carries the running max m,
// the running sum l and the accumulator in VMEM scratch. On Hopper the blocks
// of a grid run in no order, so the KV sweep is a loop inside one block: a
// block owns one (batch, query head, 64-row query tile), with m, l and the
// 64 x D accumulator in fp32 registers, and stages K and V tiles in shared
// memory (above the static 48 KB at large D, so each launch raises the
// dynamic shared-memory limit).
//
// For training, each kernel also writes the row log-sum-exp of the scaled,
// masked scores, lse (B, Hq, Sq) in fp32 and natural log units (+inf for a
// row with no live key), when it is given an lse pointer; serving passes
// none, and out does not depend on it. flash_attention_bwd.cu reads it.
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
// bound by operations. Two kernels, picked by dtype:
//   bf16 (tc::flash_mma_kernel, below): tensor cores through mma.sync, with
//     bf16 K/V tiles double-buffered by cp.async; the serving path's kernel.
//   fp32 (flash_kernel): the CUDA cores in fp32 (FMA), since TF32 would
//     change the result. Each query row is split over D/32 threads (one
//     thread below D = 64), each holding 32 interleaved head-dim elements of
//     q and of the accumulator, with the partial dot products joined by warp
//     shuffles; K and V tiles of 32 keys are staged in shared memory as fp32.
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
             T* __restrict__ out, float* __restrict__ lse, int hq, int group, int64_t sq,
             int64_t sk, bool causal, int64_t window, float scale) {
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
    if (lse != nullptr && r == 0) {
      lse[(static_cast<int64_t>(b) * hq + h) * sq + qrow] =
          l == 0.f ? __int_as_float(0x7f800000) : m + logf(l);
    }
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
cudaError_t launch(const void* q, const void* k, const void* v, void* out, float* lse, int64_t b,
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
      static_cast<T*>(out), lse, static_cast<int>(hq), static_cast<int>(hq / hkv), sq, sk,
      causal, window, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int64_t d, const void* q, const void* k, const void* v, void* out,
                     float* lse, int64_t b, int64_t hq, int64_t hkv, int64_t sq, int64_t sk,
                     bool causal, int64_t window, float scale, cudaStream_t s) {
  switch (d) {
    case 16: return launch<T, 16>(q, k, v, out, lse, b, hq, hkv, sq, sk, causal, window, scale, s);
    case 32: return launch<T, 32>(q, k, v, out, lse, b, hq, hkv, sq, sk, causal, window, scale, s);
    case 64: return launch<T, 64>(q, k, v, out, lse, b, hq, hkv, sq, sk, causal, window, scale, s);
    case 128: return launch<T, 128>(q, k, v, out, lse, b, hq, hkv, sq, sk, causal, window, scale, s);
    case 256: return launch<T, 256>(q, k, v, out, lse, b, hq, hkv, sq, sk, causal, window, scale, s);
    default: return cudaErrorInvalidValue;
  }
}


// ------------------------------------------------ bf16: tensor cores (mma.sync)
//
// The FlashAttention-2 shape on warp-level tensor cores. A block of 4 warps
// owns 64 query rows of one (batch, query head), 16 rows a warp. Q, and
// 64-key tiles of K and V, stay bf16 in shared memory, each row padded by
// 16 bytes so that ldmatrix's eight row addresses fall in eight different
// bank groups; K and V are double-buffered with cp.async, the next tile
// loading while this one computes. S = Q K^T runs as
// mma.sync.m16n8k16.row.col.f32.bf16.bf16.f32 with fp32 sums (each bf16
// product is exact in fp32). The online softmax runs on the fp32 S fragment:
// a row lives in one quad of lanes, so its max and sum take two shuffles.
// P enters the P V product as two bf16 fragments, P = hi + lo with hi its
// bf16 rounding and lo the bf16 rounding of the rest (within about 2^-17 of
// the fp32 P), and O accumulates in fp32 fragments. One bf16 P (2^-9 on each
// term) would break the per-element rule that holds this kernel to its fp32
// plain version, in rows with few live keys whose terms cancel; the second
// fragment costs half again the MMAs of the tile (three 16 x 8 products
// where FlashAttention-2 issues two). Q's fragments stay in registers up to
// D = 128; at D = 256 they are re-read from shared memory, where registers
// run out. Blocks start from the last query tile, which
// causal masking makes the longest.
namespace tc {

constexpr int BQ = 64, BKV = 64, THREADS = 128;  // 4 warps of 16 query rows

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}
// c(16x8, fp32) += a(16x16, bf16, row) * b(16x8, bf16, col)
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// Rows [row0, row0 + rows) of a (len, D) head into shared memory [rows][D + 8]
// with cp.async; rows past len are zero-filled.
template <int D>
__device__ __forceinline__ void load_rows(__nv_bfloat16* dst, const __nv_bfloat16* src, int64_t row0,
                                          int64_t len, int rows) {
  constexpr int LD = D + 8, CPR = D / 8;  // 16-byte chunks per row
  for (int e = threadIdx.x; e < rows * CPR; e += THREADS) {
    const int r = e / CPR, c = (e % CPR) * 8;
    const bool out = row0 + r >= len;
    cp_async16(dst + r * LD + c, out ? src : src + (row0 + r) * D + c, out);
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_mma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out,
                 float* __restrict__ lse, int hq, int group, int64_t sq, int64_t sk, bool causal,
                 int64_t window, float scale) {
  constexpr int LD = D + 8, KD = D / 16;
  constexpr bool QREG = D <= 128;
  extern __shared__ float4 smem4[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem4);  // [BQ][LD]
  __nv_bfloat16* ks = qs + BQ * LD;                             // [2][BKV][LD]
  __nv_bfloat16* vs = ks + 2 * BKV * LD;                        // [2][BKV][LD]

  const int h = blockIdx.x, b = blockIdx.y;
  const int64_t q_off = static_cast<int64_t>(gridDim.z - 1 - blockIdx.z) * BQ;
  const int hkv = hq / group;
  const int64_t kv_head = static_cast<int64_t>(b) * hkv + h / group;
  const __nv_bfloat16* qh = q + (static_cast<int64_t>(b) * hq + h) * sq * D;
  const __nv_bfloat16* kh = k + kv_head * sk * D;
  const __nv_bfloat16* vh = v + kv_head * sk * D;
  __nv_bfloat16* oh = out + (static_cast<int64_t>(b) * hq + h) * sq * D;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  // The KV tiles with a live key for some row of this block; the causal and
  // window masks leave every other tile empty.
  int64_t kv_lo = 0, kv_hi = sk;
  if (causal && q_off + BQ < sk) kv_hi = q_off + BQ;
  if (window >= 0 && q_off - window + 1 > 0) kv_lo = q_off - window + 1;
  const int64_t t0 = kv_lo / BKV, t1 = kv_hi > kv_lo ? (kv_hi + BKV - 1) / BKV : t0;

  load_rows<D>(qs, qh, q_off, sq, BQ);
  cp_async_commit();
  if (t0 < t1) {
    load_rows<D>(ks, kh, t0 * BKV, sk, BKV);
    load_rows<D>(vs, vh, t0 * BKV, sk, BKV);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  // A fragments of this warp's 16 query rows: lane l addresses row l % 16,
  // columns 8 * (l / 16) of each 16-column step.
  const __nv_bfloat16* q_frag = qs + (warp * 16 + lane % 16) * LD + (lane / 16) * 8;
  uint32_t qf[QREG ? KD : 1][4];
  if constexpr (QREG) {
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) ldsm_x4(qf[kk], q_frag + kk * 16);
  }

  float o[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
  // Each lane holds rows g and g + 8 of the warp's 16 (g = lane / 4).
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  const int64_t row[2] = {q_off + warp * 16 + lane / 4, q_off + warp * 16 + lane / 4 + 8};
  const float scale_log2 = scale * 1.4426950408889634f;  // exp(x) = exp2(x * log2(e))

  for (int64_t t = t0; t < t1; ++t) {
    const int stage = static_cast<int>((t - t0) % 2);
    if (t + 1 < t1) {
      load_rows<D>(ks + (stage ^ 1) * BKV * LD, kh, (t + 1) * BKV, sk, BKV);
      load_rows<D>(vs + (stage ^ 1) * BKV * LD, vh, (t + 1) * BKV, sk, BKV);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const __nv_bfloat16* kt = ks + stage * BKV * LD;
    const __nv_bfloat16* vt = vs + stage * BKV * LD;
    const int64_t k_off = t * BKV;

    // S = Q K^T over 64 keys: 8 fragments of 16 x 8.
    float s[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      uint32_t a[4];
      if constexpr (QREG) {
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = qf[kk][i];
      } else {
        ldsm_x4(a, q_frag + kk * 16);
      }
#pragma unroll
      for (int n2 = 0; n2 < 4; ++n2) {
        // keys 16 n2 + {0..7, 8..15}, head dims 16 kk + {0..7, 8..15}
        uint32_t kb[4];
        ldsm_x4(kb, kt + (n2 * 16 + lane % 8 + (lane / 16) * 8) * LD + kk * 16 + ((lane / 8) % 2) * 8);
        mma16816(s[2 * n2], a, kb[0], kb[1]);
        mma16816(s[2 * n2 + 1], a, kb[2], kb[3]);
      }
    }

    // Mask (only tiles that straddle a mask edge or the end of the keys), in
    // units of log2 so that exp2 gives the softmax's exp.
    const bool edge = k_off + BKV > sk || (causal && k_off + BKV - 1 > q_off) ||
                      (window >= 0 && q_off + BQ - 1 - k_off >= window);
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int64_t col = k_off + n * 8 + 2 * (lane % 4) + (e & 1);
        const bool live = !edge || is_live(row[e / 2], col, sk, causal, window);
        s[n][e] = live ? s[n][e] * scale_log2 : kNegInf;
        mx[e / 2] = fmaxf(mx[e / 2], s[n][e]);
      }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      alpha[r] = exp2f(m[r] - m_new);
      m[r] = m_new;
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int i = 0; i < D / 8; ++i) {
      o[i][0] *= alpha[0]; o[i][1] *= alpha[0];
      o[i][2] *= alpha[1]; o[i][3] *= alpha[1];
    }
#pragma unroll
    for (int kk2 = 0; kk2 < 4; ++kk2) {
      // P for keys 16 kk2 + {0..15} as the A fragments of P V, split into a
      // bf16 part and the bf16 rounding of what it leaves (P = hi + lo to
      // about 2^-17), so that P V keeps the fp32 P of the TPU kernel.
      uint32_t hi[4], lo[4];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int n = 2 * kk2 + h;
        float p[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool live = s[n][e] > kNegInf;  // masked scores hold exactly kNegInf
          p[e] = live ? exp2f(s[n][e] - m[e / 2]) : 0.f;
          l[e / 2] += p[e];
        }
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const __nv_bfloat162 ph = __floats2bfloat162_rn(p[2 * r], p[2 * r + 1]);
          const float2 back = __bfloat1622float2(ph);
          hi[2 * h + r] = *reinterpret_cast<const uint32_t*>(&ph);
          lo[2 * h + r] = pack_bf16(p[2 * r] - back.x, p[2 * r + 1] - back.y);
        }
      }
#pragma unroll
      for (int d2 = 0; d2 < D / 16; ++d2) {
        // keys 16 kk2 + {0..7, 8..15}, head dims 16 d2 + {0..7, 8..15}, transposed
        uint32_t vb[4];
        ldsm_x4_trans(vb, vt + (kk2 * 16 + lane % 8 + ((lane / 8) % 2) * 8) * LD + d2 * 16 + (lane / 16) * 8);
        mma16816(o[2 * d2], hi, vb[0], vb[1]);
        mma16816(o[2 * d2 + 1], hi, vb[2], vb[3]);
        mma16816(o[2 * d2], lo, vb[0], vb[1]);
        mma16816(o[2 * d2 + 1], lo, vb[2], vb[3]);
      }
    }
    __syncthreads();  // every warp is done with this stage before it is refilled
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    if (lse != nullptr && lane % 4 == 0 && row[r] < sq) {
      // m is in units of log2 (scores times scale * log2(e))
      lse[(static_cast<int64_t>(b) * hq + h) * sq + row[r]] =
          l[r] == 0.f ? __int_as_float(0x7f800000) : m[r] * 0.6931471805599453f + logf(l[r]);
    }
    if (l[r] == 0.f) l[r] = 1.f;
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (row[r] >= sq) continue;
    __nv_bfloat16* dst = oh + row[r] * D + 2 * (lane % 4);
#pragma unroll
    for (int i = 0; i < D / 8; ++i) {
      *reinterpret_cast<__nv_bfloat162*>(dst + i * 8) =
          __floats2bfloat162_rn(o[i][2 * r] / l[r], o[i][2 * r + 1] / l[r]);
    }
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, float* lse, int64_t b,
                   int64_t hq, int64_t hkv, int64_t sq, int64_t sk, bool causal, int64_t window,
                   float scale, cudaStream_t stream) {
  const int smem = (BQ + 4 * BKV) * (D + 8) * static_cast<int>(sizeof(__nv_bfloat16));
  const cudaError_t err = cudaFuncSetAttribute(
      flash_mma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>(hq), static_cast<unsigned>(b),
                  static_cast<unsigned>((sq + BQ - 1) / BQ));
  flash_mma_kernel<D><<<grid, THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out), lse,
      static_cast<int>(hq), static_cast<int>(hq / hkv), sq, sk, causal, window, scale);
  return cudaGetLastError();
}

cudaError_t dispatch(int64_t d, const void* q, const void* k, const void* v, void* out, float* lse,
                     int64_t b, int64_t hq, int64_t hkv, int64_t sq, int64_t sk, bool causal,
                     int64_t window, float scale, cudaStream_t s) {
  switch (d) {
    case 16: return launch<16>(q, k, v, out, lse, b, hq, hkv, sq, sk, causal, window, scale, s);
    case 32: return launch<32>(q, k, v, out, lse, b, hq, hkv, sq, sk, causal, window, scale, s);
    case 64: return launch<64>(q, k, v, out, lse, b, hq, hkv, sq, sk, causal, window, scale, s);
    case 128: return launch<128>(q, k, v, out, lse, b, hq, hkv, sq, sk, causal, window, scale, s);
    case 256: return launch<256>(q, k, v, out, lse, b, hq, hkv, sq, sk, causal, window, scale, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace tc

}  // namespace
}  // namespace repro

// q, out: (b, hq, sq, d); k, v: (b, hkv, sk, d); contiguous, 16-byte aligned,
// all of type dtype. window < 0 means no window. lse: (b, hq, sq) fp32, or
// null when the caller does not need it.
extern "C" int repro_flash_attention(const void* q, const void* k, const void* v, void* out,
                                     void* lse, int dtype, int64_t b, int64_t hq, int64_t hkv, int64_t sq,
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
    err = dispatch<float>(d, q, k, v, out, static_cast<float*>(lse), b, hq, hkv, sq, sk,
                          causal != 0, window, scale, s);
  } else if (dtype == kBF16) {
    if ((sq + tc::BQ - 1) / tc::BQ > 65535) return cudaErrorInvalidValue;
    err = tc::dispatch(d, q, k, v, out, static_cast<float*>(lse), b, hq, hkv, sq, sk, causal != 0,
                       window, scale, s);
  } else {
    return cudaErrorInvalidValue;
  }
  return err != cudaSuccess ? err : cudaGetLastError();
}
