// Flash-attention backward: dQ, dK, dV of O = softmax(Q K^T * scale + mask) V
// for Q (B, Hq, Sq, D) against K, V (B, Hkv, Sk, D), from Q, K, V, O, dO and
// the forward's row log-sum-exp lse (B, Hq, Sq), never forming (Sq, Sk).
//
// No TPU kernel to replace: the JAX package trains through its pure-JAX
// chunked_attention (src/repro/models/attention.py:44) and has no Pallas
// backward. The port's forward runs the flash kernel (flash_attention.cu), so
// its gradient is a kernel too. FlashAttention-2's algorithm, three launches:
//
//  1. prep: delta = rowsum(dO o O) in fp32, one warp a row;
//  2. main: one block per (batch, KV head, key tile). It holds its K and V
//     tile in shared memory and dK, dV in fp32 registers, and walks the
//     group's query heads (GQA: every query head that reads this KV head)
//     and, for each, the query tiles that have a live key in the tile. For a
//     query tile it recomputes S = Q K^T, P = exp(S * scale - lse) (0 where
//     masked), dV += P^T dO, dP = dO V^T, dS = P o (dP - delta) * scale,
//     dK += dS^T Q, and stores the tile's dQ term dS K, in fp32, in its own
//     slice of a partial-dQ buffer (dQ's sum runs over key tiles, which other
//     blocks own). dK and dV need no atomics: one block owns a key tile for
//     all of its query heads;
//  3. dq: each element's partials added in key-tile order, over the key
//     tiles that visited its query tile, and rounded to q's dtype. No
//     atomics anywhere, so two runs give the same bits; the price is the
//     partial buffer, Sk / 64 (fp32: Sk / 32) times dQ's size in fp32.
//
// Masks are those of the forward and of kernels/flash_attention/ref.py:
// causal keeps row >= col (top-left aligned, also for Sq != Sk), a window
// keeps row - col < window, keys past Sk and rows past Sq are dead. A row
// with no live key has every P = 0, so its dQ is 0 and it adds nothing to
// dK, dV (its forward output is 0, a constant).
//
// What bounds it: five products of Sq x Sk x D per head (S, dP, dV, dK, dQ;
// halved by the causal mask) against (3 Sq + 2 Sk) D elements read and
// (Sq + 2 Sk) D written, so operations at training lengths. Two kernels, by
// dtype:
//   bf16 (tc::flash_bwd_mma_kernel): tensor cores through mma.sync
//     m16n8k16 with fp32 sums, as the forward's flash_mma_kernel. A block of
//     4 warps owns 64 keys, 16 a warp; each warp computes S^T and dP^T for
//     its keys against a 64-row query tile, so that P^T and dS^T come out as
//     the C fragments that the dV and dK products take as A operands, and
//     its dK, dV rows stay in its registers. dS^T goes through shared memory
//     for dQ = dS K, where each warp takes 16 query rows. P and dS enter
//     their products as two bf16 parts, hi + lo (hi the bf16 rounding, lo
//     that of the rest; within about 2^-17 of the fp32 value), as the
//     forward feeds P: one bf16 rounding (2^-9) of each term broke the
//     per-element rule that holds the kernel to its fp32 plain version, in
//     a few elements whose terms cancel. D = 256 is refused: two 16 x 256
//     fp32 accumulators a warp need 256 registers a thread.
//   fp32 (flash_bwd_f32_kernel): the CUDA cores in fp32 (TF32 would change
//     the result), 32 keys a block, 32 query rows a step, Q, dO, K, V, P and
//     dS tiles in shared memory and each thread's dK, dV columns in registers.
#include <initializer_list>

#include "common.cuh"

namespace repro {
namespace {

__device__ __forceinline__ bool live(int64_t row, int64_t col, int64_t sq, int64_t sk, bool causal,
                                     int64_t window) {
  return row < sq && col < sk && (!causal || row >= col) && (window < 0 || row - col < window);
}

// The query rows [lo, hi) with a live key among keys [k_off, k_off + keys).
__device__ __forceinline__ void live_rows(int64_t k_off, int keys, int64_t sq, bool causal,
                                          int64_t window, int64_t& lo, int64_t& hi) {
  lo = causal ? k_off : 0;
  hi = sq;
  if (window >= 0 && k_off + keys - 1 + window < hi) hi = k_off + keys - 1 + window;
  if (hi < lo) hi = lo;
}

// delta[r] = sum_d dout[r][d] * o[r][d] in fp32: one warp a row.
template <typename T>
__global__ void flash_bwd_prep_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                                      float* __restrict__ delta, int64_t rows, int d) {
  const int64_t row = static_cast<int64_t>(blockIdx.x) * (blockDim.x / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  float s = 0.f;
  for (int i = lane; i < d; i += 32) s = fmaf(to_f32(dout[row * d + i]), to_f32(o[row * d + i]), s);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) delta[row] = s;
}

// dq[i] = the partials part[kt][i] of the key tiles kt (of `keys` keys) that
// visited i's query tile (of `rows` rows), added in kt order, rounded to T.
template <typename T>
__global__ void flash_bwd_dq_kernel(const float* __restrict__ part, T* __restrict__ dq, int64_t n,
                                    int d, int64_t sq, int64_t sk, int keys, int rows, bool causal,
                                    int64_t window) {
  const int64_t n_kt = (sk + keys - 1) / keys;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int64_t t = (i / d) % sq / rows;  // the element's query tile
    float s = 0.f;
    for (int64_t kt = 0; kt < n_kt; ++kt) {
      int64_t lo, hi;
      live_rows(kt * keys, keys, sq, causal, window, lo, hi);
      if (hi > lo && t >= lo / rows && t < (hi + rows - 1) / rows) s += part[kt * n + i];
    }
    dq[i] = from_f32<T>(s);
  }
}

// ------------------------------------------------------------ fp32 (CUDA cores)
constexpr int FB = 32;         // keys a block, query rows a step
constexpr int FTHREADS = 256;  // thread t: row (or key) t / 8, columns t % 8 + 8 c

template <int D>
__global__ void __launch_bounds__(FTHREADS)
flash_bwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     float* __restrict__ dq_part, float* __restrict__ dk, float* __restrict__ dv,
                     int hq, int group, int64_t sq, int64_t sk, bool causal, int64_t window,
                     float scale) {
  constexpr int LD = D + 1, LP = FB + 1, C = D / 8;  // padded rows: no bank conflicts
  extern __shared__ float smem[];
  float* ks = smem;            // [FB][LD]
  float* vs = ks + FB * LD;    // [FB][LD]
  float* qs = vs + FB * LD;    // [FB][LD]
  float* dos = qs + FB * LD;   // [FB][LD]
  float* ps = dos + FB * LD;   // [FB rows][LP]
  float* dss = ps + FB * LP;   // [FB rows][LP]
  float* lse_s = dss + FB * LP;
  float* delta_s = lse_s + FB;

  const int64_t k_off = static_cast<int64_t>(blockIdx.x) * FB;
  const int hk = blockIdx.y, b = blockIdx.z;
  const int hkv = hq / group;
  const int64_t kv_base = (static_cast<int64_t>(b) * hkv + hk) * sk;
  const int ti = threadIdx.x / 8, tj = threadIdx.x % 8;
  // this key tile's slice of the partial dQ, (b, hq, sq, D) like q
  float* dq = dq_part + static_cast<int64_t>(blockIdx.x) * gridDim.z * hq * sq * D;

  for (int e = threadIdx.x; e < FB * D; e += FTHREADS) {
    const int j = e / D, c = e % D;
    const bool in = k_off + j < sk;
    ks[j * LD + c] = in ? k[(kv_base + k_off + j) * D + c] : 0.f;
    vs[j * LD + c] = in ? v[(kv_base + k_off + j) * D + c] : 0.f;
  }
  int64_t lo, hi;
  live_rows(k_off, FB, sq, causal, window, lo, hi);
  const int64_t t0 = lo / FB, t1 = hi > lo ? (hi + FB - 1) / FB : t0;

  float acc_dk[C], acc_dv[C];
#pragma unroll
  for (int c = 0; c < C; ++c) acc_dk[c] = acc_dv[c] = 0.f;

  for (int g = 0; g < group; ++g) {
    const int64_t qh = (static_cast<int64_t>(b) * hq + hk * group + g) * sq;  // row base
    for (int64_t t = t0; t < t1; ++t) {
      const int64_t q_off = t * FB;
      __syncthreads();  // the previous step is done with the tiles
      for (int e = threadIdx.x; e < FB * D; e += FTHREADS) {
        const int i = e / D, c = e % D;
        const bool in = q_off + i < sq;
        qs[i * LD + c] = in ? q[(qh + q_off + i) * D + c] : 0.f;
        dos[i * LD + c] = in ? dout[(qh + q_off + i) * D + c] : 0.f;
      }
      if (threadIdx.x < FB) {
        const bool in = q_off + threadIdx.x < sq;
        lse_s[threadIdx.x] = in ? lse[qh + q_off + threadIdx.x] : 0.f;
        delta_s[threadIdx.x] = in ? delta[qh + q_off + threadIdx.x] : 0.f;
      }
      __syncthreads();
      // P and dS at row ti, keys tj + 8 e.
#pragma unroll
      for (int e = 0; e < FB / 8; ++e) {
        const int j = tj + 8 * e;
        float s = 0.f, dp = 0.f;
#pragma unroll 8
        for (int c = 0; c < D; ++c) {
          s = fmaf(qs[ti * LD + c], ks[j * LD + c], s);
          dp = fmaf(dos[ti * LD + c], vs[j * LD + c], dp);
        }
        const bool on = live(q_off + ti, k_off + j, sq, sk, causal, window);
        const float p = on ? expf(s * scale - lse_s[ti]) : 0.f;
        ps[ti * LP + j] = p;
        dss[ti * LP + j] = p * (dp - delta_s[ti]) * scale;
      }
      __syncthreads();
      // dV, dK at key ti, columns tj + 8 c; dQ at row ti, columns tj + 8 c.
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const int col = tj + 8 * c;
        float sv = acc_dv[c], sk_ = acc_dk[c], sq_ = 0.f;
#pragma unroll 8
        for (int i = 0; i < FB; ++i) {
          sv = fmaf(ps[i * LP + ti], dos[i * LD + col], sv);
          sk_ = fmaf(dss[i * LP + ti], qs[i * LD + col], sk_);
          sq_ = fmaf(dss[ti * LP + i], ks[i * LD + col], sq_);
        }
        acc_dv[c] = sv;
        acc_dk[c] = sk_;
        if (q_off + ti < sq) dq[(qh + q_off + ti) * D + col] = sq_;
      }
    }
  }
  if (k_off + ti < sk) {
#pragma unroll
    for (int c = 0; c < C; ++c) {
      dk[(kv_base + k_off + ti) * D + tj + 8 * c] = acc_dk[c];
      dv[(kv_base + k_off + ti) * D + tj + 8 * c] = acc_dv[c];
    }
  }
}

template <int D>
cudaError_t launch_f32(const float* q, const float* k, const float* v, const float* dout,
                       const float* lse, const float* delta, float* dq_part, float* dk, float* dv,
                       int64_t b, int64_t hq, int64_t hkv, int64_t sq, int64_t sk, bool causal,
                       int64_t window, float scale, cudaStream_t stream) {
  const int smem = (4 * FB * (D + 1) + 2 * FB * (FB + 1) + 2 * FB) * static_cast<int>(sizeof(float));
  const cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_f32_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>((sk + FB - 1) / FB), static_cast<unsigned>(hkv),
                  static_cast<unsigned>(b));
  flash_bwd_f32_kernel<D><<<grid, FTHREADS, smem, stream>>>(
      q, k, v, dout, lse, delta, dq_part, dk, dv, static_cast<int>(hq), static_cast<int>(hq / hkv),
      sq, sk, causal, window, scale);
  return cudaGetLastError();
}

// ------------------------------------------------- bf16: tensor cores (mma.sync)
namespace tc {

constexpr int BQ = 64, BKV = 64, THREADS = 128;  // 4 warps of 16 keys
constexpr int LDS = BQ + 8;                      // dS^T rows: 64 query rows + 16 bytes

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
// (a, b) as a pair of bf16 hi parts and a pair of bf16 lo parts: x = hi + lo
// to about 2^-17 relative.
__device__ __forceinline__ void split_bf16(float a, float b, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 back = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(a - back.x, b - back.y);
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

// st (16 keys x 64 rows, C fragments) = A (this warp's 16 rows of a [key][d]
// tile) times B^T (a [row][d] tile): S^T = K Q^T, or dP^T = V dO^T.
template <int D>
__device__ __forceinline__ void keys_by_rows(float (&st)[8][4], const __nv_bfloat16* a_tile,
                                             const __nv_bfloat16* b_tile, int warp, int lane) {
  constexpr int LD = D + 8;
#pragma unroll
  for (int n = 0; n < 8; ++n) st[n][0] = st[n][1] = st[n][2] = st[n][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t a[4];
    ldsm_x4(a, a_tile + (warp * 16 + lane % 16) * LD + kk * 16 + (lane / 16) * 8);
#pragma unroll
    for (int n2 = 0; n2 < 4; ++n2) {
      uint32_t bb[4];
      ldsm_x4(bb, b_tile + (n2 * 16 + lane % 8 + (lane / 16) * 8) * LD + kk * 16 + ((lane / 8) % 2) * 8);
      mma16816(st[2 * n2], a, bb[0], bb[1]);
      mma16816(st[2 * n2 + 1], a, bb[2], bb[3]);
    }
  }
}

// acc (16 keys x D) += X^T (16 keys x 64 rows, C fragments, as hi + lo bf16)
// times a [row][d] tile: dV += P^T dO, or dK += dS^T Q.
template <int D>
__device__ __forceinline__ void add_keys_by_d(float (&acc)[D / 8][4], float (&xt)[8][4],
                                              const __nv_bfloat16* tile, int lane) {
  constexpr int LD = D + 8;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {  // query rows 16 kk + {0..15}
    uint32_t hi[4], lo[4];
    split_bf16(xt[2 * kk][0], xt[2 * kk][1], hi[0], lo[0]);
    split_bf16(xt[2 * kk][2], xt[2 * kk][3], hi[1], lo[1]);
    split_bf16(xt[2 * kk + 1][0], xt[2 * kk + 1][1], hi[2], lo[2]);
    split_bf16(xt[2 * kk + 1][2], xt[2 * kk + 1][3], hi[3], lo[3]);
#pragma unroll
    for (int d2 = 0; d2 < D / 16; ++d2) {
      uint32_t bb[4];
      ldsm_x4_trans(bb, tile + (kk * 16 + lane % 8 + ((lane / 8) % 2) * 8) * LD + d2 * 16 + (lane / 16) * 8);
      mma16816(acc[2 * d2], hi, bb[0], bb[1]);
      mma16816(acc[2 * d2 + 1], hi, bb[2], bb[3]);
      mma16816(acc[2 * d2], lo, bb[0], bb[1]);
      mma16816(acc[2 * d2 + 1], lo, bb[2], bb[3]);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_bwd_mma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     float* __restrict__ dq_part, __nv_bfloat16* __restrict__ dk,
                     __nv_bfloat16* __restrict__ dv, int hq, int group, int64_t sq, int64_t sk,
                     bool causal, int64_t window, float scale) {
  constexpr int LD = D + 8, DC = D < 32 ? D : 32;  // dQ's head dims a pass
  constexpr float kLog2e = 1.4426950408889634f;
  extern __shared__ float4 smem4[];
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem4);  // [BKV][LD]
  __nv_bfloat16* vs = ks + BKV * LD;                            // [BKV][LD]
  __nv_bfloat16* qs = vs + BKV * LD;                            // [BQ][LD]
  __nv_bfloat16* dos = qs + BQ * LD;                            // [BQ][LD]
  __nv_bfloat16* dst = dos + BQ * LD;                           // dS^T hi [BKV][LDS]
  __nv_bfloat16* dst_lo = dst + BKV * LDS;                      // dS^T lo [BKV][LDS]
  float* lse_s = reinterpret_cast<float*>(dst_lo + BKV * LDS);  // [BQ], times log2(e)
  float* delta_s = lse_s + BQ;                                  // [BQ]

  const int64_t k_off = static_cast<int64_t>(blockIdx.x) * BKV;
  const int hk = blockIdx.y, b = blockIdx.z;
  const int hkv = hq / group;
  const int64_t kv_base = (static_cast<int64_t>(b) * hkv + hk) * sk;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const float scale_log2 = scale * kLog2e;
  // this key tile's slice of the partial dQ, (b, hq, sq, D) like q
  float* dq = dq_part + static_cast<int64_t>(blockIdx.x) * gridDim.z * hq * sq * D;

  load_rows<D>(ks, k + kv_base * D, k_off, sk, BKV);
  load_rows<D>(vs, v + kv_base * D, k_off, sk, BKV);
  cp_async_commit();

  int64_t lo, hi;
  live_rows(k_off, BKV, sq, causal, window, lo, hi);
  const int64_t t0 = lo / BQ, t1 = hi > lo ? (hi + BQ - 1) / BQ : t0;

  float dk_acc[D / 8][4], dv_acc[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[i][e] = dv_acc[i][e] = 0.f;
  // This lane's keys in C fragments: g and g + 8 of the warp's 16.
  const int64_t key0 = k_off + warp * 16 + lane / 4;

  for (int g = 0; g < group; ++g) {
    const int64_t qh = (static_cast<int64_t>(b) * hq + hk * group + g) * sq;  // row base
    for (int64_t t = t0; t < t1; ++t) {
      const int64_t q_off = t * BQ;
      __syncthreads();  // every warp is done with the previous step's tiles
      load_rows<D>(qs, q + qh * D, q_off, sq, BQ);
      load_rows<D>(dos, dout + qh * D, q_off, sq, BQ);
      cp_async_commit();
      if (threadIdx.x < BQ) {
        const bool in = q_off + threadIdx.x < sq;
        lse_s[threadIdx.x] = in ? lse[qh + q_off + threadIdx.x] * kLog2e : 0.f;
        delta_s[threadIdx.x] = in ? delta[qh + q_off + threadIdx.x] : 0.f;
      }
      cp_async_wait<0>();
      __syncthreads();

      // P^T = exp(S^T * scale - lse): C fragment [n][e] is key key0 + 8 (e / 2),
      // query row q_off + 8 n + 2 (lane % 4) + (e % 2).
      float pt[8][4];
      keys_by_rows<D>(pt, ks, qs, warp, lane);
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = n * 8 + 2 * (lane % 4) + (e & 1);
          const bool on = live(q_off + r, key0 + 8 * (e / 2), sq, sk, causal, window);
          pt[n][e] = on ? exp2f(pt[n][e] * scale_log2 - lse_s[r]) : 0.f;
        }
      add_keys_by_d<D>(dv_acc, pt, dos, lane);  // dV += P^T dO

      // dS^T = P^T o (dP^T - delta) * scale
      float dpt[8][4];
      keys_by_rows<D>(dpt, vs, dos, warp, lane);
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = n * 8 + 2 * (lane % 4) + (e & 1);
          dpt[n][e] = pt[n][e] * (dpt[n][e] - delta_s[r]) * scale;
        }
      add_keys_by_d<D>(dk_acc, dpt, qs, lane);  // dK += dS^T Q
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int at = (warp * 16 + lane / 4 + 8 * h) * LDS + n * 8 + 2 * (lane % 4);
          split_bf16(dpt[n][2 * h], dpt[n][2 * h + 1], *reinterpret_cast<uint32_t*>(dst + at),
                     *reinterpret_cast<uint32_t*>(dst_lo + at));
        }
      __syncthreads();

      // This tile's dQ term for the warp's 16 rows, dS K, DC head dims at a
      // time; A from dS^T transposed, B from K transposed.
#pragma unroll
      for (int dc = 0; dc < D / DC; ++dc) {
        float acc[DC / 8][4];
#pragma unroll
        for (int n = 0; n < DC / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {  // keys 16 kk + {0..15}
          const int at = (kk * 16 + (lane / 16) * 8 + lane % 8) * LDS + warp * 16 + ((lane / 8) % 2) * 8;
          uint32_t hi[4], lo[4];
          ldsm_x4_trans(hi, dst + at);
          ldsm_x4_trans(lo, dst_lo + at);
#pragma unroll
          for (int d2 = 0; d2 < DC / 16; ++d2) {
            uint32_t bb[4];
            ldsm_x4_trans(bb, ks + (kk * 16 + lane % 8 + ((lane / 8) % 2) * 8) * LD + dc * DC + d2 * 16 + (lane / 16) * 8);
            mma16816(acc[2 * d2], hi, bb[0], bb[1]);
            mma16816(acc[2 * d2 + 1], hi, bb[2], bb[3]);
            mma16816(acc[2 * d2], lo, bb[0], bb[1]);
            mma16816(acc[2 * d2 + 1], lo, bb[2], bb[3]);
          }
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int64_t row = q_off + warp * 16 + lane / 4 + 8 * (e / 2);
          if (row >= sq) continue;
          float* dst_row = dq + (qh + row) * D + dc * DC + 2 * (lane % 4) + (e & 1);
#pragma unroll
          for (int n = 0; n < DC / 8; ++n) dst_row[n * 8] = acc[n][e];
        }
      }
    }
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int64_t key = key0 + 8 * h;
    if (key >= sk) continue;
    __nv_bfloat16* krow = dk + (kv_base + key) * D + 2 * (lane % 4);
    __nv_bfloat16* vrow = dv + (kv_base + key) * D + 2 * (lane % 4);
#pragma unroll
    for (int i = 0; i < D / 8; ++i) {
      *reinterpret_cast<__nv_bfloat162*>(krow + i * 8) =
          __floats2bfloat162_rn(dk_acc[i][2 * h], dk_acc[i][2 * h + 1]);
      *reinterpret_cast<__nv_bfloat162*>(vrow + i * 8) =
          __floats2bfloat162_rn(dv_acc[i][2 * h], dv_acc[i][2 * h + 1]);
    }
  }
}

template <int D>
cudaError_t launch(const __nv_bfloat16* q, const __nv_bfloat16* k, const __nv_bfloat16* v,
                   const __nv_bfloat16* dout, const float* lse, const float* delta, float* dq_part,
                   __nv_bfloat16* dk, __nv_bfloat16* dv, int64_t b, int64_t hq, int64_t hkv,
                   int64_t sq, int64_t sk, bool causal, int64_t window, float scale,
                   cudaStream_t stream) {
  const int smem = (2 * BKV + 2 * BQ) * (D + 8) * static_cast<int>(sizeof(__nv_bfloat16)) +
                   2 * BKV * LDS * static_cast<int>(sizeof(__nv_bfloat16)) +
                   2 * BQ * static_cast<int>(sizeof(float));
  const cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_mma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>((sk + BKV - 1) / BKV), static_cast<unsigned>(hkv),
                  static_cast<unsigned>(b));
  flash_bwd_mma_kernel<D><<<grid, THREADS, smem, stream>>>(
      q, k, v, dout, lse, delta, dq_part, dk, dv, static_cast<int>(hq), static_cast<int>(hq / hkv),
      sq, sk, causal, window, scale);
  return cudaGetLastError();
}

}  // namespace tc

template <typename T>
cudaError_t prep(const void* o, const void* dout, float* delta, int64_t rows, int d, cudaStream_t s) {
  constexpr int WARPS = 8;
  flash_bwd_prep_kernel<T><<<static_cast<unsigned>((rows + WARPS - 1) / WARPS), 32 * WARPS, 0, s>>>(
      static_cast<const T*>(o), static_cast<const T*>(dout), delta, rows, d);
  return cudaGetLastError();
}

template <typename T>
cudaError_t reduce_dq(const float* part, void* dq, int64_t n, int d, int64_t sq, int64_t sk,
                      int keys, int rows, bool causal, int64_t window, cudaStream_t s) {
  const int64_t blocks = (n + 255) / 256 < 4096 ? (n + 255) / 256 : 4096;
  flash_bwd_dq_kernel<T><<<static_cast<unsigned>(blocks), 256, 0, s>>>(
      part, static_cast<T*>(dq), n, d, sq, sk, keys, rows, causal, window);
  return cudaGetLastError();
}

}  // namespace
}  // namespace repro

// q, o, dout, dq: (b, hq, sq, d); k, v, dk, dv: (b, hkv, sk, d); all of type
// dtype, contiguous and 16-byte aligned. lse, delta: (b, hq, sq) fp32; dq_part:
// fp32 scratch of ceil(sk / keys) x (b, hq, sq, d), keys = repro_flash_bwd_key_tile(dtype).
// window < 0 means no window.
extern "C" int repro_flash_attention_bwd(const void* q, const void* k, const void* v,
                                         const void* o, const void* dout, const void* lse,
                                         void* delta, void* dq_part, void* dq, void* dk, void* dv,
                                         int dtype, int64_t b, int64_t hq, int64_t hkv, int64_t sq,
                                         int64_t sk, int64_t d, int causal, int64_t window,
                                         float scale, void* stream) {
  using namespace repro;
  if (b < 1 || b > 65535 || hkv < 1 || hkv > 65535 || hq < 1 || hq % hkv != 0 || sq < 1 ||
      sk < 1 || (sk + FB - 1) / FB > 0x7fffffffLL) {
    return cudaErrorInvalidValue;
  }
  for (const void* p : std::initializer_list<const void*>{q, k, v, o, dout, dq, dk, dv}) {
    if (!aligned16(p)) return cudaErrorMisalignedAddress;
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool cz = causal != 0;
  float* del = static_cast<float*>(delta);
  float* acc = static_cast<float*>(dq_part);
  const float* l = static_cast<const float*>(lse);
  const int64_t rows = b * hq * sq;
  cudaError_t err;
  if (dtype == kF32) {
    err = prep<float>(o, dout, del, rows, static_cast<int>(d), s);
    if (err != cudaSuccess) return err;
    const float *fq = static_cast<const float*>(q), *fk = static_cast<const float*>(k),
                *fv = static_cast<const float*>(v), *fo = static_cast<const float*>(dout);
    float *fdk = static_cast<float*>(dk), *fdv = static_cast<float*>(dv);
    switch (d) {
      case 16: err = launch_f32<16>(fq, fk, fv, fo, l, del, acc, fdk, fdv, b, hq, hkv, sq, sk, cz, window, scale, s); break;
      case 32: err = launch_f32<32>(fq, fk, fv, fo, l, del, acc, fdk, fdv, b, hq, hkv, sq, sk, cz, window, scale, s); break;
      case 64: err = launch_f32<64>(fq, fk, fv, fo, l, del, acc, fdk, fdv, b, hq, hkv, sq, sk, cz, window, scale, s); break;
      case 128: err = launch_f32<128>(fq, fk, fv, fo, l, del, acc, fdk, fdv, b, hq, hkv, sq, sk, cz, window, scale, s); break;
      case 256: err = launch_f32<256>(fq, fk, fv, fo, l, del, acc, fdk, fdv, b, hq, hkv, sq, sk, cz, window, scale, s); break;
      default: return cudaErrorInvalidValue;
    }
    if (err != cudaSuccess) return err;
    err = reduce_dq<float>(acc, dq, rows * d, static_cast<int>(d), sq, sk, FB, FB, cz, window, s);
  } else if (dtype == kBF16) {
    using bf = __nv_bfloat16;
    err = prep<bf>(o, dout, del, rows, static_cast<int>(d), s);
    if (err != cudaSuccess) return err;
    const bf *bq = static_cast<const bf*>(q), *bk = static_cast<const bf*>(k),
             *bv = static_cast<const bf*>(v), *bo = static_cast<const bf*>(dout);
    bf *bdk = static_cast<bf*>(dk), *bdv = static_cast<bf*>(dv);
    switch (d) {
      case 16: err = tc::launch<16>(bq, bk, bv, bo, l, del, acc, bdk, bdv, b, hq, hkv, sq, sk, cz, window, scale, s); break;
      case 32: err = tc::launch<32>(bq, bk, bv, bo, l, del, acc, bdk, bdv, b, hq, hkv, sq, sk, cz, window, scale, s); break;
      case 64: err = tc::launch<64>(bq, bk, bv, bo, l, del, acc, bdk, bdv, b, hq, hkv, sq, sk, cz, window, scale, s); break;
      case 128: err = tc::launch<128>(bq, bk, bv, bo, l, del, acc, bdk, bdv, b, hq, hkv, sq, sk, cz, window, scale, s); break;
      default: return cudaErrorInvalidValue;  // D = 256: see the note at the top
    }
    if (err != cudaSuccess) return err;
    err = reduce_dq<bf>(acc, dq, rows * d, static_cast<int>(d), sq, sk, tc::BKV, tc::BQ, cz, window, s);
  } else {
    return cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// Keys a block of the backward kernel owns (dtype's kernel), which sizes dq_part.
extern "C" int repro_flash_bwd_key_tile(int dtype) {
  using namespace repro;
  return dtype == kF32 ? FB : tc::BKV;
}
