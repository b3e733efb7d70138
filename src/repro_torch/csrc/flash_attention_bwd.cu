// Flash-attention backward: dQ, dK, dV of O = softmax(Q K^T * scale + mask) V
// for Q (B, Hq, Sq, D) against K, V (B, Hkv, Sk, D), from Q, K, V, O, dO and
// the forward's row log-sum-exp lse (B, Hq, Sq), never forming (Sq, Sk).
//
// No TPU kernel to replace: the JAX package trains through its pure-JAX
// chunked_attention (src/repro/models/attention.py:44) and has no Pallas
// backward. The port's forward runs the flash kernel (flash_attention.cu), so
// its gradient is a kernel too: FlashAttention-2's algorithm. A prep launch
// forms delta = rowsum(dO o O) in fp32, one warp a row. The main launch gives
// each block a key tile, K and V resident, that walks the query tiles with a
// live key in it: it recomputes S = Q K^T, P = exp(S * scale - lse) (0 where
// masked), dP = dO V^T, dS = P o (dP - delta) * scale, adds dV += P^T dO and
// dK += dS^T Q in registers (a key tile is one block's, so dK and dV need no
// atomics), and adds its term dS K to dQ.
//
// Masks are those of the forward and of kernels/flash_attention/ref.py:
// causal keeps row >= col (top-left aligned, also for Sq != Sk), a window
// keeps row - col < window, keys past Sk and rows past Sq are dead. A row
// with no live key has every P = 0, so its dQ is 0 and it adds nothing to
// dK, dV (its forward output is 0, a constant).
//
// What bounds it: five products of Sq x Sk x D per head (S, dP, dV, dK, dQ;
// halved by the causal mask) against (3 Sq + 2 Sk) D elements read and
// (Sq + 2 Sk) D written, so tensor-core operations at training lengths. Two
// kernels, by dtype:
//   bf16 (wg::flash_bwd_wgmma_kernel, every head dim): wgmma, in the shape of
//     FlashAttention-3's backward. A block of three warpgroups owns 64 keys,
//     K and V resident in the TMA's 128-byte swizzle. A producer warp streams
//     each step's 64-row Q and dO tiles, lse and delta through a ring of
//     stages (TMA and the 1-D bulk copy; a full and an empty mbarrier a
//     stage) and hands its registers to the consumers (setmaxnreg; ptxas
//     still compiles every thread to the launch bound's 168, so at D = 256
//     dK, dV and a 64-column dQ piece fit in 168 with no spill). Consumer
//     warpgroup 0 computes S^T = K Q^T and P^T, warpgroup 1 dP^T = V dO^T and
//     dS^T, both m64n64 with keys as rows, so that P^T and dS^T are the A
//     operands of the dV and dK products as they stand; they meet in shared
//     memory. Then each warpgroup owns half of the head dim for dV += P^T dO,
//     dK += dS^T Q and dQ = dS K (dS^T read transposed): at D = 256 its dK
//     and dV are 64 x 128 fp32, 64 registers a thread each, and dQ goes in
//     64-column pieces.
//     dQ has no partial buffer, and no two adds to it race: the key tiles
//     that visit a query tile add their terms to one fp32 sum of dQ's size
//     in key-tile order, taking turns on a count per (batch, head, query
//     tile); the first stores, the middle ones add in L2 (16-byte
//     reductions, 8 at D = 256: nothing comes back), the last reads, rounds
//     and writes dQ. A helper warp of the producer warpgroup waits for each
//     step's turn a step ahead and passes it on, off the consumers' path.
//     Blocks are numbered key tile first, so a block only waits for blocks
//     issued before it (and the
//     heaviest causal key tiles start first); every block walks its query
//     tiles from the last down, so that the key tiles of a query tile reach
//     it at the same step. Under GQA and MQA the plan (flash_bwd_plan in
//     flash_attention.py) splits a KV head's query heads into `parts` blocks,
//     enough to fill the SMs, which add their dK and dV in part order the
//     same way.
//     P and dS enter the products named in LO_PRODUCTS as hi + lo bf16
//     parts (within about 2^-17 of the fp32 value): one bf16 rounding of each
//     term broke the per-element rule that holds the kernel to its fp32 plain
//     version, in a few elements whose terms cancel. D < 64 runs as D = 64
//     with zero columns (the TMA fills them).
//   fp32 (flash_bwd_f32_kernel): the CUDA cores in fp32 (TF32 would change
//     the result), 32 keys a block, 32 query rows a step, Q, dO, K, V, P and
//     dS tiles in shared memory and each thread's dK, dV columns in
//     registers. Each key tile stores its dQ term in its own slice of a
//     partial buffer (Sk / 32 times dQ's size in fp32), which a third launch
//     adds in key-tile order.
#include <initializer_list>

#include "hopper.cuh"

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

// The key tiles [k0, k1] (of `keys` keys, nkt of them) whose live_rows reach
// query tile t (of `rows` rows); none when k0 > k1.
__device__ __forceinline__ void key_tiles(int64_t t, int rows, int keys, int64_t nkt, bool causal,
                                          int64_t window, int64_t& k0, int64_t& k1) {
  k0 = 0;
  k1 = nkt - 1;
  if (causal) {
    const int64_t last = (t * rows + rows - 1) / keys;  // k_off <= the tile's last row
    if (last < k1) k1 = last;
    const int64_t x = t * rows - (keys - 1) - window;  // k_off + keys - 1 + window > t * rows
    if (window >= 0 && x >= 0) k0 = x / keys + 1;
  }
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

// ------------------------------------------------------ bf16: tensor cores (wgmma)
namespace wg {

constexpr int TILE = 64;                       // query rows of a step
constexpr int CONSUMERS = 256, THREADS = 384;  // two consumer warpgroups and a producer
constexpr int BOX = 64 * 64;                   // bf16 of a 64 x 64 box: 8 KB, one swizzle atom wide
constexpr int BOX_BYTES = BOX * 2;
constexpr int LD = 2 * TILE;                   // floats of a query tile's lse * log2(e) and delta
// Products whose P or dS operand enters as hi + lo bf16 parts (bit 0: dV,
// bit 1: dK, bit 2: dQ); the others take the hi part alone.
constexpr int LO_PRODUCTS = 7;

// Tiles and ring of head dim DP (D rounded up to 64) and KT keys a block.
// KT = 64: the warpgroups share the keys (S^T on one, dP^T on the other)
// and split the head dim for dK and dV. KT = 128 (DP = 64 only, where the
// registers allow it): warpgroup w owns keys 64 w.., computes S^T, dP^T, P
// and dS for them itself and dK, dV at every column; half the key tiles,
// so half the dQ adds, and no exchange of P.
template <int DP, int KT>
struct Cfg {
  static_assert(KT == 64 || DP == 64, "128 keys a block only at D <= 64");
  static constexpr int NB = DP / 64;                  // 64-column boxes of a row tile
  static constexpr int KH = KT / 64;                  // 64-key halves of the block's keys
  static constexpr int NH = DP / 2;                   // columns of dQ a warpgroup owns
  static constexpr int KV_N = KT == 128 ? DP : NH;    // columns of dK, dV a warpgroup owns
  static constexpr int NQ = NH < 64 ? NH : 64;        // columns of dQ a product
  static constexpr bool V4 = DP < 256;                // 16-byte reductions (registers to spare)
  static constexpr int STAGES = DP == 256 ? 2 : 3;    // ring of Q, dO, lse and delta
  static constexpr int TILE_ELEMS = NB * BOX;         // a 64-row tile of Q or dO
  static constexpr int KV_ELEMS = KH * TILE_ELEMS;    // the block's K or V
  // alignment slack, K, V, the ring, P^T and dS^T (hi and lo of each half),
  // the ring's lse and delta
  static constexpr int SMEM = 1024 + (2 * KV_ELEMS + 2 * STAGES * TILE_ELEMS) * 2 + 4 * KH * BOX_BYTES +
                              STAGES * LD * 4;
};

struct Args {
  const float* ld;     // (B Hq, nt, LD): each query tile's lse * log2(e) and delta, rows past Sq 0
  float* dq_acc;       // (B, Hq, Sq, D) fp32: dQ's running sum over key tiles
  float* dkv_acc;      // 2 x (B, Hkv, Sk, D) fp32: dK's and dV's running sums over parts
  int* dq_count;       // (B, Hq, nt): key tiles that have added to a query tile
  int* dkv_count;      // (B, Hkv, nkt): parts that have added to a key tile
  __nv_bfloat16 *dq, *dk, *dv;
  int b, hq, hkv, parts, d, nt, nkt;  // nkt: key tiles of the kernel's KT keys
  int64_t sq, sk, window;
  bool causal;
  float scale;
};

__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(CONSUMERS) : "memory");
}

// Descriptor of a 16-deep K step of a K-major 64-row tile stored as 64-column
// boxes: step kk sits in box kk / 4, 32 bytes in per step.
__device__ __forceinline__ uint64_t k_major(uint32_t tile, int kk) {
  return sw128_desc(tile + (kk / 4) * BOX_BYTES + (kk % 4) * 32);
}
// Descriptor of rows 16 kk.. of a row tile read MN-major from column col0:
// boxes BOX_BYTES apart along N, 8-row groups 1024 bytes apart along K.
__device__ __forceinline__ uint64_t mn_major(uint32_t tile, int col0, int kk) {
  return sw128_desc(tile + (col0 / 64) * BOX_BYTES + (col0 % 64) * 2 + kk * 2048, BOX_BYTES, 1024);
}
// Element (r, c) of a 64 x 64 bf16 tile in the 128-byte swizzle.
__device__ __forceinline__ int sw(int r, int c) { return r * 64 + (((c / 8) ^ (r % 8)) * 8) + c % 8; }

// acc (+)= the P^T or dS^T tile at x (hi, then lo at x + lo_off unless
// lo_off is 0) times B's columns col0.. of a row tile, MN-major, over KSTEPS
// 16-deep steps; or, with TA, the tiles read transposed (dS, KSTEPS / 4 of
// them one after another).
template <int N, int TA, int KSTEPS = 4>
__device__ __forceinline__ void add_product(float (&acc)[N / 2], uint32_t x, uint32_t lo_off, uint32_t tile,
                                            int col0, int first) {
#pragma unroll
  for (int part = 0; part < 2; ++part) {
    if (part == 1 && lo_off == 0) break;
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) {
      const uint32_t a = x + part * lo_off;
      const uint64_t da = TA ? sw128_desc(a + kk * 2048, BOX_BYTES, 1024) : sw128_desc(a + kk * 32);
      Wgmma<N, TA, 1>::mma(acc, da, mn_major(tile, col0, kk), (part > 0 || kk > 0) ? 1 : first);
    }
  }
}

// Adds a 64 x N fragment (wgmma's accumulator layout, columns col0..) to an
// fp32 sum of `rows` x d in its turn: the first turn stores, a middle turn
// adds in L2 (16-byte reductions: nothing comes back, and no other block
// touches the elements until this block's turn is over), the last reads the
// sum, adds and writes `out` rounded to bf16. Rows past `rows` and columns
// past d are skipped (d is a multiple of 8). A middle turn's reductions are
// of 4 floats (V4, after a shuffle with the partner lane) or of the lane's
// own 2 (fewer registers: D = 256).
template <int N, bool V4>
__device__ __forceinline__ void add_in_turn(const float (&x)[N / 2], float* sum, __nv_bfloat16* out,
                                            int64_t row0, int64_t rows, int d, int col0, bool first,
                                            bool last, int warp, int lane) {
  const int c = col0 + 2 * (lane % 4);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int64_t r = row0 + warp * 16 + lane / 4 + 8 * h;
    const bool row_ok = r < rows;  // lanes l and l ^ 1 share their rows
    float* s = sum + r * d + c;
    if (!row_ok && (last || first)) continue;
    if (last) {
      // BATCH pairs' loads in flight at a time: few registers beside dK and
      // dV (at D = 256 they hold 128 of a consumer thread's 168).
      constexpr int BATCH = V4 ? 4 : 2;
      __nv_bfloat16* o = out + r * d + c;
#pragma unroll
      for (int i0 = 0; i0 < N / 8; i0 += BATCH) {
        float2 prev[BATCH];
#pragma unroll
        for (int i = i0; i < i0 + BATCH; ++i) {
          prev[i - i0] = make_float2(0.f, 0.f);
          if (!first && c + 8 * i < d) prev[i - i0] = __ldcg(reinterpret_cast<const float2*>(s + 8 * i));
        }
#pragma unroll
        for (int i = i0; i < i0 + BATCH; ++i) {
          if (c + 8 * i < d) {
            *reinterpret_cast<__nv_bfloat162*>(o + 8 * i) = __floats2bfloat162_rn(
                prev[i - i0].x + x[4 * i + 2 * h], prev[i - i0].y + x[4 * i + 2 * h + 1]);
          }
        }
      }
    } else if (first) {
#pragma unroll
      for (int i = 0; i < N / 8; ++i) {
        if (c + 8 * i < d) {
          __stcg(reinterpret_cast<float2*>(s + 8 * i), make_float2(x[4 * i + 2 * h], x[4 * i + 2 * h + 1]));
        }
      }
    } else if (!V4) {
#pragma unroll
      for (int i = 0; i < N / 8; ++i) {
        if (row_ok && c + 8 * i < d) {  // in turn, so the order of the adds is fixed
          atomicAdd(reinterpret_cast<float2*>(s + 8 * i), make_float2(x[4 * i + 2 * h], x[4 * i + 2 * h + 1]));
        }
      }
    } else {
      // In turn, so the order of the adds is fixed. Lanes l and l ^ 1 hold
      // columns 2 (l % 4) and 2 (l % 4) + 2 of each 8: for even i the even
      // lane takes its partner's pair and adds 4 columns in one reduction,
      // for odd i the odd lane does. Every lane shuffles, past the rows too.
      const bool odd = lane & 1;
      float* s4 = s - (odd ? 2 : 0);
#pragma unroll
      for (int i = 0; i < N / 8; ++i) {
        const float give0 = x[4 * i + 2 * h], give1 = x[4 * i + 2 * h + 1];
        const float got0 = __shfl_xor_sync(0xffffffffu, give0, 1);
        const float got1 = __shfl_xor_sync(0xffffffffu, give1, 1);
        if (row_ok && (i & 1) == odd && c - (odd ? 2 : 0) + 8 * i < d) {
          const float4 v = odd ? make_float4(got0, got1, give0, give1) : make_float4(give0, give1, got0, got1);
          atomicAdd(reinterpret_cast<float4*>(s4 + 8 * i), v);
        }
      }
    }
  }
}

// Query tile of step s of a block: heads h0.., each over tiles t_first + nt
// - 1 down to t_first; its turn among the key tiles that visit it and
// whether it is the last.
struct Step {
  int h, t, turn;
  bool last;
};
template <int KT>
__device__ __forceinline__ Step step_at(int s, int h0, int t_first, int nt, int kt, const Args& a) {
  Step st;
  st.h = h0 + s / nt;
  st.t = t_first + nt - 1 - s % nt;
  int64_t k_lo, k_hi;
  key_tiles(st.t, TILE, KT, a.nkt, a.causal, a.window, k_lo, k_hi);
  st.turn = kt - static_cast<int>(k_lo);
  st.last = kt == k_hi;
  return st;
}

template <int DP, int KT>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_wgmma_kernel(const __grid_constant__ CUtensorMap map_q, const __grid_constant__ CUtensorMap map_k,
                       const __grid_constant__ CUtensorMap map_v, const __grid_constant__ CUtensorMap map_do,
                       const Args a) {
  using C = Cfg<DP, KT>;
  using bf = __nv_bfloat16;
  constexpr float kLog2e = 1.4426950408889634f;
  __shared__ __align__(8) uint64_t full[C::STAGES];   // a stage's tiles have landed
  __shared__ __align__(8) uint64_t empty[C::STAGES];  // the 8 consumer warps are done with a stage
  __shared__ __align__(8) uint64_t kv_full;
  // Step s's dQ turn has come (the helper warp), and the 8 consumer warps
  // have added step s's dQ: barrier s % 2 of each, so the helper can run a
  // step ahead.
  __shared__ __align__(8) uint64_t turn_ok[2];
  __shared__ __align__(8) uint64_t added[2];
  extern __shared__ uint8_t smem_raw[];
  bf* ks = reinterpret_cast<bf*>(smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023));
  bf* vs = ks + C::KV_ELEMS;
  bf* ring = vs + C::KV_ELEMS;                    // stage s: Q, then dO
  bf* pt = ring + 2 * C::STAGES * C::TILE_ELEMS;  // P^T [key][row]: hi of each half, then lo
  bf* dst = pt + 2 * C::KH * BOX;                 // dS^T [key][row]: the same
  float* lds = reinterpret_cast<float*>(dst + 2 * C::KH * BOX);  // [STAGES][LD]

  // Block order: key tile slowest (heaviest causal tiles first), then the
  // part of the KV head's query heads, the batch entry and the KV head.
  int u = blockIdx.x;
  const int kvh = u % a.hkv;
  u /= a.hkv;
  const int bi = u % a.b;
  u /= a.b;
  const int part = u % a.parts, kt = u / a.parts;
  const int heads = a.hq / a.hkv / a.parts;
  const int h0 = kvh * (a.hq / a.hkv) + part * heads;  // the part's first query head
  const int64_t k_off = static_cast<int64_t>(kt) * KT;
  int64_t lo, hi;
  live_rows(k_off, KT, a.sq, a.causal, a.window, lo, hi);
  const int t_first = static_cast<int>(lo / TILE);
  const int nt = hi > lo ? static_cast<int>((hi + TILE - 1) / TILE) - t_first : 0;
  const int steps = heads * nt;  // step s: head h0 + s / nt, query tile t_first + nt - 1 - s % nt

  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int i = 0; i < C::STAGES; ++i) {
      mbar_init(&full[i]);
      mbar_init<CONSUMERS / 32>(&empty[i]);
    }
    mbar_init(&kv_full);
    for (int i = 0; i < 2; ++i) {
      mbar_init(&turn_ok[i]);
      mbar_init<CONSUMERS / 32>(&added[i]);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= CONSUMERS) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (tid == CONSUMERS + 32) {
      // Helper: waits for each step's dQ turn (the key tiles before this one
      // have added) a step ahead and tells the consumers; once they have
      // added, passes the turn on (fence, then the count), off their path.
      const auto count_of = [&](const Step& st) {
        return a.dq_count + (static_cast<int64_t>(bi) * a.hq + st.h) * a.nt + st.t;
      };
      Step next = step_at<KT>(0, h0, t_first, nt, kt, a);
      if (steps > 0) {
        if (next.turn > 0) wait_for(count_of(next), next.turn);
        mbar_arrive(&turn_ok[0]);
      }
      for (int s = 0; s < steps; ++s) {
        const Step st = next;
        if (s + 1 < steps) {
          next = step_at<KT>(s + 1, h0, t_first, nt, kt, a);
          if (next.turn > 0) wait_for(count_of(next), next.turn);
          mbar_arrive(&turn_ok[(s + 1) & 1]);
        }
        mbar_wait(&added[s & 1], (s >> 1) & 1);
        if (!st.last) signal_count(count_of(st));
      }
      return;
    }
    // Producer: one thread issues K and V once, then each step's tiles into
    // stage s % STAGES once the consumers have left it.
    if (tid != CONSUMERS) return;
    const int kv_plane = bi * a.hkv + kvh;
    mbar_expect_tx(&kv_full, 2 * C::KV_ELEMS * 2);
    for (int j = 0; j < C::NB; ++j) {  // boxes of KT rows: a column box's halves stacked
      tma_load(ks + j * C::KH * BOX, &map_k, &kv_full, 64 * j, kt * KT, kv_plane);
      tma_load(vs + j * C::KH * BOX, &map_v, &kv_full, 64 * j, kt * KT, kv_plane);
    }
    int slot = 0, phase = 0;
    for (int s = 0; s < steps; ++s) {
      if (s >= C::STAGES) mbar_wait(&empty[slot], phase ^ 1);
      const int plane = bi * a.hq + h0 + s / nt, t = t_first + nt - 1 - s % nt;
      bf* qs = ring + 2 * slot * C::TILE_ELEMS;
      bf* dos = qs + C::TILE_ELEMS;
      mbar_expect_tx(&full[slot], 2 * C::TILE_ELEMS * 2 + LD * 4);
      for (int j = 0; j < C::NB; ++j) {
        tma_load(qs + j * BOX, &map_q, &full[slot], 64 * j, t * TILE, plane);
        tma_load(dos + j * BOX, &map_do, &full[slot], 64 * j, t * TILE, plane);
      }
      bulk_load(lds + slot * LD, a.ld + (static_cast<int64_t>(plane) * a.nt + t) * LD, LD * 4, &full[slot]);
      if (++slot == C::STAGES) {
        slot = 0;
        phase ^= 1;
      }
    }
    return;
  }

  // Consumers: warpgroup wg; its lane holds accumulator rows 16 warp + lane / 4
  // (+ 8). It owns dQ's columns col0 .. col0 + NH - 1, and dK's and dV's
  // columns kv_col0 .. + KV_N - 1 of keys kv_row0 .. + 63 of the block's.
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int wg = tid / 128, warp = (tid / 32) % 4, lane = tid % 32;
  const int col0 = wg * C::NH;
  const int kv_col0 = KT == 128 ? 0 : col0, kv_row0 = KT == 128 ? 64 * wg : 0;
  const float scale_log2 = a.scale * kLog2e;
  float acc_dk[C::KV_N / 2], acc_dv[C::KV_N / 2];
#pragma unroll
  for (int i = 0; i < C::KV_N / 2; ++i) acc_dk[i] = acc_dv[i] = 0.f;
  const uint32_t k_addr = smem_u32(ks), v_addr = smem_u32(vs);
  // This warpgroup's P^T and dS^T tiles (KT = 64: the one pair, shared);
  // each tile's lo part lies KH boxes after its hi part.
  const int half = KT == 128 ? wg : 0;
  bf* my_pt = pt + half * BOX;
  bf* my_dst = dst + half * BOX;
  const uint32_t lo_bytes = C::KH * BOX_BYTES;
  mbar_wait(&kv_full, 0);

  int slot = 0, phase = 0;
  for (int s = 0; s < steps; ++s) {
    const Step st = step_at<KT>(s, h0, t_first, nt, kt, a);
    const int64_t q_off = static_cast<int64_t>(st.t) * TILE;
    const uint32_t q_addr = smem_u32(ring + 2 * slot * C::TILE_ELEMS);
    const uint32_t do_addr = q_addr + C::TILE_ELEMS * 2;
    const float* lse2 = lds + slot * LD;
    const float* delta = lse2 + TILE;
    // Whether any (row, key) of the tile is dead.
    const bool masked = q_off + TILE > a.sq || k_off + KT > a.sk || (a.causal && q_off < k_off + KT - 1) ||
                        (a.window >= 0 && q_off + TILE - 1 - k_off >= a.window);
    mbar_wait(&full[slot], phase);

    // Register 4 i + 2 hh + j of a 64 x 64 product below: key 16 warp +
    // lane / 4 + 8 hh of the 64, row 8 i + 2 (lane % 4) + j.
    const auto p_of = [&](const float (&sc)[32], int i, int hh, int j, int key) {
      const int row = 8 * i + 2 * (lane % 4) + j;
      const float p = exp2f(sc[4 * i + 2 * hh + j] * scale_log2 - lse2[row]);
      return masked && !live(q_off + row, k_off + key, a.sq, a.sk, a.causal, a.window) ? 0.f : p;
    };
    const auto put = [&](bf* tile, int key, int row, float v0, float v1) {  // hi, and lo lo_bytes on
      const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
      const float2 back = __bfloat1622float2(h);
      *reinterpret_cast<__nv_bfloat162*>(tile + sw(key, row)) = h;
      *reinterpret_cast<__nv_bfloat162*>(tile + C::KH * BOX + sw(key, row)) =
          __floats2bfloat162_rn(v0 - back.x, v1 - back.y);
    };
    if constexpr (KT == 64) {
      // S^T = K Q^T (warpgroup 0) or dP^T = V dO^T (warpgroup 1): 64 keys x 64 rows.
      float x[32];
      const uint32_t at = wg == 0 ? k_addr : v_addr, bt = wg == 0 ? q_addr : do_addr;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) Wgmma<64, 0, 0>::mma(x, k_major(at, kk), k_major(bt, kk), kk > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(x);
      consumers_sync();  // both warpgroups are done with the previous step's P^T and dS^T
      if (wg == 0) {
#pragma unroll
        for (int i = 0; i < 8; ++i) {
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int key = warp * 16 + lane / 4 + 8 * hh, row = 8 * i + 2 * (lane % 4);
            put(pt, key, row, p_of(x, i, hh, 0, key), p_of(x, i, hh, 1, key));
          }
        }
        fence_proxy_async();  // the generic stores, visible to wgmma
      }
      consumers_sync();  // P^T is in shared memory
      if (wg == 1) {  // dS^T = P^T o (dP^T - delta) * scale, P^T read back (hi + lo)
#pragma unroll
        for (int i = 0; i < 8; ++i) {
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int key = warp * 16 + lane / 4 + 8 * hh, row = 8 * i + 2 * (lane % 4);
            const float2 ph = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(pt + sw(key, row)));
            const float2 pl = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(pt + BOX + sw(key, row)));
            put(dst, key, row, (ph.x + pl.x) * (x[4 * i + 2 * hh] - delta[row]) * a.scale,
                (ph.y + pl.y) * (x[4 * i + 2 * hh + 1] - delta[row + 1]) * a.scale);
          }
        }
        fence_proxy_async();
      }
    } else {
      // Each warpgroup: S^T = K Q^T and dP^T = V dO^T for its 64 keys, then
      // P^T and dS^T = P^T o (dP^T - delta) * scale in registers.
      float xs[32], xd[32];
      const uint32_t kh = k_addr + wg * BOX_BYTES, vh = v_addr + wg * BOX_BYTES;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) Wgmma<64, 0, 0>::mma(xs, k_major(kh, kk), k_major(q_addr, kk), kk > 0);
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) Wgmma<64, 0, 0>::mma(xd, k_major(vh, kk), k_major(do_addr, kk), kk > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(xs);
      fence_regs(xd);
      consumers_sync();  // the other warpgroup is done with the previous step's dS^T
#pragma unroll
      for (int i = 0; i < 8; ++i) {
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int key = warp * 16 + lane / 4 + 8 * hh, row = 8 * i + 2 * (lane % 4);
          const float p0 = p_of(xs, i, hh, 0, kv_row0 + key), p1 = p_of(xs, i, hh, 1, kv_row0 + key);
          put(my_pt, key, row, p0, p1);
          put(my_dst, key, row, p0 * (xd[4 * i + 2 * hh] - delta[row]) * a.scale,
              p1 * (xd[4 * i + 2 * hh + 1] - delta[row + 1]) * a.scale);
        }
      }
      fence_proxy_async();
    }
    consumers_sync();  // dS^T (both halves) is in shared memory

    // dV += P^T dO, dK += dS^T Q on this warpgroup's keys and columns.
    fence_regs(acc_dv);
    fence_regs(acc_dk);
    wgmma_fence();
    add_product<C::KV_N, 0>(acc_dv, smem_u32(my_pt), LO_PRODUCTS & 1 ? lo_bytes : 0, do_addr, kv_col0, 1);
    add_product<C::KV_N, 0>(acc_dk, smem_u32(my_dst), LO_PRODUCTS & 2 ? lo_bytes : 0, q_addr, kv_col0, 1);
    wgmma_commit();

    // dQ = dS K over the block's keys, NQ columns a product, added to dQ in
    // this key tile's turn.
    const int64_t plane_off = (static_cast<int64_t>(bi) * a.hq + st.h) * a.sq * a.d;
#pragma unroll
    for (int c = 0; c < C::NH / C::NQ; ++c) {
      float dq[C::NQ / 2];
      wgmma_fence();
      add_product<C::NQ, 1, 4 * C::KH>(dq, smem_u32(dst), LO_PRODUCTS & 4 ? lo_bytes : 0, k_addr,
                                       col0 + c * C::NQ, 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dq);
      if (c == 0) {
        // Q, dO and lse of the stage are read: release it, then wait for the turn.
        if (lane == 0) mbar_arrive(&empty[slot]);
        mbar_wait(&turn_ok[s & 1], (s >> 1) & 1);
      }
      add_in_turn<C::NQ, C::V4>(dq, a.dq_acc + plane_off, a.dq + plane_off, q_off, a.sq, a.d,
                                col0 + c * C::NQ, st.turn == 0, st.last, warp, lane);
    }
    fence_regs(acc_dv);
    fence_regs(acc_dk);
    __syncwarp();
    if (lane == 0) mbar_arrive(&added[s & 1]);
    if (++slot == C::STAGES) {
      slot = 0;
      phase ^= 1;
    }
  }

  // dK and dV of this key tile: written, or added over the parts in part order.
  const int64_t kv_off = (static_cast<int64_t>(bi) * a.hkv + kvh) * a.sk * a.d;
  const int64_t kv_rows = k_off + kv_row0;
  if (a.parts == 1) {
    add_in_turn<C::KV_N, C::V4>(acc_dk, nullptr, a.dk + kv_off, kv_rows, a.sk, a.d, kv_col0, true, true, warp,
                                lane);
    add_in_turn<C::KV_N, C::V4>(acc_dv, nullptr, a.dv + kv_off, kv_rows, a.sk, a.d, kv_col0, true, true, warp,
                                lane);
    return;
  }
  int* count = a.dkv_count + (static_cast<int64_t>(bi) * a.hkv + kvh) * a.nkt + kt;
  if (part > 0) {
    if (tid == 0) wait_for(count, part);
    consumers_sync();
  }
  const bool last = part == a.parts - 1;
  const int64_t dv_acc = static_cast<int64_t>(a.b) * a.hkv * a.sk * a.d;
  add_in_turn<C::KV_N, C::V4>(acc_dk, a.dkv_acc + kv_off, a.dk + kv_off, kv_rows, a.sk, a.d, kv_col0, part == 0,
                              last, warp, lane);
  add_in_turn<C::KV_N, C::V4>(acc_dv, a.dkv_acc + dv_acc + kv_off, a.dv + kv_off, kv_rows, a.sk, a.d, kv_col0,
                              part == 0, last, warp, lane);
  if (!last) {
    consumers_sync();
    if (tid == 0) signal_count(count);
  }
}

// delta and the lse of one (plane, row) per warp, into the ld tiles; rows
// past Sq zero. A row of a query tile that no key tile visits gets dQ = 0.
__global__ void flash_bwd_prep_tiles_kernel(const __nv_bfloat16* __restrict__ o,
                                            const __nv_bfloat16* __restrict__ dout,
                                            const float* __restrict__ lse, float* __restrict__ ld,
                                            __nv_bfloat16* __restrict__ dq, int64_t planes, int64_t sq, int nt,
                                            int d, int keys, int64_t nkt, bool causal, int64_t window) {
  constexpr int WARPS = 8;
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * WARPS + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int64_t padded = static_cast<int64_t>(nt) * TILE;
  if (idx >= planes * padded) return;
  const int64_t plane = idx / padded, r = idx % padded, t = r / TILE;
  float* tile = ld + (plane * nt + t) * LD;
  if (r >= sq) {
    if (lane == 0) tile[r % TILE] = tile[TILE + r % TILE] = 0.f;
    return;
  }
  const int64_t row = plane * sq + r;
  float s = 0.f;
  for (int i = lane; i < d; i += 32) s = fmaf(to_f32(dout[row * d + i]), to_f32(o[row * d + i]), s);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) {
    tile[r % TILE] = lse[row] * 1.4426950408889634f;
    tile[TILE + r % TILE] = s;
  }
  int64_t k0, k1;
  key_tiles(t, TILE, keys, nkt, causal, window, k0, k1);
  if (k0 > k1) {
    for (int i = lane; i < d; i += 32) dq[row * d + i] = __float2bfloat16_rn(0.f);
  }
}

template <int DP, int KT>
cudaError_t launch(const void* q, const void* k, const void* v, const void* o, const void* dout,
                   const float* lse, Args a, cudaStream_t stream) {
  using C = Cfg<DP, KT>;
  using bf = __nv_bfloat16;
  a.nkt = static_cast<int>((a.sk + KT - 1) / KT);
  a.dkv_count = a.dq_count + static_cast<int64_t>(a.b) * a.hq * a.nt;
  const int64_t blocks = static_cast<int64_t>(a.nkt) * a.parts * a.b * a.hkv;
  if (blocks > INT32_MAX) return cudaErrorInvalidValue;
  CUtensorMap map_q = {}, map_k = {}, map_v = {}, map_do = {};
  if (!make_map<bf>(&map_q, q, static_cast<int64_t>(a.b) * a.hq, a.sq, a.d, TILE, 64) ||
      !make_map<bf>(&map_do, dout, static_cast<int64_t>(a.b) * a.hq, a.sq, a.d, TILE, 64) ||
      !make_map<bf>(&map_k, k, static_cast<int64_t>(a.b) * a.hkv, a.sk, a.d, KT, 64) ||
      !make_map<bf>(&map_v, v, static_cast<int64_t>(a.b) * a.hkv, a.sk, a.d, KT, 64)) {
    return cudaErrorInvalidValue;
  }
  const int64_t planes = static_cast<int64_t>(a.b) * a.hq;
  const int64_t warps = planes * a.nt * TILE;
  flash_bwd_prep_tiles_kernel<<<static_cast<unsigned>((warps + 7) / 8), 256, 0, stream>>>(
      static_cast<const bf*>(o), static_cast<const bf*>(dout), lse, const_cast<float*>(a.ld), a.dq, planes, a.sq,
      a.nt, a.d, KT, a.nkt, a.causal, a.window);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t counts = static_cast<size_t>(planes) * a.nt +
                        (a.parts > 1 ? static_cast<size_t>(a.b) * a.hkv * a.nkt : 0);
  err = cudaMemsetAsync(a.dq_count, 0, counts * sizeof(int), stream);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_bwd_wgmma_kernel<DP, KT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             C::SMEM);
  if (err != cudaSuccess) return err;
  flash_bwd_wgmma_kernel<DP, KT><<<static_cast<unsigned>(blocks), THREADS, C::SMEM, stream>>>(map_q, map_k, map_v,
                                                                                             map_do, a);
  return cudaGetLastError();
}

}  // namespace wg

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
// dtype, contiguous and 16-byte aligned; lse (b, hq, sq) fp32; window < 0
// means no window. Scratch, sized by flash_bwd_plan (flash_attention.py):
//   fp32: stats = delta (b, hq, sq); acc = the partial dQ, ceil(sk / 32) x
//     (b, hq, sq, d); dkv_acc, counts unused, parts 1.
//   bf16: stats = lse and delta by query tile (b hq, ceil(sq / 64), 128),
//     16-byte aligned; acc = dQ's fp32 sum (b, hq, sq, d), unused at one key
//     tile (of 128 keys at d <= 64, else 64); dkv_acc = dK's then dV's fp32
//     sums (2, b, hkv, sk, d) when parts > 1; counts = b hq ceil(sq / 64)
//     ints, then b hkv times the key tiles when parts > 1.
extern "C" int repro_flash_attention_bwd(const void* q, const void* k, const void* v, const void* o,
                                         const void* dout, const void* lse, void* stats, void* acc,
                                         void* dkv_acc, void* counts, void* dq, void* dk, void* dv, int dtype,
                                         int64_t b, int64_t hq, int64_t hkv, int64_t sq, int64_t sk, int64_t d,
                                         int causal, int64_t window, float scale, int parts, void* stream) {
  using namespace repro;
  if (b < 1 || b > 65535 || hkv < 1 || hkv > 65535 || hq < 1 || hq % hkv != 0 || sq < 1 || sk < 1 ||
      sq > 0x7fffffffLL || sk > 0x7fffffffLL || parts < 1 || (hq / hkv) % parts != 0) {
    return cudaErrorInvalidValue;
  }
  for (const void* p : std::initializer_list<const void*>{q, k, v, o, dout, dq, dk, dv, stats}) {
    if (!aligned16(p)) return cudaErrorMisalignedAddress;
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool cz = causal != 0;
  float* st = static_cast<float*>(stats);
  float* sum = static_cast<float*>(acc);
  const float* l = static_cast<const float*>(lse);
  const int64_t rows = b * hq * sq;
  cudaError_t err;
  if (dtype == kF32) {
    if (parts != 1) return cudaErrorInvalidValue;
    err = prep<float>(o, dout, st, rows, static_cast<int>(d), s);
    if (err != cudaSuccess) return err;
    const float *fq = static_cast<const float*>(q), *fk = static_cast<const float*>(k),
                *fv = static_cast<const float*>(v), *fo = static_cast<const float*>(dout);
    float *fdk = static_cast<float*>(dk), *fdv = static_cast<float*>(dv);
    switch (d) {
      case 16: err = launch_f32<16>(fq, fk, fv, fo, l, st, sum, fdk, fdv, b, hq, hkv, sq, sk, cz, window, scale, s); break;
      case 32: err = launch_f32<32>(fq, fk, fv, fo, l, st, sum, fdk, fdv, b, hq, hkv, sq, sk, cz, window, scale, s); break;
      case 64: err = launch_f32<64>(fq, fk, fv, fo, l, st, sum, fdk, fdv, b, hq, hkv, sq, sk, cz, window, scale, s); break;
      case 128: err = launch_f32<128>(fq, fk, fv, fo, l, st, sum, fdk, fdv, b, hq, hkv, sq, sk, cz, window, scale, s); break;
      case 256: err = launch_f32<256>(fq, fk, fv, fo, l, st, sum, fdk, fdv, b, hq, hkv, sq, sk, cz, window, scale, s); break;
      default: return cudaErrorInvalidValue;
    }
    if (err != cudaSuccess) return err;
    err = reduce_dq<float>(sum, dq, rows * d, static_cast<int>(d), sq, sk, FB, FB, cz, window, s);
  } else if (dtype == kBF16) {
    using bf = __nv_bfloat16;
    wg::Args a;
    a.ld = st;
    a.dq_acc = sum;
    a.dkv_acc = static_cast<float*>(dkv_acc);
    a.nt = static_cast<int>((sq + wg::TILE - 1) / wg::TILE);
    a.dq_count = static_cast<int*>(counts);
    a.dq = static_cast<bf*>(dq);
    a.dk = static_cast<bf*>(dk);
    a.dv = static_cast<bf*>(dv);
    a.b = static_cast<int>(b);
    a.hq = static_cast<int>(hq);
    a.hkv = static_cast<int>(hkv);
    a.parts = parts;
    a.d = static_cast<int>(d);
    a.sq = sq;
    a.sk = sk;
    a.window = window;
    a.causal = cz;
    a.scale = scale;
    switch (d) {
      case 16: case 32: case 64: err = wg::launch<64, 128>(q, k, v, o, dout, l, a, s); break;
      case 128: err = wg::launch<128, 64>(q, k, v, o, dout, l, a, s); break;
      case 256: err = wg::launch<256, 64>(q, k, v, o, dout, l, a, s); break;
      default: return cudaErrorInvalidValue;
    }
  } else {
    return cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// Bytes of dynamic shared memory a block of dtype's backward kernel takes at
// head dim d (flash_bwd_plan holds the same number).
extern "C" int repro_flash_bwd_smem(int dtype, int d) {
  using namespace repro;
  if (dtype == kF32) return (4 * FB * (d + 1) + 2 * FB * (FB + 1) + 2 * FB) * static_cast<int>(sizeof(float));
  if (d <= 64) return wg::Cfg<64, 128>::SMEM;
  return d <= 128 ? wg::Cfg<128, 64>::SMEM : wg::Cfg<256, 64>::SMEM;
}
