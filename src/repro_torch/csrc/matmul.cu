// Batched matmul (mb, m, k) x (mb, k, n) -> (mb, m, n) with fp32 accumulation.
//
// Replaces batched_matmul_pallas (src/repro/kernels/matmul/matmul.py:95),
// Stark's leaf stage batched over the 7^depth tag index, and matmul_pallas
// (:43), which is this kernel launched with mb = 1.
//
// What bounds it: at the leaf shapes of the main path (e.g. 49 x 4096^3) the
// work is 2*m*n*k*mb flops against (m*k + k*n + m*n)*mb elements moved, far
// above the card's balance point, so the arithmetic rate is the bound: fp32
// FMA on the CUDA cores (67 TFLOP/s; TF32 tensor cores would change the
// result) and bf16 on the tensor cores (989 TFLOP/s). Both round the fp32
// sum once to the storage type.
//
// Design: one block per output tile of one batch entry, tiles in groups of 8
// tile rows so that blocks in flight share their A rows and B columns in L2
// (plain row order ran 1.1-1.2x slower in bf16 and the same in fp32). The K
// loop runs inside the block over a ring of shared-memory stages that the
// TMA fills (one thread issues a step's boxes; each stage completes on its
// own mbarrier; edges past M, N and K arrive zero-filled). The alternatives
// named here were timed by tools/matmul_variants.py.
//
//   fp32: a 128 x 256 tile, 256 threads on the CUDA cores (FFMA only), each
//   an 8 x 16 micro-tile, one block an SM (at most 255 registers a thread),
//   a ring of 4 stages of 32-deep K steps and one __syncthreads a step (a
//   release by each warp on an mbarrier instead ran 1.6% slower). A
//   lands as it is stored (rows of 32 floats, 128 bytes) in the TMA's
//   128-byte swizzle, B row-major. A warp owns 32 x 128 of the tile: lane l
//   takes rows l/8 + 4i (i = 0..7) and columns (l%8)*4 + 32q + {0..3}
//   (q = 0..3). Per 4 k a thread loads each of its rows' float4 along k,
//   then each B row's four float4s: eight lanes share each A float4 (a
//   broadcast) and the four distinct rows of an A load lie in four bank
//   groups thanks to the swizzle; the eight distinct B float4s of a load are
//   one 128-byte line. 21 FFMA per LDS.128.
//
//   bf16: a 128 x 256 tile, a producer warpgroup (one thread issues the TMA;
//   setmaxnreg hands its registers to the consumers) and two consumer
//   warpgroups, each 64 x 256 of the tile on wgmma.mma_async m64n256k16 with
//   fp32 accumulation (128 registers a thread), reading both operands from
//   shared memory in the 128-byte swizzle the TMA lands them in: A K-major
//   (rows of 64 bf16), B N-major through the transpose bit (four 64-column
//   boxes, 8 KB apart). 64-deep K steps, a ring of 4 stages with a full and
//   an empty mbarrier each; a consumer warp releases a stage once the wgmma
//   group after it has been issued and the group on it has completed. (A
//   128 x 128 tile, or two of them an SM, ran 1.2-1.3x slower.)
//
// Both kernels store C as fp32 or bf16 (out_dtype), whatever the operands:
// the fp32 accumulators are stored as they are, or rounded once to bf16.
//
// Shapes whose rows are not whole 16-byte chunks (K or N not a multiple of 4
// fp32 or 8 bf16), or whose bases are not 16-byte aligned, which the TMA
// cannot address, load tiles element by element into the same ring and
// layout: the whole fp32 block, or the bf16 producer warpgroup.
#include "hopper.cuh"

namespace repro {
namespace {

constexpr int GROUP_M = 8;  // tile rows per raster group

struct Tile {
  int batch, row0, col0;
};

// Block u's tile: batch entry u / (tiles_m * tiles_n); within it, groups of
// GROUP_M tile rows, walked column by column.
template <int BM, int BN>
__device__ __forceinline__ Tile tile_at(int u, int tiles_m, int tiles_n) {
  const int per_batch = tiles_m * tiles_n;
  Tile t;
  t.batch = u / per_batch;
  const int bid = u - t.batch * per_batch;
  const int group = bid / (GROUP_M * tiles_n);
  const int first = group * GROUP_M;
  const int rows = min(tiles_m - first, GROUP_M);
  const int in = bid - group * GROUP_M * tiles_n;
  t.row0 = (first + in % rows) * BM;
  t.col0 = (in / rows) * BN;
  return t;
}

// Offset of element (r, c) in a tile with rows of 128 bytes (8 chunks of 16
// bytes, VEC elements each) in the 128-byte swizzle: chunk c / VEC of row r
// sits at chunk (c / VEC) ^ (r % 8).
template <int VEC>
__device__ __forceinline__ int sw128_offset(int r, int c) {
  return r * 8 * VEC + ((((c / VEC) ^ r) & 7) * VEC) + c % VEC;
}

// ------------------------------------------------------------ fp32 kernel
namespace f32 {
constexpr int BM = 128, BN = 256, BK = 32, THREADS = 256, STAGES = 4;
constexpr int A_TILE = BM * BK, B_TILE = BK * BN, STAGE = A_TILE + B_TILE;  // floats
constexpr int SMEM = 1024 + STAGES * STAGE * 4;  // 1024-byte alignment slack + the ring
}  // namespace f32

template <bool TMA, typename OutT>
__global__ void __launch_bounds__(f32::THREADS, 1)
matmul_fma_kernel(const __grid_constant__ CUtensorMap map_a, const __grid_constant__ CUtensorMap map_b,
                  const float* __restrict__ A, const float* __restrict__ B, OutT* __restrict__ C, int M,
                  int K, int N, int tiles_m, int tiles_n, bool vec_out) {
  using namespace f32;
  __shared__ __align__(8) uint64_t full[STAGES];  // a stage's tiles have landed
  extern __shared__ uint8_t smem_raw[];
  // Swizzled tiles must start on 1024 bytes.
  float* ring = reinterpret_cast<float*>(smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023));

  const int tid = threadIdx.x;
  if (TMA && tid == 0) {
    for (int i = 0; i < STAGES; ++i) mbar_init(&full[i]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  const Tile t = tile_at<BM, BN>(blockIdx.x, tiles_m, tiles_n);
  const int nk = (K + BK - 1) / BK;
  __syncthreads();

  // Step s's tiles go to ring stage s % STAGES, STAGES - 1 steps ahead.
  int ld_step = 0, ld_slot = 0;
  auto issue = [&]() {
    if (ld_step >= nk) return;
    float* sa = ring + ld_slot * STAGE;
    float* sb = sa + A_TILE;
    const int k0 = ld_step * BK;
    if constexpr (TMA) {
      if (tid == 0) {
        mbar_expect_tx(&full[ld_slot], STAGE * 4);
        tma_load(sa, &map_a, &full[ld_slot], k0, t.row0, t.batch);
        tma_load(sb, &map_b, &full[ld_slot], t.col0, k0, t.batch);
      }
    } else {
      const float* a = A + static_cast<int64_t>(t.batch) * M * K;
      const float* b = B + static_cast<int64_t>(t.batch) * K * N;
      for (int e = tid; e < A_TILE; e += THREADS) {
        const int r = e / BK, c = e % BK, gr = t.row0 + r, gc = k0 + c;
        sa[sw128_offset<4>(r, c)] = (gr < M && gc < K) ? a[static_cast<int64_t>(gr) * K + gc] : 0.f;
      }
      for (int e = tid; e < B_TILE; e += THREADS) {
        const int r = e / BN, c = e % BN, gr = k0 + r, gc = t.col0 + c;
        sb[e] = (gr < K && gc < N) ? b[static_cast<int64_t>(gr) * N + gc] : 0.f;
      }
    }
    ++ld_step;
    if (++ld_slot == STAGES) ld_slot = 0;
  };

  // A warp owns 32 x 128 of the tile. Lane l takes rows a_row + 4i (i =
  // 0..7), whose swizzle (row % 8) is l/8 for even i and (l/8) ^ 4 for odd,
  // and columns b_col + 32q + {0..3} (q = 0..3).
  const int warp = tid / 32, lane = tid % 32;
  const int ty = lane / 8;
  const int a_row = (warp / 2) * 32 + ty;
  const int b_col = (warp % 2) * 128 + (lane % 8) * 4;
  const int ty4 = ty * 4;
  float acc[8][16];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 16; ++j) acc[i][j] = 0.f;

  for (int i = 0; i < STAGES - 1; ++i) issue();
  if (!TMA) __syncthreads();
  int slot = 0, phase = 0;
  for (int s = 0; s < nk; ++s) {
    issue();  // into the stage that step s - 1 has left
    if (TMA) mbar_wait(&full[slot], phase);
    const float* arow = ring + slot * STAGE + a_row * BK;
    const float* sb = ring + slot * STAGE + A_TILE + b_col;
#pragma unroll
    for (int kc = 0; kc < BK / 4; ++kc) {
      // The float4 along k = 4kc .. 4kc + 3 of each of the thread's rows
      // (32 registers), then one B row at a time.
      float a[8][4];
      const int even = (kc * 4) ^ ty4, odd = ((kc ^ 4) * 4) ^ ty4;  // swizzled float offsets
#pragma unroll
      for (int i = 0; i < 8; ++i) ld4(a[i], arow + i * 4 * BK + ((i & 1) ? odd : even));
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        float b[16];
#pragma unroll
        for (int q = 0; q < 4; ++q) ld4(b + 4 * q, sb + (kc * 4 + kk) * BN + 32 * q);
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 16; ++j) acc[i][j] = fmaf(a[i][kk], b[j], acc[i][j]);
      }
    }
    if (TMA) fence_proxy_async();  // this stage is refilled by the TMA later
    __syncthreads();
    if (++slot == STAGES) { slot = 0; phase ^= 1; }
  }

  OutT* c = C + static_cast<int64_t>(t.batch) * M * N;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = t.row0 + a_row + 4 * i;
    if (r >= M) continue;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int col = t.col0 + b_col + 32 * q;
      OutT* dst = c + static_cast<int64_t>(r) * N + col;
      if (vec_out && col + 3 < N) {
        store_vec<OutT, 4>(dst, &acc[i][4 * q]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (col + j < N) dst[j] = from_f32<OutT>(acc[i][4 * q + j]);
      }
    }
  }
}

// ------------------------------------------------------------ bf16 kernel
namespace b16 {
constexpr int BM = 128, BN = 256, BK = 64, STAGES = 4;
constexpr int CONSUMERS = 256, THREADS = CONSUMERS + 128;  // two consumer warpgroups, one producer
constexpr int BOXES = BN / 64;  // B lands as 64-column boxes, one 128-byte swizzle atom wide
constexpr int A_TILE = BM * BK, B_BOX = BK * 64, STAGE = A_TILE + BOXES * B_BOX;  // elements
constexpr int SMEM = 1024 + STAGES * STAGE * 2;
}  // namespace b16

template <bool TMA, typename OutT>
__global__ void __launch_bounds__(b16::THREADS, 1)
matmul_wgmma_kernel(const __grid_constant__ CUtensorMap map_a, const __grid_constant__ CUtensorMap map_b,
                    const __nv_bfloat16* __restrict__ A, const __nv_bfloat16* __restrict__ B,
                    OutT* __restrict__ C, int M, int K, int N, int tiles_m, int tiles_n,
                    bool pairs_out) {
  using namespace b16;
  using T = __nv_bfloat16;
  __shared__ __align__(8) uint64_t full[STAGES];   // a stage's tiles have landed
  __shared__ __align__(8) uint64_t empty[STAGES];  // the 8 consumer warps are done with a stage
  extern __shared__ uint8_t smem_raw[];
  T* ring = reinterpret_cast<T*>(smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023));

  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(&full[i]);
      mbar_init<CONSUMERS / 32>(&empty[i]);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  const Tile t = tile_at<BM, BN>(blockIdx.x, tiles_m, tiles_n);
  const int nk = (K + BK - 1) / BK;
  __syncthreads();

  // Registers move from the producer warpgroup to the consumers' accumulators
  // (2 x 128 x 232 + 128 x 40 <= 64K). Element loads need more in the producer.
  constexpr int PRODUCER_REGS = TMA ? 40 : 56, CONSUMER_REGS = TMA ? 232 : 224;
  if (tid >= CONSUMERS) {
    // Producer: step s into stage s % STAGES once the consumers have left it.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS) : "memory");
    const int p = tid - CONSUMERS;
    if (TMA && p != 0) return;
    int slot = 0, phase = 0;
    for (int s = 0; s < nk; ++s) {
      if (s >= STAGES) mbar_wait(&empty[slot], phase ^ 1);
      T* sa = ring + slot * STAGE;
      T* sb = sa + A_TILE;
      const int k0 = s * BK;
      if constexpr (TMA) {
        // A box that would start past N is not loaded: its columns are never stored.
        const int boxes = min(BOXES, (N - t.col0 + 63) / 64);
        mbar_expect_tx(&full[slot], (A_TILE + boxes * B_BOX) * 2);
        tma_load(sa, &map_a, &full[slot], k0, t.row0, t.batch);
        for (int j = 0; j < boxes; ++j)
          tma_load(sb + j * B_BOX, &map_b, &full[slot], t.col0 + 64 * j, k0, t.batch);
      } else {
        const T* a = A + static_cast<int64_t>(t.batch) * M * K;
        const T* b = B + static_cast<int64_t>(t.batch) * K * N;
        const T zero = from_f32<T>(0.f);
        for (int e = p; e < A_TILE; e += THREADS - CONSUMERS) {
          const int r = e / BK, c = e % BK, gr = t.row0 + r, gc = k0 + c;
          sa[sw128_offset<8>(r, c)] = (gr < M && gc < K) ? a[static_cast<int64_t>(gr) * K + gc] : zero;
        }
        for (int e = p; e < BOXES * B_BOX; e += THREADS - CONSUMERS) {
          const int r = e / BN, c = e % BN, gr = k0 + r, gc = t.col0 + c;
          sb[(c / 64) * B_BOX + sw128_offset<8>(r, c % 64)] =
              (gr < K && gc < N) ? b[static_cast<int64_t>(gr) * N + gc] : zero;
        }
        fence_proxy_async();  // visible to the wgmma reads
        asm volatile("bar.sync 1, %0;\n" ::"n"(THREADS - CONSUMERS) : "memory");
        if (p == 0) mbar_arrive(&full[slot]);
      }
      if (++slot == STAGES) { slot = 0; phase ^= 1; }
    }
    return;
  }

  // Consumers: warpgroup wg owns rows wg * 64 .. + 63 of the tile.
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS) : "memory");
  const int wg = tid / 128, warp = (tid / 32) % 4, lane = tid % 32;
  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  int slot = 0, phase = 0, prev = 0;
  for (int s = 0; s < nk; ++s) {
    mbar_wait(&full[slot], phase);
    const uint32_t a_addr = smem_u32(ring + slot * STAGE + wg * 64 * BK);
    const uint32_t b_addr = smem_u32(ring + slot * STAGE + A_TILE);
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      // A advances 16 elements (32 bytes) along its rows; B 16 rows (2048
      // bytes), its 64-column boxes B_BOX elements apart.
      wgmma_64x256x16(acc, sw128_desc(a_addr + kk * 32), sw128_desc(b_addr + kk * 2048, B_BOX * 2, 1024),
                      (s > 0 || kk > 0) ? 1 : 0);
    }
    wgmma_commit();
    wgmma_wait<1>();  // step s - 1's group has completed: release its stage
    fence_regs(acc);
    if (s > 0 && lane == 0) mbar_arrive(&empty[prev]);
    prev = slot;
    if (++slot == STAGES) { slot = 0; phase ^= 1; }
  }
  wgmma_wait<0>();
  fence_regs(acc);

  // Store, rounded once to OutT. wgmma's accumulator layout: register
  // 4i + 2h + j of lane l in warp w is row 16w + l/4 + 8h, column
  // 8i + 2(l%4) + j of the warpgroup's 64 x BN. A pair is one store of 4
  // (bf16) or 8 (fp32) bytes.
  OutT* c = C + static_cast<int64_t>(t.batch) * M * N;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = t.row0 + wg * 64 + warp * 16 + lane / 4 + 8 * h;
    if (r >= M) continue;
#pragma unroll
    for (int i = 0; i < BN / 8; ++i) {
      const int col = t.col0 + 8 * i + 2 * (lane % 4);
      OutT* dst = c + static_cast<int64_t>(r) * N + col;
      const float v[2] = {acc[4 * i + 2 * h], acc[4 * i + 2 * h + 1]};
      if (pairs_out && col + 1 < N) {
        store_vec<OutT, 2>(dst, v);
      } else {
        if (col < N) dst[0] = from_f32<OutT>(v[0]);
        if (col + 1 < N) dst[1] = from_f32<OutT>(v[1]);
      }
    }
  }
}

// ------------------------------------------------------------------- host
template <typename T, typename OutT, typename Kernel>
cudaError_t launch(Kernel kernel, int bm, int bn, int threads, int smem, const CUtensorMap& map_a,
                   const CUtensorMap& map_b, const void* a, const void* b, void* c, int64_t mb, int64_t m,
                   int64_t k, int64_t n, bool vec_out, cudaStream_t stream) {
  const int64_t tiles_m = (m + bm - 1) / bm, tiles_n = (n + bn - 1) / bn;
  const int64_t blocks = tiles_m * tiles_n * mb;
  if (blocks > INT32_MAX) return cudaErrorInvalidValue;
  if (blocks == 0) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  kernel<<<static_cast<unsigned>(blocks), threads, smem, stream>>>(
      map_a, map_b, static_cast<const T*>(a), static_cast<const T*>(b), static_cast<OutT*>(c),
      static_cast<int>(m), static_cast<int>(k), static_cast<int>(n), static_cast<int>(tiles_m),
      static_cast<int>(tiles_n), vec_out);
  return cudaGetLastError();
}

// The TMA addresses rows of whole 16-byte chunks from 16-byte-aligned bases.
bool tma_ok(const void* a, const void* b, int64_t k, int64_t n, int vec) {
  return aligned16(a) && aligned16(b) && k > 0 && k % vec == 0 && n % vec == 0;
}

// c is aligned to n_vec stores of OutT when its base and its rows are.
template <typename OutT>
bool vec_aligned(const void* c, int64_t n, int n_vec) {
  return reinterpret_cast<uintptr_t>(c) % (n_vec * sizeof(OutT)) == 0 && n % n_vec == 0;
}

template <typename OutT>
cudaError_t launch_f32(const void* a, const void* b, void* c, int64_t mb, int64_t m, int64_t k, int64_t n,
                       cudaStream_t stream) {
  using namespace f32;
  CUtensorMap map_a = {}, map_b = {};
  const bool tma = tma_ok(a, b, k, n, 4);
  if (tma && (!make_map<float>(&map_a, a, mb, m, k, BM, BK, true) ||
              !make_map<float>(&map_b, b, mb, k, n, BK, BN, false))) {
    return cudaErrorInvalidValue;
  }
  return launch<float, OutT>(tma ? matmul_fma_kernel<true, OutT> : matmul_fma_kernel<false, OutT>, BM, BN,
                             THREADS, SMEM, map_a, map_b, a, b, c, mb, m, k, n, vec_aligned<OutT>(c, n, 4),
                             stream);
}

template <typename OutT>
cudaError_t launch_bf16(const void* a, const void* b, void* c, int64_t mb, int64_t m, int64_t k, int64_t n,
                        cudaStream_t stream) {
  using namespace b16;
  CUtensorMap map_a = {}, map_b = {};
  const bool tma = tma_ok(a, b, k, n, 8);
  if (tma && (!make_map<__nv_bfloat16>(&map_a, a, mb, m, k, BM, BK) ||
              !make_map<__nv_bfloat16>(&map_b, b, mb, k, n, BK, 64))) {
    return cudaErrorInvalidValue;
  }
  return launch<__nv_bfloat16, OutT>(tma ? matmul_wgmma_kernel<true, OutT> : matmul_wgmma_kernel<false, OutT>,
                                     BM, BN, THREADS, SMEM, map_a, map_b, a, b, c, mb, m, k, n,
                                     vec_aligned<OutT>(c, n, 2), stream);
}

}  // namespace
}  // namespace repro

// a, b of type dtype; c of type out_dtype (fp32 or bf16, either way).
extern "C" int repro_batched_matmul(const void* a, const void* b, void* c, int dtype, int out_dtype,
                                    int64_t mb, int64_t m, int64_t k, int64_t n, void* stream) {
  using namespace repro;
  if (mb < 1 || m > INT32_MAX || k > INT32_MAX || n > INT32_MAX) return cudaErrorInvalidValue;
  if (out_dtype != kF32 && out_dtype != kBF16) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool f32_out = out_dtype == kF32;
  cudaError_t err;
  if (dtype == kF32) {
    err = f32_out ? launch_f32<float>(a, b, c, mb, m, k, n, s)
                  : launch_f32<__nv_bfloat16>(a, b, c, mb, m, k, n, s);
  } else if (dtype == kBF16) {
    err = f32_out ? launch_bf16<float>(a, b, c, mb, m, k, n, s)
                  : launch_bf16<__nv_bfloat16>(a, b, c, mb, m, k, n, s);
  } else {
    return cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}
