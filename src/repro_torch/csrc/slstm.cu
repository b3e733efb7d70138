// The sLSTM recurrence over a whole sequence, state resident in fp32:
// for t = 0 .. S-1, with h_{-1} = h0 and gates g = z, i, f, o,
//   pre[b,g,h,e] = wx[b,t,g,h,e] + sum_d h_{t-1}[b,h,d] * r[g,h,d,e]
//   z = tanh(pre_z), log_f = log_sigmoid(pre_f), o = sigmoid(pre_o)
//   m' = max(log_f + m, pre_i), i = exp(pre_i - m'), f = exp(log_f + m - m')
//   c' = f c + i z, n' = f n + i, h_t = o c' / max(n', 1), hs[b,t] = h_t.
//
// Replaces slstm_seq_pallas (src/repro/kernels/slstm/slstm.py:81), whose grid
// walks the time axis in order on one TPU core and keeps (c, n, m, h) in VMEM
// scratch for the whole sequence.
//
// What bounds it: 2 * 4 * dh^2 flops per (batch row, head, step) against r's
// 16 MB (fp32, 4 heads of 512 at full width). Over a prefill of S steps at
// batch 1 the fp32 rate bounds the work (0.125 us a step); a single decode
// step is bound by reading r once from device memory. But a recurrence is
// sequential: step t of head h needs all of h_{t-1} of head h, so its real
// floor is S times one exchange of h between the SMs that share a head.
//
// Design: one cooperative launch a call, one block an SM, persistent over
// the whole sequence. The output columns of a head are cut into tiles of
// COLS columns (all four gates); tiles are numbered head by head and each
// block owns a run of `tiles_per_block` consecutive tiles (one, at xlstm's
// 4 heads of 512 on 132 SMs: 128 blocks of 16 columns). Prologue: a block
// copies the r slices of its first `resident` tiles, [4][dh][COLS] each
// (128 KB at dh 512), into shared memory with cp.async, once; the tiles
// past those are read from device memory (L2) every step. A single step (a
// decode step) reads r once, so the wrapper's plan makes none resident
// then. A pass over a tile takes ROWS batch rows: one at B = 1 (a
// prefill), BT otherwise (the one-row kernel is a quarter of the code and
// ran faster a step than the BT-row one: rows_4 in tools/slstm_variants.py).
// Each step t, for each tile and pass:
//   1. the tile's gate threads prefetch wx[:, t] and their c, n, m (in
//      device memory, each element owned by one thread for the whole
//      launch; read from the initial state at t = 0) before waiting;
//   2. the block waits until every block of the head has published
//      h_{t-1}: thread 0 spins with acquire loads on the head's counter;
//   3. it stages h_{t-1} of the pass's rows in shared memory, read
//      through L2 (ld.global.cg: the read-only path could serve a line
//      written earlier in this launch, stale);
//   4. 256 threads form the 4 x COLS x ROWS dot products of length dh on the
//      FMA units (fp32; TF32 tensor cores would change the result), each
//      thread four adjacent columns (float4 reads of r) and an interleaved
//      64th of the length, joined in a fixed order (a shuffle tree in each
//      warp, then the 8 warps in order);
//   5. the gate threads apply the gates and write c, n, m and h_t;
//   6. after the head's last tile, __syncthreads, then thread 0 adds one to
//      the head's counter with release semantics (red.release.gpu).
// Heads never wait on each other: the counters are per head, one int32
// each, zeroed by the wrapper for each call. A block's run of tiles may span
// two heads; every block walks (step, tile) in the same order, so each wait
// is on work that every block reaches first. A wait longer than two seconds
// traps instead of hanging.
//
// Numerics: fp32 throughout, precise expf/tanhf/log1pf (no fast math); the
// log-sigmoid is the stable min(x, 0) - log1p(exp(-|x|)). With m = -1e30 at
// the first step, log_f + m - m' underflows exp to 0 and f = 0, never NaN.
#include "slstm.cuh"

namespace repro {
namespace {

// The 4 x COLS x ROWS dot products of one tile, reduced within each warp
// into red[warp][bb][g][col]. A thread owns four adjacent columns (cg) and
// an interleaved SLICES-th of the length. RES: r's slice lies in shared
// memory as [4][dh][COLS], read as float4, one row of the length at a time
// (more in flight measured slower, tools/slstm_variants.py); else it is
// read from device memory at columns e0 + 4 cg .. + 3 (a float4 where `vec`
// and the four lie below dh, else masked elements), four rows in flight.
template <int ROWS, bool RES>
__device__ __forceinline__ void tile_dots(const float* rs, const float* __restrict__ r, const float* sh_h,
                                          float* red, int nb, int heads, int head, int dh, int e0, bool vec) {
  const int tid = threadIdx.x;
  const int cg = tid % CGROUPS;
  const int slice = tid / CGROUPS;
  float acc[ROWS][4][4];  // [row][gate][column]
#pragma unroll
  for (int bb = 0; bb < ROWS; ++bb)
#pragma unroll
    for (int g = 0; g < 4; ++g)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[bb][g][j] = 0.f;
  const int64_t gstride = static_cast<int64_t>(heads) * dh * dh;
  const float* rg = r + static_cast<int64_t>(head) * dh * dh + e0 + 4 * cg;
  const bool full = vec && e0 + 4 * cg + 3 < dh;
  auto row = [&](int d) {
    float rv[4][4];
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      if constexpr (RES) {
        ld4(rv[g], rs + (g * dh + d) * COLS + 4 * cg);
      } else {
        const float* p = rg + g * gstride + static_cast<int64_t>(d) * dh;
        if (full) {
          const float4 q = __ldg(reinterpret_cast<const float4*>(p));
          rv[g][0] = q.x; rv[g][1] = q.y; rv[g][2] = q.z; rv[g][3] = q.w;
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j) rv[g][j] = e0 + 4 * cg + j < dh ? __ldg(p + j) : 0.f;
        }
      }
    }
#pragma unroll
    for (int bb = 0; bb < ROWS; ++bb) {
      if (bb < nb) {
        const float hv = sh_h[bb * dh + d];
#pragma unroll
        for (int g = 0; g < 4; ++g)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[bb][g][j] = fmaf(hv, rv[g][j], acc[bb][g][j]);
      }
    }
  };
  if constexpr (RES) {
#pragma unroll 1
    for (int d = slice; d < dh; d += SLICES) row(d);
  } else {
#pragma unroll 4
    for (int d = slice; d < dh; d += SLICES) row(d);
  }
  // The 8 lanes of a column group in a warp (lane bits 2-4) hold its 8
  // slices of the group's 16 sums (4 gates x 4 columns). Three halving
  // steps, each sending half of what a lane holds, leave each lane 2 of the
  // 16 summed over the 8 lanes: sum s = 8 b4 + 4 b3 + 2 b2 + i.
  const int warp = tid / 32, lane = tid % 32;
  const int b4 = (lane >> 4) & 1, b3 = (lane >> 3) & 1, b2 = (lane >> 2) & 1;
#pragma unroll
  for (int bb = 0; bb < ROWS; ++bb) {
    if (bb >= nb) break;
    float v[16];
#pragma unroll
    for (int s = 0; s < 16; ++s) v[s] = acc[bb][s / 4][s % 4];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float recv = __shfl_xor_sync(0xffffffffu, b4 ? v[i] : v[i + 8], 16);
      v[i] = (b4 ? v[i + 8] : v[i]) + recv;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float recv = __shfl_xor_sync(0xffffffffu, b3 ? v[i] : v[i + 4], 8);
      v[i] = (b3 ? v[i + 4] : v[i]) + recv;
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float recv = __shfl_xor_sync(0xffffffffu, b2 ? v[i] : v[i + 2], 4);
      v[i] = (b2 ? v[i + 2] : v[i]) + recv;
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int s = 8 * b4 + 4 * b3 + 2 * b2 + i;  // gate s / 4, column 4 cg + s % 4
      red[((warp * BT + bb) * 4 + s / 4) * COLS + 4 * cg + s % 4] = v[i];
    }
  }
}

// SAVE (training): each step also writes what the backward reads, the gate
// pre-activations pre (B, S, 4, H, dh) and the state after the step, c_all,
// n_all, m_all (B, S, H, dh); hs holds h. Without it (serving) the pointers
// are null and never touched.
template <int ROWS, bool SAVE>
__global__ void __launch_bounds__(THREADS, 1)
slstm_seq_kernel(const float* __restrict__ wx, const float* __restrict__ r, const float* h0,
                 const float* __restrict__ c0, const float* __restrict__ n0, const float* __restrict__ m0,
                 float* c, float* n, float* m, float* hs, float* pre_all, float* c_all, float* n_all,
                 float* m_all, int* counters, int batch, int steps, int heads, int dh,
                 int tiles_per_block, int resident, bool vec) {
  extern __shared__ __align__(16) float smem[];
  const int tile_floats = 4 * dh * COLS;
  float* rs = smem;                                    // [resident][4][dh][COLS]
  float* sh_h = smem + resident * tile_floats;         // [BT][dh]
  float* red = sh_h + BT * dh;                         // [WARPS][BT][4][COLS]
  const int tid = threadIdx.x;
  const int per_head = (dh + COLS - 1) / COLS;
  const int u_begin = blockIdx.x * tiles_per_block;
  const int u_end = min(u_begin + tiles_per_block, heads * per_head);

  // Prologue: the resident tiles' slices of r, zero past dh.
  for (int k = 0; k < resident && u_begin + k < u_end; ++k) {
    const int head = (u_begin + k) / per_head, e0 = ((u_begin + k) % per_head) * COLS;
    float* dst = rs + k * tile_floats;
    const float* src = r + static_cast<int64_t>(head) * dh * dh + e0;
    const int64_t gstride = static_cast<int64_t>(heads) * dh * dh;
    if (vec) {  // rows of COLS floats as 16-byte chunks
      for (int i = tid; i < 4 * dh * (COLS / 4); i += THREADS) {
        const int row = i / (COLS / 4), ch = i % (COLS / 4);
        const int g = row / dh, d = row % dh;
        const bool live = e0 + 4 * ch < dh;
        const float* p = live ? src + g * gstride + static_cast<int64_t>(d) * dh + 4 * ch : r;
        cp_async16(dst + row * COLS + 4 * ch, p, !live);
      }
    } else {
      for (int i = tid; i < tile_floats; i += THREADS) {
        const int row = i / COLS, cc = i % COLS;
        const int g = row / dh, d = row % dh;
        dst[i] = e0 + cc < dh ? src[g * gstride + static_cast<int64_t>(d) * dh + cc] : 0.f;
      }
    }
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  const int64_t wx_row = static_cast<int64_t>(steps) * 4 * heads * dh;  // batch strides
  const int64_t hs_row = static_cast<int64_t>(steps) * heads * dh;
  const bool gate = tid < ROWS * COLS;
  const int gb = tid / COLS, gc = tid % COLS;

  for (int t = 0; t < steps; ++t) {
    for (int u = u_begin; u < u_end; ++u) {
      const int head = u / per_head, e0 = (u % per_head) * COLS;
      const int k = u - u_begin;
      const bool first_of_head = u == u_begin || (u - 1) / per_head != head;
      const bool last_of_head = u + 1 == u_end || (u + 1) / per_head != head;
      const int e = e0 + gc;
      for (int b0 = 0; b0 < batch; b0 += ROWS) {
        const int nb = min(ROWS, batch - b0);
        // 1. this tile's gate inputs, ahead of the wait
        const bool live = gate && gb < nb && e < dh;
        const int64_t row = b0 + gb;
        const int64_t sidx = (row * heads + head) * dh + e;
        float wxv[4] = {0.f, 0.f, 0.f, 0.f}, cs = 0.f, ns = 0.f, ms = 0.f;
        if (live) {
          const float* wp = wx + row * wx_row + static_cast<int64_t>(t) * 4 * heads * dh +
                            static_cast<int64_t>(head) * dh + e;
#pragma unroll
          for (int g = 0; g < 4; ++g) wxv[g] = __ldg(wp + static_cast<int64_t>(g) * heads * dh);
          cs = t == 0 ? c0[sidx] : c[sidx];
          ns = t == 0 ? n0[sidx] : n[sidx];
          ms = t == 0 ? m0[sidx] : m[sidx];
        }
        // 2. every block of the head has published h_{t-1}
        if (t > 0 && b0 == 0 && first_of_head) {
          const int first = head * per_head / tiles_per_block;
          const int last = ((head + 1) * per_head - 1) / tiles_per_block;
          wait_count(counters + head, (last - first + 1) * t);
        }
        // 3. h_{t-1} of rows b0 .. b0 + nb - 1, through L2
        for (int bb = 0; bb < nb; ++bb) {
          const float* hp = t == 0 ? h0 + ((b0 + bb) * static_cast<int64_t>(heads) + head) * dh
                                   : hs + (b0 + bb) * hs_row + (static_cast<int64_t>(t - 1) * heads + head) * dh;
          if (vec) {
            for (int i = tid; i < dh / 4; i += THREADS)
              reinterpret_cast<float4*>(sh_h + bb * dh)[i] = __ldcg(reinterpret_cast<const float4*>(hp) + i);
          } else {
            for (int i = tid; i < dh; i += THREADS) sh_h[bb * dh + i] = __ldcg(hp + i);
          }
        }
        __syncthreads();
        // 4. the dot products
        if (k < resident) {
          tile_dots<ROWS, true>(rs + k * tile_floats, r, sh_h, red, nb, heads, head, dh, e0, vec);
        } else {
          tile_dots<ROWS, false>(rs, r, sh_h, red, nb, heads, head, dh, e0, vec);
        }
        __syncthreads();
        // 5. the gates
        if (live) {
          float pre[4];
#pragma unroll
          for (int g = 0; g < 4; ++g) {
            float rec = 0.f;
#pragma unroll
            for (int w = 0; w < WARPS; ++w) rec += red[((w * BT + gb) * 4 + g) * COLS + gc];
            pre[g] = wxv[g] + rec;
          }
          const float z = tanhf(pre[0]);
          const float i_pre = pre[1];
          const float log_f = log_sigmoid(pre[2]);
          const float o = 1.f / (1.f + expf(-pre[3]));
          const float m_new = fmaxf(log_f + ms, i_pre);
          const float i_g = expf(i_pre - m_new);
          const float f_g = expf(log_f + ms - m_new);
          const float c_new = f_g * cs + i_g * z;
          const float n_new = f_g * ns + i_g;
          c[sidx] = c_new;
          n[sidx] = n_new;
          m[sidx] = m_new;
          const int64_t tidx = row * hs_row + (static_cast<int64_t>(t) * heads + head) * dh + e;
          hs[tidx] = o * c_new / fmaxf(n_new, 1.f);
          if constexpr (SAVE) {
            float* pp = pre_all + row * wx_row + static_cast<int64_t>(t) * 4 * heads * dh +
                        static_cast<int64_t>(head) * dh + e;
#pragma unroll
            for (int g = 0; g < 4; ++g) pp[static_cast<int64_t>(g) * heads * dh] = pre[g];
            c_all[tidx] = c_new;
            n_all[tidx] = n_new;
            m_all[tidx] = m_new;
          }
        }
        __syncthreads();  // sh_h and red are refilled next; h_t is written
      }
      // 6. publish this block's part of h_t for the head: the bar.sync above
      // orders the block's writes of h_t before thread 0's release add
      // (CUTLASS's GenericBarrier arrives the same way); a __threadfence
      // before it measured 0.34 us a step (tools/slstm_variants.py).
      if (last_of_head && tid == 0) add_release(counters + head);
    }
  }
}

}  // namespace
}  // namespace repro

// The shared memory a block of the kernel needs for `resident` tiles of r.
static int64_t slstm_smem_bytes(int64_t dh, int64_t resident) {
  using namespace repro;
  return (resident * 4 * dh * COLS + BT * dh + RED_FLOATS) * static_cast<int64_t>(sizeof(float));
}

// The device's SM count and the shared memory a block may opt in to: the two
// numbers the wrapper's launch plan is made from.
extern "C" int repro_device_limits(int device, int* sms, int* smem_per_block) {
  cudaError_t err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  return cudaDeviceGetAttribute(smem_per_block, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
}

// wx (B, S, 4, H, dh), r (4, H, dh, dh), and the state at t = 0, h0, c0,
// n0, m0 (B, H, dh): read only. c, n, m (B, H, dh): written, the state after
// step S - 1. hs (B, S, H, dh): written, hs[:, S-1] is the final h. pre
// (B, S, 4, H, dh) and c_all, n_all, m_all (B, S, H, dh): null (serving), or
// all four written, every step's gate pre-activations and state (training).
// All fp32, contiguous. counters: H int32, zero. The plan (blocks,
// tiles_per_block, resident) comes from the wrapper; one cooperative launch
// runs all S steps, and a grid that cannot be co-resident is refused, not run.
extern "C" int repro_slstm_seq(const void* wx, const void* r, const void* h0, const void* c0,
                               const void* n0, const void* m0, void* c, void* n, void* m, void* hs,
                               void* pre, void* c_all, void* n_all, void* m_all,
                               void* counters, int64_t b, int64_t s, int64_t h, int64_t dh, int64_t blocks,
                               int64_t tiles_per_block, int64_t resident, void* stream) {
  using namespace repro;
  const int64_t units = h * ((dh + COLS - 1) / COLS);
  if (b < 1 || s < 1 || h < 1 || dh < 1 || b > INT32_MAX || s > INT32_MAX || units > INT32_MAX ||
      blocks < 1 || tiles_per_block < 1 || resident < 0 || resident > tiles_per_block ||
      (blocks - 1) * tiles_per_block >= units || blocks * tiles_per_block < units ||
      blocks * s > INT32_MAX) {  // a head's counter reaches its blocks x S
    return cudaErrorInvalidValue;
  }
  const bool save = pre != nullptr;
  if (save != (c_all != nullptr) || save != (n_all != nullptr) || save != (m_all != nullptr)) {
    return cudaErrorInvalidValue;
  }
  const int64_t smem = slstm_smem_bytes(dh, resident);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  // One row a pass at B = 1 (a prefill's shape), BT otherwise: the B = 1
  // kernel's loop is a quarter of the code.
  const void* kernel =
      save ? (b == 1 ? reinterpret_cast<const void*>(slstm_seq_kernel<1, true>)
                     : reinterpret_cast<const void*>(slstm_seq_kernel<BT, true>))
           : (b == 1 ? reinterpret_cast<const void*>(slstm_seq_kernel<1, false>)
                     : reinterpret_cast<const void*>(slstm_seq_kernel<BT, false>));
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const bool vec = dh % 4 == 0 && aligned16(r) && aligned16(h0) && aligned16(hs);
  const float* wxp = static_cast<const float*>(wx);
  const float* rp = static_cast<const float*>(r);
  const float* h0p = static_cast<const float*>(h0);
  const float *c0p = static_cast<const float*>(c0), *n0p = static_cast<const float*>(n0),
              *m0p = static_cast<const float*>(m0);
  float *cp = static_cast<float*>(c), *np = static_cast<float*>(n), *mp = static_cast<float*>(m);
  float* hsp = static_cast<float*>(hs);
  float *prep = static_cast<float*>(pre), *cap = static_cast<float*>(c_all), *nap = static_cast<float*>(n_all),
        *map = static_cast<float*>(m_all);
  int* ctr = static_cast<int*>(counters);
  int bi = static_cast<int>(b), si = static_cast<int>(s), hi = static_cast<int>(h), di = static_cast<int>(dh);
  int tpb = static_cast<int>(tiles_per_block), res = static_cast<int>(resident);
  void* args[] = {&wxp, &rp, &h0p, &c0p, &n0p, &m0p, &cp, &np, &mp, &hsp, &prep, &cap, &nap, &map, &ctr,
                  &bi, &si, &hi, &di, &tpb, &res, const_cast<bool*>(&vec)};
  err = cudaLaunchCooperativeKernel(kernel, dim3(static_cast<unsigned>(blocks)), dim3(THREADS), args,
                                    static_cast<size_t>(smem), static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}
