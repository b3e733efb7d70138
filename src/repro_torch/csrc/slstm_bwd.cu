// The sLSTM backward: the reverse-time recurrence of slstm.cu's sequence
// kernel (the VJP of the scan of _slstm_step, src/repro/models/xlstm.py:248,
// which the JAX package forms in XLA; no Pallas kernel computes it). For
// t = S-1 .. 0, with dh_t the gradient of h_t (dhs[:, t] plus the recurrent
// term below, plus the final state's dh at t = S-1) and dc, dn, dm carried
// from step t+1 (the final state's at t = S-1):
//   dpre_t = the VJP of the step's gates at each element (step_vjp), which
//            is dwx[:, t]; it also gives dc, dn, dm of the state before;
//   dh_{t-1}[b,h,d] = sum_{g,e} dpre_t[b,g,h,e] r[g,h,d,e],
// and at t = -1 that sum is the initial state's dh.
//
// What bounds it: the forward's work, 2 * 4 * dh^2 flops per (batch row,
// head, step), and the forward's floor: step t of head h needs all of
// dpre_{t+1} of head h, so S exchanges between the SMs that share a head.
//
// Design, the forward's mirror: one cooperative launch, one block an SM,
// persistent over the sequence, fp32 FMA sums in a fixed order (a rerun gives
// the same bits), per-head release/acquire counters and a trap instead of a
// hang. A tile is now COLS columns of r's d index: its dot products are the
// forward's with the gate index summed, so the wrapper hands the kernel r
// transposed in its last two indices (rt[g,h,e,d] = r[g,h,d,e]) and a tile's
// slice, [4][dh][COLS], lies and is copied as the forward's does. A pass
// stages dpre_{t+1} of its rows, [ROWS][4][dh], through L2 (what blocks
// exchange, where the forward exchanges h_{t-1}).
//
// Numerics: the forward's gates are recomputed from the saved pre-activations
// with the same functions; the saved m' gives i and f bit for bit. Ties take
// PyTorch's rules: at max(n', 1) the gradient passes when n' >= 1 (clamp_min),
// at max(log_f + m, pre_i) it is split in halves (maximum). From a zero state
// the first step gives n' = 1 and m' = pre_i exactly, so it sits on the first
// tie; i = exp(pre_i - m') = 1 there, and its two terms in pre_i's gradient
// cancel in the order written out in step_vjp, as in the plain version.
#include "slstm.cuh"

namespace repro {
namespace {

// The VJP of one step at one element. p: the gate pre-activations (z, i,
// f, o); c, n, m: the state before the step; c1, n1, m1: after it. dh: the
// gradient of h_t; dc, dn, dm: in, the gradients of c1, n1, m1; out, those of
// c, n, m. dp: out, the gradients of p. kernels/slstm/ref.py:step_vjp is the
// same arithmetic in PyTorch.
__device__ __forceinline__ void step_vjp(const float p[4], float c, float n, float m, float c1, float n1,
                                         float m1, float dh, float& dc, float& dn, float& dm, float dp[4]) {
  const float z = tanhf(p[0]);
  const float lf = log_sigmoid(p[2]);
  const float o = 1.f / (1.f + expf(-p[3]));
  const float a = lf + m;
  const float ig = expf(p[1] - m1);
  const float fg = expf(a - m1);
  const float nn = fmaxf(n1, 1.f);
  const float h = o * c1 / nn;
  const float dq = dh / nn;  // of o * c1
  const float d_o = dq * c1;
  const float dc1 = dc + dq * o;
  const float dn1 = dn + (n1 >= 1.f ? -dq * h : 0.f);
  const float df = dc1 * c + dn1 * n;
  const float di = dc1 * z + dn1;
  const float dz = dc1 * ig;
  const float ga = df * fg;  // of a - m1
  const float gi = di * ig;  // of p_i - m1
  const float dmt = dm - ga - gi;  // of m1
  float dlf = ga, dmp = ga, dpi = gi;
  if (a > p[1]) {
    dlf += dmt;
    dmp += dmt;
  } else if (a < p[1]) {
    dpi += dmt;
  } else {
    const float half = 0.5f * dmt;
    dlf += half;
    dmp += half;
    dpi += half;
  }
  dp[0] = dz * (1.f - z * z);
  dp[1] = dpi;
  dp[2] = dlf / (1.f + expf(p[2]));  // log_sigmoid' = sigmoid(-x)
  dp[3] = d_o * o * (1.f - o);
  dc = dc1 * fg;
  dn = dn1 * fg;
  dm = dmp;
}

// The backward's dot products of one tile: for each of its COLS columns d and
// pass row bb, sum_{g,e} dp[bb][g][e] * rt[g][e][d], reduced within each warp
// into red[warp][bb][col]. The thread layout and r's reads are tile_dots'
// (four adjacent columns a thread, an interleaved SLICES-th of the length,
// float4 reads); each thread keeps the four gates apart and adds them in
// order before the warp's shuffle tree.
template <int ROWS, bool RES>
__device__ __forceinline__ void tile_dots_bwd(const float* rs, const float* __restrict__ rt, const float* sh_dp,
                                              float* red, int nb, int heads, int head, int dh, int d0, bool vec) {
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
  const float* rg = rt + static_cast<int64_t>(head) * dh * dh + d0 + 4 * cg;
  const bool full = vec && d0 + 4 * cg + 3 < dh;
  auto row = [&](int e) {
    float rv[4][4];
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      if constexpr (RES) {
        ld4(rv[g], rs + (g * dh + e) * COLS + 4 * cg);
      } else {
        const float* p = rg + g * gstride + static_cast<int64_t>(e) * dh;
        if (full) {
          const float4 q = __ldg(reinterpret_cast<const float4*>(p));
          rv[g][0] = q.x; rv[g][1] = q.y; rv[g][2] = q.z; rv[g][3] = q.w;
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j) rv[g][j] = d0 + 4 * cg + j < dh ? __ldg(p + j) : 0.f;
        }
      }
    }
#pragma unroll
    for (int bb = 0; bb < ROWS; ++bb) {
      if (bb < nb) {
#pragma unroll
        for (int g = 0; g < 4; ++g) {
          const float dv = sh_dp[(bb * 4 + g) * dh + e];
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[bb][g][j] = fmaf(dv, rv[g][j], acc[bb][g][j]);
        }
      }
    }
  };
  if constexpr (RES) {
#pragma unroll 1
    for (int e = slice; e < dh; e += SLICES) row(e);
  } else {
#pragma unroll 4
    for (int e = slice; e < dh; e += SLICES) row(e);
  }
  // The 8 lanes of a column group in a warp (lane bits 2-4) hold its 8
  // slices of the group's 4 column sums: two halving steps leave each lane
  // one of them summed over 4 lanes (column 2 b4 + b3), the third adds the
  // other 4 lanes' and the lanes with b2 = 0 write it.
  const int warp = tid / 32, lane = tid % 32;
  const int b4 = (lane >> 4) & 1, b3 = (lane >> 3) & 1, b2 = (lane >> 2) & 1;
#pragma unroll
  for (int bb = 0; bb < ROWS; ++bb) {
    if (bb >= nb) break;
    float v[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) v[j] = ((acc[bb][0][j] + acc[bb][1][j]) + acc[bb][2][j]) + acc[bb][3][j];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float recv = __shfl_xor_sync(0xffffffffu, b4 ? v[i] : v[i + 2], 16);
      v[i] = (b4 ? v[i + 2] : v[i]) + recv;
    }
    {
      const float recv = __shfl_xor_sync(0xffffffffu, b3 ? v[0] : v[1], 8);
      v[0] = (b3 ? v[1] : v[0]) + recv;
    }
    v[0] += __shfl_xor_sync(0xffffffffu, v[0], 4);
    if (!b2) red[(warp * BT + bb) * COLS + 4 * cg + 2 * b4 + b3] = v[0];
  }
}

// rt (4, H, dh, dh): r transposed in its last two indices. pre (B, S, 4, H,
// dh), cs, ns, ms (B, S, H, dh): the saving forward's. c0, n0, m0 (B, H, dh):
// the initial state. dhs (B, S, H, dh), dh_fin, dc_fin, dn_fin, dm_fin (B, H,
// dh): the gradients of hs and of the final state. Written: dwx (B, S, 4, H,
// dh), dh0 (B, H, dh), and dc, dn, dm (B, H, dh), which carry the state's
// gradient from step to step and end as the initial state's.
template <int ROWS>
__global__ void __launch_bounds__(THREADS, 1)
slstm_seq_bwd_kernel(const float* __restrict__ rt, const float* __restrict__ pre, const float* __restrict__ cs,
                     const float* __restrict__ ns, const float* __restrict__ ms, const float* __restrict__ c0,
                     const float* __restrict__ n0, const float* __restrict__ m0, const float* __restrict__ dhs,
                     const float* __restrict__ dh_fin, const float* __restrict__ dc_fin,
                     const float* __restrict__ dn_fin, const float* __restrict__ dm_fin, float* dwx, float* dh0,
                     float* dc, float* dn, float* dm, int* counters, int batch, int steps, int heads, int dh,
                     int tiles_per_block, int resident, bool vec) {
  extern __shared__ __align__(16) float smem[];
  const int tile_floats = 4 * dh * COLS;
  float* rs = smem;                                    // [resident][4][dh][COLS]
  float* sh_dp = smem + resident * tile_floats;        // [BT][4][dh]
  float* red = sh_dp + BT * 4 * dh;                    // [WARPS][BT][COLS]
  const int tid = threadIdx.x;
  const int per_head = (dh + COLS - 1) / COLS;
  const int u_begin = blockIdx.x * tiles_per_block;
  const int u_end = min(u_begin + tiles_per_block, heads * per_head);

  // Prologue: the resident tiles' slices of rt, zero past dh (the forward's).
  for (int k = 0; k < resident && u_begin + k < u_end; ++k) {
    const int head = (u_begin + k) / per_head, d0 = ((u_begin + k) % per_head) * COLS;
    float* dst = rs + k * tile_floats;
    const float* src = rt + static_cast<int64_t>(head) * dh * dh + d0;
    const int64_t gstride = static_cast<int64_t>(heads) * dh * dh;
    if (vec) {
      for (int i = tid; i < 4 * dh * (COLS / 4); i += THREADS) {
        const int row = i / (COLS / 4), ch = i % (COLS / 4);
        const int g = row / dh, e = row % dh;
        const bool live = d0 + 4 * ch < dh;
        const float* p = live ? src + g * gstride + static_cast<int64_t>(e) * dh + 4 * ch : rt;
        cp_async16(dst + row * COLS + 4 * ch, p, !live);
      }
    } else {
      for (int i = tid; i < tile_floats; i += THREADS) {
        const int row = i / COLS, cc = i % COLS;
        const int g = row / dh, e = row % dh;
        dst[i] = d0 + cc < dh ? src[g * gstride + static_cast<int64_t>(e) * dh + cc] : 0.f;
      }
    }
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  const int64_t gate_row = static_cast<int64_t>(steps) * 4 * heads * dh;  // batch strides
  const int64_t seq_row = static_cast<int64_t>(steps) * heads * dh;
  const int64_t hd = static_cast<int64_t>(heads) * dh;
  const bool gate = tid < ROWS * COLS;
  const int gb = tid / COLS, gc = tid % COLS;

  // Iteration k handles step t = S-1-k; the last one (t = -1) only forms the
  // initial state's dh from dpre_0.
  for (int k = 0; k <= steps; ++k) {
    const int t = steps - 1 - k;
    for (int u = u_begin; u < u_end; ++u) {
      const int head = u / per_head, d0 = (u % per_head) * COLS;
      const int kk = u - u_begin;
      const bool first_of_head = u == u_begin || (u - 1) / per_head != head;
      const bool last_of_head = u + 1 == u_end || (u + 1) / per_head != head;
      const int e = d0 + gc;
      for (int b0 = 0; b0 < batch; b0 += ROWS) {
        const int nb = min(ROWS, batch - b0);
        // 1. this tile's saved forward values and carried gradients, ahead of the wait
        const bool live = gate && gb < nb && e < dh;
        const int64_t row = b0 + gb;
        const int64_t sidx = (row * heads + head) * dh + e;
        const int64_t tidx = row * seq_row + static_cast<int64_t>(t) * hd + static_cast<int64_t>(head) * dh + e;
        float p[4] = {0.f, 0.f, 0.f, 0.f};
        float c = 0.f, n = 0.f, m = 0.f, c1 = 0.f, n1 = 0.f, m1 = 0.f, dht = 0.f;
        float dcs = 0.f, dns = 0.f, dms = 0.f;
        if (live && t >= 0) {
          const float* pp = pre + row * gate_row + static_cast<int64_t>(t) * 4 * hd +
                            static_cast<int64_t>(head) * dh + e;
#pragma unroll
          for (int g = 0; g < 4; ++g) p[g] = __ldg(pp + static_cast<int64_t>(g) * hd);
          c1 = __ldg(cs + tidx);
          n1 = __ldg(ns + tidx);
          m1 = __ldg(ms + tidx);
          c = t == 0 ? __ldg(c0 + sidx) : __ldg(cs + tidx - hd);
          n = t == 0 ? __ldg(n0 + sidx) : __ldg(ns + tidx - hd);
          m = t == 0 ? __ldg(m0 + sidx) : __ldg(ms + tidx - hd);
          dht = __ldg(dhs + tidx);
          dcs = k == 0 ? __ldg(dc_fin + sidx) : dc[sidx];
          dns = k == 0 ? __ldg(dn_fin + sidx) : dn[sidx];
          dms = k == 0 ? __ldg(dm_fin + sidx) : dm[sidx];
        }
        float rec = 0.f;
        if (k == 0) {
          if (live) rec = __ldg(dh_fin + sidx);
        } else {
          // 2. every block of the head has published dpre_{t+1}
          if (b0 == 0 && first_of_head) {
            const int first = head * per_head / tiles_per_block;
            const int last = ((head + 1) * per_head - 1) / tiles_per_block;
            wait_count(counters + head, (last - first + 1) * k);
          }
          // 3. dpre_{t+1} of rows b0 .. b0 + nb - 1, all four gates, through L2
          for (int bb = 0; bb < nb; ++bb) {
            const float* src = dwx + (b0 + bb) * gate_row + static_cast<int64_t>(t + 1) * 4 * hd +
                               static_cast<int64_t>(head) * dh;
            for (int g = 0; g < 4; ++g) {
              const float* gp = src + static_cast<int64_t>(g) * hd;
              float* dst = sh_dp + (bb * 4 + g) * dh;
              if (vec) {
                for (int i = tid; i < dh / 4; i += THREADS)
                  reinterpret_cast<float4*>(dst)[i] = __ldcg(reinterpret_cast<const float4*>(gp) + i);
              } else {
                for (int i = tid; i < dh; i += THREADS) dst[i] = __ldcg(gp + i);
              }
            }
          }
          __syncthreads();
          // 4. the dot products
          if (kk < resident) {
            tile_dots_bwd<ROWS, true>(rs + kk * tile_floats, rt, sh_dp, red, nb, heads, head, dh, d0, vec);
          } else {
            tile_dots_bwd<ROWS, false>(rs, rt, sh_dp, red, nb, heads, head, dh, d0, vec);
          }
          __syncthreads();
          if (live) {
#pragma unroll
            for (int w = 0; w < WARPS; ++w) rec += red[(w * BT + gb) * COLS + gc];
          }
        }
        // 5. the step's VJP, or at t = -1 the initial state's dh
        if (live) {
          if (t >= 0) {
            float dp[4];
            step_vjp(p, c, n, m, c1, n1, m1, dht + rec, dcs, dns, dms, dp);
            float* wp = dwx + row * gate_row + static_cast<int64_t>(t) * 4 * hd + static_cast<int64_t>(head) * dh + e;
#pragma unroll
            for (int g = 0; g < 4; ++g) wp[static_cast<int64_t>(g) * hd] = dp[g];
            dc[sidx] = dcs;
            dn[sidx] = dns;
            dm[sidx] = dms;
          } else {
            dh0[sidx] = rec;
          }
        }
        __syncthreads();  // sh_dp and red are refilled next; dpre_t is written
      }
      // 6. publish this block's part of dpre_t for the head (as the forward
      // publishes h_t); nothing reads past t = 0.
      if (t >= 0 && last_of_head && tid == 0) add_release(counters + head);
    }
  }
}

}  // namespace
}  // namespace repro

// The shared memory a block of the backward kernel needs for `resident`
// tiles of r: the forward's tiles, four gates a staged row, and one sum a
// column in the reduction buffer.
static int64_t slstm_bwd_smem_bytes(int64_t dh, int64_t resident) {
  using namespace repro;
  return (resident * 4 * dh * COLS + BT * 4 * dh + WARPS * BT * COLS) * static_cast<int64_t>(sizeof(float));
}

// The backward of repro_slstm_seq (see slstm_seq_bwd_kernel for the
// operands). All fp32, contiguous; counters: H int32, zero. The plan comes
// from the wrapper (kernels/slstm/slstm.py:slstm_bwd_plan), checked as the
// forward's; one cooperative launch runs all S steps.
extern "C" int repro_slstm_seq_bwd(const void* rt, const void* pre, const void* cs, const void* ns,
                                   const void* ms, const void* c0, const void* n0, const void* m0,
                                   const void* dhs, const void* dh_fin, const void* dc_fin, const void* dn_fin,
                                   const void* dm_fin, void* dwx, void* dh0, void* dc, void* dn, void* dm,
                                   void* counters, int64_t b, int64_t s, int64_t h, int64_t dh, int64_t blocks,
                                   int64_t tiles_per_block, int64_t resident, void* stream) {
  using namespace repro;
  const int64_t units = h * ((dh + COLS - 1) / COLS);
  if (b < 1 || s < 1 || h < 1 || dh < 1 || b > INT32_MAX || s >= INT32_MAX || units > INT32_MAX ||
      blocks < 1 || tiles_per_block < 1 || resident < 0 || resident > tiles_per_block ||
      (blocks - 1) * tiles_per_block >= units || blocks * tiles_per_block < units ||
      blocks * s > INT32_MAX) {  // a head's counter reaches its blocks x S
    return cudaErrorInvalidValue;
  }
  const int64_t smem = slstm_bwd_smem_bytes(dh, resident);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  const void* kernel = b == 1 ? reinterpret_cast<const void*>(slstm_seq_bwd_kernel<1>)
                              : reinterpret_cast<const void*>(slstm_seq_bwd_kernel<BT>);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const bool vec = dh % 4 == 0 && aligned16(rt) && aligned16(dwx);
  const float *rtp = static_cast<const float*>(rt), *prep = static_cast<const float*>(pre),
              *csp = static_cast<const float*>(cs), *nsp = static_cast<const float*>(ns),
              *msp = static_cast<const float*>(ms), *c0p = static_cast<const float*>(c0),
              *n0p = static_cast<const float*>(n0), *m0p = static_cast<const float*>(m0),
              *dhsp = static_cast<const float*>(dhs), *dhfp = static_cast<const float*>(dh_fin),
              *dcfp = static_cast<const float*>(dc_fin), *dnfp = static_cast<const float*>(dn_fin),
              *dmfp = static_cast<const float*>(dm_fin);
  float *dwxp = static_cast<float*>(dwx), *dh0p = static_cast<float*>(dh0), *dcp = static_cast<float*>(dc),
        *dnp = static_cast<float*>(dn), *dmp = static_cast<float*>(dm);
  int* ctr = static_cast<int*>(counters);
  int bi = static_cast<int>(b), si = static_cast<int>(s), hi = static_cast<int>(h), di = static_cast<int>(dh);
  int tpb = static_cast<int>(tiles_per_block), res = static_cast<int>(resident);
  void* args[] = {&rtp, &prep, &csp, &nsp, &msp, &c0p, &n0p, &m0p, &dhsp, &dhfp, &dcfp, &dnfp, &dmfp,
                  &dwxp, &dh0p, &dcp, &dnp, &dmp, &ctr, &bi, &si, &hi, &di, &tpb, &res,
                  const_cast<bool*>(&vec)};
  err = cudaLaunchCooperativeKernel(kernel, dim3(static_cast<unsigned>(blocks)), dim3(THREADS), args,
                                    static_cast<size_t>(smem), static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}
