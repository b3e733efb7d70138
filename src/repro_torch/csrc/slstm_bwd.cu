// The sLSTM backward: the reverse-time recurrence of slstm.cu's sequence
// kernel (the VJP of the scan of _slstm_step, src/repro/models/xlstm.py:248,
// which the JAX package forms in XLA; no Pallas kernel computes it). For
// t = S-1 .. 0, with dh_t the gradient of h_t (dhs[:, t] plus the recurrent
// term below, plus the final state's dh at t = S-1) and dc, dn, dm carried
// from step t+1 (the final state's at t = S-1):
//   dpre_t = the VJP of the step's gates at each element, which is
//            dwx[:, t]; it also gives dc, dn, dm of the state before;
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
// hang. A tile is COLS columns of r's d index: its dot products are the
// forward's with the gate index summed, so the wrapper hands the kernel r
// transposed in its last two indices (rt[g,h,e,d] = r[g,h,d,e]) and a tile's
// slice, [4][dh][COLS], lies and is copied as the forward's does. A pass
// takes ROWS batch rows: 1 at B = 1, 2 at B = 2 (xlstm's training rows), BT
// otherwise. Each step, for each tile and pass, what lies on the chain from
// one block's publish to the next is kept short:
//   1. before the wait, the gate threads reduce the step's VJP to what is
//      affine in dh_t (step_vjp_affine), from the saved values and the
//      carried gradients alone;
//   2. the warps that hold no gate thread (the stagers) take the exchange:
//      one of them (WAITER) waits for the head's counter, and after a barrier
//      of their own they stage dpre_{t+1} of the pass's rows from the
//      exchange ring, one contiguous run, with float4 loads all in flight at
//      once; so the gate warps' part of the VJP runs beside the wait and the
//      staging, not before them;
//   3. the dot products, reduced across the warps in shared memory;
//   4. the gate threads form dpre_t, dc, dn, dm with one FMA each from
//      dh_t = dhs + the sum, and write dpre_t to dwx (streaming stores) and
//      to the ring;
//   5. after the head's last tile, __syncthreads, then thread 0 adds one to
//      the head's counter with release semantics.
//
// The ring, xring[2][H][B][4][dhp] (dhp: dh rounded up to 4 floats), holds
// dpre of step t in slot t & 1, so that the rows a pass stages lie in one
// 16-byte-aligned run (16 KB at B = 2, dh 512) where dwx spreads them over
// 4 x B pieces; at 128 KB for xlstm's 4 heads of 512 it stays in L2. Two
// slots suffice: a block writes slot t & 1 at step t only after its wait at
// step t has shown that every block of the head has published step t+1,
// which each does after a barrier that follows its staging loads of step t+1
// (dpre_{t+2}, the slot's last content).
//
// Measured and left out (tools/slstm_bwd_variants.py): the staging as a TMA
// bulk copy completing on an mbarrier, and the carried gradients kept in
// registers with the saved values loaded a step ahead where a thread owns
// one element for the whole launch (together no faster a step than this
// form); and an L2 prefetch of the step before's saved values (no faster).
// `block_staging` (the whole block stages after the VJP) measures what the
// stagers' overlap buys.
//
// Numerics: the forward's gates are recomputed from the saved pre-activations
// with the same functions; the saved m' gives i and f bit for bit. Ties take
// PyTorch's rules: at max(n', 1) the gradient passes when n' >= 1 (clamp_min),
// at max(log_f + m, pre_i) it is split in halves (maximum). From a zero state
// the first step gives n' = 1 and m' = pre_i exactly, so it sits on the first
// tie; i = exp(pre_i - m') = 1 and f = 0 there, and the two terms of pre_i's
// gradient cancel: exactly in dh_t's coefficient (f = 0 zeroes the other
// term), and in the constant part in step_vjp's order, as in the plain
// version (kernels/slstm/ref.py:step_vjp_affine).
#include "hopper.cuh"
#include "slstm.cuh"

namespace repro {
namespace {

constexpr int WAITER = THREADS - 1;
static_assert(BT * COLS <= THREADS - 32, "the waiter's warp must hold no gate thread");
// Float4s a stager loads before it stores any: 4, so that two rows of four
// gates of 512 (xlstm's training pass) take two round trips; 8 (one round
// trip) ran slower: stage_loads_8 in tools/slstm_bwd_variants.py.
constexpr int STAGE_LOADS = 4;

// dst[i] = src[i] for i < n, by the threads numbered i0 = 0 .. stride - 1,
// each with up to STAGE_LOADS loads in flight (from L2, bypassing L1).
__device__ __forceinline__ void stage(float4* dst, const float4* src, int n, int i0, int stride) {
  for (; i0 < n; i0 += STAGE_LOADS * stride) {
    float4 x[STAGE_LOADS];
#pragma unroll
    for (int j = 0; j < STAGE_LOADS; ++j) {
      if (i0 + j * stride < n) x[j] = __ldcg(src + i0 + j * stride);
    }
#pragma unroll
    for (int j = 0; j < STAGE_LOADS; ++j) {
      if (i0 + j * stride < n) dst[i0 + j * stride] = x[j];
    }
  }
}

// The VJP of one step at one element, as far as the saved values take it:
// every output is x0 + dh * x1 in dh, the gradient of h_t, which the
// exchange completes. p: the gate pre-activations (z, i, f, o); c, n, m: the
// state before the step; c1, n1, m1: after it; dc, dn, dm: the gradients of
// c1, n1, m1. The outputs: dp (the gradients of p) and dc, dn, dm of the
// state before. kernels/slstm/ref.py:step_vjp_affine is the same arithmetic
// in PyTorch.
struct Affine {
  float p0[4], p1[4];
  float c0, c1, n0, n1, m0, m1;
};

__device__ __forceinline__ Affine step_vjp_affine(const float p[4], float c, float n, float m, float c1, float n1,
                                                  float m1, float dc, float dn, float dm) {
  const float z = tanhf(p[0]);
  const float lf = log_sigmoid(p[2]);
  const float o = 1.f / (1.f + expf(-p[3]));
  const float a = lf + m;
  const float ig = expf(p[1] - m1);
  const float fg = expf(a - m1);
  const float nn = fmaxf(n1, 1.f);
  const float q = 1.f / nn;  // dq = dh * q, of o * c1
  const float h = o * c1 / nn;
  // dc1 = dc + dh * kc, dn1 = dn + dh * kn
  const float kc = q * o;
  const float kn = n1 >= 1.f ? -q * h : 0.f;
  const float df0 = dc * c + dn * n, df1 = kc * c + kn * n;
  const float di0 = dc * z + dn, di1 = kc * z + kn;
  const float ga0 = df0 * fg, ga1 = df1 * fg;  // of a - m1
  const float gi0 = di0 * ig, gi1 = di1 * ig;  // of p_i - m1
  const float dmt0 = dm - ga0 - gi0, dmt1 = -ga1 - gi1;  // of m1
  // m1's share to log_f + m and to p_i
  const float ta = a > p[1] ? 1.f : (a < p[1] ? 0.f : 0.5f);
  const float ti = a < p[1] ? 1.f : (a > p[1] ? 0.f : 0.5f);
  const float dlf0 = ga0 + ta * dmt0, dlf1 = ga1 + ta * dmt1;
  const float kz = ig * (1.f - z * z);
  const float sf = 1.f / (1.f + expf(p[2]));  // log_sigmoid' = sigmoid(-x)
  Affine v;
  v.p0[0] = dc * kz;
  v.p1[0] = kc * kz;
  v.p0[1] = gi0 + ti * dmt0;
  v.p1[1] = gi1 + ti * dmt1;
  v.p0[2] = dlf0 * sf;
  v.p1[2] = dlf1 * sf;
  v.p0[3] = 0.f;
  v.p1[3] = q * c1 * o * (1.f - o);
  v.c0 = dc * fg;
  v.c1 = kc * fg;
  v.n0 = dn * fg;
  v.n1 = kn * fg;
  v.m0 = dlf0;
  v.m1 = dlf1;
  return v;
}

// What a step reads of the saving forward at one element: the gate
// pre-activations, the state before the step, and the gradient of h_t from
// dhs (each read once: streaming loads).
struct Saved {
  float p[4];
  float c, n, m, dht;
};

// The backward's dot products of one tile: for each of its COLS columns d and
// pass row bb, sum_{g,e} dp[bb][g][e] * rt[g][e][d], reduced within each warp
// into red[warp][bb][col]. The thread layout and r's reads are tile_dots'
// (four adjacent columns a thread, an interleaved SLICES-th of the length,
// float4 reads); each thread keeps the four gates apart and adds them in
// order before the warp's shuffle tree. sh_dp holds a row's gates dhp apart.
template <int ROWS, bool RES>
__device__ __forceinline__ void tile_dots_bwd(const float* rs, const float* __restrict__ rt, const float* sh_dp,
                                              float* red, int nb, int heads, int head, int dh, int dhp, int d0,
                                              bool vec) {
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
          const float dv = sh_dp[(bb * 4 + g) * dhp + e];
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[bb][g][j] = fmaf(dv, rv[g][j], acc[bb][g][j]);
        }
      }
    }
  };
  // Over resident r the loop is unrolled twice (not at all measured slower:
  // unroll_1 in tools/slstm_bwd_variants.py), over streamed r four times.
  if constexpr (RES) {
#pragma unroll 2
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
    if (!b2) red[(warp * ROWS + bb) * COLS + 4 * cg + 2 * b4 + b3] = v[0];
  }
}

// rt (4, H, dh, dh): r transposed in its last two indices. pre (B, S, 4, H,
// dh), cs, ns, ms (B, S, H, dh): the saving forward's. c0, n0, m0 (B, H, dh):
// the initial state. dhs (B, S, H, dh), dh_fin, dc_fin, dn_fin, dm_fin (B, H,
// dh): the gradients of hs and of the final state. Written: dwx (B, S, 4, H,
// dh), dh0 (B, H, dh), and dc, dn, dm (B, H, dh), the initial state's
// gradients, which also carry the state's gradient from step to step. ring:
// the exchange ring, 2 x H x B x 4 x dhp floats, 16-byte aligned.
template <int ROWS>
__global__ void __launch_bounds__(THREADS, 1)
slstm_seq_bwd_kernel(const float* __restrict__ rt, const float* __restrict__ pre, const float* __restrict__ cs,
                     const float* __restrict__ ns, const float* __restrict__ ms, const float* __restrict__ c0,
                     const float* __restrict__ n0, const float* __restrict__ m0, const float* __restrict__ dhs,
                     const float* __restrict__ dh_fin, const float* __restrict__ dc_fin,
                     const float* __restrict__ dn_fin, const float* __restrict__ dm_fin, float* dwx, float* dh0,
                     float* dc, float* dn, float* dm, int* counters, float* ring, int batch, int steps, int heads,
                     int dh, int tiles_per_block, int resident, bool vec) {
  extern __shared__ __align__(16) float smem[];
  const int dhp = (dh + 3) & ~3;
  const int tile_floats = 4 * dh * COLS;
  float* rs = smem;                                    // [resident][4][dh][COLS]
  float* sh_dp = smem + resident * tile_floats;        // [ROWS][4][dhp]
  float* red = sh_dp + ROWS * 4 * dhp;                 // [WARPS][ROWS][COLS]
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
  constexpr int FIRST_STAGER = (ROWS * COLS + 31) / 32 * 32;  // the first warp with no gate thread
  constexpr int STAGERS = THREADS - FIRST_STAGER;

  auto load_saved = [&](int64_t row, int head, int e, int t) {
    Saved v;
    const int64_t sidx = (row * heads + head) * dh + e;
    const int64_t tidx = row * seq_row + static_cast<int64_t>(t) * hd + static_cast<int64_t>(head) * dh + e;
    const float* pp = pre + row * gate_row + static_cast<int64_t>(t) * 4 * hd + static_cast<int64_t>(head) * dh + e;
#pragma unroll
    for (int g = 0; g < 4; ++g) v.p[g] = __ldcs(pp + static_cast<int64_t>(g) * hd);
    v.c = t == 0 ? __ldg(c0 + sidx) : __ldcs(cs + tidx - hd);
    v.n = t == 0 ? __ldg(n0 + sidx) : __ldcs(ns + tidx - hd);
    v.m = t == 0 ? __ldg(m0 + sidx) : __ldcs(ms + tidx - hd);
    v.dht = __ldcs(dhs + tidx);
    return v;
  };

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
        const bool live = gate && gb < nb && e < dh;
        const int64_t row = b0 + gb;
        const int64_t sidx = (row * heads + head) * dh + e;
        // 1. the step's VJP as far as the saved values take it, ahead of the wait
        Affine v{};
        float dht = 0.f;
        if (live && t >= 0) {
          const Saved s = load_saved(row, head, e, t);
          const int64_t tidx = row * seq_row + static_cast<int64_t>(t) * hd + static_cast<int64_t>(head) * dh + e;
          const bool fin = k == 0;
          const float c1 = __ldcs(cs + tidx), n1 = __ldcs(ns + tidx), m1 = __ldcs(ms + tidx);
          const float dc1 = fin ? __ldg(dc_fin + sidx) : dc[sidx], dn1 = fin ? __ldg(dn_fin + sidx) : dn[sidx],
                      dm1 = fin ? __ldg(dm_fin + sidx) : dm[sidx];
          v = step_vjp_affine(s.p, s.c, s.n, s.m, c1, n1, m1, dc1, dn1, dm1);
          dht = s.dht;
        }
        float rec = 0.f;
        if (k == 0) {
          if (live) rec = __ldg(dh_fin + sidx);
        } else {
          // 2. every block of the head has published dpre_{t+1}: the stagers
          // stage its rows b0 .. b0 + nb - 1 from the ring's slot (t+1) & 1,
          // nb x dhp float4s, 16-byte aligned. Each block published its
          // stores with a barrier and a release add; the waiter's acquire and
          // the stagers' barrier order them before the loads, which bypass L1
          // (the forward's wait_count and h loads).
          if (tid >= FIRST_STAGER) {
            if (tid == WAITER && b0 == 0 && first_of_head) {
              const int first = head * per_head / tiles_per_block;
              const int last = ((head + 1) * per_head - 1) / tiles_per_block;
              spin_until(counters + head, (last - first + 1) * k);
            }
            asm volatile("bar.sync 1, %0;\n" ::"n"(STAGERS) : "memory");
            const int64_t slot_row = (static_cast<int64_t>((t + 1) & 1) * heads + head) * batch + b0;
            const float4* staged = reinterpret_cast<const float4*>(ring + slot_row * 4 * dhp);
            stage(reinterpret_cast<float4*>(sh_dp), staged, nb * dhp, tid - FIRST_STAGER, STAGERS);
          }
          __syncthreads();
          // 3. the dot products
          if (kk < resident) {
            tile_dots_bwd<ROWS, true>(rs + kk * tile_floats, rt, sh_dp, red, nb, heads, head, dh, dhp, d0, vec);
          } else {
            tile_dots_bwd<ROWS, false>(rs, rt, sh_dp, red, nb, heads, head, dh, dhp, d0, vec);
          }
          __syncthreads();
          if (live) {
#pragma unroll
            for (int w = 0; w < WARPS; ++w) rec += red[(w * ROWS + gb) * COLS + gc];
          }
        }
        // 4. dpre_t and the state before's gradients, or at t = -1 the
        // initial state's dh
        if (live) {
          if (t >= 0) {
            const float d = dht + rec;
            float* wp = dwx + row * gate_row + static_cast<int64_t>(t) * 4 * hd + static_cast<int64_t>(head) * dh + e;
            float* xp = ring + ((static_cast<int64_t>(t & 1) * heads + head) * batch + row) * 4 * dhp + e;
#pragma unroll
            for (int g = 0; g < 4; ++g) {
              const float x = fmaf(d, v.p1[g], v.p0[g]);
              __stcs(wp + static_cast<int64_t>(g) * hd, x);
              xp[g * dhp] = x;
            }
            dc[sidx] = fmaf(d, v.c1, v.c0);
            dn[sidx] = fmaf(d, v.n1, v.n0);
            dm[sidx] = fmaf(d, v.m1, v.m0);
          } else {
            dh0[sidx] = rec;
          }
        }
        __syncthreads();  // sh_dp and red are refilled next; dpre_t is written
      }
      // 5. publish this block's part of dpre_t for the head (as the forward
      // publishes h_t); nothing reads past t = 0.
      if (t >= 0 && last_of_head && tid == 0) add_release(counters + head);
    }
  }
}

}  // namespace
}  // namespace repro

// The shared memory a block of the backward kernel needs for `resident`
// tiles of r and `rows` rows a pass: the forward's tiles, four gates of dhp
// a staged row, and one sum a column and row in the reduction buffer.
// kernels/slstm/slstm.py:slstm_bwd_plan counts the same.
static int64_t slstm_bwd_smem_bytes(int64_t dh, int64_t resident, int64_t rows) {
  using namespace repro;
  const int64_t dhp = (dh + 3) / 4 * 4;
  return (resident * 4 * dh * COLS + rows * 4 * dhp + WARPS * rows * COLS) * static_cast<int64_t>(sizeof(float));
}

// The backward of repro_slstm_seq (see slstm_seq_bwd_kernel for the
// operands). All fp32, contiguous; counters: H int32, zero; ring: 2 x H x B x
// 4 x dhp floats, 16-byte aligned, its contents left to the kernel. The plan
// comes from the wrapper (kernels/slstm/slstm.py:slstm_bwd_plan), checked as
// the forward's; `rows` is 1, 2 or BT, the batch rows a pass. One cooperative
// launch runs all S steps.
extern "C" int repro_slstm_seq_bwd(const void* rt, const void* pre, const void* cs, const void* ns,
                                   const void* ms, const void* c0, const void* n0, const void* m0,
                                   const void* dhs, const void* dh_fin, const void* dc_fin, const void* dn_fin,
                                   const void* dm_fin, void* dwx, void* dh0, void* dc, void* dn, void* dm,
                                   void* counters, void* ring, int64_t b, int64_t s, int64_t h, int64_t dh,
                                   int64_t blocks, int64_t tiles_per_block, int64_t resident, int64_t rows,
                                   void* stream) {
  using namespace repro;
  const int64_t units = h * ((dh + COLS - 1) / COLS);
  if (b < 1 || s < 1 || h < 1 || dh < 1 || b > INT32_MAX || s >= INT32_MAX || units > INT32_MAX ||
      blocks < 1 || tiles_per_block < 1 || resident < 0 || resident > tiles_per_block ||
      (blocks - 1) * tiles_per_block >= units || blocks * tiles_per_block < units ||
      blocks * s > INT32_MAX ||  // a head's counter reaches its blocks x S
      (rows != 1 && rows != 2 && rows != BT) || !aligned16(ring)) {
    return cudaErrorInvalidValue;
  }
  const int64_t smem = slstm_bwd_smem_bytes(dh, resident, rows);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  const void* kernel = rows == 1   ? reinterpret_cast<const void*>(slstm_seq_bwd_kernel<1>)
                       : rows == 2 ? reinterpret_cast<const void*>(slstm_seq_bwd_kernel<2>)
                                   : reinterpret_cast<const void*>(slstm_seq_bwd_kernel<BT>);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const bool vec = dh % 4 == 0 && aligned16(rt);
  const float *rtp = static_cast<const float*>(rt), *prep = static_cast<const float*>(pre),
              *csp = static_cast<const float*>(cs), *nsp = static_cast<const float*>(ns),
              *msp = static_cast<const float*>(ms), *c0p = static_cast<const float*>(c0),
              *n0p = static_cast<const float*>(n0), *m0p = static_cast<const float*>(m0),
              *dhsp = static_cast<const float*>(dhs), *dhfp = static_cast<const float*>(dh_fin),
              *dcfp = static_cast<const float*>(dc_fin), *dnfp = static_cast<const float*>(dn_fin),
              *dmfp = static_cast<const float*>(dm_fin);
  float *dwxp = static_cast<float*>(dwx), *dh0p = static_cast<float*>(dh0), *dcp = static_cast<float*>(dc),
        *dnp = static_cast<float*>(dn), *dmp = static_cast<float*>(dm), *ringp = static_cast<float*>(ring);
  int* ctr = static_cast<int*>(counters);
  int bi = static_cast<int>(b), si = static_cast<int>(s), hi = static_cast<int>(h), di = static_cast<int>(dh);
  int tpb = static_cast<int>(tiles_per_block), res = static_cast<int>(resident);
  void* args[] = {&rtp, &prep, &csp, &nsp, &msp, &c0p, &n0p, &m0p, &dhsp, &dhfp, &dcfp, &dnfp, &dmfp,
                  &dwxp, &dh0p, &dcp, &dnp, &dmp, &ctr, &ringp, &bi, &si, &hi, &di, &tpb, &res,
                  const_cast<bool*>(&vec)};
  err = cudaLaunchCooperativeKernel(kernel, dim3(static_cast<unsigned>(blocks)), dim3(THREADS), args,
                                    static_cast<size_t>(smem), static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}
