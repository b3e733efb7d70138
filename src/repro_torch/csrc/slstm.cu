// The sLSTM recurrence over a whole sequence, state resident in fp32:
// for t = 0 .. S-1, with h_{-1} = h0 and gates g = z, i, f, o,
//   pre[b,g,h,e] = wx[b,t,g,h,e] + sum_d h_{t-1}[b,h,d] * r[g,h,d,e]
//   z = tanh(pre_z), log_f = log_sigmoid(pre_f), o = sigmoid(pre_o)
//   m' = max(log_f + m, pre_i), i = exp(pre_i - m'), f = exp(log_f + m - m')
//   c' = f c + i z, n' = f n + i, h_t = o c' / max(n', 1), hs[b,t] = h_t.
//
// Replaces slstm_seq_pallas (src/repro/kernels/slstm/slstm.py:81), whose grid
// walks the time axis in order on one TPU core and keeps (c, n, m, h) in VMEM
// scratch for the whole sequence. On Hopper the blocks of a grid run in no
// order, and step t needs every column of h_{t-1}, so the time loop runs on
// the host: one launch per step on the caller's stream, which orders the
// steps. The state never leaves device memory: c, n and m are updated in
// place (each element has one owner), and h_{t-1} is read back from
// hs[:, t-1], or from h0 at t = 0, so no second buffer is needed.
//
// A block owns COLS output columns of one head for all four gates and up to
// BT batch rows: it stages h_{t-1} of its rows in shared memory, forms the
// 4 x COLS x BT dot products of length dh against r (threads split the
// length into SLICES interleaved parts, joined in shared memory in a fixed
// order), then adds wx and applies the gates for its own columns. Columns
// past dh and rows past B are masked, so no tile has to divide dh or B.
//
// What bounds it: 2 * 4 * dh^2 flops per (batch row, head, step) against r's
// 16 MB (fp32, 4 heads of 512 at full width) read every step. Over a
// prefill of S steps at batch 1 the card's fp32 rate bounds the work (r then
// stays in the 50 MB L2); a single decode step is bound by reading r once
// from device memory. This first version is bound by neither: each step is
// one short launch whose blocks stream their slice of r from L2 with plain
// loads. A persistent kernel with r resident in shared memory across the
// SMs, and tensor cores for the mat-vec at B > 1, are later work.
//
// Numerics: fp32 throughout, precise expf/tanhf/log1pf (no fast math); the
// log-sigmoid is the stable min(x, 0) - log1p(exp(-|x|)). With m = -1e30 at
// the first step, log_f + m - m' underflows exp to 0 and f = 0, never NaN.
#include "common.cuh"

namespace repro {
namespace {

constexpr int COLS = 16;                // output columns per block, all four gates
constexpr int BT = 4;                   // batch rows per block
constexpr int THREADS = 256;
constexpr int SLICES = THREADS / COLS;  // parts of each dot product's length
constexpr int RED_FLOATS = SLICES * BT * 4 * COLS;
constexpr int kMaxSmem = 227 * 1024;

__device__ __forceinline__ float log_sigmoid(float x) {
  return fminf(x, 0.f) - log1pf(expf(-fabsf(x)));
}

// One time step. Batch strides are in elements; wx, h_prev and hs point at
// step t (t - 1 for h_prev) of batch row 0.
__global__ void __launch_bounds__(THREADS)
slstm_step_kernel(const float* __restrict__ wx, int64_t wx_bstride, const float* __restrict__ r,
                  const float* h_prev, int64_t hp_bstride, float* __restrict__ c,
                  float* __restrict__ n, float* __restrict__ m, float* hs, int64_t hs_bstride,
                  int64_t batch, int heads, int dh) {
  extern __shared__ float smem[];
  float* sh_h = smem;             // [BT][dh]
  float* red = smem + BT * dh;    // [SLICES][BT][4][COLS]
  const int64_t b0 = static_cast<int64_t>(blockIdx.x) * BT;
  const int head = blockIdx.y;
  const int e0 = blockIdx.z * COLS;
  const int nb = batch - b0 < BT ? static_cast<int>(batch - b0) : BT;
  const int tid = threadIdx.x;

  for (int i = tid; i < nb * dh; i += THREADS) {
    const int bb = i / dh;
    sh_h[i] = h_prev[(b0 + bb) * hp_bstride + static_cast<int64_t>(head) * dh + (i - bb * dh)];
  }
  __syncthreads();

  const int col = tid % COLS;
  const int slice = tid / COLS;
  const int e = e0 + col;
  float acc[BT][4];
#pragma unroll
  for (int bb = 0; bb < BT; ++bb) {
#pragma unroll
    for (int g = 0; g < 4; ++g) acc[bb][g] = 0.f;
  }
  if (e < dh) {
    const int64_t gstride = static_cast<int64_t>(heads) * dh * dh;
    const float* rp = r + static_cast<int64_t>(head) * dh * dh + e;
#pragma unroll 4
    for (int d = slice; d < dh; d += SLICES) {
      float rv[4];
#pragma unroll
      for (int g = 0; g < 4; ++g) rv[g] = __ldg(rp + g * gstride + static_cast<int64_t>(d) * dh);
#pragma unroll
      for (int bb = 0; bb < BT; ++bb) {
        if (bb < nb) {
          const float hv = sh_h[bb * dh + d];
#pragma unroll
          for (int g = 0; g < 4; ++g) acc[bb][g] = fmaf(hv, rv[g], acc[bb][g]);
        }
      }
    }
  }
#pragma unroll
  for (int bb = 0; bb < BT; ++bb) {
#pragma unroll
    for (int g = 0; g < 4; ++g) red[((slice * BT + bb) * 4 + g) * COLS + col] = acc[bb][g];
  }
  __syncthreads();

  if (tid >= BT * COLS) return;
  const int bb = tid / COLS;
  const int cc = tid % COLS;
  const int ee = e0 + cc;
  if (bb >= nb || ee >= dh) return;
  const int64_t row = b0 + bb;
  float pre[4];
#pragma unroll
  for (int g = 0; g < 4; ++g) {
    float rec = 0.f;
    for (int sl = 0; sl < SLICES; ++sl) rec += red[((sl * BT + bb) * 4 + g) * COLS + cc];
    pre[g] = wx[row * wx_bstride + (static_cast<int64_t>(g) * heads + head) * dh + ee] + rec;
  }
  const int64_t idx = (row * heads + head) * dh + ee;
  const float z = tanhf(pre[0]);
  const float i_pre = pre[1];
  const float log_f = log_sigmoid(pre[2]);
  const float o = 1.f / (1.f + expf(-pre[3]));
  const float m_prev = m[idx];
  const float m_new = fmaxf(log_f + m_prev, i_pre);
  const float i_g = expf(i_pre - m_new);
  const float f_g = expf(log_f + m_prev - m_new);
  const float c_new = f_g * c[idx] + i_g * z;
  const float n_new = f_g * n[idx] + i_g;
  c[idx] = c_new;
  n[idx] = n_new;
  m[idx] = m_new;
  hs[row * hs_bstride + static_cast<int64_t>(head) * dh + ee] = o * c_new / fmaxf(n_new, 1.f);
}

}  // namespace
}  // namespace repro

// wx (B, S, 4, H, dh), r (4, H, dh, dh), h0 (B, H, dh): read only. c, n, m
// (B, H, dh): the state at t = 0, updated in place to the state after step
// S - 1. hs (B, S, H, dh): written, hs[:, S-1] is the final h. All fp32,
// contiguous.
extern "C" int repro_slstm_seq(const void* wx, const void* r, const void* h0, void* c, void* n,
                               void* m, void* hs, int64_t b, int64_t s, int64_t h, int64_t dh,
                               void* stream) {
  using namespace repro;
  if (b < 1 || s < 1 || h < 1 || h > 65535 || dh < 1 || (dh + COLS - 1) / COLS > 65535 ||
      (b + BT - 1) / BT > 0x7fffffffLL) {
    return cudaErrorInvalidValue;
  }
  const int64_t smem = (static_cast<int64_t>(BT) * dh + RED_FLOATS) * sizeof(float);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        slstm_step_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned>((b + BT - 1) / BT), static_cast<unsigned>(h),
                  static_cast<unsigned>((dh + COLS - 1) / COLS));
  const float* wxp = static_cast<const float*>(wx);
  const float* rp = static_cast<const float*>(r);
  float* hsp = static_cast<float*>(hs);
  const int64_t step_wx = 4 * h * dh, step_hs = h * dh;
  for (int64_t t = 0; t < s; ++t) {
    const float* h_prev = t == 0 ? static_cast<const float*>(h0) : hsp + (t - 1) * step_hs;
    const int64_t hp_bstride = t == 0 ? step_hs : s * step_hs;
    slstm_step_kernel<<<grid, THREADS, smem, st>>>(
        wxp + t * step_wx, s * step_wx, rp, h_prev, hp_bstride, static_cast<float*>(c),
        static_cast<float*>(n), static_cast<float*>(m), hsp + t * step_hs, s * step_hs, b,
        static_cast<int>(h), static_cast<int>(dh));
    if (t == 0) {  // a refused launch is refused at every step: stop at the first
      const cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return err;
    }
  }
  return cudaGetLastError();
}
