// What the sLSTM forward (slstm.cu) and backward (slstm_bwd.cu) kernels
// share: their tile and block shape, the stable log-sigmoid, and the per-head
// release/acquire counters with a wait that traps instead of hanging.
#pragma once

#include "common.cuh"

namespace repro {

constexpr int COLS = 16;                // output columns per tile, all four gates
constexpr int BT = 4;                   // batch rows per pass over a tile, at most
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int CGROUPS = COLS / 4;       // four adjacent columns a thread
constexpr int SLICES = THREADS / CGROUPS;  // parts of each dot product's length
constexpr int RED_FLOATS = WARPS * BT * 4 * COLS;
constexpr int kMaxSmem = 227 * 1024;
constexpr unsigned long long kWaitLimitNs = 2000000000ull;

__device__ __forceinline__ float log_sigmoid(float x) {
  return fminf(x, 0.f) - log1pf(expf(-fabsf(x)));
}

__device__ __forceinline__ void add_release(int* p) {
  asm volatile("red.release.gpu.global.add.s32 [%0], 1;" ::"l"(p) : "memory");
}

// The calling thread waits, with acquire loads, until *ctr >= target; a wait
// longer than kWaitLimitNs traps.
__device__ __forceinline__ void spin_until(const int* ctr, int target) {
  const unsigned long long t0 = global_ns();
  while (load_acquire(ctr) < target) {
    if (global_ns() - t0 > kWaitLimitNs) __trap();
  }
}

// Thread 0 waits until *ctr >= target; then the whole block goes on.
__device__ __forceinline__ void wait_count(const int* ctr, int target) {
  if (threadIdx.x == 0) spin_until(ctr, target);
  __syncthreads();
}

}  // namespace repro
