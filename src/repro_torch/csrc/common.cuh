// Shared helpers of the port's CUDA kernels (sm_90a).
//
// Every kernel takes fp32 or bf16 storage and computes in fp32. Each C entry
// point launches on the stream it is given, allocates nothing, and returns
// cudaGetLastError() so that the Python wrapper can raise on a refused launch.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace repro {

// Storage type codes shared with the Python wrappers (kernels/_build.py).
enum DType : int { kF32 = 0, kBF16 = 1 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);  // round to nearest even, as torch's .to(bfloat16)
}

// Rounds an fp32 value to the storage type and back: the identity for fp32,
// one round-to-nearest-even for bf16.
template <typename T>
__device__ __forceinline__ float round_to(float x) { return to_f32(from_f32<T>(x)); }

// Loads four consecutive floats (16-byte aligned) into dst[0..3].
__device__ __forceinline__ void ld4(float* dst, const float* src) {
  const float4 v = *reinterpret_cast<const float4*>(src);
  dst[0] = v.x; dst[1] = v.y; dst[2] = v.z; dst[3] = v.w;
}

// Asynchronous 16-byte copy from device to shared memory (cp.async, sm_80+).
// With fill set, the 16 bytes are zeros and nothing is read from src.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool fill = false) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  const int bytes = fill ? 0 : 16;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
// Waits until at most N of this thread's committed copy groups are pending.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Stores N (2 or 4) consecutive fp32 values as storage type T, each rounded
// once, in one vector store: dst must be aligned to N * sizeof(T) bytes.
template <typename T, int N>
__device__ __forceinline__ void store_vec(T* dst, const float* v) {
  static_assert(N == 2 || N == 4, "store_vec stores 2 or 4 values");
  if constexpr (sizeof(T) == 4) {
    if constexpr (N == 2) {
      *reinterpret_cast<float2*>(dst) = make_float2(v[0], v[1]);
    } else {
      *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
    }
  } else if constexpr (N == 2) {
    *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(v[0], v[1]);
  } else {
    uint2 u;
    *reinterpret_cast<__nv_bfloat162*>(&u.x) = __floats2bfloat162_rn(v[0], v[1]);
    *reinterpret_cast<__nv_bfloat162*>(&u.y) = __floats2bfloat162_rn(v[2], v[3]);
    *reinterpret_cast<uint2*>(dst) = u;
  }
}

// A count in device memory that blocks of one launch take turns on, for
// sums that must run in a fixed order without two adds racing: a block
// waits until the count reaches its turn, adds its term, and raises the
// count. One thread waits and signals; the block's barrier around each call
// orders the other threads' loads and stores (as CUTLASS's semaphores do).
// A wait that outlasts WAIT_NS (a turn that never comes) traps, so the launch
// fails instead of hanging the card.
constexpr unsigned long long WAIT_NS = 4000000000ull;

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
__device__ __forceinline__ int load_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.s32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}
// Waits until *count >= want (this thread only).
__device__ __forceinline__ void wait_for(const int* count, int want) {
  if (load_acquire(count) >= want) return;
  const unsigned long long t0 = global_ns();
  while (load_acquire(count) < want) {
    if (global_ns() - t0 > WAIT_NS) __trap();
  }
}
// Adds one to *count, after every store this thread has seen; returns the
// count before (a ticket: the order of arrival).
__device__ __forceinline__ int arrive_count(int* count) {
  int old;
  asm volatile("fence.acq_rel.gpu;\natom.relaxed.gpu.global.add.s32 %0, [%1], 1;\n"
               : "=r"(old) : "l"(count) : "memory");
  return old;
}
// Adds one to *count, after every store this thread has seen (cumulative).
__device__ __forceinline__ void signal_count(int* count) {
  asm volatile("fence.acq_rel.gpu;\nred.relaxed.gpu.global.add.s32 [%0], 1;\n" ::"l"(count) : "memory");
}

// True when a pointer allows 16-byte vector loads and stores.
inline bool aligned16(const void* ptr) { return reinterpret_cast<uintptr_t>(ptr) % 16 == 0; }

// VEC consecutive elements of storage type T, loaded as floats and stored
// back rounded once: one element, a float4 of fp32, or eight bf16 (16 bytes).
template <typename T, int VEC>
struct Vec;

template <typename T>
struct Vec<T, 1> {
  static __device__ __forceinline__ void load(float* dst, const T* src) { dst[0] = to_f32(*src); }
  static __device__ __forceinline__ void store(T* dst, const float* src) { *dst = from_f32<T>(src[0]); }
};

template <>
struct Vec<float, 4> {
  static __device__ __forceinline__ void load(float* dst, const float* src) {
    const float4 v = *reinterpret_cast<const float4*>(src);
    dst[0] = v.x; dst[1] = v.y; dst[2] = v.z; dst[3] = v.w;
  }
  static __device__ __forceinline__ void store(float* dst, const float* src) {
    *reinterpret_cast<float4*>(dst) = make_float4(src[0], src[1], src[2], src[3]);
  }
};

template <>
struct Vec<__nv_bfloat16, 8> {
  static __device__ __forceinline__ void load(float* dst, const __nv_bfloat16* src) {
    const uint4 v = *reinterpret_cast<const uint4*>(src);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      dst[2 * i] = f.x;
      dst[2 * i + 1] = f.y;
    }
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* dst, const float* src) {
    uint4 v;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(src[2 * i], src[2 * i + 1]);
    *reinterpret_cast<uint4*>(dst) = v;
  }
};

}  // namespace repro
