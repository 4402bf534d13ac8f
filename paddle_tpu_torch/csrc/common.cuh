// Shared helpers of the port's CUDA kernels (sm_90a, plain C interface,
// loaded with ctypes by paddle_tpu_torch/kernels/_build.py).
//
// PT_DEFINE_PROBE(lib) defines `int <lib>_probe(x, o, n, stream)`, the
// capability probe every kernel library carries: o = x + x over an
// [8, 128] f32 tile. It replaces the Pallas probe
// `_pallas_supported` (paddle_tpu/kernels/flash_attention.py:105); the
// loader launches it once per library and raises when the answer is
// wrong, so no kernel route is ever taken on a card that cannot run it.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace pt {

// dtype codes shared with the Python wrappers
enum DType { kF32 = 0, kBF16 = 1, kF16 = 2, kI8 = 3 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }
__device__ __forceinline__ float to_f32(int8_t x) {
  return static_cast<float>(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
template <>
__device__ __forceinline__ __half from_f32<__half>(float x) {
  return __float2half(x);
}

// Elements of T in one 16-byte vector load.
template <typename T>
struct Vec16 {
  static constexpr int n = 16 / sizeof(T);
};

// One 16-byte load of Vec16<T>::n elements at `src` (16-byte aligned),
// converted to f32 and multiplied by `mul`, into dst[0..n).
template <typename T>
__device__ __forceinline__ void load16_f32(const T* __restrict__ src,
                                           float* __restrict__ dst,
                                           float mul) {
  uint4 raw = __ldg(reinterpret_cast<const uint4*>(src));
  const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int i = 0; i < Vec16<T>::n; ++i) dst[i] = to_f32(e[i]) * mul;
}

// Asynchronous copies global -> shared (cp.async, sm_80+): 16 bytes (the
// L2-only .cg path) or 4 bytes, or that many zero bytes when !pred (src
// is then not read but must be a valid address). A thread's copies
// complete in the groups it commits, oldest first; wait<N> returns once
// at most N of its groups are still in flight.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src), "r"(pred ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool pred) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src), "r"(pred ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__global__ void probe_kernel(const float* __restrict__ x,
                             float* __restrict__ o, int n) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) o[i] = x[i] + x[i];
}

}  // namespace pt

#define PT_DEFINE_PROBE(lib)                                              \
  extern "C" int lib##_probe(const void* x, void* o, int n,               \
                             void* stream) {                              \
    pt::probe_kernel<<<(n + 255) / 256, 256, 0,                           \
                       static_cast<cudaStream_t>(stream)>>>(              \
        static_cast<const float*>(x), static_cast<float*>(o), n);         \
    return static_cast<int>(cudaGetLastError());                          \
  }
