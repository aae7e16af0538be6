// Shared helpers for the hand-written kernels of ray_tpu_torch.
//
// Each kernel source is its own shared library with a plain C interface
// (loaded with ctypes); every C entry point launches on the caller's
// stream and returns cudaGetLastError() so the Python wrapper can raise.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace rt {

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Round a float through T and back (the JAX kernels' `.astype(v.dtype)`
// before a product).
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_float(from_float<T>(x));
}

// Load N consecutive elements of T starting at p (N * sizeof(T) bytes,
// aligned to that size) as floats, with one vector load.
template <typename T, int N>
struct VecLoad;

template <>
struct VecLoad<__nv_bfloat16, 2> {
  __device__ __forceinline__ static void run(const __nv_bfloat16* p,
                                             float* out) {
    __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(p);
    out[0] = __low2float(v);
    out[1] = __high2float(v);
  }
};
template <>
struct VecLoad<__nv_bfloat16, 4> {
  __device__ __forceinline__ static void run(const __nv_bfloat16* p,
                                             float* out) {
    uint2 raw = *reinterpret_cast<const uint2*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
    out[0] = __low2float(h[0]);
    out[1] = __high2float(h[0]);
    out[2] = __low2float(h[1]);
    out[3] = __high2float(h[1]);
  }
};
template <>
struct VecLoad<float, 2> {
  __device__ __forceinline__ static void run(const float* p, float* out) {
    float2 v = *reinterpret_cast<const float2*>(p);
    out[0] = v.x;
    out[1] = v.y;
  }
};
template <>
struct VecLoad<float, 4> {
  __device__ __forceinline__ static void run(const float* p, float* out) {
    float4 v = *reinterpret_cast<const float4*>(p);
    out[0] = v.x;
    out[1] = v.y;
    out[2] = v.z;
    out[3] = v.w;
  }
};

}  // namespace rt

extern "C" const char* rt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
