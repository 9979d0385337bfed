// Device helpers shared by the port's kernels (each kernel's .cu file is
// compiled on its own into its own library and includes this header).
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace tpulab {

constexpr int MAX_DEVICES = 64;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// e4m3 pages.  Every e4m3 value, NaN included, is an f16 value and an f32
// value, so e4m3 -> f16 (one `cvt` for a pair on sm_90) -> f32 is exact.
using e4m3 = __nv_fp8_e4m3;

// Two e4m3 values, the first in the low byte, as f32.
__device__ __forceinline__ float2 e4m3x2_to_float2(uint32_t pair) {
  const __half2_raw h = __nv_cvt_fp8x2_to_halfraw2(
      static_cast<__nv_fp8x2_storage_t>(pair & 0xFFFFu), __NV_E4M3);
  return __half22float2(__half2(h));
}
__device__ __forceinline__ float to_f(e4m3 x) {
  return __half2float(__half(__nv_cvt_fp8_to_halfraw(x.__x, __NV_E4M3)));
}

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(
    float x) {
  return __float2bfloat16(x);
}

// 16-byte global->shared async copy; src_bytes == 0 zero-fills the chunk
// without reading global memory.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int src_bytes) {
  uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_1() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::);
}

// N consecutive values from shared memory as f32 (N even; the address
// aligned to N values, up to 16 bytes).
template <int N>
__device__ __forceinline__ void load_vals(const float* p, float* out) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N; i += 4) {
      float4 r = *reinterpret_cast<const float4*>(p + i);
      out[i] = r.x;
      out[i + 1] = r.y;
      out[i + 2] = r.z;
      out[i + 3] = r.w;
    }
  } else {
    static_assert(N % 2 == 0, "f32 loads come in pairs");
#pragma unroll
    for (int i = 0; i < N; i += 2) {
      float2 r = *reinterpret_cast<const float2*>(p + i);
      out[i] = r.x;
      out[i + 1] = r.y;
    }
  }
}
template <int N>
__device__ __forceinline__ void load_vals(const __nv_bfloat16* p,
                                          float* out) {
  if constexpr (N % 8 == 0) {
#pragma unroll
    for (int i = 0; i < N; i += 8) {
      uint4 raw = *reinterpret_cast<const uint4*>(p + i);
      const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float2 f = __bfloat1622float2(h[j]);
        out[i + 2 * j] = f.x;
        out[i + 2 * j + 1] = f.y;
      }
    }
  } else if constexpr (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N; i += 4) {
      uint2 raw = *reinterpret_cast<const uint2*>(p + i);
      const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        float2 f = __bfloat1622float2(h[j]);
        out[i + 2 * j] = f.x;
        out[i + 2 * j + 1] = f.y;
      }
    }
  } else {
    static_assert(N % 2 == 0, "bf16 loads come in pairs");
#pragma unroll
    for (int i = 0; i < N; i += 2) {
      float2 f = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(p + i));
      out[i] = f.x;
      out[i + 1] = f.y;
    }
  }
}

// N e4m3 values (N even; the address aligned to N values, up to 16).
template <int N>
__device__ __forceinline__ void load_vals(const e4m3* p, float* out) {
  constexpr int W = N % 16 == 0 ? 16 : N % 8 == 0 ? 8 : N % 4 == 0 ? 4 : 2;
  static_assert(N % 2 == 0, "e4m3 loads come in pairs");
#pragma unroll
  for (int i = 0; i < N; i += W) {
    uint32_t w[W / 4 > 0 ? W / 4 : 1];
    if constexpr (W == 16) {
      const uint4 r = *reinterpret_cast<const uint4*>(p + i);
      w[0] = r.x, w[1] = r.y, w[2] = r.z, w[3] = r.w;
    } else if constexpr (W == 8) {
      const uint2 r = *reinterpret_cast<const uint2*>(p + i);
      w[0] = r.x, w[1] = r.y;
    } else if constexpr (W == 4) {
      w[0] = *reinterpret_cast<const uint32_t*>(p + i);
    } else {
      w[0] = *reinterpret_cast<const uint16_t*>(p + i);
    }
#pragma unroll
    for (int j = 0; j < W / 2; ++j) {
      const float2 f = e4m3x2_to_float2(w[j / 2] >> (16 * (j % 2)));
      out[i + 2 * j] = f.x;
      out[i + 2 * j + 1] = f.y;
    }
  }
}

// Opt a kernel into `smem` bytes of dynamic shared memory on the current
// device, once per device: `done` is the caller's per-instantiation flag
// array (a function-local static).  Returns 0 or a cudaError_t code.
template <typename Kernel>
inline int enable_smem(Kernel kern, size_t smem,
                       std::atomic<bool> (&done)[MAX_DEVICES]) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev < MAX_DEVICES && done[dev].load(std::memory_order_acquire))
    return 0;
  e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
  if (e != cudaSuccess) return (int)e;
  if (dev < MAX_DEVICES) done[dev].store(true, std::memory_order_release);
  return 0;
}

}  // namespace tpulab

// Each library's error text for a launch's return code: -1 means a body,
// dtype or shape the kernel is not built for, anything else a cudaError_t.
extern "C" const char* tpulab_cuda_error_string(int code) {
  return code < 0 ? "not built for this body, dtype or shape"
                  : cudaGetErrorString(static_cast<cudaError_t>(code));
}
