// Device helpers shared by the port's kernels (each kernel's .cu file is
// compiled on its own into its own library and includes this header).
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>
#include <type_traits>

namespace tpulab {

constexpr int MAX_DEVICES = 64;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f(__half x) { return __half2float(x); }

// fp8 pages.  Every e4m3 and every e5m2 value, NaN and inf included, is an
// f16 value, a bf16 value and an f32 value, so fp8 -> f16 -> f32 is exact:
// e4m3 -> f16 is one `cvt` for a pair on sm_90, and an e5m2 byte is the
// high byte of its f16 (same sign, exponent and bias; two mantissa bits
// of ten), so a pair is one byte permute.
using e4m3 = __nv_fp8_e4m3;
using e5m2 = __nv_fp8_e5m2;

// Two fp8 values, the first in the low byte of `pair`, as the bits of an
// f16 pair (the first in the low half).
template <typename F8>
__device__ __forceinline__ uint32_t fp8x2_to_h2bits(uint32_t pair);
template <>
__device__ __forceinline__ uint32_t fp8x2_to_h2bits<e4m3>(uint32_t pair) {
  const __half2_raw h = __nv_cvt_fp8x2_to_halfraw2(
      static_cast<__nv_fp8x2_storage_t>(pair & 0xFFFFu), __NV_E4M3);
  return static_cast<uint32_t>(h.x) | (static_cast<uint32_t>(h.y) << 16);
}
template <>
__device__ __forceinline__ uint32_t fp8x2_to_h2bits<e5m2>(uint32_t pair) {
  return __byte_perm(pair, 0u, 0x1404);   // bytes {0, b0, 0, b1}
}
// Two fp8 values, the first in the low byte, as f32.
template <typename F8>
__device__ __forceinline__ float2 fp8x2_to_float2(uint32_t pair) {
  const uint32_t bits = fp8x2_to_h2bits<F8>(pair);
  return __half22float2(*reinterpret_cast<const __half2*>(&bits));
}
__device__ __forceinline__ float to_f(e4m3 x) {
  return __half2float(__half(__nv_cvt_fp8_to_halfraw(x.__x, __NV_E4M3)));
}
__device__ __forceinline__ float to_f(e5m2 x) {
  return __half2float(__half(__nv_cvt_fp8_to_halfraw(x.__x, __NV_E5M2)));
}

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(
    float x) {
  return __float2bfloat16(x);
}
template <> __device__ __forceinline__ __half from_f<__half>(float x) {
  return __float2half_rn(x);
}

// The host side's element types by the launchers' dtype codes: q (0 f32,
// 1 bf16, 2 f16) and pages (0 f32, 1 bf16, 2 e4m3, 3 e5m2, 4 f16).  `f`
// is called with a Tag of the type; an unknown code returns -1.
template <typename T>
struct Tag {
  using type = T;
};
template <class F>
int with_q_type(int code, F&& f) {
  switch (code) {
    case 0: return f(Tag<float>{});
    case 1: return f(Tag<__nv_bfloat16>{});
    case 2: return f(Tag<__half>{});
    default: return -1;
  }
}
template <class F>
int with_kv_type(int code, F&& f) {
  switch (code) {
    case 0: return f(Tag<float>{});
    case 1: return f(Tag<__nv_bfloat16>{});
    case 2: return f(Tag<e4m3>{});
    case 3: return f(Tag<e5m2>{});
    case 4: return f(Tag<__half>{});
    default: return -1;
  }
}
// q over pages on the tensor cores in q's 16-bit type: bf16 or f16 q
// over pages of its own type or fp8 (each upcast to q's type exactly).
template <typename QT, typename KVT>
constexpr bool tensor_core_pair =
    (std::is_same<QT, __nv_bfloat16>::value ||
     std::is_same<QT, __half>::value) &&
    (std::is_same<KVT, QT>::value || sizeof(KVT) == 1);

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

// N consecutive values from shared memory as f32 (N 1 or even; the
// address aligned to N values, up to 16 bytes).  N 1 is one output dim a
// lane of a P.V at D 16 or 32.
template <int N>
__device__ __forceinline__ void load_vals(const float* p, float* out) {
  if constexpr (N == 1) {
    out[0] = *p;
  } else if constexpr (N % 4 == 0) {
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
__device__ __forceinline__ float2 to_float2(__nv_bfloat162 x) {
  return __bfloat1622float2(x);
}
__device__ __forceinline__ float2 to_float2(__half2 x) {
  return __half22float2(x);
}

// N consecutive 16-bit values (bf16 or f16; H2 the pair type) as f32 (N
// even; the address aligned to N values, up to 16 bytes).
template <int N, typename H2>
__device__ __forceinline__ void load_vals16(const void* p, float* out) {
  const H2* h2 = reinterpret_cast<const H2*>(p);
  if constexpr (N % 8 == 0) {
#pragma unroll
    for (int i = 0; i < N; i += 8) {
      uint4 raw = *reinterpret_cast<const uint4*>(h2 + i / 2);
      const H2* h = reinterpret_cast<const H2*>(&raw);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float2 f = to_float2(h[j]);
        out[i + 2 * j] = f.x;
        out[i + 2 * j + 1] = f.y;
      }
    }
  } else if constexpr (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N; i += 4) {
      uint2 raw = *reinterpret_cast<const uint2*>(h2 + i / 2);
      const H2* h = reinterpret_cast<const H2*>(&raw);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        float2 f = to_float2(h[j]);
        out[i + 2 * j] = f.x;
        out[i + 2 * j + 1] = f.y;
      }
    }
  } else {
    static_assert(N % 2 == 0, "16-bit loads come in pairs");
#pragma unroll
    for (int i = 0; i < N; i += 2) {
      float2 f = to_float2(h2[i / 2]);
      out[i] = f.x;
      out[i + 1] = f.y;
    }
  }
}
template <int N>
__device__ __forceinline__ void load_vals(const __nv_bfloat16* p,
                                          float* out) {
  if constexpr (N == 1)
    out[0] = to_f(*p);
  else
    load_vals16<N, __nv_bfloat162>(p, out);
}
template <int N>
__device__ __forceinline__ void load_vals(const __half* p, float* out) {
  if constexpr (N == 1)
    out[0] = to_f(*p);
  else
    load_vals16<N, __half2>(p, out);
}

// N fp8 values (N even; the address aligned to N values, up to 16).
template <int N, typename F8>
__device__ __forceinline__ void load_vals8(const F8* p, float* out) {
  constexpr int W = N % 16 == 0 ? 16 : N % 8 == 0 ? 8 : N % 4 == 0 ? 4 : 2;
  static_assert(N % 2 == 0, "fp8 loads come in pairs");
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
      const float2 f = fp8x2_to_float2<F8>(w[j / 2] >> (16 * (j % 2)));
      out[i + 2 * j] = f.x;
      out[i + 2 * j + 1] = f.y;
    }
  }
}
template <int N>
__device__ __forceinline__ void load_vals(const e4m3* p, float* out) {
  if constexpr (N == 1)
    out[0] = to_f(*p);
  else
    load_vals8<N>(p, out);
}
template <int N>
__device__ __forceinline__ void load_vals(const e5m2* p, float* out) {
  if constexpr (N == 1)
    out[0] = to_f(*p);
  else
    load_vals8<N>(p, out);
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
