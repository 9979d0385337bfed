// Device helpers shared by the port's kernels (each kernel's .cu file is
// compiled on its own into its own library and includes this header).
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>
#include <initializer_list>
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
// One `w`-byte chunk (w 16, 8, 4, 2 or 1; both addresses aligned to w)
// from global to shared memory, zeros when !valid: cp.async for 4 bytes
// and more (its zero fill reads nothing), a plain load and store below.
// The rows of a head dim whose row bytes are not a multiple of 16 (D 100
// in bf16, D 24 in fp8) are copied in the widest chunks they allow.
__device__ __forceinline__ void copy_chunk(void* smem, const void* gmem,
                                           int w, bool valid) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const int n = valid ? w : 0;
  if (w == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
                 "l"(gmem), "r"(n));
  } else if (w == 8) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(s),
                 "l"(gmem), "r"(n));
  } else if (w == 4) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
                 "l"(gmem), "r"(n));
  } else if (w == 2) {
    *static_cast<uint16_t*>(smem) =
        valid ? *static_cast<const uint16_t*>(gmem) : uint16_t(0);
  } else {
    *static_cast<uint8_t*>(smem) =
        valid ? *static_cast<const uint8_t*>(gmem) : uint8_t(0);
  }
}
// The chunks of a padded fma body's rows: `rows` rows of `row_bytes`
// each in chunks of `cw` bytes, chunk c by thread c % `nthreads` (this
// one `tid`), which calls f(row, the chunk's byte offset in the row) to
// copy that chunk of the row's K and V.  Every thread makes the same
// number of calls when `nthreads` divides `rows`.
template <typename F>
__device__ __forceinline__ void for_row_chunks(int rows, int row_bytes,
                                               int cw, int tid, int nthreads,
                                               F f) {
  const int cpw = row_bytes / cw;
  for (int c = tid; c < rows * cpw; c += nthreads) f(c / cpw, c % cpw * cw);
}
// The widest chunk (16, 8, 4, 2 or 1 bytes) that divides every value of
// `v` (byte offsets: a base address, strides, a row's bytes).
inline int copy_width(std::initializer_list<unsigned long long> v) {
  int w = 16;
  for (unsigned long long x : v)
    while (x % w) w /= 2;
  return w;
}
// Zero `bytes` (a multiple of 16) of shared memory from `p` (16-byte
// aligned), by `nthreads` threads of which this is `tid`.
__device__ __forceinline__ void zero_smem(void* p, size_t bytes, int tid,
                                          int nthreads) {
  uint4* q = static_cast<uint4*>(p);
  for (size_t i = tid; i < bytes / 16; i += nthreads)
    q[i] = make_uint4(0u, 0u, 0u, 0u);
}

// The fma bodies' shared-memory width for a head dim from 1 to FMA_WIDTH
// that none of them is compiled for exactly (D 16, 32, 64, 128 and 256
// are): the next of 32, 64, 128 and 256.  Columns from D to the width stay
// zero in shared memory and are never stored.  Past FMA_WIDTH every head
// dim runs the wide form instead (wide_attention.cuh).
constexpr int FMA_WIDTH = 256;
inline int padded_width(int d) {
  return d <= 32 ? 32 : d <= 64 ? 64 : d <= 128 ? 128 : FMA_WIDTH;
}
// The tensor-core bodies' tile width (kernels 1 and 2) for a head dim
// that is a multiple of 16 from 64 to 256: 64, 128, 192 or 256, the head
// dim's columns past it zero in shared memory; 0 for any other head dim.
inline int wgmma_width(int d) {
  if (d % 16 || d < 64 || d > 256) return 0;
  return d == 64 ? 64 : d <= 128 ? 128 : d <= 192 ? 192 : 256;
}
// A kernel's registers a thread, the dynamic shared memory `smem` it is
// launched with and its local memory a thread into out[0..2]; 0 or a
// cudaError_t code.
template <class Kern>
int kernel_attributes(Kern kern, size_t smem, int* out) {
  cudaFuncAttributes a;
  if (cudaError_t e = cudaFuncGetAttributes(&a, kern)) return (int)e;
  out[0] = a.numRegs;
  out[1] = (int)smem;
  out[2] = (int)a.localSizeBytes;
  return 0;
}
// q's element type taken at run time (its launcher code: 0 f32, 1 bf16,
// 2 f16): the padded fma bodies of kernels 1 and 3 read q once and write
// their output once, so one instantiation serves the three q types.
struct AnyQ {};
// Element i of q (type QT, or AnyQ with code qc) as f32, and the store
// of an f32 value into element i of an output of that type.
template <typename QT>
__device__ __forceinline__ float q_load(const QT* p, size_t i, int qc) {
  if constexpr (std::is_same<QT, AnyQ>::value) {
    const void* v = p;
    return qc == 0   ? static_cast<const float*>(v)[i]
           : qc == 1 ? to_f(static_cast<const __nv_bfloat16*>(v)[i])
                     : to_f(static_cast<const __half*>(v)[i]);
  } else {
    return to_f(p[i]);
  }
}
template <typename QT>
__device__ __forceinline__ void q_store(QT* p, size_t i, int qc, float x) {
  if constexpr (std::is_same<QT, AnyQ>::value) {
    void* v = p;
    if (qc == 0)
      static_cast<float*>(v)[i] = x;
    else if (qc == 1)
      static_cast<__nv_bfloat16*>(v)[i] = from_f<__nv_bfloat16>(x);
    else
      static_cast<__half*>(v)[i] = from_f<__half>(x);
  } else {
    p[i] = from_f<QT>(x);
  }
}
// Call `f` with a compile-time padded width (an integral constant); -1
// for a head dim outside 1 to FMA_WIDTH.
template <class F>
int with_padded_width(int d, F&& f) {
  if (d < 1 || d > FMA_WIDTH) return -1;
  switch (padded_width(d)) {
    case 32: return f(std::integral_constant<int, 32>{});
    case 64: return f(std::integral_constant<int, 64>{});
    case 128: return f(std::integral_constant<int, 128>{});
    default: return f(std::integral_constant<int, FMA_WIDTH>{});
  }
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
// Weak: every translation unit of a library that includes this header
// defines it, and the link keeps one.
extern "C" __attribute__((weak)) const char* tpulab_cuda_error_string(
    int code) {
  return code < 0 ? "not built for this body, dtype or shape"
                  : cudaGetErrorString(static_cast<cudaError_t>(code));
}
