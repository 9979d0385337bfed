// TMA tensor maps over a strided 16-bit (B, T, H, D) view, for the flash
// kernel's tensor-core bodies (flash_attention.cu, wide_wgmma.cuh):
// libcuda's cuTensorMapEncodeTiled, looked up through the CUDA runtime's
// entry-point query, so nothing links -lcuda.
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>

namespace tpulab {
namespace tma {
namespace {

// cuTensorMapEncodeTiled, looked up through the CUDA runtime's entry-point
// query (no -lcuda at link time).
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

inline EncodeTiled encode_fn() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult st = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &st);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                            cudaEnableDefault, &st);
#endif
    return (e == cudaSuccess && st == cudaDriverEntryPointSuccess)
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// A 4-d map {D, H, T, B} over a strided 16-bit (B, T, H, D) view of TMA
// data type `dt` (bf16 or f16); the box is 64 columns x 1 head x 64 rows x
// 1, swizzled 128B; rows past T and columns past D read 0.
inline int make_map(CUtensorMap* map, CUtensorMapDataType dt, const void* base,
             int B, int Tlen, int H, int D, long long sb, long long st,
             long long sh) {
  EncodeTiled fn = encode_fn();
  if (!fn) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)Tlen,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)sh * 2, (cuuint64_t)st * 2,
                                 (cuuint64_t)sb * 2};
  const cuuint32_t box[4] = {64, 1, 64, 1};
  const cuuint32_t estr[4] = {1, 1, 1, 1};
  CUresult r = fn(map, dt, 4,
                  const_cast<void*>(base), dims, strides, box, estr,
                  CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

}  // namespace
}  // namespace tma
}  // namespace tpulab
