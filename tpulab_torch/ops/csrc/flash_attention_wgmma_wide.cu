// Flash attention forward for NVIDIA Hopper (sm_90a): the tensor-core wide
// form (wide_wgmma.cuh) for bf16 and f16 at every head dim past
// FMA_WIDTH (256) that is a multiple of 16.  A third translation unit of
// the flash library, so that nvcc builds it beside the others.

#include "wide_wgmma.cuh"

namespace tpulab {

int flash_wgmma_wide(int q_code, const void* q, const void* k, const void* v,
                     void* out, int B, int T, int H, int D,
                     const long long* st, int causal, float sm_scale,
                     cudaStream_t s) {
  return with_q_type(q_code, [&](auto tag) {
    using E = typename decltype(tag)::type;
    if constexpr (std::is_same<E, float>::value) {
      return -1;
    } else {
      return wwg::launch_dense<E>(q, k, v, out, B, T, H, D, st, causal,
                                  sm_scale, s);
    }
  });
}

}  // namespace tpulab

// The tensor-core wide kernel's attributes for dtype code `q_code` (1
// bf16, 2 f16) at head dim `d`: registers a thread, dynamic shared memory
// bytes and local memory bytes a thread into out[0..2].  0, a cudaError_t
// code, or -1 for f32 or an unknown code.
extern "C" int tpulab_flash_wgmma_wide_attributes(int q_code, int d,
                                                  int* out) {
  return tpulab::with_q_type(q_code, [&](auto tag) {
    using E = typename decltype(tag)::type;
    if constexpr (std::is_same<E, float>::value) {
      return -1;
    } else {
      return tpulab::wwg::attributes(tpulab::wwg::dense_wgmma_wide_kernel<E>,
                                     d, out);
    }
  });
}
