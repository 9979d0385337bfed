// Flash attention forward for NVIDIA Hopper (sm_90a): every head dim
// past FMA_WIDTH (256), on the wide form of wide_attention.cuh, for f32,
// bf16 and f16.  A second translation unit of the flash library, so that
// nvcc builds it beside flash_attention.cu.

#include "wide_attention.cuh"

namespace tpulab {

int flash_wide(int q_code, const void* q, const void* k, const void* v,
               void* out, int B, int T, int H, int D, const long long* st,
               int causal, float sm_scale, cudaStream_t s) {
  return with_q_type(q_code, [&](auto tag) {
    using T16 = typename decltype(tag)::type;
    return wide::launch_dense<T16>(q, k, v, out, B, T, H, D, st, causal,
                                   sm_scale, s);
  });
}

}  // namespace tpulab

// The wide kernel's attributes for dtype code `q_code` (0 f32, 1 bf16, 2
// f16): registers a thread, dynamic shared memory bytes and local memory
// bytes a thread into out[0..2].  0, a cudaError_t code, or -1 for an
// unknown code.
extern "C" int tpulab_flash_wide_attributes(int q_code, int* out) {
  return tpulab::with_q_type(q_code, [&](auto tag) {
    using T = typename decltype(tag)::type;
    return tpulab::wide::attributes(tpulab::wide::dense_wide_kernel<T>,
                                    tpulab::wide::Geometry<T>::smem_bytes,
                                    out);
  });
}
