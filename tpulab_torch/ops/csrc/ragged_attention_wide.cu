// Ragged paged attention for NVIDIA Hopper (sm_90a): every head dim past
// FMA_WIDTH (256), on the wide form of wide_attention.cuh.  A third
// translation unit of the ragged library, so that nvcc builds it beside
// ragged_attention.cu.

#include "wide_attention.cuh"

namespace tpulab {

int ragged_wide(int qc, int kv, const void* q, const void* pool,
                const int* tables, const int* q_lens, const int* kv_lens,
                void* out, void* scratch, int B, int M, int Hq, int Hkv,
                int D, int P, int S, int MP, int n_split, float sm_scale,
                cudaStream_t st) {
  return wide::launch_paged(qc, kv, q, pool, tables, q_lens, kv_lens, out,
                            scratch, B, M, Hq, Hkv, D, P, S, MP, n_split,
                            sm_scale, st);
}

}  // namespace tpulab

// The wide kernel's attributes for page code `kv` (0 f32, 1 bf16, 2 e4m3,
// 3 e5m2, 4 f16): registers a thread, dynamic shared memory bytes and
// local memory bytes a thread into out[0..2].  0, a cudaError_t code, or
// -1 for an unknown code.
extern "C" int tpulab_ragged_wide_attributes(int kv, int* out) {
  return tpulab::with_kv_type(kv, [&](auto kt) {
    using KVT = typename decltype(kt)::type;
    return tpulab::wide::attributes(tpulab::wide::paged_wide_kernel<KVT>,
                                    tpulab::wide::Geometry<KVT>::smem_bytes,
                                    out);
  });
}
