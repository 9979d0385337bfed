// Ragged paged attention for NVIDIA Hopper (sm_90a): the tensor-core wide
// form (wide_wgmma.cuh) for a bf16 or f16 q over pages of its own type,
// e4m3 or e5m2 at every head dim past FMA_WIDTH (256) that is a multiple
// of 16.  A fourth translation unit of the ragged library, so that nvcc
// builds it beside the others.

#include "wide_wgmma.cuh"

namespace tpulab {

int ragged_wgmma_wide(int qc, int kv, const void* q, const void* pool,
                      const int* tables, const int* q_lens,
                      const int* kv_lens, void* out, void* scratch, int B,
                      int M, int Hq, int Hkv, int D, int P, int S, int MP,
                      int n_split, float sm_scale, cudaStream_t st) {
  return wwg::launch_paged(qc, kv, q, pool, tables, q_lens, kv_lens, out,
                           scratch, B, M, Hq, Hkv, D, P, S, MP, n_split,
                           sm_scale, st);
}

}  // namespace tpulab

// The tensor-core wide kernel's attributes for q code `qc` (1 bf16, 2
// f16) over page code `kv` (1 bf16, 2 e4m3, 3 e5m2, 4 f16; the pairs the
// form takes) at head dim `d`: registers a thread, dynamic shared memory
// bytes and local memory bytes a thread into out[0..2].  0, a cudaError_t
// code, or -1 for a pair the form does not take.
extern "C" int tpulab_ragged_wgmma_wide_attributes(int qc, int kv, int d,
                                                   int* out) {
  return tpulab::with_q_type(qc, [&](auto qt) {
    return tpulab::with_kv_type(kv, [&](auto kt) {
      using E = typename decltype(qt)::type;
      using KVT = typename decltype(kt)::type;
      if constexpr (tpulab::tensor_core_pair<E, KVT>) {
        return tpulab::wwg::attributes(
            tpulab::wwg::paged_wgmma_wide_kernel<E, KVT>, d, out);
      }
      return -1;
    });
  });
}
