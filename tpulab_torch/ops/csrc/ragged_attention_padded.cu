// Ragged paged attention for NVIDIA Hopper (sm_90a): the forms at head
// dims the kernel is not compiled for exactly (ragged_attention.cuh says
// how each is laid out).  A second translation unit of the ragged
// library, so that nvcc builds it beside ragged_attention.cu.

#include "ragged_attention.cuh"

namespace tpulab {

int ragged_tc_padded(int qc, int kv, const void* q, const void* pool,
                     const int* tables, const int* q_lens, const int* kv_lens,
                     void* out, void* scratch, int B, int M, int Hq, int Hkv,
                     int D, int P, int S, int MP, int n_split, float sm_scale,
                     cudaStream_t st) {
  if (D != 80 && D != 96 && D != 112) return -1;
  return with_q_type(qc, [&](auto qt) {
    return with_kv_type(kv, [&](auto kt) {
      using E = typename decltype(qt)::type;
      using KVT = typename decltype(kt)::type;
      if constexpr (tensor_core_pair<E, KVT>) {
        return tc::launch<128, E, KVT, true>(
            q, pool, tables, q_lens, kv_lens, out, scratch, B, M, Hq, Hkv, P,
            S, MP, n_split, sm_scale, D, st);
      }
      return -1;
    });
  });
}

int ragged_fma_padded(int qc, int kv, const void* q, const void* pool,
                      const int* tables, const int* q_lens,
                      const int* kv_lens, void* out, int B, int M, int Hq,
                      int Hkv, int D, int P, int S, int MP, float sm_scale,
                      cudaStream_t st) {
  return with_padded_width(D, [&](auto w) {
    return launch_d<decltype(w)::value, true>(qc, kv, q, pool, tables,
                                              q_lens, kv_lens, out, B, M, Hq,
                                              Hkv, P, S, MP, sm_scale, st, D);
  });
}

}  // namespace tpulab
