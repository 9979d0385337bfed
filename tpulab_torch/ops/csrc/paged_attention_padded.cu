// Paged single-query decode attention for NVIDIA Hopper (sm_90a): any
// head dim up to FMA_WIDTH (256) the body is not compiled for exactly, on
// the next width of 32, 64, 128 and 256 (paged_attention.cuh says how).  A second
// translation unit of the paged library, so that nvcc builds it beside
// paged_attention.cu.

#include "paged_attention.cuh"

namespace tpulab {

int paged_padded(int qc, int kv, const void* q, const void* pool,
                 const int* tables, const int* lengths, void* out,
                 void* scratch, int B, int Hq, int Hkv, int D, int P, int S,
                 int MP, int n_split, float sm_scale, cudaStream_t st) {
  return with_padded_width(D, [&](auto w) {
    return launch_d<decltype(w)::value, true>(qc, kv, q, pool, tables,
                                              lengths, out, scratch, B, Hq,
                                              Hkv, P, S, MP, n_split,
                                              sm_scale, st, D);
  });
}

}  // namespace tpulab
