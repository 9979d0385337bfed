// Ragged paged attention for NVIDIA Hopper (sm_90a): the tensor-core body
// on its 192- and 256-wide tiles, for a bf16 or f16 q over pages of its
// own type, e4m3 or e5m2 at every head dim from 144 to 256 that is a
// multiple of 16 (Gemma-2-9B's, Gemma-7B's and GPT-J's 256).  A unit of
// its own of the ragged library, so that nvcc builds it beside the
// others; the kernel and its layout are in ragged_attention.cuh.

#include "ragged_attention.cuh"

namespace tpulab {

int ragged_tc_256(int qc, int kv, const void* q, const void* pool,
                  const int* tables, const int* q_lens, const int* kv_lens,
                  void* out, void* scratch, int B, int M, int Hq, int Hkv,
                  int D, int P, int S, int MP, int n_split, float sm_scale,
                  cudaStream_t st) {
  const int w = wgmma_width(D);
  if (w != 192 && w != 256) return -1;
  return with_q_type(qc, [&](auto qt) {
    return with_kv_type(kv, [&](auto kt) {
      using E = typename decltype(qt)::type;
      using KVT = typename decltype(kt)::type;
      if constexpr (tensor_core_pair<E, KVT>) {
        auto run = [&](auto width, auto pad) {
          return tc::launch<decltype(width)::value, E, KVT,
                            decltype(pad)::value>(
              q, pool, tables, q_lens, kv_lens, out, scratch, B, M, Hq, Hkv,
              P, S, MP, n_split, sm_scale, D, st);
        };
        using W192 = std::integral_constant<int, 192>;
        using W256 = std::integral_constant<int, 256>;
        if (w == 192)
          return D == 192 ? run(W192{}, std::false_type{})
                          : run(W192{}, std::true_type{});
        return D == 256 ? run(W256{}, std::false_type{})
                        : run(W256{}, std::true_type{});
      }
      return -1;
    });
  });
}

}  // namespace tpulab

// The tensor-core body's attributes for q code `qc` (1 bf16, 2 f16) over
// page code `kv` (q's own type, e4m3 or e5m2) at head dim `d` (a multiple
// of 16 from 144 to 256): registers a thread, dynamic shared memory bytes
// and local memory bytes a thread into out[0..2].  0, a cudaError_t code,
// or -1 for another pair or head dim.
extern "C" int tpulab_ragged_wgmma_attributes(int qc, int kv, int d,
                                              int* out) {
  using namespace tpulab;
  const int w = wgmma_width(d);
  if (w < 192) return -1;
  return with_q_type(qc, [&](auto qt) {
    return with_kv_type(kv, [&](auto kt) {
      using E = typename decltype(qt)::type;
      using KVT = typename decltype(kt)::type;
      if constexpr (tensor_core_pair<E, KVT>) {
        const bool pad = d != w;
        if (w == 192)
          return kernel_attributes(
              pad ? tc::ragged_attn_wgmma_kernel<192, E, KVT, true>
                  : tc::ragged_attn_wgmma_kernel<192, E, KVT, false>,
              tc::Smem<192, KVT>::bytes, out);
        return kernel_attributes(
            pad ? tc::ragged_attn_wgmma_kernel<256, E, KVT, true>
                : tc::ragged_attn_wgmma_kernel<256, E, KVT, false>,
            tc::Smem<256, KVT>::bytes, out);
      }
      return -1;
    });
  });
}
