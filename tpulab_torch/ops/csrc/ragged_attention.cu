// Ragged paged attention for NVIDIA Hopper (sm_90a): the library's C
// interface and the forms compiled for their head dim exactly (the
// tensor-core body at D 64 and 128, the fma body at D 16, 32, 64, 128 and
// 256).  The kernels, and what they replace and compute, are in
// ragged_attention.cuh; the padded forms in ragged_attention_padded.cu,
// the tensor-core body at D 144-256 in ragged_attention_wgmma_256.cu,
// the wide forms (every D past 256) in ragged_attention_wide.cu and
// ragged_attention_wgmma_wide.cu.

#include "ragged_attention.cuh"

namespace {

using namespace tpulab;

// The tensor-core body for q code `qc` over page code `kv` (only the
// pairs of `tensor_core_pair`) at D 64 or 128; D 80, 96 and 112 run the
// 128-wide tile (`ragged_tc_padded`), D 144 to 256 the 192- and 256-wide
// tiles (`ragged_tc_256`).
int launch_tc(int qc, int kv, const void* q, const void* pool,
              const int* tables, const int* q_lens, const int* kv_lens,
              void* out, void* scratch, int B, int M, int Hq, int Hkv, int D,
              int P, int S, int MP, int n_split, float sm_scale,
              cudaStream_t st) {
  if (D > 128)
    return ragged_tc_256(qc, kv, q, pool, tables, q_lens, kv_lens, out,
                         scratch, B, M, Hq, Hkv, D, P, S, MP, n_split,
                         sm_scale, st);
  if (D != 64 && D != 128)
    return ragged_tc_padded(qc, kv, q, pool, tables, q_lens, kv_lens, out,
                            scratch, B, M, Hq, Hkv, D, P, S, MP, n_split,
                            sm_scale, st);
  return with_q_type(qc, [&](auto qt) {
    return with_kv_type(kv, [&](auto kt) {
      using E = typename decltype(qt)::type;
      using KVT = typename decltype(kt)::type;
      if constexpr (tensor_core_pair<E, KVT>) {
        if (D == 64)
          return tc::launch<64, E, KVT, false>(
              q, pool, tables, q_lens, kv_lens, out, scratch, B, M, Hq, Hkv,
              P, S, MP, n_split, sm_scale, D, st);
        return tc::launch<128, E, KVT, false>(
            q, pool, tables, q_lens, kv_lens, out, scratch, B, M, Hq, Hkv, P,
            S, MP, n_split, sm_scale, D, st);
      }
      return -1;
    });
  });
}

}  // namespace

// C interface (bound with ctypes).  q_code is q's dtype code (0 f32, 1
// bf16, 2 f16), kv the pool's (0 f32, 1 bf16, 2 e4m3, 3 e5m2, 4 f16).
// body 1 is the tensor-core body (a bf16 or f16 q over pages of its own
// type, e4m3 or e5m2, every D from 64 to 256 that is a multiple of 16)
// with `n_split` splits over the context and, when n_split > 1, f32
// scratch of n_split * B * M * Hq * (D + 2) values; body 0 the CUDA-core
// body (every other mix at those head dims, and every mix at any other D
// from 1 to 256; n_split 1); body 2 the wide fma form (every mix at every D past 256,
// wide_attention.cuh) and body 3 the tensor-core wide form (the pairs of
// body 1 at every D past 256 that is a multiple of 16, wide_wgmma.cuh),
// each with `n_split` splits and, when n_split > 1, f32 scratch of n_split
// * B * M * Hq * D values, one more when that count is odd, then n_split *
// B * M * Hq (m, l) pairs.  Returns 0 or a cudaError_t code; -1 for a body,
// dtype pair and head dim the kernel is not built for.
extern "C" int tpulab_ragged_paged_attention(
    const void* q, const void* pool, const int* tables, const int* q_lens,
    const int* kv_lens, void* out, void* scratch, int B, int M, int Hq,
    int Hkv, int D, int P, int S, int MP, int q_code, int kv, int body,
    int n_split, float sm_scale, void* stream) {
  if (B == 0 || M == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (body == 1)
    return launch_tc(q_code, kv, q, pool, tables, q_lens, kv_lens, out,
                     scratch, B, M, Hq, Hkv, D, P, S, MP, n_split, sm_scale,
                     st);
  if (body == 3)
    return ragged_wgmma_wide(q_code, kv, q, pool, tables, q_lens, kv_lens,
                             out, scratch, B, M, Hq, Hkv, D, P, S, MP,
                             n_split, sm_scale, st);
  if (body == 2)
    return ragged_wide(q_code, kv, q, pool, tables, q_lens, kv_lens, out,
                       scratch, B, M, Hq, Hkv, D, P, S, MP, n_split, sm_scale,
                       st);
  if (body != 0 || n_split != 1) return -1;
  switch (D) {
    case 16:
      return launch_d<16>(q_code, kv, q, pool, tables, q_lens, kv_lens,
                          out, B, M, Hq, Hkv, P, S, MP, sm_scale, st);
    case 32:
      return launch_d<32>(q_code, kv, q, pool, tables, q_lens, kv_lens,
                          out, B, M, Hq, Hkv, P, S, MP, sm_scale, st);
    case 64:
      return launch_d<64>(q_code, kv, q, pool, tables, q_lens, kv_lens,
                          out, B, M, Hq, Hkv, P, S, MP, sm_scale, st);
    case 128:
      return launch_d<128>(q_code, kv, q, pool, tables, q_lens, kv_lens,
                           out, B, M, Hq, Hkv, P, S, MP, sm_scale, st);
    case 256:
      return launch_d<256>(q_code, kv, q, pool, tables, q_lens, kv_lens,
                           out, B, M, Hq, Hkv, P, S, MP, sm_scale, st);
    default:
      return ragged_fma_padded(q_code, kv, q, pool, tables, q_lens, kv_lens,
                               out, B, M, Hq, Hkv, D, P, S, MP, sm_scale,
                               st);
  }
}
