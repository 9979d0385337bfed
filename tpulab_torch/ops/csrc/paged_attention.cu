// Paged single-query decode attention for NVIDIA Hopper (sm_90a): the
// library's C interface and the forms compiled for their head dim exactly
// (D 16, 32, 64, 128 and 256).  The kernel, and what it replaces and
// computes, is in paged_attention.cuh; the padded forms in
// paged_attention_padded.cu, the wide form (every D past 256) in
// paged_attention_wide.cu.

#include "paged_attention.cuh"

// C interface (bound with ctypes).  q (B, Hq, D) and out contiguous;
// pool (P, 2, S, Hkv, D) contiguous and 16-byte aligned; tables (B, MP)
// and lengths (B,) int32; q_code q's dtype code (0 f32, 1 bf16, 2 f16),
// kv the pool's (0 f32, 1 bf16, 2 e4m3, 3 e5m2, 4 f16).  n_split splits
// over each lane's context and, when n_split > 1, f32 scratch of
// n_split * B * Hq * (D + 2) values, one more when n_split * B * Hq * D
// is odd (the (m, l) pairs start at an even offset).  n_split is the
// wrapper's: `paged_splits` for the ring body (D <= 256), `wide_splits`
// for the wide form.  Any group size Hq / Hkv; any D >= 1.  Returns 0 or
// a cudaError_t code; -1 for a head dim or dtype the kernel is not built
// for.
extern "C" int tpulab_paged_decode_attention(
    const void* q, const void* pool, const int* tables, const int* lengths,
    void* out, void* scratch, int B, int Hq, int Hkv, int D, int P, int S,
    int MP, int n_split, int q_code, int kv, float sm_scale,
    void* stream) {
  if (B == 0) return 0;
  if (Hkv <= 0 || Hq % Hkv) return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16:
      return launch_d<16>(q_code, kv, q, pool, tables, lengths, out,
                          scratch, B, Hq, Hkv, P, S, MP, n_split, sm_scale, st);
    case 32:
      return launch_d<32>(q_code, kv, q, pool, tables, lengths, out,
                          scratch, B, Hq, Hkv, P, S, MP, n_split, sm_scale, st);
    case 64:
      return launch_d<64>(q_code, kv, q, pool, tables, lengths, out,
                          scratch, B, Hq, Hkv, P, S, MP, n_split, sm_scale, st);
    case 128:
      return launch_d<128>(q_code, kv, q, pool, tables, lengths, out,
                           scratch, B, Hq, Hkv, P, S, MP, n_split, sm_scale,
                           st);
    case 256:
      return launch_d<256>(q_code, kv, q, pool, tables, lengths, out,
                           scratch, B, Hq, Hkv, P, S, MP, n_split, sm_scale,
                           st);
    default:
      if (D > FMA_WIDTH)
        return paged_wide(q_code, kv, q, pool, tables, lengths, out, scratch,
                          B, Hq, Hkv, D, P, S, MP, n_split, sm_scale, st);
      return paged_padded(q_code, kv, q, pool, tables, lengths, out, scratch,
                          B, Hq, Hkv, D, P, S, MP, n_split, sm_scale, st);
  }
}
