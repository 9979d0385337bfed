// Paged single-query decode attention for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_paged_attn` / `_paged_attn_kernel`
// (tpulab/ops/paged_attention.py:221 and :76): one query token per lane
// attends its own block table of KV pages in the fused (P, 2, S, Hkv, D)
// pool, MHA or grouped-query.
//
// What it computes.  lengths[b] is the lane's CURRENT POSITION, inclusive
// (not a count, unlike the ragged kernel's kv_lens): positions
// 0..lengths[b] are visible.  Pages are walked while p * S <= lengths[b];
// positions past lengths[b] are never read (their shared-memory rows are
// zero-filled and lie past every loop bound), so a dead page holding inf
// or NaN cannot leak into the output.  q is scaled by 1/sqrt(D) in f32
// before the dot; softmax is online in f32; the output is acc / max(l,
// 1e-30) in q's dtype.  Every product is an f32 FMA (no TF32).
//
// What bounds it on an H100.  At 8 lanes x 1024 positions, Hkv 8, D 128,
// bf16, a call must read 33.6 MB of K/V for ~0.13 GFLOP: it is bound by
// bytes (~10 us at 3.35 TB/s).
//
// What the design does about it.  One block per (KV head, lane); the GQA
// group's Hq/Hkv query heads are the block's rows, so each K/V row is
// read from device memory once per group.  The walk stages KT positions
// (32 KB of K and 32 KB of V) per step in shared memory with cp.async,
// double-buffered, and splits every stage over the block's 8 warps: each
// warp keeps its own running (max, normaliser, accumulator) over its
// share of the positions, and the warps' partial results are merged once
// at the end.  Within a warp, a lane scores one (position, head) pair at
// a time and owns D/32 output dims of every head for P.V.  The TPU
// kernel's g_pages / nbuf (pages per DMA block, pipeline depth) are VMEM
// geometry and have no counterpart here; split-KV across blocks for few
// lanes and long contexts is later work.

#include "common.cuh"

namespace {

using namespace tpulab;

constexpr int NWARPS = 8;
constexpr int MAXG = 8;          // largest GQA group (query heads per KV head)
constexpr float NEG = -1e30f;

template <typename KVT, int D>
struct Geometry {
  static constexpr int EPC = 16 / sizeof(KVT);   // elements per 16B chunk
  static constexpr int CPR = D / EPC;            // chunks per K or V row
  static constexpr int LD = D + EPC;             // padded K/V row stride
  static constexpr int KT = 32768 / (D * (int)sizeof(KVT));  // per stage
  static constexpr int PW = KT / NWARPS;         // positions per warp
  static constexpr int DPL = D / 32;             // output dims per lane
  static constexpr int QLD = D + 4;              // padded query row stride
  static constexpr size_t kv_bytes = sizeof(KVT) * 2 * 2 * KT * LD;
  static constexpr size_t q_bytes = sizeof(float) * MAXG * QLD;
  static constexpr size_t s_bytes = sizeof(float) * NWARPS * PW * MAXG;
  // the end-of-walk merge reuses the K/V area
  static constexpr size_t merge_bytes =
      sizeof(float) * NWARPS * MAXG * (D + 2);
  static_assert(merge_bytes <= kv_bytes, "merge area must fit");
  static constexpr size_t smem_bytes = kv_bytes + q_bytes + s_bytes;
};

template <typename QT, typename KVT, int D>
__global__ void __launch_bounds__(NWARPS * 32)
    paged_decode_kernel(const QT* __restrict__ q,
                        const KVT* __restrict__ pool,
                        const int* __restrict__ tables,
                        const int* __restrict__ lengths, QT* __restrict__ out,
                        int Hq, int Hkv, int P, int S, int MP,
                        float sm_scale) {
  using Geo = Geometry<KVT, D>;
  constexpr int EPC = Geo::EPC, CPR = Geo::CPR, LD = Geo::LD, KT = Geo::KT;
  constexpr int PW = Geo::PW, DPL = Geo::DPL, QLD = Geo::QLD;

  const int hk = blockIdx.x, b = blockIdx.y;
  const int G = Hq / Hkv;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  // positions 0..lengths[b] are visible; the walk stops at the table's end
  const int n_pos = max(0, min(lengths[b] + 1, MP * S));
  const int n_stages = (n_pos + KT - 1) / KT;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  KVT* ks = reinterpret_cast<KVT*>(smem_raw);                  // [2][KT][LD]
  KVT* vs = ks + 2 * KT * LD;                                  // [2][KT][LD]
  float* qs = reinterpret_cast<float*>(smem_raw + Geo::kv_bytes);  // [MAXG][QLD]
  float* ss = qs + MAXG * QLD;                                 // [NWARPS][PW][MAXG]
  float* sw = ss + warp * PW * MAXG;                           // this warp's

  const int* tab = tables + (size_t)b * MP;
  auto load_stage = [&](int stage, int buf) {
    const int t0 = stage * KT;
    for (int c = threadIdx.x; c < 2 * KT * CPR; c += NWARPS * 32) {
      const int kv = c / (KT * CPR);
      const int rem = c % (KT * CPR);
      const int t = rem / CPR, ch = rem % CPR;
      const int pos = t0 + t;
      const bool valid = pos < n_pos;
      const KVT* src = pool;
      if (valid) {
        const int page = min(max(tab[pos / S], 0), P - 1);
        src = pool + ((((size_t)page * 2 + kv) * S + pos % S) * Hkv + hk) * D +
              ch * EPC;
      }
      KVT* dst = (kv ? vs : ks) + ((size_t)buf * KT + t) * LD + ch * EPC;
      cp_async16(dst, src, valid ? 16 : 0);
    }
  };

  if (n_stages > 0) load_stage(0, 0);
  cp_async_commit();

  for (int idx = threadIdx.x; idx < G * D; idx += NWARPS * 32) {
    const int g = idx / D, d = idx % D;
    qs[g * QLD + d] =
        to_f(q[((size_t)b * Hq + hk * G + g) * D + d]) * sm_scale;
  }

  float m_r[MAXG], l_r[MAXG], acc[MAXG][DPL];
#pragma unroll
  for (int g = 0; g < MAXG; ++g) {
    m_r[g] = NEG;
    l_r[g] = 0.f;
#pragma unroll
    for (int x = 0; x < DPL; ++x) acc[g][x] = 0.f;
  }

  for (int s = 0; s < n_stages; ++s) {
    const int buf = s & 1;
    if (s + 1 < n_stages) load_stage(s + 1, buf ^ 1);
    cp_async_commit();       // (possibly empty) group keeps wait_group 1 exact
    cp_async_wait_1();
    __syncthreads();         // stage s landed (and, at s == 0, the queries)
    const int w0 = warp * PW;                         // this warp's share
    const int nv = min(PW, n_pos - (s * KT + w0));    // its visible positions
    if (nv > 0) {                                     // warp-uniform
      const KVT* kb = ks + ((size_t)buf * KT + w0) * LD;
      const KVT* vb = vs + ((size_t)buf * KT + w0) * LD;
      // scores: one (position, head) pair per lane at a time
      for (int pr = lane; pr < nv * G; pr += 32) {
        const int t = pr / G, g = pr % G;
        const float* qr = qs + g * QLD;
        const KVT* kr = kb + t * LD;
        float a = 0.f;
#pragma unroll 4
        for (int d = 0; d < D; d += EPC) {
          float kf[EPC], qf[EPC];
          load_vals<EPC>(kr + d, kf);
          load_vals<EPC>(qr + d, qf);
#pragma unroll
          for (int e = 0; e < EPC; ++e) a = fmaf(qf[e], kf[e], a);
        }
        sw[t * MAXG + g] = a;
      }
      __syncwarp();
      // new running max per head; rescale what came before
#pragma unroll
      for (int g = 0; g < MAXG; ++g) {
        if (g >= G) break;
        float mx = NEG;
        for (int t = 0; t < nv; ++t) mx = fmaxf(mx, sw[t * MAXG + g]);
        const float m_new = fmaxf(m_r[g], mx);
        const float alpha = expf(m_r[g] - m_new);
        m_r[g] = m_new;
        l_r[g] *= alpha;
#pragma unroll
        for (int x = 0; x < DPL; ++x) acc[g][x] *= alpha;
      }
      __syncwarp();
      // weights, one pair per lane at a time
      for (int pr = lane; pr < nv * G; pr += 32) {
        const int t = pr / G, g = pr % G;
        float mg = m_r[0];
#pragma unroll
        for (int gg = 1; gg < MAXG; ++gg)
          if (gg == g) mg = m_r[gg];
        sw[t * MAXG + g] = expf(sw[t * MAXG + g] - mg);
      }
      __syncwarp();
      // l += sum p; acc += p * V on this lane's dims
      for (int t = 0; t < nv; ++t) {
        float vf[DPL];
        load_vals<DPL>(vb + t * LD + lane * DPL, vf);
#pragma unroll
        for (int g = 0; g < MAXG; ++g) {
          if (g >= G) break;
          const float p = sw[t * MAXG + g];
          l_r[g] += p;
#pragma unroll
          for (int x = 0; x < DPL; ++x) acc[g][x] = fmaf(p, vf[x], acc[g][x]);
        }
      }
      __syncwarp();          // sw is rewritten next stage
    }
    __syncthreads();         // buffer `buf` is refilled by stage s + 2
  }
  cp_async_wait_all();
  __syncthreads();           // every warp is done with the K/V area

  // merge the warps' partial softmax states
  float* cm = reinterpret_cast<float*>(smem_raw);   // [NWARPS][MAXG]
  float* cl = cm + NWARPS * MAXG;                   // [NWARPS][MAXG]
  float* ca = cl + NWARPS * MAXG;                   // [NWARPS][MAXG][D]
#pragma unroll
  for (int g = 0; g < MAXG; ++g) {
    if (g >= G) break;
    if (lane == 0) {
      cm[warp * MAXG + g] = m_r[g];
      cl[warp * MAXG + g] = l_r[g];
    }
#pragma unroll
    for (int x = 0; x < DPL; ++x)
      ca[((size_t)warp * MAXG + g) * D + lane * DPL + x] = acc[g][x];
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < G * D; idx += NWARPS * 32) {
    const int g = idx / D, d = idx % D;
    float m = NEG;
#pragma unroll
    for (int w = 0; w < NWARPS; ++w) m = fmaxf(m, cm[w * MAXG + g]);
    float l = 0.f, o = 0.f;
#pragma unroll
    for (int w = 0; w < NWARPS; ++w) {
      const float sc = expf(cm[w * MAXG + g] - m);
      l += cl[w * MAXG + g] * sc;
      o += ca[((size_t)w * MAXG + g) * D + d] * sc;
    }
    out[((size_t)b * Hq + hk * G + g) * D + d] = from_f<QT>(o / fmaxf(l, 1e-30f));
  }
}

template <typename QT, typename KVT, int D>
int launch(const void* q, const void* pool, const int* tables,
           const int* lengths, void* out, int B, int Hq, int Hkv, int P,
           int S, int MP, float sm_scale, cudaStream_t stream) {
  const size_t smem = Geometry<KVT, D>::smem_bytes;
  auto kern = paged_decode_kernel<QT, KVT, D>;
  static std::atomic<bool> smem_set[MAX_DEVICES];
  if (int e = enable_smem(kern, smem, smem_set)) return e;
  if (B > 65535) return (int)cudaErrorInvalidConfiguration;
  dim3 grid(Hkv, B);
  kern<<<grid, NWARPS * 32, smem, stream>>>(
      static_cast<const QT*>(q), static_cast<const KVT*>(pool), tables,
      lengths, static_cast<QT*>(out), Hq, Hkv, P, S, MP, sm_scale);
  return (int)cudaGetLastError();
}

template <int D>
int launch_d(int q_bf16, int kv_bf16, const void* q, const void* pool,
             const int* tables, const int* lengths, void* out, int B, int Hq,
             int Hkv, int P, int S, int MP, float sm_scale, cudaStream_t st) {
  using bf = __nv_bfloat16;
  if (q_bf16 && kv_bf16)
    return launch<bf, bf, D>(q, pool, tables, lengths, out, B, Hq, Hkv, P, S,
                             MP, sm_scale, st);
  if (q_bf16)
    return launch<bf, float, D>(q, pool, tables, lengths, out, B, Hq, Hkv, P,
                                S, MP, sm_scale, st);
  if (kv_bf16)
    return launch<float, bf, D>(q, pool, tables, lengths, out, B, Hq, Hkv, P,
                                S, MP, sm_scale, st);
  return launch<float, float, D>(q, pool, tables, lengths, out, B, Hq, Hkv,
                                 P, S, MP, sm_scale, st);
}

}  // namespace

// C interface (bound with ctypes).  q (B, Hq, D) and out contiguous;
// pool (P, 2, S, Hkv, D) contiguous; tables (B, MP) and lengths (B,)
// int32.  Returns 0 or a cudaError_t code; -1 for a head dim or group
// size the kernel is not built for.
extern "C" int tpulab_paged_decode_attention(
    const void* q, const void* pool, const int* tables, const int* lengths,
    void* out, int B, int Hq, int Hkv, int D, int P, int S, int MP,
    int q_bf16, int kv_bf16, float sm_scale, void* stream) {
  if (B == 0) return 0;
  if (Hkv <= 0 || Hq % Hkv || Hq / Hkv > MAXG) return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64:
      return launch_d<64>(q_bf16, kv_bf16, q, pool, tables, lengths, out, B,
                          Hq, Hkv, P, S, MP, sm_scale, st);
    case 128:
      return launch_d<128>(q_bf16, kv_bf16, q, pool, tables, lengths, out, B,
                           Hq, Hkv, P, S, MP, sm_scale, st);
    case 256:
      return launch_d<256>(q_bf16, kv_bf16, q, pool, tables, lengths, out, B,
                           Hq, Hkv, P, S, MP, sm_scale, st);
    default:
      return -1;
  }
}
