// Ragged paged attention for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_ragged_attn` / `_ragged_attn_kernel`
// (tpulab/ops/ragged_attention.py:190 and :59), the one attention kernel
// of the ragged serving plan: decode (q_len 1), K+1 verify and chunked
// prefill, in any mix within one batch.
//
// What it computes.  Lane b holds q_lens[b] left-packed query rows; row j
// sits at position kv_lens[b] - q_lens[b] + j and attends every position
// <= its own through the lane's block table over the fused page pool
// (P, 2, S, Hkv, D).  Softmax is online, in f32; q is scaled by 1/sqrt(D)
// before the dot.  Rows j >= q_lens[b] (and lanes with kv_lens == 0) are
// written as zeros; no position >= kv_lens[b] ever enters a sum (its
// shared-memory row is zero-filled and lies past every row's loop bound).
// There is no TF32 anywhere: every product is an f32 FMA on CUDA cores.
//
// What bounds it on an H100.  At decode (8 lanes x 1024 context, Hkv 8,
// D 128, bf16) a layer must read 33.6 MB of K/V for ~0.13 GFLOP: it is
// bound by bytes (~10 us at 3.35 TB/s).  A 256-token prefill chunk over
// 1024 context is ~34 GFLOP: bound by operations (~35 us at the bf16
// tensor-core peak).
//
// What the design does about it.  One block per (query-row tile, KV head,
// lane).  The GQA group's Hq/Hkv query heads are packed into the tile's
// rows, so each K/V row is read from device memory once per group and
// not once per query head (the bandwidth point of the compact Hkv
// layout).  A block walks the lane's positions only up to the last one
// its rows can see, KT positions per stage, staging K and V rows in
// shared memory with cp.async, double-buffered so the next stage's loads
// are in flight while this stage computes.  Each warp owns whole query
// rows: for QK^T a lane owns one key of the stage, for P.V a lane owns
// D/32 output dims.  This is the simple, right first kernel: it leaves
// the bf16 tensor cores (wgmma), TMA and split-KV for long contexts at
// small batch to later work, so prefill runs far from its bound.

#include "common.cuh"

namespace {

using namespace tpulab;

constexpr int KT = 32;              // key positions per stage (one per lane)
constexpr int NWARPS = 8;
constexpr int ROWS_PER_WARP = 4;
constexpr int TILE_ROWS = NWARPS * ROWS_PER_WARP;   // query rows per block
constexpr float NEG = -1e30f;

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename KVT, int D>
struct Geometry {
  static constexpr int EPC = 16 / sizeof(KVT);  // elements per 16B chunk
  static constexpr int CPR = D / EPC;           // chunks per K or V row
  static constexpr int LD = D + EPC;            // padded smem row stride
  static constexpr int DPL = D / 32;            // output dims per lane
  static constexpr size_t kv_bytes = 2ull * 2 * KT * LD * sizeof(KVT);
  static constexpr size_t smem_bytes =
      kv_bytes + sizeof(float) * TILE_ROWS * D;
};

template <typename QT, typename KVT, int D>
__global__ void __launch_bounds__(NWARPS * 32)
    ragged_attn_kernel(const QT* __restrict__ q, const KVT* __restrict__ pool,
                       const int* __restrict__ tables,
                       const int* __restrict__ q_lens,
                       const int* __restrict__ kv_lens, QT* __restrict__ out,
                       int M, int Hq, int Hkv, int P, int S, int MP,
                       float sm_scale) {
  using Geo = Geometry<KVT, D>;
  constexpr int EPC = Geo::EPC, CPR = Geo::CPR, LD = Geo::LD;
  constexpr int DPL = Geo::DPL;

  const int tile = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int G = Hq / Hkv;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int qn = q_lens[b], kvn = kv_lens[b];
  const int start = kvn - qn;                 // position of query row 0
  const int row0 = tile * TILE_ROWS;
  const int rows_total = M * G;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  KVT* ks = reinterpret_cast<KVT*>(smem_raw);       // [2][KT][LD]
  KVT* vs = ks + 2 * KT * LD;                       // [2][KT][LD]
  float* qs = reinterpret_cast<float*>(smem_raw + Geo::kv_bytes);  // [TILE_ROWS][D]

  // keys [0, limit) are all this tile's rows can see
  const int j_lo = row0 / G;
  const int j_last = min(min((row0 + TILE_ROWS - 1) / G, M - 1), qn - 1);
  int limit = 0;
  if (j_last >= j_lo) limit = min(start + j_last + 1, kvn);
  limit = max(0, min(limit, MP * S));
  const int n_stages = (limit + KT - 1) / KT;

  for (int idx = threadIdx.x; idx < TILE_ROWS * D; idx += blockDim.x) {
    const int i = idx / D, d = idx % D;
    const int r = row0 + i, j = r / G, g = r % G;
    float v = 0.f;
    if (r < rows_total && j < qn)
      v = to_f(q[(((size_t)b * M + j) * Hq + hk * G + g) * D + d]) * sm_scale;
    qs[idx] = v;
  }

  const int* tab = tables + (size_t)b * MP;
  auto load_stage = [&](int stage, int buf) {
    const int t0 = stage * KT;
    for (int c = threadIdx.x; c < 2 * KT * CPR; c += blockDim.x) {
      const int kv = c / (KT * CPR);
      const int rem = c % (KT * CPR);
      const int t = rem / CPR, ch = rem % CPR;
      const int pos = t0 + t;
      const bool valid = pos < limit;
      const KVT* src = pool;
      if (valid) {
        const int page = min(max(tab[pos / S], 0), P - 1);
        const int slot = pos % S;
        src = pool + ((((size_t)page * 2 + kv) * S + slot) * Hkv + hk) * D +
              ch * EPC;
      }
      KVT* dst = (kv ? vs : ks) + ((size_t)buf * KT + t) * LD + ch * EPC;
      cp_async16(dst, src, valid ? 16 : 0);
    }
  };

  float m_r[ROWS_PER_WARP], l_r[ROWS_PER_WARP], acc[ROWS_PER_WARP][DPL];
#pragma unroll
  for (int k = 0; k < ROWS_PER_WARP; ++k) {
    m_r[k] = NEG;
    l_r[k] = 0.f;
#pragma unroll
    for (int x = 0; x < DPL; ++x) acc[k][x] = 0.f;
  }

  if (n_stages > 0) load_stage(0, 0);
  cp_async_commit();
  for (int s = 0; s < n_stages; ++s) {
    const int buf = s & 1;
    if (s + 1 < n_stages) load_stage(s + 1, buf ^ 1);
    cp_async_commit();       // (possibly empty) group keeps wait_group 1 exact
    cp_async_wait_1();
    __syncthreads();
    const KVT* kb = ks + (size_t)buf * KT * LD;
    const KVT* vb = vs + (size_t)buf * KT * LD;
    const int t0 = s * KT;
#pragma unroll
    for (int k = 0; k < ROWS_PER_WARP; ++k) {
      const int i = k * NWARPS + warp;       // interleaved: decode rows
      const int r = row0 + i, j = r / G;     // spread over warps
      if (r >= rows_total || j >= qn) continue;          // warp-uniform
      int nvis = min(start + j + 1, limit) - t0;         // keys this row sees
      if (nvis <= 0) continue;                           // warp-uniform
      nvis = min(nvis, KT);

      float sc = NEG;
      if (lane < nvis) {
        const float* qr = qs + i * D;
        const KVT* kr = kb + lane * LD;
        float a = 0.f;
#pragma unroll
        for (int d = 0; d < D; d += EPC) {
          float kv8[EPC];
          load_vals<EPC>(kr + d, kv8);
#pragma unroll
          for (int e = 0; e < EPC; ++e) a = fmaf(qr[d + e], kv8[e], a);
        }
        sc = a;
      }
      const float m_new = fmaxf(m_r[k], warp_max(sc));
      const float alpha = expf(m_r[k] - m_new);
      const float p = lane < nvis ? expf(sc - m_new) : 0.f;
      l_r[k] = l_r[k] * alpha + warp_sum(p);
      m_r[k] = m_new;
#pragma unroll
      for (int x = 0; x < DPL; ++x) acc[k][x] *= alpha;
      for (int t = 0; t < nvis; ++t) {
        const float pt = __shfl_sync(0xffffffffu, p, t);
        const KVT* vr = vb + t * LD + lane * DPL;
#pragma unroll
        for (int x = 0; x < DPL; ++x) acc[k][x] = fmaf(pt, to_f(vr[x]), acc[k][x]);
      }
    }
    __syncthreads();         // buffer `buf` is refilled by stage s + 2
  }
  cp_async_wait_all();

#pragma unroll
  for (int k = 0; k < ROWS_PER_WARP; ++k) {
    const int i = k * NWARPS + warp;
    const int r = row0 + i;
    if (r >= rows_total) continue;
    const int j = r / G, g = r % G;
    QT* o = out + (((size_t)b * M + j) * Hq + hk * G + g) * D + lane * DPL;
    const float inv = 1.f / fmaxf(l_r[k], 1e-30f);
#pragma unroll
    for (int x = 0; x < DPL; ++x)
      o[x] = from_f<QT>(j < qn ? acc[k][x] * inv : 0.f);
  }
}

template <typename QT, typename KVT, int D>
int launch(const void* q, const void* pool, const int* tables,
           const int* q_lens, const int* kv_lens, void* out, int B, int M,
           int Hq, int Hkv, int P, int S, int MP, float sm_scale,
           cudaStream_t stream) {
  const size_t smem = Geometry<KVT, D>::smem_bytes;
  auto kern = ragged_attn_kernel<QT, KVT, D>;
  static std::atomic<bool> smem_set[MAX_DEVICES];
  if (int e = enable_smem(kern, smem, smem_set)) return e;
  const int G = Hq / Hkv;
  dim3 grid((M * G + TILE_ROWS - 1) / TILE_ROWS, Hkv, B);
  kern<<<grid, NWARPS * 32, smem, stream>>>(
      static_cast<const QT*>(q), static_cast<const KVT*>(pool), tables,
      q_lens, kv_lens, static_cast<QT*>(out), M, Hq, Hkv, P, S, MP,
      sm_scale);
  return (int)cudaGetLastError();
}

template <int D>
int launch_d(int q_bf16, int kv_bf16, const void* q, const void* pool,
             const int* tables, const int* q_lens, const int* kv_lens,
             void* out, int B, int M, int Hq, int Hkv, int P, int S, int MP,
             float sm_scale, cudaStream_t st) {
  using bf = __nv_bfloat16;
  if (q_bf16 && kv_bf16)
    return launch<bf, bf, D>(q, pool, tables, q_lens, kv_lens, out, B, M,
                             Hq, Hkv, P, S, MP, sm_scale, st);
  if (q_bf16)
    return launch<bf, float, D>(q, pool, tables, q_lens, kv_lens, out, B, M,
                                Hq, Hkv, P, S, MP, sm_scale, st);
  if (kv_bf16)
    return launch<float, bf, D>(q, pool, tables, q_lens, kv_lens, out, B, M,
                                Hq, Hkv, P, S, MP, sm_scale, st);
  return launch<float, float, D>(q, pool, tables, q_lens, kv_lens, out, B,
                                 M, Hq, Hkv, P, S, MP, sm_scale, st);
}

}  // namespace

// C interface (bound with ctypes).  Returns 0 or a cudaError_t code; -1
// for a head dim the kernel is not built for.
extern "C" int tpulab_ragged_paged_attention(
    const void* q, const void* pool, const int* tables, const int* q_lens,
    const int* kv_lens, void* out, int B, int M, int Hq, int Hkv, int D,
    int P, int S, int MP, int q_bf16, int kv_bf16, float sm_scale,
    void* stream) {
  if (B == 0 || M == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64:
      return launch_d<64>(q_bf16, kv_bf16, q, pool, tables, q_lens, kv_lens,
                          out, B, M, Hq, Hkv, P, S, MP, sm_scale, st);
    case 128:
      return launch_d<128>(q_bf16, kv_bf16, q, pool, tables, q_lens,
                           kv_lens, out, B, M, Hq, Hkv, P, S, MP, sm_scale,
                           st);
    case 256:
      return launch_d<256>(q_bf16, kv_bf16, q, pool, tables, q_lens,
                           kv_lens, out, B, M, Hq, Hkv, P, S, MP, sm_scale,
                           st);
    default:
      return -1;
  }
}
