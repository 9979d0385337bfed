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
// (P, 2, S, Hkv, D), whose pages are f32, bf16 or e4m3 (tpulab's pool may
// store a narrower dtype than the compute path: the Pallas body upcasts
// the pages it reads, :150-151, and so does every body here; e4m3 -> bf16
// and -> f32 are exact).  Softmax is online, in f32.  Rows j >= q_lens[b] (and
// lanes with kv_lens == 0) are written as zeros; no position >= kv_lens[b]
// is ever read (a dead page may hold NaN).  There is no TF32 anywhere.
//
// What bounds it on an H100.  At decode (8 lanes x 1024 context, Hkv 8,
// D 128, bf16) a layer must read 33.6 MB of K/V for ~0.13 GFLOP: it is
// bound by bytes (~10 us at 3.35 TB/s), and one block per (KV head, lane)
// is only 64 blocks for 132 SMs.  A 256-token prefill chunk over 1024
// context is ~34 GFLOP: bound by operations (~35 us at the bf16
// tensor-core peak).
//
// Every body packs the GQA group's Hq/Hkv query heads into a tile's rows
// (row = j * G + g), so each K/V row is read once per group and not once
// per query head.  The caller names the body and the split count
// (ragged_attention.py `ragged_body`, `ragged_splits`, functions of dtype
// and shapes only); the launcher refuses a body that does not fit.
//
// * `ragged_attn_wgmma_kernel<D, KVT>`, bf16 q over a bf16 or e4m3 pool,
//   D 64 or 128:
//   one warpgroup per (64-row tile, KV head, lane, split), latest rows
//   first.  The Q tile and 64-key stages of K and V are gathered page by
//   page with cp.async into the 128-byte-swizzled layout of
//   attn_wgmma.cuh, double-buffered; a position past the last one the
//   tile's rows see is zero-filled without a read, and the page index is
//   clamped to [0, P).  Each stage is the shared tile step: S = Q K^T and
//   O += P V on `wgmma`, P in bf16 from registers, online softmax in f32
//   (scores scaled after the product; P to bf16 is the one rounding the
//   plain version does not make).  An e4m3 pool's stages land raw (D
//   bytes a row) in a double-buffered staging ring instead; after the
//   wait one pass turns each 16-byte e4m3 chunk into the two 16-byte bf16
//   chunks of the swizzled K or V tile (one tile each: the next stage is
//   still in the ring), and the step is the bf16 one.  No fp8 `wgmma`:
//   it takes both operands in fp8, so Q would be rounded to e4m3, which
//   tpulab never does.  Staging costs 2 x 64 x D bytes a buffer, the bf16
//   second K/V buffer it replaces: shared memory stays 5 tiles.
// * Split-KV, for launches whose tiles do not fill the card (decode and
//   verify: M * G <= 64 rows): the grid gains a split axis, and split i of
//   n walks stages [i * n_st / n, (i + 1) * n_st / n) of the tile's own
//   walk.  Each split writes f32 partials (unnormalised O, m in log2
//   units, l) to scratch, and `ragged_attn_merge_kernel` combines them in
//   split order: no atomics, so a launch is bit-reproducible.  With one
//   split the tile writes the output directly.
// * `ragged_attn_kernel<QT, KVT, D>`, f32 q over any pool, bf16 over f32,
//   and bf16 over bf16 or e4m3 with D 256: every product an f32 FMA on
//   CUDA cores (a chunk is 16 bytes: 4, 8 or 16 values), q scaled
//   by 1/sqrt(D) before the dot.  One block per (32-row tile, KV head,
//   lane); KT positions per stage through a cp.async double buffer; each
//   warp owns whole query rows, a lane one key of QK^T and D/32 output
//   dims of P.V.

#include "attn_wgmma.cuh"
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

// kv: the pool's dtype code (0 f32, 1 bf16, 2 e4m3).  bf16 q over a bf16
// or e4m3 pool runs here at D 256 only (D 64 and 128 run the tensor-core
// body).
template <int D>
int launch_d(int q_bf16, int kv, const void* q, const void* pool,
             const int* tables, const int* q_lens, const int* kv_lens,
             void* out, int B, int M, int Hq, int Hkv, int P, int S, int MP,
             float sm_scale, cudaStream_t st) {
  using bf = __nv_bfloat16;
  if (q_bf16 && kv) {
    if constexpr (D == 256) {
      if (kv == 1)
        return launch<bf, bf, D>(q, pool, tables, q_lens, kv_lens, out, B, M,
                                 Hq, Hkv, P, S, MP, sm_scale, st);
      if (kv == 2)
        return launch<bf, e4m3, D>(q, pool, tables, q_lens, kv_lens, out, B,
                                   M, Hq, Hkv, P, S, MP, sm_scale, st);
    }
    return -1;
  }
  if (q_bf16)
    return launch<bf, float, D>(q, pool, tables, q_lens, kv_lens, out, B, M,
                                Hq, Hkv, P, S, MP, sm_scale, st);
  if (kv == 1)
    return launch<float, bf, D>(q, pool, tables, q_lens, kv_lens, out, B, M,
                                Hq, Hkv, P, S, MP, sm_scale, st);
  if (kv == 2)
    return launch<float, e4m3, D>(q, pool, tables, q_lens, kv_lens, out, B,
                                  M, Hq, Hkv, P, S, MP, sm_scale, st);
  if (kv != 0) return -1;
  return launch<float, float, D>(q, pool, tables, q_lens, kv_lens, out, B,
                                 M, Hq, Hkv, P, S, MP, sm_scale, st);
}

// ---------------------------------------------------------------- wgmma
namespace tc {

constexpr int BQ = 64;          // query rows per block: one warpgroup
constexpr int NTHREADS = 128;

template <int D, typename KVT>
struct Smem {
  static constexpr int TILE = wg::AttnTile<D>::TILE_BYTES;
  static constexpr bool kE4M3 = sizeof(KVT) == 1;
  static constexpr int Q = 0;                  // [TILE]
  // bf16 pool: K and V tiles double-buffered.  e4m3 pool: one K and one
  // V tile, and the staging ring of raw stages behind them.
  static constexpr int K = TILE;               // [2][TILE] / [TILE]
  static constexpr int V = kE4M3 ? 2 * TILE : 3 * TILE;
  static constexpr int STG = 3 * TILE;         // e4m3: [2][K, V][64][D] bytes
  static constexpr int STG_BUF = 2 * 64 * D;   // one staged stage, K then V
  static constexpr size_t bytes = 5 * TILE + 1024;   // + alignment
  static_assert(!kE4M3 || STG + 2 * STG_BUF <= 5 * TILE,
                "the staging ring fits the second K/V buffer's room");
};

// One staged e4m3 stage (K rows, then V rows; D bytes a row) into the
// swizzled bf16 K and V tiles: 16 e4m3 values -> two 16-byte bf16 chunks.
template <int D>
__device__ __forceinline__ void e4m3_stage_to_tiles(const unsigned char* stg,
                                                    unsigned char* k_tile,
                                                    unsigned char* v_tile) {
  constexpr int BK = wg::AttnTile<D>::BK;
  constexpr int CPR8 = D / 16;                  // 16-byte e4m3 chunks a row
  for (int c = threadIdx.x; c < 2 * BK * CPR8; c += NTHREADS) {
    const int kv = c / (BK * CPR8), rem = c % (BK * CPR8);
    const int t = rem / CPR8, ch = rem % CPR8;
    const uint4 raw =
        *reinterpret_cast<const uint4*>(stg + (kv * BK + t) * D + ch * 16);
    const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
    uint32_t o[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 f = e4m3x2_to_float2(w[j / 2] >> (16 * (j % 2)));
      o[j] = wg::pack_bf16(f.x, f.y);
    }
    unsigned char* tile = kv ? v_tile : k_tile;
    *reinterpret_cast<uint4*>(tile + wg::swz(t, 2 * ch, BK)) =
        make_uint4(o[0], o[1], o[2], o[3]);
    *reinterpret_cast<uint4*>(tile + wg::swz(t, 2 * ch + 1, BK)) =
        make_uint4(o[4], o[5], o[6], o[7]);
  }
}

template <int D, typename KVT>
__global__ void __launch_bounds__(NTHREADS)
    ragged_attn_wgmma_kernel(const __nv_bfloat16* __restrict__ q,
                             const KVT* __restrict__ pool,
                             const int* __restrict__ tables,
                             const int* __restrict__ q_lens,
                             const int* __restrict__ kv_lens,
                             __nv_bfloat16* __restrict__ out,
                             float* __restrict__ part_o,
                             float* __restrict__ part_ml, int B, int M,
                             int Hq, int Hkv, int P, int S, int MP,
                             int n_split, float scale_log2) {
  using Tile = wg::AttnTile<D>;
  using L = Smem<D, KVT>;
  constexpr int BK = Tile::BK;
  constexpr int CPR = D / 8;                    // 16-byte chunks per Q row
  constexpr int EPC = 16 / (int)sizeof(KVT);    // pool values a chunk
  constexpr int KCPR = D / EPC;                 // chunks per K or V row

  const int tile = gridDim.x - 1 - blockIdx.x;  // latest rows first
  const int hk = blockIdx.y;
  const int b = blockIdx.z / n_split, split = blockIdx.z % n_split;
  const int G = Hq / Hkv;
  const int tid = threadIdx.x;
  const int qn = q_lens[b], kvn = kv_lens[b];
  const int start = kvn - qn;                   // position of query row 0
  const int row0 = tile * BQ;
  const int rows_total = M * G;

  // keys [0, limit) are all this tile's rows can see
  const int j_lo = row0 / G;
  const int j_last = min(min((row0 + BQ - 1) / G, M - 1), qn - 1);
  int limit = 0;
  if (j_last >= j_lo) limit = min(start + j_last + 1, kvn);
  limit = max(0, min(limit, MP * S));
  const int n_st = (limit + BK - 1) / BK;
  const int s_lo = split * n_st / n_split;
  const int s_hi = (split + 1) * n_st / n_split;

  extern __shared__ __align__(1024) unsigned char smem_tc[];
  unsigned char* sm = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_tc) + 1023) & ~uintptr_t(1023));

  // Copies: thread tid moves 16-byte chunk tid % CPR of rows tid / CPR +
  // RSTEP * i, so it works out one row's address (and one page index) per
  // K/V pair of chunks, and a stage's page lookups are independent loads.
  // K/V rows follow the same pattern with their own chunk count.
  constexpr int RSTEP = NTHREADS / CPR;          // Q rows a pass covers
  constexpr int RPT = BQ / RSTEP;                // Q rows a thread copies
  constexpr int KRSTEP = NTHREADS / KCPR;        // K/V rows a pass covers
  constexpr int KRPT = BK / KRSTEP;              // K/V rows a thread copies
  const int ch = tid % CPR, r_base = tid / CPR;
  const int kch = tid % KCPR, kr_base = tid / KCPR;

  // the Q tile; rows past M * G or past q_lens[b] are zeros
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int r = r_base + RSTEP * i;
    const int rr = row0 + r, j = rr / G, g = rr - j * G;
    const bool valid = rr < rows_total && j < qn;
    const __nv_bfloat16* src =
        valid ? q + (((size_t)b * M + j) * Hq + hk * G + g) * D + ch * 8 : q;
    cp_async16(sm + L::Q + wg::swz(r, ch, BQ), src, valid ? 16 : 0);
  }
  const int* tab = tables + (size_t)b * MP;
  const size_t v_off = (size_t)S * Hkv * D;      // K -> V inside a page
  auto load_stage = [&](int stage, int buf) {
    const int t0 = stage * BK;
    int page[KRPT];
#pragma unroll
    for (int i = 0; i < KRPT; ++i) {
      const int pos = t0 + kr_base + KRSTEP * i;
      page[i] = pos < limit ? min(max(tab[pos / S], 0), P - 1) : -1;
    }
#pragma unroll
    for (int i = 0; i < KRPT; ++i) {
      const int t = kr_base + KRSTEP * i, pos = t0 + t;
      const bool valid = page[i] >= 0;
      const KVT* src =
          valid ? pool + (((size_t)page[i] * 2 * S + pos % S) * Hkv + hk) * D +
                      kch * EPC
                : pool;
      unsigned char *kd, *vd;
      if constexpr (L::kE4M3) {     // raw rows into the staging ring
        kd = sm + L::STG + buf * L::STG_BUF + t * D + kch * 16;
        vd = kd + BK * D;
      } else {                      // straight into the swizzled tiles
        const uint32_t dst = buf * L::TILE + wg::swz(t, kch, BK);
        kd = sm + L::K + dst;
        vd = sm + L::V + dst;
      }
      cp_async16(kd, src, valid ? 16 : 0);
      cp_async16(vd, valid ? src + v_off : pool, valid ? 16 : 0);
    }
  };

  // this thread's two rows: the last position each may see (-1: none)
  int qpos[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int rr = row0 + Tile::row(i), j = rr / G;
    qpos[i] = (rr < rows_total && j < qn) ? start + j : -1;
  }
  const int first_pos = start + j_lo;   // the tile's earliest row position

  Tile t;
  t.init();
  if (s_lo < s_hi) load_stage(s_lo, 0);
  cp_async_commit();                     // the Q tile rides with stage s_lo
  for (int s = s_lo; s < s_hi; ++s) {
    const int buf = (s - s_lo) & 1;
    if (s + 1 < s_hi) load_stage(s + 1, buf ^ 1);
    cp_async_commit();
    cp_async_wait_1();
    int tb = buf;                        // the K/V tile buffer the step reads
    if constexpr (L::kE4M3) {
      __syncthreads();                   // every thread's raw rows landed
      e4m3_stage_to_tiles<D>(sm + L::STG + buf * L::STG_BUF, sm + L::K,
                             sm + L::V);
      tb = 0;
    }
    wg::fence_proxy_async();
    __syncthreads();
    const int k0 = s * BK;
    const uint32_t qa = wg::smem_u32(sm + L::Q);
    const uint32_t ka = wg::smem_u32(sm + L::K + tb * L::TILE);
    const uint32_t va = wg::smem_u32(sm + L::V + tb * L::TILE);
    auto visible = [&](int i, int key) { return k0 + key <= qpos[i]; };
    if (k0 + BK - 1 > first_pos)
      t.template step<true>(qa, ka, va, scale_log2, visible);
    else
      t.template step<false>(qa, ka, va, scale_log2, visible);
    __syncthreads();                     // buffer `buf` is refilled next
  }
  cp_async_wait_all();
  t.finish();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int rr = row0 + Tile::row(i);
    if (rr >= rows_total) continue;
    const int j = rr / G, g = rr % G;
    const size_t orow = ((size_t)b * M + j) * Hq + hk * G + g;
    if (n_split == 1) {
      const float inv = j < qn ? 1.f / fmaxf(t.l[i], 1e-30f) : 0.f;
      __nv_bfloat16* o = out + orow * D;
#pragma unroll
      for (int cc = 0; cc < D / 8; ++cc)
        *reinterpret_cast<__nv_bfloat162*>(o + Tile::col(cc, 0)) =
            __floats2bfloat162_rn(t.o[4 * cc + 2 * i] * inv,
                                  t.o[4 * cc + 2 * i + 1] * inv);
    } else if (j < qn) {
      const size_t prow = (size_t)split * B * M * Hq + orow;
      float* o = part_o + prow * D;
#pragma unroll
      for (int cc = 0; cc < D / 8; ++cc)
        *reinterpret_cast<float2*>(o + Tile::col(cc, 0)) =
            make_float2(t.o[4 * cc + 2 * i], t.o[4 * cc + 2 * i + 1]);
      if ((tid & 3) == 0)
        *reinterpret_cast<float2*>(part_ml + prow * 2) =
            make_float2(t.m[i], t.l[i]);
    }
  }
}

// Combine the splits of each (lane, row, query head) in split order; rows
// j >= q_lens[b] are zeros.  One warp per row, D/32 dims a lane.
template <int D>
__global__ void __launch_bounds__(128)
    ragged_attn_merge_kernel(const float* __restrict__ part_o,
                             const float* __restrict__ part_ml,
                             const int* __restrict__ q_lens,
                             __nv_bfloat16* __restrict__ out, int B, int M,
                             int Hq, int n_split) {
  constexpr int DPL = D / 32;
  const int row = blockIdx.x * 4 + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const size_t rows = (size_t)B * M * Hq;
  if (row >= rows) return;
  const int j = (row / Hq) % M, b = row / (M * Hq);
  float acc[DPL];
#pragma unroll
  for (int x = 0; x < DPL; ++x) acc[x] = 0.f;
  float den = 0.f;
  if (j < q_lens[b]) {
    float mx = wg::NEG;
    for (int s = 0; s < n_split; ++s)
      mx = fmaxf(mx, part_ml[(s * rows + row) * 2]);
    for (int s = 0; s < n_split; ++s) {
      const float2 ml =
          *reinterpret_cast<const float2*>(part_ml + (s * rows + row) * 2);
      const float w = exp2f(ml.x - mx);
      den += w * ml.y;
      const float* po = part_o + (s * rows + row) * D + lane * DPL;
#pragma unroll
      for (int x = 0; x < DPL; ++x) acc[x] += w * po[x];
    }
  }
  const float inv = 1.f / fmaxf(den, 1e-30f);
  __nv_bfloat16* o = out + (size_t)row * D + lane * DPL;
#pragma unroll
  for (int x = 0; x < DPL; ++x) o[x] = __float2bfloat16(acc[x] * inv);
}

template <int D, typename KVT>
int launch(const void* q, const void* pool, const int* tables,
           const int* q_lens, const int* kv_lens, void* out, void* scratch,
           int B, int M, int Hq, int Hkv, int P, int S, int MP, int n_split,
           float sm_scale, cudaStream_t stream) {
  using bf = __nv_bfloat16;
  const size_t smem = Smem<D, KVT>::bytes;
  auto kern = ragged_attn_wgmma_kernel<D, KVT>;
  static std::atomic<bool> smem_set[MAX_DEVICES];
  if (int e = enable_smem(kern, smem, smem_set)) return e;
  const int G = Hq / Hkv;
  const size_t rows = (size_t)B * M * Hq;
  float* part_o = static_cast<float*>(scratch);
  float* part_ml = part_o + (size_t)n_split * rows * D;
  if ((long long)B * n_split > 65535 || n_split < 1 ||
      (n_split > 1 && scratch == nullptr))
    return (int)cudaErrorInvalidConfiguration;
  dim3 grid((M * G + BQ - 1) / BQ, Hkv, B * n_split);
  kern<<<grid, NTHREADS, smem, stream>>>(
      static_cast<const bf*>(q), static_cast<const KVT*>(pool), tables,
      q_lens, kv_lens, static_cast<bf*>(out), part_o, part_ml, B, M, Hq, Hkv,
      P, S, MP, n_split, sm_scale * 1.4426950408889634f);
  if (n_split == 1) return (int)cudaGetLastError();
  if (cudaError_t e = cudaGetLastError()) return (int)e;
  ragged_attn_merge_kernel<D><<<(unsigned)((rows + 3) / 4), 128, 0, stream>>>(
      part_o, part_ml, q_lens, static_cast<bf*>(out), B, M, Hq, n_split);
  return (int)cudaGetLastError();
}

template <typename KVT>
int launch_d(const void* q, const void* pool, const int* tables,
             const int* q_lens, const int* kv_lens, void* out, void* scratch,
             int B, int M, int Hq, int Hkv, int D, int P, int S, int MP,
             int n_split, float sm_scale, cudaStream_t st) {
  if (D == 64)
    return launch<64, KVT>(q, pool, tables, q_lens, kv_lens, out, scratch, B,
                           M, Hq, Hkv, P, S, MP, n_split, sm_scale, st);
  if (D == 128)
    return launch<128, KVT>(q, pool, tables, q_lens, kv_lens, out, scratch,
                            B, M, Hq, Hkv, P, S, MP, n_split, sm_scale, st);
  return -1;
}

}  // namespace tc

}  // namespace

// C interface (bound with ctypes).  kv is the pool's dtype code: 0 f32, 1
// bf16, 2 e4m3.  body 1 is the tensor-core body (bf16 q over a bf16 or
// e4m3 pool, D 64 or 128) with `n_split` splits over the context and, when
// n_split > 1, f32 scratch of n_split * B * M * Hq * (D + 2) values; body
// 0 the CUDA-core body (an f32 q or pool at D 64, 128 or 256, and bf16
// over bf16 or e4m3 at D 256; n_split 1).
// Returns 0 or a cudaError_t code; -1 for a body, dtype and head dim the
// kernel is not built for.
extern "C" int tpulab_ragged_paged_attention(
    const void* q, const void* pool, const int* tables, const int* q_lens,
    const int* kv_lens, void* out, void* scratch, int B, int M, int Hq,
    int Hkv, int D, int P, int S, int MP, int q_bf16, int kv, int body,
    int n_split, float sm_scale, void* stream) {
  if (B == 0 || M == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (body == 1) {
    if (!q_bf16) return -1;
    if (kv == 1)
      return tc::launch_d<__nv_bfloat16>(q, pool, tables, q_lens, kv_lens,
                                         out, scratch, B, M, Hq, Hkv, D, P, S,
                                         MP, n_split, sm_scale, st);
    if (kv == 2)
      return tc::launch_d<e4m3>(q, pool, tables, q_lens, kv_lens, out,
                                scratch, B, M, Hq, Hkv, D, P, S, MP, n_split,
                                sm_scale, st);
    return -1;
  }
  if (body != 0 || n_split != 1) return -1;
  switch (D) {
    case 64:
      return launch_d<64>(q_bf16, kv, q, pool, tables, q_lens, kv_lens,
                          out, B, M, Hq, Hkv, P, S, MP, sm_scale, st);
    case 128:
      return launch_d<128>(q_bf16, kv, q, pool, tables, q_lens,
                           kv_lens, out, B, M, Hq, Hkv, P, S, MP, sm_scale,
                           st);
    case 256:
      return launch_d<256>(q_bf16, kv, q, pool, tables, q_lens,
                           kv_lens, out, B, M, Hq, Hkv, P, S, MP, sm_scale,
                           st);
    default:
      return -1;
  }
}
