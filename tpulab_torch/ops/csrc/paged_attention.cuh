// Paged single-query decode attention for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_paged_attn` / `_paged_attn_kernel`
// (tpulab/ops/paged_attention.py:221 and :76): one query token per lane
// attends its own block table of KV pages in the fused (P, 2, S, Hkv, D)
// pool, MHA or grouped-query.  q is f32, bf16 or f16; pages are f32,
// bf16, f16, e4m3 or e5m2 (tpulab's pool may be narrower than the compute
// dtype; the Pallas body upcasts what it reads, :184-185): the consumers
// convert each value to f32 as they read it (fp8 -> f16 -> f32, exact),
// and an fp8 stage is half a 16-bit stage's bytes, its rows D bytes,
// copied in the same 16-byte chunks.  Every (q, page) mix runs this one
// body, its math in f32.
//
// What it computes.  lengths[b] is the lane's CURRENT POSITION, inclusive
// (not a count, unlike the ragged kernel's kv_lens): positions
// 0..lengths[b] are visible.  No row past lengths[b] is copied, and a
// stage's shared-memory rows past it (stale from an earlier stage) are
// left out of the max, the sum and P.V by selection, never by a zero
// weight, so a dead page or a page tail holding inf or NaN cannot leak
// into the output.  q is scaled by log2(e)/sqrt(D) in f32 before the dot
// and the softmax is online in f32 with exp2; the output is acc / max(l,
// 1e-30) in q's dtype.  Every product is an f32 FMA (no TF32).  Page ids
// are clamped to [0, P).
//
// What bounds it on an H100.  At 8 lanes x 1024 positions, Hkv 8, D 128,
// bf16, a call must read 33.6 MB of K/V for ~0.13 GFLOP (~4 FLOP a byte,
// under the f32 CUDA-core ridge of ~20): it is bound by bytes (~10 us at
// 3.35 TB/s).  What stands between it and that bound is how many SMs
// work, how many bytes each keeps in flight, and the cost of each stage.
//
// What the design does about it.
// * Split-KV across blocks: the grid is (split, KV head, lane).  The
//   wrapper picks the split count from shapes and the SM count alone
//   (paged_attention.py `paged_splits`: 4 at 8 lanes x 8 KV heads, 16 at
//   one lane).  Split i walks stages [i * n / n_split, (i + 1) * n /
//   n_split) of the lane's n live 32-position stages and writes f32
//   partials (unnormalised O, m in log2 units, l); a split with no stage
//   writes the neutral partial (m = -1e30, l = 0, O = 0).
//   `paged_decode_merge_kernel` adds them in split order: no atomics, so
//   a second launch is bit-identical.  With one split the block writes
//   the output directly.
// * Copies tracked by mbarriers: one producer warp feeds a ring of NW
//   stages, one slot per consumer warp (NW = 4 at bf16 D <= 128 and f32
//   D 64: 78 KB a block at bf16 D 128, two blocks an SM; 3 at 512-byte
//   rows, 2 at f32 D 256).  A stage is 32 positions of one KV head: each
//   producer lane reads one table entry (one lookup per page, issued
//   before the wait for a free slot) and works out its row's address; the
//   warp then copies the stage's K and V rows (D contiguous elements
//   each, Hkv * D apart in the pool) in coalesced 16-byte `cp.async`
//   chunks, and each lane's `cp.async.mbarrier.arrive.noinc` completes
//   the stage's `full` mbarrier once its copies land.  (A `cp.async.bulk`
//   per row was measured slower at bf16: the copy unit's cost per request
//   dominates a 256-byte row.)  Rows land at a 16-byte padded stride, so
//   a warp reading 32 rows at one column hits 32 distinct banks.
// * The math, laid out for the warp: consumer warp w takes stages w, w +
//   NW, ... in slot w, each warp with its own online softmax state.  (A
//   warp waits on a slot only after it consumed the slot's previous round
//   itself, so a parity wait never sees a phase two rounds old.)  Lane t
//   scores position t against every query head of the block's group,
//   padded to GP = 4 or 8 heads at compile time (zero query rows) so that
//   every head's loads and FMAs interleave without branches; q is read
//   from shared memory as broadcasts, the max is a shuffle reduction, and
//   for P.V each lane owns D/32 output dims of every head and reads the
//   weights back as broadcasts.  Below D 32 (D 16: tpulab's own small
//   model, d_model 32 over 2 heads) a lane owns one output dim and the
//   warp's 32 / D lane groups take every (32 / D)-th position of P.V
//   each; their sums meet through shuffles before the warps' merge.  No
//   block barrier per stage: a consumer waits on its slot's `full`
//   barrier and releases it on `empty`.  The warps' states are merged
//   once at the end.
// * Groups past 8 query heads a KV head (G 16, or MQA's Hq 32 over Hkv
//   1): the grid's KV-head axis walks (KV head, block of GBLK = 8 query
//   heads), so a block keeps the 8-head shared memory and registers of
//   a smaller group, and each block of a group re-reads the KV head's
//   pages (G / 8 times the bytes of one pass; the split rule counts the
//   blocks).
// * Head dims.  The body is compiled for D 16, 32, 64, 128 and 256
//   exactly.  Any other head dim up to 256 (kPad: Phi-3-mini's 96,
//   Phi-2's 80, 24, 100, ...) runs the instantiation of the next width of
//   32, 64, 128 and 256 (GP 8) with the head dim and q's type (read once,
//   written once) taken at run time: the
//   ring is zeroed once, so a row's columns past the head dim are zeros
//   that add nothing to the scores or P.V; rows are copied in the widest
//   chunks their bytes allow (16 bytes down to 1, plain stores and a
//   plain mbarrier arrival below 4), and the columns past the head dim
//   are not stored.  Every head dim past 256 runs the wide form of
//   wide_attention.cuh instead (`paged_wide`, paged_attention_wide.cu):
//   kernel 1's wide kernel over one query row a lane, its own split-KV.

#pragma once

#include "attn_wgmma.cuh"
#include "common.cuh"

namespace {

using namespace tpulab;

constexpr int KT = 32;                      // positions a stage: one a lane
constexpr int GBLK = 8;                     // query heads a block
constexpr float NEG = -1e30f;               // m before any position

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
// The NW consumer warps' own barrier (the producer warp takes no part).
template <int NW>
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(NW * 32) : "memory");
}
// Arrive on `bar` once every cp.async this thread issued so far has
// landed (the arrival counts toward the barrier's expected count).
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   wg::smem_u32(bar))
               : "memory");
}

template <typename KVT, int D>
struct Geometry {
  static constexpr int ROW = D * (int)sizeof(KVT);   // bytes of a K or V row
  static constexpr int LDB = ROW + 16;               // padded row stride
  static constexpr int STAGE = 2 * KT * LDB;         // K rows, then V rows
  // consumer warps = ring slots
  static constexpr int NW = STAGE <= 20000 ? 4 : STAGE <= 40000 ? 3 : 2;
  static constexpr int NTHREADS = (NW + 1) * 32;     // + the producer warp
  static constexpr size_t ring_bytes = (size_t)NW * STAGE;
  static constexpr size_t q_bytes = sizeof(float) * GBLK * D;
  static constexpr size_t p_bytes = sizeof(float) * NW * KT * GBLK;
  // the end-of-walk merge of the consumer warps reuses the ring
  static constexpr size_t merge_bytes = sizeof(float) * NW * GBLK * (D + 2);
  static_assert(merge_bytes <= ring_bytes, "merge area must fit the ring");
  static constexpr size_t bar_off = ring_bytes + q_bytes + p_bytes;
  static constexpr size_t smem_bytes = bar_off + 2 * NW * sizeof(uint64_t);
};

// D is the shared-memory width; the head dim HD is D, or (kPad) `dh` <= D
// with rows copied in chunks of `cw` bytes and q's type taken at run time
// (QT AnyQ, code `qc`).
template <typename QT, typename KVT, int D, int GP, bool kPad>
__global__ void __launch_bounds__(Geometry<KVT, D>::NTHREADS)
    paged_decode_kernel(const QT* __restrict__ q,
                        const KVT* __restrict__ pool,
                        const int* __restrict__ tables,
                        const int* __restrict__ lengths, QT* __restrict__ out,
                        float* __restrict__ part_o,
                        float* __restrict__ part_ml, int B, int Hq, int Hkv,
                        int P, int S, int MP, float scale_log2, int dh,
                        int cw, int qc) {
  using Geo = Geometry<KVT, D>;
  const int HD = kPad ? dh : D;
  constexpr int NW = Geo::NW, LDB = Geo::LDB;
  constexpr int DPL = D >= 32 ? D / 32 : 1;           // P.V dims a lane
  constexpr int PVL = D / DPL;                        // lanes with dims
  constexpr int PVG = 32 / PVL;                       // P.V's key groups
  constexpr int EPC = 16 / sizeof(KVT);               // elements a 16 B chunk
  constexpr int CPR = Geo::ROW / 16;                  // chunks a row

  const int split = blockIdx.x, n_split = gridDim.x;
  const int G = Hq / Hkv;
  const int n_gb = (G + GBLK - 1) / GBLK;             // head blocks a group
  const int hk = blockIdx.y / n_gb, g0 = blockIdx.y % n_gb * GBLK;
  const int Gb = min(GBLK, G - g0);                   // this block's heads
  const int b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int pv_lane = lane % PVL, pv_grp = lane / PVL;
  // positions 0..lengths[b] are visible; the walk stops at the table's end
  const int n_pos = max(0, min(lengths[b] + 1, MP * S));
  const int n_st = (n_pos + KT - 1) / KT;
  const int s_lo = split * n_st / n_split;
  const int s_hi = (split + 1) * n_st / n_split;

  extern __shared__ __align__(16) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem + Geo::ring_bytes);  // [GP][D]
  float* ps = qs + GBLK * D;                             // [NW][KT][GP]
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + Geo::bar_off);
  uint64_t* empty = full + NW;

  if constexpr (kPad)   // a row's columns past the head dim stay zero
    zero_smem(smem, Geo::ring_bytes, threadIdx.x, Geo::NTHREADS);
  if (threadIdx.x == 0) {
    for (int i = 0; i < NW; ++i) {
      wg::mbar_init(&full[i], 32);     // each producer lane's copies landed
      wg::mbar_init(&empty[i], 1);     // the consuming warp's release
    }
    wg::mbar_fence_init();
  }
  __syncthreads();

  if (warp == NW) {
    // ---- producer: stage i of this split goes to slot i % NW
    const int* tab = tables + (size_t)b * MP;
    const size_t v_off = (size_t)S * Hkv * HD * sizeof(KVT);  // K -> V, bytes
    for (int s = s_lo; s < s_hi; ++s) {
      const int i = s - s_lo, slot = i % NW;
      const int t0 = s * KT, nv = min(KT, n_pos - t0);
      const int p0 = t0 / S;                           // the stage's first page
      // one table entry a lane (a stage spans at most 32 pages), read
      // before the wait for a free slot; row `lane`'s address from it
      int page = 0;
      if ((p0 + lane) * S < t0 + nv)
        page = min(max(tab[p0 + lane], 0), P - 1);
      const int pos = t0 + lane;
      const int pg = pos / S;
      page = __shfl_sync(0xffffffffu, page, lane < nv ? pg - p0 : 0);
      const unsigned char* row = reinterpret_cast<const unsigned char*>(
          pool + (((size_t)page * 2 * S + (pos - pg * S)) * Hkv + hk) * HD);
      if (i >= NW) wg::mbar_wait(&empty[slot], (i / NW - 1) & 1);
      unsigned char* st = smem + (size_t)slot * Geo::STAGE;
      if constexpr (kPad) {
        // rows of HD * sizeof(KVT) bytes, cw a chunk; row t's address from
        // lane t (every lane shuffles alike: 32 lanes, 32 rows)
        for_row_chunks(KT, HD * (int)sizeof(KVT), cw, lane, 32,
                       [&](int t, int off) {
          const unsigned char* src =
              reinterpret_cast<const unsigned char*>(__shfl_sync(
                  0xffffffffu, reinterpret_cast<unsigned long long>(row),
                  t)) + off;
          if (t < nv) {
            copy_chunk(st + t * LDB + off, src, cw, true);
            copy_chunk(st + (KT + t) * LDB + off, src + v_off, cw, true);
          }
        });
        // below 4 bytes the copies were plain stores: a plain (release)
        // arrival publishes them
        if (cw >= 4)
          cp_async_arrive(&full[slot]);
        else
          wg::mbar_arrive(&full[slot]);
        continue;
      }
      // 32 / CPR rows a pass, CPR lanes a row: coalesced 16-byte chunks
#pragma unroll 4
      for (int k = 0; k < CPR; ++k) {
        const int idx = lane + 32 * k, r = idx / CPR, c = idx % CPR;
        const unsigned char* src =
            reinterpret_cast<const unsigned char*>(__shfl_sync(
                0xffffffffu, reinterpret_cast<unsigned long long>(row), r)) +
            c * 16;
        if (r < nv) {
          cp_async16(st + r * LDB + c * 16, src, 16);
          cp_async16(st + (KT + r) * LDB + c * 16, src + v_off, 16);
        }
      }
      cp_async_arrive(&full[slot]);
    }
    return;
  }

  // ---- consumers: the block's queries, scaled into log2 units; rows
  // Gb..GP-1 are zeros
  for (int idx = threadIdx.x; idx < GP * D; idx += NW * 32) {
    if constexpr (kPad) {
      const int g = idx / D, d = idx % D;
      qs[idx] = g < Gb && d < HD
                    ? q_load(q, ((size_t)b * Hq + hk * G + g0 + g) * HD + d,
                             qc) * scale_log2
                    : 0.f;
    } else {
      qs[idx] = idx < Gb * D
                    ? q_load(q, ((size_t)b * Hq + hk * G + g0) * D + idx,
                             qc) * scale_log2
                    : 0.f;
    }
  }
  consumers_sync<NW>();

  float m_r[GP], l_r[GP], acc[GP][DPL];
#pragma unroll
  for (int g = 0; g < GP; ++g) {
    m_r[g] = NEG;
    l_r[g] = 0.f;            // this lane's share; summed over the warp at the end
#pragma unroll
    for (int x = 0; x < DPL; ++x) acc[g][x] = 0.f;
  }
  float* pw = ps + warp * KT * GP;                      // this warp's weights
  const unsigned char* kb = smem + (size_t)warp * Geo::STAGE;   // slot `warp`
  const unsigned char* vb = kb + KT * LDB;

  for (int i = warp; s_lo + i < s_hi; i += NW) {
    const int nv = min(KT, n_pos - (s_lo + i) * KT);    // live rows, >= 1
    wg::mbar_wait(&full[warp], (i / NW) & 1);

    // scores: lane t against every head of the group
    float sc[GP];
#pragma unroll
    for (int g = 0; g < GP; ++g) sc[g] = 0.f;
    if (lane < nv) {
      const KVT* kr = reinterpret_cast<const KVT*>(kb + lane * LDB);
#pragma unroll 4
      for (int d = 0; d < D; d += EPC) {
        float kf[EPC];
        load_vals<EPC>(kr + d, kf);
#pragma unroll
        for (int g = 0; g < GP; ++g) {
          float qf[EPC];
          load_vals<EPC>(qs + g * D + d, qf);
          float a = 0.f;
#pragma unroll
          for (int e = 0; e < EPC; ++e) a = fmaf(qf[e], kf[e], a);
          sc[g] += a;
        }
      }
    }
    // online softmax; rows past nv are selected out (their smem is stale)
    float p[GP];
#pragma unroll
    for (int g = 0; g < GP; ++g) {
      const float s = lane < nv ? sc[g] : -INFINITY;
      const float m_new = fmaxf(m_r[g], warp_max(s));
      const float alpha = exp2f(m_r[g] - m_new);
      m_r[g] = m_new;
      p[g] = lane < nv ? exp2f(s - m_new) : 0.f;
      l_r[g] = l_r[g] * alpha + p[g];
#pragma unroll
      for (int x = 0; x < DPL; ++x) acc[g][x] *= alpha;
    }
#pragma unroll
    for (int g = 0; g < GP; g += 4)
      *reinterpret_cast<float4*>(pw + lane * GP + g) =
          make_float4(p[g], p[g + 1], p[g + 2], p[g + 3]);
    __syncwarp();
    // P.V over the live rows only: this lane's D/32 dims of every head
    // (below D 32, its dim over its group's rows)
#pragma unroll 4
    for (int t = pv_grp; t < nv; t += PVG) {
      float vf[DPL], pt[GP];
      load_vals<DPL>(
          reinterpret_cast<const KVT*>(vb + t * LDB) + pv_lane * DPL, vf);
      load_vals<GP>(pw + t * GP, pt);
#pragma unroll
      for (int g = 0; g < GP; ++g)
#pragma unroll
        for (int x = 0; x < DPL; ++x) acc[g][x] = fmaf(pt[g], vf[x], acc[g][x]);
    }
    __syncwarp();                       // every lane is done with the slot
    if (lane == 0) wg::mbar_arrive(&empty[warp]);
  }
#pragma unroll
  for (int g = 0; g < GP; ++g) {
    l_r[g] = warp_sum(l_r[g]);
#pragma unroll
    for (int off = PVL; off < 32; off <<= 1)      // P.V's key groups
#pragma unroll
      for (int x = 0; x < DPL; ++x)
        acc[g][x] += __shfl_xor_sync(0xffffffffu, acc[g][x], off);
  }
  consumers_sync<NW>();                 // every stage landed and was read

  // merge the consumer warps' states (the ring is free now)
  float* cm = reinterpret_cast<float*>(smem);           // [NW][GP]
  float* cl = cm + NW * GP;                             // [NW][GP]
  float* ca = cl + NW * GP;                             // [NW][GP][D]
#pragma unroll
  for (int g = 0; g < GP; ++g) {
    if (lane == 0) {
      cm[warp * GP + g] = m_r[g];
      cl[warp * GP + g] = l_r[g];
    }
    if (pv_grp == 0) {
#pragma unroll
      for (int x = 0; x < DPL; ++x)
        ca[((size_t)warp * GP + g) * D + pv_lane * DPL + x] = acc[g][x];
    }
  }
  consumers_sync<NW>();
  const size_t rows = (size_t)B * Hq;
  for (int idx = threadIdx.x; idx < Gb * D; idx += NW * 32) {
    const int g = idx / D, d = idx % D;
    if (kPad && d >= HD) continue;
    float mx = NEG;
#pragma unroll
    for (int w = 0; w < NW; ++w) mx = fmaxf(mx, cm[w * GP + g]);
    float den = 0.f, o = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      const float sc = exp2f(cm[w * GP + g] - mx);
      den += cl[w * GP + g] * sc;
      o += ca[((size_t)w * GP + g) * D + d] * sc;
    }
    const size_t row = (size_t)b * Hq + hk * G + g0 + g;
    if (n_split == 1) {
      q_store(out, row * HD + d, qc, o / fmaxf(den, 1e-30f));
    } else {
      const size_t prow = (size_t)split * rows + row;
      part_o[prow * HD + d] = o;
      if (d == 0)
        *reinterpret_cast<float2*>(part_ml + prow * 2) = make_float2(mx, den);
    }
  }
}

// Combine the splits of each (lane, query head) in split order.  One warp
// a row, D/32 dims a lane (one below D 32, lanes past D idle; kPad: the
// dims below the head dim `dh`).
template <typename QT, int D, bool kPad>
__global__ void __launch_bounds__(128)
    paged_decode_merge_kernel(const float* __restrict__ part_o,
                              const float* __restrict__ part_ml,
                              QT* __restrict__ out, int rows, int n_split,
                              int dh, int qc) {
  constexpr int DPL = D >= 32 ? D / 32 : 1;
  const int HD = kPad ? dh : D;
  const int row = blockIdx.x * 4 + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows || lane * DPL >= HD) return;
  float mx = NEG;
  for (int s = 0; s < n_split; ++s)
    mx = fmaxf(mx, part_ml[((size_t)s * rows + row) * 2]);
  float acc[DPL];
#pragma unroll
  for (int x = 0; x < DPL; ++x) acc[x] = 0.f;
  float den = 0.f;
  for (int s = 0; s < n_split; ++s) {
    const size_t prow = (size_t)s * rows + row;
    const float2 ml = *reinterpret_cast<const float2*>(part_ml + prow * 2);
    const float w = exp2f(ml.x - mx);
    den += w * ml.y;
    const float* po = part_o + prow * HD + lane * DPL;
#pragma unroll
    for (int x = 0; x < DPL; ++x)
      if (!kPad || lane * DPL + x < HD) acc[x] += w * po[x];
  }
  const float inv = 1.f / fmaxf(den, 1e-30f);
  const size_t o = (size_t)row * HD + lane * DPL;
#pragma unroll
  for (int x = 0; x < DPL; ++x)
    if (!kPad || lane * DPL + x < HD) q_store(out, o + x, qc, acc[x] * inv);
}

template <typename QT, typename KVT, int D, int GP, bool kPad>
int launch(const void* q, const void* pool, const int* tables,
           const int* lengths, void* out, void* scratch, int B, int Hq,
           int Hkv, int P, int S, int MP, int n_split, float sm_scale,
           int dh, int qc, cudaStream_t stream) {
  const size_t smem = Geometry<KVT, D>::smem_bytes;
  auto kern = paged_decode_kernel<QT, KVT, D, GP, kPad>;
  static std::atomic<bool> smem_set[MAX_DEVICES];
  if (int e = enable_smem(kern, smem, smem_set)) return e;
  const int n_gb = (Hq / Hkv + GBLK - 1) / GBLK;
  if (B > 65535 || (long long)Hkv * n_gb > 65535 || n_split < 1 ||
      (n_split > 1 && scratch == nullptr))
    return (int)cudaErrorInvalidConfiguration;
  const int rows = B * Hq;
  // (m, l) pairs are read and written as float2: they start at an even
  // offset, past one float of padding when the O partials' count is odd
  // (an odd head dim over an odd count of split rows)
  const size_t n_o = (size_t)n_split * rows * dh;
  float* part_o = static_cast<float*>(scratch);
  float* part_ml = part_o + n_o + n_o % 2;
  dim3 grid(n_split, Hkv * n_gb, B);
  kern<<<grid, Geometry<KVT, D>::NTHREADS, smem, stream>>>(
      static_cast<const QT*>(q), static_cast<const KVT*>(pool), tables,
      lengths, static_cast<QT*>(out), part_o, part_ml, B, Hq, Hkv, P, S, MP,
      sm_scale * 1.4426950408889634f, dh,
      copy_width({(unsigned long long)dh * sizeof(KVT)}), qc);
  if (n_split == 1) return (int)cudaGetLastError();
  if (cudaError_t e = cudaGetLastError()) return (int)e;
  paged_decode_merge_kernel<QT, D, kPad><<<(rows + 3) / 4, 128, 0, stream>>>(
      part_o, part_ml, static_cast<QT*>(out), rows, n_split, dh, qc);
  return (int)cudaGetLastError();
}

// A block's heads padded to GP = 4 or 8 (a smaller group computes zero
// rows it never writes; a larger one runs blocks of 8).  kPad: GP 8 for
// every group (one instantiation a width and dtype mix).
template <typename QT, typename KVT, int D>
int launch_g(const void* q, const void* pool, const int* tables,
             const int* lengths, void* out, void* scratch, int B, int Hq,
             int Hkv, int P, int S, int MP, int n_split, float sm_scale,
             int qc, cudaStream_t st) {
  if (Hq / Hkv <= 4)
    return launch<QT, KVT, D, 4, false>(q, pool, tables, lengths, out,
                                        scratch, B, Hq, Hkv, P, S, MP,
                                        n_split, sm_scale, D, qc, st);
  return launch<QT, KVT, D, 8, false>(q, pool, tables, lengths, out, scratch,
                                      B, Hq, Hkv, P, S, MP, n_split, sm_scale,
                                      D, qc, st);
}

// q code `qc` (0 f32, 1 bf16, 2 f16) over page code `kv` (0 f32, 1 bf16,
// 2 e4m3, 3 e5m2, 4 f16): every mix, at D; or (kPad) at the head dim `dh`
// on the width D, GP 8 and q's type taken at run time (one instantiation
// a width and page type).
template <int D, bool kPad = false>
int launch_d(int qc, int kv, const void* q, const void* pool,
             const int* tables, const int* lengths, void* out, void* scratch,
             int B, int Hq, int Hkv, int P, int S, int MP, int n_split,
             float sm_scale, cudaStream_t st, int dh = D) {
  if constexpr (kPad) {
    if (qc < 0 || qc > 2) return -1;
    return with_kv_type(kv, [&](auto kt) {
      using KVT = typename decltype(kt)::type;
      return launch<AnyQ, KVT, D, 8, true>(q, pool, tables, lengths, out,
                                           scratch, B, Hq, Hkv, P, S, MP,
                                           n_split, sm_scale, dh, qc, st);
    });
  } else {
    return with_q_type(qc, [&](auto qt) {
      return with_kv_type(kv, [&](auto kt) {
        using QT = typename decltype(qt)::type;
        using KVT = typename decltype(kt)::type;
        return launch_g<QT, KVT, D>(q, pool, tables, lengths, out, scratch,
                                    B, Hq, Hkv, P, S, MP, n_split, sm_scale,
                                    qc, st);
      });
    });
  }
}

}  // namespace

namespace tpulab {
// Any head dim up to FMA_WIDTH (256) the body is not compiled for exactly,
// on its padded width: defined in paged_attention_padded.cu (a second
// translation unit of the same library, so nvcc builds both at once).
// Arguments as the C interface's; -1 for a head dim past FMA_WIDTH.
int paged_padded(int qc, int kv, const void* q, const void* pool,
                 const int* tables, const int* lengths, void* out,
                 void* scratch, int B, int Hq, int Hkv, int D, int P, int S,
                 int MP, int n_split, float sm_scale, cudaStream_t st);
// Every head dim past FMA_WIDTH: the wide form (wide_attention.cuh),
// defined in paged_attention_wide.cu (a third translation unit).
// Arguments as the C interface's; -1 for a head dim up to FMA_WIDTH.
int paged_wide(int qc, int kv, const void* q, const void* pool,
               const int* tables, const int* lengths, void* out,
               void* scratch, int B, int Hq, int Hkv, int D, int P, int S,
               int MP, int n_split, float sm_scale, cudaStream_t st);
}  // namespace tpulab
