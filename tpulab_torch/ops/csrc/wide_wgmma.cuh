// The wide tensor-core form of kernels 1 and 2 (`"wgmma-wide"`): every head
// dim past 256 that is a multiple of 16, for a 16-bit q (E: bf16 or f16)
// over K/V whose upcast to E is exact (E itself, e4m3 or e5m2), on NVIDIA
// Hopper (sm_90a).
//
// Replaces, for those calls, the Pallas TPU kernels `_ragged_attn`
// (tpulab/ops/ragged_attention.py:190) and `_flash_bhd`
// (tpulab/ops/flash_attention.py:80), which take the head dim as a
// parameter with no upper limit.  It computes what the wide fma form
// (wide_attention.cuh) computes: the same visibility, lengths, GQA row
// packing (row = j * G + g), f32 online softmax and zero rows for dead
// queries.  The numerics are those of the D <= 128 `wgmma` bodies
// (attn_wgmma.cuh): Q K^T in f32 on the tensor cores, scores scaled by
// log2(e)/sqrt(D) in f32 after the product, P rounded to E before P V —
// the one rounding the plain version does not make.  fp8 pages are
// staged to E (no fp8 `wgmma`: it would round Q to fp8).
//
// What bounds it.  Kernel 2 at T 2048, H 8, D 512, causal: 34.4 GFLOP, 35
// us at the bf16 tensor-core peak; its K and V are 33.6 MB.  Kernel 1 at
// decode (8 lanes x 1024 positions over one KV head of D 512) reads 16.8
// MB for 0.07 GFLOP: bytes.  The wide fma form ran every product as an
// f32 FMA on CUDA cores and recomputed the scores once per 256-column
// output slab: 130x its bound at D 512 on kernel 2.
//
// The design.  A block owns 64 query rows (kernel 1: packed (j, g) rows
// of one lane and KV head) and up to 512 output columns, and has two
// warpgroups, consumers 0 and 1.  No producer warpgroup: ptxas held a
// 384-thread version of this block to 168 registers a thread whatever
// `setmaxnreg` asked (1.1 KB of spills a thread), and O alone is 128;
// two warpgroups may use 255.
// * The head dim is walked in 64-column chunks (D 576: 9).  Q's chunks
//   stay in shared memory for the whole walk where they fit beside the
//   rings (`resident`: through D 640); past that each S unit carries its
//   own Q chunk (`streamed`).
// * A stage of 64 keys is n_s S units (resident: K chunks 2k and 2k + 1;
//   streamed: Q chunk k and K chunk k) and then the block's V units (V
//   chunks 2v and 2v + 1: 128 output columns each, 2 to 4 a block).  Unit
//   k of each kind belongs to consumer k % 2, so both work on every stage
//   at once.  A unit is two 64-row x 64-column 16-bit halves in the
//   128-byte-swizzled layout of attn_wgmma.cuh, one 16 KB slot of its
//   consumer's ring of four.
// * Each consumer loads its own units two ahead of the one it multiplies
//   and meets its four warps on a named barrier before its `wgmma`s read
//   a slot; the slot of the unit two before is refilled then, every warp
//   having waited for its products.  One unit's products stay in flight
//   while the next is issued, and a stage's P V runs under the next
//   stage's S.
//   - Kernel 2: TMA.  Thread 0 of the consumer asks for each 64 x 64 box
//     of a (B, T, H, D) tensor map of inner dimension D (rows past T and
//     columns past D read zeros), counted in bytes on the slot's
//     mbarrier.  Gathered with cp.async like kernel 1's, the copies'
//     address arithmetic on 128 threads cost 0.12 of 0.26 ms at D 512
//     (PERF.md).
//   - Kernel 1: its 128 threads gather the rows of the lane's pages with
//     cp.async (zero-filled without a read past the keys the block's
//     rows see and past the head dim, so no dead page's NaN is read;
//     page indices clamped to [0, P)), one group a unit.  An fp8 row's
//     16-value chunk lands raw in the second of the two 16-byte chunks
//     its E values fill, and the thread that copied it widens it in
//     place.
// * Scores once, no slab recomputation inside a block: each consumer
//   computes S over its half of the head dim's chunks (m64n64k16, 32 f32
//   registers a thread); consumer 1 hands its partial S to consumer 0
//   through 16 KB of shared memory, consumer 0 adds it and hands back the
//   sum (two named barriers of 256 threads), so both hold the same S bit
//   for bit and so the same (m, l) and P.  Each then runs O += P V over
//   its own V units (m64n128k16, P from registers), O of up to 256
//   columns a consumer in 128 f32 registers a thread (o0, o1).
// * Past 512 output columns the grid's x axis also walks column blocks
//   (D 576: 2, 1024: 2, 2048: 4), each recomputing S: ceil(D / 512)
//   times the Q K^T work of one pass (D 576: 1.5x in all, D 2048: 2.5x).
// * Split-KV (kernel 1): where the (tile, column block, KV head, lane)
//   blocks do not fill the card, the grid's z axis walks splits of each
//   lane's stages; each split writes f32 partials (unnormalised O, and
//   from column block 0 the row's (m, l) with m in log2 units, at an even
//   float offset) and `wide_merge_kernel<true>` adds them in split order:
//   no atomics, so a relaunch is bit-identical.
// Shared memory (`Plan`, mirrored by `wgmma_wide_plan` in
// ragged_attention.py): Q if resident (8 KB a chunk), two rings of four
// 16 KB slots, the 16 KB score swap, 128 bytes of mbarriers, 1 KB of
// alignment (fp8 pages need no more): D 320 189,568 bytes, D 512
// 214,144, D 640 230,528, every D past 640 148,608; every D within
// 232,448.  Registers: 221 a thread for kernel 2, 243-254 for kernel 1,
// no local memory (`cudaFuncGetAttributes`, PERF.md).
#pragma once

#include "attn_wgmma.cuh"
#include "common.cuh"
#include "tma_map.cuh"
#include "wide_merge.cuh"

namespace tpulab {
namespace wwg {
namespace {

constexpr int BQ = 64;                   // query rows a block
constexpr int BK = 64;                   // key positions a stage
constexpr int NTHREADS = 256;            // two consumer warpgroups
constexpr int HALF = 64 * 128;           // a 64 x 64 16-bit tile, 8 KB
constexpr int UNIT = 2 * HALF;           // a ring slot
constexpr int LAG = 2;                   // units in flight a consumer
constexpr int RING = LAG + 2;            // slots a consumer
constexpr int XBUF = 32 * 128 * 4;       // one consumer's partial S
constexpr int BAR_BYTES = 128;           // kernel 2's mbarriers
constexpr size_t SMEM_LIMIT = 232448;
constexpr int BLOCK_VUNITS = 4;          // V units (128 columns) a block

// The shared-memory plan at head dim `dh`: Q resident where it fits
// beside the two rings and the S swap, else streamed with the K chunks.
struct Plan {
  int nch, resident, n_s, n_vu, n_cb, ring_off, x_off, bar_off;
  size_t bytes;
};
__host__ __device__ inline Plan make_plan(int dh) {
  Plan p;
  p.nch = (dh + 63) / 64;
  const long long rest = 2LL * RING * UNIT + XBUF + BAR_BYTES + 1024;
  p.resident = (long long)p.nch * HALF + rest <= (long long)SMEM_LIMIT;
  p.ring_off = p.resident ? p.nch * HALF : 0;
  p.x_off = p.ring_off + 2 * RING * UNIT;
  p.bar_off = p.x_off + XBUF;
  p.bytes = (size_t)p.bar_off + BAR_BYTES + 1024;
  p.n_s = p.resident ? (p.nch + 1) / 2 : p.nch;
  p.n_vu = (p.nch + 1) / 2;
  p.n_cb = (p.n_vu + BLOCK_VUNITS - 1) / BLOCK_VUNITS;
  return p;
}

// Wait until at most N of this thread's cp.async groups are pending.
template <int N>
__device__ __forceinline__ void cp_async_wait_n() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Kernel 1's rows: (j, g) rows row0 + i of lane b over KV head hk.
template <typename E, typename KVT>
struct PagedRows {
  static constexpr bool kTMA = false;   // rows gathered with cp.async
  const E* q;
  const KVT* pool;
  const int* tab;
  int M, Hq, Hkv, G, P, S, dh, b, hk, qn, start, row0, rows_total;
  size_t split_base;     // split * B * M * Hq: this split's partial rows
  __device__ bool exists(int i) const { return row0 + i < rows_total; }
  __device__ bool live(int i) const {
    return row0 + i < rows_total && (row0 + i) / G < qn;
  }
  __device__ size_t row(int i) const {
    const int r = row0 + i, j = r / G;
    return ((size_t)b * M + j) * Hq + hk * G + (r - j * G);
  }
  __device__ const E* q_row(int i) const { return q + row(i) * dh; }
  __device__ const void* base() const { return q; }
  __device__ size_t o_off(int i) const { return row(i) * dh; }
  __device__ size_t prow(int i) const { return split_base + row(i); }
  __device__ int last(int i) const {
    return live(i) ? start + (row0 + i) / G : -1;
  }
  // position pos's K row (kv 0) or V row (kv 1)
  __device__ const KVT* kv_row(int pos, int kv) const {
    const int page = min(max(tab[pos / S], 0), P - 1);
    return pool + ((((size_t)page * 2 + kv) * S + pos % S) * Hkv + hk) * dh;
  }
};

// Kernel 2's rows: q0 + i of (b, h), read through the tensor maps of the
// (B, T, H, D) views.
template <typename E>
struct DenseRows {
  static constexpr bool kTMA = true;    // tiles of the views' tensor maps
  const CUtensorMap *mq, *mk, *mv;
  size_t obase;          // ((b * T) * H + h) * D
  int Tlen, H, dh, b, h, q0, causal;
  // the map of kind 0 (Q), 1 (K) or 2 (V)
  __device__ const CUtensorMap* map(int kind) const {
    return kind == 0 ? mq : kind == 1 ? mk : mv;
  }
  __device__ bool exists(int i) const { return q0 + i < Tlen; }
  __device__ bool live(int i) const { return q0 + i < Tlen; }
  __device__ size_t o_off(int i) const {
    return obase + (size_t)(q0 + i) * H * dh;
  }
  __device__ size_t prow(int) const { return 0; }
  __device__ int last(int i) const {
    return live(i) ? (causal ? q0 + i : Tlen - 1) : -1;
  }
};

// Eight E values from 16 fp8 values (w[0..3], the first in the low byte
// of w[0]): o[j] holds values 2j and 2j + 1.  To f16 the pair's f16 bits
// are the result; to bf16 through f32 (exact).
template <typename E, typename F8>
__device__ __forceinline__ void fp8x16_to_e(const uint4& raw,
                                            uint32_t (&o)[8]) {
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const uint32_t pair = w[j / 2] >> (16 * (j % 2));
    if constexpr (wg::is_f16<E>) {
      o[j] = fp8x2_to_h2bits<F8>(pair);
    } else {
      const float2 f = fp8x2_to_float2<F8>(pair);
      o[j] = wg::pack_bf16(f.x, f.y);
    }
  }
}

// Row i (0 or 1) of a consumer thread's O for one V unit (128 output
// columns from col0): into `out` at element o_off, normalised (zeros for
// a dead row), or (part_o non-null) unnormalised into the partial row
// prow.  Columns past the head dim are not stored.
template <typename E>
__device__ __forceinline__ void store_unit(const float (&o)[64], int i,
                                           int col0, int dh, bool live,
                                           float l, E* out, float* part_o,
                                           size_t o_off, size_t prow) {
  using Tile = wg::AttnTile<128, E>;
  if (part_o == nullptr) {
    const float inv = live ? 1.f / fmaxf(l, 1e-30f) : 0.f;
#pragma unroll
    for (int cc = 0; cc < 16; ++cc) {
      const int col = col0 + Tile::col(cc, 0);
      if (col < dh)
        wg::store2<E>(out + o_off + col, o[4 * cc + 2 * i] * inv,
                      o[4 * cc + 2 * i + 1] * inv);
    }
  } else if (live) {
#pragma unroll
    for (int cc = 0; cc < 16; ++cc) {
      const int col = col0 + Tile::col(cc, 0);
      if (col < dh)
        *reinterpret_cast<float2*>(part_o + prow * dh + col) =
            make_float2(o[4 * cc + 2 * i], o[4 * cc + 2 * i + 1]);
    }
  }
}

// One block's walk over stages [s_lo, s_hi) of keys [0, limit), its
// output columns those of V units [v_lo, v_lo + n_v) (128 columns each);
// the output into `out` (part_o null) or as this split's partials.
template <typename E, typename KVT, class Rows>
__device__ __forceinline__ void walk(const Rows& tl, E* __restrict__ out,
                                     float* __restrict__ part_o,
                                     float* __restrict__ part_ml, int dh,
                                     int cb, int limit, int s_lo, int s_hi,
                                     float scale_log2) {
  constexpr bool kFP8 = sizeof(KVT) == 1;
  constexpr bool kTMA = Rows::kTMA;
  using Tile = wg::AttnTile<128, E>;
  const Plan pl = make_plan(dh);
  const int v_lo = cb * pl.n_vu / pl.n_cb;
  const int n_v = (cb + 1) * pl.n_vu / pl.n_cb - v_lo;   // 2 to 4
  const int w = threadIdx.x / 128;                        // consumer 0 or 1
  const int ct = threadIdx.x % 128;
  const int lane = threadIdx.x & 31;
  const int my_s = (pl.n_s - w + 1) / 2;        // S units k == w (mod 2)
  const int my_v = (n_v - w + 1) / 2;           // V units v == w (mod 2)
  const int per = my_s + my_v;                  // this consumer's units a stage
  const int n_units = (s_hi - s_lo) * per;

  extern __shared__ __align__(1024) unsigned char smem_ww[];
  unsigned char* sm = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_ww) + 1023) & ~uintptr_t(1023));
  unsigned char* ring = sm + pl.ring_off + w * RING * UNIT;   // this consumer's
  float* xbuf = reinterpret_cast<float*>(sm + pl.x_off);

  // One 64 x 64 half: kind 0 Q rows, 1 K rows, 2 V rows of stage `st`,
  // columns of chunk `c`, by this consumer's 128 threads, into the
  // swizzled tile `dst`.  An fp8 row's 16-byte chunk j (16 values) lands
  // raw in the row's chunk 2j + 1, the second of the two chunks its E
  // values fill, so the thread that copied it widens it in place.
  auto copy_half = [&](unsigned char* dst, int kind, int c, int st) {
    if constexpr (!kTMA) {       // kernel 2 copies through TMA
      const int col0 = c * 64;
      if (kind == 0 || !kFP8) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = ct / 8 + 16 * i, j = ct % 8;
          const int col = col0 + j * 8;
          const void* src = tl.base();
          bool valid = col < dh;
          if (kind == 0) {
            valid = valid && tl.live(r);
            if (valid) src = tl.q_row(r) + col;
          } else {
            const int pos = st * BK + r;
            valid = valid && pos < limit;
            if constexpr (!kFP8)
              if (valid) src = tl.kv_row(pos, kind - 1) + col;
          }
          cp_async16(dst + wg::swz(r, j, 64), src, valid ? 16 : 0);
        }
      } else {
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int r = ct / 4 + 32 * i, j = ct % 4;
          const int col = col0 + j * 16, pos = st * BK + r;
          const bool valid = col < dh && pos < limit;
          const void* src =
              valid ? static_cast<const void*>(tl.kv_row(pos, kind - 1) +
                                               col)
                    : tl.base();
          cp_async16(dst + wg::swz(r, 2 * j + 1, 64), src, valid ? 16 : 0);
        }
      }
    }
  };
  // this consumer's unit u: its stage, whether an S unit, and the halves'
  // (kind, chunk); chunk -1 for none
  auto unit_halves = [&](int u, int (&kind)[2], int (&chunk)[2], int& st) {
    st = s_lo + u / per;
    const int k = u % per;
    if (k < my_s) {
      const int s_unit = 2 * k + w;
      if (pl.resident) {
        kind[0] = kind[1] = 1;
        chunk[0] = 2 * s_unit;
        chunk[1] = 2 * s_unit + 1 < pl.nch ? 2 * s_unit + 1 : -1;
      } else {
        kind[0] = 0, kind[1] = 1;
        chunk[0] = chunk[1] = s_unit;
      }
    } else {
      const int v = v_lo + 2 * (k - my_s) + w;
      kind[0] = kind[1] = 2;
      chunk[0] = 2 * v;
      chunk[1] = 2 * v + 1 < pl.nch ? 2 * v + 1 : -1;
    }
  };
  // kernel 2: one mbarrier a slot of each consumer, then Q's
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + pl.bar_off);
  uint64_t* qbar = full + 2 * RING;
  if constexpr (kTMA) {
    if (threadIdx.x == 0) {
      for (int i = 0; i < 2 * RING + 1; ++i) wg::mbar_init(&full[i], 1);
      wg::mbar_fence_init();
    }
    __syncthreads();
  }
  // Unit u's copies: kernel 1 by this consumer's 128 threads (one
  // cp.async group, empty past the last unit), kernel 2 by its thread 0
  // (one TMA box a half, counted in bytes on the slot's mbarrier).
  auto issue = [&](int u) {
    if (u < n_units && (!kTMA || ct == 0)) {
      int kind[2], chunk[2], st;
      unit_halves(u, kind, chunk, st);
      unsigned char* slot = ring + (u % RING) * UNIT;
      if constexpr (kTMA) {
        uint64_t* bar = &full[w * RING + u % RING];
        wg::mbar_expect_tx(bar, (chunk[1] >= 0 ? 2 : 1) * HALF);
#pragma unroll
        for (int h = 0; h < 2; ++h)
          if (chunk[h] >= 0)
            wg::tma_load_4d(slot + h * HALF, tl.map(kind[h]), bar,
                            chunk[h] * 64, tl.h,
                            kind[h] == 0 ? tl.q0 : st * BK, tl.b);
      } else {
#pragma unroll
        for (int h = 0; h < 2; ++h)
          if (chunk[h] >= 0)
            copy_half(slot + h * HALF, kind[h], chunk[h], st);
      }
    }
    if constexpr (!kTMA)
      cp_async_commit();     // (possibly empty) group keeps the count exact
  };
  // Unit u landed for every thread of this consumer (u 0: Q too), its fp8
  // chunks widened to E, visible to `wgmma`; the slot of unit u - 2,
  // whose products every warp has waited for, is refilled with unit u +
  // LAG.
  auto acquire = [&](int u) -> uint32_t {
    unsigned char* slot = ring + (u % RING) * UNIT;
    if constexpr (kTMA) {
      if (u == 0 && pl.resident) wg::mbar_wait_or_trap(qbar, 0);
      wg::mbar_wait_or_trap(&full[w * RING + u % RING], (u / RING) & 1);
      wg::bar_sync(1 + w, 128);
    } else {
      cp_async_wait_n<LAG - 1>();
      if constexpr (kFP8) {
        int kind[2], chunk[2], st;
        unit_halves(u, kind, chunk, st);
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            if (chunk[h] < 0 || kind[h] == 0) continue;
            const int r = ct / 4 + 32 * i, j = ct % 4;
            unsigned char* t = slot + h * HALF;
            uint32_t o[8];
            fp8x16_to_e<E, KVT>(*reinterpret_cast<const uint4*>(
                                    t + wg::swz(r, 2 * j + 1, 64)),
                                o);
            *reinterpret_cast<uint4*>(t + wg::swz(r, 2 * j, 64)) =
                make_uint4(o[0], o[1], o[2], o[3]);
            *reinterpret_cast<uint4*>(t + wg::swz(r, 2 * j + 1, 64)) =
                make_uint4(o[4], o[5], o[6], o[7]);
          }
      }
      wg::fence_proxy_async();
      if (u == 0)
        __syncthreads();     // Q was copied by both consumers
      else
        wg::bar_sync(1 + w, 128);
    }
    issue(u + LAG);
    return wg::smem_u32(slot);
  };

  if (pl.resident) {         // Q's chunks, once
    if constexpr (kTMA) {
      if (threadIdx.x == 0) {
        wg::mbar_expect_tx(qbar, pl.nch * HALF);
        for (int c = 0; c < pl.nch; ++c)
          wg::tma_load_4d(sm + c * HALF, tl.mq, qbar, c * 64, tl.h,
                          tl.q0, tl.b);
      }
    } else {                 // chunk c by consumer c % 2
      for (int c = w; c < pl.nch; c += 2) copy_half(sm + c * HALF, 0, c, 0);
    }
  }
  if constexpr (!kTMA)
    cp_async_commit();       // Q: a group of its own, before unit 0's
#pragma unroll
  for (int u = 0; u < LAG; ++u) issue(u);

  int last[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) last[i] = tl.last(Tile::row(i));
  int first_last = 0x7fffffff;   // the earliest last position of a row
  for (int i = 0; i < BQ; ++i)
    if (tl.live(i)) first_last = min(first_last, tl.last(i));

  float o0[64], o1[64], m[2] = {wg::NEG, wg::NEG}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int x = 0; x < 64; ++x) o0[x] = o1[x] = 0.f;
  const uint32_t qa = wg::smem_u32(sm);
  int u = 0;
  for (int st = s_lo; st < s_hi; ++st) {
    // ---- S over this consumer's chunks of the head dim
    float s[32];
    bool first = true;
    for (int i = 0; i < my_s; ++i) {
      const int s_unit = 2 * i + w;
      const uint32_t ua = acquire(u++);
      wg::wgmma_fence();
      if (pl.resident) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int c = 2 * s_unit + h;
          if (c >= pl.nch) break;
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            wg::wgmma_ss_m64n64k16<E>(
                s, wg::smem_desc(qa + c * HALF + kk * 32, 16, 1024),
                wg::smem_desc(ua + h * HALF + kk * 32, 16, 1024),
                first ? 0 : 1);
            first = false;
          }
        }
      } else {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          wg::wgmma_ss_m64n64k16<E>(
              s, wg::smem_desc(ua + kk * 32, 16, 1024),
              wg::smem_desc(ua + HALF + kk * 32, 16, 1024), first ? 0 : 1);
          first = false;
        }
      }
      wg::wgmma_commit();
      wg::wgmma_wait<1>();   // unit u - 1's products done: its slot is free
    }
    wg::wgmma_wait<0>();     // S, and the last stage's P V
    wg::fence_regs(s);
    wg::fence_regs(o0);
    wg::fence_regs(o1);

    // ---- the two partial S summed once, by consumer 0: both then hold
    // the same s0 + s1 bit for bit
    if (w == 1) {
#pragma unroll
      for (int x = 0; x < 32; ++x) xbuf[x * 128 + ct] = s[x];
    }
    wg::bar_sync(3, 256);
    if (w == 0) {
#pragma unroll
      for (int x = 0; x < 32; ++x) {
        s[x] += xbuf[x * 128 + ct];
        xbuf[x * 128 + ct] = s[x];
      }
    }
    wg::bar_sync(3, 256);
    if (w == 1) {
#pragma unroll
      for (int x = 0; x < 32; ++x) s[x] = xbuf[x * 128 + ct];
    }

    // ---- online softmax in f32 (log2 units)
    const int k0 = st * BK;
    const bool masked = k0 + BK - 1 > first_last;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float mx = wg::NEG;
#pragma unroll
      for (int c = 0; c < 8; ++c)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float x = s[4 * c + 2 * i + e] * scale_log2;
          if (masked && k0 + Tile::col(c, e) > last[i]) x = -INFINITY;
          s[4 * c + 2 * i + e] = x;
          mx = fmaxf(mx, x);
        }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = exp2f(m[i] - m_new);
      m[i] = m_new;
      float rs = 0.f;
#pragma unroll
      for (int c = 0; c < 8; ++c)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float p = exp2f(s[4 * c + 2 * i + e] - m_new);
          s[4 * c + 2 * i + e] = p;
          rs += p;
        }
      l[i] = l[i] * alpha + rs;
#pragma unroll
      for (int c = 0; c < 16; ++c) {
        o0[4 * c + 2 * i] *= alpha;
        o0[4 * c + 2 * i + 1] *= alpha;
        o1[4 * c + 2 * i] *= alpha;
        o1[4 * c + 2 * i + 1] *= alpha;
      }
    }
    uint32_t p[16];   // P in E: the A operand of O += P V
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int h = 0; h < 4; ++h)
        p[4 * kk + h] = wg::pack<E>(s[8 * kk + 2 * h], s[8 * kk + 2 * h + 1]);

    // ---- O += P V over this consumer's V units, left in flight under
    // the next stage's S
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (i >= my_v) break;
      const uint32_t va = acquire(u++);
      wg::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint32_t a[4] = {p[4 * kk], p[4 * kk + 1], p[4 * kk + 2],
                               p[4 * kk + 3]};
        const uint64_t dv = wg::smem_desc(va + kk * 16 * 128, HALF, 1024);
        if (i == 0)
          wg::wgmma_rs_m64n128k16<E>(o0, a, dv);
        else
          wg::wgmma_rs_m64n128k16<E>(o1, a, dv);
      }
      wg::wgmma_commit();
      wg::wgmma_wait<1>();
    }
  }
  wg::wgmma_wait<0>();
  wg::fence_regs(o0);
  wg::fence_regs(o1);
  cp_async_wait_all();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = Tile::row(i);
    if (!tl.exists(r)) continue;
    const bool live = tl.live(r);
    store_unit<E>(o0, i, (v_lo + w) * 128, dh, live, l[i], out, part_o,
                  tl.o_off(r), tl.prow(r));
    if (my_v > 1)
      store_unit<E>(o1, i, (v_lo + 2 + w) * 128, dh, live, l[i], out,
                    part_o, tl.o_off(r), tl.prow(r));
    if (part_o != nullptr && live && cb == 0 && w == 0 && (lane & 3) == 0)
      *reinterpret_cast<float2*>(part_ml + tl.prow(r) * 2) =
          make_float2(m[i], l[i]);
  }
}

// Kernel 1 over the fused page pool: lane b holds q_lens[b] rows over
// kv_lens[b] positions.  Grid (tiles x column blocks, Hkv, B x n_split).
template <typename E, typename KVT>
__global__ void __launch_bounds__(NTHREADS, 1)
    paged_wgmma_wide_kernel(const E* __restrict__ q,
                            const KVT* __restrict__ pool,
                            const int* __restrict__ tables,
                            const int* __restrict__ q_lens,
                            const int* __restrict__ kv_lens,
                            E* __restrict__ out, float* __restrict__ part_o,
                            float* __restrict__ part_ml, int B, int M, int Hq,
                            int Hkv, int P, int S, int MP, int n_split,
                            float scale_log2, int dh, int n_cb) {
  // latest rows first: a chunk's later rows see more keys
  const int tile = gridDim.x / n_cb - 1 - blockIdx.x / n_cb;
  const int cb = blockIdx.x % n_cb;
  const int b = blockIdx.z / n_split, split = blockIdx.z % n_split;
  PagedRows<E, KVT> tl;
  tl.q = q;
  tl.pool = pool;
  tl.tab = tables + (size_t)b * MP;
  tl.M = M, tl.Hq = Hq, tl.Hkv = Hkv, tl.G = Hq / Hkv;
  tl.P = P, tl.S = S, tl.dh = dh, tl.b = b, tl.hk = blockIdx.y;
  tl.qn = q_lens[b];
  const int kvn = kv_lens[b];
  tl.start = kvn - tl.qn;                      // position of query row 0
  tl.row0 = tile * BQ;
  tl.rows_total = M * tl.G;
  tl.split_base = (size_t)split * B * M * Hq;
  // keys [0, limit) are all this tile's rows can see
  const int j_lo = tl.row0 / tl.G;
  const int j_last = min(min((tl.row0 + BQ - 1) / tl.G, M - 1), tl.qn - 1);
  int limit = 0;
  if (j_last >= j_lo) limit = min(tl.start + j_last + 1, kvn);
  limit = max(0, min(limit, MP * S));
  const int n_st = (limit + BK - 1) / BK;
  walk<E, KVT>(tl, out, n_split > 1 ? part_o : nullptr, part_ml, dh, cb,
               limit, split * n_st / n_split, (split + 1) * n_st / n_split,
               scale_log2);
}

// Kernel 2: (B, T, H, D) views read through TMA maps of inner dimension
// D (rows past T and columns past D read zeros).  Grid ((b, h) x column
// blocks, query tiles): heaviest causal tile first.
template <typename E>
__global__ void __launch_bounds__(NTHREADS, 1)
    dense_wgmma_wide_kernel(const __grid_constant__ CUtensorMap tq,
                            const __grid_constant__ CUtensorMap tk,
                            const __grid_constant__ CUtensorMap tv,
                            E* __restrict__ out, int Tlen, int H, int causal,
                            float scale_log2, int dh, int n_cb) {
  const int bh = blockIdx.x / n_cb, cb = blockIdx.x % n_cb;
  DenseRows<E> tl;
  tl.mq = &tq, tl.mk = &tk, tl.mv = &tv;
  tl.b = bh / H, tl.h = bh % H;
  tl.obase = ((size_t)tl.b * Tlen * H + tl.h) * dh;
  tl.Tlen = Tlen, tl.H = H, tl.dh = dh, tl.causal = causal;
  tl.q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  const int limit = causal ? min(Tlen, tl.q0 + BQ) : Tlen;
  walk<E, E>(tl, out, nullptr, nullptr, dh, cb, limit, 0,
             (limit + BK - 1) / BK, scale_log2);
}

// The tensor-core wide kernel's registers a thread, dynamic shared memory
// at head dim `dh` and local memory a thread into out[0..2].
template <class Kern>
int attributes(Kern kern, int dh, int* out) {
  return kernel_attributes(kern, make_plan(dh).bytes, out);
}

// Kernel 1's tensor-core wide form for q code `qc` (1 bf16, 2 f16) over
// page code `kv` (q's own type, e4m3 or e5m2).  Scratch, when n_split >
// 1: f32 partials of n_split * B * M * Hq * D values, one more when that
// count is odd, then n_split * B * M * Hq (m, l) pairs.
inline int launch_paged(int qc, int kv, const void* q, const void* pool,
                        const int* tables, const int* q_lens,
                        const int* kv_lens, void* out, void* scratch, int B,
                        int M, int Hq, int Hkv, int D, int P, int S, int MP,
                        int n_split, float sm_scale, cudaStream_t st) {
  if (D <= FMA_WIDTH || D % 16) return -1;
  return with_q_type(qc, [&](auto qt) {
    return with_kv_type(kv, [&](auto kt) {
      using E = typename decltype(qt)::type;
      using KVT = typename decltype(kt)::type;
      if constexpr (tensor_core_pair<E, KVT>) {
        if (reinterpret_cast<uintptr_t>(q) % 16)
          return (int)cudaErrorMisalignedAddress;
        const Plan pl = make_plan(D);
        const int G = Hq / Hkv;
        const long long nx = (long long)(M * G + BQ - 1) / BQ * pl.n_cb;
        if (nx > 2147483647LL || Hkv > 65535 ||
            (long long)B * n_split > 65535 || n_split < 1 ||
            (n_split > 1 && scratch == nullptr) || pl.bytes > SMEM_LIMIT)
          return (int)cudaErrorInvalidConfiguration;
        auto kern = paged_wgmma_wide_kernel<E, KVT>;
        static std::atomic<bool> smem_set[MAX_DEVICES];
        if (int e = enable_smem(kern, SMEM_LIMIT, smem_set)) return e;
        const size_t rows = (size_t)B * M * Hq, n_o = n_split * rows * D;
        float* part_o = static_cast<float*>(scratch);
        float* part_ml = part_o + n_o + n_o % 2;  // (m, l) at an even offset
        kern<<<dim3((unsigned)nx, Hkv, B * n_split), NTHREADS, pl.bytes,
               st>>>(static_cast<const E*>(q), static_cast<const KVT*>(pool),
                     tables, q_lens, kv_lens, static_cast<E*>(out), part_o,
                     part_ml, B, M, Hq, Hkv, P, S, MP, n_split,
                     sm_scale * 1.4426950408889634f, D, pl.n_cb);
        if (n_split == 1) return (int)cudaGetLastError();
        if (cudaError_t e = cudaGetLastError()) return (int)e;
        wide::wide_merge_kernel<true>
            <<<(unsigned)((rows + 3) / 4), 128, 0, st>>>(
                part_o, part_ml, q_lens, static_cast<AnyQ*>(out), M, Hq,
                rows, n_split, D, qc);
        return (int)cudaGetLastError();
      }
      return -1;
    });
  });
}

// Kernel 2's tensor-core wide form (st: the element strides (b, t, h) of
// q, k, v; every row 16-byte aligned).
template <typename E>
int launch_dense(const void* q, const void* k, const void* v, void* out,
                 int B, int Tlen, int H, int D, const long long* st,
                 int causal, float sm_scale, cudaStream_t stream) {
  if (D <= FMA_WIDTH || D % 16) return -1;
  const Plan pl = make_plan(D);
  const long long nx = (long long)B * H * pl.n_cb;
  const int n_qt = (Tlen + BQ - 1) / BQ;
  if (nx > 2147483647LL || n_qt > 65535 || pl.bytes > SMEM_LIMIT)
    return (int)cudaErrorInvalidConfiguration;
  const unsigned long long es = sizeof(E);
  if (copy_width({(unsigned long long)(uintptr_t)q,
                  (unsigned long long)(uintptr_t)k,
                  (unsigned long long)(uintptr_t)v,
                  (unsigned long long)st[0] * es,
                  (unsigned long long)st[1] * es,
                  (unsigned long long)st[2] * es,
                  (unsigned long long)st[3] * es,
                  (unsigned long long)st[4] * es,
                  (unsigned long long)st[5] * es,
                  (unsigned long long)st[6] * es,
                  (unsigned long long)st[7] * es,
                  (unsigned long long)st[8] * es}) < 16)
    return (int)cudaErrorMisalignedAddress;
  const CUtensorMapDataType dt = wg::is_f16<E>
                                     ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                                     : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  CUtensorMap mq, mk, mv;
  if (int e = tma::make_map(&mq, dt, q, B, Tlen, H, D, st[0], st[1], st[2]))
    return e;
  if (int e = tma::make_map(&mk, dt, k, B, Tlen, H, D, st[3], st[4], st[5]))
    return e;
  if (int e = tma::make_map(&mv, dt, v, B, Tlen, H, D, st[6], st[7], st[8]))
    return e;
  auto kern = dense_wgmma_wide_kernel<E>;
  static std::atomic<bool> smem_set[MAX_DEVICES];
  if (int e = enable_smem(kern, SMEM_LIMIT, smem_set)) return e;
  kern<<<dim3((unsigned)nx, n_qt), NTHREADS, pl.bytes, stream>>>(
      mq, mk, mv, static_cast<E*>(out), Tlen, H, causal,
      sm_scale * 1.4426950408889634f, D, pl.n_cb);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace wwg
}  // namespace tpulab
