// The wide fma form of the port's three attention kernels: every head dim
// past 256, on NVIDIA Hopper (sm_90a).
//
// Replaces, for D > 256, the Pallas TPU kernels `_ragged_attn`
// (tpulab/ops/ragged_attention.py:190), `_flash_bhd`
// (tpulab/ops/flash_attention.py:80) and `_paged_attn`
// (tpulab/ops/paged_attention.py:221), which take the head dim as a
// parameter with no upper limit (DeepSeek-V4-Flash's heads are 512 wide,
// sarvam-105b's latent heads 576).  What each computes is what its D <= 256
// bodies compute (ragged_attention.cuh, flash_attention.cu,
// paged_attention.cuh): the same visibility, the same f32 online softmax,
// q scaled by 1/sqrt(D) before the dot, every product an f32 FMA.
//
// Why a form of its own.  The fma bodies hold a block's query rows and
// two stages of K and V rows at their full width in shared memory and a
// D/32 (or D/16) slice of every row's output in registers; past 256
// columns they no longer fit a block's 227 KB (kernel 1 at D 512 over f32
// pages: 264 KB of K/V alone).  This form keeps the D 256 padded body's
// shared memory and registers at every D:
// * The output's columns are split into slabs of W = 256; the grid's x
//   axis walks (tile, slab), slab fastest, so the blocks of one tile read
//   the same K rows out of L2 one after the other.
// * Each block computes its rows' scores S = Q K^T over the whole head
//   dim, walking it in chunks of W columns through the same two K buffers
//   (32 positions x W columns), with the matching chunk of Q (32 rows x W,
//   scaled, f32) rewritten into shared memory before each K chunk; then
//   O += P V over its slab of V's columns only.  A stage of 32 positions
//   is ceil(D / W) K chunks and one V slab: each a cp.async group,
//   double-buffered (the next one in flight while this one is used).
// * Every slab computes the same S in the same order, so its online
//   softmax's (m, l) and P are the same bit for bit, and no slab has to
//   talk to another.  The price is S recomputed once a slab: ceil(D / W)
//   times the Q K^T work of one pass (PERF.md, open questions).
// * The last K chunk's columns past the head dim are zero-filled without
//   a read (so they add nothing to S); a V slab's columns past the head
//   dim are never copied, and the output's are never stored.  Rows are
//   copied in the widest chunks their bytes allow (16 down to 1).
// * Lane t of a warp scores key t of the stage against the warp's four
//   query rows; for P V each lane owns 8 of the slab's 256 columns.
// * Split-KV (kernels 1 and 3): where the (tile, KV head, lane, slab)
//   blocks do not fill the card, the grid's z axis also walks splits of
//   each lane's stages; each split writes f32 partials (unnormalised O
//   for its slab's columns, and from slab 0 the row's (m, l), at an even
//   float offset whatever D is) and `wide_merge_kernel` adds them in split
//   order: no atomics, so a second launch is bit-identical.
// Kernels 1 and 3 run one kernel, `paged_wide_kernel`, over the fused
// page pool (kernel 3's inclusive `lengths` are one query row a lane over
// lengths + 1 positions); kernel 2 runs `dense_wide_kernel` over its
// strided (B, T, H, D) views.  q's type is taken at run time (AnyQ), so
// each library instantiates one wide kernel a page (or flash) type.
#pragma once

#include "common.cuh"
#include "wide_merge.cuh"

namespace tpulab {
namespace wide {
namespace {

constexpr int W = 256;                  // columns of a Q/K chunk, a V/O slab
constexpr int KT = 32;                  // key positions a stage: one a lane
constexpr int NWARPS = 8;
constexpr int RPW = 4;                  // query rows a warp
constexpr int ROWS = NWARPS * RPW;      // query rows a block
constexpr int NTHREADS = NWARPS * 32;
constexpr int DPL = W / 32;             // a lane's output columns of a slab

template <typename KVT>
struct Geometry {
  static constexpr int EPC = 16 / (int)sizeof(KVT);   // values a 16 B chunk
  static constexpr int LD = W + EPC;                  // padded row stride
  static constexpr size_t buf_bytes = (size_t)KT * LD * sizeof(KVT);
  static constexpr size_t kv_bytes = 4 * buf_bytes;   // K [2], then V [2]
  static constexpr size_t smem_bytes = kv_bytes + sizeof(float) * ROWS * W;
};

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

__host__ __device__ inline int slabs(int dh) { return (dh + W - 1) / W; }

// One block's walk: `tl` names its rows and keys (PagedRows, DenseRows),
// keys [0, limit) are all its rows can see, stages [s_lo, s_hi) its share
// of them; the slab `slab` of the output is written to `out`, or (part_o
// non-null) as this split's partials.  Rows i of the block: tl.exists(i)
// (an output row), tl.live(i) (a query row: the others are written as
// zeros), tl.q_off(i) / tl.o_off(i) (element offsets of column 0),
// tl.last(i) (the last position it sees), tl.prow(i) (its partials' row);
// tl.keys(pos, k, v) the addresses of position pos's K and V rows.
template <typename QT, typename KVT, class Rows>
__device__ __forceinline__ void walk(const Rows& tl, const QT* __restrict__ q,
                                     QT* __restrict__ out,
                                     float* __restrict__ part_o,
                                     float* __restrict__ part_ml, int dh,
                                     int slab, int limit, int s_lo, int s_hi,
                                     float sm_scale, int cw, int qc) {
  using Geo = Geometry<KVT>;
  constexpr int EPC = Geo::EPC, LD = Geo::LD;
  constexpr int ESZ = (int)sizeof(KVT);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int nch = slabs(dh);
  const int c0 = slab * W, sw = min(W, dh - c0);   // this slab's columns

  extern __shared__ __align__(16) unsigned char smem_wide[];
  KVT* ks = reinterpret_cast<KVT*>(smem_wide);          // [2][KT][LD]
  KVT* vs = ks + 2 * KT * LD;                           // [2][KT][LD]
  // [ROWS][W]: this chunk of Q, scaled, in f32
  float* qs = reinterpret_cast<float*>(smem_wide + Geo::kv_bytes);

  // unit u of the walk: stage s_lo + u / (nch + 1); K chunk u % (nch + 1),
  // or the V slab when that is nch
  const int n_units = (s_hi - s_lo) * (nch + 1);
  auto load_unit = [&](int u) {
    const int st = u / (nch + 1), c = u % (nch + 1);
    const int t0 = (s_lo + st) * KT;
    const bool is_v = c == nch;
    const int col0 = is_v ? c0 : c * W;
    const int ncol = is_v ? sw : min(W, dh - col0);     // columns with data
    KVT* dst = is_v ? vs + (size_t)(st & 1) * KT * LD
                    : ks + (size_t)((st * nch + c) & 1) * KT * LD;
    // a K chunk's columns past the head dim are zero-filled; a V slab's
    // are never read
    for_row_chunks(KT, (is_v ? ncol : W) * ESZ, cw, threadIdx.x, NTHREADS,
                   [&](int t, int off) {
      const int pos = t0 + t;
      const bool valid = pos < limit && off < ncol * ESZ;
      const unsigned char* src = reinterpret_cast<const unsigned char*>(q);
      if (valid) {
        const KVT *kr, *vr;
        tl.keys(pos, kr, vr);
        src = reinterpret_cast<const unsigned char*>((is_v ? vr : kr) + col0) +
              off;
      }
      copy_chunk(reinterpret_cast<unsigned char*>(dst + (size_t)t * LD) + off,
                 src, cw, valid);
    });
  };

  int last[RPW];          // the last position each of this warp's rows sees
#pragma unroll
  for (int k = 0; k < RPW; ++k) {
    const int i = k * NWARPS + warp;     // interleaved: decode rows spread
    last[k] = tl.live(i) ? min(tl.last(i), limit - 1) : -1;
  }
  float m_r[RPW], l_r[RPW], sc[RPW], acc[RPW][DPL];
#pragma unroll
  for (int k = 0; k < RPW; ++k) {
    m_r[k] = NEG;
    l_r[k] = 0.f;
    sc[k] = 0.f;
#pragma unroll
    for (int x = 0; x < DPL; ++x) acc[k][x] = 0.f;
  }

  if (n_units > 0) load_unit(0);
  cp_async_commit();
  for (int u = 0; u < n_units; ++u) {
    if (u + 1 < n_units) load_unit(u + 1);
    cp_async_commit();       // (possibly empty) group keeps wait_group 1 exact
    const int st = u / (nch + 1), c = u % (nch + 1);
    const int t0 = (s_lo + st) * KT;
    if (c < nch) {           // Q's chunk c, scaled; columns past D are zeros
      const int col0 = c * W, ncol = min(W, dh - col0);
#pragma unroll 4
      for (int i = 0; i < ROWS; ++i) {
        const int d = threadIdx.x;      // NTHREADS == W: one column a thread
        qs[i * W + d] = d < ncol && tl.live(i)
                            ? q_load(q, tl.q_off(i) + col0 + d, qc) * sm_scale
                            : 0.f;
      }
    }
    cp_async_wait_1();
    __syncthreads();         // the unit landed; Q's chunk is written
    if (c < nch) {
      const KVT* kb = ks + (size_t)((st * nch + c) & 1) * KT * LD;
#pragma unroll
      for (int k = 0; k < RPW; ++k) {
        const int i = k * NWARPS + warp;
        const int nvis = min(last[k] + 1 - t0, KT);     // warp-uniform
        if (nvis <= 0 || lane >= nvis) continue;
        const float* qr = qs + i * W;
        const KVT* kr = kb + lane * LD;
        float a = 0.f;
#pragma unroll 8
        for (int d = 0; d < W; d += EPC) {
          float kf[EPC];
          load_vals<EPC>(kr + d, kf);
#pragma unroll
          for (int e = 0; e < EPC; ++e) a = fmaf(qr[d + e], kf[e], a);
        }
        sc[k] += a;
      }
    } else {                 // the stage's scores are whole: softmax, P V
      const KVT* vb = vs + (size_t)(st & 1) * KT * LD;
#pragma unroll
      for (int k = 0; k < RPW; ++k) {
        const int nvis = min(last[k] + 1 - t0, KT);     // warp-uniform
        if (nvis <= 0) continue;
        const float s = lane < nvis ? sc[k] : NEG;
        sc[k] = 0.f;
        const float m_new = fmaxf(m_r[k], warp_max(s));
        const float alpha = expf(m_r[k] - m_new);
        const float p = lane < nvis ? expf(s - m_new) : 0.f;
        l_r[k] = l_r[k] * alpha + warp_sum(p);
        m_r[k] = m_new;
#pragma unroll
        for (int x = 0; x < DPL; ++x) acc[k][x] *= alpha;
        for (int t = 0; t < nvis; ++t) {
          const float pt = __shfl_sync(0xffffffffu, p, t);
          float vf[DPL];
          load_vals<DPL>(vb + t * LD + lane * DPL, vf);
#pragma unroll
          for (int x = 0; x < DPL; ++x) acc[k][x] = fmaf(pt, vf[x], acc[k][x]);
        }
      }
    }
    __syncthreads();         // the buffers and Q's chunk are refilled next
  }
  cp_async_wait_all();

#pragma unroll
  for (int k = 0; k < RPW; ++k) {
    const int i = k * NWARPS + warp;
    if (!tl.exists(i)) continue;                        // warp-uniform
    const bool live = tl.live(i);
    if (part_o == nullptr) {
      const size_t o = tl.o_off(i) + c0 + lane * DPL;
      const float inv = 1.f / fmaxf(l_r[k], 1e-30f);
#pragma unroll
      for (int x = 0; x < DPL; ++x)
        if (lane * DPL + x < sw)
          q_store(out, o + x, qc, live ? acc[k][x] * inv : 0.f);
    } else if (live) {
      const size_t pr = tl.prow(i);
      float* po = part_o + pr * dh + c0 + lane * DPL;
#pragma unroll
      for (int x = 0; x < DPL; ++x)
        if (lane * DPL + x < sw) po[x] = acc[k][x];
      if (slab == 0 && lane == 0)
        *reinterpret_cast<float2*>(part_ml + pr * 2) =
            make_float2(m_r[k], l_r[k]);
    }
  }
}

// Kernels 1 and 3: rows (j, g) of lane b's query rows over KV head hk,
// row0 the block's first.
template <typename KVT>
struct PagedRows {
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
  __device__ size_t q_off(int i) const { return row(i) * dh; }
  __device__ size_t o_off(int i) const { return row(i) * dh; }
  __device__ size_t prow(int i) const { return split_base + row(i); }
  __device__ int last(int i) const { return start + (row0 + i) / G; }
  __device__ void keys(int pos, const KVT*& k, const KVT*& v) const {
    const int page = min(max(tab[pos / S], 0), P - 1);
    k = pool + (((size_t)page * 2 * S + pos % S) * Hkv + hk) * dh;
    v = k + (size_t)S * Hkv * dh;
  }
};

// Kernel 1 (q_lens non-null: lane b holds q_lens[b] rows over kv_lens[b]
// positions) and kernel 3 (q_lens null: one row a lane over positions
// 0..kv_lens[b], its inclusive `lengths`).  Grid (tiles x slabs, Hkv,
// B x n_split).
template <typename KVT>
__global__ void __launch_bounds__(NTHREADS)
    paged_wide_kernel(const AnyQ* __restrict__ q, const KVT* __restrict__ pool,
                      const int* __restrict__ tables,
                      const int* __restrict__ q_lens,
                      const int* __restrict__ kv_lens, AnyQ* __restrict__ out,
                      float* __restrict__ part_o, float* __restrict__ part_ml,
                      int B, int M, int Hq, int Hkv, int P, int S, int MP,
                      int n_split, float sm_scale, int dh, int cw, int qc) {
  const int n_slab = slabs(dh);
  const int tile = blockIdx.x / n_slab, slab = blockIdx.x % n_slab;
  const int b = blockIdx.z / n_split, split = blockIdx.z % n_split;
  PagedRows<KVT> tl;
  tl.pool = pool;
  tl.tab = tables + (size_t)b * MP;
  tl.M = M, tl.Hq = Hq, tl.Hkv = Hkv, tl.G = Hq / Hkv;
  tl.P = P, tl.S = S, tl.dh = dh, tl.b = b, tl.hk = blockIdx.y;
  tl.qn = q_lens ? q_lens[b] : 1;
  const int kvn = q_lens ? kv_lens[b] : kv_lens[b] + 1;
  tl.start = kvn - tl.qn;                      // position of query row 0
  tl.row0 = tile * ROWS;
  tl.rows_total = M * tl.G;
  tl.split_base = (size_t)split * B * M * Hq;
  // keys [0, limit) are all this tile's rows can see
  const int j_lo = tl.row0 / tl.G;
  const int j_last = min(min((tl.row0 + ROWS - 1) / tl.G, M - 1), tl.qn - 1);
  int limit = 0;
  if (j_last >= j_lo) limit = min(tl.start + j_last + 1, kvn);
  limit = max(0, min(limit, MP * S));
  const int n_st = (limit + KT - 1) / KT;
  walk<AnyQ, KVT>(tl, q, out, n_split > 1 ? part_o : nullptr, part_ml, dh,
                  slab, limit, split * n_st / n_split,
                  (split + 1) * n_st / n_split, sm_scale, cw, qc);
}

// Kernel 2: rows q0 + i of (b, h) over the strided (B, T, H, D) views.
template <typename T>
struct DenseRows {
  const T* kb;
  const T* vb;
  long long qbase, qst, kst, vst;
  size_t obase;          // ((b * T) * H + h) * D
  int Tlen, H, dh, q0, causal;
  __device__ bool exists(int i) const { return q0 + i < Tlen; }
  __device__ bool live(int i) const { return q0 + i < Tlen; }
  __device__ size_t q_off(int i) const { return qbase + (q0 + i) * qst; }
  __device__ size_t o_off(int i) const {
    return obase + (size_t)(q0 + i) * H * dh;
  }
  __device__ size_t prow(int) const { return 0; }
  __device__ int last(int i) const { return causal ? q0 + i : Tlen - 1; }
  __device__ void keys(int pos, const T*& k, const T*& v) const {
    k = kb + pos * kst;
    v = vb + pos * vst;
  }
};

// Grid ((b, h) x slabs, query tiles): heaviest causal tile first.
template <typename T>
__global__ void __launch_bounds__(NTHREADS)
    dense_wide_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, T* __restrict__ out, int Tlen,
                      int H, long long qsb, long long qst, long long qsh,
                      long long ksb, long long kst, long long ksh,
                      long long vsb, long long vst, long long vsh, int causal,
                      float sm_scale, int dh, int cw) {
  const int n_slab = slabs(dh);
  const int bh = blockIdx.x / n_slab, slab = blockIdx.x % n_slab;
  const int b = bh / H, h = bh % H;
  DenseRows<T> tl;
  tl.kb = k + b * ksb + h * ksh;
  tl.vb = v + b * vsb + h * vsh;
  tl.qbase = b * qsb + h * qsh;
  tl.qst = qst, tl.kst = kst, tl.vst = vst;
  tl.obase = ((size_t)b * Tlen * H + h) * dh;
  tl.Tlen = Tlen, tl.H = H, tl.dh = dh, tl.causal = causal;
  tl.q0 = (gridDim.y - 1 - blockIdx.y) * ROWS;
  const int limit = causal ? min(Tlen, tl.q0 + ROWS) : Tlen;
  walk<T, T>(tl, q, out, nullptr, nullptr, dh, slab, limit, 0,
             (limit + KT - 1) / KT, sm_scale, cw, 0);
}

// A wide kernel's registers a thread, dynamic shared memory and local
// memory a thread (spills) into out[0..2], from cudaFuncGetAttributes.
// Returns 0 or a cudaError_t code.
template <class Kern>
int attributes(Kern kern, size_t smem, int* out) {
  cudaFuncAttributes a;
  if (cudaError_t e = cudaFuncGetAttributes(&a, kern)) return (int)e;
  out[0] = a.numRegs;
  out[1] = (int)smem;
  out[2] = (int)a.localSizeBytes;
  return 0;
}

// Kernels 1 and 3's wide form for q code `qc` over page code `kv`; kernel
// 3 passes q_lens null and M 1.  Scratch, when n_split > 1: f32 partials
// of n_split * B * M * Hq * D values, one more when that count is odd,
// then n_split * B * M * Hq (m, l) pairs.
inline int launch_paged(int qc, int kv, const void* q, const void* pool,
                        const int* tables, const int* q_lens,
                        const int* kv_lens, void* out, void* scratch, int B,
                        int M, int Hq, int Hkv, int D, int P, int S, int MP,
                        int n_split, float sm_scale, cudaStream_t st) {
  if (D <= W || qc < 0 || qc > 2) return -1;
  const int G = Hq / Hkv;
  const long long nx = (long long)(M * G + ROWS - 1) / ROWS * slabs(D);
  if (nx > 2147483647LL || Hkv > 65535 || (long long)B * n_split > 65535 ||
      n_split < 1 || (n_split > 1 && scratch == nullptr))
    return (int)cudaErrorInvalidConfiguration;
  return with_kv_type(kv, [&](auto kt) {
    using KVT = typename decltype(kt)::type;
    auto kern = paged_wide_kernel<KVT>;
    const size_t smem = Geometry<KVT>::smem_bytes;
    static std::atomic<bool> smem_set[MAX_DEVICES];
    if (int e = enable_smem(kern, smem, smem_set)) return e;
    const size_t rows = (size_t)B * M * Hq, n_o = n_split * rows * D;
    float* part_o = static_cast<float*>(scratch);
    float* part_ml = part_o + n_o + n_o % 2;   // (m, l) at an even offset
    kern<<<dim3((unsigned)nx, Hkv, B * n_split), NTHREADS, smem, st>>>(
        static_cast<const AnyQ*>(q), static_cast<const KVT*>(pool), tables,
        q_lens, kv_lens, static_cast<AnyQ*>(out), part_o, part_ml, B, M, Hq,
        Hkv, P, S, MP, n_split, sm_scale, D,
        copy_width({(unsigned long long)D * sizeof(KVT)}), qc);
    if (n_split == 1) return (int)cudaGetLastError();
    if (cudaError_t e = cudaGetLastError()) return (int)e;
    wide_merge_kernel<false><<<(unsigned)((rows + 3) / 4), 128, 0, st>>>(
        part_o, part_ml, q_lens, static_cast<AnyQ*>(out), M, Hq, rows,
        n_split, D, qc);
    return (int)cudaGetLastError();
  });
}

// Kernel 2's wide form (st: the element strides (b, t, h) of q, k, v).
template <typename T>
int launch_dense(const void* q, const void* k, const void* v, void* out,
                 int B, int Tlen, int H, int D, const long long* st,
                 int causal, float sm_scale, cudaStream_t stream) {
  if (D <= W) return -1;
  const long long nx = (long long)B * H * slabs(D);
  const int n_qt = (Tlen + ROWS - 1) / ROWS;
  if (nx > 2147483647LL || n_qt > 65535)
    return (int)cudaErrorInvalidConfiguration;
  auto kern = dense_wide_kernel<T>;
  const size_t smem = Geometry<T>::smem_bytes;
  static std::atomic<bool> smem_set[MAX_DEVICES];
  if (int e = enable_smem(kern, smem, smem_set)) return e;
  // the widest chunk every K/V row start allows: the bases and the byte
  // strides of both views, and a row's bytes
  const unsigned long long es = sizeof(T);
  const int cw = copy_width(
      {(unsigned long long)(uintptr_t)k, (unsigned long long)(uintptr_t)v,
       (unsigned long long)st[3] * es, (unsigned long long)st[4] * es,
       (unsigned long long)st[5] * es, (unsigned long long)st[6] * es,
       (unsigned long long)st[7] * es, (unsigned long long)st[8] * es,
       (unsigned long long)D * es});
  kern<<<dim3((unsigned)nx, n_qt), NTHREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), Tlen, H, st[0], st[1],
      st[2], st[3], st[4], st[5], st[6], st[7], st[8], causal, sm_scale, D,
      cw);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace wide
}  // namespace tpulab
