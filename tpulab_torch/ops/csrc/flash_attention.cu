// Flash attention forward for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_flash_bhd` / `_attn_kernel`
// (tpulab/ops/flash_attention.py:80 and :28): blockwise attention with
// online softmax over (B, T, H, D) q, k, v, causal or not.  On the serving
// path it is the attention of the split plan's full-prompt prefill
// (`paged_prefill` with `make_flash_attention_fn`), one launch per layer.
//
// What it computes.  o[b, t, h] = softmax_s(q[b, t, h] . k[b, s, h] / sqrt(D))
// . v[b, s, h], over s < T (causal: s <= t).  Max, normaliser and the
// output accumulator are f32; the output is acc / max(l, 1e-30) in q's
// dtype.  K/V already carry q's head count (GQA callers repeat them).
// There is no TF32 anywhere.
//
// What bounds it on an H100.  At T = 2048, H = 32, D = 128, causal, bf16:
// 4 * D * H * T(T+1)/2 = 34.4 GFLOP, 35 us at the bf16 tensor-core peak;
// q, k, v and o are 67 MB, 20 us at 3.35 TB/s.  It is bound by operations,
// so the bf16 products belong on the tensor cores.
//
// Four bodies; the caller names one (flash_attention.py `flash_body`),
// and the launcher refuses a body that does not fit the dtype and D:
//
// * `flash_fwd_wgmma_kernel<D, E, kPad>`, bf16 or f16 (E) with every head
//   dim from 64 to 256 that is a multiple of 16, on
//   the tensor cores in E (`wgmma ... f32.bf16.bf16` or `f32.f16.f16`;
//   the tensor maps name E's TMA data type): a block owns 128 query rows
//   of one (b, h), heaviest causal tile first, two consumer warpgroups of
//   64 rows each running the shared tile step (attn_wgmma.cuh): S = Q K^T
//   and O += P V on `wgmma`, P in E from registers, the online softmax in
//   f32 registers.  One thread issues TMA loads of the Q tiles and of a
//   ring of 64-key K and V tiles (64-column boxes, 128-byte swizzle)
//   through a 4-d tensor map of the strided (B, T, H, D) view, with
//   full/empty mbarriers.  Through the 128-wide tile that thread is in a
//   third, producer warpgroup, which gives its registers up (setmaxnreg),
//   and three stages are in flight.  On the 192- and 256-wide tiles (D
//   144-256: Gemma's and GPT-J's 256) O is 96 or 128 f32 registers a
//   thread, and ptxas held a 384-thread block to 168 a thread whatever
//   setmaxnreg asked (PERF.md), so there is no producer: thread 0
//   of consumer 0 issues the loads, each stage's slot refilled once both
//   consumers' warps have arrived on its `empty` (3 stages at width 192,
//   2 at 256; 192 KB of shared memory either way).  What bounds it there
//   is what bounds it at D 128: operations (T 2048, H 16, D 256, causal:
//   34.4 GFLOP, 35 us), which the `fma` body ran at the CUDA cores' f32
//   rate.  The k-walk stops at the causal limit
//   min(T, q0 + 128); rows past T are zero-filled by TMA and never stored;
//   keys past T or past a row's position weigh 0.  Scores are scaled in
//   f32 after the product, so besides f32 summation order the one new
//   rounding against the plain version is P to E.  A head dim under the
//   tile's width (kPad: 80-112, 144-176, 208-240) runs with the tensor
//   maps' inner dimension at the head dim, so the boxes read past it and
//   TMA fills those columns with zeros, the Q K^T products stop at the
//   head dim, P V runs at n = the width and the output's columns past
//   the head dim are not stored.
// * `flash_fwd_kernel<T, D, kPad>`, f32 (any D) and bf16 or f16 with any
//   other head dim (D 16, 32, and every D up to 256 that is not a
//   multiple of 16 from 64 up):
//   every product an f32 FMA on CUDA cores, q scaled by 1/sqrt(D) before
//   the dot.  One block per (64-row query tile, b * H + h), heaviest
//   first; K and V tiles staged by cp.async, double-buffered; a 16 x 16
//   thread grid holds 4 rows x BK/16 keys of S and 4 rows x D/16 dims of
//   O in registers, P through shared memory (at D 16 a thread holds one
//   dim of O).  D 16 and 32 stay here in bf16 and f16 because the
//   tensor-core tile's swizzled layout is built of 64-column blocks.  It
//   is compiled for D 16, 32, 64, 128 and 256 exactly (64, 128 and 256
//   for f32 only); any other head dim (kPad) runs the instantiation
//   of the next width of 32, 64, 128 and 256 with the head dim taken at
//   run time: K/V shared memory holds zeros past it (cleared once), rows
//   are copied in the widest chunks the views' addresses and strides
//   allow (16 bytes down to 1), and the output's columns past it are not
//   stored.
// * `dense_wgmma_wide_kernel<E>` (wide_wgmma.cuh,
//   flash_attention_wgmma_wide.cu), bf16 or f16 at every head dim past 256
//   that is a multiple of 16: 64 query rows and up to 512 output columns a
//   block on the tensor cores, scores once a block.
// * `dense_wide_kernel<T>` (wide_attention.cuh, flash_attention_wide.cu),
//   every other dtype and head dim past 256: 32 query rows a block, the
//   output in slabs of 256 columns on a ((b, h) x slab, q tile) grid, each
//   block recomputing its rows' scores over the whole head dim.

#include "attn_wgmma.cuh"
#include "common.cuh"
#include "tma_map.cuh"

namespace {

using namespace tpulab;

constexpr int BQ = 64;          // query rows per block
constexpr int NTHREADS = 256;   // a 16 x 16 thread grid
constexpr int TM = BQ / 16;     // query rows per thread
constexpr float NEG = -1e30f;

template <typename T, int D>
struct Geometry {
  static constexpr int EPC = 16 / sizeof(T);     // elements per 16B chunk
  static constexpr int CPR = D / EPC;            // chunks per K or V row
  static constexpr int LD = D + EPC;             // padded K/V row stride
  static constexpr int BK = D > 128 ? 32 : 64;   // keys per stage
  static constexpr int TN = BK / 16;             // score columns per thread
  static constexpr int DPT = D / 16;             // output dims per thread
  static constexpr int LDP = BK + 4;             // padded P row stride
  static constexpr size_t q_bytes = sizeof(float) * BQ * D;
  static constexpr size_t kv_bytes = sizeof(T) * 2 * 2 * BK * LD;
  static constexpr size_t p_bytes = sizeof(float) * BQ * LDP;
  static constexpr size_t smem_bytes = q_bytes + kv_bytes + p_bytes;
};

// D is the shared-memory width; the head dim HD is D, or (kPad) `dh` <= D
// with K/V rows copied in chunks of `cw` bytes.
template <typename T, int D, bool kPad>
__global__ void __launch_bounds__(NTHREADS)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ out, int Tlen,
                     int H, long long qsb, long long qst, long long qsh,
                     long long ksb, long long kst, long long ksh,
                     long long vsb, long long vst, long long vsh, int causal,
                     float sm_scale, int dh, int cw) {
  using Geo = Geometry<T, D>;
  const int HD = kPad ? dh : D;
  constexpr int EPC = Geo::EPC, CPR = Geo::CPR, LD = Geo::LD;
  constexpr int BK = Geo::BK, TN = Geo::TN, DPT = Geo::DPT, LDP = Geo::LDP;

  const int bh = blockIdx.x;
  const int qt = gridDim.y - 1 - blockIdx.y;   // heaviest causal tile first
  const int b = bh / H, h = bh % H;
  const int q0 = qt * BQ;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* qs = reinterpret_cast<float*>(smem_raw);             // [BQ][D]
  T* ks = reinterpret_cast<T*>(smem_raw + Geo::q_bytes);      // [2][BK][LD]
  T* vs = ks + 2 * BK * LD;                                   // [2][BK][LD]
  float* ps = reinterpret_cast<float*>(smem_raw + Geo::q_bytes +
                                       Geo::kv_bytes);        // [BQ][LDP]

  const T* qb = q + b * qsb + h * qsh;
  const T* kb = k + b * ksb + h * ksh;
  const T* vb = v + b * vsb + h * vsh;

  // keys [0, kend) are all this tile's rows can see
  const int kend = causal ? min(Tlen, q0 + BQ) : Tlen;
  const int n_stages = (kend + BK - 1) / BK;

  auto load_stage = [&](int stage, int buf) {
    const int t0 = stage * BK;
    if constexpr (kPad) {    // rows of HD * sizeof(T) bytes, cw a chunk
      for_row_chunks(BK, HD * (int)sizeof(T), cw, tid, NTHREADS,
                     [&](int t, int off) {
        const int pos = t0 + t;
        const bool valid = pos < kend;
        const T* ksrc = valid ? kb + pos * kst : kb;
        const T* vsrc = valid ? vb + pos * vst : vb;
        const size_t row = ((size_t)buf * BK + t) * LD;
        copy_chunk(reinterpret_cast<unsigned char*>(ks + row) + off,
                   reinterpret_cast<const unsigned char*>(ksrc) + off, cw,
                   valid);
        copy_chunk(reinterpret_cast<unsigned char*>(vs + row) + off,
                   reinterpret_cast<const unsigned char*>(vsrc) + off, cw,
                   valid);
      });
      return;
    }
    for (int c = tid; c < 2 * BK * CPR; c += NTHREADS) {
      const int kv = c / (BK * CPR);
      const int rem = c % (BK * CPR);
      const int t = rem / CPR, ch = rem % CPR;
      const int pos = t0 + t;
      const bool valid = pos < kend;
      const T* base = kv ? vb : kb;
      const T* src = base;
      if (valid) src = base + pos * (kv ? vst : kst) + ch * EPC;
      T* dst = (kv ? vs : ks) + ((size_t)buf * BK + t) * LD + ch * EPC;
      cp_async16(dst, src, valid ? 16 : 0);
    }
  };

  if constexpr (kPad) {      // K/V columns past the head dim stay zero
    zero_smem(ks, Geo::kv_bytes, tid, NTHREADS);
    __syncthreads();
  }
  if (n_stages > 0) load_stage(0, 0);
  cp_async_commit();

  // the query tile, scaled, in f32; rows past T (and columns past the
  // head dim) are zeros
  for (int idx = tid; idx < BQ * D; idx += NTHREADS) {
    const int i = idx / D, d = idx % D;
    const int r = q0 + i;
    qs[idx] = r < Tlen && (!kPad || d < HD)
                  ? to_f(qb[(long long)r * qst + d]) * sm_scale
                  : 0.f;
  }

  float m_r[TM], l_r[TM], acc[TM][DPT];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    m_r[i] = NEG;
    l_r[i] = 0.f;
#pragma unroll
    for (int x = 0; x < DPT; ++x) acc[i][x] = 0.f;
  }

  for (int s = 0; s < n_stages; ++s) {
    const int buf = s & 1;
    if (s + 1 < n_stages) load_stage(s + 1, buf ^ 1);
    cp_async_commit();       // (possibly empty) group keeps wait_group 1 exact
    cp_async_wait_1();
    __syncthreads();         // stage s landed (and, at s == 0, the Q tile)
    const T* kt = ks + (size_t)buf * BK * LD;
    const T* vt = vs + (size_t)buf * BK * LD;
    const int k0 = s * BK;

    // S = Q K^T on this thread's rows ty*TM + i and keys tx + 16*j
    float sc[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) sc[i][j] = 0.f;
#pragma unroll 2
    for (int d = 0; d < D; d += EPC) {
      float kf[TN][EPC];
#pragma unroll
      for (int j = 0; j < TN; ++j)
        load_vals<EPC>(kt + (tx + 16 * j) * LD + d, kf[j]);
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        float qf[EPC];
        load_vals<EPC>(qs + (ty * TM + i) * D + d, qf);
#pragma unroll
        for (int j = 0; j < TN; ++j)
#pragma unroll
          for (int e = 0; e < EPC; ++e)
            sc[i][j] = fmaf(qf[e], kf[j][e], sc[i][j]);
      }
    }

    // online softmax over this tile's keys; masked keys weigh exactly 0
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int qpos = q0 + ty * TM + i;
      bool ok[TN];
      float mx = NEG;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int kpos = k0 + tx + 16 * j;
        ok[j] = kpos < Tlen && (!causal || kpos <= qpos);
        if (ok[j]) mx = fmaxf(mx, sc[i][j]);
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)   // the row's 16 threads: a half-warp
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m_r[i], mx);
      const float alpha = expf(m_r[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const float p = ok[j] ? expf(sc[i][j] - m_new) : 0.f;
        ps[(ty * TM + i) * LDP + tx + 16 * j] = p;
        rs += p;
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, o);
      l_r[i] = l_r[i] * alpha + rs;
      m_r[i] = m_new;
#pragma unroll
      for (int x = 0; x < DPT; ++x) acc[i][x] *= alpha;
    }
    __syncthreads();         // the P tile is complete

    // O += P V on rows ty*TM + i and dims tx*DPT + x
#pragma unroll 2
    for (int c = 0; c < BK; c += 4) {
      float pf[TM][4];
#pragma unroll
      for (int i = 0; i < TM; ++i)
        load_vals<4>(ps + (ty * TM + i) * LDP + c, pf[i]);
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        float vf[DPT];
        load_vals<DPT>(vt + (c + cc) * LD + tx * DPT, vf);
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int x = 0; x < DPT; ++x)
            acc[i][x] = fmaf(pf[i][cc], vf[x], acc[i][x]);
      }
    }
    __syncthreads();         // buffer `buf` and the P tile are reused
  }
  cp_async_wait_all();

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = q0 + ty * TM + i;
    if (r >= Tlen) continue;
    const float den = fmaxf(l_r[i], 1e-30f);
    T* o = out + (((size_t)b * Tlen + r) * H + h) * HD + tx * DPT;
#pragma unroll
    for (int x = 0; x < DPT; ++x)
      if (!kPad || tx * DPT + x < HD) o[x] = from_f<T>(acc[i][x] / den);
  }
}

template <typename T, int D, bool kPad>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int Tlen, int H, const long long* st, int causal, float sm_scale,
           int dh, cudaStream_t stream) {
  const size_t smem = Geometry<T, D>::smem_bytes;
  auto kern = flash_fwd_kernel<T, D, kPad>;
  static std::atomic<bool> smem_set[MAX_DEVICES];
  if (int e = enable_smem(kern, smem, smem_set)) return e;
  const int n_qt = (Tlen + BQ - 1) / BQ;
  if (n_qt > 65535) return (int)cudaErrorInvalidConfiguration;
  // the widest chunk every K/V row start allows: the bases and the byte
  // strides of both views, and a row's bytes
  const unsigned long long es = sizeof(T);
  const int cw = copy_width(
      {(unsigned long long)(uintptr_t)k, (unsigned long long)(uintptr_t)v,
       (unsigned long long)st[3] * es, (unsigned long long)st[4] * es,
       (unsigned long long)st[5] * es, (unsigned long long)st[6] * es,
       (unsigned long long)st[7] * es, (unsigned long long)st[8] * es,
       (unsigned long long)dh * es});
  if (!kPad && cw < 16) return (int)cudaErrorMisalignedAddress;
  dim3 grid(B * H, n_qt);
  kern<<<grid, NTHREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), Tlen, H, st[0], st[1],
      st[2], st[3], st[4], st[5], st[6], st[7], st[8], causal, sm_scale, dh,
      cw);
  return (int)cudaGetLastError();
}

// The fma body at D 16, 32, 64, 128 or 256 (compiled for D; 64, 128 and
// 256 for f32 only), or at any other head dim up to 256 on the width
// padded_width(D).
template <typename T>
int launch_t(int D, const void* q, const void* k, const void* v, void* out,
             int B, int Tlen, int H, const long long* st, int causal,
             float sm_scale, cudaStream_t s) {
  switch (D) {
    case 16:
      return launch<T, 16, false>(q, k, v, out, B, Tlen, H, st, causal,
                                  sm_scale, D, s);
    case 32:
      return launch<T, 32, false>(q, k, v, out, B, Tlen, H, st, causal,
                                  sm_scale, D, s);
    case 64:    // bf16 and f16 run the tensor-core body at 64 and 128
      if constexpr (std::is_same<T, float>::value)
        return launch<T, 64, false>(q, k, v, out, B, Tlen, H, st, causal,
                                    sm_scale, D, s);
      return -1;
    case 128:
      if constexpr (std::is_same<T, float>::value)
        return launch<T, 128, false>(q, k, v, out, B, Tlen, H, st, causal,
                                     sm_scale, D, s);
      return -1;
    case 256:   // bf16 and f16 run the tensor-core body at 256
      if constexpr (std::is_same<T, float>::value)
        return launch<T, 256, false>(q, k, v, out, B, Tlen, H, st, causal,
                                     sm_scale, D, s);
      return -1;
    default:
      return with_padded_width(D, [&](auto w) {
        return launch<T, decltype(w)::value, true>(
            q, k, v, out, B, Tlen, H, st, causal, sm_scale, D, s);
      });
  }
}

// ---------------------------------------------------------------- wgmma
namespace tc {

constexpr int BQ = 128;        // query rows per block: two consumer warpgroups

// Through width 128 the block is three warpgroups: a TMA producer that
// gives its registers up (setmaxnreg) and two consumers, three K/V stages
// in flight.  Past it (D 144-256) O is 96 or 128 f32 registers a thread,
// and ptxas holds a 384-thread block to 168 registers a thread whatever
// setmaxnreg asks (PERF.md): the block is the two consumers alone
// (256 threads, up to 255 registers each), thread 0 of consumer 0
// issuing the loads, with three stages at width 192 and two at 256 (Q 48
// or 64 KB, a stage 48 or 64 KB: 192 KB either way).
template <int D>
struct Smem {
  static constexpr bool kProducer = D <= 128;
  static constexpr int NTHREADS = kProducer ? 384 : 256;
  static constexpr int NST = D <= 192 ? 3 : 2;   // K/V stages in flight
  static constexpr int TILE = wg::AttnTile<D>::TILE_BYTES;
  static constexpr int Q = 0;                    // [2][TILE]
  static constexpr int K = 2 * TILE;             // [NST][TILE]
  static constexpr int V = K + NST * TILE;       // [NST][TILE]
  static constexpr int BAR = V + NST * TILE;     // full[NST], empty[NST], q
  static constexpr size_t bytes = BAR + 8 * (2 * NST + 1) + 1024;  // + align
};

// D is the tile's width; the head dim HD is D, or (kPad) `dh`: a multiple
// of 16 under D and past the next narrower width (80-112, 144-176,
// 208-240).
template <int D, typename E, bool kPad>
__global__ void __launch_bounds__(Smem<D>::NTHREADS, 1)
    flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                           const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tv,
                           E* __restrict__ out, int Tlen, int H,
                           int causal, float scale_log2, int dh) {
  using Tile = wg::AttnTile<D, E>;
  using L = Smem<D>;
  constexpr int NST = L::NST;
  const int HD = kPad ? dh : D;                  // the head dim
  constexpr int BK = Tile::BK;
  constexpr int NCB = D / 64;                    // 64-column boxes per row
  constexpr uint32_t BOX = 64 * 128;             // bytes of one box

  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;   // heaviest first
  const int kend = causal ? min(Tlen, q0 + BQ) : Tlen;
  const int n_stages = (kend + BK - 1) / BK;
  const int n_cons = min(2, (Tlen - q0 + 63) / 64);   // warpgroups with rows

  extern __shared__ __align__(1024) unsigned char smem_tc[];
  unsigned char* sm = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_tc) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + L::BAR);
  uint64_t* empty = full + NST;
  uint64_t* qbar = empty + NST;

  if (threadIdx.x == 0) {
    for (int i = 0; i < NST; ++i) {
      wg::mbar_init(&full[i], 1);
      wg::mbar_init(&empty[i], 4 * n_cons);     // one arrive per warp
    }
    wg::mbar_init(qbar, 1);
    wg::mbar_fence_init();
  }
  __syncthreads();

  // by one thread: the Q tiles of the warpgroups with rows, and stage s's
  // K and V tiles into its ring slot
  auto load_q = [&]() {
    wg::mbar_expect_tx(qbar, n_cons * NCB * BOX);
    for (int c = 0; c < n_cons; ++c)
      for (int cb = 0; cb < NCB; ++cb)
        wg::tma_load_4d(sm + L::Q + c * L::TILE + cb * BOX, &tq, qbar,
                        cb * 64, h, q0 + 64 * c, b);
  };
  auto load_stage = [&](int s) {
    const int slot = s % NST;
    wg::mbar_expect_tx(&full[slot], 2 * NCB * BOX);
    for (int cb = 0; cb < NCB; ++cb) {
      wg::tma_load_4d(sm + L::K + slot * L::TILE + cb * BOX, &tk,
                      &full[slot], cb * 64, h, s * BK, b);
      wg::tma_load_4d(sm + L::V + slot * L::TILE + cb * BOX, &tv,
                      &full[slot], cb * 64, h, s * BK, b);
    }
  };

  const int wgi = threadIdx.x / 128;
  int c = wgi;                                   // this consumer
  if constexpr (L::kProducer) {
    if (wgi == 0) {
      // ---- producer ----
      wg::setmaxnreg_dec<40>();
      if (threadIdx.x == 0) {
        load_q();
        for (int s = 0; s < n_stages; ++s) {
          if (s >= NST) wg::mbar_wait(&empty[s % NST], ((s / NST) - 1) & 1);
          load_stage(s);
        }
      }
      return;
    }
    wg::setmaxnreg_inc<232>();
    c = wgi - 1;
  } else {
    // thread 0 (consumer 0 always has rows) loads Q and the first NST
    // stages now, each later stage once every warp is done with the one
    // that held its slot (below)
    if (threadIdx.x == 0) {
      load_q();
      for (int s = 0; s < min(NST, n_stages); ++s) load_stage(s);
    }
  }
  // ---- consumers: warpgroup c owns rows q0 + 64c .. q0 + 64c + 63 ----
  if (c >= n_cons) return;
  const int row_lo = q0 + 64 * c;
  const int my_end = causal ? min(Tlen, row_lo + 64) : Tlen;
  const int my_stages = (my_end + BK - 1) / BK;
  const uint32_t qa = wg::smem_u32(sm + L::Q + c * L::TILE);
  Tile t;
  t.init();
  if constexpr (L::kProducer)
    wg::mbar_wait(qbar, 0);
  else
    wg::mbar_wait_or_trap(qbar, 0);
  for (int s = 0; s < n_stages; ++s) {
    const int slot = s % NST;
    if constexpr (!L::kProducer) {
      // stage s - 1's slot takes stage s - 1 + NST once every warp of
      // both consumers has arrived on its `empty` (consumer 0 is at most
      // one stage ahead of consumer 1)
      if (threadIdx.x == 0 && s >= 1 && s - 1 + NST < n_stages) {
        wg::mbar_wait_or_trap(&empty[(s - 1) % NST], ((s - 1) / NST) & 1);
        load_stage(s - 1 + NST);
      }
      __syncwarp();
      wg::mbar_wait_or_trap(&full[slot], (s / NST) & 1);
      __syncwarp();            // the warp's `wgmma`s issue converged
    } else {
      wg::mbar_wait(&full[slot], (s / NST) & 1);
    }
    if (s < my_stages) {
      const int k0 = s * BK;
      const uint32_t ka = wg::smem_u32(sm + L::K + slot * L::TILE);
      const uint32_t va = wg::smem_u32(sm + L::V + slot * L::TILE);
      auto visible = [&](int i, int key) {
        const int kpos = k0 + key;
        return kpos < Tlen && (!causal || kpos <= row_lo + Tile::row(i));
      };
      if (k0 + BK > Tlen || (causal && k0 + BK - 1 > row_lo))
        t.template step<true>(qa, ka, va, scale_log2, visible, HD / 16);
      else
        t.template step<false>(qa, ka, va, scale_log2, visible, HD / 16);
    }
    __syncwarp();
    if ((threadIdx.x & 31) == 0) wg::mbar_arrive(&empty[slot]);
  }
  t.finish();
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = row_lo + Tile::row(i);
    if (r >= Tlen) continue;
    const float inv = 1.f / fmaxf(t.l[i], 1e-30f);
    E* o = out + (((size_t)b * Tlen + r) * H + h) * HD;
#pragma unroll
    for (int cc = 0; cc < D / 8; ++cc)
      if (!kPad || cc < HD / 8)
        wg::store2<E>(o + Tile::col(cc, 0), t.o[4 * cc + 2 * i] * inv,
                      t.o[4 * cc + 2 * i + 1] * inv);
  }
}

using tma::make_map;

template <int D, typename E, bool kPad>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int Tlen, int H, const long long* st, int causal, float sm_scale,
           int dh, cudaStream_t stream) {
  const CUtensorMapDataType dt = wg::is_f16<E>
                                     ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                                     : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  CUtensorMap mq, mk, mv;
  if (int e = make_map(&mq, dt, q, B, Tlen, H, dh, st[0], st[1], st[2]))
    return e;
  if (int e = make_map(&mk, dt, k, B, Tlen, H, dh, st[3], st[4], st[5]))
    return e;
  if (int e = make_map(&mv, dt, v, B, Tlen, H, dh, st[6], st[7], st[8]))
    return e;
  const size_t smem = Smem<D>::bytes;
  auto kern = flash_fwd_wgmma_kernel<D, E, kPad>;
  static std::atomic<bool> smem_set[MAX_DEVICES];
  if (int e = enable_smem(kern, smem, smem_set)) return e;
  const int n_qt = (Tlen + BQ - 1) / BQ;
  if (n_qt > 65535) return (int)cudaErrorInvalidConfiguration;
  dim3 grid(B * H, n_qt);
  kern<<<grid, Smem<D>::NTHREADS, smem, stream>>>(
      mq, mk, mv, static_cast<E*>(out), Tlen, H, causal,
      sm_scale * 1.4426950408889634f, dh);
  return (int)cudaGetLastError();
}

}  // namespace tc

}  // namespace

// C interface (bound with ctypes).  q, k, v (B, T, H, D) with element
// strides (b, t, h) given in that order for q, then k, then v (the last
// dim contiguous, rows 16-byte aligned); out (B, T, H, D) contiguous.
// q_code is the one dtype's code (0 f32, 1 bf16, 2 f16).  body 1 is the
// tensor-core body (bf16 or f16, every D from 64 to 256 that is a
// multiple of 16), body 0 the CUDA-core body (f32 with any D from 1 to
// 256, and bf16 or f16 with any other D up to 256; rows 16-byte aligned
// at D 16, 32, 64, 128 and 256, any alignment of the element size at the
// others), body 2 the wide fma
// form (every dtype at every D past 256, any alignment of the element
// size; wide_attention.cuh), body 3 the tensor-core wide form (bf16 or
// f16 at every D past 256 that is a multiple of 16, rows 16-byte aligned;
// wide_wgmma.cuh).  Returns 0 or a
// cudaError_t code; -1 for a body, dtype and head dim the kernel is not
// built for.
namespace tpulab {
// Every head dim past FMA_WIDTH (256): the wide form (wide_attention.cuh),
// defined in flash_attention_wide.cu (a second translation unit of the
// same library).  -1 for a head dim up to FMA_WIDTH or an unknown dtype.
int flash_wide(int q_code, const void* q, const void* k, const void* v,
               void* out, int B, int T, int H, int D, const long long* st,
               int causal, float sm_scale, cudaStream_t s);
// bf16 and f16 at every head dim past FMA_WIDTH that is a multiple of 16:
// the tensor-core wide form (wide_wgmma.cuh), defined in
// flash_attention_wgmma_wide.cu (a third translation unit).  -1 for f32 or
// another head dim.
int flash_wgmma_wide(int q_code, const void* q, const void* k, const void* v,
                     void* out, int B, int T, int H, int D,
                     const long long* st, int causal, float sm_scale,
                     cudaStream_t s);
}  // namespace tpulab

extern "C" int tpulab_flash_attention(
    const void* q, const void* k, const void* v, void* out, int B, int T,
    int H, int D, long long qsb, long long qst, long long qsh, long long ksb,
    long long kst, long long ksh, long long vsb, long long vst, long long vsh,
    int causal, int q_code, int body, float sm_scale, void* stream) {
  if (B == 0 || T == 0 || H == 0) return 0;
  const long long st[9] = {qsb, qst, qsh, ksb, kst, ksh, vsb, vst, vsh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (body == 3)
    return flash_wgmma_wide(q_code, q, k, v, out, B, T, H, D, st, causal,
                            sm_scale, s);
  if (body == 2)
    return flash_wide(q_code, q, k, v, out, B, T, H, D, st, causal, sm_scale,
                      s);
  return with_q_type(q_code, [&](auto tag) {
    using T16 = typename decltype(tag)::type;
    if constexpr (std::is_same<T16, float>::value) {
      return body == 0 ? launch_t<float>(D, q, k, v, out, B, T, H, st,
                                         causal, sm_scale, s)
                       : -1;
    } else {
      const int w = wgmma_width(D);  // the tensor-core dims run body 1
      if (body == 0)
        return w ? -1 : launch_t<T16>(D, q, k, v, out, B, T, H, st, causal,
                                      sm_scale, s);
      if (body != 1) return -1;
      switch (w) {   // a head dim under its tile's width: kPad
        case 64:
          return tc::launch<64, T16, false>(q, k, v, out, B, T, H, st,
                                            causal, sm_scale, D, s);
        case 128:
          return D == 128 ? tc::launch<128, T16, false>(
                                q, k, v, out, B, T, H, st, causal, sm_scale,
                                D, s)
                          : tc::launch<128, T16, true>(
                                q, k, v, out, B, T, H, st, causal, sm_scale,
                                D, s);
        case 192:
          return D == 192 ? tc::launch<192, T16, false>(
                                q, k, v, out, B, T, H, st, causal, sm_scale,
                                D, s)
                          : tc::launch<192, T16, true>(
                                q, k, v, out, B, T, H, st, causal, sm_scale,
                                D, s);
        case 256:
          return D == 256 ? tc::launch<256, T16, false>(
                                q, k, v, out, B, T, H, st, causal, sm_scale,
                                D, s)
                          : tc::launch<256, T16, true>(
                                q, k, v, out, B, T, H, st, causal, sm_scale,
                                D, s);
        default:
          return -1;
      }
    }
  });
}

// The tensor-core body's attributes for dtype code `q_code` (1 bf16, 2
// f16) at head dim `d` (a multiple of 16 from 144 to 256): registers a
// thread, dynamic shared memory bytes and local memory bytes a thread
// into out[0..2].  0, a cudaError_t code, or -1 for f32 or another head
// dim.
extern "C" int tpulab_flash_wgmma_attributes(int q_code, int d, int* out) {
  const int w = wgmma_width(d);
  if (w < 192) return -1;
  return with_q_type(q_code, [&](auto tag) {
    using E = typename decltype(tag)::type;
    if constexpr (std::is_same<E, float>::value) {
      return -1;
    } else {
      const bool pad = d != w;
      if (w == 192)
        return kernel_attributes(pad ? tc::flash_fwd_wgmma_kernel<192, E, true>
                                     : tc::flash_fwd_wgmma_kernel<192, E, false>,
                                 tc::Smem<192>::bytes, out);
      return kernel_attributes(pad ? tc::flash_fwd_wgmma_kernel<256, E, true>
                                   : tc::flash_fwd_wgmma_kernel<256, E, false>,
                               tc::Smem<256>::bytes, out);
    }
  });
}
