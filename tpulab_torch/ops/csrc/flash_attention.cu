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
// Two bodies; the caller names one (flash_attention.py `flash_body`), and
// the launcher refuses a body that does not fit the dtype and D:
//
// * `flash_fwd_wgmma_kernel<D, E>`, bf16 or f16 (E) with D 64 or 128, on
//   the tensor cores in E (`wgmma ... f32.bf16.bf16` or `f32.f16.f16`;
//   the tensor maps name E's TMA data type): a block of three
//   warpgroups owns 128 query rows of one (b, h), heaviest causal tile
//   first.  Warpgroup 0 is the producer: one thread issues TMA loads of
//   the Q tile and of a 3-stage ring of 64-key K and V tiles (two boxes
//   of 64 columns per 128-column row, 128-byte swizzle) through a 4-d
//   tensor map of the strided (B, T, H, D) view, with full/empty
//   mbarriers, and gives its registers up (setmaxnreg).  Warpgroups 1 and
//   2 each take 64 rows and run the shared tile step (attn_wgmma.cuh):
//   S = Q K^T and O += P V on `wgmma`, P in E from registers, the
//   online softmax in f32 registers.  The k-walk stops at the causal limit
//   min(T, q0 + 128); rows past T are zero-filled by TMA and never stored;
//   keys past T or past a row's position weigh 0.  Scores are scaled in
//   f32 after the product, so besides f32 summation order the one new
//   rounding against the plain version is P to E.
// * `flash_fwd_kernel<T, D>`, f32 (any D) and bf16 or f16 with D 32 or 256:
//   every product an f32 FMA on CUDA cores, q scaled by 1/sqrt(D) before
//   the dot.  One block per (64-row query tile, b * H + h), heaviest
//   first; K and V tiles staged by cp.async, double-buffered; a 16 x 16
//   thread grid holds 4 rows x BK/16 keys of S and 4 rows x D/16 dims of
//   O in registers, P through shared memory.  D 256 stays here in bf16 and
//   f16 because its O accumulator (128 f32 a thread) with S does not fit
//   the tensor-core tile's register budget; D 32 because the tile's
//   swizzled layout is built of 64-column blocks.

#include <cuda.h>

#include "attn_wgmma.cuh"
#include "common.cuh"

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

template <typename T, int D>
__global__ void __launch_bounds__(NTHREADS)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ out, int Tlen,
                     int H, long long qsb, long long qst, long long qsh,
                     long long ksb, long long kst, long long ksh,
                     long long vsb, long long vst, long long vsh, int causal,
                     float sm_scale) {
  using Geo = Geometry<T, D>;
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

  if (n_stages > 0) load_stage(0, 0);
  cp_async_commit();

  // the query tile, scaled, in f32; rows past T are zeros
  for (int idx = tid; idx < BQ * D; idx += NTHREADS) {
    const int i = idx / D, d = idx % D;
    const int r = q0 + i;
    qs[idx] = r < Tlen ? to_f(qb[(long long)r * qst + d]) * sm_scale : 0.f;
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
    T* o = out + (((size_t)b * Tlen + r) * H + h) * D + tx * DPT;
#pragma unroll
    for (int x = 0; x < DPT; ++x) o[x] = from_f<T>(acc[i][x] / den);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int Tlen, int H, const long long* st, int causal, float sm_scale,
           cudaStream_t stream) {
  const size_t smem = Geometry<T, D>::smem_bytes;
  auto kern = flash_fwd_kernel<T, D>;
  static std::atomic<bool> smem_set[MAX_DEVICES];
  if (int e = enable_smem(kern, smem, smem_set)) return e;
  const int n_qt = (Tlen + BQ - 1) / BQ;
  if (n_qt > 65535) return (int)cudaErrorInvalidConfiguration;
  dim3 grid(B * H, n_qt);
  kern<<<grid, NTHREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), Tlen, H, st[0], st[1],
      st[2], st[3], st[4], st[5], st[6], st[7], st[8], causal, sm_scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_t(int D, const void* q, const void* k, const void* v, void* out,
             int B, int Tlen, int H, const long long* st, int causal,
             float sm_scale, cudaStream_t s) {
  switch (D) {
    case 32:
      return launch<T, 32>(q, k, v, out, B, Tlen, H, st, causal, sm_scale, s);
    case 64:
      return launch<T, 64>(q, k, v, out, B, Tlen, H, st, causal, sm_scale, s);
    case 128:
      return launch<T, 128>(q, k, v, out, B, Tlen, H, st, causal, sm_scale,
                            s);
    case 256:
      return launch<T, 256>(q, k, v, out, B, Tlen, H, st, causal, sm_scale,
                            s);
    default:
      return -1;
  }
}

// ---------------------------------------------------------------- wgmma
namespace tc {

constexpr int BQ = 128;        // query rows per block: two consumer warpgroups
constexpr int NST = 3;         // K/V stages in flight
constexpr int NTHREADS = 384;  // producer + two consumers

template <int D>
struct Smem {
  static constexpr int TILE = wg::AttnTile<D>::TILE_BYTES;
  static constexpr int Q = 0;                    // [2][TILE]
  static constexpr int K = 2 * TILE;             // [NST][TILE]
  static constexpr int V = K + NST * TILE;       // [NST][TILE]
  static constexpr int BAR = V + NST * TILE;     // full[NST], empty[NST], q
  static constexpr size_t bytes = BAR + 8 * (2 * NST + 1) + 1024;  // + align
};

template <int D, typename E>
__global__ void __launch_bounds__(NTHREADS, 1)
    flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                           const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tv,
                           E* __restrict__ out, int Tlen, int H,
                           int causal, float scale_log2) {
  using Tile = wg::AttnTile<D, E>;
  using L = Smem<D>;
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

  const int wgi = threadIdx.x / 128;
  if (wgi == 0) {
    // ---- producer ----
    wg::setmaxnreg_dec<40>();
    if (threadIdx.x == 0) {
      wg::mbar_expect_tx(qbar, n_cons * NCB * BOX);
      for (int c = 0; c < n_cons; ++c)
        for (int cb = 0; cb < NCB; ++cb)
          wg::tma_load_4d(sm + L::Q + c * L::TILE + cb * BOX, &tq, qbar,
                          cb * 64, h, q0 + 64 * c, b);
      for (int s = 0; s < n_stages; ++s) {
        const int slot = s % NST;
        if (s >= NST) wg::mbar_wait(&empty[slot], ((s / NST) - 1) & 1);
        wg::mbar_expect_tx(&full[slot], 2 * NCB * BOX);
        for (int cb = 0; cb < NCB; ++cb) {
          wg::tma_load_4d(sm + L::K + slot * L::TILE + cb * BOX, &tk,
                          &full[slot], cb * 64, h, s * BK, b);
          wg::tma_load_4d(sm + L::V + slot * L::TILE + cb * BOX, &tv,
                          &full[slot], cb * 64, h, s * BK, b);
        }
      }
    }
  } else {
    // ---- consumers: warpgroup c owns rows q0 + 64c .. q0 + 64c + 63 ----
    wg::setmaxnreg_inc<232>();
    const int c = wgi - 1;
    if (c >= n_cons) return;
    const int row_lo = q0 + 64 * c;
    const int my_end = causal ? min(Tlen, row_lo + 64) : Tlen;
    const int my_stages = (my_end + BK - 1) / BK;
    const uint32_t qa = wg::smem_u32(sm + L::Q + c * L::TILE);
    Tile t;
    t.init();
    wg::mbar_wait(qbar, 0);
    for (int s = 0; s < n_stages; ++s) {
      const int slot = s % NST;
      wg::mbar_wait(&full[slot], (s / NST) & 1);
      if (s < my_stages) {
        const int k0 = s * BK;
        const uint32_t ka = wg::smem_u32(sm + L::K + slot * L::TILE);
        const uint32_t va = wg::smem_u32(sm + L::V + slot * L::TILE);
        auto visible = [&](int i, int key) {
          const int kpos = k0 + key;
          return kpos < Tlen && (!causal || kpos <= row_lo + Tile::row(i));
        };
        if (k0 + BK > Tlen || (causal && k0 + BK - 1 > row_lo))
          t.template step<true>(qa, ka, va, scale_log2, visible);
        else
          t.template step<false>(qa, ka, va, scale_log2, visible);
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
      E* o = out + (((size_t)b * Tlen + r) * H + h) * D;
#pragma unroll
      for (int cc = 0; cc < D / 8; ++cc)
        wg::store2<E>(o + Tile::col(cc, 0), t.o[4 * cc + 2 * i] * inv,
                      t.o[4 * cc + 2 * i + 1] * inv);
    }
  }
}

// cuTensorMapEncodeTiled, looked up through the CUDA runtime's entry-point
// query (no -lcuda at link time).
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_fn() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult st = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &st);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                            cudaEnableDefault, &st);
#endif
    return (e == cudaSuccess && st == cudaDriverEntryPointSuccess)
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// A 4-d map {D, H, T, B} over a strided 16-bit (B, T, H, D) view of TMA
// data type `dt` (bf16 or f16); the box is 64 columns x 1 head x 64 rows x
// 1, swizzled 128B; rows past T read 0.
int make_map(CUtensorMap* map, CUtensorMapDataType dt, const void* base,
             int B, int Tlen, int H, int D, long long sb, long long st,
             long long sh) {
  EncodeTiled fn = encode_fn();
  if (!fn) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)Tlen,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)sh * 2, (cuuint64_t)st * 2,
                                 (cuuint64_t)sb * 2};
  const cuuint32_t box[4] = {64, 1, 64, 1};
  const cuuint32_t estr[4] = {1, 1, 1, 1};
  CUresult r = fn(map, dt, 4,
                  const_cast<void*>(base), dims, strides, box, estr,
                  CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

template <int D, typename E>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int Tlen, int H, const long long* st, int causal, float sm_scale,
           cudaStream_t stream) {
  const CUtensorMapDataType dt = wg::is_f16<E>
                                     ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                                     : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  CUtensorMap mq, mk, mv;
  if (int e = make_map(&mq, dt, q, B, Tlen, H, D, st[0], st[1], st[2]))
    return e;
  if (int e = make_map(&mk, dt, k, B, Tlen, H, D, st[3], st[4], st[5]))
    return e;
  if (int e = make_map(&mv, dt, v, B, Tlen, H, D, st[6], st[7], st[8]))
    return e;
  const size_t smem = Smem<D>::bytes;
  auto kern = flash_fwd_wgmma_kernel<D, E>;
  static std::atomic<bool> smem_set[MAX_DEVICES];
  if (int e = enable_smem(kern, smem, smem_set)) return e;
  const int n_qt = (Tlen + BQ - 1) / BQ;
  if (n_qt > 65535) return (int)cudaErrorInvalidConfiguration;
  dim3 grid(B * H, n_qt);
  kern<<<grid, NTHREADS, smem, stream>>>(
      mq, mk, mv, static_cast<E*>(out), Tlen, H, causal,
      sm_scale * 1.4426950408889634f);
  return (int)cudaGetLastError();
}

}  // namespace tc

}  // namespace

// C interface (bound with ctypes).  q, k, v (B, T, H, D) with element
// strides (b, t, h) given in that order for q, then k, then v (the last
// dim contiguous, rows 16-byte aligned); out (B, T, H, D) contiguous.
// q_code is the one dtype's code (0 f32, 1 bf16, 2 f16).  body 1 is the
// tensor-core body (bf16 or f16, D 64 or 128), body 0 the CUDA-core body
// (f32 with D 32, 64, 128 or 256, and bf16 or f16 with D 32 or 256).  Returns 0 or
// a cudaError_t code; -1 for a body, dtype and head dim the kernel is not
// built for.
extern "C" int tpulab_flash_attention(
    const void* q, const void* k, const void* v, void* out, int B, int T,
    int H, int D, long long qsb, long long qst, long long qsh, long long ksb,
    long long kst, long long ksh, long long vsb, long long vst, long long vsh,
    int causal, int q_code, int body, float sm_scale, void* stream) {
  if (B == 0 || T == 0 || H == 0) return 0;
  const long long st[9] = {qsb, qst, qsh, ksb, kst, ksh, vsb, vst, vsh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return with_q_type(q_code, [&](auto tag) {
    using T16 = typename decltype(tag)::type;
    if constexpr (std::is_same<T16, float>::value) {
      return body == 0 ? launch_t<float>(D, q, k, v, out, B, T, H, st,
                                         causal, sm_scale, s)
                       : -1;
    } else {
      if (body == 1 && D == 64)
        return tc::launch<64, T16>(q, k, v, out, B, T, H, st, causal,
                                   sm_scale, s);
      if (body == 1 && D == 128)
        return tc::launch<128, T16>(q, k, v, out, B, T, H, st, causal,
                                    sm_scale, s);
      if (body == 0 && D == 256)   // D 64 and 128 run the tensor-core body
        return launch<T16, 256>(q, k, v, out, B, T, H, st, causal, sm_scale,
                                s);
      if (body == 0 && D == 32)
        return launch<T16, 32>(q, k, v, out, B, T, H, st, causal, sm_scale,
                               s);
      return -1;
    }
  });
}
