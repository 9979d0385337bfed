// Flash attention forward for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_flash_bhd` / `_attn_kernel`
// (tpulab/ops/flash_attention.py:80 and :28): blockwise attention with
// online softmax over (B, T, H, D) q, k, v, causal or not.  On the serving
// path it is the attention of the split plan's full-prompt prefill
// (`paged_prefill` with `make_flash_attention_fn`), one launch per layer.
//
// What it computes.  o[b, t, h] = softmax_s(q[b, t, h] . k[b, s, h] / sqrt(D))
// . v[b, s, h], over s < T (causal: s <= t).  q is scaled by 1/sqrt(D) in
// f32 before the dot, as the TPU kernel does; max, normaliser and the
// output accumulator are f32; the output is acc / max(l, 1e-30) in q's
// dtype.  K/V already carry q's head count (GQA callers repeat them).
// There is no TF32 anywhere: every product is an f32 FMA on CUDA cores.
//
// What bounds it on an H100.  At T = 2048, H = 32, D = 128, causal, bf16:
// 4 * D * H * T(T+1)/2 = 34.4 GFLOP, 35 us at the bf16 tensor-core peak;
// q, k, v and o are 67 MB, 20 us at 3.35 TB/s.  It is bound by operations.
//
// What the design does about it.  One block per (query tile of 64 rows,
// b * H + h); tiles are issued heaviest (latest causal tile) first.  The
// k-walk is an in-block loop up to the causal limit, so fully-future K
// tiles are never loaded.  K and V tiles of BK rows are staged through
// shared memory by cp.async, double-buffered so the next tile's loads are
// in flight while this one computes; rows past T are zero-filled and
// masked.  The block's 256 threads form a 16 x 16 grid: a thread owns 4
// query rows and BK/16 keys of S = Q K^T (a register tile, ~10 FMAs per
// shared-memory load), then the same 4 rows and D/16 output dims of
// O += P V, with P passed through shared memory.  The 16 threads of a row
// group sit in one half-warp, so row max and row sum are shuffles.  q, k
// and v are read through their (B, T, H) strides; only the last dim must
// be contiguous.  This is the simple, right first kernel: it leaves the
// bf16 tensor cores (wgmma), TMA and warp specialisation to later work.

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

}  // namespace

// C interface (bound with ctypes).  q, k, v (B, T, H, D) with element
// strides (b, t, h) given in that order for q, then k, then v (the last
// dim contiguous); out (B, T, H, D) contiguous.  Returns 0 or a
// cudaError_t code; -1 for a head dim the kernel is not built for.
extern "C" int tpulab_flash_attention(
    const void* q, const void* k, const void* v, void* out, int B, int T,
    int H, int D, long long qsb, long long qst, long long qsh, long long ksb,
    long long kst, long long ksh, long long vsb, long long vst, long long vsh,
    int causal, int bf16, float sm_scale, void* stream) {
  if (B == 0 || T == 0 || H == 0) return 0;
  const long long st[9] = {qsb, qst, qsh, ksb, kst, ksh, vsb, vst, vsh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch_t<__nv_bfloat16>(D, q, k, v, out, B, T, H, st, causal,
                                   sm_scale, s);
  return launch_t<float>(D, q, k, v, out, B, T, H, st, causal, sm_scale, s);
}
