// Warpgroup attention tile for NVIDIA Hopper (sm_90a), shared by the
// flash (flash_attention.cu) and ragged (ragged_attention.cu) kernels'
// tensor-core bodies: the bf16 -> f32 and f16 -> f32 `wgmma` wrappers,
// shared-memory matrix descriptors for the 128-byte-swizzled layout,
// `mbarrier` and TMA helpers, and the consumer's step over one stage of
// keys.  The element type E (bf16 or f16) is a template parameter of the
// wrappers and of the tile: both are 16-bit, so layouts, descriptors and
// instruction shapes are the same, and only the `wgmma` type suffix, the
// packing of P and the output's rounding differ.
//
// The layout.  A 16-bit operand tile of R rows x D columns (D 64, 128,
// 192 or 256, the tile's width) is stored as D/64 column blocks, each R
// rows of 128 bytes, block c at byte c * R * 128.  A head dim that is a
// multiple of 16 under the width (80-112 in the 128-wide tile, 144-176
// in the 192-wide, 208-240 in the 256-wide) fills its last block or
// blocks partly: the columns past the head dim are zero in shared memory
// (the ragged kernel zeroes them once, TMA fills them with zeros as it
// reads past the row), so they add nothing to Q K^T, and P V's columns
// past the head dim are never stored.  Inside each 1024-byte group of 8 rows, the 16-byte
// chunk j of row r sits at chunk j ^ (r % 8): the pattern that TMA writes
// under CU_TENSOR_MAP_SWIZZLE_128B and that descriptor layout type 1
// (128B swizzle) reads.  Tiles start on 1024-byte boundaries.  Q and K are
// read K-major (D contiguous); V is the same layout read MN-major, i.e.
// transposed through its descriptor, so P V needs no transpose in memory.
//
// The step.  A warpgroup (128 threads) owns 64 query rows.  S = Q K^T is
// one m64n64k16 product per 16 columns of the head dim (the zero columns'
// steps are skipped: 5 at D 80, 9 at D 144) into 32
// f32 registers a thread; the thread holds
// rows r and r + 8 (r = 16 * warp + lane / 4) at columns 8c + 2(lane % 4)
// + {0, 1}, so a row's max and sum are reduced over the four lanes that
// share lane / 4.  Scores are scaled by log2(e)/sqrt(D) in f32 after the
// product; masked keys score -inf and weigh exactly 0.  P is rounded to
// E (bf16 or f16) in registers, where the S accumulator layout is already the A
// operand layout of the next product: O += P V is BK/16 products with A
// from registers at n = the tile's width (m64n64k16 or m64n128k16; the
// 192- and 256-wide tiles issue m64n128k16 on columns 0-127 and m64n64k16
// or m64n128k16 on the rest, each into its own slice of O; a head dim
// under the width multiplies the zero columns too and drops them at the
// store).  O is D/2 f32 registers a thread: 128 at width 256, which with
// S and P fits one thread's 255 only in a block of at most two
// warpgroups.  The online softmax keeps m and l in f32.
#pragma once

#include "common.cuh"

namespace tpulab {
namespace wg {

constexpr float NEG = -1e30f;   // the running max before any key is seen

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Byte offset of 16-byte chunk `j` (j < D/8) of row `r` in an R-row tile.
__device__ __forceinline__ uint32_t swz(int r, int j, int rows) {
  return (j >> 3) * rows * 128 + r * 128 + (((j & 7) ^ (r & 7)) << 4);
}

// A shared-memory matrix descriptor, 128-byte swizzle.  K-major operands
// (Q, K) step 32 bytes per k16 inside a 128-byte row, their 8-row groups
// 1024 bytes apart (LBO is unused); the MN-major V steps 1024 bytes per 8
// keys (SBO) and R * 128 bytes per 64 output columns (LBO).
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keep the compiler from moving register uses across an async product.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
// Generic-proxy shared-memory writes (cp.async, st.shared) made visible to
// the async proxy that wgmma reads through.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// The three products as macros over the type suffix TY ("bf16" or
// "f16"), instantiated by the templates below.
#define TPULAB_WGMMA_SS_M64N64K16(TY) \
  asm volatile( \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n" \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, " \
      "%32, %33, p, 1, 1, 0, 0;\n}\n" \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]) \
      : "l"(da), "l"(db), "r"(scale_d))

#define TPULAB_WGMMA_RS_M64N64K16(TY) \
  asm volatile( \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n" \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, " \
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n" \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]) \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1))

#define TPULAB_WGMMA_RS_M64N128K16(TY) \
  asm volatile( \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n" \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, " \
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n" \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), \
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), \
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), \
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), \
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]) \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1))

template <typename E>
constexpr bool is_f16 = std::is_same<E, __half>::value;

// D[64 x 64] (+)= A[64 x 16] B[16 x 64]^T, A and B K-major in shared memory.
template <typename E>
__device__ __forceinline__ void wgmma_ss_m64n64k16(float (&d)[32], uint64_t da,
                                                   uint64_t db, int scale_d) {
  if constexpr (is_f16<E>)
    TPULAB_WGMMA_SS_M64N64K16("f16");
  else
    TPULAB_WGMMA_SS_M64N64K16("bf16");
}

// D[64 x 64] += A[64 x 16] B[16 x 64], A from registers, B MN-major in
// shared memory (transposed through the descriptor).
template <typename E>
__device__ __forceinline__ void wgmma_rs_m64n64k16(float (&d)[32],
                                                   const uint32_t (&a)[4],
                                                   uint64_t db) {
  if constexpr (is_f16<E>)
    TPULAB_WGMMA_RS_M64N64K16("f16");
  else
    TPULAB_WGMMA_RS_M64N64K16("bf16");
}

// D[64 x 128] += A[64 x 16] B[16 x 128], A from registers, B MN-major in
// shared memory (transposed through the descriptor).
template <typename E>
__device__ __forceinline__ void wgmma_rs_m64n128k16(float (&d)[64],
                                                   const uint32_t (&a)[4],
                                                   uint64_t db) {
  if constexpr (is_f16<E>)
    TPULAB_WGMMA_RS_M64N128K16("f16");
  else
    TPULAB_WGMMA_RS_M64N128K16("bf16");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}
__device__ __forceinline__ uint32_t pack_f16(float lo, float hi) {
  __half2 v = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}
// Two f32 values rounded to E, the first in the low half.
template <typename E>
__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  if constexpr (is_f16<E>)
    return pack_f16(lo, hi);
  else
    return pack_bf16(lo, hi);
}
// Two f32 values rounded to E and stored at p (4-byte aligned).
template <typename E>
__device__ __forceinline__ void store2(E* p, float lo, float hi) {
  *reinterpret_cast<uint32_t*>(p) = pack<E>(lo, hi);
}

// ---- mbarrier and TMA ----
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count));
}
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}
// Spin until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  asm volatile(
      "{\n.reg .pred P1;\nLAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\nbra LAB_WAIT;\nDONE:\n}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}
// One 4-d TMA box into shared memory; completion counts bytes on `bar`.
// `map` is the address of a __grid_constant__ CUtensorMap.
__device__ __forceinline__ void tma_load_4d(void* dst, const void* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}
// The same wait that, after 20 s, traps: a lost TMA or a ring that
// deadlocks then fails the launch instead of holding the card.
__device__ __forceinline__ void mbar_wait_or_trap(uint64_t* bar, int parity) {
  const uint32_t addr = smem_u32(bar);
  uint64_t t0 = 0;
  for (uint32_t n = 0;; ++n) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred P1;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 P1, [%1], %2;\n"
        "selp.u32 %0, 1, 0, P1;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if ((n & 1023) == 0) {
      uint64_t now;
      asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(now));
      if (n == 0)
        t0 = now;
      else if (now - t0 > 20000000000ull)
        __trap();
    }
  }
}
// Named barrier `id` over `n` threads (a multiple of 32).
__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}
template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// Zero 16-byte chunks [c0, c1) of every row of an R-row swizzled tile (the
// columns past a head dim of 80, 96 or 112), by `nthreads` threads.
__device__ __forceinline__ void zero_chunks(unsigned char* tile, int rows,
                                            int c0, int c1, int tid,
                                            int nthreads) {
  const int n = c1 - c0;
  for (int i = tid; i < rows * n; i += nthreads)
    *reinterpret_cast<uint4*>(tile + swz(i / n, c0 + i % n, rows)) =
        make_uint4(0u, 0u, 0u, 0u);
}

// ---- the consumer's tile ----
// A warpgroup's 64 query rows against stages of BK = 64 keys.  Q, K and V
// tiles are 64 rows x D of E (bf16 or f16) in the swizzled layout above;
// D is the tile's width, the head dim is D or a multiple of 16 under it
// and past the next narrower width.
template <int D, typename E = __nv_bfloat16>
struct AttnTile {
  static_assert(D == 64 || D == 128 || D == 192 || D == 256,
                "the tensor-core tile is 64, 128, 192 or 256 wide");
  static constexpr int BK = 64;
  static constexpr int TILE_BYTES = 64 * D * 2;   // one 64-row 16-bit tile
  static constexpr int NO = D / 2;                // O floats a thread
  float o[NO];
  float m[2], l[2];

  // This thread's rows (i = 0, 1) and columns (8c + col(e)) of a tile.
  __device__ __forceinline__ static int row(int i) {
    return ((threadIdx.x >> 5) & 3) * 16 + ((threadIdx.x & 31) >> 2) + 8 * i;
  }
  __device__ __forceinline__ static int col(int c, int e) {
    return 8 * c + (threadIdx.x & 3) * 2 + e;
  }

  __device__ __forceinline__ void init() {
#pragma unroll
    for (int i = 0; i < NO; ++i) o[i] = 0.f;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      m[i] = NEG;
      l[i] = 0.f;
    }
  }

  // One stage.  q, k, v: shared-memory addresses of the tiles;
  // scale_log2 = log2(e) / sqrt(head dim); visible(i, key) says whether
  // this thread's row i (0 or 1, at tile row row(i)) sees the stage's key
  // `key`, and is asked only when kMask (some row may not see some key);
  // k16 = head dim / 16, the products of Q K^T (the columns past it are
  // zeros).
  template <bool kMask, class Visible>
  __device__ __forceinline__ void step(uint32_t q, uint32_t k, uint32_t v,
                                       float scale_log2,
                                       const Visible& visible,
                                       int k16 = D / 16) {
    float s[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      if (kk >= k16) break;
      const uint32_t off = (kk >> 2) * (64 * 128) + (kk & 3) * 32;
      wgmma_ss_m64n64k16<E>(s, smem_desc(q + off, 16, 1024),
                         smem_desc(k + off, 16, 1024), kk);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);

#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float mx = NEG;
#pragma unroll
      for (int c = 0; c < 8; ++c)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float x = s[4 * c + 2 * i + e] * scale_log2;
          if (kMask && !visible(i, col(c, e))) x = -INFINITY;
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
          const float p = exp2f(s[4 * c + 2 * i + e] - m_new);  // -inf -> 0
          s[4 * c + 2 * i + e] = p;
          rs += p;
        }
      l[i] = l[i] * alpha + rs;   // this thread's columns; finish() sums
#pragma unroll
      for (int c = 0; c < D / 8; ++c) {
        o[4 * c + 2 * i] *= alpha;
        o[4 * c + 2 * i + 1] *= alpha;
      }
    }

    uint32_t p[16];   // P in E: the A operand of O += P V
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int h = 0; h < 4; ++h)
        p[4 * kk + h] = pack<E>(s[8 * kk + 2 * h], s[8 * kk + 2 * h + 1]);

    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint32_t a[4] = {p[4 * kk], p[4 * kk + 1], p[4 * kk + 2],
                             p[4 * kk + 3]};
      const uint64_t dv = smem_desc(v + kk * 16 * 128, 64 * 128, 1024);
      if constexpr (D == 64) {
        wgmma_rs_m64n64k16<E>(o, a, dv);
      } else if constexpr (D == 128) {
        wgmma_rs_m64n128k16<E>(o, a, dv);
      } else {
        // columns 0-127 into o[0..63]; past 128 (two more 64-column
        // blocks of V, 16 KB on) into o[64..]
        wgmma_rs_m64n128k16<E>(*reinterpret_cast<float(*)[64]>(o), a, dv);
        const uint64_t dv2 =
            smem_desc(v + 2 * 64 * 128 + kk * 16 * 128, 64 * 128, 1024);
        if constexpr (D == 192)
          wgmma_rs_m64n64k16<E>(*reinterpret_cast<float(*)[32]>(o + 64), a,
                                dv2);
        else
          wgmma_rs_m64n128k16<E>(*reinterpret_cast<float(*)[64]>(o + 64), a,
                                 dv2);
      }
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(o);
  }

  // Sum each row's l over the four lanes that share it.
  __device__ __forceinline__ void finish() {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    }
  }
};

}  // namespace wg
}  // namespace tpulab
