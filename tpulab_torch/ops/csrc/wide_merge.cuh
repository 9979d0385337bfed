// The split-KV merge of the port's wide forms (wide_attention.cuh,
// wide_wgmma.cuh): each split's f32 partials (unnormalised O, then the
// rows' (m, l) at an even float offset) added in split order, so a
// relaunch is bit-identical.
#pragma once

#include "common.cuh"

namespace tpulab {
namespace wide {
namespace {

constexpr float NEG = -1e30f;

// Combine the splits of each row in split order; rows past a lane's
// q_lens (q_lens non-null) are zeros.  One warp a row, its lanes striding
// the head dim.  kLog2: m in log2 units (the tensor-core wide form,
// wide_wgmma.cuh), else natural.
template <bool kLog2>
__global__ void __launch_bounds__(128)
    wide_merge_kernel(const float* __restrict__ part_o,
                      const float* __restrict__ part_ml,
                      const int* __restrict__ q_lens, AnyQ* __restrict__ out,
                      int M, int Hq, size_t rows, int n_split, int dh,
                      int qc) {
  const size_t row = (size_t)blockIdx.x * 4 + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const bool live =
      !q_lens || (int)(row / Hq % M) < q_lens[row / ((size_t)M * Hq)];
  float mx = NEG;
  for (int s = 0; s < n_split; ++s)
    mx = fmaxf(mx, part_ml[(s * rows + row) * 2]);
  float den = 0.f;
  for (int s = 0; s < n_split; ++s) {
    const float2 ml =
        *reinterpret_cast<const float2*>(part_ml + (s * rows + row) * 2);
    den += (kLog2 ? exp2f(ml.x - mx) : expf(ml.x - mx)) * ml.y;
  }
  const float inv = 1.f / fmaxf(den, 1e-30f);
  for (int d = lane; d < dh; d += 32) {
    float o = 0.f;
    if (live)
      for (int s = 0; s < n_split; ++s)
        o += (kLog2 ? exp2f(part_ml[(s * rows + row) * 2] - mx)
                    : expf(part_ml[(s * rows + row) * 2] - mx)) *
             part_o[(s * rows + row) * dh + d];
    q_store(out, row * dh + d, qc, o * inv);
  }
}

}  // namespace
}  // namespace wide
}  // namespace tpulab
