// The GroupNorm statistics of a row tile of whole samples, shared by kernel
// 5 (fused_gn_silu_conv3.cu) and 5''s backward (fused_gn_silu_conv3_bwd.cu),
// so that the backward recomputes the forward's bits: mean and rstd a
// (sample, group), two passes over x (mean first, then the centred squares:
// E[x^2] - mean^2 cancels when |mean| >> std).
#pragma once

#include <cuda_runtime.h>

namespace cst {

constexpr int kStatsThreads = 256;  // the block, synchronised on barrier 1
// x a thread keeps in registers from the first pass to the second: its
// first kStatsCacheRows rows' first kStatsCacheQ4 float4s
constexpr int kStatsCacheRows = 8;
constexpr int kStatsCacheQ4 = 2;

// xs: the tile's (R, C) rows of x; part: R G floats of shared memory;
// stats: (mean, rstd) a (sample, group) of the sv valid samples, in shared
// memory; row_sample: each row's sample.  Thread t takes group g = t % G of
// rows t / G, t / G + rstep, ...; the rows past the cached ones are read
// again.  A float32 partial sum per (row, group), then a double sum per
// (sample, group) over the rows in order: neither order depends on B or on
// the tiling.  Ends on a barrier of the block.
__device__ __forceinline__ void gn_statistics(
    const float* __restrict__ xs, float* part, float* stats,
    const unsigned char* row_sample, int R, int sv, int L, int C, int G,
    float eps) {
  const int t = threadIdx.x;
  const int W = C / 4;               // float4s a row
  const int cpg = C / G;
  const int q4 = cpg / 4;            // float4s a group has on one row
  const int gshift = 31 - __clz(G);  // G is 16 or 32
  const int g = t & (G - 1);
  const int rstep = kStatsThreads >> gshift;
  const int rt = t >> gshift;
  const float4* xg = reinterpret_cast<const float4*>(xs + g * cpg);
  float4 xc[kStatsCacheRows][kStatsCacheQ4];
  auto add = [](float sum, float4 v, bool centred, float m) {
    if (!centred) return sum + ((v.x + v.y) + (v.z + v.w));
    const float a = v.x - m, b = v.y - m, c = v.z - m, d = v.w - m;
    return sum + ((a * a + b * b) + (c * c + d * d));
  };
  auto row_group_sums = [&](bool centred) {
#pragma unroll
    for (int k = 0; k < kStatsCacheRows; ++k) {
      const int r = rt + k * rstep;
      if (r < R) {
        const float4* p = xg + static_cast<size_t>(r) * W;
        const float m = centred ? stats[2 * (row_sample[r] * G + g)] : 0.0f;
        float sum = 0.0f;
#pragma unroll
        for (int j = 0; j < kStatsCacheQ4; ++j) {
          if (j < q4) {
            if (!centred) xc[k][j] = __ldg(p + j);
            sum = add(sum, xc[k][j], centred, m);
          }
        }
        for (int j = kStatsCacheQ4; j < q4; ++j)
          sum = add(sum, __ldg(p + j), centred, m);
        part[r * G + g] = sum;
      }
    }
    for (int r = rt + kStatsCacheRows * rstep; r < R; r += rstep) {
      const float4* p = xg + static_cast<size_t>(r) * W;
      const float m = centred ? stats[2 * (row_sample[r] * G + g)] : 0.0f;
      float sum = 0.0f;
      for (int j = 0; j < q4; ++j) sum = add(sum, __ldg(p + j), centred, m);
      part[r * G + g] = sum;
    }
  };
  auto sample_sums = [&](int slot) {
    for (int it = t; it < sv * G; it += kStatsThreads) {
      const float* ps = part + (it >> gshift) * L * G + (it & (G - 1));
      double acc = 0.0;
#pragma unroll 8
      for (int l = 0; l < L; ++l) acc += ps[l * G];
      const float v = static_cast<float>(acc / (L * cpg));
      stats[2 * it + slot] = slot ? rsqrtf(fmaxf(v, 0.0f) + eps) : v;
    }
  };
  row_group_sums(false);
  asm volatile("bar.sync 1, %0;\n" ::"n"(kStatsThreads) : "memory");
  sample_sums(0);
  asm volatile("bar.sync 1, %0;\n" ::"n"(kStatsThreads) : "memory");
  row_group_sums(true);
  asm volatile("bar.sync 1, %0;\n" ::"n"(kStatsThreads) : "memory");
  sample_sums(1);
  asm volatile("bar.sync 1, %0;\n" ::"n"(kStatsThreads) : "memory");
}

}  // namespace cst
