// fused_gn_silu_conv3: the U-Net half-block GroupNorm -> silu -> conv3.
//
// Replaces climsim_tpu/ops/unet_fused.py fused_gn_silu_conv3 / _kernel (the
// pl.pallas_call at unet_fused.py:111).  Per sample, x (L, C) float32:
//   mean_g, var_g  over L x C/G, two passes (mean first, then the centred
//                  squares: E[x^2] - mean^2 cancels when |mean| >> std)
//   h = silu(((x - mean_g) * rsqrt(var_g + eps)) * gamma + beta) -> bf16
//   y[l] = sum_k h[l + k - 1] @ w[k] + b      (SAME conv, k = 3, zeros at the
//                                              sample's own edges)
// with bf16 x bf16 products summed in float32 and the float32 bias added
// last.  The affine step and silu keep the plain version's roundings
// (separate multiply and add; x / (1 + exp(-x)), as PyTorch's silu).
//
// Bound on the H100: at B = 384 the 82 chains of the unet_v5 forward are
// ~274 GFLOP of bf16 products (0.714 GFLOP a column) against ~1.7 GB of
// float32 activations in and out, so the tensor cores can bound it.  This
// version is bound by latency instead: warp-level mma through WMMA (16x16x16
// bf16 tiles), no wgmma, no TMA, a few blocks an SM.  PERF.md keeps its
// times and those of the first version, which read the weight fragments
// straight from L2 with nothing in flight.
//
// Design: one block per (sample, 128 output channels).  The block computes
// its sample's group statistics from device memory (warp per group, float4
// loads, fixed summation order), writes the normalized, silu'd bf16 slab
// (L + 2 rows with a zero halo, padded to whole 16-row tiles) into dynamic
// shared memory -- 52.8 KB at L = 64, C = 384, above the 48 KB default,
// hence the one-time opt-in -- then streams the weights through shared
// memory in 64-row chunks, three in flight (cp.async), while eight warps
// run the three shifted products as 16x16 tiles: warp w owns output
// channels 16w .. 16w + 15 of the block and every row tile, so each weight
// fragment it loads feeds up to four products.  Every output sums over
// (k, c) in one fixed order whatever B is, so a sample's result does not
// depend on its batch.  Outputs go through a float32 tile in shared memory
// (over the weight chunks, which are dead by then), where the bias is
// added.
#include <mma.h>

#include "common.cuh"

namespace {

using namespace nvcuda;

constexpr int kThreads = 256;    // 8 warps
constexpr int kTileN = 128;      // output channels a block (8 warps x 16)
constexpr int kPadC = 16;        // slab row padding: rows stay 32-byte aligned
constexpr int kMaxRowTiles = 4;  // L <= 64
constexpr int kChunk = 64;       // weight rows a pipeline stage
constexpr int kStages = 3;       // weight chunks in flight
constexpr int kLdB = kTileN + 8;  // weight chunk row stride (elements)

__device__ __forceinline__ float warp_sum(float v) {
  // butterfly: every lane ends with the same sum, in a fixed order
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Dynamic shared memory: slab | max(weight stages, output tile) | stats.
__host__ __device__ inline size_t slab_bytes(int rows, int C) {
  return static_cast<size_t>(rows + 2) * (C + kPadC) * sizeof(__nv_bfloat16);
}
__host__ __device__ inline size_t stage_bytes(int rows) {
  const size_t b = static_cast<size_t>(kStages) * kChunk * kLdB *
                   sizeof(__nv_bfloat16);
  const size_t o = static_cast<size_t>(rows) * kTileN * sizeof(float);
  return b > o ? b : o;
}

__global__ void __launch_bounds__(kThreads)
    gn_silu_conv3_kernel(const float* __restrict__ x,
                         const float* __restrict__ gamma,
                         const float* __restrict__ beta,
                         const __nv_bfloat16* __restrict__ w,
                         const float* __restrict__ bias,
                         float* __restrict__ out, int L, int C, int Cout,
                         int G, float eps) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int rows = (L + 15) & ~15;  // output rows padded to 16-row tiles
  const int ld = C + kPadC;
  __nv_bfloat16* slab = reinterpret_cast<__nv_bfloat16*>(smem);
  unsigned char* stage_base = smem + slab_bytes(rows, C);
  __nv_bfloat16* wbuf = reinterpret_cast<__nv_bfloat16*>(stage_base);
  float* otile = reinterpret_cast<float*>(stage_base);  // after the products
  float* stats = reinterpret_cast<float*>(stage_base + stage_bytes(rows));

  const int sample = blockIdx.y;
  const int n0 = blockIdx.x * kTileN;
  const int nw = min(kTileN, Cout - n0);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const float* xs = x + static_cast<size_t>(sample) * L * C;

  // weight chunk q: rows q*kChunk .. of the (3C, Cout) matrix, columns
  // n0 .. n0 + nw, 16 bytes a copy
  const int n_chunks = 3 * C / kChunk;
  auto load_chunk = [&](int q) {
    if (q < n_chunks) {
      __nv_bfloat16* dst = wbuf + (q % kStages) * kChunk * kLdB;
      const __nv_bfloat16* src =
          w + static_cast<size_t>(q) * kChunk * Cout + n0;
      const int per_row = nw / 8;
      for (int i = threadIdx.x; i < kChunk * per_row; i += kThreads) {
        const int r = i / per_row;
        const int c = (i - r * per_row) * 8;
        cp_async16(dst + r * kLdB + c, src + static_cast<size_t>(r) * Cout + c);
      }
    }
    cp_async_commit();  // an empty group keeps the count uniform
  };
  // the weights do not depend on x: start the first chunks at once
#pragma unroll
  for (int q = 0; q < kStages - 1; ++q) load_chunk(q);

  // 1. group statistics, two passes, one warp per group
  const int cpg = C / G;
  const int q4 = cpg / 4;  // float4s a group has on one level
  const int n4 = L * q4;
  for (int g = warp; g < G; g += kThreads / 32) {
    const float* xg = xs + g * cpg;
    float s = 0.0f;
    for (int i = lane; i < n4; i += 32) {
      const int l = i / q4;
      const float4 v = *reinterpret_cast<const float4*>(
          xg + l * C + 4 * (i - l * q4));
      s += (v.x + v.y) + (v.z + v.w);
    }
    const float mean = warp_sum(s) / (4 * n4);
    float s2 = 0.0f;
    for (int i = lane; i < n4; i += 32) {
      const int l = i / q4;
      const float4 v = *reinterpret_cast<const float4*>(
          xg + l * C + 4 * (i - l * q4));
      const float a = v.x - mean, b = v.y - mean;
      const float c = v.z - mean, d = v.w - mean;
      s2 += (a * a + b * b) + (c * c + d * d);
    }
    const float var = fmaxf(warp_sum(s2) / (4 * n4), 0.0f);
    if (lane == 0) {
      stats[g] = mean;
      stats[G + g] = rsqrtf(var + eps);
    }
  }
  __syncthreads();

  // 2. normalized, silu'd bf16 slab: slab row l + 1 holds level l; row 0
  // and rows L + 1 .. rows + 1 are zero
  for (int i = threadIdx.x; i < L * C / 4; i += kThreads) {
    const int l = (4 * i) / C;
    const int c = 4 * i - l * C;
    const int g = c / cpg;  // a float4 never straddles groups (cpg % 4 == 0)
    const float4 v4 = *reinterpret_cast<const float4*>(xs + 4 * i);
    const float in[4] = {v4.x, v4.y, v4.z, v4.w};
    __nv_bfloat16 h[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float v = __fmul_rn(in[j] - stats[g], stats[G + g]);
      v = __fadd_rn(__fmul_rn(v, __ldg(gamma + c + j)), __ldg(beta + c + j));
      h[j] = __float2bfloat16_rn(v / (1.0f + expf(-v)));
    }
    __nv_bfloat162* dst =
        reinterpret_cast<__nv_bfloat162*>(slab + (l + 1) * ld + c);
    dst[0] = __halves2bfloat162(h[0], h[1]);
    dst[1] = __halves2bfloat162(h[2], h[3]);
  }
  const __nv_bfloat16 zero = __float2bfloat16_rn(0.0f);
  for (int c = threadIdx.x; c < C; c += kThreads) slab[c] = zero;
  for (int i = threadIdx.x; i < (rows + 1 - L) * C; i += kThreads) {
    const int r = L + 1 + i / C;
    slab[r * ld + i % C] = zero;
  }

  // 3. three shifted products on the tensor cores, float32 sums, the
  // weights streamed through shared memory
  const int row_tiles = rows / 16;
  const bool active = warp * 16 < nw;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[kMaxRowTiles];
#pragma unroll
  for (int t = 0; t < kMaxRowTiles; ++t) wmma::fill_fragment(acc[t], 0.0f);
  for (int q = 0; q < n_chunks; ++q) {
    cp_async_wait<kStages - 2>();  // chunk q has landed (this thread's part)
    __syncthreads();               // ... everyone's; chunk q - 1 is done
    load_chunk(q + kStages - 1);   // into the buffer chunk q - 1 used
    if (active) {
      const __nv_bfloat16* wq = wbuf + (q % kStages) * kChunk * kLdB;
#pragma unroll
      for (int kk = 0; kk < kChunk; kk += 16) {
        const int r = q * kChunk + kk;  // row of the (3C, Cout) matrix
        const int k = r / C;            // tap
        const int c0 = r - k * C;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major>
            b;
        wmma::load_matrix_sync(b, wq + kk * kLdB + warp * 16, kLdB);
#pragma unroll
        for (int t = 0; t < kMaxRowTiles; ++t) {
          if (t < row_tiles) {
            wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                           wmma::row_major>
                a;
            // output row r reads slab rows r + k (level r + k - 1)
            wmma::load_matrix_sync(a, slab + (t * 16 + k) * ld + c0, ld);
            wmma::mma_sync(acc[t], a, b, acc[t]);
          }
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the weight chunks are dead: otile may reuse them
  if (active) {
#pragma unroll
    for (int t = 0; t < kMaxRowTiles; ++t) {
      if (t < row_tiles) {
        wmma::store_matrix_sync(otile + t * 16 * kTileN + warp * 16, acc[t],
                                kTileN, wmma::mem_row_major);
      }
    }
  }
  __syncthreads();

  // 4. + bias, the first L rows out
  float* os = out + static_cast<size_t>(sample) * L * Cout + n0;
  for (int i = threadIdx.x; i < L * nw; i += kThreads) {
    const int l = i / nw;
    const int j = i - l * nw;
    os[static_cast<size_t>(l) * Cout + j] = otile[l * kTileN + j] +
                                            __ldg(bias + n0 + j);
  }
}

}  // namespace

// x: (batch, L, C) float32, 16-byte aligned; gamma, beta: (C,) float32; w:
// (3, C, Cout) bf16, 16-byte aligned; bias: (Cout,) float32; out: (batch,
// L, Cout) float32.  Needs L <= 64, C % 64 == 0, Cout % 16 == 0, C % G ==
// 0 with C / G % 4 == 0, and batch <= 65535 (ops/unet_fused.py checks
// them).
extern "C" int cst_fused_gn_silu_conv3(const float* x, const float* gamma,
                                       const float* beta, const void* w,
                                       const float* bias, float* out,
                                       int batch, int L, int C, int Cout,
                                       int G, float eps, void* stream) {
  if (L < 1 || L > 16 * kMaxRowTiles || C % kChunk || Cout % 16 || G < 1 ||
      C % G || (C / G) % 4 || batch < 1 || batch > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  static bool opted[cst::kMaxDevices] = {};
  static std::mutex mu;
  const int e = cst::opt_in_shared_memory(gn_silu_conv3_kernel, opted, mu);
  if (e != 0) return e;
  const int rows = (L + 15) & ~15;
  const size_t smem = slab_bytes(rows, C) + stage_bytes(rows) +
                      2 * static_cast<size_t>(G) * sizeof(float);
  const dim3 grid((Cout + kTileN - 1) / kTileN, batch);
  gn_silu_conv3_kernel<<<grid, kThreads, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      x, gamma, beta, static_cast<const __nv_bfloat16*>(w), bias, out, L, C,
      Cout, G, eps);
  return static_cast<int>(cudaGetLastError());
}
