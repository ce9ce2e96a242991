// The FMA relu-MLP forward: fused_mlp_forward.cu's float32-weight entry,
// which no served path uses, and, through accumulate(), the forward of the
// training kernel (mlp_train.cuh).  The served bf16 and int8 entries run
// the tensor-core kernel of mlp_forward_wgmma.cuh; this file keeps the
// float32 path and accumulate() as they were.
//
// One launch runs the whole network.  All layers' weights sit in one
// contiguous buffer, layer after layer, each (d_in, d_out) row-major; the
// biases in one float buffer; the widths arrive by value.
//
// Each block owns a tile of TB rows and keeps its activations as float32
// in dynamic shared memory, ping-ponging between two TB x ld buffers
// (ld = widest layer input, rounded up to 4 floats so rows stay 16-byte
// aligned).  Layer by layer, each thread owns groups of 4 adjacent output
// columns for all TB rows: per 8 steps of k it reads an 8 x 4 block of W
// from global memory (one 16-byte load a row; neighbouring threads,
// neighbouring columns: coalesced; the 16.4 MB of float32 weights of the
// 4x1024 coupling MLP stay in the 50 MB L2 across blocks), reads each row's 4
// activations as float4 broadcasts from shared memory, and accumulates
// TB x 4 sums in registers with float32 FMAs.  Why: the products run on
// the float32 pipes, which shared-memory reads and L2 latency starve; with
// 4 columns a thread each float4 activation load feeds 16 FMAs, not 4, and
// with eight rows of W loaded before they are used, eight L2 round trips
// are in flight per thread.  Each output sums in k order whatever TB is,
// so a row's result does not depend on its batch.  Rows past B are zero
// in shared memory and never stored; columns past d_out (d_out % 4 != 0)
// read zero weights and are never stored.
//
// Numerics follow the Pallas kernel: float32 activations times float32
// weights, float32 accumulation, bias added in float32.
#pragma once

#include "common.cuh"

namespace cst {

constexpr int kMlpThreads = 256;

__device__ __forceinline__ float widen(float w) { return w; }
__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// Four adjacent weights p[0..3] widened to float, in one aligned load.
__device__ __forceinline__ void load4(const float* p, float (&w)[4]) {
  const float4 v = __ldg(reinterpret_cast<const float4*>(p));
  w[0] = v.x;
  w[1] = v.y;
  w[2] = v.z;
  w[3] = v.w;
}

// Weights of columns c0..c0+3 of one row of W (p points at column c0):
// one vector load where the rows are aligned and whole (kVec), else
// guarded scalar loads with zero past d_out.
template <bool kVec, typename WT>
__device__ __forceinline__ void load_cols(const WT* p, int n_valid,
                                          float (&w)[4]) {
  if constexpr (kVec) {
    load4(p, w);
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) w[j] = j < n_valid ? widen(p[j]) : 0.0f;
  }
}

// acc[r][j] += sum_k h[r][k] * W[k][c0 + j], k ascending.  Eight rows of W
// are loaded before they are used, so eight L2 round trips are in flight
// per thread.
template <bool kVec, int TB, typename WT>
__device__ __forceinline__ void accumulate(const WT* wc, int dout,
                                           int n_valid, int din,
                                           const float* hin, int ld,
                                           float (&acc)[TB][4]) {
  int k = 0;
  for (; k + 8 <= din; k += 8) {
    float wk[8][4];
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      load_cols<kVec>(wc + static_cast<long long>(k + kk) * dout, n_valid,
                      wk[kk]);
    }
#pragma unroll
    for (int r = 0; r < TB; ++r) {
      const float4 h0 = *reinterpret_cast<const float4*>(hin + r * ld + k);
      const float4 h1 =
          *reinterpret_cast<const float4*>(hin + r * ld + k + 4);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        acc[r][j] = fmaf(h0.x, wk[0][j], acc[r][j]);
        acc[r][j] = fmaf(h0.y, wk[1][j], acc[r][j]);
        acc[r][j] = fmaf(h0.z, wk[2][j], acc[r][j]);
        acc[r][j] = fmaf(h0.w, wk[3][j], acc[r][j]);
        acc[r][j] = fmaf(h1.x, wk[4][j], acc[r][j]);
        acc[r][j] = fmaf(h1.y, wk[5][j], acc[r][j]);
        acc[r][j] = fmaf(h1.z, wk[6][j], acc[r][j]);
        acc[r][j] = fmaf(h1.w, wk[7][j], acc[r][j]);
      }
    }
  }
  for (; k < din; ++k) {
    float wk[4];
    load_cols<kVec>(wc + static_cast<long long>(k) * dout, n_valid, wk);
#pragma unroll
    for (int r = 0; r < TB; ++r) {
      const float h = hin[r * ld + k];
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[r][j] = fmaf(h, wk[j], acc[r][j]);
    }
  }
}

template <typename WT, int TB>
__global__ void __launch_bounds__(kMlpThreads)
    mlp_forward_kernel(const float* __restrict__ x, const WT* __restrict__ w,
                       const float* __restrict__ bias, float* __restrict__ out,
                       Widths wd, int rows, int ld, int relu_tail) {
  extern __shared__ float4 smem[];
  float* hin = reinterpret_cast<float*>(smem);
  float* hout = hin + TB * ld;
  const int row0 = blockIdx.x * TB;

  const int d0 = wd.w[0];
  for (int i = threadIdx.x; i < TB * d0; i += blockDim.x) {
    const int r = i / d0;
    const int k = i - r * d0;
    const float v =
        row0 + r < rows ? x[static_cast<long long>(row0 + r) * d0 + k] : 0.0f;
    hin[r * ld + k] = v;
  }
  __syncthreads();

  long long woff = 0;
  int boff = 0;
  for (int l = 0; l < wd.n_layers; ++l) {
    const int din = wd.w[l];
    const int dout = wd.w[l + 1];
    const bool last = l == wd.n_layers - 1;
    // 4-wide vector loads need every row of this layer 4-element aligned
    const bool vec = dout % 4 == 0 && woff % 4 == 0;
    for (int c0 = 4 * threadIdx.x; c0 < dout; c0 += 4 * blockDim.x) {
      const WT* wc = w + woff + c0;
      const int n_valid = dout - c0;
      float acc[TB][4];
#pragma unroll
      for (int r = 0; r < TB; ++r) {
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[r][j] = 0.0f;
      }
      if (vec) {
        accumulate<true>(wc, dout, n_valid, din, hin, ld, acc);
      } else {
        accumulate<false>(wc, dout, n_valid, din, hin, ld, acc);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = c0 + j;
        if (c >= dout) break;
        const float b = bias[boff + c];
        // relu between layers, and on the last relu_tail outputs (the
        // non-negative surface scalars); `v < 0` keeps a NaN, as
        // jnp.maximum does
        const bool relu = !last || c >= dout - relu_tail;
#pragma unroll
        for (int r = 0; r < TB; ++r) {
          float v = acc[r][j] + b;
          if (relu && v < 0.0f) v = 0.0f;
          if (!last) {
            hout[r * ld + c] = v;
          } else if (row0 + r < rows) {
            out[static_cast<long long>(row0 + r) * dout + c] = v;
          }
        }
      }
    }
    __syncthreads();
    float* t = hin;
    hin = hout;
    hout = t;
    woff += static_cast<long long>(din) * dout;
    boff += dout;
  }
}

template <typename WT, int TB>
int launch_tile(const float* x, const WT* w, const float* bias, float* out,
                const Widths& wd, int rows, int ld, int relu_tail,
                cudaStream_t stream) {
  const size_t smem = 2 * static_cast<size_t>(TB) * ld * sizeof(float);
  auto kernel = mlp_forward_kernel<WT, TB>;
  static bool opted[kMaxDevices] = {};
  static std::mutex mu;
  const int e = opt_in_shared_memory(kernel, opted, mu);
  if (e != 0) return e;
  const int blocks = (rows + TB - 1) / TB;
  kernel<<<blocks, kMlpThreads, smem, stream>>>(x, w, bias, out, wd, rows,
                                                ld, relu_tail);
  return static_cast<int>(cudaGetLastError());
}

template <typename WT>
int launch_mlp(const float* x, const WT* w, const float* bias, float* out,
               const int* widths, int n_layers, int rows, int relu_tail,
               int tile_rows, void* stream) {
  if (n_layers < 1 || n_layers > kMaxLayers) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Widths wd;
  wd.n_layers = n_layers;
  int widest_in = 0;
  for (int i = 0; i <= n_layers; ++i) wd.w[i] = widths[i];
  for (int i = 0; i < n_layers; ++i) {
    widest_in = widths[i] > widest_in ? widths[i] : widest_in;
  }
  const int ld = (widest_in + 3) & ~3;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (tile_rows) {
    case 4:
      return launch_tile<WT, 4>(x, w, bias, out, wd, rows, ld, relu_tail,
                                s);
    case 16:
      return launch_tile<WT, 16>(x, w, bias, out, wd, rows, ld, relu_tail,
                                 s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace cst
