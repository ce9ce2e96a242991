// The fused MLP-training forward, shared by fused_mlp_train_fwd.cu (the
// forward of kernel 6) and fused_mlp_train_bwd.cu (its recompute), so the
// backward's relu masks are the forward's, bit for bit.
//
// The network: relu between layers, a linear last layer; float32
// activations times weights rounded to bf16 (round to nearest even, as
// _fwd_kernel's w.astype(bf16) does, climsim_tpu/ops/fused_mlp_train.py:57),
// float32 sums, the float32 bias added last.  These are kernel 2's
// numerics, and this is kernel 2's design (mlp_forward.cuh: TB rows a
// block, activations in shared memory for the whole network, four output
// columns a thread, eight weight rows in flight), reused through its
// accumulate(): each output sums its products in ascending k with fmaf,
// whatever TB is and whichever translation unit runs it.  What differs:
// the weights are the float32 parameters themselves, one tensor a layer
// (pointers by value in Layers), rounded to bf16 as they are loaded, so
// no cast or copy precedes a call; and with kSave the kernel writes every
// hidden layer's activations (after the relu) to device memory, for the
// backward, and stops before the last layer, which the backward does not
// need.
#pragma once

#include <stdint.h>

#include "mlp_forward.cuh"

namespace cst {

// Per-layer parameters: w[l] is (d_in, d_out) row-major float32, b[l] is
// (d_out,) float32.
struct Layers {
  const float* w[kMaxLayers];
  const float* b[kMaxLayers];
};

// A float32 weight that the kernels use rounded to bf16.  accumulate()
// reaches these overloads of widen() and load4() by argument-dependent
// lookup.
struct Bf16OfF32 {
  float v;
};
__device__ __forceinline__ float widen(Bf16OfF32 w) { return round_bf16(w.v); }
__device__ __forceinline__ void load4(const Bf16OfF32* p, float (&w)[4]) {
  const float4 v = __ldg(reinterpret_cast<const float4*>(p));
  w[0] = round_bf16(v.x);
  w[1] = round_bf16(v.y);
  w[2] = round_bf16(v.z);
  w[3] = round_bf16(v.w);
}

// saved: hidden layer l (l < n_layers - 1) at saved + rows * (d_1 + ... +
// d_l), a (rows, d_{l+1}) row-major block.
template <int TB, bool kSave>
__global__ void __launch_bounds__(kMlpThreads)
    train_forward_kernel(const float* __restrict__ x, Layers p, Widths wd,
                         int rows, int ld, float* __restrict__ out,
                         float* __restrict__ saved) {
  extern __shared__ float4 smem[];
  float* hin = reinterpret_cast<float*>(smem);
  float* hout = hin + TB * ld;
  const int row0 = blockIdx.x * TB;

  const int d0 = wd.w[0];
  for (int i = threadIdx.x; i < TB * d0; i += blockDim.x) {
    const int r = i / d0;
    const int k = i - r * d0;
    hin[r * ld + k] =
        row0 + r < rows ? x[static_cast<long long>(row0 + r) * d0 + k] : 0.0f;
  }
  __syncthreads();

  const int n_run = kSave ? wd.n_layers - 1 : wd.n_layers;
  long long soff = 0;
  for (int l = 0; l < n_run; ++l) {
    const int din = wd.w[l];
    const int dout = wd.w[l + 1];
    const bool last = l == wd.n_layers - 1;
    const Bf16OfF32* w = reinterpret_cast<const Bf16OfF32*>(p.w[l]);
    const bool vec =
        dout % 4 == 0 && (reinterpret_cast<uintptr_t>(w) & 15) == 0;
    // the saved block starts rows * (d_1 + ... + d_l) floats in, which a
    // hidden width of 2 mod 4 at an odd batch leaves off 16 bytes
    const bool save4 =
        kSave && dout % 4 == 0 &&
        (reinterpret_cast<uintptr_t>(saved + soff) & 15) == 0;
    for (int c0 = 4 * threadIdx.x; c0 < dout; c0 += 4 * blockDim.x) {
      float acc[TB][4];
#pragma unroll
      for (int r = 0; r < TB; ++r) {
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[r][j] = 0.0f;
      }
      if (vec) {
        accumulate<true>(w + c0, dout, dout - c0, din, hin, ld, acc);
      } else {
        accumulate<false>(w + c0, dout, dout - c0, din, hin, ld, acc);
      }
      float bias[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        bias[j] = c0 + j < dout ? p.b[l][c0 + j] : 0.0f;
      }
#pragma unroll
      for (int r = 0; r < TB; ++r) {
        float v[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          v[j] = acc[r][j] + bias[j];
          // `v < 0` keeps a NaN, as jnp.maximum does
          if (!last && v[j] < 0.0f) v[j] = 0.0f;
        }
        const long long orow = static_cast<long long>(row0 + r) * dout;
        if (!last) {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            if (c0 + j < dout) hout[r * ld + c0 + j] = v[j];
          }
          if (kSave && row0 + r < rows) {
            float* s = saved + soff + orow + c0;
            if (save4) {  // rows of dout % 4 == 0 floats keep its alignment
              *reinterpret_cast<float4*>(s) =
                  make_float4(v[0], v[1], v[2], v[3]);
            } else {
              for (int j = 0; j < 4 && c0 + j < dout; ++j) s[j] = v[j];
            }
          }
        } else if (row0 + r < rows) {
          for (int j = 0; j < 4 && c0 + j < dout; ++j) out[orow + c0 + j] = v[j];
        }
      }
    }
    __syncthreads();
    float* t = hin;
    hin = hout;
    hout = t;
    soff += static_cast<long long>(rows) * dout;
  }
}

template <int TB, bool kSave>
int launch_train_tile(const float* x, const Layers& p, const Widths& wd,
                      int rows, int ld, float* out, float* saved,
                      cudaStream_t stream) {
  auto kernel = train_forward_kernel<TB, kSave>;
  static bool opted[kMaxDevices] = {};
  static std::mutex mu;
  const int e = opt_in_shared_memory(kernel, opted, mu);
  if (e != 0) return e;
  const size_t smem = 2 * static_cast<size_t>(TB) * ld * sizeof(float);
  kernel<<<(rows + TB - 1) / TB, kMlpThreads, smem, stream>>>(
      x, p, wd, rows, ld, out, saved);
  return static_cast<int>(cudaGetLastError());
}

// Copy the C arguments into the by-value structs; 0 or an error code.
inline int train_layers(const float* const* w, const float* const* b,
                        const int* widths, int n_layers, Layers* p,
                        Widths* wd) {
  if (n_layers < 1 || n_layers > kMaxLayers) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  wd->n_layers = n_layers;
  for (int i = 0; i <= n_layers; ++i) wd->w[i] = widths[i];
  for (int i = 0; i < n_layers; ++i) {
    p->w[i] = w[i];
    p->b[i] = b[i];
  }
  return 0;
}

template <bool kSave>
int launch_train_forward(const float* x, const Layers& p, const Widths& wd,
                         int rows, int tile_rows, float* out, float* saved,
                         cudaStream_t stream) {
  int widest_in = 0;
  for (int i = 0; i < wd.n_layers; ++i) {
    widest_in = wd.w[i] > widest_in ? wd.w[i] : widest_in;
  }
  const int ld = (widest_in + 3) & ~3;
  switch (tile_rows) {
    case 4:
      return launch_train_tile<4, kSave>(x, p, wd, rows, ld, out, saved,
                                         stream);
    case 16:
      return launch_train_tile<16, kSave>(x, p, wd, rows, ld, out, saved,
                                          stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace cst
