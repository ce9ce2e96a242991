// fused_mlp_forward: the whole relu MLP in one launch, f32 or bf16 weights.
//
// Replaces climsim_tpu/ops/kernels.py fused_mlp_forward / _mlp_kernel (the
// pl.pallas_call at kernels.py:263): h = h_f32 @ W + b layer by layer, relu
// between layers and on the last relu_tail outputs.
//
// Bound on the H100: float32 FMA throughput.  The 557 -> 1024 x 4 -> 368
// coupling MLP costs about 4.1 M multiply-adds a row; its bf16 weights
// (8.4 MB) are re-read from L2 by every block, which at TB rows a block
// makes L2 traffic 8.4 MB * ceil(B / TB).  The reference numerics (float32
// activations) rule out the bf16 tensor cores for now.
//
// Design (see mlp_forward.cuh): activations stay in shared memory for the
// whole network, so only x, the weights and the output touch device memory;
// each weight loaded from L2 feeds TB rows, and each activation read from
// shared memory feeds 4 columns.  The caller picks TB = 16 (128 KB of
// shared memory at width 1024) once there are rows enough to give every SM
// a block of 16, else TB = 4, which runs B = 384 (one ne4 chunk) as 96
// blocks rather than 24.
#include "mlp_forward.cuh"

// x: (rows, widths[0]) float32; w: every layer's (d_in, d_out) row-major,
// concatenated; bias: every layer's d_out floats, concatenated; out:
// (rows, widths[n_layers]) float32.
extern "C" int cst_fused_mlp_forward_f32(const float* x, const float* w,
                                         const float* bias, float* out,
                                         const int* widths, int n_layers,
                                         int rows, int relu_tail,
                                         int tile_rows, void* stream) {
  return cst::launch_mlp<float, false>(x, w, nullptr, bias, out, widths,
                                       n_layers, rows, relu_tail, tile_rows,
                                       stream);
}

extern "C" int cst_fused_mlp_forward_bf16(const float* x, const void* w,
                                          const float* bias, float* out,
                                          const int* widths, int n_layers,
                                          int rows, int relu_tail,
                                          int tile_rows, void* stream) {
  return cst::launch_mlp<__nv_bfloat16, false>(
      x, static_cast<const __nv_bfloat16*>(w), nullptr, bias, out, widths,
      n_layers, rows, relu_tail, tile_rows, stream);
}
