// fused_mlp_forward_int8: the whole relu MLP in one launch with weight-only
// int8 weights and per-output-channel float32 scales.
//
// Replaces climsim_tpu/ops/kernels.py fused_mlp_forward_int8 /
// _mlp_q8_kernel (the pl.pallas_call at kernels.py:359): per layer
// y = bf16(h) @ bf16(q) with float32 accumulation, then h = y * scale + b,
// relu as in fused_mlp_forward.
//
// Bound on the H100: float32 FMA throughput, as fused_mlp_forward; the int8
// weights halve the L2 traffic of the bf16 variant (4.2 MB for the
// 4x1024 coupling MLP).  Hopper has no int8 x bf16 MMA, and quantizing the
// activations to s8 for the integer tensor cores would change the
// semantics, so the product stays on the float32 pipes.
//
// Design: the skeleton of mlp_forward.cuh with int8 weights widened to
// float (exact for |q| <= 127) and every activation rounded to bf16 with
// __float2bfloat16_rn when it is written to shared memory, i.e. before its
// product: bf16 x (small integer) products are exact in float32, so the
// float32 FMA chain computes what the bf16 dot with float32 accumulation
// computes, up to summation order.
#include "mlp_forward.cuh"

// q: every layer's (d_in, d_out) int8 row-major, concatenated; scale and
// bias: every layer's d_out floats, concatenated.
extern "C" int cst_fused_mlp_forward_int8(const float* x, const int8_t* q,
                                          const float* scale,
                                          const float* bias, float* out,
                                          const int* widths, int n_layers,
                                          int rows, int relu_tail,
                                          int tile_rows, void* stream) {
  return cst::launch_mlp<int8_t, true>(x, q, scale, bias, out, widths,
                                       n_layers, rows, relu_tail, tile_rows,
                                       stream);
}
