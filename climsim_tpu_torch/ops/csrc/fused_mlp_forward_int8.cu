// fused_mlp_forward_int8: the whole relu MLP in one launch with weight-only
// int8 weights and per-output-channel float32 scales.
//
// Replaces climsim_tpu/ops/kernels.py fused_mlp_forward_int8 /
// _mlp_q8_kernel (the pl.pallas_call at kernels.py:359): per layer
// y = bf16(h) @ bf16(q) with float32 accumulation, then h = y * scale + b,
// relu as in fused_mlp_forward.
//
// Bound on the H100: the int8 weights' bytes from device memory (4.1 MB
// for the 4x1024 coupling MLP).  Design: the tensor-core kernel of
// mlp_forward_wgmma.cuh.  Every activation is rounded to bf16 (round to
// nearest even) when it is published, as kernels.py:320 does, and an int8
// weight widens to bf16 exactly, so bf16 x bf16 wgmma with float32 sums
// forms the Pallas kernel's products; Hopper has no int8 x bf16 MMA, so
// TMA brings each int8 box and the threads widen it in shared memory into
// the swizzled bf16 box wgmma reads.
#include "mlp_forward_wgmma.cuh"

// q: the pack's padded device layout (PackedMLP.w, int8); scale and bias:
// its padded scales and biases (PackedMLP.scale, .b); the plan as in
// cst_fused_mlp_forward_bf16.
extern "C" int cst_fused_mlp_forward_int8(const float* x, const int8_t* q,
                                          const float* scale,
                                          const float* bias, float* out,
                                          void* act, const int* widths,
                                          int n_layers,
                                          int rows, int relu_tail, int nwg,
                                          int nb, int cluster, int stages,
                                          void* stream) {
  return cst::mlpw::launch<true>(x, q, scale, bias, out, act, widths,
                                 n_layers, rows, relu_tail, nwg, nb, cluster,
                                 stages, 1, stream);
}

// cst_mlp_forward_clusters_bf16 for the int8 instantiations.
extern "C" int cst_mlp_forward_clusters_int8(int nwg, int nb, int cluster,
                                             int smem) {
  return cst::mlpw::active_clusters<true>(nwg, nb, cluster, smem);
}
