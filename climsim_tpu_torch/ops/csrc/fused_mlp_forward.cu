// fused_mlp_forward: the whole relu MLP in one launch, f32 or bf16 weights.
//
// Replaces climsim_tpu/ops/kernels.py fused_mlp_forward / _mlp_kernel (the
// pl.pallas_call at kernels.py:263): h = h_f32 @ W + b layer by layer, relu
// between layers and on the last relu_tail outputs.
//
// bf16 weights (the served path) run the tensor-core kernel of
// mlp_forward_wgmma.cuh: float32 activations split exactly into three
// bf16 parts, three bf16 wgmma passes into float32 sums, so the products
// are float32's (the sums are the tensor cores'); weights by TMA, read
// once a row tile by a cluster that splits every layer's columns; bound
// by the weights' bytes from device memory (8.2 MB for the 557 -> 1024 x
// 4 -> 368 coupling MLP).
//
// float32 weights (no served path) stay on the FMA kernel of
// mlp_forward.cuh: TB rows a block, activations in shared memory, float32
// FMAs; the caller picks TB = 16 once every SM gets a block of 16, else 4.
#include "mlp_forward.cuh"
#include "mlp_forward_wgmma.cuh"

// x: (rows, widths[0]) float32; w: every layer's (d_in, d_out) row-major,
// concatenated; bias: every layer's d_out floats, concatenated; out:
// (rows, widths[n_layers]) float32.
extern "C" int cst_fused_mlp_forward_f32(const float* x, const float* w,
                                         const float* bias, float* out,
                                         const int* widths, int n_layers,
                                         int rows, int relu_tail,
                                         int tile_rows, void* stream) {
  return cst::launch_mlp<float>(x, w, bias, out, widths, n_layers, rows,
                                relu_tail, tile_rows, stream);
}

// w: the pack's padded device layout (PackedMLP.w, bf16), bias its
// padded biases (PackedMLP.b); the plan (ops/kernels.py plan_mlp_forward):
// 64 nwg rows a tile, clusters of `cluster` CTAs owning at most nb
// 64-column chunks of a layer, `stages` weight stages.  passes: how many
// of the activations' bf16 parts (hi, mid, lo) enter the products; 3
// forms float32's products.
extern "C" int cst_fused_mlp_forward_bf16(const float* x, const void* w,
                                          const float* bias, float* out,
                                          void* act, const int* widths,
                                          int n_layers,
                                          int rows, int relu_tail, int nwg,
                                          int nb, int cluster, int stages,
                                          int passes, void* stream) {
  return cst::mlpw::launch<false>(x, w, nullptr, bias, out, act, widths,
                                  n_layers, rows, relu_tail, nwg, nb,
                                  cluster, stages, passes, stream);
}

// Clusters of the bf16 instantiation for (nwg, nb, cluster) with `smem`
// bytes a CTA that the current card holds at once; 0 where none can be
// scheduled; minus a CUDA error.
extern "C" int cst_mlp_forward_clusters_bf16(int nwg, int nb, int cluster,
                                             int smem) {
  return cst::mlpw::active_clusters<false>(nwg, nb, cluster, smem);
}

// The dynamic shared memory a CTA of the tensor-core kernel takes
// (smem_layout's total), for ops/kernels.py _mlp_smem to be held against.
extern "C" int cst_mlp_forward_smem(int int8, int nwg, int nb, int stages) {
  return static_cast<int>(
      cst::mlpw::smem_layout(int8 != 0, nwg, nb, stages).total);
}
