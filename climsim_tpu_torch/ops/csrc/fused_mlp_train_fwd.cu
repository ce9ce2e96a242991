// fused_mlp_train_fwd: the forward of the fused MLP-training kernel
// (kernel 6).
//
// Replaces climsim_tpu/ops/fused_mlp_train.py _fwd_kernel (:50, the
// pl.pallas_call at :134): the whole relu MLP with a linear last layer in
// one launch, float32 activations times the float32 weights rounded to
// bf16 in the kernel, float32 sums, (B, d_out) float32 out.
//
// Bound on the H100: float32 FMA throughput, as kernel 2.  The v1 MLP
// (124 -> 768, 640, 512, 640, 640 -> 128) costs 1.73 M multiply-adds a
// row, 113.6 GFLOP at B = 32,768, against 16 MB of x in and out; the
// float32 activations of the reference rule out the bf16 tensor cores.
//
// Design: kernel 2's (see mlp_train.cuh): activations in shared memory
// for the whole network, so only x, the weights (from L2) and the output
// touch device memory.  The backward recomputes the forward with this
// same device code (fused_mlp_train_bwd.cu) rather than keep activations
// from the forward, as the Pallas kernel does.
#include "mlp_train.cuh"

// x: (rows, widths[0]) float32; w[l]: (widths[l], widths[l+1]) row-major
// float32; b[l]: (widths[l+1],) float32; out: (rows, widths[n_layers])
// float32; tile_rows: 4 or 16 rows a block.
extern "C" int cst_fused_mlp_train_fwd(const float* x, const float* const* w,
                                       const float* const* b, float* out,
                                       const int* widths, int n_layers,
                                       int rows, int tile_rows,
                                       void* stream) {
  cst::Layers p;
  cst::Widths wd;
  const int e = cst::train_layers(w, b, widths, n_layers, &p, &wd);
  if (e != 0) return e;
  if (rows < 1) return static_cast<int>(cudaErrorInvalidValue);
  return cst::launch_train_forward<false>(x, p, wd, rows, tile_rows, out,
                                          nullptr,
                                          static_cast<cudaStream_t>(stream));
}
