// fused_mlp_train_fwd: the forward of the fused MLP-training kernel
// (kernel 6), and the pack its forward and backward read.
//
// Replaces climsim_tpu/ops/fused_mlp_train.py _fwd_kernel (:50, the
// pl.pallas_call at :134): the relu MLP with a linear last layer, float32
// activations times the float32 weights rounded to bf16 (nearest even, as
// w.astype(bf16) at :57), float32 sums, + b, (B, d_out) float32 out.
//
// Bound on the H100: the products.  The v1 MLP (124 -> 768, 640, 512,
// 640, 640 -> 128) is 1.73 M multiply-adds a row, 113.6 GFLOP at B =
// 32,768; float32 activations against bf16 weights take three bf16
// passes on the tensor cores for float32's products (340.8 GFLOP, 0.345
// ms at 989 TFLOP/s), against 33 MB of x in and y out.
//
// Design: the parameters change every step, so
//  * pack_kernel rounds every layer's float32 weights to bf16 into the
//    tensor-core kernel's padded device layout (PackedMLP, ops/kernels.py:
//    each layer zero-padded to 64 x 64 boxes, stacked in one matrix; the
//    biases padded, float32), all layers in one launch; the backward reads
//    the same pack (W^T of its dh products);
//  * the forward is kernel 2's tensor-core kernel (mlp_forward_wgmma.cuh:
//    float32 activations split exactly into hi, mid and lo bf16 planes,
//    three wgmma passes into float32 sums, bias and relu in the
//    epilogue), with relu_tail 0 (a linear last layer).  The backward's
//    recompute runs the same kernel with the same plan and its save
//    epilogue, so its relu masks are the forward's, bit for bit.
#include "mlp_forward_wgmma.cuh"

namespace {

struct PackArgs {
  const float* w[cst::kMaxLayers];  // (d_l, d_{l+1}) row-major float32
  const float* b[cst::kMaxLayers];  // (d_{l+1},) float32
  int widths[cst::kMaxLayers + 1];
  int roff[cst::kMaxLayers + 1];    // layer l's first row in the pack
  int boff[cst::kMaxLayers + 1];    // layer l's first padded bias
  int n_layers, cols;               // the pack's columns: the widest Np
};

// Element i of the pack (weights, then biases); one thread an element.
__global__ void pack_kernel(const __grid_constant__ PackArgs a,
                            __nv_bfloat16* __restrict__ w,
                            float* __restrict__ bias) {
  const long long nw =
      static_cast<long long>(a.roff[a.n_layers]) * a.cols;
  const long long n = nw + a.boff[a.n_layers];
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    if (i < nw) {
      const int r = static_cast<int>(i / a.cols);
      const int c = static_cast<int>(i - static_cast<long long>(r) * a.cols);
      int l = 0;
      while (r >= a.roff[l + 1]) ++l;
      const int k = r - a.roff[l];
      const int dout = a.widths[l + 1];
      w[i] = k < a.widths[l] && c < dout
                 ? __float2bfloat16_rn(
                       a.w[l][static_cast<long long>(k) * dout + c])
                 : __float2bfloat16_rn(0.0f);
    } else {
      const int j = static_cast<int>(i - nw);
      int l = 0;
      while (j >= a.boff[l + 1]) ++l;
      const int c = j - a.boff[l];
      bias[j] = c < a.widths[l + 1] ? a.b[l][c] : 0.0f;
    }
  }
}

}  // namespace

// w[l]: (widths[l], widths[l+1]) float32, b[l]: (widths[l+1],) float32;
// wp: (sum of the padded d_in, the widest padded d_out) bf16 and bp: (sum
// of the padded d_out) float32, the PackedMLP layout.
extern "C" int cst_fused_mlp_train_pack(const float* const* w,
                                        const float* const* b,
                                        const int* widths, int n_layers,
                                        void* wp, float* bp, void* stream) {
  if (n_layers < 1 || n_layers > cst::kMaxLayers)
    return static_cast<int>(cudaErrorInvalidValue);
  PackArgs a{};
  a.n_layers = n_layers;
  for (int l = 0; l <= n_layers; ++l) {
    if (widths[l] < 1) return static_cast<int>(cudaErrorInvalidValue);
    a.widths[l] = widths[l];
  }
  for (int l = 0; l < n_layers; ++l) {
    a.w[l] = w[l];
    a.b[l] = b[l];
    const int kp = cst::mlpw::kChunk * cst::mlpw::chunks(widths[l]);
    const int np = cst::mlpw::kChunk * cst::mlpw::chunks(widths[l + 1]);
    a.roff[l + 1] = a.roff[l] + kp;
    a.boff[l + 1] = a.boff[l] + np;
    a.cols = np > a.cols ? np : a.cols;
  }
  const long long n =
      static_cast<long long>(a.roff[n_layers]) * a.cols + a.boff[n_layers];
  const int threads = 256;
  const long long blocks = (n + threads - 1) / threads;
  pack_kernel<<<static_cast<unsigned>(blocks < 4096 ? blocks : 4096),
                threads, 0, static_cast<cudaStream_t>(stream)>>>(
      a, static_cast<__nv_bfloat16*>(wp), bp);
  return static_cast<int>(cudaGetLastError());
}

// The forward on a pack: kernel 2's tensor-core kernel with a linear last
// layer.  x: (rows, widths[0]) float32; out: (rows, widths[n_layers])
// float32; act: kernel 2's scratch; the plan (ops/fused_mlp_train.py
// plan_mlp_train, its forward part); passes as kernel 2's (3 forms
// float32's products; fewer for the card's planted-fault check).
extern "C" int cst_fused_mlp_train_fwd(const float* x, const void* wp,
                                       const float* bp, float* out,
                                       void* act, const int* widths,
                                       int n_layers, int rows, int nwg,
                                       int nb, int cluster, int stages,
                                       int passes, void* stream) {
  return cst::mlpw::launch<false, true>(x, wp, nullptr, bp, out, act,
                                        widths, n_layers, rows, 0, nwg, nb,
                                        cluster, stages, passes, stream);
}
