// fused_input_transform: raw (B, D) columns -> normalized (B, D), one pass.
//
// Replaces climsim_tpu/ops/kernels.py make_fused_input_transform /
// _transform_kernel (the pl.pallas_call at kernels.py:101).  Per feature j:
//   v = is_cloud[j] ? 1 - exp(-v * lbd[j]) : v     (cloud exponential rate)
//   v = (v - sub[j]) * divinv[j]                     (normalize)
//   v = isfinite(v) ? v : 0                          (nan/inf cleanup)
//   v = v * mask[j]                                  (input pruning)
//   v = min(max(v, lo[j]), hi[j])                    (clip; +/-inf = off)
// in that order.  lbd is a per-feature vector, zero outside the cloud
// lanes, so one kernel covers the v5 state_qn rate and the v4/v2
// state_q0002/state_q0003 rates (the Pallas kernel handled state_qn only).
//
// Bound on the H100: device-memory bandwidth.  Every element is read once
// and written once (8 bytes; about 4.5 KB for a 557-wide column) with a
// dozen flops; the seven constant rows (7 * D floats, 15.6 KB at D = 557)
// are reused by every row and stay in L1/L2.
//
// Design: one thread per element, grid-stride loop over the flat row-major
// array, so neighbouring threads touch neighbouring addresses and the
// loads coalesce; the constants go through the read-only cache (__ldg).
// No lane padding: the loop bound masks the ragged end at any B and D.
// Built without --use_fast_math, so isfinite is not folded away and expf
// is the accurate one.
#include "common.cuh"

namespace {

enum ConstRow { kSub, kDivInv, kMask, kLo, kHi, kLbd, kIsCloud };

__global__ void fused_input_transform_kernel(const float* __restrict__ x,
                                             const float* __restrict__ c,
                                             float* __restrict__ out,
                                             long long n, int d) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n; i += stride) {
    const int j = static_cast<int>(i % d);
    float v = x[i];
    if (__ldg(c + kIsCloud * d + j) > 0.5f) {
      v = 1.0f - expf(-v * __ldg(c + kLbd * d + j));
    }
    v = (v - __ldg(c + kSub * d + j)) * __ldg(c + kDivInv * d + j);
    if (!isfinite(v)) v = 0.0f;
    v = v * __ldg(c + kMask * d + j);
    v = fminf(fmaxf(v, __ldg(c + kLo * d + j)), __ldg(c + kHi * d + j));
    out[i] = v;
  }
}

}  // namespace

// x, out: (rows, d) float32 row-major; consts: (7, d) float32 rows in
// ConstRow order.
extern "C" int cst_fused_input_transform(const float* x, const float* consts,
                                         float* out, int rows, int d,
                                         void* stream) {
  const long long n = static_cast<long long>(rows) * d;
  const int threads = 256;
  long long blocks = (n + threads - 1) / threads;
  if (blocks > 65535) blocks = 65535;  // the grid-stride loop covers the rest
  fused_input_transform_kernel<<<static_cast<int>(blocks), threads, 0,
                                 static_cast<cudaStream_t>(stream)>>>(
      x, consts, out, n, d);
  return static_cast<int>(cudaGetLastError());
}
