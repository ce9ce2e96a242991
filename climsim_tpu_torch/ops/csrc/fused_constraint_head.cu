// fused_constraint_head: the v5 coupling postprocess in one pass.
//
// Replaces climsim_tpu/ops/kernels.py make_fused_constraint_head /
// _constraint_kernel (the pl.pallas_call at kernels.py:189), which computes
// the XLA chain of climsim_tpu/online/wrapper.py:112-125.  Per column, from
// the normalized v5 output y (308: t 0:60, q1 60:120, qn 120:180, u 180:240,
// v 240:300, 8 scalars 300:308) and t, qc, qi before the step (60 each):
//   yu     = y * mask * scaleinv       (stratosphere zeroing, un-scaling)
//   t_new  = t + yu_t * dt,  qn_new = qc + qi + yu_qn * dt
//   liq    = clip((t_new - 253.16) / 20, 0, 1)
//   dqc    = (liq * qn_new - qc) / dt,  dqi = ((1 - liq) * qn_new - qi) / dt
//   out    = [yu_t, yu_q1, dqc, dqi, yu_u, yu_v, yu_scalars]   (368)
// in that order of operations.  nvcc contracts a*b+c into one FMA by
// default, so the result may differ from the plain version's separate
// roundings in the last bit (chip_smoke.py reports the error).
//
// Bound on the H100: device-memory bandwidth.  A column reads 488 floats
// (1.95 KB) and writes 368 (1.47 KB) with a few flops an element; the two
// constant rows (2 x 308 floats) stay in L1/L2.
//
// Design: one thread per output element, grid-stride over the flat
// (B, 368) output, so stores coalesce and neighbouring threads read
// neighbouring inputs.  The TPU kernel's 64-lane repacking of each level
// block is a TPU layout and is dropped: the offsets are computed per
// element and the ragged end is masked by the loop bound.
#include "common.cuh"

namespace {

constexpr int kLev = 60;
constexpr int kIn = 308;
constexpr int kOut = 368;

__global__ void constraint_head_kernel(const float* __restrict__ y,
                                       const float* __restrict__ t,
                                       const float* __restrict__ qc,
                                       const float* __restrict__ qi,
                                       const float* __restrict__ consts,
                                       float* __restrict__ out, long long n,
                                       float dt) {
  const float* mask = consts;
  const float* scaleinv = consts + kIn;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n; i += stride) {
    const long long row = i / kOut;
    const int j = static_cast<int>(i - row * kOut);
    const float* yr = y + row * kIn;
    auto un = [&](int k) {
      return yr[k] * __ldg(mask + k) * __ldg(scaleinv + k);
    };
    float v;
    if (j < 2 * kLev) {
      v = un(j);                          // t, q1
    } else if (j < 4 * kLev) {            // dqc, dqi
      const int l = (j - 2 * kLev) % kLev;
      const long long p = row * kLev + l;
      const float c = qc[p];
      const float ice = qi[p];
      const float t_new = t[p] + un(l) * dt;
      const float qn_new = c + ice + un(2 * kLev + l) * dt;
      const float liq = fminf(fmaxf((t_new - 253.16f) / 20.0f, 0.0f), 1.0f);
      v = j < 3 * kLev ? (liq * qn_new - c) / dt
                       : ((1.0f - liq) * qn_new - ice) / dt;
    } else {
      v = un(j - kLev);                   // u, v, scalars
    }
    out[i] = v;
  }
}

}  // namespace

// y: (rows, 308); t, qc, qi: (rows, 60); consts: (2, 308) rows mask and
// 1 / out_scale; out: (rows, 368); all float32 row-major.
extern "C" int cst_fused_constraint_head(const float* y, const float* t,
                                         const float* qc, const float* qi,
                                         const float* consts, float* out,
                                         int rows, float dt, void* stream) {
  const long long n = static_cast<long long>(rows) * kOut;
  const int threads = 256;
  long long blocks = (n + threads - 1) / threads;
  if (blocks > 65535) blocks = 65535;  // the grid-stride loop covers the rest
  constraint_head_kernel<<<static_cast<int>(blocks), threads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      y, t, qc, qi, consts, out, n, dt);
  return static_cast<int>(cudaGetLastError());
}
