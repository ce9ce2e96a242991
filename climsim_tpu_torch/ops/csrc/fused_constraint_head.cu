// fused_constraint_head: the v5 coupling postprocess in one pass.
//
// Replaces climsim_tpu/ops/kernels.py make_fused_constraint_head /
// _constraint_kernel (the pl.pallas_call at kernels.py:189), which computes
// the XLA chain of climsim_tpu/online/wrapper.py:112-125.  Per column, from
// the normalized v5 output y (308: t 0:60, q1 60:120, qn 120:180, u 180:240,
// v 240:300, 8 scalars 300:308) and t, qc, qi before the step (60 each):
//   yu     = y * mask * scaleinv       (stratosphere zeroing, un-scaling)
//   t_new  = t + yu_t * dt,  qn_new = (qc + qi) + yu_qn * dt
//   liq    = clip((t_new - 253.16) / 20, 0, 1)
//   dqc    = (liq * qn_new - qc) / dt,  dqi = ((1 - liq) * qn_new - qi) / dt
//   out    = [yu_t, yu_q1, dqc, dqi, yu_u, yu_v, yu_scalars]   (368)
// in the plain version's order of operations, every step rounded on its
// own (the __f*_rn intrinsics: no contraction into an FMA).  PyTorch on the
// card divides a tensor by a Python scalar as a product with the scalar's
// float reciprocal (ATen's div_true_kernel_cuda), so the two divisions are
// products with 1.0f / 20.0f and 1.0f / dt here too, and the kernel is
// bit-equal to the plain version on the card; the plain version on the CPU
// divides, and differs from both by at most an ulp or so of those steps.
//
// Bound on the H100: device-memory bytes.  A column reads 488 floats and
// writes 368 (3424 B) with a few flops an element, and the (2, 308)
// constants are read once: (3424 B + 2464) bytes over 3.35 TB/s.  The first
// version (one thread an output element, a 64-bit i / 368 each, the dqc and
// dqi threads of a level each reloading t, qc, qi and two y values and
// each recomputing t_new, qn_new and liq) needed t, qc and qi contiguous,
// so the v4 wrapper copied three slices of the raw row a request.  This
// design:
//
//  * Row tiles.  A CTA takes tiles of R rows (the host's plan,
//    ops/kernels.py plan_constraint_head).
//  * One thread a (row, level).  The level threads (R * 60 of them, after
//    the 256 column threads) read t, qc and qi of their row and level with
//    coalesced loads (a warp covers consecutive levels), issued before the
//    tile's y is read; each computes t_new, qn_new and liq once and writes
//    both dqc and dqi.
//  * Strided inputs.  t, qc and qi are (B, 60) views with any row stride
//    (ld_t, ld_qc, ld_qi floats), such as slices of the raw v4 row, so the
//    wrapper copies nothing.
//  * Constants once a CTA, in registers.  Column thread c (248 of them)
//    owns one of the y columns that pass through scaled (t, q1, u, v, the
//    scalars) in every row of every tile; a level thread owns the t and qn
//    columns of its level.
//  * Direct where y, t, qc and qi fit half the L2 (B <= 13,429 on an H100),
//    as in fused_input_transform.cu: the callers' data is in L2 and the
//    copy engine's round trips would only add latency.  A CTA takes one
//    tile, reads y and writes out by ordinary coalesced accesses, no shared
//    memory.  A y that is not 16-byte aligned takes this path too.
//  * Pipelined past that: thread 0 brings the y tile (R x 308 floats, a
//    multiple of 16 bytes at any R) by one 1D bulk copy into shared memory,
//    completing on an mbarrier, and the (R, 368) output tile is assembled
//    in shared memory and leaves by one bulk store; one or two CTAs an SM,
//    up to four y tiles in flight, two output tiles alternating.
#include "common.cuh"
#include "hopper.cuh"

namespace {

using namespace cst;  // the Hopper helpers of hopper.cuh

constexpr int kLev = 60;
constexpr int kIn = 308;
constexpr int kOut = 368;
constexpr int kColThreads = 256;  // the first 248 own a scaled column
constexpr int kScaled = kIn - kLev;
constexpr int kMaxRows = 12;      // HEAD_MAX_ROWS in ops/kernels.py
constexpr int kMaxStages = 4;     // HEAD_STAGES
constexpr int kMaxThreads = 1024;
constexpr int kGroup = 4;         // rows a column thread loads, then stores
constexpr float kTIce = 253.16f;  // physics.T_ICE

__device__ __forceinline__ float clip01(float v) {
  // torch.clamp: NaN passes through
  return v != v ? v : fminf(fmaxf(v, 0.0f), 1.0f);
}

// DIRECT: ordinary loads and stores, no shared memory; else y tiles by the
// copy engine (y 16-byte aligned) and output tiles by bulk stores.
template <bool DIRECT>
__global__ void __launch_bounds__(kMaxThreads)
    constraint_head_kernel(const float* __restrict__ y,
                           const float* __restrict__ t,
                           const float* __restrict__ qc,
                           const float* __restrict__ qi, long long ld_t,
                           long long ld_qc, long long ld_qi,
                           const float* __restrict__ consts,
                           float* __restrict__ out, int rows, float dt,
                           int tile_rows, int n_tiles, int stages) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* y_s = reinterpret_cast<float*>(smem);          // `stages` y tiles
  float* out_s = y_s + stages * tile_rows * kIn;        // two output tiles
  uint64_t* full =
      reinterpret_cast<uint64_t*>(out_s + 2 * tile_rows * kOut);
  const float* mask = consts;
  const float* scaleinv = consts + kIn;
  // PyTorch's x / scalar on the card: x * (1.0f / scalar)
  const float inv_ramp = __fdiv_rn(1.0f, 20.0f);  // T_FREEZE - T_ICE
  const float inv_dt = __fdiv_rn(1.0f, dt);

  const int tid = threadIdx.x;
  // whether this CTA has a local tile k (CTA i takes tiles i, i + grid, ...;
  // the host gives the tile count: no division ahead of the first load)
  auto has = [&](int k) {
    return static_cast<long long>(blockIdx.x) +
               static_cast<long long>(k) * gridDim.x < n_tiles;
  };

  auto first_row = [&](int k) {
    return static_cast<long long>(blockIdx.x + k * gridDim.x) * tile_rows;
  };
  auto n_rows = [&](int k) {
    return static_cast<int>(min(static_cast<long long>(tile_rows),
                                rows - first_row(k)));
  };
  auto load = [&](int k, int s) {
    const uint32_t bytes = static_cast<uint32_t>(n_rows(k)) * kIn * 4;
    mbar_expect_tx(full + s, bytes);
    bulk_load(y_s + s * tile_rows * kIn, y + first_row(k) * kIn, bytes,
              full + s);
  };

  if (!DIRECT) {
    if (tid == 0) {
      for (int s = 0; s < stages; ++s) mbar_init(full + s, 1);
      fence_barrier_init();
    }
    __syncthreads();
    if (tid == 0) {
      for (int k = 0; k < stages && has(k); ++k) load(k, k);
    }
  }

  // a column thread's column (y and out), or a level thread's row and level
  const bool column = tid < kScaled;
  const int item = tid - kColThreads;
  const bool level = item >= 0 && item < tile_rows * kLev;
  int yc = 0, oc = 0, lr = 0, l = 0;
  float m0 = 0.0f, s0 = 0.0f, m1 = 0.0f, s1 = 0.0f;
  if (column) {
    yc = tid < 2 * kLev ? tid : tid + kLev;  // skip qn (y 120:180)
    oc = tid < 2 * kLev ? tid : tid + 2 * kLev;
    m0 = mask[yc];
    s0 = scaleinv[yc];
  } else if (level) {
    lr = item / kLev;
    l = item - lr * kLev;
    m0 = mask[l];                  // t
    s0 = scaleinv[l];
    m1 = mask[2 * kLev + l];       // qn
    s1 = scaleinv[2 * kLev + l];
  }

  for (int k = 0, s = 0, parity = 0; has(k); ++k) {
    const int nr = n_rows(k);
    const long long row0 = first_row(k);
    // the output tile: in shared memory for the bulk store, or (direct) the
    // output rows themselves
    float* dst =
        DIRECT ? out + row0 * kOut : out_s + (k & 1) * tile_rows * kOut;
    const float* src = DIRECT ? y + row0 * kIn : y_s + s * tile_rows * kIn;
    const bool on = level && lr < nr;
    float tv = 0.0f, cv = 0.0f, iv = 0.0f;
    if (on) {  // before the tile's y has landed
      tv = t[(row0 + lr) * ld_t + l];
      cv = qc[(row0 + lr) * ld_qc + l];
      iv = qi[(row0 + lr) * ld_qi + l];
    }
    if (!DIRECT) mbar_wait(full + s, parity);
    if (column) {
      // kGroup rows at a time: every load of the group is issued before
      // the first store, which the compiler could not otherwise move them
      // past (src and dst may be shared or global memory)
      for (int r = 0; r < nr; r += kGroup) {
        float v[kGroup];
#pragma unroll
        for (int g = 0; g < kGroup; ++g) {
          if (r + g < nr) v[g] = src[(r + g) * kIn + yc];
        }
#pragma unroll
        for (int g = 0; g < kGroup; ++g) {
          if (r + g < nr) {
            dst[(r + g) * kOut + oc] = __fmul_rn(__fmul_rn(v[g], m0), s0);
          }
        }
      }
    } else if (on) {
      const float* yr = src + lr * kIn;
      const float yt = __fmul_rn(__fmul_rn(yr[l], m0), s0);
      const float yq = __fmul_rn(__fmul_rn(yr[2 * kLev + l], m1), s1);
      const float qn_before = __fadd_rn(cv, iv);
      const float t_new = __fadd_rn(tv, __fmul_rn(yt, dt));
      const float qn_new = __fadd_rn(qn_before, __fmul_rn(yq, dt));
      const float liq = clip01(__fmul_rn(__fsub_rn(t_new, kTIce), inv_ramp));
      const float qc_new = __fmul_rn(liq, qn_new);
      const float qi_new = __fmul_rn(__fsub_rn(1.0f, liq), qn_new);
      float* orow = dst + lr * kOut;
      orow[2 * kLev + l] = __fmul_rn(__fsub_rn(qc_new, cv), inv_dt);
      orow[3 * kLev + l] = __fmul_rn(__fsub_rn(qi_new, iv), inv_dt);
    }
    if (DIRECT) continue;
    fence_proxy_async_shared();
    // the store of the tile before (the other output buffer) has read it,
    // before any thread passes on to write that buffer
    if (tid == 0) bulk_wait_read();
    __syncthreads();
    if (tid == 0) {
      bulk_store(out + row0 * kOut, dst,
                 static_cast<uint32_t>(nr) * kOut * 4);
      bulk_commit();
      if (has(k + stages)) {
        fence_proxy_async_shared();
        load(k + stages, s);
      }
    }
    if (++s == stages) {
      s = 0;
      parity ^= 1;
    }
  }
  // the shared memory outlives the stores' reads (their writes are done
  // when the grid is)
  if (!DIRECT && tid == 0) bulk_wait_read();
}

}  // namespace

// y: (rows, 308) float32 row-major, 4-byte aligned; t, qc, qi: (rows, 60)
// float32 with unit column stride; consts: (2, 308) rows mask and
// 1 / out_scale; out: (rows, 368) float32, 16-byte aligned.  `geo`
// (ops/kernels.py plan_constraint_head, HeadPlan.args): rows; the row
// strides ld_t, ld_qc, ld_qi in floats; tile_rows rows a tile, `stages` y
// tiles in flight, `grid` CTAs of `threads` threads, `smem` bytes of
// dynamic shared memory; `direct`: ordinary loads and stores, no shared
// memory, as for a y that is not 16-byte aligned; `tiles` tiles.
extern "C" int cst_fused_constraint_head(const float* y, const float* t,
                                         const float* qc, const float* qi,
                                         const float* consts, float* out,
                                         const long long* geo, float dt,
                                         void* stream) {
  const long long rows = geo[0], ld_t = geo[1], ld_qc = geo[2],
                  ld_qi = geo[3], tile_rows = geo[4], stages = geo[5],
                  grid = geo[6], threads = geo[7], smem = geo[8],
                  tiles = geo[10];
  const bool direct = geo[9] != 0;
  const long long need =
      direct ? 0 : stages * tile_rows * kIn * 4 + 2 * tile_rows * kOut * 4 +
                       8 * stages;
  if (rows < 1 || rows > 0x7fffffffLL || tile_rows < 1 ||
      tile_rows > kMaxRows || stages < 2 || stages > kMaxStages || grid < 1 ||
      grid > 0x7fffffffLL || threads < kColThreads + tile_rows * kLev ||
      threads % 32 || threads > kMaxThreads || smem < need ||
      smem > 0x7fffffffLL || ld_t < kLev || ld_qc < kLev || ld_qi < kLev ||
      tiles != (rows + tile_rows - 1) / tile_rows ||
      reinterpret_cast<uintptr_t>(y) % 4 ||
      reinterpret_cast<uintptr_t>(out) % 16) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 g(static_cast<unsigned>(grid)), b(static_cast<unsigned>(threads));
  if (direct || reinterpret_cast<uintptr_t>(y) % 16) {
    constraint_head_kernel<true><<<g, b, 0, st>>>(
        y, t, qc, qi, ld_t, ld_qc, ld_qi, consts, out, static_cast<int>(rows),
        dt, static_cast<int>(tile_rows), static_cast<int>(tiles),
        static_cast<int>(stages));
  } else {
    static bool opted[cst::kMaxDevices] = {};
    static std::mutex mu;
    const int e = cst::opt_in_shared_memory(constraint_head_kernel<false>,
                                            opted, mu);
    if (e != 0) return e;
    constraint_head_kernel<false><<<g, b, static_cast<size_t>(smem), st>>>(
        y, t, qc, qi, ld_t, ld_qc, ld_qi, consts, out, static_cast<int>(rows),
        dt, static_cast<int>(tile_rows), static_cast<int>(tiles),
        static_cast<int>(stages));
  }
  return static_cast<int>(cudaGetLastError());
}
