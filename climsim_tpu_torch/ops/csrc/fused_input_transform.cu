// fused_input_transform: raw (B, D) columns -> normalized (B, D), one pass.
//
// Replaces climsim_tpu/ops/kernels.py make_fused_input_transform /
// _transform_kernel (the pl.pallas_call at kernels.py:101).  Per feature j:
//   v = is_cloud[j] ? 1 - exp(-v * lbd[j]) : v     (cloud exponential rate)
//   v = (v - sub[j]) * divinv[j]                     (normalize)
//   v = isfinite(v) ? v : 0                          (nan/inf cleanup)
//   v = v * mask[j]                                  (input pruning)
//   v = min(max(v, lo[j]), hi[j])                    (clip; +/-inf = off)
// in that order, each step rounded on its own (the __f*_rn intrinsics: no
// contraction), as the plain version's separate PyTorch ops round them, so
// the kernel is bit-equal to it.  lbd is a per-feature vector, zero outside
// the cloud lanes, so one kernel covers the v5 state_qn rate and the v4/v2
// state_q0002/state_q0003 rates (the Pallas kernel handled state_qn only).
// Built without --use_fast_math: isfinite is not folded away and expf is
// the accurate one, the same as PyTorch's exp.
//
// Bound on the H100: device-memory bytes.  Every element is read once and
// written once (8 B * D a row, 4.5 KB at D = 557) with about ten flops, and
// the seven (D,) constant rows are read once; so the least time is
// (8 B D + 28 D) bytes over 3.35 TB/s.  The first version ran one thread an
// element, each with a 64-bit i % D and seven 4-byte constant loads, on a
// grid of up to 65,535 blocks.  This design, two paths of one kernel chosen
// by the host's plan (ops/kernels.py plan_input_transform):
//
//  * Constants once, in registers.  A thread owns its columns j (and j +
//    c T, c < COLS, on the pipelined path) of every row it takes, so it
//    reads their seven constants once, and its feature index needs no
//    division or modulo.  Where D is narrow, several row phases of T
//    threads take every other row.
//  * Direct where x fits half the L2 (B <= 11,765 at D = 557 on an H100):
//    the callers hand the kernel rows they have just written, which L2
//    still holds, and there the copy engine's round trips only add latency
//    (bench_io_kernels --sweep: the pipeline won only past the L2).  A CTA
//    takes one tile of rows and one block of its columns (blockIdx.y), one
//    column a thread, so that a small batch spreads over many SMs as one
//    thread an element would; it reads x and writes out by ordinary
//    coalesced accesses, a group of rows' loads issued before their stores.
//  * Pipelined past that, by the copy engine.  A tile is R
//    whole rows, R a multiple of 4, so its R D 4 bytes are a multiple of 16
//    at any D and every tile of a 16-byte aligned x starts 16-byte aligned:
//    thread 0 brings it into shared memory with one 1D bulk copy,
//    completing on an mbarrier, and the result goes back with one bulk
//    store.  The grid is one or two CTAs an SM; CTA i takes tiles i, i +
//    grid, ...  Up to four input tiles are in flight while one is computed
//    (a tile's buffer is refilled as soon as it is consumed), and two
//    output tiles alternate, so a tile's store overlaps the next tile's
//    compute.  A warp reads and writes 32 consecutive floats of shared
//    memory (no bank conflict).
//  * Alignment and ragged tiles.  An x that is 4- but not 16-byte aligned
//    (a view that starts mid-row, x[1:] at D = 557) takes the direct path;
//    on the pipelined path the last tile's bytes past the last multiple of
//    16 (up to 3 floats, where R' D is not a multiple of 4) are read and
//    written by ordinary accesses of their owner threads.
#include "common.cuh"
#include "hopper.cuh"

namespace {

using namespace cst;  // the Hopper helpers of hopper.cuh

enum ConstRow { kSub, kDivInv, kMask, kLo, kHi, kLbd, kIsCloud };
constexpr int kMaxThreads = 512;  // TRANSFORM_THREADS in ops/kernels.py
constexpr int kMaxStages = 4;     // TRANSFORM_STAGES
// rows a thread loads before it stores: a direct tile has few rows a
// thread, and a shorter unrolled body starts sooner
constexpr int kGroupBulk = 4;
constexpr int kGroupDirect = 2;

// A column's seven constants, held as loaded: the cloud flag is compared
// where it is used, so no thread waits on a constant before its x loads
// are in flight.
struct Feature {
  float sub, divinv, mask, lo, hi, lbd, is_cloud;
};

__device__ __forceinline__ float transform(float v, const Feature& f) {
  if (f.is_cloud > 0.5f) v = __fsub_rn(1.0f, expf(__fmul_rn(-v, f.lbd)));
  v = __fmul_rn(__fsub_rn(v, f.sub), f.divinv);
  if (!isfinite(v)) v = 0.0f;
  v = __fmul_rn(v, f.mask);
  return fminf(fmaxf(v, f.lo), f.hi);
}

// COLS columns a thread (up to 3: widths up to 1536); row_threads threads
// a row phase, blockDim.x / row_threads phases.  DIRECT: ordinary loads
// and stores, no shared memory; else tiles by the copy engine (x 16-byte
// aligned).
template <int COLS, bool DIRECT>
__global__ void __launch_bounds__(kMaxThreads, 2)
    transform_kernel(const float* __restrict__ x, const float* __restrict__ c,
                     float* __restrict__ out, int rows, int d, int tile_rows,
                     int n_tiles, int stages, int row_threads, int phases) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int tile_el = tile_rows * d;
  float* in_s = reinterpret_cast<float*>(smem);  // `stages` input tiles
  float* out_s = in_s + stages * tile_el;        // two output tiles
  uint64_t* full = reinterpret_cast<uint64_t*>(out_s + 2 * tile_el);

  // no integer division ahead of the first load: the host gives the tile
  // count and the row phases, and one phase needs no tid / row_threads
  const int tid = threadIdx.x;
  const int r0 = phases == 1 ? 0 : tid / row_threads;
  // this thread's first column: column block blockIdx.y (direct only) of
  // row_threads * COLS columns
  const int j0 = blockIdx.y * row_threads * COLS + tid - r0 * row_threads;
  // whether this CTA has a local tile k (CTA i takes tiles i, i + grid, ...)
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
  // the bytes of local tile k that come by the copy engine
  auto copied = [&](int k) {
    return static_cast<uint32_t>(n_rows(k) * d * 4) & ~15u;
  };
  auto load = [&](int k, int s) {
    const uint32_t bytes = copied(k);
    mbar_expect_tx(full + s, bytes);
    if (bytes) bulk_load(in_s + s * tile_el, x + first_row(k) * d, bytes,
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

  // the constants of this thread's columns, read once, after the first
  // group's x loads are issued (x is the long round trip)
  Feature f[COLS];
  bool have_f = false;

  for (int k = 0, s = 0, parity = 0; has(k); ++k) {
    const int nr = n_rows(k);
    const int n_el = nr * d;
    // elements that came by the copy engine, and that the store takes
    const int in_el = DIRECT ? 0 : static_cast<int>(copied(k) / 4);
    const int out_el = DIRECT ? 0 : (n_el * 4 & ~15) / 4;
    const float* xg = x + first_row(k) * d;
    float* og = out + first_row(k) * d;
    const float* src = in_s + s * tile_el;
    float* dst = out_s + (k & 1) * tile_el;
    if (!DIRECT) mbar_wait(full + s, parity);
    // kGroup rows at a time: every load of the group is issued before the
    // first store, which the compiler could not otherwise move them past
    // (src and dst may be shared or global memory)
    constexpr int kGroup = DIRECT ? kGroupDirect : kGroupBulk;
    for (int r = r0; r < nr; r += kGroup * phases) {
      float v[kGroup][COLS];
#pragma unroll
      for (int g = 0; g < kGroup; ++g) {
#pragma unroll
        for (int q = 0; q < COLS; ++q) {
          const int e = (r + g * phases) * d + j0 + q * row_threads;
          if (r + g * phases < nr && j0 + q * row_threads < d) {
            v[g][q] = e < in_el ? src[e] : xg[e];
          }
        }
      }
      if (!have_f) {
#pragma unroll
        for (int q = 0; q < COLS; ++q) {
          const int j = j0 + q * row_threads;
          if (j < d) {
            f[q] = {__ldg(c + kSub * d + j), __ldg(c + kDivInv * d + j),
                    __ldg(c + kMask * d + j),  __ldg(c + kLo * d + j),
                    __ldg(c + kHi * d + j),    __ldg(c + kLbd * d + j),
                    __ldg(c + kIsCloud * d + j)};
          }
        }
        have_f = true;
      }
#pragma unroll
      for (int g = 0; g < kGroup; ++g) {
#pragma unroll
        for (int q = 0; q < COLS; ++q) {
          const int e = (r + g * phases) * d + j0 + q * row_threads;
          if (r + g * phases < nr && j0 + q * row_threads < d) {
            const float w = transform(v[g][q], f[q]);
            if (e < out_el) {
              dst[e] = w;
            } else {
              og[e] = w;
            }
          }
        }
      }
    }
    if (DIRECT) continue;
    fence_proxy_async_shared();
    // the store of the tile before (the other output buffer) has read it,
    // before any thread passes on to write that buffer
    if (tid == 0) bulk_wait_read();
    __syncthreads();
    if (tid == 0) {
      if (out_el) {
        bulk_store(og, dst, static_cast<uint32_t>(out_el) * 4);
        bulk_commit();
      }
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

// The plan's fields, in ops/kernels.py TransformPlan.args order.
struct Plan {
  int rows, d, tile_rows, stages, grid, threads, row_threads, cols, smem,
      direct, tiles, phases;
};

template <int COLS>
int launch(const float* x, const float* consts, float* out, const Plan& p,
           bool direct, cudaStream_t stream) {
  if (direct) {
    // column blocks: a direct tile may split its rows' columns
    const dim3 grid(p.grid, (p.d + p.row_threads * COLS - 1) /
                                (p.row_threads * COLS));
    transform_kernel<COLS, true><<<grid, p.threads, 0, stream>>>(
        x, consts, out, p.rows, p.d, p.tile_rows, p.tiles, p.stages,
        p.row_threads, p.phases);
  } else {
    static bool opted[kMaxDevices] = {};
    static std::mutex mu;
    const int e =
        opt_in_shared_memory(transform_kernel<COLS, false>, opted, mu);
    if (e != 0) return e;
    transform_kernel<COLS, false><<<p.grid, p.threads, p.smem, stream>>>(
        x, consts, out, p.rows, p.d, p.tile_rows, p.tiles, p.stages,
        p.row_threads, p.phases);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, out: (rows, d) float32 row-major, x 4-byte and out 16-byte aligned;
// consts: (7, d) float32 rows in ConstRow order.  `plan` (ops/kernels.py
// plan_input_transform): rows, d; tile_rows rows a tile (a multiple of 4
// unless direct), `stages` input tiles in flight, `grid` CTAs of `threads`
// threads, `row_threads` of them a row phase with `cols` columns each,
// `smem` bytes of dynamic shared memory; `direct`: ordinary loads and
// stores, no shared memory, as for an x that is not 16-byte aligned, the
// columns in blocks of row_threads * cols; `tiles` tiles, `phases` =
// threads / row_threads row phases.
extern "C" int cst_fused_input_transform(const float* x, const float* consts,
                                         float* out, const int* plan,
                                         void* stream) {
  const Plan p = {plan[0], plan[1], plan[2],  plan[3],  plan[4],  plan[5],
                  plan[6], plan[7], plan[8],  plan[9],  plan[10], plan[11]};
  const long long need =
      p.direct ? 0
               : static_cast<long long>(p.stages + 2) * p.tile_rows * p.d * 4 +
                     8 * p.stages;
  if (p.rows < 1 || p.d < 1 || p.tile_rows < 1 ||
      (!p.direct && p.tile_rows % 4) ||
      p.stages < 2 || p.stages > kMaxStages || p.grid < 1 || p.threads < 32 ||
      p.threads % 32 || p.threads > kMaxThreads || p.row_threads < 1 ||
      p.threads != p.row_threads * p.phases ||
      p.tiles != (p.rows + p.tile_rows - 1) / p.tile_rows ||
      (!p.direct && p.row_threads * p.cols < p.d) || p.smem < need ||
      reinterpret_cast<uintptr_t>(x) % 4 ||
      reinterpret_cast<uintptr_t>(out) % 16) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool direct = p.direct || reinterpret_cast<uintptr_t>(x) % 16 != 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (p.cols) {
    case 1:
      return launch<1>(x, consts, out, p, direct, st);
    case 2:
      return launch<2>(x, consts, out, p, direct, st);
    case 3:
      return launch<3>(x, consts, out, p, direct, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
