// fused_gn_silu_conv3: the U-Net half-block GroupNorm -> silu -> conv3.
//
// Replaces climsim_tpu/ops/unet_fused.py fused_gn_silu_conv3 / _kernel (the
// pl.pallas_call at unet_fused.py:111).  Per sample, x (L, C) float32:
//   mean_g, var_g  over L x C/G, two passes (mean first, then the centred
//                  squares: E[x^2] - mean^2 cancels when |mean| >> std)
//   h = silu(((x - mean_g) * rsqrt(var_g + eps)) * gamma + beta) -> bf16
//   y[l] = sum_k h[l + k - 1] @ w[k] + b      (SAME conv, k = 3, zeros at the
//                                              sample's own edges)
// with bf16 x bf16 products summed in float32 and the float32 bias added
// last.  The affine step and silu keep the plain version's roundings
// (separate multiply and add; x / (1 + exp(-x)), as PyTorch's silu).
//
// Bound on the H100 SXM (3.35 TB/s, 989 TFLOP/s bf16 dense): by bytes.  At
// B = 384 the 82 chains of a unet_v5 forward move ~1.6 GB of float32
// activations (x in, y out: 0.477 ms) against ~0.28 ms of bf16 products.
// The first version (one block per sample and 128 output channels, WMMA
// tiles, a __syncthreads a weight chunk) took 9.1 ms there, ~5% of the
// bound: each block streamed a whole weight slice from L2 for only L
// output rows (12.6 GB of weight reads a forward), read x three times with
// few loads in flight, and ran warp-level products with the block stalled
// on every chunk.  This design (PERF.md has its times, shape by shape):
//
//  * Row tiles of whole samples.  A block of two warpgroups owns S whole
//    samples (S L <= 64 ROWS / 64; ROWS = 64 or 128) and 64 NT output
//    channels: with ROWS = 128 each warpgroup takes 64 rows, with 64 the
//    two split the NT boxes.  The weight slice is read once for all S
//    samples.  The host's tile plan (ops/unet_fused.py
//    plan_gn_silu_conv3) picks ROWS, NT, S and the stage count from the
//    shape, the batch and the card: where the grid would leave SMs idle,
//    fewer samples a tile.
//  * Statistics once per sample and group per block: a float32 partial
//    sum per (row, group), then a double sum over the rows in order; mean
//    first, then the centred squares, from x the first pass left in
//    registers (up to 16 float4s a thread; the rest from L2).  Then the
//    normalized, silu'd bf16 slab in shared memory, x read once more:
//    every sample's rows with their own zero halo row above and below, row
//    pitch 2C + 16 bytes so that the eight rows an ldmatrix phase reads
//    fall in eight different 16-byte bank groups.
//  * Weights by TMA: 64-row x 64-column boxes of the (3C, Cout) matrix as
//    it lies in memory (128-byte swizzle) into a ring of 2 or 3
//    mbarrier-guarded stages.  Thread 0 issues the first stages before the
//    statistics (the weights do not depend on x) and refills a slot once
//    every warp has released it; there is no producer warp, so that two
//    blocks fit an SM (256 threads, at most 128 registers each) and one
//    block's statistics and slab overlap another's products.
//  * Products by wgmma.mma_async m64n64k16, bf16 x bf16 -> float32: A from
//    registers (ldmatrix of the slab rows each tap shifts to: output row l
//    of sample s reads slab row s (L + 2) + l + k, so halos and sample
//    edges cost nothing), B from shared memory, MN-major (N is contiguous
//    in flax's layout).  One stage's products stay in flight while the
//    next stage's A fragments load and its own wait for their weights.
//  * One fixed K order: the rows of (3C, Cout) ascending (tap 0, 1, 2; C
//    ascending within a tap) in 16-row steps, each output channel in a
//    64-wide instruction of its own.  It depends on (L, C, Cout) only,
//    never on B or on the plan, so a sample's output has the same bits in
//    any batch and any tile (the server pads a 50-row request to 384).
//  * Epilogue: float32 accumulators + the float32 bias, float2 stores of
//    the valid rows straight from the registers.
#include "common.cuh"
#include "hopper.cuh"

namespace {

using namespace cst;  // the Hopper helpers of hopper.cuh

constexpr int kBoxRows = 64;    // weight rows (K) a stage
constexpr int kBoxCols = 64;    // output channels a box: 128 bytes, one swizzle row
constexpr int kBoxBytes = kBoxRows * kBoxCols * 2;
constexpr int kPadBytes = 16;   // slab row padding
constexpr int kMaxStages = 8;

constexpr int kThreads = 256;   // two warpgroups
constexpr int kBatch = 8;       // rows a slab thread has in flight
// x a thread keeps in registers from the first statistics pass to the
// second: its first kCacheRows rows' first kCacheQ4 float4s
constexpr int kCacheRows = 8;
constexpr int kCacheQ4 = 2;

struct Layout {
  size_t slab, stats, rows, bars, total;
};

// Dynamic shared memory, from a 1024-byte aligned base: the weight ring |
// the slab, and before it in the same bytes a partial sum per (row,
// group) | mean and rstd per (sample, group) | each tile row's sample | a
// full and an empty barrier a stage.  ops/unet_fused.py _smem_bytes
// mirrors `total`.
__host__ __device__ inline Layout smem_layout(int S, int L, int C, int G,
                                              int NT, int stages) {
  Layout o;
  o.slab = static_cast<size_t>(stages) * NT * kBoxBytes;
  o.stats = o.slab + static_cast<size_t>(S) * (L + 2) * (2 * C + kPadBytes);
  o.rows = o.stats + 8 * static_cast<size_t>(S) * G;
  o.bars = o.rows + 128;
  o.total = o.bars + 16 * static_cast<size_t>(stages) + 1024;
  return o;
}

// The A fragments of one weight stage (four 16-deep steps) for this
// thread's row: `row_addr` is the shared address of its slab row at tap 0,
// channel 8 * (lane / 16).
__device__ __forceinline__ void load_a(uint32_t (&a)[4][4], uint32_t row_addr,
                                       int q, int C, int pitch) {
  const int r0 = q * kBoxRows;
  const int tap = r0 / C;
  const uint32_t addr = row_addr + tap * pitch + (r0 - tap * C) * 2;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) ldmatrix_x4(a[kk], addr + kk * 32);
}

// The weight ring: `stages` slots of NT 64 x 64 boxes of the (3C, Cout)
// matrix, a full and an empty barrier a slot.
struct Ring {
  const CUtensorMap* map;
  unsigned char* base;
  uint64_t* full;
  uint64_t* empty;
  int stages, nt, n0;
};

// Weight stage q (rows 64q.. of the (3C, Cout) matrix, the block's
// columns) into its slot, by TMA; one thread issues it.
__device__ __forceinline__ void load_stage(const Ring& w, int q) {
  const int s = q % w.stages;
  mbar_expect_tx(w.full + s, w.nt * kBoxBytes);
  for (int j = 0; j < w.nt; ++j)
    tma_load_2d(w.base + (s * w.nt + j) * kBoxBytes, w.map, w.full + s,
                w.n0 + j * kBoxCols, q * kBoxRows);
}

// One stage: wait for its weights, issue this warpgroup's 4 x NB products
// on `a`; once the previous stage's products are done (one group stays in
// flight), release its slot -- thread 0 refills it with the stage `stages`
// on, once every warp has -- and load the next stage's fragments into
// `next`, which its products read.  `ring` is the address of this
// warpgroup's first box in slot 0; slots lie `stage_bytes` apart.
template <int NB>
__device__ __forceinline__ void run_stage(
    float (&acc)[NB][32], uint32_t (&a)[4][4], uint32_t (&next)[4][4], int q,
    int nq, const Ring& w, uint32_t ring, int stage_bytes, uint32_t row_addr,
    int C, int pitch, int lane) {
  const int stages = w.stages;
  const int s = q % stages;
  mbar_wait(w.full + s, (q / stages) & 1);
#pragma unroll
  for (int j = 0; j < NB; ++j)
#pragma unroll
    for (int i = 0; i < 32; ++i) fence_reg(acc[j][i]);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int j = 0; j < NB; ++j)
      wgmma_m64n64k16(acc[j], a[kk],
                      b_desc(ring + s * stage_bytes + j * kBoxBytes +
                             kk * 2048));
  wgmma_commit();
  wgmma_wait_one();  // stage q - 1 is done: its weights and fragments free
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) fence_reg(next[kk][i]);
  if (q > 0) {
    const int p = q - 1;  // the stage whose slot is free here
    if (lane == 0) mbar_arrive(w.empty + p % stages);
    if (threadIdx.x == 0 && p + stages < nq) {
      mbar_wait(w.empty + p % stages, (p / stages) & 1);
      load_stage(w, p + stages);
    }
  }
  if (q + 1 < nq) load_a(next, row_addr, q + 1, C, pitch);
}

// A block: two warpgroups; thread 0 also issues the weight copies.  ROWS =
// 128: each
// warpgroup owns 64 of the tile's rows and all NT boxes; ROWS = 64: both
// own the 64 rows and split the boxes (with one box, the second only
// helps with the statistics and the slab).
// Two blocks an SM (128 registers a thread), so that one block's
// statistics and slab overlap another's products.
template <int ROWS, int NT>
__global__ void __launch_bounds__(kThreads, 2)
    gn_silu_conv3_kernel(const __grid_constant__ CUtensorMap wmap,
                         const float* __restrict__ x,
                         const float* __restrict__ gamma,
                         const float* __restrict__ beta,
                         const float* __restrict__ bias,
                         float* __restrict__ out, int batch, int L, int C,
                         int Cout, int G, float eps, int S, int stages,
                         int tiles_n) {
  constexpr int kConsumers = 256;
  constexpr int kWgBoxes = ROWS == 128 ? NT : (NT + 1) / 2;
  constexpr int kMmaWarps = ROWS == 64 && NT == 1 ? 4 : 8;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const Layout lay = smem_layout(S, L, C, G, NT, stages);
  __nv_bfloat16* slab = reinterpret_cast<__nv_bfloat16*>(smem + lay.slab);
  float* part = reinterpret_cast<float*>(smem + lay.slab);  // then the slab
  float* stats = reinterpret_cast<float*>(smem + lay.stats);
  unsigned char* row_sample = smem + lay.rows;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + lay.bars);
  uint64_t* empty = full + stages;

  const int tile = blockIdx.x / tiles_n;
  const int n0 = (blockIdx.x - tile * tiles_n) * kBoxCols * NT;
  const long long s0 = static_cast<long long>(tile) * S;  // first sample
  const int sv = static_cast<int>(min(static_cast<long long>(S), batch - s0));
  const int nq = 3 * C / kBoxRows;  // weight stages of the K loop
  const float* xs = x + static_cast<size_t>(s0) * L * C;

  if (threadIdx.x == 0) {
    prefetch_tensormap(&wmap);
    for (int s = 0; s < stages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, kMmaWarps);  // one arrival a consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // the weights do not depend on x: the first stages are in flight before
  // the statistics start
  const Ring w{&wmap, smem, full, empty, stages, NT, n0};
  if (threadIdx.x == 0) {
    for (int q = 0; q < stages && q < nq; ++q) load_stage(w, q);
  }

  const int t = threadIdx.x;
  const int warp = t >> 5;
  const int lane = t & 31;
  const int ld = C + kPadBytes / 2;  // slab row pitch in elements
  const int R = sv * L;              // valid rows of the tile
  const int W = C / 4;               // float4s a row
  const int cpg = C / G;
  const int q4 = cpg / 4;            // float4s a group has on one row
  const int gshift = 31 - __clz(G);  // G is 16 or 32
  for (int r = t; r < R; r += kConsumers) row_sample[r] = r / L;
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");

  // 1. group statistics, two passes over x: thread t takes group g =
  // t % G of rows t / G, t / G + rstep, ...; the first kCacheRows of them
  // (their first kCacheQ4 float4s) stay in registers for the second pass,
  // the rest is read again.  A float32 partial sum per (row, group), then
  // a double sum per (sample, group) over the rows in order: neither
  // order depends on B or on the plan.
  const int g = t & (G - 1);
  const int rstep = kConsumers >> gshift;
  const int rt = t >> gshift;
  const float4* xg = reinterpret_cast<const float4*>(xs + g * cpg);
  float4 xc[kCacheRows][kCacheQ4];
  auto add = [](float sum, float4 v, bool centred, float m) {
    if (!centred) return sum + ((v.x + v.y) + (v.z + v.w));
    const float a = v.x - m, b = v.y - m, c = v.z - m, d = v.w - m;
    return sum + ((a * a + b * b) + (c * c + d * d));
  };
  auto row_group_sums = [&](bool centred) {
#pragma unroll
    for (int k = 0; k < kCacheRows; ++k) {
      const int r = rt + k * rstep;
      if (r < R) {
        const float4* p = xg + static_cast<size_t>(r) * W;
        const float m = centred ? stats[2 * (row_sample[r] * G + g)] : 0.0f;
        float sum = 0.0f;
#pragma unroll
        for (int j = 0; j < kCacheQ4; ++j) {
          if (j < q4) {
            if (!centred) xc[k][j] = __ldg(p + j);
            sum = add(sum, xc[k][j], centred, m);
          }
        }
        for (int j = kCacheQ4; j < q4; ++j)
          sum = add(sum, __ldg(p + j), centred, m);
        part[r * G + g] = sum;
      }
    }
    for (int r = rt + kCacheRows * rstep; r < R; r += rstep) {
      const float4* p = xg + static_cast<size_t>(r) * W;
      const float m = centred ? stats[2 * (row_sample[r] * G + g)] : 0.0f;
      float sum = 0.0f;
      for (int j = 0; j < q4; ++j) sum = add(sum, __ldg(p + j), centred, m);
      part[r * G + g] = sum;
    }
  };
  auto sample_sums = [&](int slot) {
    for (int it = t; it < sv * G; it += kConsumers) {
      const float* ps = part + (it >> gshift) * L * G + (it & (G - 1));
      double acc = 0.0;
#pragma unroll 8
      for (int l = 0; l < L; ++l) acc += ps[l * G];
      const float v = static_cast<float>(acc / (L * cpg));
      stats[2 * it + slot] = slot ? rsqrtf(fmaxf(v, 0.0f) + eps) : v;
    }
  };
  row_group_sums(false);
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
  sample_sums(0);
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
  row_group_sums(true);
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
  sample_sums(1);
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");

  // 2. the normalized, silu'd bf16 slab: sample s, level l at slab row
  // s (L + 2) + l + 1 (tile row r = s L + l at r + 2s + 1); rows s (L + 2)
  // and s (L + 2) + L + 1 are zero.  Thread t takes float4 column t % lanes
  // of every (kConsumers / lanes)-th row, kBatch rows in flight.
  const int lanes = min(W, kConsumers);
  const int rows_at_once = kConsumers / lanes;
  const int tr = t / lanes;
  if (tr < rows_at_once) {
    for (int c4 = t - tr * lanes; c4 < W; c4 += lanes) {
      const int c = 4 * c4;
      const int gc = c / cpg;  // a float4 never straddles groups
      float gw[4], bw[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        gw[j] = __ldg(gamma + c + j);
        bw[j] = __ldg(beta + c + j);
      }
      for (int r0 = tr; r0 < R; r0 += kBatch * rows_at_once) {
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          const int r = r0 + u * rows_at_once;
          if (r < R) {
            const int s = row_sample[r];
            const float mean = stats[2 * (s * G + gc)];
            const float rstd = stats[2 * (s * G + gc) + 1];
            const float4 v4 = __ldg(reinterpret_cast<const float4*>(xs) +
                                    static_cast<size_t>(r) * W + c4);
            const float in[4] = {v4.x, v4.y, v4.z, v4.w};
            __nv_bfloat16 h[4];
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              float v = __fmul_rn(in[j] - mean, rstd);
              v = __fadd_rn(__fmul_rn(v, gw[j]), bw[j]);
              h[j] = __float2bfloat16_rn(v / (1.0f + expf(-v)));
            }
            __nv_bfloat162* dst = reinterpret_cast<__nv_bfloat162*>(
                slab + (r + 2 * s + 1) * ld + c);
            dst[0] = __halves2bfloat162(h[0], h[1]);
            dst[1] = __halves2bfloat162(h[2], h[3]);
          }
        }
      }
    }
  }
  const int per_row = C / 8;  // 16-byte words of a row
  for (int i = t; i < 2 * sv * per_row; i += kConsumers) {
    const int h = i / per_row;
    const int row = (h >> 1) * (L + 2) + (h & 1) * (L + 1);
    reinterpret_cast<uint4*>(slab + row * ld)[i - h * per_row] =
        make_uint4(0, 0, 0, 0);
  }
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");

  // 3. the three shifted products: this thread's A row is row r of the
  // tile (rows past the valid samples read row 0 and are never stored)
  const int wg = warp >> 2;
  if (wg * 4 >= kMmaWarps) return;  // ROWS = 64 with one box: no products
  const int row0 = ROWS == 128 ? 64 * wg : 0;  // the warpgroup's first row
  const int box0 = ROWS == 128 ? 0 : wg * kWgBoxes;
  const int r = row0 + 16 * (warp & 3) + (lane & 15);
  const int base = r < R ? r + 2 * (r / L) : 0;  // slab row at tap 0
  const int pitch = ld * 2;
  const uint32_t row_addr = smem_u32(slab) + base * pitch + (lane >> 4) * 16;
  const uint32_t ring = smem_u32(smem) + box0 * kBoxBytes;

  float acc[kWgBoxes][32];
#pragma unroll
  for (int j = 0; j < kWgBoxes; ++j)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[j][i] = 0.0f;
  uint32_t a0[4][4], a1[4][4];
  load_a(a0, row_addr, 0, C, pitch);
  for (int q = 0; q < nq; q += 2) {
    run_stage<kWgBoxes>(acc, a0, a1, q, nq, w, ring, NT * kBoxBytes,
                        row_addr, C, pitch, lane);
    if (q + 1 < nq)
      run_stage<kWgBoxes>(acc, a1, a0, q + 1, nq, w, ring, NT * kBoxBytes,
                          row_addr, C, pitch, lane);
  }
  wgmma_wait_all();
#pragma unroll
  for (int j = 0; j < kWgBoxes; ++j)
#pragma unroll
    for (int i = 0; i < 32; ++i) fence_reg(acc[j][i]);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      fence_reg(a0[kk][i]);
      fence_reg(a1[kk][i]);
    }

  // 4. + bias, the valid rows out: register 4b + 2h + e of a 64-column
  // box holds row lane / 4 + 8h of the warp, column 8b + 2 (lane % 4) + e
  float* os = out + static_cast<size_t>(s0) * L * Cout;
#pragma unroll
  for (int j = 0; j < kWgBoxes; ++j) {
#pragma unroll
    for (int b = 0; b < 8; ++b) {
      const int col = n0 + (box0 + j) * kBoxCols + 8 * b + 2 * (lane & 3);
      if (col >= Cout) continue;
      const float b0 = __ldg(bias + col), b1 = __ldg(bias + col + 1);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = row0 + 16 * (warp & 3) + (lane >> 2) + 8 * h;
        if (row < R) {
          *reinterpret_cast<float2*>(os + static_cast<size_t>(row) * Cout +
                                     col) =
              make_float2(acc[j][4 * b + 2 * h] + b0,
                          acc[j][4 * b + 2 * h + 1] + b1);
        }
      }
    }
  }
}

template <int ROWS, int NT>
int launch(const CUtensorMap& map, const float* x, const float* gamma,
           const float* beta, const float* bias, float* out, int batch,
           int L, int C, int Cout, int G, float eps, int S, int stages,
           int tiles_n, unsigned grid, size_t smem, cudaStream_t stream) {
  static bool opted[cst::kMaxDevices] = {};
  static std::mutex mu;
  const int e =
      cst::opt_in_shared_memory(gn_silu_conv3_kernel<ROWS, NT>, opted, mu);
  if (e != 0) return e;
  gn_silu_conv3_kernel<ROWS, NT><<<grid, kThreads, smem, stream>>>(
      map, x, gamma, beta, bias, out, batch, L, C, Cout, G, eps, S, stages,
      tiles_n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x: (batch, L, C) float32, 16-byte aligned; gamma, beta: (C,) float32; w:
// (3, C, Cout) bf16, 16-byte aligned; bias: (Cout,) float32; out: (batch,
// L, Cout) float32.  The tile plan (ops/unet_fused.py plan_gn_silu_conv3):
// row tiles of 64 nwg rows holding S whole samples, nt 64-column boxes a
// block, `stages` weight stages.  Needs C % 64 == 0, Cout % 16 == 0, G 16
// or 32 dividing C with C / G % 4 == 0, S L <= 64 nwg, and the plan's
// shared memory within the card's limit (the plan checks them all).
extern "C" int cst_fused_gn_silu_conv3(const float* x, const float* gamma,
                                       const float* beta, const void* w,
                                       const float* bias, float* out,
                                       int batch, int L, int C, int Cout,
                                       int G, float eps, int nwg, int nt,
                                       int stages, int S, void* stream) {
  if (nwg < 1 || nwg > 2 || (nt != 1 && nt != 2 && nt != 4) ||
      (nwg == 2 && nt == 4) || stages < 2 ||
      stages > kMaxStages || L < 1 || L > 64 * nwg || C < 64 ||
      C % kBoxRows || Cout < 16 || Cout % 16 || (G != 16 && G != 32) ||
      C % G || (C / G) % 4 || batch < 1 || S < 1 || S > batch ||
      S * L > 64 * nwg) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long tiles_m = (static_cast<long long>(batch) + S - 1) / S;
  const int tiles_n = (Cout + kBoxCols * nt - 1) / (kBoxCols * nt);
  if (tiles_m * tiles_n > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_layout(S, L, C, G, nt, stages).total;

  if (encode_tiled() == nullptr)
    return static_cast<int>(cudaErrorNotSupported);
  CUtensorMap map;
  if (!encode_2d(&map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, w,
                 static_cast<uint64_t>(3) * C, Cout, kBoxRows, kBoxCols,
                 CU_TENSOR_MAP_SWIZZLE_128B)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const unsigned grid = static_cast<unsigned>(tiles_m * tiles_n);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define CST_LAUNCH(NWG, NT)                                                \
  if (nwg == NWG && nt == NT)                                              \
    return launch<64 * NWG, NT>(map, x, gamma, beta, bias, out, batch, L, C, \
                                Cout, G, eps, S, stages, tiles_n, grid, smem, \
                                st);
  CST_LAUNCH(1, 1)
  CST_LAUNCH(1, 2)
  CST_LAUNCH(1, 4)
  CST_LAUNCH(2, 1)
  CST_LAUNCH(2, 2)
#undef CST_LAUNCH
  return static_cast<int>(cudaErrorInvalidValue);
}
