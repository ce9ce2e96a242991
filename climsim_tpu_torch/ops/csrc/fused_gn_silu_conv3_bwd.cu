// fused_gn_silu_conv3_bwd: the backward of the U-Net half-block GroupNorm ->
// silu -> conv3 (fused_gn_silu_conv3.cu) under its custom VJP.
//
// Replaces the backward of climsim_tpu/ops/unet_fused.py
// make_trainable_fused_block (`bwd`, :194: jax.vjp of xla_gn_silu_conv3
// with flax's bf16 conv output, f32_accum=False).  Per sample, x (L, C)
// float32, the cotangent g (L, Cout) float32, w (3, C, Cout) bf16, G groups:
//   mean_g, rstd_g  two passes, as kernel 5 takes them (the same bits)
//   x^ = (x - mean) rstd, a = x^ gamma + beta, xn = bf16(silu(a))
//   gb = bf16(g)                                (the conv output's rounding)
//   dxn[l] = bf16(sum_k gb[l + 1 - k] w[k]^T)   (zeros past the sample)
//   da = dxn s(a) (1 + a (1 - s(a))),  t = da gamma
//   dx = rstd (t - mean_g(t) - x^ mean_g(t x^))
//   dgamma = sum da x^, dbeta = sum da, db = sum g (unrounded)
//   dw[k] = bf16(sum_l xn[l + k - 1]^T gb[l]), returned as float32
// bf16 x bf16 products summed in float32 on the tensor cores; the plain
// version is ops/unet_fused.py fused_gn_silu_conv3_bwd_plain.
//
// Bound on the H100 SXM (3.35 TB/s, 989 TFLOP/s bf16 dense): the two
// limits are close.  The 82 chains of a unet_v5 step at B = 1024 must
// move 6.58 GB (x and g read, dx written, w read and dw written once:
// 1.97 ms) and do 1.46 TFLOP of bf16 products (dgrad and wgrad: 1.48 ms).
// The path this replaces recomputed the plain chain and ran autograd of
// it: float32 k = 3 convolutions, which cuDNN took as FFTs, ~750x off.
// So the design keeps the normalized activations, the rounded cotangent
// and dxn on the chip where it can, and runs both products by wgmma:
//
//  * Pass 1, dgrad and the GroupNorm backward (gn_bwd_dgrad_kernel): a
//    block of two warpgroups owns S whole samples (S L <= 64 rows) and
//    every channel, so the group sums of the GroupNorm backward stay in
//    the block, as kernel 5's statistics do.  The statistics are kernel
//    5's (gn_stats.cuh), with its bits.  gb goes into a shared slab with a
//    zero halo row above and below each sample (pitch 2 Cout + 16 bytes);
//    dxn is kernel 5's forward mirrored: A from registers (ldmatrix of the
//    slab row each tap shifts to, taps flipped: output row l reads
//    gb[l + 1 - k]), B the weight as TMA lays it down, (64 channels x 64
//    Cout) boxes read K-major (the transpose bit clear), through a ring of
//    mbarrier-guarded stages that thread 0 refills.  The warpgroups take `nb` 64-channel boxes
//    each at a time; each pass's sums are rounded to bf16 into dxn in
//    shared memory, never device memory.  Then, from dxn and x (read
//    again from L2): per (row, group) the sums of t and t x^, per (sample,
//    group) their means, per channel dx and the row tile's column sums of
//    da and da x^, and of g.  These passes over x are latency-bound, so
//    where the plan's shared memory allows (one box a warpgroup, two
//    stages) two blocks share an SM at 128 registers a thread and one
//    block's passes overlap the other's products: on an H100 that took
//    this pass of the 82 chains at B = 1024 from 17.2 to 12.5 ms
//    (bench_gn_conv3 --backward --sweep, torch.profiler).
//  * Pass 1 also writes xn and gb (bf16) to scratch in device memory as B
//    (L + 2) padded rows, a zero row past each edge of a sample.  Pass 2,
//    wgrad (gn_bwd_wgrad_kernel), is then a plain TMA-fed GEMM: a block of
//    three warpgroups, one a tap, and a producer warp owns 64 channels x
//    64 nbb columns of dw; each stage brings 64 padded rows of gb and, for
//    tap k, the 64 rows of xn k - 1 on (the box's start shifts the rows;
//    the halo rows make every cross-sample product zero); m64nNk16 wgmma
//    with both operands MN-major from shared memory.  The rows are split
//    over blocks; split z writes its float32 partial.
//  * Pass 3 (reduce_kernel) adds the wgrad partials in split order and
//    rounds dw to bf16, and adds the row tiles' dgamma, dbeta and db
//    partials in tile order: no atomics, so two runs give the same bits.
// The scratch costs bytes the bound does not count (xn and gb written and
// read once more, the partials); the bound stays the one above.
#include "common.cuh"
#include "gn_stats.cuh"
#include "hopper.cuh"

namespace {

using namespace cst;  // the Hopper helpers of hopper.cuh

constexpr int kBox = 64;                    // rows and columns of a TMA box
constexpr int kBoxBytes = kBox * kBox * 2;  // a bf16 box: 8 KB
constexpr int kPadBytes = 16;               // slab row padding
constexpr int kMaxStages = 8;
constexpr int kThreads = 256;               // dgrad: two warpgroups
constexpr int kWgradThreads = 3 * 128 + 32;  // wgrad: a warpgroup a tap + 1
static_assert(kThreads == kStatsThreads, "the statistics' block");

__device__ __forceinline__ void sync_all() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kThreads) : "memory");
}

struct Layout {
  size_t slab, dxn, stats, rows, bars, total;
};

// Dynamic shared memory of pass 1, from a 1024-byte aligned base: the
// weight ring (after the products: the GroupNorm backward's sums a (row,
// group)) | the gb slab | dxn, bf16, pitch 2C + 16 bytes (before the
// products: the statistics' sums a (row, group)) | mean, rstd, mean_g(t),
// mean_g(t x^) a (sample, group) | each row's sample | a full and an empty
// barrier a stage.  ops/unet_fused.py _bwd_smem mirrors `total`.
__host__ __device__ inline Layout dgrad_layout(int S, int L, int C, int Cout,
                                               int G, int boxes, int stages) {
  Layout o;
  o.slab = static_cast<size_t>(stages) * boxes * kBoxBytes;
  o.dxn = o.slab + static_cast<size_t>(S) * (L + 2) * (2 * Cout + kPadBytes);
  o.stats = o.dxn + static_cast<size_t>(S) * L * (2 * C + kPadBytes);
  o.rows = o.stats + 16 * static_cast<size_t>(S) * G;
  o.bars = o.rows + 64;
  o.total = o.bars + 16 * static_cast<size_t>(stages) + 1024;
  return o;
}

// ops/unet_fused.py _wgrad_smem mirrors it
__host__ __device__ inline size_t wgrad_smem(int nbb, int stages) {
  return static_cast<size_t>(stages) * (3 + nbb) * kBoxBytes +
         16 * static_cast<size_t>(stages) + 1024;
}

// The dgrad weight ring: `stages` slots of `boxes` (64 channels x 64 Cout)
// boxes of w viewed as the (3C, Cout) matrix.  Stage q: pass it = q / nq
// over the channel boxes it * boxes .. it * boxes + boxes - 1; within a
// pass tap q % nq / nob and Cout box q % nob (the K order: tap 0, 1, 2,
// Cout ascending within a tap).
struct Ring {
  const CUtensorMap* map;
  unsigned char* base;
  uint64_t* full;
  uint64_t* empty;
  int stages, boxes, nq, nob, C, total;
};

__device__ __forceinline__ void load_w(const Ring& w, int q) {
  const int s = q % w.stages;
  const int it = q / w.nq, qq = q - it * w.nq;
  const int tap = qq / w.nob, ob = qq - tap * w.nob;
  mbar_expect_tx(w.full + s, w.boxes * kBoxBytes);
  for (int j = 0; j < w.boxes; ++j)
    tma_load_2d(w.base + (s * w.boxes + j) * kBoxBytes, w.map, w.full + s,
                ob * kBox, tap * w.C + (it * w.boxes + j) * kBox);
}

// This warp is done with stage p's slot; thread 0 refills it with the stage
// `stages` on once every product warp is.
__device__ __forceinline__ void release(const Ring& w, int p, int lane) {
  if (lane == 0) mbar_arrive(w.empty + p % w.stages);
  if (threadIdx.x == 0 && p + w.stages < w.total) {
    mbar_wait(w.empty + p % w.stages, (p / w.stages) & 1);
    load_w(w, p + w.stages);
  }
}

// The 16-deep k steps of stage q that fall within Cout (Cout % 16 == 0).
__device__ __forceinline__ int k_steps(const Ring& w, int q, int Cout) {
  const int ob = q % w.nq % w.nob;
  return min(4, (Cout - ob * kBox) / 16);
}

// The A fragments of stage q for this thread's row: `row_addr` is the
// slab address of gb[l + 1] (tap 0) at column 8 (lane / 16); tap k reads
// k rows above it.  kFull: Cout % 64 == 0, every stage four k steps (no
// branch around the products, which ptxas would serialize).
template <bool kFull>
__device__ __forceinline__ void load_g(uint32_t (&a)[4][4], const Ring& w,
                                       uint32_t row_addr, int q, int Cout,
                                       int pitch) {
  const int qq = q % w.nq;
  const int tap = qq / w.nob, ob = qq - tap * w.nob;
  const int nk = k_steps(w, q, Cout);
  const uint32_t addr = row_addr - tap * pitch + ob * kBox * 2;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    if (kFull || kk < nk) ldmatrix_x4(a[kk], addr + kk * 32);
}

// One dgrad stage, q of a pass of nq: wait for its weights, issue this
// warpgroup's products on `a`; once the stage before is done (one group
// stays in flight), release its slot and load the pass's next stage's
// fragments into `next`.  `ring` is this warpgroup's first box in slot 0.
template <int NB, bool kFull>
__device__ __forceinline__ void dgrad_stage(
    float (&acc)[NB][32], uint32_t (&a)[4][4], uint32_t (&next)[4][4], int q,
    int qq, const Ring& w, uint32_t ring, uint32_t row_addr, int Cout,
    int pitch, int lane) {
  const int s = q % w.stages;
  const int nk = k_steps(w, q, Cout);
  mbar_wait(w.full + s, (q / w.stages) & 1);
#pragma unroll
  for (int j = 0; j < NB; ++j)
#pragma unroll
    for (int i = 0; i < 32; ++i) fence_reg(acc[j][i]);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    if (kFull || kk < nk) {
#pragma unroll
      for (int j = 0; j < NB; ++j)
        wgmma_m64n64k16_bk(
            acc[j], a[kk],
            sw128_desc(ring + (s * w.boxes + j) * kBoxBytes + kk * 32, 16));
    }
  }
  wgmma_commit();
  wgmma_wait_one();  // stage q - 1 is done: its weights and fragments free
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) fence_reg(next[kk][i]);
  if (qq > 0) release(w, q - 1, lane);
  if (qq + 1 < w.nq) load_g<kFull>(next, w, row_addr, q + 1, Cout, pitch);
}

// s(a) and the silu of a as kernel 5 takes it (a / (1 + exp(-a))), from
// x and its group's statistics.
struct Act {
  float xh, a, e;
};
__device__ __forceinline__ Act act(float x, float mean, float rstd, float gw,
                                   float bw) {
  Act r;
  r.xh = __fmul_rn(x - mean, rstd);
  r.a = __fadd_rn(__fmul_rn(r.xh, gw), bw);
  r.e = expf(-r.a);
  return r;
}
// da from dxn and the activation: dxn s(a) (1 + a (1 - s(a)))
__device__ __forceinline__ float dact(float d, const Act& v) {
  const float sg = 1.0f / (1.0f + v.e);
  return d * (sg * (1.0f + v.a * (1.0f - sg)));
}

// Pass 1: a block of two warpgroups, S whole samples, every channel;
// kMinBlocks = 2 (nb = 1, Cout % 64 == 0 and the plan's shared memory
// small enough: with the branch around the k steps it would spill) keeps
// two blocks an SM, 128 registers a thread, so that one block's passes
// over x overlap another's products.
template <int NB, bool kFull, int kMinBlocks>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    gn_bwd_dgrad_kernel(const __grid_constant__ CUtensorMap wmap,
                        const float* __restrict__ x,
                        const float* __restrict__ gamma,
                        const float* __restrict__ beta,
                        const float* __restrict__ g, float* __restrict__ dx,
                        __nv_bfloat16* __restrict__ xn_pad,
                        __nv_bfloat16* __restrict__ gb_pad,
                        float* __restrict__ part_v, int batch, int L, int C,
                        int Cout, int G, float eps, int S, int stages,
                        int wgs) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const int boxes = wgs * NB;
  const Layout lay = dgrad_layout(S, L, C, Cout, G, boxes, stages);
  __nv_bfloat16* slab = reinterpret_cast<__nv_bfloat16*>(smem + lay.slab);
  __nv_bfloat16* dxn = reinterpret_cast<__nv_bfloat16*>(smem + lay.dxn);
  float* part = reinterpret_cast<float*>(smem + lay.dxn);  // then dxn
  float* tsum = reinterpret_cast<float*>(smem);  // after the products
  float* stats = reinterpret_cast<float*>(smem + lay.stats);
  unsigned char* row_sample = smem + lay.rows;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + lay.bars);
  uint64_t* empty = full + stages;

  const int tile = blockIdx.x;
  const long long s0 = static_cast<long long>(tile) * S;  // first sample
  const int sv = static_cast<int>(min(static_cast<long long>(S), batch - s0));
  const int R = sv * L;  // valid rows of the tile
  const int nob = (Cout + kBox - 1) / kBox;
  const int nq = 3 * nob;
  const int total = C / kBox / boxes * nq;
  const float* xs = x + static_cast<size_t>(s0) * L * C;
  const float* gs = g + static_cast<size_t>(s0) * L * Cout;
  const size_t prow0 = static_cast<size_t>(s0) * (L + 2);  // padded rows

  if (threadIdx.x == 0) {
    prefetch_tensormap(&wmap);
    for (int s = 0; s < stages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, 4 * wgs);  // one arrival a product warp
    }
    fence_barrier_init();
  }
  __syncthreads();
  const Ring w{&wmap, smem, full, empty, stages, boxes, nq, nob, C, total};
  // the weights do not depend on x or g: the first stages are in flight
  // before the statistics start
  if (threadIdx.x == 0) {
    for (int q = 0; q < stages && q < total; ++q) load_w(w, q);
  }

  const int t = threadIdx.x;
  const int warp = t >> 5;
  const int lane = t & 31;
  const int cpg = C / G;
  const int q4 = cpg / 4;  // float4s a group has on one row
  const int gshift = 31 - __clz(G);
  for (int r = t; r < R; r += kThreads) row_sample[r] = r / L;
  sync_all();

  // 1. the group statistics, kernel 5's (gn_stats.cuh): the same bits
  gn_statistics(xs, part, stats, row_sample, R, sv, L, C, G, eps);

  // 2. gb = bf16(g) into the slab (sample s, level l at slab row s (L + 2)
  // + l + 1; rows s (L + 2) and s (L + 2) + L + 1 zero) and into gb_pad,
  // whose padded rows are the slab's, from row prow0 on
  const int lds = Cout + kPadBytes / 2;  // slab pitch in elements
  const int Wg = Cout / 4;
  for (int i = t; i < R * Wg; i += kThreads) {
    const int r = i / Wg;
    const int c4 = i - r * Wg;
    const int row = r + 2 * row_sample[r] + 1;
    const float4 v = __ldg(reinterpret_cast<const float4*>(gs) + i);
    __nv_bfloat162 h[2] = {__floats2bfloat162_rn(v.x, v.y),
                           __floats2bfloat162_rn(v.z, v.w)};
    const uint2 u = *reinterpret_cast<const uint2*>(h);
    *reinterpret_cast<uint2*>(slab + row * lds + 4 * c4) = u;
    *reinterpret_cast<uint2*>(gb_pad + (prow0 + row) * Cout + 4 * c4) = u;
  }
  {
    const int per_row = Cout / 8;  // 16-byte words of a row
    for (int i = t; i < 2 * sv * per_row; i += kThreads) {
      const int hrow = i / per_row;
      const int row = (hrow >> 1) * (L + 2) + (hrow & 1) * (L + 1);
      const int word = i - hrow * per_row;
      reinterpret_cast<uint4*>(slab + row * lds)[word] = make_uint4(0, 0, 0, 0);
      reinterpret_cast<uint4*>(gb_pad + (prow0 + row) * Cout)[word] =
          make_uint4(0, 0, 0, 0);
    }
  }
  sync_all();

  // 3. dxn = bf16(sum_k gb[l + 1 - k] w[k]^T): this thread's A row is row
  // r of the tile (rows past the valid samples read row 0, never stored)
  const int ldd = C + kPadBytes / 2;  // dxn pitch in elements
  const int wg = warp >> 2;
  if (wg < wgs) {
    const int r = 16 * (warp & 3) + (lane & 15);
    const int rr = r < R ? r : 0;
    const int pitch = lds * 2;
    const uint32_t row_addr = smem_u32(slab) +
                              (rr + 2 * (rr / L) + 2) * pitch +
                              (lane >> 4) * 16;
    const uint32_t ring = smem_u32(smem) + wg * NB * kBoxBytes;
    float acc[NB][32];
#pragma unroll
    for (int j = 0; j < NB; ++j)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[j][i] = 0.0f;
    uint32_t a0[4][4], a1[4][4];
    // a pass: the 3 Cout / 64 stages of `boxes` channel boxes, then all
    // products waited for, the last slot released, and the sums rounded
    // into dxn; register 4b + 2h + e of a box holds row 16 (warp % 4) +
    // lane / 4 + 8h, column 8b + 2 (lane % 4) + e
    for (int it = 0; it < total / nq; ++it) {
      const int q0 = it * nq;
      load_g<kFull>(a0, w, row_addr, q0, Cout, pitch);
      for (int qq = 0; qq < nq; qq += 2) {
        dgrad_stage<NB, kFull>(acc, a0, a1, q0 + qq, qq, w, ring, row_addr,
                               Cout, pitch, lane);
        if (qq + 1 < nq)
          dgrad_stage<NB, kFull>(acc, a1, a0, q0 + qq + 1, qq + 1, w, ring,
                                 row_addr, Cout, pitch, lane);
      }
      wgmma_wait_all();
#pragma unroll
      for (int j = 0; j < NB; ++j)
#pragma unroll
        for (int i = 0; i < 32; ++i) fence_reg(acc[j][i]);
      release(w, q0 + nq - 1, lane);
#pragma unroll
      for (int j = 0; j < NB; ++j) {
        const int c0 = (it * boxes + wg * NB + j) * kBox + 2 * (lane & 3);
#pragma unroll
        for (int b = 0; b < 8; ++b) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int row = 16 * (warp & 3) + (lane >> 2) + 8 * h;
            if (row < R) {
              *reinterpret_cast<__nv_bfloat162*>(dxn + row * ldd + c0 +
                                                 8 * b) =
                  __floats2bfloat162_rn(acc[j][4 * b + 2 * h],
                                        acc[j][4 * b + 2 * h + 1]);
            }
          }
        }
#pragma unroll
        for (int i = 0; i < 32; ++i) acc[j][i] = 0.0f;
      }
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        fence_reg(a0[kk][i]);
        fence_reg(a1[kk][i]);
      }
  }
  sync_all();  // dxn is whole; the ring is free

  // 4a. per (row, group), thread t taking group t % G of rows t / G,
  // t / G + rstep, ...: xn to xn_pad, and the sums of t = da gamma and of
  // t x^ over the group's channels, in channel order
  const int gq = t & (G - 1);
  const int rstep = kThreads >> gshift;
  for (int r = t >> gshift; r < R; r += rstep) {
    const int s = row_sample[r];
    const float mean = stats[2 * (s * G + gq)];
    const float rstd = stats[2 * (s * G + gq) + 1];
    const float4* xr =
        reinterpret_cast<const float4*>(xs + static_cast<size_t>(r) * C);
    __nv_bfloat16* xo = xn_pad + (prow0 + r + 2 * s + 1) * C;
    float st = 0.0f, stx = 0.0f;
    for (int j = 0; j < q4; ++j) {
      const int c = gq * cpg + 4 * j;
      const float4 v4 = __ldg(xr + gq * q4 + j);
      const float in[4] = {v4.x, v4.y, v4.z, v4.w};
      const uint2 du = *reinterpret_cast<const uint2*>(dxn + r * ldd + c);
      const __nv_bfloat16* d = reinterpret_cast<const __nv_bfloat16*>(&du);
      __nv_bfloat16 h[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float gw = __ldg(gamma + c + e);
        const Act v = act(in[e], mean, rstd, gw, __ldg(beta + c + e));
        h[e] = __float2bfloat16_rn(v.a / (1.0f + v.e));
        const float tt = dact(__bfloat162float(d[e]), v) * gw;
        st += tt;
        stx += tt * v.xh;
      }
      *reinterpret_cast<uint2*>(xo + c) = *reinterpret_cast<const uint2*>(h);
    }
    tsum[r * G + gq] = st;
    tsum[(R + r) * G + gq] = stx;
  }
  {
    const int per_row = C / 8;
    for (int i = t; i < 2 * sv * per_row; i += kThreads) {
      const int hrow = i / per_row;
      const int row = (hrow >> 1) * (L + 2) + (hrow & 1) * (L + 1);
      reinterpret_cast<uint4*>(xn_pad + (prow0 + row) * C)[i - hrow * per_row] =
          make_uint4(0, 0, 0, 0);
    }
  }
  sync_all();

  // 4b. mean_g(t) and mean_g(t x^) a (sample, group): double sums over the
  // rows in order
  float* tm = stats + 2 * S * G;
  for (int it = t; it < sv * G; it += kThreads) {
    const float* p1 = tsum + (it >> gshift) * L * G + (it & (G - 1));
    const float* p2 = p1 + R * G;
    double s1 = 0.0, s2 = 0.0;
    for (int l = 0; l < L; ++l) {
      s1 += p1[l * G];
      s2 += p2[l * G];
    }
    tm[2 * it] = static_cast<float>(s1 / (L * cpg));
    tm[2 * it + 1] = static_cast<float>(s2 / (L * cpg));
  }
  sync_all();

  // 4c. per channel, the rows in order: dx, and the tile's sums of da x^
  // (dgamma) and da (dbeta)
  float* pv = part_v + static_cast<size_t>(tile) * (2 * C + Cout);
  float* dxs = dx + static_cast<size_t>(s0) * L * C;
  for (int c = t; c < C; c += kThreads) {
    const int gc = c / cpg;
    const float gw = __ldg(gamma + c), bw = __ldg(beta + c);
    float sa = 0.0f, sax = 0.0f;
#pragma unroll 8
    for (int r = 0; r < R; ++r) {
      const int k = row_sample[r] * G + gc;
      const float rstd = stats[2 * k + 1];
      const Act v = act(__ldg(xs + static_cast<size_t>(r) * C + c),
                        stats[2 * k], rstd, gw, bw);
      const float da = dact(__bfloat162float(dxn[r * ldd + c]), v);
      dxs[static_cast<size_t>(r) * C + c] =
          rstd * ((da * gw - tm[2 * k]) - v.xh * tm[2 * k + 1]);
      sa += da;
      sax += da * v.xh;
    }
    pv[c] = sax;
    pv[C + c] = sa;
  }
  // 4d. the tile's sums of g (db), unrounded
  for (int o = t; o < Cout; o += kThreads) {
    float sb = 0.0f;
#pragma unroll 8
    for (int r = 0; r < R; ++r)
      sb += __ldg(gs + static_cast<size_t>(r) * Cout + o);
    pv[2 * C + o] = sb;
  }
}

// Pass 2: dw's partial of split z over chunks [z cps, (z + 1) cps) of 64
// padded rows, for channels c0 .. c0 + 63 and columns o0 .. o0 + 64 NBB - 1.
// Warpgroup k (tap k) sums xn_pad[p + k - 1]^T gb_pad[p] over the rows p;
// warp 12 issues the loads.
template <int NBB>
__global__ void __launch_bounds__(kWgradThreads, 1)
    gn_bwd_wgrad_kernel(const __grid_constant__ CUtensorMap amap,
                        const __grid_constant__ CUtensorMap bmap,
                        float* __restrict__ part_w, int C, int Cout,
                        int chunks, int cps, int stages, int tiles_c,
                        int tiles_o) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  constexpr int kStageBytes = (3 + NBB) * kBoxBytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + stages * kStageBytes);
  uint64_t* empty = full + stages;
  const int per = tiles_c * tiles_o;
  const int z = blockIdx.x / per;
  const int rem = blockIdx.x - z * per;
  const int tc = rem / tiles_o;
  const int c0 = tc * kBox, o0 = (rem - tc * tiles_o) * kBox * NBB;
  const int q0 = z * cps;
  const int n = min(q0 + cps, chunks) - q0;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    prefetch_tensormap(&amap);
    prefetch_tensormap(&bmap);
    for (int s = 0; s < stages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, 12);  // one arrival a consumer warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (warp == 12) {
    if (lane == 0) {
      for (int i = 0; i < n; ++i) {
        const int s = i % stages;
        if (i >= stages) mbar_wait(empty + s, (i / stages - 1) & 1);
        mbar_expect_tx(full + s, kStageBytes);
        const int p0 = (q0 + i) * kBox;
        unsigned char* st = smem + s * kStageBytes;
        for (int k = 0; k < 3; ++k)
          tma_load_2d(st + k * kBoxBytes, &amap, full + s, c0, p0 + k - 1);
        for (int j = 0; j < NBB; ++j)
          tma_load_2d(st + (3 + j) * kBoxBytes, &bmap, full + s,
                      o0 + j * kBox, p0);
      }
    }
    return;
  }

  const int k = warp >> 2;  // the tap
  float acc[32 * NBB];
#pragma unroll
  for (int i = 0; i < 32 * NBB; ++i) acc[i] = 0.0f;
  const uint32_t base = smem_u32(smem);
  for (int i = 0; i < n; ++i) {
    const int s = i % stages;
    mbar_wait(full + s, (i / stages) & 1);
#pragma unroll
    for (int r = 0; r < 32 * NBB; ++r) fence_reg(acc[r]);
    wgmma_fence();
    const uint32_t a0 = base + s * kStageBytes + k * kBoxBytes;
    const uint32_t b0 = base + s * kStageBytes + 3 * kBoxBytes;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_ss<64 * NBB, 1, 1>(acc, sw128_desc(a0 + 2048 * kk, kBoxBytes),
                               sw128_desc(b0 + 2048 * kk, kBoxBytes), 1);
    wgmma_commit();
    wgmma_wait_one();
    if (i > 0 && lane == 0) mbar_arrive(empty + (i - 1) % stages);
  }
  wgmma_wait_all();
#pragma unroll
  for (int r = 0; r < 32 * NBB; ++r) fence_reg(acc[r]);

  // register 4b + 2h + e: channel c0 + 16 (warp % 4) + lane / 4 + 8h,
  // column o0 + 8b + 2 (lane % 4) + e
  float* out = part_w + (static_cast<size_t>(z) * 3 + k) * C * Cout;
#pragma unroll
  for (int b = 0; b < 8 * NBB; ++b) {
    const int col = o0 + 8 * b + 2 * (lane & 3);
    if (col < Cout) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = c0 + 16 * (warp & 3) + (lane >> 2) + 8 * h;
        *reinterpret_cast<float2*>(out + static_cast<size_t>(row) * Cout +
                                   col) =
            make_float2(acc[4 * b + 2 * h], acc[4 * b + 2 * h + 1]);
      }
    }
  }
}

// Pass 3: out[j] = sum over p < n of part[p * stride + j], in a fixed order
// (warp w adds p = w, w + 8, ... ascending; then warp 0 adds the eight in
// order), rounded to bf16 if `round`; out[j] goes to out0 for j < m0, out1
// for j < m0 + m1, else out2.
__global__ void __launch_bounds__(256)
    reduce_kernel(const float* __restrict__ part, int n, long long stride,
                  long long m, float* out0, long long m0, float* out1,
                  long long m1, float* out2, int round) {
  __shared__ float sh[8][32];
  const int lane = threadIdx.x & 31, wp = threadIdx.x >> 5;
  const long long j = static_cast<long long>(blockIdx.x) * 32 + lane;
  float acc = 0.0f;
  if (j < m) {
    for (int p = wp; p < n; p += 8) acc += part[p * stride + j];
  }
  sh[wp][lane] = acc;
  __syncthreads();
  if (wp == 0 && j < m) {
    float v = sh[0][lane];
#pragma unroll
    for (int i = 1; i < 8; ++i) v += sh[i][lane];
    if (round) v = __bfloat162float(__float2bfloat16_rn(v));
    if (j < m0) {
      out0[j] = v;
    } else if (j < m0 + m1) {
      out1[j - m0] = v;
    } else {
      out2[j - m0 - m1] = v;
    }
  }
}

}  // namespace

// x: (batch, L, C) float32; gamma, beta: (C,) float32; w: (3, C, Cout) bf16;
// g: (batch, L, Cout) float32 (x, w, g 16-byte aligned).  Out: dx (batch,
// L, C), dgamma, dbeta (C,), dw (3, C, Cout), db (Cout,), float32.
// Scratch: xn_pad (batch (L + 2), C) and gb_pad (batch (L + 2), Cout) bf16,
// part_w (splits, 3, C, Cout) and part_v (tiles_m, 2C + Cout) float32.
// plan (ops/unet_fused.py GnBwdPlan.args): S, stages, nb, wgs, nbb,
// wstages, cps, splits, blocks (dgrad's an SM).  Three passes on `stream`,
// in order.
extern "C" int cst_fused_gn_silu_conv3_bwd(
    const float* x, const float* gamma, const float* beta, const void* w,
    const float* g, float* dx, float* dgamma, float* dbeta, float* dw,
    float* db, void* xn_pad, void* gb_pad, float* part_w, float* part_v,
    int batch, int L, int C, int Cout, int G, float eps, const int* plan,
    void* stream) {
  const int S = plan[0], stages = plan[1], nb = plan[2], wgs = plan[3];
  const int nbb = plan[4], wstages = plan[5], cps = plan[6],
            splits = plan[7], blocks = plan[8];
  const int nbox = C / kBox;
  const long long rows = static_cast<long long>(batch) * (L + 2);
  const long long chunks = (rows + kBox - 1) / kBox;
  if (L < 1 || L > 64 || C < kBox || C % kBox || Cout < 16 || Cout % 16 ||
      (G != 16 && G != 32) || C % G || (C / G) % 4 || batch < 1 || S < 1 ||
      S > batch || S * L > 64 || stages < 2 || stages > kMaxStages ||
      wstages < 2 || wstages > kMaxStages || (nb != 1 && nb != 2) ||
      wgs != (nbox == 1 ? 1 : 2) || nbox % (wgs * nb) ||
      (nbb != 1 && nbb != 2) || (blocks != 1 && blocks != 2) ||
      (blocks == 2 && (nb != 1 || Cout % kBox)) ||
      cps < 1 || splits < 1 || static_cast<long long>(splits) * cps < chunks ||
      static_cast<long long>(splits - 1) * cps >= chunks ||
      rows > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (encode_tiled() == nullptr)
    return static_cast<int>(cudaErrorNotSupported);
  CUtensorMap wmap, amap, bmap;
  if (!encode_2d(&wmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, w,
                 static_cast<uint64_t>(3) * C, Cout, kBox, kBox,
                 CU_TENSOR_MAP_SWIZZLE_128B) ||
      !encode_2d(&amap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, xn_pad, rows, C,
                 kBox, kBox, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !encode_2d(&bmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, gb_pad, rows,
                 Cout, kBox, kBox, CU_TENSOR_MAP_SWIZZLE_128B)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned tiles_m = static_cast<unsigned>((batch + S - 1) / S);
  const size_t smem = dgrad_layout(S, L, C, Cout, G, wgs * nb, stages).total;
  static bool opted[7][kMaxDevices] = {};
  static std::mutex mu;
  int e = 0;
  auto* xnp = static_cast<__nv_bfloat16*>(xn_pad);
  auto* gbp = static_cast<__nv_bfloat16*>(gb_pad);
#define CST_DGRAD(NB, FULL, MINB, SLOT)                                      \
  if (nb == NB && (Cout % kBox == 0) == FULL && blocks == MINB) {            \
    e = cst::opt_in_shared_memory(gn_bwd_dgrad_kernel<NB, FULL, MINB>,       \
                                  opted[SLOT], mu);                          \
    if (e != 0) return e;                                                    \
    gn_bwd_dgrad_kernel<NB, FULL, MINB><<<tiles_m, kThreads, smem, st>>>(    \
        wmap, x, gamma, beta, g, dx, xnp, gbp, part_v, batch, L, C, Cout, G, \
        eps, S, stages, wgs);                                                \
  }
  CST_DGRAD(1, false, 1, 0)
  CST_DGRAD(1, true, 1, 1)
  CST_DGRAD(1, true, 2, 2)
  CST_DGRAD(2, false, 1, 3)
  CST_DGRAD(2, true, 1, 4)
#undef CST_DGRAD
  e = static_cast<int>(cudaGetLastError());
  if (e != 0) return e;

  const int tiles_c = nbox;
  const int tiles_o = (Cout + kBox * nbb - 1) / (kBox * nbb);
  const unsigned wgrid = static_cast<unsigned>(splits * tiles_c * tiles_o);
  const size_t wsmem = wgrad_smem(nbb, wstages);
  if (nbb == 2) {
    e = cst::opt_in_shared_memory(gn_bwd_wgrad_kernel<2>, opted[5], mu);
    if (e != 0) return e;
    gn_bwd_wgrad_kernel<2><<<wgrid, kWgradThreads, wsmem, st>>>(
        amap, bmap, part_w, C, Cout, static_cast<int>(chunks), cps, wstages,
        tiles_c, tiles_o);
  } else {
    e = cst::opt_in_shared_memory(gn_bwd_wgrad_kernel<1>, opted[6], mu);
    if (e != 0) return e;
    gn_bwd_wgrad_kernel<1><<<wgrid, kWgradThreads, wsmem, st>>>(
        amap, bmap, part_w, C, Cout, static_cast<int>(chunks), cps, wstages,
        tiles_c, tiles_o);
  }
  e = static_cast<int>(cudaGetLastError());
  if (e != 0) return e;

  const long long mw = 3LL * C * Cout;
  reduce_kernel<<<static_cast<unsigned>((mw + 31) / 32), 256, 0, st>>>(
      part_w, splits, mw, mw, dw, mw, nullptr, 0, nullptr, 1);
  e = static_cast<int>(cudaGetLastError());
  if (e != 0) return e;
  const long long mv = 2LL * C + Cout;
  reduce_kernel<<<static_cast<unsigned>((mv + 31) / 32), 256, 0, st>>>(
      part_v, static_cast<int>(tiles_m), mv, mv, dgamma, C, dbeta, C, db, 0);
  return static_cast<int>(cudaGetLastError());
}
