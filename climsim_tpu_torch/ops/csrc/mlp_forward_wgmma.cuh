// The tensor-core relu-MLP forward of kernels 2 (bf16 weights, entered
// from fused_mlp_forward.cu) and 3 (int8 weights, fused_mlp_forward_int8.cu).
//
// What it computes is the FMA kernel's (mlp_forward.cuh), with the same
// products (each exact in float32):
//  * kernel 3: y = bf16(h) @ bf16(q) summed in float32, h = y * scale + b
//    with two roundings, relu.  The activations are rounded to bf16 (round
//    to nearest even) when they are published, and an int8 weight widens
//    to bf16 exactly, so a bf16 x bf16 wgmma with float32 sums forms the
//    same products.
//  * kernel 2: h = h_f32 @ w + b, relu.  Each float32 activation is split
//    exactly into three bf16 parts, hi + mid + lo == h (the top, middle and
//    last 8 significant bits: truncations and two float32 subtractions,
//    all exact, no fast-math), and the three bf16 passes into one float32
//    accumulator form hi w + mid w + lo w == h w, float32's product.  A
//    non-finite h goes whole into hi (mid = lo = 0), so inf w and NaN come
//    out as in float32.  Exact for |h| >= 2**-110; below that lo may lose
//    a residue under bf16's subnormal spacing.
// The sums are not the FMA kernel's: they are the tensor cores' float32
// accumulation, in another order, and its rounding has not been shown to
// be IEEE float32's.  Kernel 2 stays within the plain version's tolerance;
// kernel 3's bf16 roundings of the activations flip against the plain
// version more often than the FMA kernel's did (bench_mlp_forward prints
// both kernels' share of outputs outside the tolerance).
//
// Bound on the H100 (989 TFLOP/s bf16 dense, 3.35 TB/s): the 4.1 M
// weights of the 557 -> 1024 x 4 -> 368 network are 8.2 MB (bf16) or 4.1
// MB (int8) from device memory once a call; the products, 3.1 GFLOP at
// B = 384 (x3 for kernel 2), take 3-10 us.  What held the FMA kernel back
// was the weights' traffic from L2 (every 4-row block read all of them:
// ~786 MB at B = 384) and the float32 pipes.  This design:
//
//  * A cluster of `cluster` CTAs (16, or 8 at large B) owns one row tile
//    of 64 nwg rows (one consumer warpgroup a 64 rows).  CTA `rank` owns
//    every layer's output chunks j (64 columns each) with j % cluster ==
//    rank, nb of them at most, so each weight is read from L2 once a row
//    tile, not once every 4 rows.
//  * A layer's output goes to the next layer's CTAs through L2: each CTA
//    stores its chunks in a scratch buffer in global memory, in the order
//    of wgmma's A registers (a thread's four registers of a 16-deep k step
//    in 16 contiguous bytes), as bf16 (kernel 3: rounded) or as three bf16
//    planes (kernel 2: split once, by the writer, not by each of the
//    cluster's readers).  A chunk is then one contiguous block that one
//    bulk copy brings into a ring slot of the CTA (each CTA of the
//    cluster reads every chunk of its tile).  Two scratch buffers
//    alternate between layers, and one cluster barrier after each layer
//    orders every CTA's stores (and a proxy fence, for the copy engine)
//    before any copy, and every copy before the buffer is written again.
//    The input x (row stride 557 x 4 B: no TMA) is published the same way
//    first.  Reading the chunks from the owners' shared memory instead
//    (ld.shared::cluster) was slower on the H100: every CTA reads every
//    chunk, and distributed shared memory delivered a few bytes a clock to
//    an SM; one copy multicast to the whole cluster was slower too, as it
//    ties every CTA to the slowest at each stage.
//  * Warp roles: 4 nwg consumer warps run the products and the epilogue;
//    one producer warp issues, a stage ahead of them by `stages`, each
//    stage's weight boxes by TMA (from the pack's device layout: every
//    layer zero-padded to 64 x 64 boxes, stacked in one matrix; bf16 with
//    the 128-byte swizzle that wgmma reads, B MN-major as in kernel 5),
//    running on into the next layer, and its activation chunk once the
//    layer has begun; for int8 weights three more warps widen each int8
//    box into a swizzled bf16 box (Hopper has no int8 x bf16 MMA).  Full
//    and empty mbarriers a slot; no block-wide barrier in the loop.
//  * Products: wgmma.mma_async m64n64k16, bf16 x bf16 -> float32, A from
//    registers (16-byte shared loads), one instruction a 64-column chunk
//    and 16 K rows, with no branch around them (ptxas serializes wgmma on
//    a divergent path).
//  * One fixed order: every output sums its layer's K chunks ascending, 16
//    K rows an instruction, (kernel 2) hi, mid, lo at each 16 rows.  It
//    depends on the widths only, never on B, the tile or the cluster, so a
//    row's output has the same bits in any batch (the server pads a
//    50-row request to 384).
//  * Padding: rows past B read x as zero and are never stored; columns
//    past a layer's width are set to zero in the epilogue (a zero-padded
//    weight column times an inf activation would give NaN) and the last
//    layer stores its real columns only.
//  * kF32 (kernel 6, fused_mlp_train_{fwd,bwd}.cu; a template parameter,
//    so kernels 2 and 3 compile without it): the tensor cores' float32
//    accumulation truncates, and over a layer's ~100 products into one
//    accumulator that left kernel 6's hidden activations ~1e-5 of their
//    scale low on an H100, ten times float32's error: enough to flip the
//    backward's bf16 roundings and relu masks against the reference.  So
//    the products of a 16-deep k step of one output chunk (its three
//    passes lo, mid, hi, smallest first) go into a fresh accumulator,
//    which is then added into the float32 sums in registers, rounded to
//    nearest (__fadd_rn); one fixed order still.  With it the hidden
//    activations were closer to float64's than float32's own.
//    The float32 sums take registers a CTA of two warpgroups and two
//    chunks does not have under the 168 a thread its launch allows: so
//    kF32's producer is a whole warpgroup (one warp issues, three idle)
//    that gives its registers up (setmaxnreg) to the consumers, 232 each.
//    Its waits are every instantiation's (mbar_wait): one protocol, one
//    behaviour where a barrier never completes.
//  * kF32 also gives kernel 6's recompute (fused_mlp_train_bwd.cu) its
//    saves: where `save` is given, every layer's output after its relu is
//    written, rounded to bf16 (nearest even), row-major at the layer's
//    width padded to 64 (zeros past the width); where `out` is not, no
//    float32 output is.  The recompute passes the hidden layers only, with
//    relu_tail the last one's whole width.  So the forward and the
//    recompute run one instantiation, and their relu masks agree bit for
//    bit.
#pragma once

#include <algorithm>

#include "common.cuh"
#include "hopper.cuh"

namespace cst {
namespace mlpw {

constexpr int kChunk = 64;     // K chunk and output column slice
constexpr int kMaxNb = 2;      // output chunks a CTA of the widest layer
constexpr int kMaxStages = 8;
constexpr int kMaxCluster = 16;
constexpr int kBf16Box = kChunk * kChunk * 2;
constexpr int kInt8Box = kChunk * kChunk;

constexpr int kConvStages = 4;  // int8: widened bf16 stages
constexpr int kWidenWarps = 3;  // int8: producer warps that widen

// Warps of a CTA: 4 nwg consumer warps (the warpgroups that run the
// products), then the producer: one warp that issues the weight copies,
// and for int8 weights kWidenWarps more that widen them.
__host__ __device__ constexpr int consumer_threads(int nwg) {
  return 128 * nwg;
}
__host__ __device__ constexpr int cta_threads(bool int8, int nwg,
                                              bool f32 = false) {
  return 128 * nwg + 32 * (int8 || f32 ? 1 + kWidenWarps : 1);
}
constexpr int kF32ProducerRegs = 40;   // kF32: a thread, after setmaxnreg
constexpr int kF32ConsumerRegs = 232;

struct Layout {
  size_t conv, act, table, bars, total;
};

// Bytes of one activation chunk: 1 (int8) or 3 (bf16 weights) bf16 planes
// of 64 nwg rows x 64 columns.
__host__ __device__ constexpr int chunk_bytes(bool int8, int nwg) {
  return (int8 ? 1 : 3) * 64 * nwg * kChunk * 2;
}

// Dynamic shared memory, from a 1024-byte aligned base: the weight ring
// (stages x nb boxes) | int8 only: kConvStages widened bf16 stages | the
// activation ring (stages x one chunk) | the layer table | the barriers:
// full and empty ones a stage for its weights and for its activations,
// and (int8) for a widened stage.  ops/kernels.py _mlp_smem mirrors
// `total`.
__host__ __device__ inline Layout smem_layout(bool int8, int nwg, int nb,
                                              int stages) {
  Layout o;
  o.conv = static_cast<size_t>(stages) * nb * (int8 ? kInt8Box : kBf16Box);
  o.act =
      o.conv + (int8 ? static_cast<size_t>(kConvStages) * nb * kBf16Box : 0);
  o.table = o.act + static_cast<size_t>(stages) * chunk_bytes(int8, nwg);
  o.bars = o.table + 32 * (kMaxLayers + 1);
  o.total = o.bars + 32 * static_cast<size_t>(stages) +
            (int8 ? 16 * kConvStages : 0) + 1024;
  return o;
}

struct Args {
  const float* x;       // (rows, w[0]) float32
  const float* scale;   // int8: every layer's padded scales
  const float* bias;    // every layer's padded biases
  float* out;           // (rows, w[n_layers]) float32
  __nv_bfloat16* act;   // scratch: [2][row tiles][act_chunks] chunks
  __nv_bfloat16* save;  // kF32, or null: layer l's (rows, 64 chunks(w[l +
                        // 1])) at rows * (the padded widths before it)
  Widths wd;            // the real widths
  int rows, relu_tail, stages, passes, act_chunks;
};

__host__ __device__ __forceinline__ int chunks(int width) {
  return (width + kChunk - 1) / kChunk;
}

// A layer as this CTA sees it (in shared memory, so that the hot loops
// neither divide nor index the kernel's parameters).
struct LayerRow {
  int n;     // output chunks this CTA owns (<= nb)
  int nk;    // K chunks
  int roff;  // first row in the stacked weight matrix
  int boff;  // first padded bias
  int g0;    // this CTA's first stage of the layer
  int pad;
  long long soff;  // kF32: the layer's first saved element
};

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}
__device__ __forceinline__ uint32_t cluster_size() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_nctarank;\n" : "=r"(r));
  return r;
}
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
// The three bf16 parts of h (their bits): see the notes.
__device__ __forceinline__ void split3(float h, uint32_t& p0, uint32_t& p1,
                                       uint32_t& p2) {
  if (!isfinite(h)) {
    p0 = static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(h)));
    p1 = p2 = 0;
    return;
  }
  const uint32_t b0 = __float_as_uint(h);
  const float r1 = __fsub_rn(h, __uint_as_float(b0 & 0xffff0000u));
  const uint32_t b1 = __float_as_uint(r1);
  const float r2 = __fsub_rn(r1, __uint_as_float(b1 & 0xffff0000u));
  p0 = b0 >> 16;
  p1 = b1 >> 16;
  p2 = __float_as_uint(r2) >> 16;
}

// Publish 8 activations (one thread's k step, in order) as the next
// layer's A, to global memory: kernel 3 rounds them to bf16 (one plane),
// kernel 2 splits them into hi, mid, lo (three planes `plane` elements
// apart; with passes < 3 the parts left out are published as zero, for the
// card's planted-fault check).
template <int kParts>
__device__ __forceinline__ void publish8(__nv_bfloat16* dst, int plane,
                                         const float (&v)[8], int passes) {
  if constexpr (kParts == 1) {
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat162 p = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
      w[i] = *reinterpret_cast<const uint32_t*>(&p);
    }
    *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
  } else {
    uint32_t w[3][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      uint32_t x0, x1, x2, y0, y1, y2;
      split3(v[2 * i], x0, x1, x2);
      split3(v[2 * i + 1], y0, y1, y2);
      w[0][i] = x0 | (y0 << 16);
      w[1][i] = passes > 1 ? x1 | (y1 << 16) : 0u;
      w[2][i] = passes > 2 ? x2 | (y2 << 16) : 0u;
    }
#pragma unroll
    for (int p = 0; p < 3; ++p)
      *reinterpret_cast<uint4*>(dst + p * plane) =
          make_uint4(w[p][0], w[p][1], w[p][2], w[p][3]);
  }
}

__device__ __forceinline__ void wgmma_a(float (&d)[32], const uint4& a,
                                        uint64_t desc) {
  const uint32_t r[4] = {a.x, a.y, a.z, a.w};
  wgmma_m64n64k16(d, r, desc);
}

// Widen n int8 boxes (64 rows of 64 bytes) into bf16 boxes laid down as
// TMA's 128-byte swizzle would (row k's 16-byte group g at k * 128 +
// (g ^ (k % 8)) * 16), by `threads` threads numbered from `t`.  An int8 q
// widens exactly through float: a byte permute puts q + 128 into the low
// mantissa bits of 2^23, less 2^23 + 128 that is q, whose top 16 bits are
// its bf16.
__device__ __forceinline__ void widen_boxes(const unsigned char* raw,
                                            unsigned char* conv, int n,
                                            int t, int threads) {
  for (int i = t; i < n * 512; i += threads) {
    const int box = i >> 9, k = (i >> 3) & 63, g = i & 7;
    const uint2 v = *reinterpret_cast<const uint2*>(raw + box * kInt8Box +
                                                    k * 64 + g * 8);
    const uint32_t src[2] = {v.x ^ 0x80808080u, v.y ^ 0x80808080u};
    uint32_t w[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const uint32_t word = src[j >> 1];
      const int b = (j & 1) * 2;
      const float lo =
          __uint_as_float(__byte_perm(word, 0x4B000000u, 0x7540 | b)) -
          8388736.0f;
      const float hi =
          __uint_as_float(__byte_perm(word, 0x4B000000u, 0x7540 | (b + 1))) -
          8388736.0f;
      w[j] = __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632);
    }
    *reinterpret_cast<uint4*>(conv + box * kBf16Box + k * 128 +
                              ((g ^ (k & 7)) << 4)) =
        make_uint4(w[0], w[1], w[2], w[3]);
  }
}

template <bool kInt8, int NWG, int NB, bool kF32>
__global__ void __launch_bounds__(cta_threads(kInt8, NWG, kF32), 1)
    mlp_wgmma_kernel(const __grid_constant__ CUtensorMap wmap, const Args a) {
  constexpr int kCons = consumer_threads(NWG);
  constexpr int kThreads = cta_threads(kInt8, NWG, kF32);
  constexpr int kRows = 64 * NWG;
  constexpr int kBox = kInt8 ? kInt8Box : kBf16Box;
  constexpr int kParts = kInt8 ? 1 : 3;   // bf16 planes of an activation
  constexpr int kPlane = kRows * kChunk;  // elements a plane
  constexpr int kChunkElems = kParts * kPlane;
  constexpr int kChunkBytes = chunk_bytes(kInt8, NWG);
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const int stages = a.stages;
  const Layout lay = smem_layout(kInt8, NWG, NB, stages);
  unsigned char* conv = smem + lay.conv;
  unsigned char* act = smem + lay.act;
  LayerRow* table = reinterpret_cast<LayerRow*>(smem + lay.table);
  uint64_t* wfull = reinterpret_cast<uint64_t*>(smem + lay.bars);
  uint64_t* wempty = wfull + stages;
  uint64_t* afull = wempty + stages;
  uint64_t* aempty = afull + stages;
  uint64_t* cfull = aempty + stages;  // int8 only
  uint64_t* cempty = cfull + kConvStages;

  const Widths& wd = a.wd;
  const int L = wd.n_layers;
  const int rank = static_cast<int>(cluster_rank());
  const int csize = static_cast<int>(cluster_size());
  const int tile = blockIdx.x / csize;
  const long long row0 = static_cast<long long>(tile) * kRows;
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  // chunk c of the activations of buffer b for this row tile
  auto act_chunk = [&](int b, int c) {
    return a.act + ((static_cast<size_t>(b) * (gridDim.x / csize) + tile) *
                        a.act_chunks + c) * kChunkElems;
  };

  // 0. the layer table and the barriers
  if (t == 0) {
    prefetch_tensormap(&wmap);
    int roff = 0, boff = 0, g = 0;
    for (int l = 0; l < L; ++l) {
      LayerRow& row = table[l];
      const int nout = chunks(wd.w[l + 1]);
      row.nk = chunks(wd.w[l]);
      row.n = rank < nout ? min((nout - 1 - rank) / csize + 1, NB) : 0;
      row.roff = roff;
      row.boff = boff;
      row.g0 = g;
      if constexpr (kF32) row.soff = static_cast<long long>(a.rows) * boff;
      roff += kChunk * row.nk;
      boff += kChunk * nout;
      g += row.n > 0 ? row.nk : 0;
    }
    table[L].g0 = g;
    for (int s = 0; s < stages; ++s) {
      mbar_init(wfull + s, 1);
      mbar_init(wempty + s, kInt8 ? kWidenWarps : kCons / 32);
      mbar_init(afull + s, 1);
      mbar_init(aempty + s, kCons / 32);
    }
    if constexpr (kInt8) {
      for (int s = 0; s < kConvStages; ++s) {
        mbar_init(cfull + s, kWidenWarps);
        mbar_init(cempty + s, kCons / 32);
      }
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // The producer's walk over this CTA's stages (layer, step of its K walk).
  // The issuing lane brings a stage's weights as soon as its slot is free,
  // running ahead across layers, and its activation chunk once the layer
  // has begun (the chunk is written by the layer before); the widening
  // warps (int8) follow the weights.
  const bool producer = warp >= kCons / 32;
  const bool issuer = warp == kCons / 32;
  const int total = table[L].g0;
  struct Walk {
    int l, i, g;
  };
  auto advance = [&](Walk& w) {
    ++w.g;
    if (++w.i >= table[w.l].nk) {
      w.i = 0;
      ++w.l;
      while (w.l < L && table[w.l].n == 0) ++w.l;
    }
  };
  Walk ww{0, 0, 0}, wa{0, 0, 0};
  while (ww.l < L && table[ww.l].n == 0) ++ww.l;
  wa = ww;
  // weights of the stages up to `limit`
  auto produce_w = [&](int limit) {
    for (; ww.g < limit; advance(ww)) {
      const LayerRow& row = table[ww.l];
      const int s = ww.g % stages;
      if (issuer) {
        if (lane == 0) {
          if (ww.g >= stages)
            mbar_wait(wempty + s, ((ww.g / stages) - 1) & 1);
          mbar_expect_tx(wfull + s, row.n * kBox);
          for (int j = 0; j < row.n; ++j)
            tma_load_2d(smem + (s * NB + j) * kBox, &wmap, wfull + s,
                        kChunk * (rank + j * csize),
                        row.roff + kChunk * ww.i);
        }
      } else if constexpr (kInt8) {
        const int cs = ww.g % kConvStages;
        mbar_wait(wfull + s, (ww.g / stages) & 1);
        if (ww.g >= kConvStages)
          mbar_wait(cempty + cs, ((ww.g / kConvStages) - 1) & 1);
        widen_boxes(smem + s * NB * kBox, conv + cs * NB * kBf16Box, row.n,
                    t - kCons - 32, 32 * kWidenWarps);
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        __syncwarp();
        if (lane == 0) {
          mbar_arrive(wempty + s);
          mbar_arrive(cfull + cs);
        }
      }
    }
    __syncwarp();
  };
  // the weights do not depend on x: the first stages are in flight first
  if (issuer) produce_w(min(total, stages));

  // 1. publish this CTA's chunks of x (zero past the rows and columns) to
  // buffer 0, every thread eight elements: one thread's k step of one row
  // group, in the order the products read them
  {
    const int d0 = wd.w[0];
    const int nx = rank < chunks(d0)
                       ? min((chunks(d0) - 1 - rank) / csize + 1, NB)
                       : 0;
    for (int i = t; i < nx * kPlane / 8; i += kThreads) {
      const int slot = i / (kPlane / 8);
      const int e = (i % (kPlane / 8)) * 8;
      const int wq = e >> 10, ks = (e >> 8) & 3, ln = (e >> 3) & 31;
      const int col0 = kChunk * (rank + slot * csize) + 16 * ks +
                       2 * (ln & 3);
      const long long r0 = row0 + 16 * wq + (ln >> 2);
      float v[8];
#pragma unroll
      for (int m = 0; m < 8; ++m) {
        const long long r = r0 + 8 * ((m >> 1) & 1);
        const int c = col0 + 8 * (m >> 2) + (m & 1);
        v[m] = r < a.rows && c < d0 ? __ldg(a.x + r * d0 + c) : 0.0f;
      }
      publish8<kParts>(act_chunk(0, rank + slot * csize) + e, kPlane, v,
                       a.passes);
    }
  }
  asm volatile("fence.proxy.async.global;\n" ::: "memory");
  cluster_sync();

  if constexpr (kF32) {
    // the producer warpgroup's registers to the consumers (see the notes)
    if (producer) {
      setmaxnreg_dec<kF32ProducerRegs>();
    } else {
      setmaxnreg_inc<kF32ConsumerRegs>();
    }
  }
  if (producer) {
    // 2a. the producer, layer by layer: this layer's activations, the
    // weights up to `stages` (widening: kConvStages) into the next layer,
    // then the cluster barrier that closes the layer
    // (the widening warps never look past what the issuer has issued)
    const int ahead = issuer ? stages : min(kConvStages, stages);
    for (int l = 0; l < L; ++l) {
      if (issuer) {
        // stage by stage: its weights (already in flight for the layer's
        // first `stages` stages), then its activation chunk, each once its
        // slot is free
        for (; wa.g < table[l + 1].g0; advance(wa)) {
          if (ww.g <= wa.g) produce_w(wa.g + 1);
          if (lane == 0) {
            const int s = wa.g % stages;
            if (wa.g >= stages)
              mbar_wait(aempty + s, ((wa.g / stages) - 1) & 1);
            // the layer before's global writes, for the copy engine
            asm volatile("fence.proxy.async.global;\n" ::: "memory");
            mbar_expect_tx(afull + s, kChunkBytes);
            bulk_load(act + s * kChunkBytes, act_chunk(l & 1, wa.i),
                      kChunkBytes, afull + s);
          }
          __syncwarp();
        }
      }
      produce_w(min(total, table[l + 1].g0 + ahead));
      cluster_sync();
    }
    return;
  }

  // 2b. the consumers: this thread's 16 bytes of k step 0 in a chunk, and
  // its rows
  const int a_off = ((warp * 4 * 32 + lane) * 8) * 2;
  const int ra = 16 * warp + (lane >> 2);

  for (int l = 0; l < L; ++l) {
    const LayerRow& row = table[l];
    const int dout = wd.w[l + 1];
    const int n = row.n, nk = row.nk;
    const bool last = l == L - 1;
    if (n > 0) {
      float acc[NB][32];
      float tmp[32];  // kF32: a k step's products of a chunk
#pragma unroll
      for (int j = 0; j < NB; ++j)
#pragma unroll
        for (int i = 0; i < 32; ++i) acc[j][i] = 0.0f;
#pragma unroll
      for (int i = 0; i < 32; ++i) tmp[i] = 0.0f;
      for (int i = 0; i < nk; ++i) {
        const int g = row.g0 + i;
        const int s = g % stages;
        uint32_t b0;
        if constexpr (kInt8) {
          const int cs = g % kConvStages;
          mbar_wait(cfull + cs, (g / kConvStages) & 1);
          b0 = smem_u32(conv + cs * NB * kBf16Box);
        } else {
          mbar_wait(wfull + s, (g / stages) & 1);
          b0 = smem_u32(smem + s * NB * kBox);
        }
        mbar_wait(afull + s, (g / stages) & 1);
        if constexpr (kF32) {
          // chunk by chunk, a k step at a time: lo, mid, hi into tmp (the
          // first product overwrites it), then tmp into the float32 sums;
          // the step's A registers live until its products are done
          static_assert(!kInt8, "kF32 takes bf16 weights");
          const unsigned char* ab = act + s * kChunkBytes + a_off;
#pragma unroll
          for (int j = 0; j < NB; ++j) {
#pragma unroll
            for (int kk = 0; kk < 4; ++kk) {
              uint4 A[kParts];
#pragma unroll
              for (int p = 0; p < kParts; ++p)
                A[p] = *reinterpret_cast<const uint4*>(ab + kk * 512 +
                                                       p * kPlane * 2);
              const uint64_t desc = b_desc(b0 + j * kBf16Box + kk * 2048);
              const uint32_t lo[4] = {A[2].x, A[2].y, A[2].z, A[2].w};
#pragma unroll
              for (int r = 0; r < 32; ++r) fence_reg(tmp[r]);
              wgmma_fence();
              wgmma_m64n64k16_set(tmp, lo, desc);
              wgmma_a(tmp, A[1], desc);
              wgmma_a(tmp, A[0], desc);
              wgmma_commit();
              wgmma_wait_all();
#pragma unroll
              for (int r = 0; r < 32; ++r) {
                fence_reg(tmp[r]);
                acc[j][r] = __fadd_rn(acc[j][r], tmp[r]);
              }
#pragma unroll
              for (int p = 0; p < kParts; ++p) {
                fence_reg(A[p].x);
                fence_reg(A[p].y);
                fence_reg(A[p].z);
                fence_reg(A[p].w);
              }
            }
          }
        } else {
          uint4 A[4][kParts];
          const unsigned char* ab = act + s * kChunkBytes + a_off;
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
#pragma unroll
            for (int p = 0; p < kParts; ++p)
              A[kk][p] = *reinterpret_cast<const uint4*>(ab + kk * 512 +
                                                         p * kPlane * 2);
#pragma unroll
          for (int j = 0; j < NB; ++j)
#pragma unroll
            for (int r = 0; r < 32; ++r) fence_reg(acc[j][r]);
          wgmma_fence();
          // no branch around a product: ptxas serializes wgmma on divergent
          // paths.  Chunks past n read a slot nothing was loaded to, and are
          // never stored
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
#pragma unroll
            for (int p = 0; p < kParts; ++p)
#pragma unroll
              for (int j = 0; j < NB; ++j)
                wgmma_a(acc[j], A[kk][p],
                        b_desc(b0 + j * kBf16Box + kk * 2048));
          wgmma_commit();
          wgmma_wait_all();
#pragma unroll
          for (int j = 0; j < NB; ++j)
#pragma unroll
            for (int r = 0; r < 32; ++r) fence_reg(acc[j][r]);
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
#pragma unroll
            for (int p = 0; p < kParts; ++p) {
              fence_reg(A[kk][p].x);
              fence_reg(A[kk][p].y);
              fence_reg(A[kk][p].z);
              fence_reg(A[kk][p].w);
            }
        }
        if (lane == 0) {
          mbar_arrive(aempty + s);
          if constexpr (kInt8) {
            mbar_arrive(cempty + g % kConvStages);
          } else {
            mbar_arrive(wempty + s);
          }
        }
      }

      // epilogue: accumulator 8 kk + m of chunk j is row ra + 8 ((m / 2)
      // % 2), column 16 kk + 8 (m / 4) + 2 (lane % 4) + m % 2 of the
      // chunk; the 8 of k step kk are, in order, the 8 elements the next
      // layer's thread of this warp and lane reads for its k step kk
#pragma unroll
      for (int j = 0; j < NB; ++j) {
        if (j >= n) continue;
        const int cj = rank + j * csize;
        const int col0 = kChunk * cj;
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          float v[8];
#pragma unroll
          for (int m = 0; m < 8; ++m) {
            const int gc = col0 + 16 * kk + 8 * (m >> 2) + 2 * (lane & 3) +
                           (m & 1);
            const float bias = __ldg(a.bias + row.boff + gc);
            float y = acc[j][8 * kk + m];
            if constexpr (kInt8) {
              y = __fadd_rn(__fmul_rn(y, __ldg(a.scale + row.boff + gc)),
                            bias);
            } else {
              y = __fadd_rn(y, bias);
            }
            // relu between layers and on the last relu_tail outputs;
            // `y < 0` keeps a NaN, as jnp.maximum does
            const bool relu = !last || gc >= dout - a.relu_tail;
            if (relu && y < 0.0f) y = 0.0f;
            v[m] = gc < dout ? y : 0.0f;
            if (last && gc < dout && (!kF32 || a.out != nullptr)) {
              const long long r = row0 + ra + 8 * ((m >> 1) & 1);
              if (r < a.rows) a.out[r * dout + gc] = y;
            }
          }
          if (!last)
            publish8<kParts>(act_chunk((l + 1) & 1, cj) +
                                 ((warp * 4 + kk) * 32 + lane) * 8,
                             kPlane, v, a.passes);
          if (kF32 && a.save != nullptr) {
            // v[4 b + 2 h + e]: row ra + 8 h, column 16 kk + 8 b + 2 (lane
            // % 4) + e of the chunk; two columns a 4-byte store
            const int ld = kChunk * chunks(dout);
            __nv_bfloat16* sp = a.save + row.soff;
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const long long r = row0 + ra + 8 * h;
              if (r >= a.rows) continue;
#pragma unroll
              for (int b = 0; b < 2; ++b) {
                const int m = 4 * b + 2 * h;
                *reinterpret_cast<__nv_bfloat162*>(
                    sp + r * ld + col0 + 16 * kk + 8 * b + 2 * (lane & 3)) =
                    __floats2bfloat162_rn(v[m], v[m + 1]);
              }
            }
          }
        }
      }
    }
    // every CTA's chunks of this layer are written, and every copy of the
    // other buffer has landed; at the end no CTA leaves while a peer may
    // still copy from it
    asm volatile("fence.proxy.async.global;\n" ::: "memory");
    cluster_sync();
  }
}

template <bool kInt8, int NWG, int NB, bool kF32>
int launch_kernel(const CUtensorMap* map, const Args* a, int cluster,
                  int tiles_m, size_t smem, cudaStream_t stream,
                  int* active) {
  auto kernel = mlp_wgmma_kernel<kInt8, NWG, NB, kF32>;
  // once a device: the shared memory opt-in, and clusters of 16 (past the
  // portable 8)
  static bool opted[kMaxDevices] = {};
  static bool wide[kMaxDevices] = {};
  static std::mutex mu;
  int e = opt_in_shared_memory(kernel, opted, mu);
  if (e != 0) return e;
  {
    int dev = 0;
    e = static_cast<int>(cudaGetDevice(&dev));
    if (e != 0) return e;
    std::lock_guard<std::mutex> lock(mu);
    if (!wide[dev]) {
      e = static_cast<int>(cudaFuncSetAttribute(
          kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1));
      if (e != 0) return e;
      wide[dev] = true;
    }
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(tiles_m * cluster));
  cfg.blockDim = dim3(cta_threads(kInt8, NWG, kF32));
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (active != nullptr)
    return static_cast<int>(
        cudaOccupancyMaxActiveClusters(active, kernel, &cfg));
  const cudaError_t le = cudaLaunchKernelEx(&cfg, kernel, *map, *a);
  if (le != cudaSuccess) return static_cast<int>(le);
  return static_cast<int>(cudaGetLastError());
}

// Launch (or, with `active`, count the clusters the card holds at once of)
// the instantiation for (nwg, nb).
template <bool kInt8, bool kF32 = false>
int dispatch(int nwg, int nb, const CUtensorMap* map, const Args* a,
             int cluster, int tiles_m, size_t smem, cudaStream_t stream,
             int* active) {
#define CST_MLPW(NWG, NB)                                                  \
  if (nwg == NWG && nb == NB)                                              \
    return launch_kernel<kInt8, NWG, NB, kF32>(map, a, cluster, tiles_m,   \
                                               smem, stream, active);
  CST_MLPW(1, 1)
  CST_MLPW(1, 2)
  CST_MLPW(2, 1)
  CST_MLPW(2, 2)
#undef CST_MLPW
  return static_cast<int>(cudaErrorInvalidValue);
}

// How many clusters of (nwg, nb, cluster) with `smem` bytes a CTA the
// current card holds at once (cudaOccupancyMaxActiveClusters): 0 where
// such a cluster cannot be scheduled; minus a CUDA error.
template <bool kInt8>
int active_clusters(int nwg, int nb, int cluster, int smem) {
  if (cluster < 1 || cluster > kMaxCluster || smem < 0)
    return -static_cast<int>(cudaErrorInvalidValue);
  int n = 0;
  const int e = dispatch<kInt8>(nwg, nb, nullptr, nullptr, cluster, 1,
                                static_cast<size_t>(smem), nullptr, &n);
  return e != 0 ? -e : n;
}

// Checks the plan, encodes the weight map and launches.  w: the pack's
// device layout, (sum of the padded d_in, the widest padded d_out), bf16
// or int8, 16-byte aligned; act: scratch of 2 x (row tiles) x (the most K
// chunks of a layer) activation chunks (chunk_bytes each), 16-byte
// aligned; save (kF32 only, or null): rows x (the layers' padded output
// widths) bf16, 4-byte aligned, beside or in place of `out`; w_cols: the
// pack's columns where it holds more layers than these (0: the widest
// padded d_out of these).
template <bool kInt8, bool kF32 = false>
int launch(const float* x, const void* w, const float* scale,
           const float* bias, float* out, void* act, const int* widths,
           int n_layers, int rows, int relu_tail, int nwg, int nb,
           int cluster, int stages, int passes, void* stream,
           void* save = nullptr, int w_cols = 0) {
  static_assert(!(kInt8 && kF32), "kF32 is kernel 6's");
  if (n_layers < 1 || n_layers > kMaxLayers || rows < 1 || nwg < 1 ||
      nwg > 2 || nb < 1 || nb > kMaxNb || cluster < 1 ||
      (cluster != 8 && cluster != 16) || stages < 2 ||
      stages > kMaxStages || passes < 1 || passes > 3 || relu_tail < 0 ||
      act == nullptr || (out == nullptr && (!kF32 || save == nullptr)) ||
      (!kF32 && save != nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Args a{x, scale, bias, out, static_cast<__nv_bfloat16*>(act),
         static_cast<__nv_bfloat16*>(save), {}, rows, relu_tail, stages,
         passes, 0};
  a.wd.n_layers = n_layers;
  long long ktot = 0;
  int wmax = 0;
  for (int i = 0; i <= n_layers; ++i) {
    if (widths[i] < 1 || chunks(widths[i]) > nb * cluster)
      return static_cast<int>(cudaErrorInvalidValue);
    a.wd.w[i] = widths[i];
    const int padded = kChunk * chunks(widths[i]);
    if (i < n_layers) {
      ktot += padded;
      a.act_chunks = std::max(a.act_chunks, chunks(widths[i]));
    }
    if (i > 0 && padded > wmax) wmax = padded;
  }
  if (relu_tail > widths[n_layers] || (w_cols != 0 && w_cols < wmax))
    return static_cast<int>(cudaErrorInvalidValue);
  if (w_cols != 0) wmax = w_cols;
  const long long tiles_m = (rows + 64LL * nwg - 1) / (64LL * nwg);
  if (tiles_m * cluster > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  if (encode_tiled() == nullptr)
    return static_cast<int>(cudaErrorNotSupported);
  CUtensorMap map;
  if (!encode_2d(&map,
                 kInt8 ? CU_TENSOR_MAP_DATA_TYPE_UINT8
                       : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                 kInt8 ? 1 : 2, w, ktot, wmax, kChunk, kChunk,
                 kInt8 ? CU_TENSOR_MAP_SWIZZLE_NONE
                       : CU_TENSOR_MAP_SWIZZLE_128B)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return dispatch<kInt8, kF32>(nwg, nb, &map, &a, cluster,
                                static_cast<int>(tiles_m),
                                smem_layout(kInt8, nwg, nb, stages).total,
                                static_cast<cudaStream_t>(stream), nullptr);
}

}  // namespace mlpw
}  // namespace cst
