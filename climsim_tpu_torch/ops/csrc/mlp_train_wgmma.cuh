// The products of kernel 6's backward (fused_mlp_train_bwd.cu): one
// TMA-fed wgmma GEMM, C (M x N) = A (M x K) B (K x N), bf16 operands from
// shared memory, float32 sums, in two forms:
//
//  * kDw, dW_l = bf16(h_{l-1})^T bf16(dh_l): M = d_l, N = d_{l+1}, K = the
//    batch.  A(m, k) = h[k, m] and B(k, n) = dh[k, n] are read MN-major
//    straight from the row-major bf16 matrices (no transpose pass: the
//    wgmma transpose bits take them).  Split-K: block z sums the batch rows
//    [z kc, (z + 1) kc) (kc a whole number of 64-row steps and of tile_b
//    rows, from the plan) into its own float32 slice of `out`; the slices
//    are added in z order by a second pass (fused_mlp_train_bwd.cu), so
//    every dW element has one fixed order and two runs give the same bits.
//  * kDh, dh_{l-1} = (bf16(dh_l) bf16(W_l)^T) * [h_{l-1} > 0]: M = the
//    batch, N = d_l (padded to 64), K = d_{l+1} (padded).  A(m, k) =
//    dh[m, k] and B(k, n) = W_l[n, k] (the bf16 pack) are K-major.  The
//    epilogue masks by the saved bf16 h_{l-1} > 0, writes the masked dh
//    rounded to bf16 (all the next products read), and the tile's column
//    sums of the masked float32 dh, rows in a fixed order, for db_{l-1}
//    (added over the row tiles in order by the second pass): db needs no
//    re-read of dh.
//
// Structure: 128 x BN output tiles (BN = 64, 128 or, dW only, 256 from
// the plan);
// two consumer warpgroups of 64 rows each and one producer warp that keeps
// `stages` TMA stages in flight (64 K a stage: one 128-byte swizzled row
// of bf16; A as two 64 x 64 boxes, B as BN / 64), with full and empty
// mbarriers a stage; m64nBNk16 wgmma, A and B by descriptor (dW: one group
// in flight while the stage before is released; dh: each stage's sums
// added into float32 sums in registers).  Rows and columns past the
// matrices' edges are read as zeros (TMA's fill) and never stored.
#pragma once

#include "common.cuh"
#include "hopper.cuh"

namespace cst {
namespace mlpt {

constexpr int kBM = 128;             // output rows a tile
constexpr int kBK = 64;              // K a stage
constexpr int kBox = 64 * 64 * 2;    // one 64 x 64 bf16 TMA box
constexpr int kMaxStages = 8;
constexpr int kConsumers = 256;      // two warpgroups
constexpr int kThreads = kConsumers + 32;
constexpr float kMinNormal = 1.17549435e-38f;  // 2^-126, the relu mask's edge

enum Form { kDw = 0, kDh = 1 };

struct Layout {
  size_t b, colsum, bars, total;
};

// Dynamic shared memory from a 1024-byte aligned base: the A ring (stages
// x two boxes) | the B ring (stages x BN / 64 boxes) | the eight consumer
// warps' column sums (kDh) | full and empty barriers a stage | the base's
// alignment.  ops/fused_mlp_train.py _gemm_smem mirrors `total`.
__host__ __device__ inline Layout gemm_layout(int bn, int stages) {
  Layout o;
  o.b = static_cast<size_t>(stages) * 2 * kBox;
  o.colsum = o.b + static_cast<size_t>(stages) * (bn / 64) * kBox;
  o.bars = o.colsum + 8 * static_cast<size_t>(bn) * 4;
  o.total = o.bars + 16 * static_cast<size_t>(stages) + 1024;
  return o;
}

struct GemmArgs {
  int M, N, K;     // output rows and columns; depth
  int kc;          // kDw: depth a block (a multiple of kBK)
  int stages;
  int boff;        // kDh: W_l's first row in the pack
  float* out;      // kDw: slice z at out + z M N, (M, N) row-major
  __nv_bfloat16* dh;          // kDh: (M, N) bf16 out, N padded
  const __nv_bfloat16* mask;  // kDh: h_{l-1}, (M, N) bf16
  float* colsum;              // kDh: (row tiles, N) float32
};

__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
}

// Blocks an SM: two where the registers allow (dW up to 128 columns; dh,
// which keeps a stage's sums beside its own, 64), so that one block's
// waits overlap the other's products.
__host__ __device__ constexpr int blocks_an_sm(int form, int bn) {
  return bn <= (form == kDw ? 128 : 64) ? 2 : 1;
}

// A stage's four products of a warpgroup into d: K-major operands step 32
// bytes a 16-deep k step inside the 128-byte row, MN-major ones 16 rows of
// 128 bytes (the leading offset: 64-wide blocks along N, MN-major only).
// kDh: the first product overwrites d.
template <int kForm, int BN>
__device__ __forceinline__ void stage_products(float (&d)[BN / 2],
                                               uint32_t a0, uint32_t b0) {
  constexpr int kT = kForm == kDw ? 1 : 0;  // MN-major A and B
  constexpr uint32_t kLead = kForm == kDw ? kBox : 16;
#pragma unroll
  for (int r = 0; r < BN / 2; ++r) fence_reg(d[r]);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kBK / 16; ++kk) {
    const uint32_t step = kForm == kDw ? 2048 * kk : 32 * kk;
    wgmma_ss<BN, kT, kT>(d, sw128_desc(a0 + step, kLead),
                         sw128_desc(b0 + step, kLead),
                         kForm == kDh && kk == 0 ? 0 : 1);
  }
}

template <int kForm, int BN>
__global__ void __launch_bounds__(kThreads, blocks_an_sm(kForm, BN))
    gemm_kernel(const __grid_constant__ CUtensorMap amap,
                const __grid_constant__ CUtensorMap bmap, const GemmArgs a) {
  constexpr int kNB = BN / 64;              // B boxes a stage
  constexpr uint32_t kStageBytes = (2 + kNB) * kBox;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const int stages = a.stages;
  const Layout lay = gemm_layout(BN, stages);
  unsigned char* sa = smem;
  unsigned char* sb = smem + lay.b;
  float* csum = reinterpret_cast<float*>(smem + lay.colsum);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + lay.bars);
  uint64_t* empty = full + stages;

  int m0, n0, k_beg, k_end;
  if constexpr (kForm == kDw) {
    const int tiles_n = (a.N + BN - 1) / BN;
    m0 = (blockIdx.x / tiles_n) * kBM;
    n0 = (blockIdx.x % tiles_n) * BN;
    k_beg = blockIdx.y * a.kc;
    k_end = min(a.K, k_beg + a.kc);
  } else {
    n0 = blockIdx.x * BN;
    m0 = blockIdx.y * kBM;
    k_beg = 0;
    k_end = a.K;
  }
  const int nk = (k_end - k_beg + kBK - 1) / kBK;
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;

  if (t == 0) {
    prefetch_tensormap(&amap);
    prefetch_tensormap(&bmap);
    for (int s = 0; s < stages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, kConsumers / 32);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (warp == kConsumers / 32) {
    // the producer: stage i's boxes once its slot is free
    if (lane == 0) {
      for (int i = 0; i < nk; ++i) {
        const int s = i % stages;
        if (i >= stages) mbar_wait(empty + s, ((i / stages) - 1) & 1);
        mbar_expect_tx(full + s, kStageBytes);
        const int k0 = k_beg + i * kBK;
        unsigned char* da = sa + static_cast<size_t>(s) * 2 * kBox;
        unsigned char* db = sb + static_cast<size_t>(s) * kNB * kBox;
        for (int w = 0; w < 2; ++w) {
          if constexpr (kForm == kDw) {
            tma_load_2d(da + w * kBox, &amap, full + s, m0 + 64 * w, k0);
          } else {
            tma_load_2d(da + w * kBox, &amap, full + s, k0, m0 + 64 * w);
          }
        }
        for (int j = 0; j < kNB; ++j) {
          if constexpr (kForm == kDw) {
            tma_load_2d(db + j * kBox, &bmap, full + s, n0 + 64 * j, k0);
          } else {
            tma_load_2d(db + j * kBox, &bmap, full + s, k0,
                        a.boff + n0 + 64 * j);
          }
        }
      }
    }
    return;
  }

  // the consumers: warpgroup wg owns rows 64 wg .. of the tile
  const int wg = warp >> 2;
  float acc[BN / 2];
#pragma unroll
  for (int r = 0; r < BN / 2; ++r) acc[r] = 0.0f;
  // kDh: a stage's products (64 K) into tmp, the first overwriting it,
  // then added into the float32 sums rounded to nearest: dh is rounded to
  // bf16 after, and the tensor cores' own float32 accumulation truncates
  // (see mlp_forward_wgmma.cuh, kF32).  kDw: one accumulator (dW is not
  // rounded after), a stage's products in flight while the stage before
  // is released.
  float tmp[kForm == kDh ? BN / 2 : 1];
#pragma unroll
  for (int r = 0; r < (kForm == kDh ? BN / 2 : 1); ++r) tmp[r] = 0.0f;
  for (int i = 0; i < nk; ++i) {
    const int s = i % stages;
    mbar_wait(full + s, (i / stages) & 1);
    const uint32_t a0 = smem_u32(sa + static_cast<size_t>(s) * 2 * kBox +
                                 wg * kBox);
    const uint32_t b0 = smem_u32(sb + static_cast<size_t>(s) * kNB * kBox);
    if constexpr (kForm == kDh) {
      stage_products<kForm, BN>(tmp, a0, b0);
    } else {
      stage_products<kForm, BN>(acc, a0, b0);
    }
    wgmma_commit();
    if constexpr (kForm == kDh) {
      wgmma_wait_all();
#pragma unroll
      for (int r = 0; r < BN / 2; ++r) {
        fence_reg(tmp[r]);
        acc[r] = __fadd_rn(acc[r], tmp[r]);
      }
      if (lane == 0) mbar_arrive(empty + s);
    } else {
      wgmma_wait_one();
#pragma unroll
      for (int r = 0; r < BN / 2; ++r) fence_reg(acc[r]);
      if (i > 0 && lane == 0) mbar_arrive(empty + (i - 1) % stages);
    }
  }
  wgmma_wait_all();
#pragma unroll
  for (int r = 0; r < BN / 2; ++r) fence_reg(acc[r]);

  // epilogue: register 4 b + 2 h + e is row 16 (warp % 4) + lane / 4 + 8 h
  // of the warpgroup's 64, column 8 b + 2 (lane % 4) + e
  const int rw = m0 + 64 * wg + 16 * (warp & 3) + (lane >> 2);
  const int cw = n0 + 2 * (lane & 3);
  if constexpr (kForm == kDw) {
    float* o = a.out + static_cast<long long>(blockIdx.y) * a.M * a.N;
#pragma unroll
    for (int r = 0; r < BN / 2; ++r) {
      const int row = rw + 8 * ((r >> 1) & 1);
      const int col = cw + 8 * (r >> 2) + (r & 1);
      if (row < a.M && col < a.N)
        o[static_cast<long long>(row) * a.N + col] = acc[r];
    }
  } else {
#pragma unroll
    for (int b = 0; b < BN / 8; ++b) {
      float sum[2] = {0.0f, 0.0f};
      const int col = cw + 8 * b;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = rw + 8 * h;
        if (row < a.M && col < a.N) {
          const long long at = static_cast<long long>(row) * a.N + col;
          const __nv_bfloat162 m =
              *reinterpret_cast<const __nv_bfloat162*>(a.mask + at);
          // relu' as h >= 2^-126 on the saved bf16 h: a subnormal h is
          // flushed, as XLA's CPU flushes it in the relu (NaN fails, as in
          // torch.where)
          const float v0 = __bfloat162float(m.x) >= kMinNormal
                               ? acc[4 * b + 2 * h] : 0.0f;
          const float v1 = __bfloat162float(m.y) >= kMinNormal
                               ? acc[4 * b + 2 * h + 1] : 0.0f;
          *reinterpret_cast<__nv_bfloat162*>(a.dh + at) =
              __floats2bfloat162_rn(v0, v1);
          sum[0] += v0;
          sum[1] += v1;
        }
      }
      // the warp's 8 rows of each column (lanes of one lane % 4), in a
      // fixed tree
#pragma unroll
      for (int e = 0; e < 2; ++e) {
#pragma unroll
        for (int x = 4; x < 32; x <<= 1)
          sum[e] += __shfl_xor_sync(0xffffffffu, sum[e], x);
        if (lane < 4) csum[warp * BN + 8 * b + 2 * lane + e] = sum[e];
      }
    }
    consumers_sync();
    // the eight warps' sums of a column, warp 0 first
    for (int c = t; c < BN; c += kConsumers) {
      float s = 0.0f;
#pragma unroll
      for (int w = 0; w < 8; ++w) s += csum[w * BN + c];
      if (n0 + c < a.N)
        a.colsum[static_cast<long long>(blockIdx.y) * a.N + n0 + c] = s;
    }
  }
}

template <int kForm, int BN>
int launch_gemm(const CUtensorMap& amap, const CUtensorMap& bmap,
                const GemmArgs& a, dim3 grid, cudaStream_t stream) {
  auto kernel = gemm_kernel<kForm, BN>;
  static bool opted[kMaxDevices] = {};
  static std::mutex mu;
  const int e = opt_in_shared_memory(kernel, opted, mu);
  if (e != 0) return e;
  kernel<<<grid, kThreads, gemm_layout(BN, a.stages).total, stream>>>(
      amap, bmap, a);
  return static_cast<int>(cudaGetLastError());
}

// The form's instantiation for bn.
template <int kForm>
int gemm(int bn, const CUtensorMap& amap, const CUtensorMap& bmap,
         const GemmArgs& a, dim3 grid, cudaStream_t stream) {
  if (a.stages < 2 || a.stages > kMaxStages)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (bn) {
    case 64:
      return launch_gemm<kForm, 64>(amap, bmap, a, grid, stream);
    case 128:
      return launch_gemm<kForm, 128>(amap, bmap, a, grid, stream);
    case 256:  // dW only: dh's stage sums beside its own would not fit
      if constexpr (kForm == kDw)
        return launch_gemm<kForm, 256>(amap, bmap, a, grid, stream);
      return static_cast<int>(cudaErrorInvalidValue);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace mlpt
}  // namespace cst
