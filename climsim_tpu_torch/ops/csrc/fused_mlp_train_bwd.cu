// fused_mlp_train_bwd: the backward of the fused MLP-training kernel
// (kernel 6).
//
// Replaces climsim_tpu/ops/fused_mlp_train.py _bwd_kernel (:64, the
// pl.pallas_call at :177).  Given x (B, d_0), dy (B, d_n) and the forward's
// bf16 pack:
//   recompute the forward (kernel 2's device code and plan, as the
//   forward ran it), keeping each hidden h_l rounded to bf16;
//   for layer l from the last down, with dh = dy first:
//     dW_l = bf16(h_{l-1})^T bf16(dh)     (h_{-1} = x), float32 sums
//     db_l = sum over rows of dh          float32, not rounded
//     dh  <- (bf16(dh) bf16(W_l)^T) * [h_{l-1} > 0]
// The roundings are those of :87-106 (RN); no gradient for x (:190).
//
// Bound on the H100: the products.  At B = 32,768 the v1 MLP's backward
// is 113.6 GFLOP of dW and 107.4 of dh products (bf16 x bf16), and its
// recompute 113.6 GFLOP whose float32 activations take three bf16 passes:
// 561.8 GFLOP, 0.568 ms at 989 TFLOP/s.  The bytes (the saved h written
// and read, 210 MB at v1; the dh products' bf16 in and out) take ~0.2 ms.
//
// Where the TPU differs, and what the design does:
//  * The Pallas kernel keeps a batch tile's recomputed activations in
//    VMEM; a 227 KB block holds too few rows for products that feed the
//    tensor cores.  So the recompute (kernel 2 with its save epilogue)
//    writes every hidden layer's RN-bf16(h) to device memory, row-major
//    at its width padded to 64 (B x 3,200 x 2 bytes at v1), and the
//    backward runs layer by layer over the whole batch: the dW and dh
//    products are one TMA-fed wgmma GEMM (mlp_train_wgmma.cuh) that reads
//    those matrices as they lie.  The relu mask is read back as saved > 0:
//    it differs from float32's h > 0 only for 0 < h <= 2^-134, which bf16
//    rounds to 0 (XLA's CPU flushes such h to zero in the relu itself).
//  * The Pallas kernel adds each batch tile's dW into a VMEM accumulator
//    across a sequential grid (pl.when(first), :92-100).  GPU blocks run
//    in no order, so the dW product splits the batch into the plan's S
//    chunks (whole multiples of tile_b and of 64 rows, S sized to fill
//    the SMs), each block writing its float32 partial; reduce_kernel adds
//    the S partials of every element in chunk order.  db: prep_kernel (dy,
//    which it also rounds to bf16 once) and the dh products' epilogue
//    write per-row-tile column sums, added in a fixed order by the same
//    pass.
//    No float atomics: every sum has one fixed order, and two runs give
//    the same bits.
#include "mlp_forward_wgmma.cuh"
#include "mlp_train_wgmma.cuh"

namespace {

using cst::mlpt::kBM;

int padded(int w) { return cst::mlpw::kChunk * cst::mlpw::chunks(w); }
int ceil_div(long long a, long long b) {
  return static_cast<int>((a + b - 1) / b);
}

// Tile blockIdx.x (R rows): x and dy rounded to bf16 (nearest even) at
// their padded widths, zeros past the widths; and the tile's column sums
// of dy, rows ascending, into colsum[blockIdx.x * dn + c].
__global__ void prep_kernel(const float* __restrict__ x, int d0, int p0,
                            __nv_bfloat16* __restrict__ xb,
                            const float* __restrict__ dy, int dn, int pn,
                            __nv_bfloat16* __restrict__ dyb,
                            float* __restrict__ colsum, int rows, int R) {
  const long long r0 = static_cast<long long>(blockIdx.x) * R;
  const long long r1 = min(static_cast<long long>(rows), r0 + R);
  for (int c = threadIdx.x; c < p0; c += blockDim.x) {
    for (long long r = r0; r < r1; ++r)
      xb[r * p0 + c] = __float2bfloat16_rn(c < d0 ? x[r * d0 + c] : 0.0f);
  }
  for (int c = threadIdx.x; c < pn; c += blockDim.x) {
    float s = 0.0f;
    for (long long r = r0; r < r1; ++r) {
      const float v = c < dn ? dy[r * dn + c] : 0.0f;
      s += v;
      dyb[r * pn + c] = __float2bfloat16_rn(v);
    }
    if (c < dn) colsum[blockIdx.x * static_cast<long long>(dn) + c] = s;
  }
}

struct ReduceLayer {
  float* dw;        // (nw,) out
  float* db;        // (nb,) out
  const float* pw;  // S slices of nw
  const float* pb;  // T rows of ldb
  long long nw;
  int nb, S, T, ldb;
};
struct ReduceArgs {
  ReduceLayer l[cst::kMaxLayers];
  // layer l's threads from start[l]: one a dW element (nw rounded up to
  // 32), then a warp a db element
  long long start[cst::kMaxLayers + 1];
  int n_layers;
};

__host__ __device__ long long warps(long long n) {
  return (n + 31) / 32 * 32;
}

// Every dW element the sum of its S partials in ascending order, one
// thread each; every db element the sum of its T row-tile sums by a warp:
// lane k adds tiles k, k + 32, ... ascending, then a fixed shuffle tree
// (a few hundred tiles at B = 32,768: one thread each was a serial chain
// of loads).  Every range starts on a warp, so a warp's lanes share one
// element.
__global__ void reduce_kernel(const __grid_constant__ ReduceArgs a) {
  const long long n = a.start[a.n_layers];
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    int l = 0;
    while (i >= a.start[l + 1]) ++l;
    const ReduceLayer& L = a.l[l];
    const long long j = i - a.start[l];
    const long long nw = warps(L.nw);
    if (j < nw) {
      if (j < L.nw) {
        float s = L.pw[j];
        for (int z = 1; z < L.S; ++z) s += L.pw[z * L.nw + j];
        L.dw[j] = s;
      }
    } else {
      const int c = static_cast<int>((j - nw) >> 5);
      const int lane = static_cast<int>(j & 31);
      float s = 0.0f;
      for (int t = lane; t < L.T; t += 32)
        s += L.pb[static_cast<long long>(t) * L.ldb + c];
      for (int x = 16; x > 0; x >>= 1)
        s += __shfl_xor_sync(0xffffffffu, s, x);
      if (lane == 0) L.db[c] = s;
    }
  }
}

bool map_bf16(CUtensorMap* map, const void* base, long long rows, int cols) {
  return cst::encode_2d(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, base,
                        static_cast<uint64_t>(rows),
                        static_cast<uint64_t>(cols), 64, 64,
                        CU_TENSOR_MAP_SWIZZLE_128B);
}

constexpr int kPlanHead = 5;   // nwg, nb, cluster, stages, prep rows
constexpr int kPlanLayer = 5;  // dW bn, stages, kc; dh bn, stages

}  // namespace

// The float32 partials the backward needs for `plan` (the wrapper holds its
// own count, ops/fused_mlp_train.py, against it); minus 1 for a bad plan.
extern "C" long long cst_fused_mlp_train_partials(const int* widths,
                                                  int n_layers, int rows,
                                                  const int* plan) {
  if (n_layers < 1 || n_layers > cst::kMaxLayers || rows < 1) return -1;
  long long n = 0;
  for (int l = 0; l < n_layers; ++l) {
    const int kc = plan[kPlanHead + kPlanLayer * l + 2];
    if (kc < 1 || kc % cst::mlpt::kBK) return -1;
    const int S = ceil_div(rows, kc);
    n += static_cast<long long>(S) * widths[l] * widths[l + 1];
    if (l == n_layers - 1) {
      if (plan[4] < 1) return -1;
      n += static_cast<long long>(ceil_div(rows, plan[4])) * widths[l + 1];
    } else {
      n += static_cast<long long>(ceil_div(rows, kBM)) * padded(widths[l + 1]);
    }
  }
  return n;
}

// The dynamic shared memory a block of the backward's GEMM takes
// (gemm_layout's total), for ops/fused_mlp_train.py _gemm_smem to be held
// against.
extern "C" int cst_mlp_train_gemm_smem(int bn, int stages) {
  return static_cast<int>(cst::mlpt::gemm_layout(bn, stages).total);
}

// x: (rows, d_0), dy: (rows, d_n) float32; wp, bp: the forward's pack
// (cst_fused_mlp_train_pack); dw[l]: (d_l, d_{l+1}) and db[l]: (d_{l+1},)
// float32 out.  plan (ops/fused_mlp_train.py TrainPlan.args): kernel 2's
// nwg, nb, cluster, stages; the prep tile's rows; then a layer: the dW
// product's bn, stages and rows a split-K chunk, the dh product's bn and
// stages.  Scratch (the caller allocates, TrainPlan sizes it): act, kernel
// 2's; save, bf16 rows x (P(d_1) + ... + P(d_{n-1})), P = padded to 64;
// xb, bf16 rows x P(d_0); dh0, dh1, bf16 rows x max P(d_1 .. d_n) each;
// partial, `partial_floats` floats (cst_fused_mlp_train_partials).
extern "C" int cst_fused_mlp_train_bwd(
    const float* x, const float* dy, const void* wp, const float* bp,
    float* const* dw, float* const* db, const int* widths, int n_layers,
    int rows, const int* plan, void* act, void* save, void* xb, void* dh0,
    void* dh1, float* partial, long long partial_floats, void* stream) {
  const long long need =
      cst_fused_mlp_train_partials(widths, n_layers, rows, plan);
  if (need < 0 || need > partial_floats)
    return static_cast<int>(cudaErrorInvalidValue);
  if (cst::encode_tiled() == nullptr)
    return static_cast<int>(cudaErrorNotSupported);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int L = n_layers;
  int e;
  // the pack: layer l's rows from roff[l], the widest padded d_out wide
  int roff[cst::kMaxLayers + 1] = {}, pack_cols = 0;
  for (int l = 0; l < L; ++l) {
    roff[l + 1] = roff[l] + padded(widths[l]);
    pack_cols = padded(widths[l + 1]) > pack_cols ? padded(widths[l + 1])
                                                  : pack_cols;
  }
  // 1. the recompute: the hidden layers, every output relu'd and saved
  if (L > 1) {
    e = cst::mlpw::launch<false, true>(
        x, wp, nullptr, bp, nullptr, act, widths, L - 1, rows, widths[L - 1],
        plan[0], plan[1], plan[2], plan[3], 3, stream, save, pack_cols);
    if (e != 0) return e;
  }
  // layer l's offsets: its saved input (l >= 1), its partials
  long long soff[cst::kMaxLayers] = {};
  for (int l = 1; l < L; ++l)
    soff[l] = soff[l - 1] + static_cast<long long>(rows) * padded(widths[l]);
  long long pw[cst::kMaxLayers], pb[cst::kMaxLayers];
  ReduceArgs red{};
  red.n_layers = L;
  long long off = 0;
  for (int l = 0; l < L; ++l) {
    const int* q = plan + kPlanHead + kPlanLayer * l;
    ReduceLayer& R = red.l[l];
    R.dw = dw[l];
    R.db = db[l];
    R.nw = static_cast<long long>(widths[l]) * widths[l + 1];
    R.nb = widths[l + 1];
    R.S = ceil_div(rows, q[2]);
    const bool last = l == L - 1;
    R.T = ceil_div(rows, last ? plan[4] : kBM);
    R.ldb = last ? widths[l + 1] : padded(widths[l + 1]);
    pw[l] = off;
    off += R.S * R.nw;
    pb[l] = off;
    off += static_cast<long long>(R.T) * R.ldb;
    R.pw = partial + pw[l];
    R.pb = partial + pb[l];
    red.start[l + 1] = red.start[l] + warps(R.nw) + 32LL * R.nb;
  }
  // 2. x and dy to bf16, db of the last layer's row-tile sums
  const int pn = padded(widths[L]);
  __nv_bfloat16* bufs[2] = {static_cast<__nv_bfloat16*>(dh0),
                            static_cast<__nv_bfloat16*>(dh1)};
  prep_kernel<<<ceil_div(rows, plan[4]), 256, 0, s>>>(
      x, widths[0], padded(widths[0]), static_cast<__nv_bfloat16*>(xb), dy,
      widths[L], pn, bufs[0], partial + pb[L - 1], rows, plan[4]);
  if ((e = static_cast<int>(cudaGetLastError())) != 0) return e;
  CUtensorMap wmap;
  if (!map_bf16(&wmap, wp, roff[L], pack_cols))
    return static_cast<int>(cudaErrorInvalidValue);
  // 3. layer by layer, the last first
  int cur = 0;
  for (int l = L - 1; l >= 0; --l) {
    const int* q = plan + kPlanHead + kPlanLayer * l;
    const int pin = padded(widths[l]), pout = padded(widths[l + 1]);
    const __nv_bfloat16* hin =
        l == 0 ? static_cast<const __nv_bfloat16*>(xb)
               : static_cast<const __nv_bfloat16*>(save) + soff[l - 1];
    CUtensorMap hmap, dmap;
    if (!map_bf16(&hmap, hin, rows, pin) ||
        !map_bf16(&dmap, bufs[cur], rows, pout))
      return static_cast<int>(cudaErrorInvalidValue);
    // dW_l: M = d_l, N = d_{l+1}, K = rows in S chunks of q[2] rows
    cst::mlpt::GemmArgs g{};
    g.M = widths[l];
    g.N = widths[l + 1];
    g.K = rows;
    g.kc = q[2];
    g.stages = q[1];
    g.out = partial + pw[l];
    const dim3 gw(ceil_div(g.M, kBM) * ceil_div(g.N, q[0]),
                  ceil_div(rows, q[2]));
    e = cst::mlpt::gemm<cst::mlpt::kDw>(q[0], hmap, dmap, g, gw, s);
    if (e != 0) return e;
    if (l > 0) {
      // dh_{l-1}: M = rows, N = P(d_l), K = P(d_{l+1}); B = W_l^T from
      // the pack; masked by the saved h_{l-1}
      cst::mlpt::GemmArgs h{};
      h.M = rows;
      h.N = pin;
      h.K = pout;
      h.stages = q[4];
      h.boff = roff[l];
      h.dh = bufs[cur ^ 1];
      h.mask = hin;
      h.colsum = partial + pb[l - 1];
      const dim3 gd(ceil_div(pin, q[3]), ceil_div(rows, kBM));
      if (gd.y > 65535) return static_cast<int>(cudaErrorInvalidValue);
      e = cst::mlpt::gemm<cst::mlpt::kDh>(q[3], dmap, wmap, h, gd, s);
      if (e != 0) return e;
      cur ^= 1;
    }
  }
  // 4. the partials, in order
  const long long n = red.start[L];
  const long long blocks = (n + 255) / 256;
  reduce_kernel<<<static_cast<unsigned>(blocks < 8192 ? blocks : 8192), 256,
                  0, s>>>(red);
  return static_cast<int>(cudaGetLastError());
}
