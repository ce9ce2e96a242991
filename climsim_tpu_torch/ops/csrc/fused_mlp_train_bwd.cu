// fused_mlp_train_bwd: the backward of the fused MLP-training kernel
// (kernel 6).
//
// Replaces climsim_tpu/ops/fused_mlp_train.py _bwd_kernel (:64, the
// pl.pallas_call at :177).  Given x (B, d_0) and dy (B, d_n):
//   recompute the forward (the device code of the forward, mlp_train.cuh);
//   for layer i from the last down, with dh = dy first:
//     dW_i = bf16(h_{i-1})^T . bf16(dh)     (h_{-1} = x), float32 sums
//     db_i = sum over rows of dh            float32, not rounded
//     dh  <- (bf16(dh) . bf16(W_i)^T) * [h_{i-1} > 0]
// The roundings are those of :87-106; no gradient for x (:190).
//
// Bound on the H100: at B = 32,768 the v1 MLP's backward is ~340 GFLOP
// (the recompute's 114 on the float32 FMA pipes, ~227 of bf16 products)
// against ~0.5 GB of saved activations written and read.  Both operands of
// every backward product are bf16, so those run on the tensor cores
// (warp-level WMMA, 16x16x16 bf16 tiles, float32 sums; no wgmma, no TMA
// yet), and the recompute on the FMA pipes bounds the whole.
//
// Where the TPU differs, and what the design does:
//  * The Pallas kernel keeps a tile's recomputed activations in VMEM.  A
//    227 KB block holds ~32 rows of the v1 widths, too few for a batch
//    tile whose dW products feed the tensor cores.  So the recompute
//    writes every hidden layer's activations to a scratch in device
//    memory (B x 3,200 floats for v1: 419 MB at B = 32,768), and the
//    backward runs layer by layer over the whole batch: a dW product, a
//    column sum, a dh product, each a kernel over the (M, N) tiles.
//  * The Pallas kernel adds each batch tile's dW into a VMEM accumulator
//    across a sequential grid (pl.when(first), :92-100).  GPU blocks run
//    in no order, so a block of the dW product takes tile_b batch rows
//    and writes its partial sum to device memory; a second kernel adds
//    the ceil(B / tile_b) partials of each element in chunk order.  db
//    the same way.  No float atomics: every sum has one fixed order, and
//    two runs give the same bits.
#include <mma.h>

#include "mlp_train.cuh"

namespace {

using namespace nvcuda;

constexpr int kThreads = 256;  // 8 warps: 4 (rows) x 2 (columns)
constexpr int kBM = 64;        // output rows a block
constexpr int kBN = 64;        // output columns a block
constexpr int kBK = 32;        // depth a stage
constexpr int kLdA = kBK + 8;  // bf16 row strides: 16-byte multiples,
constexpr int kLdB = kBN + 8;  // rows shifted across banks
constexpr int kLdC = kBN + 4;  // float
constexpr int kPerThread = kBM * kBK / kThreads;  // 8 values of each operand

static_assert(kBM * kBK == kBK * kBN, "both operand tiles hold 2048 values");

// C = sum over k of bf16(A(m, k)) * bf16(B(k, n)) with float32 sums, for
// an M x N output, A(m, k) = a[m * a_m + k * a_k] and B(k, n) = b[k * b_k +
// n * b_n] (float32 in device memory; kAk / kBn say which stride is 1, so
// neighbouring threads load neighbouring addresses).  Block (x, y, z)
// computes rows 64x.., columns 64y.. over k in [z kc, min(K, (z + 1) kc))
// into c + z c_z (row stride ldc).  With mask, C(m, n) becomes 0 where
// mask[m * ldc + n] > 0 fails (the relu derivative; NaN fails too).
template <bool kAk, bool kBn>
__global__ void __launch_bounds__(kThreads)
    bf16_gemm_kernel(const float* __restrict__ a, long long a_m,
                     long long a_k, const float* __restrict__ b,
                     long long b_k, long long b_n, int M, int N, int K,
                     int kc, float* __restrict__ c, long long c_z, int ldc,
                     const float* __restrict__ mask) {
  __shared__ __align__(32) __nv_bfloat16 as[kBM * kLdA];
  __shared__ __align__(32) __nv_bfloat16 bs[kBK * kLdB];
  __shared__ __align__(32) float cs[kBM * kLdC];
  const int m0 = blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;
  const int k_beg = blockIdx.z * kc;
  const int k_end = min(K, k_beg + kc);
  const int warp = threadIdx.x >> 5;
  const int wm = warp & 3;   // 16-row slab
  const int wn = warp >> 2;  // 32-column half

  // this thread's (row, depth) of the A tile and (depth, column) of the B
  // tile for its i-th value
  auto a_at = [](int i, int& m, int& k) {
    const int idx = threadIdx.x + i * kThreads;
    if (kAk) {
      m = idx / kBK;
      k = idx % kBK;
    } else {
      m = idx % kBM;
      k = idx / kBM;
    }
  };
  auto b_at = [](int i, int& k, int& n) {
    const int idx = threadIdx.x + i * kThreads;
    if (kBn) {
      k = idx / kBN;
      n = idx % kBN;
    } else {
      k = idx % kBK;
      n = idx / kBK;
    }
  };
  float ra[kPerThread], rb[kPerThread];
  auto load = [&](int k0) {  // global -> registers, zero past the edges
#pragma unroll
    for (int i = 0; i < kPerThread; ++i) {
      int m, k, n;
      a_at(i, m, k);
      ra[i] = m0 + m < M && k0 + k < k_end
                  ? a[(m0 + m) * a_m + (k0 + k) * a_k]
                  : 0.0f;
      b_at(i, k, n);
      rb[i] = n0 + n < N && k0 + k < k_end
                  ? b[(k0 + k) * b_k + (n0 + n) * b_n]
                  : 0.0f;
    }
  };
  auto store = [&]() {  // registers -> shared memory, rounded to bf16
#pragma unroll
    for (int i = 0; i < kPerThread; ++i) {
      int m, k, n;
      a_at(i, m, k);
      as[m * kLdA + k] = __float2bfloat16_rn(ra[i]);
      b_at(i, k, n);
      bs[k * kLdB + n] = __float2bfloat16_rn(rb[i]);
    }
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2];
  wmma::fill_fragment(acc[0], 0.0f);
  wmma::fill_fragment(acc[1], 0.0f);
  if (k_beg < k_end) load(k_beg);
  for (int k0 = k_beg; k0 < k_end; k0 += kBK) {
    store();
    __syncthreads();
    // the next stage's loads are in flight while this one's products run
    if (k0 + kBK < k_end) load(k0 + kBK);
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major>
          fa;
      wmma::load_matrix_sync(fa, as + wm * 16 * kLdA + kk, kLdA);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major>
            fb;
        wmma::load_matrix_sync(fb, bs + kk * kLdB + wn * 32 + j * 16, kLdB);
        wmma::mma_sync(acc[j], fa, fb, acc[j]);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    wmma::store_matrix_sync(cs + wm * 16 * kLdC + wn * 32 + j * 16, acc[j],
                            kLdC, wmma::mem_row_major);
  }
  __syncthreads();
  float* cz = c + blockIdx.z * c_z;
  for (int i = threadIdx.x; i < kBM * kBN; i += kThreads) {
    const int m = m0 + i / kBN;
    const int n = n0 + i % kBN;
    if (m >= M || n >= N) continue;
    const long long at = static_cast<long long>(m) * ldc + n;
    float v = cs[(i / kBN) * kLdC + i % kBN];
    if (mask != nullptr && !(mask[at] > 0.0f)) v = 0.0f;
    cz[at] = v;
  }
}

// q[z * n + col] = sum of dh[r * n + col] over r in [z kc, min(rows,
// (z + 1) kc)), r ascending.
__global__ void column_sums_kernel(const float* __restrict__ dh, int rows,
                                   int n, int kc, float* __restrict__ q) {
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= n) return;
  const int r_end = min(rows, (blockIdx.y + 1) * kc);
  float s = 0.0f;
  for (int r = blockIdx.y * kc; r < r_end; ++r) {
    s += dh[static_cast<long long>(r) * n + col];
  }
  q[static_cast<long long>(blockIdx.y) * n + col] = s;
}

// out[i] = p[i] + p[stride + i] + ... + p[(chunks - 1) stride + i], in
// that order.
__global__ void sum_partials_kernel(const float* __restrict__ p,
                                    long long stride, int chunks,
                                    long long n, float* __restrict__ out) {
  const long long i =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = p[i];
  for (int z = 1; z < chunks; ++z) s += p[z * stride + i];
  out[i] = s;
}

int last_error() { return static_cast<int>(cudaGetLastError()); }

unsigned blocks(long long n, int per) {
  return static_cast<unsigned>((n + per - 1) / per);
}

}  // namespace

// x: (rows, d_0), dy: (rows, d_n) float32; w[l], b[l] as for the forward;
// dw[l]: (d_l, d_{l+1}) and db[l]: (d_{l+1},) float32 out.  Scratch (the
// caller allocates; ops/fused_mlp_train.py sizes it): h, rows x (d_1 + ...
// + d_{n-1}) floats; dh, 2 x rows x max(d_1 .. d_{n-1}); partial,
// chunks x (max_l d_l d_{l+1} + max_l d_{l+1}) with chunks = ceil(rows /
// tile_b) (unused when chunks == 1).  tile_rows: the forward's rows a
// block (4 or 16).
extern "C" int cst_fused_mlp_train_bwd(
    const float* x, const float* dy, const float* const* w,
    const float* const* b, float* const* dw, float* const* db,
    const int* widths, int n_layers, int rows, int tile_b, int tile_rows,
    float* h, float* dh, float* partial, void* stream) {
  cst::Layers p;
  cst::Widths wd;
  int e = cst::train_layers(w, b, widths, n_layers, &p, &wd);
  if (e != 0) return e;
  const int chunks = rows < 1 || tile_b < 1 ? 0 : (rows + tile_b - 1) / tile_b;
  if (chunks < 1 || chunks > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_layers > 1) {
    e = cst::launch_train_forward<true>(x, p, wd, rows, tile_rows, nullptr,
                                        h, s);
    if (e != 0) return e;
  }
  long long max_w = 0, max_h = 0;
  long long hoff[cst::kMaxLayers] = {};  // hidden layer l at h + hoff[l]
  for (int l = 0; l < n_layers; ++l) {
    const long long nw = static_cast<long long>(wd.w[l]) * wd.w[l + 1];
    max_w = nw > max_w ? nw : max_w;
    if (l + 1 < n_layers) {
      max_h = wd.w[l + 1] > max_h ? wd.w[l + 1] : max_h;
      if (l + 1 < cst::kMaxLayers) {
        hoff[l + 1] = hoff[l] + static_cast<long long>(rows) * wd.w[l + 1];
      }
    }
  }
  float* q = chunks > 1 ? partial + chunks * max_w : nullptr;  // db partials
  const float* cur = dy;                // dh of layer i, (rows, d_{i+1})
  for (int i = n_layers - 1; i >= 0; --i) {
    const int din = wd.w[i];
    const int dout = wd.w[i + 1];
    const float* prev = i == 0 ? x : h + hoff[i - 1];  // (rows, din)
    // dW_i: M = din, N = dout, K = rows; A(m, k) = prev[k, m], B(k, n) =
    // dh[k, n]
    const dim3 gw(blocks(din, kBM), blocks(dout, kBN), chunks);
    bf16_gemm_kernel<false, true><<<gw, kThreads, 0, s>>>(
        prev, 1, din, cur, dout, 1, din, dout, rows, tile_b,
        chunks == 1 ? dw[i] : partial, static_cast<long long>(din) * dout,
        dout, nullptr);
    if ((e = last_error()) != 0) return e;
    const dim3 gb(blocks(dout, 256), chunks);
    column_sums_kernel<<<gb, 256, 0, s>>>(cur, rows, dout, tile_b,
                                          chunks == 1 ? db[i] : q);
    if ((e = last_error()) != 0) return e;
    if (chunks > 1) {
      const long long nw = static_cast<long long>(din) * dout;
      sum_partials_kernel<<<blocks(nw, 256), 256, 0, s>>>(partial, nw, chunks,
                                                          nw, dw[i]);
      if ((e = last_error()) != 0) return e;
      sum_partials_kernel<<<blocks(dout, 256), 256, 0, s>>>(q, dout, chunks,
                                                            dout, db[i]);
      if ((e = last_error()) != 0) return e;
    }
    if (i > 0) {
      // dh_{i-1}: M = rows, N = din, K = dout; A(m, k) = dh[m, k], B(k, n)
      // = W_i[n, k]; masked by h_{i-1} > 0
      float* next = dh + (cur == dh ? rows * max_h : 0);
      const dim3 gd(blocks(rows, kBM), blocks(din, kBN), 1);
      bf16_gemm_kernel<true, false><<<gd, kThreads, 0, s>>>(
          cur, dout, 1, p.w[i], 1, dout, rows, din, dout, dout, next, 0, din,
          prev);
      if ((e = last_error()) != 0) return e;
      cur = next;
    }
  }
  return 0;
}
