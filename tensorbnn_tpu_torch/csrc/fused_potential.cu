// K3: the likelihood's value and gradient for a fleet of chains, once per call.
//
// Replaces the Pallas kernel tensorbnn_tpu/ops/fused_mlp.py::_potential_kernel
// (:157), launched there by make_fused_potential_vg (:993) and gated by
// try_build_fused_main_vg (:1113). Like it, this computes the likelihood half
// of the log posterior only; the caller adds the priors.
//
// What it computes, per chain c of C: the flat state thetas[c] holds, per dense
// layer, d_out bias rows then the row-major (d_in, d_out) weights, then the
// d_out slope rows of a following prelu or sqprelu. The forward
// pass runs H_l = act_l(H_{l-1} W_l + b_l) from the shared data x (N, d0); the
// Gaussian tail gives ll = -0.5 (sum (y - out)^2 / sd^2 + 2 k log sd + k log 2 pi)
// with sd clamped to [1e-8, 1e8] and k = N dK (fused_mlp.py:231-236); the
// hand-written backward pass writes d ll / d theta into grad (C, D).
//
// What bounds it on the H100: the floating-point operations. At the 10x256
// wide_deep model (N = 128 rows, 64 chains) one call is 27.9 GFLOP of float32
// multiply-adds against 303 MB of state read and gradient written: 0.42 ms at
// the 67 TFLOP/s of float32 outside the tensor cores, against 0.09 ms at
// 3.35 TB/s. At the tutorial's 784-20-20-1 (N = 9,585, 64 chains) it is 40.0
// GFLOP, 0.598 ms, nearly all of it the first layer's forward and weight
// gradient.
//
// What the design does about it: the TPU kernel puts chains on the 128 lanes
// and keeps every plane of a chain block in VMEM. A wide chain's planes do not
// fit on chip here (one 128 x 256 plane is 128 KB, and there are ten), so this
// is a family of tile kernels with fused epilogues whose planes live in a
// device-memory workspace that the caller allocates:
//   - forward, per layer: A[c] = H[c] W[c] + b[c], the layer's activation in
//     the epilogue;
//   - the tail: the per-chain ll and G = d ll / d out (Gaussian: (y - out) /
//     sd^2);
//   - backward, per layer in reverse: dW[c] = H_prev[c]^T G[c] written straight
//     into grad's weight rows, db[c] = sum_n G[c] summed by the first row of
//     tiles from the G tiles they stage anyway, and G_prev[c] = G[c] W[c]^T
//     times the previous activation's derivative in the epilogue (skipped for
//     the first layer, as the TPU kernel skips it with `first`).
// Every product is one kernel template: 64 x 64 output tiles, depth 16, staged
// through double-buffered shared memory, a 4 x 4 register micro-tile per
// thread, full float32 FFMA (no TF32, no tensor cores). Ragged edges are
// masked, so the narrow flagship (N = 11, widths 1 and 10) runs the same code.
// Two things keep the tiles full and the card busy (the launch plan, made in
// ops/fused_mlp.py::PotentialProgram.plan and checked here):
//   - the first layer's two products are packed, as the TPU kernel keeps
//     chains on its lanes: the data x is every chain's, so its forward is one
//     product x [W_1 ... W_C] (N x C d_out) and its weight gradient one x^T
//     [G_1 ... G_C] (d0 x C d_out). Batched per chain, a 20-wide layer fills
//     20 of a tile's 64 columns; packed, every tile is full. The depth order
//     is the batched one, so the results are bit-equal to it;
//   - a row sum over the N rows whose grid leaves room on the card (the deep
//     layers' weight gradients, one tile per chain; the slope passes) runs in
//     slices of rows as extra blocks, as many as the card holds at once, each
//     slice writing its partial sums to the workspace, and slice_sum_kernel
//     then adds the slices in slice order: a fixed order (no atomics), so two
//     calls give bit-equal results.
// One call makes 3 L launches for L dense layers (L forward, 1 tail, L weight
// gradients, L - 1 input gradients), plus one slope_grad_kernel per prelu or
// sqprelu and one slice_sum_kernel per split row sum: 15 at the tutorial
// shape, 30 at wide_deep. Tensor cores (wgmma, TF32) for the per-chain
// 256-wide layers of wide_deep, TMA-fed tiles and a persistent kernel over
// the layers are later work.
//
// The activation derivatives come from each activation's output, which is
// what the forward pass keeps: tanh 1 - h^2, relu [h > 0], sigmoid h (1 - h),
// exp h, elu h > 0 ? 1 : h + 1 (= exp(a) for a <= 0), leakyrelu h < 0 ? alpha
// : 1 (the JAX kernel's rule, :289-291).
//
// Likelihood tails (the Pallas kernel's :227-249), one block per chain:
// gaussian_tail_kernel; bernoulli_tail_kernel clips p to [1e-8,
// 1 - 1e-7] with G = y / p - (1 - y) / (1 - p) inside that range, 0 outside;
// categorical_tail_kernel runs one thread per row over the dk logits (y
// one-hot): softmax, py = sum y p, ll += log max(py, 1e-8) and G = py > 1e-8 ?
// y - p : 0. Each applies the last activation's derivative, as the Gaussian
// tail does.
//
// prelu and sqprelu (sampled slopes s, effective slope s or s^2 where the input
// is negative): a slope of any sign, or a sqprelu slope of 0, leaves the
// output without the input's sign, so the forward epilogue also writes the
// layer's pre-activation plane into the workspace. In the backward pass the
// product that feeds such a layer (the tail, or the next layer's input
// gradient) writes the raw gradient G, and slope_grad_kernel, a kernel of its
// own, then reduces d s_j = sum_n min(a, 0) G[n, j] (times 2 s_j for sqprelu)
// over the N rows per (chain, feature) and scales G by the derivative in
// place. A kernel of its own, rather than a fused epilogue, because the
// reduction runs over the rows that the product's tiles split across blocks:
// fused, it would need atomics (an order that changes from run to run) or a
// second pass over partial sums anyway; alone it is one deterministic read of
// two planes and one write of G, small beside the products at the tutorial
// shape (C = 64, N = 9,585, d = 20: 150 MB against 40 GFLOP).

#include <cuda_runtime.h>

#include <algorithm>
#include <cstddef>
#include <cstring>

namespace {

constexpr int kMaxLayers = 64;
constexpr float kLog2Pi = 1.8378770664093453f;
constexpr float kBernLo = 1e-8f, kBernHi = 1.f - 1e-7f, kCatLo = 1e-8f;

enum Act {
  kNone = 0, kTanh = 1, kRelu = 2, kSigmoid = 3, kExp = 4, kElu = 5, kLeaky = 6, kPrelu = 7,
  kSqPrelu = 8
};
enum Lik { kGaussian = 0, kBernoulli = 1, kCategorical = 2 };
enum Mode { kForward = 0, kWeightGrad = 1, kInputGrad = 2 };

constexpr int kBM = 64, kBN = 64, kBK = 16, kThreads = 256, kPad = 4;

// slope: leakyrelu's alpha, or the effective slope of a prelu / sqprelu
__device__ __forceinline__ float act_forward(int act, float a, float slope) {
  switch (act) {
    case kTanh: return tanhf(a);
    case kRelu: return fmaxf(a, 0.f);
    case kSigmoid: return 1.f / (1.f + expf(-a));
    case kExp: return expf(a);
    case kElu: return a > 0.f ? a : expf(a) - 1.f;
    case kLeaky: case kPrelu: case kSqPrelu: return a < 0.f ? slope * a : a;
    default: return a;
  }
}

// derivative from the activation's output h; prelu and sqprelu take theirs in
// slope_grad_kernel, from the pre-activation plane
__device__ __forceinline__ float act_backward(int act, float h, float alpha) {
  switch (act) {
    case kTanh: return 1.f - h * h;
    case kRelu: return h > 0.f ? 1.f : 0.f;
    case kSigmoid: return h * (1.f - h);
    case kExp: return h;
    case kElu: return h > 0.f ? 1.f : h + 1.f;
    case kLeaky: return h < 0.f ? alpha : 1.f;
    default: return 1.f;
  }
}

__host__ __device__ __forceinline__ bool has_slopes(int act) {
  return act == kPrelu || act == kSqPrelu;
}

// One product out = A B (M x N, depth K) per chain: batched over blockIdx.z =
// c, or packed (pack > 0: the first layer, whose A is the shared data). Packed,
// the output's columns n in [0, C pack) are (c, j) = divmod(n, pack), and every
// batched operand and output is chain c's at column j: one grid of full tiles
// covers all chains, where batching fills 20 of a tile's 64 columns at d_out =
// 20.
struct Gemm {
  int M, N, K;
  const float* a;
  size_t a_batch;
  int lda;
  const float* b;
  size_t b_batch;
  int ldb;
  float* out;
  size_t out_batch;
  int ldo;
  // forward: the bias row; input gradient: the previous layer's output plane
  const float* aux;
  size_t aux_batch;
  int ldaux;
  // weight gradient: the bias rows of grad (batch stride out_batch)
  float* col_sum;
  int act;
  // leakyrelu's alpha
  float alpha;
  // forward of a layer followed by a prelu / sqprelu: its slope rows (batch
  // stride slope_batch) and the pre-activation plane it writes (laid out as
  // out)
  const float* slope;
  size_t slope_batch;
  float* pre;
  // the chain's width of a packed product, 0 for a batched one
  int pack;
  // blockIdx.y = slice m_tiles + the row tile; slice covers depth [slice
  // k_slice, min(K, (slice + 1) k_slice)) and writes its partial out and
  // col_sum at slice slice_stride (a weight gradient split over the data's
  // rows; one slice of depth K otherwise)
  int m_tiles, k_slice;
  size_t slice_stride;
};

// MODE kForward:    A = H (N x d_in, k-contiguous), B = W (d_in x d_out).
// MODE kWeightGrad: A = H_prev^T (d_in x N, read from H_prev), B = G (N x d_out).
// MODE kInputGrad:  A = G (N x d_out), B = W^T (d_out x d_in, read from W).
// PACKED (forward and weight gradient of the first layer): see Gemm.
template <int MODE, bool PACKED>
__global__ void __launch_bounds__(kThreads) gemm_kernel(Gemm p) {
  constexpr bool kAk = MODE != kWeightGrad;  // A(m, k) contiguous in k
  constexpr bool kBn = MODE != kInputGrad;   // B(k, n) contiguous in n
  static_assert(!PACKED || kBn, "a packed product reads B along n");
  __shared__ __align__(16) float As[2][kBK][kBM + kPad];
  __shared__ __align__(16) float Bs[2][kBK][kBN + kPad];

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int m_tile = blockIdx.y % p.m_tiles, slice = blockIdx.y / p.m_tiles;
  const int m0 = m_tile * kBM, n0 = blockIdx.x * kBN;
  const int k_lo = slice * p.k_slice, k_hi = min(p.K, k_lo + p.k_slice);
  const size_t z = blockIdx.z;  // the chain of a batched product
  const float* __restrict__ a = p.a + z * p.a_batch;
  const float* __restrict__ b = p.b + z * p.b_batch;

  // each thread stages 4 elements of each tile; neighbouring threads take
  // neighbouring addresses along the contiguous axis
  auto a_coord = [&](int e, int& mm, int& kk) {
    const int idx = tid + e * kThreads;
    if (kAk) { kk = idx % kBK; mm = idx / kBK; } else { mm = idx % kBM; kk = idx / kBM; }
  };
  auto b_coord = [&](int e, int& kk, int& nn) {
    const int idx = tid + e * kThreads;
    if (kBn) { nn = idx % kBN; kk = idx / kBN; } else { kk = idx % kBK; nn = idx / kBK; }
  };
  // a packed product's B(k, n) = b[k ldb + b_col], chain c's column j: each
  // thread stages the one column tid % kBN of every tile
  static_assert(kThreads % kBN == 0, "a thread's B column is fixed");
  size_t b_col = 0;
  bool b_live = false;
  if (PACKED) {
    const int n = n0 + tid % kBN, c = n / p.pack;
    b_col = (size_t)c * p.b_batch + (n - c * p.pack);
    b_live = n < p.N;
  }
  float ra[4], rb[4];
  auto load = [&](int k0) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      int mm, kk, nn, kb;
      a_coord(e, mm, kk);
      b_coord(e, kb, nn);
      const int m = m0 + mm, ka = k0 + kk, n = n0 + nn, kq = k0 + kb;
      ra[e] = (m < p.M && ka < k_hi)
                  ? (kAk ? a[(size_t)m * p.lda + ka] : a[(size_t)ka * p.lda + m])
                  : 0.f;
      if (PACKED) {
        rb[e] = (b_live && kq < k_hi) ? b[(size_t)kq * p.ldb + b_col] : 0.f;
      } else {
        rb[e] = (n < p.N && kq < k_hi)
                    ? (kBn ? b[(size_t)kq * p.ldb + n] : b[(size_t)n * p.ldb + kq])
                    : 0.f;
      }
    }
  };
  auto store = [&](int buf) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      int mm, kk, nn, kb;
      a_coord(e, mm, kk);
      b_coord(e, kb, nn);
      As[buf][kk][mm] = ra[e];
      Bs[buf][kb][nn] = rb[e];
    }
  };

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  float col[4] = {0.f, 0.f, 0.f, 0.f};
  const bool sum_cols = MODE == kWeightGrad && m_tile == 0 && ty == 0;

  int buf = 0;
  load(k_lo);
  store(0);
  __syncthreads();
  for (int k0 = k_lo; k0 < k_hi; k0 += kBK) {
    const bool more = k0 + kBK < k_hi;
    if (more) load(k0 + kBK);  // in flight while this tile is multiplied
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      const float4 av = *reinterpret_cast<const float4*>(&As[buf][kk][ty * 4]);
      const float4 bv = *reinterpret_cast<const float4*>(&Bs[buf][kk][tx * 4]);
      const float ar[4] = {av.x, av.y, av.z, av.w};
      const float br[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(ar[i], br[j], acc[i][j]);
      if (MODE == kWeightGrad && sum_cols) {
#pragma unroll
        for (int j = 0; j < 4; ++j) col[j] += br[j];
      }
    }
    // the other buffer was last read before the previous barrier
    if (more) store(buf ^ 1);
    __syncthreads();
    buf ^= 1;
  }

  // the output column n is chain c's column j
  auto chain_col = [&](int n, size_t& c, int& j) {
    if (PACKED) {
      c = (size_t)(n / p.pack);
      j = n - (int)c * p.pack;
    } else {
      c = z;
      j = n;
    }
  };
  float* __restrict__ out = p.out + (size_t)slice * p.slice_stride;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
    if (m >= p.M) continue;
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int n = n0 + tx * 4 + jj;
      if (n >= p.N) continue;
      size_t c;
      int j;
      chain_col(n, c, j);
      float v = acc[i][jj];
      if (MODE == kForward) {
        v += p.aux[c * p.aux_batch + j];
        float slope = p.alpha;
        if (has_slopes(p.act)) {
          const float s = p.slope[c * p.slope_batch + j];
          slope = p.act == kSqPrelu ? s * s : s;
          p.pre[c * p.out_batch + (size_t)m * p.ldo + j] = v;
        }
        v = act_forward(p.act, v, slope);
      }
      if (MODE == kInputGrad && p.act != kNone) {
        v *= act_backward(p.act, p.aux[c * p.aux_batch + (size_t)m * p.ldaux + j], p.alpha);
      }
      out[c * p.out_batch + (size_t)m * p.ldo + j] = v;
    }
  }
  if (MODE == kWeightGrad && sum_cols) {
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int n = n0 + tx * 4 + jj;
      if (n >= p.N) continue;
      size_t c;
      int j;
      chain_col(n, c, j);
      p.col_sum[(size_t)slice * p.slice_stride + c * p.out_batch + j] = col[jj];
    }
  }
}

__device__ float block_total(float v, float* red) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float t = 0.f;
  if (threadIdx.x == 0) {
    for (int w = 0; w < (int)(blockDim.x >> 5); ++w) t += red[w];
  }
  return t;  // on thread 0
}

// One block per chain: ll[c] and G = d ll / d out (times the last layer's
// activation derivative, when it has one that takes it from the output).
__global__ void __launch_bounds__(kThreads)
    gaussian_tail_kernel(const float* __restrict__ out, size_t out_batch,
                         const float* __restrict__ y, const float* __restrict__ sd_c, int nk,
                         int act, float alpha, float* __restrict__ g, size_t g_batch,
                         float* __restrict__ ll) {
  __shared__ float red[kThreads / 32];
  const size_t c = blockIdx.x;
  const float sd = fminf(fmaxf(sd_c[c], 1e-8f), 1e8f);
  const float inv_sd2 = 1.f / (sd * sd);
  float quad = 0.f;
  for (int i = threadIdx.x; i < nk; i += blockDim.x) {
    const float o = out[c * out_batch + i];
    const float r = y[i] - o;
    quad = fmaf(r, r, quad);
    g[c * g_batch + i] = r * inv_sd2 * act_backward(act, o, alpha);
  }
  const float t = block_total(quad, red);
  if (threadIdx.x == 0) {
    const float k = (float)nk;
    ll[c] = -0.5f * (t * inv_sd2 + 2.f * k * logf(sd) + k * kLog2Pi);
  }
}

__global__ void __launch_bounds__(kThreads)
    bernoulli_tail_kernel(const float* __restrict__ out, size_t out_batch,
                          const float* __restrict__ y, int nk, int act, float alpha,
                          float* __restrict__ g, size_t g_batch, float* __restrict__ ll) {
  __shared__ float red[kThreads / 32];
  const size_t c = blockIdx.x;
  float part = 0.f;
  for (int i = threadIdx.x; i < nk; i += blockDim.x) {
    const float o = out[c * out_batch + i], yv = y[i];
    const float pc = fminf(fmaxf(o, kBernLo), kBernHi);
    part += yv * logf(pc) + (1.f - yv) * log1pf(-pc);
    const float gv = (o > kBernLo && o < kBernHi) ? yv / pc - (1.f - yv) / (1.f - pc) : 0.f;
    g[c * g_batch + i] = gv * act_backward(act, o, alpha);
  }
  const float t = block_total(part, red);
  if (threadIdx.x == 0) ll[c] = t;
}

__global__ void __launch_bounds__(kThreads)
    categorical_tail_kernel(const float* __restrict__ out, size_t out_batch,
                            const float* __restrict__ y, int n_rows, int dk, int act, float alpha,
                            float* __restrict__ g, size_t g_batch, float* __restrict__ ll) {
  __shared__ float red[kThreads / 32];
  const size_t c = blockIdx.x;
  float part = 0.f;
  for (int n = threadIdx.x; n < n_rows; n += blockDim.x) {
    const float* z = out + c * out_batch + (size_t)n * dk;
    const float* yr = y + (size_t)n * dk;
    float* gr = g + c * g_batch + (size_t)n * dk;
    float mx = z[0];
    for (int i = 1; i < dk; ++i) mx = fmaxf(mx, z[i]);
    float sum = 0.f;
    for (int i = 0; i < dk; ++i) {
      gr[i] = expf(z[i] - mx);
      sum += gr[i];
    }
    const float inv = 1.f / sum;
    float py = 0.f;
    for (int i = 0; i < dk; ++i) py = fmaf(yr[i], gr[i] * inv, py);
    part += logf(fmaxf(py, kCatLo));
    const bool live = py > kCatLo;
    for (int i = 0; i < dk; ++i) {
      gr[i] = live ? (yr[i] - gr[i] * inv) * act_backward(act, z[i], alpha) : 0.f;
    }
  }
  const float t = block_total(part, red);
  if (threadIdx.x == 0) ll[c] = t;
}

// The slope gradient of a prelu / sqprelu and its derivative, per chain
// (blockIdx.y), 32 features (blockIdx.x) and slice of rows (blockIdx.z, rows
// [z rows_per_slice, min(N, (z + 1) rows_per_slice))): d s_j = sum_n min(a, 0)
// G[n, j] (times 2 s_j for sqprelu) into grad's slope rows, or, split, the
// slice's raw sum into part (n_slices, C, d) for slice_sum_kernel; then G[n, j]
// *= a < 0 ? s_eff : 1 in place. Threads (32, kSlopeRows): a feature per lane,
// rows strided over threadIdx.y, a shared-memory sum over threadIdx.y.
constexpr int kSlopeRows = 16;

__global__ void __launch_bounds__(32 * kSlopeRows)
    slope_grad_kernel(const float* __restrict__ pre, size_t pre_batch, float* __restrict__ g,
                      size_t g_batch, const float* __restrict__ slopes, float* __restrict__ grad,
                      size_t batch, int n_rows, int d, int sq, int rows_per_slice,
                      float* __restrict__ part) {
  __shared__ float part_t[kSlopeRows][33];
  const size_t c = blockIdx.y;
  const int j = blockIdx.x * 32 + threadIdx.x;
  const int lo = blockIdx.z * rows_per_slice, hi = min(n_rows, lo + rows_per_slice);
  float t = 0.f;
  if (j < d) {
    const float s = slopes[c * batch + j];
    const float eff = sq ? s * s : s;
    const float* pc = pre + c * pre_batch + j;
    float* gc = g + c * g_batch + j;
    // four rows at a time, every load issued before the first use; the
    // rows are summed in the order n, n + kSlopeRows, ... as one at a time
    for (int n = lo + threadIdx.y; n < hi; n += 4 * kSlopeRows) {
      float a[4], gv[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int r = n + u * kSlopeRows;
        a[u] = r < hi ? pc[(size_t)r * d] : 0.f;
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) gv[u] = a[u] < 0.f ? gc[(size_t)(n + u * kSlopeRows) * d] : 0.f;
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        if (a[u] < 0.f) {
          t = fmaf(a[u], gv[u], t);
          gc[(size_t)(n + u * kSlopeRows) * d] = gv[u] * eff;
        }
      }
    }
  }
  part_t[threadIdx.y][threadIdx.x] = t;
  __syncthreads();
  if (threadIdx.y == 0 && j < d) {
    for (int r = 1; r < kSlopeRows; ++r) t += part_t[r][threadIdx.x];
    if (part != nullptr) {
      part[((size_t)blockIdx.z * gridDim.y + c) * d + j] = t;
    } else {
      const float s = slopes[c * batch + j];
      grad[c * batch + j] = sq ? 2.f * s * t : t;
    }
  }
}

// The fixed-order reduce of a product or slope pass split over rows: out[c *
// batch + e] = sum over slices, in slice order, of part[(slice C + c) width +
// e], for e < width; with slopes, times 2 s_e for sqprelu (a slope pass).
__global__ void __launch_bounds__(kThreads)
    slice_sum_kernel(const float* __restrict__ part, int n_slices, int width, int C,
                     const float* __restrict__ slopes, int sq, float* __restrict__ out,
                     size_t batch) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)C * width) return;
  const size_t c = i / width;
  const int e = (int)(i - (long long)c * width);
  float t = 0.f;
  for (int s = 0; s < n_slices; ++s) t += part[((size_t)s * C + c) * width + e];
  if (slopes != nullptr && sq) t = 2.f * slopes[c * batch + e] * t;
  out[c * batch + e] = t;
}

template <int MODE>
void launch_gemm(Gemm& p, int C, int n_slices, cudaStream_t stream) {
  p.m_tiles = (p.M + kBM - 1) / kBM;
  const dim3 grid((p.N + kBN - 1) / kBN, p.m_tiles * n_slices, p.pack ? 1 : C);
  if constexpr (MODE != kInputGrad) {
    if (p.pack) {
      gemm_kernel<MODE, true><<<grid, kThreads, 0, stream>>>(p);
      return;
    }
  }
  gemm_kernel<MODE, false><<<grid, kThreads, 0, stream>>>(p);
}

}  // namespace

// thetas (C, D), x (N, d0), y (N, dK) (one-hot for the categorical tail), sd
// (C,) on the card; layers a HOST table of (d_in, d_out, act, row_off,
// slope_off, alpha bits) per dense layer (slope_off the first slope row of a
// following prelu / sqprelu, else -1); plan a HOST table of (packed,
// weight-gradient slices, rows a slice, slope-pass slices, rows a slice) per
// dense layer (ops/fused_mlp.py::PotentialProgram.plan: packed only for the
// first layer, the slices of rows covering [0, N) in order, none empty, one
// slope slice for a layer without slopes); lik 0 Gaussian, 1 Bernoulli, 2
// categorical; work at least C N (sum of d_out + the d_out of every layer with
// slopes + 2 max d_out) floats plus the largest split product's partials
// (slices x C x its rows). Writes ll (C,) and grad (C, D).
extern "C" int tbnn_fused_potential(const float* thetas, const float* x, const float* y,
                                    const float* sd, const int* layers, const int* plan,
                                    int n_layers, int lik, int C, int D, int N, float* work,
                                    long long work_floats, float* ll, float* grad,
                                    void* stream_ptr) {
  if (n_layers < 1 || n_layers > kMaxLayers || C < 1 || C > 65535 || N < 1 ||
      lik < kGaussian || lik > kCategorical) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  constexpr int kCols = 6, kPlanCols = 5;
  size_t plane_off[kMaxLayers], pre_off[kMaxLayers];
  size_t rows = 0, planes = 0, partials = 0;
  int max_d = 0;
  // slices of rows [s r, min(N, (s + 1) r)) that cover [0, N), none empty
  auto slices_ok = [&](int n_slices, int per) {
    return n_slices >= 1 && n_slices <= 65535 && per >= 1 &&
           (long long)(n_slices - 1) * per < N && (long long)n_slices * per >= N;
  };
  for (int l = 0; l < n_layers; ++l) {
    const int* row = layers + kCols * l;
    const int* pl = plan + kPlanCols * l;
    const int d_in = row[0], d_out = row[1], act = row[2];
    if (d_in < 1 || d_out < 1 || act < kNone || act > kSqPrelu ||
        (l > 0 && d_in != layers[kCols * (l - 1) + 1]) || row[3] != (int)rows ||
        has_slopes(act) != (row[4] >= 0)) {
      return (int)cudaErrorInvalidValue;
    }
    if (pl[0] < 0 || pl[0] > 1 || (pl[0] == 1 && (l > 0 || (long long)C * d_out > 0x7fffffff)) ||
        !slices_ok(pl[1], pl[2]) || !slices_ok(pl[3], pl[4]) ||
        (long long)pl[1] * ((d_in + kBM - 1) / kBM) > 65535 ||
        (!has_slopes(act) && pl[3] != 1)) {
      return (int)cudaErrorInvalidValue;
    }
    const size_t layer_rows = (size_t)d_out + (size_t)d_in * d_out;
    if (pl[1] > 1) partials = std::max(partials, (size_t)pl[1] * C * layer_rows);
    if (pl[3] > 1) partials = std::max(partials, (size_t)pl[3] * C * d_out);
    rows += layer_rows;
    if (has_slopes(act)) {
      if (row[4] != (int)rows) return (int)cudaErrorInvalidValue;
      rows += (size_t)d_out;
    }
    plane_off[l] = planes;
    planes += (size_t)C * N * d_out;
    if (d_out > max_d) max_d = d_out;
  }
  // the pre-activation planes of the layers with slopes follow the outputs
  for (int l = 0; l < n_layers; ++l) {
    pre_off[l] = planes;
    if (has_slopes(layers[kCols * l + 2])) planes += (size_t)C * N * layers[kCols * l + 1];
  }
  const size_t g_batch = (size_t)N * max_d;
  if (rows != (size_t)D ||
      (long long)(planes + 2 * (size_t)C * g_batch + partials) > work_floats) {
    return (int)cudaErrorInvalidValue;
  }
  float* g_cur = work + planes;
  float* g_next = g_cur + (size_t)C * g_batch;
  // the partials of one split product at a time: each is reduced before the
  // next product runs, in stream order
  float* part = g_next + (size_t)C * g_batch;
  const int last = n_layers - 1;
  auto alpha_of = [&](int l) {
    float a;
    std::memcpy(&a, layers + kCols * l + 5, sizeof a);
    return a;
  };
  // a layer with slopes takes its derivative in slope_grad_kernel: the
  // product or tail that feeds it writes the raw gradient
  auto epilogue_act = [&](int l) {
    const int act = layers[kCols * l + 2];
    return has_slopes(act) ? (int)kNone : act;
  };
  auto slice_sum = [&](int n_slices, int width, const float* slopes, int sq, float* out) {
    const long long n = (long long)C * width;
    slice_sum_kernel<<<(unsigned)((n + kThreads - 1) / kThreads), kThreads, 0, stream>>>(
        part, n_slices, width, C, slopes, sq, out, D);
  };
  auto slope_pass = [&](int l, float* g) {
    const int* row = layers + kCols * l;
    const int* pl = plan + kPlanCols * l;
    const int d = row[1], sq = row[2] == kSqPrelu;
    const dim3 grid((d + 31) / 32, C, pl[3]);
    slope_grad_kernel<<<grid, dim3(32, kSlopeRows), 0, stream>>>(
        work + pre_off[l], (size_t)N * d, g, g_batch, thetas + row[4], grad + row[4], D, N, d,
        sq, pl[4], pl[3] > 1 ? part : nullptr);
    if (pl[3] > 1) slice_sum(pl[3], d, thetas + row[4], sq, grad + row[4]);
  };

  for (int l = 0; l < n_layers; ++l) {
    const int* row = layers + kCols * l;
    const int d_in = row[0], d_out = row[1];
    const bool packed = plan[kPlanCols * l] == 1;
    Gemm p{};
    p.M = N;
    p.N = packed ? C * d_out : d_out;
    p.K = d_in;
    p.k_slice = d_in;
    p.pack = packed ? d_out : 0;
    p.a = l == 0 ? x : work + plane_off[l - 1];
    p.a_batch = l == 0 ? 0 : (size_t)N * d_in;
    p.lda = d_in;
    p.b = thetas + row[3] + d_out;
    p.b_batch = D;
    p.ldb = d_out;
    p.out = work + plane_off[l];
    p.out_batch = (size_t)N * d_out;
    p.ldo = d_out;
    p.aux = thetas + row[3];
    p.aux_batch = D;
    p.act = row[2];
    p.alpha = alpha_of(l);
    if (has_slopes(row[2])) {
      p.slope = thetas + row[4];
      p.slope_batch = D;
      p.pre = work + pre_off[l];
    }
    launch_gemm<kForward>(p, C, 1, stream);
  }

  const int dk = layers[kCols * last + 1];
  const float* out = work + plane_off[last];
  const size_t out_batch = (size_t)N * dk;
  if (lik == kGaussian) {
    gaussian_tail_kernel<<<C, kThreads, 0, stream>>>(out, out_batch, y, sd, N * dk,
                                                     epilogue_act(last), alpha_of(last), g_cur,
                                                     g_batch, ll);
  } else if (lik == kBernoulli) {
    bernoulli_tail_kernel<<<C, kThreads, 0, stream>>>(out, out_batch, y, N * dk,
                                                      epilogue_act(last), alpha_of(last), g_cur,
                                                      g_batch, ll);
  } else {
    categorical_tail_kernel<<<C, kThreads, 0, stream>>>(out, out_batch, y, N, dk,
                                                        epilogue_act(last), alpha_of(last),
                                                        g_cur, g_batch, ll);
  }
  if (has_slopes(layers[kCols * last + 2])) slope_pass(last, g_cur);

  for (int l = last; l >= 0; --l) {
    const int* row = layers + kCols * l;
    const int* pl = plan + kPlanCols * l;
    const int d_in = row[0], d_out = row[1];
    const float* h_prev = l == 0 ? x : work + plane_off[l - 1];
    const size_t h_batch = l == 0 ? 0 : (size_t)N * d_in;
    const bool packed = pl[0] == 1, split = pl[1] > 1;
    const int layer_rows = d_out + d_in * d_out;

    // dW = H_prev^T G, db = the column sums of G; split over the rows, each
    // slice's partials go to part (slices, C, layer rows) in grad's layout
    Gemm w{};
    w.M = d_in;
    w.N = packed ? C * d_out : d_out;
    w.K = N;
    w.k_slice = split ? pl[2] : N;
    w.pack = packed ? d_out : 0;
    w.a = h_prev;
    w.a_batch = h_batch;
    w.lda = d_in;
    w.b = g_cur;
    w.b_batch = g_batch;
    w.ldb = d_out;
    float* dst = split ? part : grad + row[3];
    w.out = dst + d_out;
    w.out_batch = split ? (size_t)layer_rows : (size_t)D;
    w.ldo = d_out;
    w.col_sum = dst;
    w.slice_stride = split ? (size_t)C * layer_rows : 0;
    launch_gemm<kWeightGrad>(w, C, pl[1], stream);
    if (split) slice_sum(pl[1], layer_rows, nullptr, 0, grad + row[3]);

    if (l > 0) {
      Gemm q{};
      q.M = N;
      q.N = d_in;
      q.K = d_out;
      q.k_slice = d_out;
      q.a = g_cur;
      q.a_batch = g_batch;
      q.lda = d_out;
      q.b = thetas + row[3] + d_out;
      q.b_batch = D;
      q.ldb = d_out;
      q.out = g_next;
      q.out_batch = g_batch;
      q.ldo = d_in;
      q.aux = h_prev;
      q.aux_batch = h_batch;
      q.ldaux = d_in;
      q.act = epilogue_act(l - 1);
      q.alpha = alpha_of(l - 1);
      launch_gemm<kInputGrad>(q, C, 1, stream);
      if (has_slopes(layers[kCols * (l - 1) + 2])) slope_pass(l - 1, g_next);
      float* t = g_cur;
      g_cur = g_next;
      g_next = t;
    }
  }
  return (int)cudaGetLastError();
}
