// K3: the likelihood's value and gradient for a fleet of chains, once per call.
//
// Replaces the Pallas kernel tensorbnn_tpu/ops/fused_mlp.py::_potential_kernel
// (:157), launched there by make_fused_potential_vg (:993) and gated by
// try_build_fused_main_vg (:1113). Like it, this computes the likelihood half
// of the log posterior only; the caller adds the priors.
//
// What it computes, per chain c of C: the flat state thetas[c] holds, per dense
// layer, d_out bias rows then the row-major (d_in, d_out) weights. The forward
// pass runs H_l = act_l(H_{l-1} W_l + b_l) from the shared data x (N, d0); the
// Gaussian tail gives ll = -0.5 (sum (y - out)^2 / sd^2 + 2 k log sd + k log 2 pi)
// with sd clamped to [1e-8, 1e8] and k = N dK (fused_mlp.py:231-236); the
// hand-written backward pass writes d ll / d theta into grad (C, D).
//
// What bounds it on the H100: the floating-point operations. At the 10x256
// wide_deep model (N = 128 rows, 64 chains) one call is 27.9 GFLOP of float32
// multiply-adds against 303 MB of state read and gradient written: 0.42 ms at
// the 67 TFLOP/s of float32 outside the tensor cores, against 0.09 ms at
// 3.35 TB/s.
//
// What the design does about it: the TPU kernel puts chains on the 128 lanes
// and keeps every plane of a chain block in VMEM. A wide chain's planes do not
// fit on chip here (one 128 x 256 plane is 128 KB, and there are ten), so this
// is a family of batched tile kernels with fused epilogues whose planes live in
// a device-memory workspace that the caller allocates:
//   - forward, per layer: A[c] = H[c] W[c] + b[c], the layer's activation in
//     the epilogue; the first layer's H is the shared x;
//   - the Gaussian tail: the per-chain ll and G = (y - out) / sd^2;
//   - backward, per layer in reverse: dW[c] = H_prev[c]^T G[c] written straight
//     into grad's weight rows, db[c] = sum_n G[c] summed by the first row of
//     tiles from the G tiles they stage anyway, and G_prev[c] = G[c] W[c]^T
//     times the previous activation's derivative in the epilogue (skipped for
//     the first layer, as the TPU kernel skips it with `first`).
// Every product is one kernel template: 64 x 64 output tiles, depth 16, staged
// through double-buffered shared memory, a 4 x 4 register micro-tile per
// thread, full float32 FFMA (no TF32, no tensor cores). Ragged edges are
// masked, so the narrow flagship (N = 11, widths 1 and 10) runs the same code.
// One call makes 3 L launches for L dense layers (L forward, 1 tail, L weight
// gradients, L - 1 input gradients). A faster design (wgmma, TMA-fed tiles, a
// persistent kernel over the layers) is later work.
//
// The activation derivatives come from each activation's output, which is
// what the forward pass keeps: tanh 1 - h^2, relu [h > 0], sigmoid h (1 - h),
// exp h, elu h > 0 ? 1 : h + 1 (= exp(a) for a <= 0).

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kMaxLayers = 64;
constexpr float kLog2Pi = 1.8378770664093453f;

enum Act { kNone = 0, kTanh = 1, kRelu = 2, kSigmoid = 3, kExp = 4, kElu = 5 };
enum Mode { kForward = 0, kWeightGrad = 1, kInputGrad = 2 };

constexpr int kBM = 64, kBN = 64, kBK = 16, kThreads = 256, kPad = 4;

__device__ __forceinline__ float act_forward(int act, float a) {
  switch (act) {
    case kTanh: return tanhf(a);
    case kRelu: return fmaxf(a, 0.f);
    case kSigmoid: return 1.f / (1.f + expf(-a));
    case kExp: return expf(a);
    case kElu: return a > 0.f ? a : expf(a) - 1.f;
    default: return a;
  }
}

// derivative from the activation's output h
__device__ __forceinline__ float act_backward(int act, float h) {
  switch (act) {
    case kTanh: return 1.f - h * h;
    case kRelu: return h > 0.f ? 1.f : 0.f;
    case kSigmoid: return h * (1.f - h);
    case kExp: return h;
    case kElu: return h > 0.f ? 1.f : h + 1.f;
    default: return 1.f;
  }
}

// One batched product out[c] = A[c] B[c] (M x N, depth K) over blockIdx.z = c.
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
};

// MODE kForward:    A = H (N x d_in, k-contiguous), B = W (d_in x d_out).
// MODE kWeightGrad: A = H_prev^T (d_in x N, read from H_prev), B = G (N x d_out).
// MODE kInputGrad:  A = G (N x d_out), B = W^T (d_out x d_in, read from W).
template <int MODE>
__global__ void __launch_bounds__(kThreads) gemm_kernel(Gemm p) {
  constexpr bool kAk = MODE != kWeightGrad;  // A(m, k) contiguous in k
  constexpr bool kBn = MODE != kInputGrad;   // B(k, n) contiguous in n
  __shared__ __align__(16) float As[2][kBK][kBM + kPad];
  __shared__ __align__(16) float Bs[2][kBK][kBN + kPad];

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const size_t c = blockIdx.z;
  const float* __restrict__ a = p.a + c * p.a_batch;
  const float* __restrict__ b = p.b + c * p.b_batch;

  // each thread stages 4 elements of each tile; neighbouring threads take
  // neighbouring addresses along the contiguous axis
  float ra[4], rb[4];
  auto a_coord = [&](int e, int& mm, int& kk) {
    const int idx = tid + e * kThreads;
    if (kAk) { kk = idx % kBK; mm = idx / kBK; } else { mm = idx % kBM; kk = idx / kBM; }
  };
  auto b_coord = [&](int e, int& kk, int& nn) {
    const int idx = tid + e * kThreads;
    if (kBn) { nn = idx % kBN; kk = idx / kBN; } else { kk = idx % kBK; nn = idx / kBK; }
  };
  auto load = [&](int k0) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      int mm, kk, nn, kb;
      a_coord(e, mm, kk);
      b_coord(e, kb, nn);
      const int m = m0 + mm, ka = k0 + kk, n = n0 + nn, kq = k0 + kb;
      ra[e] = (m < p.M && ka < p.K)
                  ? (kAk ? a[(size_t)m * p.lda + ka] : a[(size_t)ka * p.lda + m])
                  : 0.f;
      rb[e] = (n < p.N && kq < p.K)
                  ? (kBn ? b[(size_t)kq * p.ldb + n] : b[(size_t)n * p.ldb + kq])
                  : 0.f;
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
  const bool sum_cols = MODE == kWeightGrad && blockIdx.y == 0 && ty == 0;

  int buf = 0;
  load(0);
  store(0);
  __syncthreads();
  for (int k0 = 0; k0 < p.K; k0 += kBK) {
    const bool more = k0 + kBK < p.K;
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

  float* __restrict__ out = p.out + c * p.out_batch;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
    if (m >= p.M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n >= p.N) continue;
      float v = acc[i][j];
      if (MODE == kForward) v = act_forward(p.act, v + p.aux[c * p.aux_batch + n]);
      if (MODE == kInputGrad && p.act != kNone) {
        v *= act_backward(p.act, p.aux[c * p.aux_batch + (size_t)m * p.ldaux + n]);
      }
      out[(size_t)m * p.ldo + n] = v;
    }
  }
  if (MODE == kWeightGrad && sum_cols) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n < p.N) p.col_sum[c * p.out_batch + n] = col[j];
    }
  }
}

// One block per chain: ll[c] and G = d ll / d out (times the last layer's
// activation derivative, when it has one).
__global__ void __launch_bounds__(kThreads)
    gaussian_tail_kernel(const float* __restrict__ out, size_t out_batch,
                         const float* __restrict__ y, const float* __restrict__ sd_c, int nk,
                         int act, float* __restrict__ g, size_t g_batch,
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
    float gv = r * inv_sd2;
    if (act != kNone) gv *= act_backward(act, o);
    g[c * g_batch + i] = gv;
  }
  for (int o = 16; o > 0; o >>= 1) quad += __shfl_down_sync(0xffffffffu, quad, o);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = quad;
  __syncthreads();
  if (threadIdx.x == 0) {
    float t = 0.f;
    for (int w = 0; w < (int)(blockDim.x >> 5); ++w) t += red[w];
    const float k = (float)nk;
    ll[c] = -0.5f * (t * inv_sd2 + 2.f * k * logf(sd) + k * kLog2Pi);
  }
}

dim3 tiles(int M, int N, int C) {
  return dim3((N + kBN - 1) / kBN, (M + kBM - 1) / kBM, C);
}

}  // namespace

// thetas (C, D), x (N, d0), y (N, dK), sd (C,) on the card; layers a HOST
// table of (d_in, d_out, act) per dense layer; work at least
// C N (sum of d_out + 2 max d_out) floats. Writes ll (C,) and grad (C, D).
extern "C" int tbnn_fused_potential(const float* thetas, const float* x, const float* y,
                                    const float* sd, const int* layers, int n_layers, int C,
                                    int D, int N, float* work, long long work_floats,
                                    float* ll, float* grad, void* stream_ptr) {
  if (n_layers < 1 || n_layers > kMaxLayers || C < 1 || C > 65535 || N < 1) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  size_t row_off[kMaxLayers], plane_off[kMaxLayers];
  size_t rows = 0, planes = 0;
  int max_d = 0;
  for (int l = 0; l < n_layers; ++l) {
    const int d_in = layers[3 * l], d_out = layers[3 * l + 1], act = layers[3 * l + 2];
    if (d_in < 1 || d_out < 1 || act < kNone || act > kElu ||
        (l > 0 && d_in != layers[3 * (l - 1) + 1])) {
      return (int)cudaErrorInvalidValue;
    }
    row_off[l] = rows;
    rows += (size_t)d_out + (size_t)d_in * d_out;
    plane_off[l] = planes;
    planes += (size_t)C * N * d_out;
    if (d_out > max_d) max_d = d_out;
  }
  const size_t g_batch = (size_t)N * max_d;
  if (rows != (size_t)D || (long long)(planes + 2 * (size_t)C * g_batch) > work_floats) {
    return (int)cudaErrorInvalidValue;
  }
  float* g_cur = work + planes;
  float* g_next = g_cur + (size_t)C * g_batch;
  const int last = n_layers - 1;

  for (int l = 0; l < n_layers; ++l) {
    const int d_in = layers[3 * l], d_out = layers[3 * l + 1];
    Gemm p{};
    p.M = N;
    p.N = d_out;
    p.K = d_in;
    p.a = l == 0 ? x : work + plane_off[l - 1];
    p.a_batch = l == 0 ? 0 : (size_t)N * d_in;
    p.lda = d_in;
    p.b = thetas + row_off[l] + d_out;
    p.b_batch = D;
    p.ldb = d_out;
    p.out = work + plane_off[l];
    p.out_batch = (size_t)N * d_out;
    p.ldo = d_out;
    p.aux = thetas + row_off[l];
    p.aux_batch = D;
    p.act = layers[3 * l + 2];
    gemm_kernel<kForward><<<tiles(N, d_out, C), kThreads, 0, stream>>>(p);
  }

  const int dk = layers[3 * last + 1];
  gaussian_tail_kernel<<<C, kThreads, 0, stream>>>(work + plane_off[last], (size_t)N * dk, y, sd,
                                                   N * dk, layers[3 * last + 2], g_cur, g_batch,
                                                   ll);

  for (int l = last; l >= 0; --l) {
    const int d_in = layers[3 * l], d_out = layers[3 * l + 1];
    const float* h_prev = l == 0 ? x : work + plane_off[l - 1];
    const size_t h_batch = l == 0 ? 0 : (size_t)N * d_in;

    Gemm w{};
    w.M = d_in;
    w.N = d_out;
    w.K = N;
    w.a = h_prev;
    w.a_batch = h_batch;
    w.lda = d_in;
    w.b = g_cur;
    w.b_batch = g_batch;
    w.ldb = d_out;
    w.out = grad + row_off[l] + d_out;
    w.out_batch = D;
    w.ldo = d_out;
    w.col_sum = grad + row_off[l];
    gemm_kernel<kWeightGrad><<<tiles(d_in, d_out, C), kThreads, 0, stream>>>(w);

    if (l > 0) {
      Gemm q{};
      q.M = N;
      q.N = d_in;
      q.K = d_out;
      q.a = g_cur;
      q.a_batch = g_batch;
      q.lda = d_out;
      q.b = thetas + row_off[l] + d_out;
      q.b_batch = D;
      q.ldb = d_out;
      q.out = g_next;
      q.out_batch = g_batch;
      q.ldo = d_in;
      q.aux = h_prev;
      q.aux_batch = h_batch;
      q.ldaux = d_in;
      q.act = layers[3 * (l - 1) + 2];
      gemm_kernel<kInputGrad><<<tiles(N, d_in, C), kThreads, 0, stream>>>(q);
      float* t = g_cur;
      g_cur = g_next;
      g_next = t;
    }
  }
  return (int)cudaGetLastError();
}
