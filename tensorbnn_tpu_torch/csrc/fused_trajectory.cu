// K1: one whole HMC leapfrog trajectory per chain, in one kernel launch.
//
// Replaces the Pallas kernel tensorbnn_tpu/ops/fused_mlp.py::_trajectory_kernel
// (:425; value+grad _likelihood_value_vg :324, priors prior_vg :485, loop
// :547-586), launched there by make_fused_trajectory (:717).
//
// What bounds it on the H100: nothing wide. A trajectory is a dependent chain
// of L+1 value-and-grad evaluations, each a forward and a backward pass of a
// narrow dense stack over a handful of data rows (the flagship: 1-10-10-10-1,
// 11 rows, 251 weights), so each step is a few thousand FMAs behind a dozen
// barriers. The kernel is latency-bound on that serial chain and needs only a
// few KB per chain.
//
// What the design does about it: one thread block per chain keeps the whole
// trajectory on one SM. The position q, momentum v, gradient g, every
// activation plane (N, d) of the forward pass and two ping-pong backward
// planes live in shared memory, so nothing but the inputs and the final state
// touches device memory. Threads spread over the outputs of each step: (n, j)
// for a dense forward, bias rows, (i, j) weight rows and (n, i) input rows for
// the backward, flat rows for the priors; block reductions give the log
// posterior. Each block runs its own chain's L, so per-chain (eps, L) is exact
// without the TPU kernel's wave-front masking, and chains that finish early
// free their SM. The op program (layer dims, activation codes) and the prior
// blocks are runtime data, so one compiled kernel serves any in-scope stack.
//
// Iteration schedule (as the Pallas kernel): i = 0 half kick then drift;
// 0 < i < L full kick then drift; i = L half kick, no drift. lp0 is the value
// at i = 0, lp1 the value at the last evaluation (the end point).
//
// Tempered variant (parallel tempering's power posterior, the Pallas kernel's
// tempered=True program, :451-456 and :525-530): a per-chain inverse
// temperature beta[c] scales the likelihood and nothing else. Block c reads
// beta[c] once; beta is folded into the residual's gradient (so the backward
// pass carries it and the prior's gradient stays unscaled) and into the value
// as beta * (quad_ll + const_ll) + prior. lp0 and lp1 are then the tempered
// log posteriors that the caller's MH test needs. A null beta is the
// untempered kernel (beta = 1, bit for bit the same arithmetic).
//
// U-turn-recording variant (the Pallas kernel's record_uturn program, :449-450
// and :560-574; the driver's trajectory="uturn"): at steps i = 1..L, after the
// kick, the block reduces (q - q0) . v_rec with block_sum, where q is the
// pre-drift position and v_rec the kicked momentum plus, at i = L, the other
// half kick (so the pair is (q_i, v_{i+1/2}), as sampler/hmc.py records it).
// Thread 0 keeps the first i where the sum is negative and writes it to
// ut_out[c], 0 when the chain never turned. v_rec is formed in the kick's own
// pass over the rows, so recording adds one block reduction per step. The
// start q0 is re-read from the unchanged theta input (L1/L2, read-only): a
// copy in shared memory measured 4-6% slower on the H100. A null ut_out is
// the non-recording kernel, bit for bit the same arithmetic.
//
// Scope of this kernel: dense layers with tanh / relu / sigmoid / exp / elu
// activations, Gaussian priors (sd = scale^2, clipped to [1e-8, 1e8]) and a
// fixed-sd Gaussian likelihood. The wrapper (ops/fused_mlp.py) checks scope,
// shapes and the shared-memory budget before it launches.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxOps = 32;
constexpr int kMaxPrior = 64;
constexpr float kLog2Pi = 1.8378770664093453f;

enum OpKind { kDense = 0, kTanh = 1, kRelu = 2, kSigmoid = 3, kExp = 4, kElu = 5 };

struct Program {
  int ops[kMaxOps * 3];        // (kind, d_in, d_out) per op
  int plane_off[kMaxOps + 1];  // float offset of op k's input plane
  int row_off[kMaxOps];        // first flat theta row of op k
  int prior_start[kMaxPrior];  // first flat row of each prior block
  int prior_rows[kMaxPrior];
  float prior_loc[kMaxPrior];
  float prior_iv[kMaxPrior];   // 1 / sd^2 of each prior block
  float const_term;            // every normalizer of the log posterior
  float const_ll;              // the likelihood's part of const_term
  int n_ops, n_prior, plane_total, max_d;
  float red[33];
};

__device__ float block_sum(float v, float* red) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    const int n_warps = (blockDim.x + 31) >> 5;
    float t = lane < n_warps ? red[lane] : 0.f;
    for (int o = 16; o > 0; o >>= 1) t += __shfl_down_sync(0xffffffffu, t, o);
    if (lane == 0) red[32] = t;
  }
  __syncthreads();
  const float total = red[32];
  __syncthreads();
  return total;
}

__device__ __forceinline__ float act_forward(int kind, float a) {
  switch (kind) {
    case kTanh: return tanhf(a);
    case kRelu: return fmaxf(a, 0.f);
    case kSigmoid: return 1.f / (1.f + expf(-a));
    case kExp: return expf(a);
    default: return a > 0.f ? a : expf(a) - 1.f;  // elu
  }
}

// derivative from the activation's input and output
__device__ __forceinline__ float act_backward(int kind, float in, float out) {
  switch (kind) {
    case kTanh: return 1.f - out * out;
    case kRelu: return out > 0.f ? 1.f : 0.f;
    case kSigmoid: return out * (1.f - out);
    case kExp: return out;
    default: return in > 0.f ? 1.f : expf(in);  // elu
  }
}

// Log posterior (likelihood tempered by beta) at q; writes its gradient into
// g. planes[0 .. N*d0) holds x.
__device__ float value_and_grad(Program& p, const float* q, float* g,
                                float* planes, float* ga, float* gb,
                                const float* __restrict__ y, int N,
                                float inv_sd2, float beta) {
  const int tid = threadIdx.x, nt = blockDim.x;

  // forward: every op's output plane stays for the backward pass
  for (int k = 0; k < p.n_ops; ++k) {
    const int kind = p.ops[3 * k], d_in = p.ops[3 * k + 1], d_out = p.ops[3 * k + 2];
    const float* in = planes + p.plane_off[k];
    float* out = planes + p.plane_off[k + 1];
    if (kind == kDense) {
      const float* b = q + p.row_off[k];
      const float* w = b + d_out;
      for (int idx = tid; idx < N * d_out; idx += nt) {
        const int n = idx / d_out, j = idx - n * d_out;
        const float* h = in + n * d_in;
        float a = b[j];
        for (int i = 0; i < d_in; ++i) a = fmaf(h[i], w[i * d_out + j], a);
        out[idx] = a;
      }
    } else {
      for (int idx = tid; idx < N * d_out; idx += nt) out[idx] = act_forward(kind, in[idx]);
    }
    __syncthreads();
  }

  // fixed-sd Gaussian likelihood: value terms and beta * d ll / d pred
  const int dk = p.ops[3 * (p.n_ops - 1) + 2];
  const float* pred = planes + p.plane_off[p.n_ops];
  const float lik_scale = inv_sd2 * beta;
  float quad = 0.f;
  for (int idx = tid; idx < N * dk; idx += nt) {
    const float r = y[idx] - pred[idx];
    quad = fmaf(r, r, quad);
    ga[idx] = r * lik_scale;
  }
  quad *= lik_scale;
  __syncthreads();

  // backward
  float* gc = ga;
  float* gn = gb;
  for (int k = p.n_ops - 1; k >= 0; --k) {
    const int kind = p.ops[3 * k], d_in = p.ops[3 * k + 1], d_out = p.ops[3 * k + 2];
    const float* in = planes + p.plane_off[k];
    if (kind == kDense) {
      const int base = p.row_off[k];
      const float* w = q + base + d_out;
      const int n_b = d_out, n_w = d_in * d_out, n_x = k > 0 ? N * d_in : 0;
      for (int idx = tid; idx < n_b + n_w + n_x; idx += nt) {
        float t = 0.f;
        if (idx < n_b) {                       // d b_j = sum_n g[n, j]
          for (int n = 0; n < N; ++n) t += gc[n * d_out + idx];
          g[base + idx] = t;
        } else if (idx < n_b + n_w) {          // d W_ij = sum_n h[n, i] g[n, j]
          const int r = idx - n_b, i = r / d_out, j = r - i * d_out;
          for (int n = 0; n < N; ++n) t = fmaf(in[n * d_in + i], gc[n * d_out + j], t);
          g[base + d_out + r] = t;
        } else {                               // g_prev[n, i] = sum_j g[n, j] W_ij
          const int r = idx - n_b - n_w, n = r / d_in, i = r - n * d_in;
          for (int j = 0; j < d_out; ++j) t = fmaf(gc[n * d_out + j], w[i * d_out + j], t);
          gn[r] = t;
        }
      }
      __syncthreads();
      float* tmp = gc;
      gc = gn;
      gn = tmp;
    } else {
      const float* out = planes + p.plane_off[k + 1];
      for (int idx = tid; idx < N * d_out; idx += nt) gc[idx] *= act_backward(kind, in[idx], out[idx]);
      __syncthreads();
    }
  }

  // Gaussian priors, block by block over the flat rows
  float prior_quad = 0.f;
  for (int b = 0; b < p.n_prior; ++b) {
    const int start = p.prior_start[b], rows = p.prior_rows[b];
    const float loc = p.prior_loc[b], iv = p.prior_iv[b];
    float part = 0.f;
    for (int r = tid; r < rows; r += nt) {
      const float dif = q[start + r] - loc;
      part = fmaf(dif, dif, part);
      g[start + r] -= dif * iv;
    }
    prior_quad = fmaf(part, iv, prior_quad);
  }
  // beta * const_ll + the prior normalizers, as const_term + (beta - 1) *
  // const_ll: exactly const_term when beta = 1
  return block_sum(-0.5f * (quad + prior_quad), p.red) + p.const_term +
         (beta - 1.f) * p.const_ll;
}

__global__ void trajectory_kernel(const float* __restrict__ theta, const float* __restrict__ mom,
                                  const float* __restrict__ eta, const float* __restrict__ x,
                                  const float* __restrict__ y, const float* __restrict__ eps_c,
                                  const int* __restrict__ steps_c, const float* __restrict__ beta_c,
                                  const int* __restrict__ ops, int n_ops, const int* __restrict__ prior, int n_prior, int D,
                                  int H, int N, float sd, float* __restrict__ q_out,
                                  float* __restrict__ v_out, float* __restrict__ lp0_out,
                                  float* __restrict__ lp1_out, int* __restrict__ ut_out) {
  __shared__ Program p;
  extern __shared__ float dyn[];
  const int c = blockIdx.x, tid = threadIdx.x, nt = blockDim.x;
  const float* eta_c = eta + (size_t)c * H;

  for (int i = tid; i < 3 * n_ops; i += nt) p.ops[i] = ops[i];
  __syncthreads();
  if (tid == 0) {
    p.n_ops = n_ops;
    p.n_prior = n_prior;
    int dim = p.ops[1], row = 0, max_d = dim;
    p.plane_off[0] = 0;
    for (int k = 0; k < n_ops; ++k) {
      p.row_off[k] = row;
      p.plane_off[k + 1] = p.plane_off[k] + N * dim;
      const int d_in = p.ops[3 * k + 1], d_out = p.ops[3 * k + 2];
      if (p.ops[3 * k] == kDense) row += d_out + d_in * d_out;
      dim = d_out;
      max_d = max(max_d, dim);
    }
    p.plane_total = p.plane_off[n_ops] + N * dim;
    p.max_d = max_d;
    // normalizers: one per prior block (scalar-sigma gaussian_logprob) and
    // the likelihood's k = N * dk events
    float cst = -0.5f * (float)(N * dim) * (2.f * logf(sd) + kLog2Pi);
    p.const_ll = cst;
    int start = 0;
    for (int b = 0; b < n_prior; ++b) {
      const int rows = prior[4 * b + 1];
      const float s = eta_c[prior[4 * b + 3]];
      const float sig = fminf(fmaxf(s * s, 1e-8f), 1e8f);
      p.prior_start[b] = start;
      p.prior_rows[b] = rows;
      p.prior_loc[b] = eta_c[prior[4 * b + 2]];
      p.prior_iv[b] = 1.f / (sig * sig);
      cst -= 0.5f * (2.f * logf(sig) + kLog2Pi);
      start += rows;
    }
    p.const_term = cst;
  }
  __syncthreads();

  float* q = dyn;
  float* v = q + D;
  float* g = v + D;
  float* planes = g + D;
  float* ga = planes + p.plane_total;
  float* gb = ga + N * p.max_d;
  const int d0 = p.ops[1];
  for (int r = tid; r < D; r += nt) {
    q[r] = theta[(size_t)c * D + r];
    v[r] = mom[(size_t)c * D + r];
  }
  for (int r = tid; r < N * d0; r += nt) planes[r] = x[r];
  __syncthreads();

  const float eps = eps_c[c];
  const int L = steps_c[c];
  const float beta = beta_c != nullptr ? beta_c[c] : 1.f;
  const float inv_sd2 = 1.f / (sd * sd);
  const bool record = ut_out != nullptr;
  const float* q0 = theta + (size_t)c * D;
  float lp0 = 0.f, lp = 0.f;
  int ut = 0;
  for (int i = 0; i <= L; ++i) {
    lp = value_and_grad(p, q, g, planes, ga, gb, y, N, inv_sd2, beta);
    if (i == 0) lp0 = lp;
    const float kick = (i == 0 || i == L) ? 0.5f * eps : eps;
    const bool drift = i < L;
    if (record && i >= 1) {
      const float half_fix = i == L ? 0.5f * eps : 0.f;
      float proj = 0.f;
      for (int r = tid; r < D; r += nt) {
        const float gr = g[r], qr = q[r];
        const float vr = fmaf(kick, gr, v[r]);
        proj = fmaf(qr - q0[r], fmaf(half_fix, gr, vr), proj);
        v[r] = vr;
        if (drift) q[r] = fmaf(eps, vr, qr);
      }
      // block_sum's barriers also end the pass over the rows
      proj = block_sum(proj, p.red);
      if (ut == 0 && proj < 0.f) ut = i;
    } else {
      for (int r = tid; r < D; r += nt) {
        const float vr = fmaf(kick, g[r], v[r]);
        v[r] = vr;
        if (drift) q[r] = fmaf(eps, vr, q[r]);
      }
      __syncthreads();
    }
  }

  for (int r = tid; r < D; r += nt) {
    q_out[(size_t)c * D + r] = q[r];
    v_out[(size_t)c * D + r] = v[r];
  }
  if (tid == 0) {
    lp0_out[c] = lp0;
    lp1_out[c] = lp;
    if (record) ut_out[c] = ut;
  }
}

}  // namespace

// beta: per-chain inverse temperatures (C,), or null for an untempered run.
// ut_out: each chain's first U-turn step (C,), or null for no recording.
extern "C" int tbnn_fused_trajectory(const float* theta, const float* mom, const float* eta,
                                     const float* x, const float* y, const float* eps,
                                     const int* steps, const float* beta, const int* ops, int n_ops,
                                     const int* prior, int n_prior, int C, int D, int H, int N,
                                     float sd, int threads, int smem_bytes, float* q_out,
                                     float* v_out, float* lp0_out, float* lp1_out, int* ut_out,
                                     void* stream) {
  if (n_ops < 1 || n_ops > kMaxOps || n_prior > kMaxPrior || threads % 32 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  if (smem_bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        trajectory_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (e != cudaSuccess) return (int)e;
  }
  trajectory_kernel<<<C, threads, smem_bytes, static_cast<cudaStream_t>(stream)>>>(
      theta, mom, eta, x, y, eps, steps, beta, ops, n_ops, prior, n_prior, D, H, N, sd, q_out,
      v_out, lp0_out, lp1_out, ut_out);
  return (int)cudaGetLastError();
}

extern "C" const char* tbnn_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
