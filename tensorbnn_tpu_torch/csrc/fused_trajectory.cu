// K1: one whole HMC leapfrog trajectory per chain, in one kernel launch.
//
// Replaces the Pallas kernel tensorbnn_tpu/ops/fused_mlp.py::_trajectory_kernel
// (:425; value+grad _likelihood_value_vg :324, priors prior_vg :485, loop
// :547-586), launched there by make_fused_trajectory (:717).
//
// What bounds it on the H100: latency, the critical path of one leapfrog
// step. A trajectory is a dependent chain of L+1 value-and-grad evaluations,
// each a forward and a backward pass of a narrow dense stack over a handful
// of data rows (the flagship: 1-10-10-10-1, 11 rows, 251 weights, ~7,200
// FMAs), so the card's rates are far away (~0.2% of its float32 rate). What
// sets a chain's time is the serial path through one step: a chain of
// barriers, each behind a phase whose threads run dependent instructions
// with one or two warps per scheduler and nothing to hide their latency
// (~5 cycles an instruction; a phase with one item a thread takes 700-1,000
// cycles on the H100, PERF.md). Going from one block an SM to ~4 barely
// moves the time per evaluation.
//
// What the design does about it: one thread block per chain keeps the whole
// trajectory on one SM. The position q, momentum v, gradient g, every
// activation plane (N, d) of the forward pass and two ping-pong backward
// planes live in shared memory, so nothing but the inputs and the final state
// touches device memory. Each block runs its own chain's L, so per-chain (eps,
// L) is exact without the TPU kernel's wave-front masking. A step has as few
// phases as its data flow needs, each as short as it can be; for the
// flagship's 7 ops, 8 barriers a step (19 in the first design, 21 with U-turn
// recording):
//   - the layer table (ops/fused_mlp.py::_layer_table) fuses each activation
//     into the dense layer before it. The thread that computes a dense output
//     a at (n, j) applies the activation and writes both planes (pre- and
//     post-activation). In the backward pass the input-gradient items of the
//     next dense layer multiply their sum by the activation's derivative
//     before they store, where the table's deriv column says so (the wrapper
//     decides, the entry point refuses a flag that cannot hold). An op that
//     does not follow a dense layer is a layer
//     of its own (d_in = 0), with a pass and a barrier of its own each way;
//     so is a prelu / sqprelu slope pass, which sums over the N rows of a
//     column that is complete only after a barrier;
//   - the Gaussian and Bernoulli tails run in the epilogue of the last
//     forward pass, on the items (idx = tid + k 128 over N dk) that the tail's
//     own loop had, and multiply in the last activation's derivative; the
//     categorical tail needs whole rows and keeps its pass;
//   - the value (the tail's quadratic and logs, the prior's value, the block
//     reduction) runs only where it is read: at i = 0 (lp0) and i = L (lp1),
//     after the forward pass, with the loops and the reduction tree of the
//     first design, so lp keeps its bits;
//   - the leapfrog update adds each row's prior gradient before its kick,
//     each thread walking the prior blocks forward as its rows rise, and runs
//     in the backward's last phase (layer 0's products, rows [0, (d_in + 1)
//     d_out)) where the wrapper passes merge: a thread updates only rows it
//     wrote there or rows written before that phase's start, so the update
//     needs no barrier of its own;
//   - the backward's items are the weight-gradient rows (bias rows first, as
//     a weight row over a column of ones: fmaf(1, g, t) is t + g exactly)
//     and, from a warp boundary, the input-gradient items, so no warp runs
//     both bodies;
//   - a block has 256 threads where a phase has more items than 128 and the
//     fleet's blocks fit the card at once (the wrapper decides), so that the
//     flagship's backward runs one round of items (a fleet in more than one
//     wave runs faster at 128: the tempered flagship at C = 2,048 took 0.74
//     ms at 128 against 1.02 at 256, PERF.md); the value's and the U-turn
//     sum's partials stay on threads 0-127 in the first design's assignment;
//   - inner loops are unrolled by 4, and each item's (n, j) is decoded by a
//     multiply-high with a reciprocal computed once in the set-up, not by an
//     integer division;
//   - the U-turn projection is reduced with no barrier of its own (below).
// Each output element keeps its float operations, in the same order, in one
// thread of the same block, and the two kept reductions keep their per-thread
// partials and their tree: q, v, lp0, lp1 and the U-turn step are bit-equal to
// the first design's (PERF.md).
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
// and :560-574; the driver's trajectory="uturn"): at steps i = 1..L, the block
// sums (q - q0) . v_rec over the rows, where q is the pre-drift position and
// v_rec the kicked momentum plus, at i = L, the other half kick (so the pair
// is (q_i, v_{i+1/2}), as sampler/hmc.py records it). Each value thread adds
// its rows in the update, each value warp reduces its partials by shuffles
// and its lane 0 writes them to slot i & 1 of red_ut; after the barrier that
// ends the update, the block's last warp finishes the sum by block_sum's
// second stage (the same tree, so the same bits) and its lane 0 keeps the
// first i where it is negative, written to ut_out[c] (0 when the chain never
// turned). Two slots suffice: a slot is written again only two update passes
// later. The start q0
// is re-read from the unchanged theta input (L1/L2, read-only): a copy in
// shared memory measured 4-6% slower on the H100. A null ut_out is the
// non-recording kernel, bit for bit the same arithmetic.
//
// Variant (d), the rest of the Pallas kernel's scope (:471-523, :350-418,
// :379-386):
//   - tails: a switch on the likelihood replaces the Gaussian residual. The
//     Gaussian tail takes a fixed sd or the learned one, sd = clip(eta[sd_idx]^2,
//     1e-8, 1e8), read once per block. The Bernoulli tail clips p to [1e-8,
//     1 - 1e-7], with g = y / p - (1 - y) / (1 - p) inside that range and 0
//     outside. The categorical tail runs over the dk logits of each row (one
//     thread per row): max, exp, sum, p, py = sum y p; value log max(py, 1e-8)
//     and g = py > 1e-8 ? y - p : 0 (y one-hot). Every tail scales g and its
//     value by beta when tempered.
//   - ops: leakyrelu (alpha as float bits in the table's 6th column, the
//     derivative from the output as the JAX kernel takes it); prelu and
//     sqprelu read their slope rows from q, and their backward writes
//     sum_n min(x_in, 0) g into those rows of g (times 2 s for sqprelu), one
//     thread per feature summing over the N rows of its column of the kept
//     input plane, then scales g by the slope where x_in < 0.
//   - priors: per block "gauss" (sd = scale^2), "gauss_raw" (sd = scale),
//     "cauchy" (gamma = scale^2; value sign sum log1p(dif^2 / gamma^2) - rows
//     log(pi gamma), gradient sign 2 dif / (gamma^2 + dif^2)) and "exp" (rate =
//     |eta|; value -rate sum s + rows log rate, gradient -rate). The per-block
//     scalars and normalizers are computed once per trajectory.
// The kernel is compiled twice: trajectory_kernel<true> runs every program,
// trajectory_kernel<false> only programs of the Gaussian tail, "gauss" priors
// and the five activations (the flagship's, a learned sd included), with the
// other branches folded away and variant (a)'s set-up expressions; the
// wrapper picks it from the program. It keeps variant (a)'s arithmetic bit
// for bit (the general set-up rounds the normalizers differently by an ulp,
// enough to flip rare MH decisions) and its speed (PERF.md).
//
// Scope of this kernel: dense layers with tanh / relu / sigmoid / exp / elu /
// leakyrelu / prelu / sqprelu activations, the four prior kinds and the three
// tails. The wrapper (ops/fused_mlp.py) checks scope, shapes and the
// shared-memory budget before it launches; the entry point checks the layer
// table.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxLayers = 32;
constexpr int kLayerCols = 7;  // (d_in, d_out, act, row_off, slope_off, alpha bits, deriv)
constexpr int kMaxPrior = 64;
// the threads that hold the value's and the U-turn sum's partials (row or
// item r on thread r % 128): this assignment fixes the sums' bits, whatever
// the block's size
constexpr int kValueThreads = 128, kValueWarps = kValueThreads / 32;
// a block has the value threads or twice as many; at most 64 registers a
// thread, so that an SM holds 4 blocks of the wide size (8 of the narrow)
constexpr int kWideThreads = 2 * kValueThreads, kWideBlocksPerSm = 4;
constexpr float kLog2Pi = 1.8378770664093453f;
constexpr float kPi = 3.14159265358979323846f;
constexpr float kBernLo = 1e-8f, kBernHi = 1.f - 1e-7f, kCatLo = 1e-8f;

enum Act {
  kNone = 0, kTanh = 1, kRelu = 2, kSigmoid = 3, kExp = 4, kElu = 5, kLeaky = 6,
  kPrelu = 7, kSqPrelu = 8
};
enum Lik { kGaussian = 0, kBernoulli = 1, kCategorical = 2 };
enum PriorKind { kGauss = 0, kGaussRaw = 1, kCauchy = 2, kExpRate = 3 };

// the host's layer table, passed by value (__grid_constant__: read in place,
// no copy to local memory)
struct LayerTable {
  int v[kMaxLayers * kLayerCols];
};

struct Layer {
  int d_in;                 // 0: no product, the activation alone on the input plane
  int d_out, act, row_off, slope_off;
  float alpha;              // a leakyrelu's slope
  int in, pre, out;         // float offsets of the input, pre-activation and output planes
  unsigned rcp_in, rcp_out; // multiply-high reciprocals of d_in and d_out
  int deriv;                // the table's deriv: the activation's derivative is
                            // applied where this layer's output gradient is produced
};

struct Program {
  Layer layer[kMaxLayers];
  int prior_kind[kMaxPrior];
  int prior_start[kMaxPrior];  // first flat row of each prior block
  int prior_end[kMaxPrior];    // one past its last row
  float prior_loc[kMaxPrior];  // gauss, cauchy: location; exp: rate
  float prior_a[kMaxPrior];    // gauss: 1 / sd^2; cauchy: gamma^2
  float prior_sign[kMaxPrior]; // cauchy: +1 the reference's flipped form, -1 proper
  float const_term;            // every normalizer of the log posterior
  float const_ll;              // the likelihood's part of const_term
  float inv_sd2;               // the Gaussian tail's 1 / sd^2
  float one;                   // 1: the bias gradient's column of the data
  int n_layers, n_prior, plane_total, max_d, lik;
  float red[33];
  float red_ut[2][kValueWarps];  // the U-turn projection's warp sums, by step parity
};

// The sum over the block of the value threads' partials: each warp by
// shuffles, then warp 0 over the kValueWarps warp sums
__device__ float block_sum(float v, float* red) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    float t = lane < kValueWarps ? red[lane] : 0.f;
    for (int o = 16; o > 0; o >>= 1) t += __shfl_down_sync(0xffffffffu, t, o);
    if (lane == 0) red[32] = t;
  }
  __syncthreads();
  const float total = red[32];
  __syncthreads();
  return total;
}

// idx / d for idx * d < 2^32 (the entry point checks every decoded range): the
// high word of idx * ceil(2^32 / d) is exact there. d = 1 has no 32-bit
// reciprocal and is its own quotient's divisor.
__device__ __forceinline__ int div_rcp(int idx, int d, unsigned rcp) {
  return d == 1 ? idx : (int)__umulhi((unsigned)idx, rcp);
}

__device__ inline unsigned reciprocal(int d) {
  return d > 1 ? (unsigned)((0x100000000ull + (unsigned)d - 1) / (unsigned)d) : 0u;
}

// a = fmaf(x[k sx], y[k sy], a) for k = 0 .. n - 1 in order (unrolled by 4:
// on the H100 this beat chunks of 8 or 4 terms with their loads issued first,
// and the loop not unrolled, PERF.md)
__device__ __forceinline__ float dot(const float* x, int sx, const float* y, int sy, int n,
                                     float a) {
#pragma unroll 4
  for (int k = 0; k < n; ++k) a = fmaf(x[k * sx], y[k * sy], a);
  return a;
}

__device__ inline int align_warp(int n) { return (n + 31) & ~31; }

__host__ __device__ inline bool elementwise(int act) {
  return act != kNone && act != kPrelu && act != kSqPrelu;
}

template <bool kFull>
__device__ __forceinline__ float act_forward(int kind, float a, float alpha) {
  if (kFull && kind == kLeaky) return a < 0.f ? alpha * a : a;
  switch (kind) {
    case kTanh: return tanhf(a);
    case kRelu: return fmaxf(a, 0.f);
    case kSigmoid: return 1.f / (1.f + expf(-a));
    case kExp: return expf(a);
    default: return a > 0.f ? a : expf(a) - 1.f;  // elu
  }
}

// derivative from the activation's input and output
template <bool kFull>
__device__ __forceinline__ float act_backward(int kind, float in, float out, float alpha) {
  if (kFull && kind == kLeaky) return out < 0.f ? alpha : 1.f;
  switch (kind) {
    case kTanh: return 1.f - out * out;
    case kRelu: return out > 0.f ? 1.f : 0.f;
    case kSigmoid: return out * (1.f - out);
    case kExp: return out;
    default: return in > 0.f ? 1.f : expf(in);  // elu
  }
}

// The forward pass with the likelihood tail: every layer's planes stay for
// the backward pass, and beta * d ll / d pred (times the last activation's
// derivative where the table fuses it) lands in ga. With `value` each value
// thread also sums its items' value terms into quad (Gaussian) or lik_part;
// the last layer and the categorical tail run on the value threads alone.
template <bool kFull>
__device__ __forceinline__ void forward(const Program& p, const float* q, float* planes,
                                        float* ga, const float* __restrict__ y, int N,
                                        float lik_scale, float beta, bool value, float& quad,
                                        float& lik_part) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const int n_layers = p.n_layers;
  const bool cat = kFull && p.lik == kCategorical;
  for (int l = 0; l < n_layers; ++l) {
    const Layer& ly = p.layer[l];
    const int d_in = ly.d_in, d_out = ly.d_out, act = ly.act, row_off = ly.row_off;
    const unsigned rcp = ly.rcp_out;
    const float alpha = ly.alpha;
    const float* in = planes + ly.in;
    float* pre = planes + ly.pre;
    float* out = planes + ly.out;
    const float* s = q + max(ly.slope_off, 0);
    const bool last = l == n_layers - 1;
    const bool tail = last && !cat;
    const bool deriv = tail && ly.deriv;
    const int stride = last ? kValueThreads : nt;
    for (int idx = tid; idx < N * d_out && tid < stride; idx += stride) {
      const int n = div_rcp(idx, d_out, rcp), j = idx - n * d_out;
      float a;
      if (d_in > 0) {
        a = dot(in + n * d_in, 1, q + row_off + d_out + j, d_out, d_in, q[row_off + j]);
      } else {
        a = in[idx];
      }
      float o = a;
      if (act != kNone) {
        if (kFull && (act == kPrelu || act == kSqPrelu)) {
          const float sj = s[j];
          const float eff = act == kSqPrelu ? sj * sj : sj;
          o = a < 0.f ? eff * a : a;
        } else {
          o = act_forward<kFull>(act, a, alpha);
        }
        if (d_in > 0) pre[idx] = a;
      }
      out[idx] = o;
      if (tail) {
        float gv;
        if (!kFull || p.lik == kGaussian) {
          const float r = y[idx] - o;
          if (value) quad = fmaf(r, r, quad);
          gv = r * lik_scale;
        } else {  // Bernoulli
          const float yv = y[idx];
          const float pc = fminf(fmaxf(o, kBernLo), kBernHi);
          if (value) lik_part += yv * logf(pc) + (1.f - yv) * log1pf(-pc);
          gv = (o > kBernLo && o < kBernHi) ? beta * (yv / pc - (1.f - yv) / (1.f - pc)) : 0.f;
        }
        if (deriv) gv *= act_backward<kFull>(act, a, o, alpha);
        ga[idx] = gv;
      }
    }
    __syncthreads();
  }
  if (cat) {  // over each row's dk logits, one thread per row
    const int dk = p.layer[n_layers - 1].d_out;
    const float* pred = planes + p.layer[n_layers - 1].out;
    for (int n = tid; n < N && tid < kValueThreads; n += kValueThreads) {
      const float* z = pred + n * dk;
      const float* yr = y + n * dk;
      float* gr = ga + n * dk;
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
      if (value) lik_part += logf(fmaxf(py, kCatLo));
      const bool live = py > kCatLo;
      for (int i = 0; i < dk; ++i) gr[i] = live ? beta * (yr[i] - gr[i] * inv) : 0.f;
    }
    __syncthreads();
  }
}

// The backward pass from the tail's gradient in ga: the likelihood's
// gradient (no prior) into g. With `merge` its last phase, layer 0's
// products, ends without a barrier: the leapfrog update that follows in the
// same phase reads only rows the reading thread wrote or rows written
// before the last barrier.
template <bool kFull>
__device__ __forceinline__ void backward(const Program& p, const float* q, float* g,
                                         const float* planes, float* ga, float* gb, int N,
                                         bool merge) {
  const int tid = threadIdx.x, nt = blockDim.x;
  float* gc = ga;
  float* gn = gb;
  for (int l = p.n_layers - 1; l >= 0; --l) {
    const Layer& ly = p.layer[l];
    const int d_in = ly.d_in, d_out = ly.d_out, act = ly.act;
    if (kFull && (act == kPrelu || act == kSqPrelu)) {
      // each thread owns feature j's column: d s_j = sum_n min(x_in, 0) g,
      // then g *= s_eff where x_in < 0
      const float* in = planes + ly.pre;
      const int base = ly.slope_off;
      for (int j = tid; j < d_out; j += nt) {
        const float sj = q[base + j];
        const float eff = act == kSqPrelu ? sj * sj : sj;
        float t = 0.f;
        for (int n = 0; n < N; ++n) {
          const float xin = in[n * d_out + j];
          if (xin < 0.f) {
            const float gv = gc[n * d_out + j];
            t = fmaf(xin, gv, t);
            gc[n * d_out + j] = gv * eff;
          }
        }
        g[base + j] = act == kSqPrelu ? 2.f * sj * t : t;
      }
      __syncthreads();
    } else if (act != kNone && !ly.deriv) {
      const float* in = planes + ly.pre;
      const float* out = planes + ly.out;
      const float alpha = ly.alpha;
      for (int idx = tid; idx < N * d_out; idx += nt) {
        gc[idx] *= act_backward<kFull>(act, in[idx], out[idx], alpha);
      }
      __syncthreads();
    }
    if (d_in == 0) continue;
    const int base = ly.row_off;
    const unsigned rcp_in = ly.rcp_in, rcp_out = ly.rcp_out;
    const float* in = planes + ly.in;
    const float* w = q + base + d_out;
    // the previous layer's activation derivative, applied to the input
    // gradient before it is stored
    const bool fuse = l > 0 && p.layer[l - 1].deriv;
    const int prev_act = fuse ? p.layer[l - 1].act : kNone;
    const float prev_alpha = fuse ? p.layer[l - 1].alpha : 0.f;
    const float* prev_pre = planes + (fuse ? p.layer[l - 1].pre : 0);
    // the layer's gradient rows r = i' d_out + j (bias rows first, i' = 0,
    // over a column of ones: fmaf(1, g, t) is t + g exactly), then from a
    // warp boundary the input gradient: no warp runs both bodies
    const int n_wg = (d_in + 1) * d_out, x0 = align_warp(n_wg);
    const int n_items = l > 0 ? x0 + N * d_in : n_wg;
    for (int idx = tid; idx < n_items; idx += nt) {
      if (idx < n_wg) {                      // d W_ij = sum_n h[n, i] g[n, j]
        const int i = div_rcp(idx, d_out, rcp_out), j = idx - i * d_out;
        const float* h = i == 0 ? &p.one : in + i - 1;
        g[base + idx] = dot(h, i == 0 ? 0 : d_in, gc + j, d_out, N, 0.f);
      } else if (idx >= x0) {                // g_prev[n, i] = sum_j g[n, j] W_ij
        const int r = idx - x0, n = div_rcp(r, d_in, rcp_in), i = r - n * d_in;
        float t = dot(gc + n * d_out, 1, w + i * d_out, 1, d_out, 0.f);
        if (fuse) t *= act_backward<kFull>(prev_act, prev_pre[r], in[r], prev_alpha);
        gn[r] = t;
      }
    }
    if (l > 0 || !merge) __syncthreads();
    float* tmp = gc;
    gc = gn;
    gn = tmp;
  }
}

// The prior's value partials of this value thread, block by block over the
// flat rows (its gradient is added in the leapfrog update)
template <bool kFull>
__device__ __forceinline__ void prior_value(const Program& p, const float* q,
                                            float& prior_quad, float& prior_other) {
  const int tid = threadIdx.x, nt = kValueThreads;
  if (tid >= nt) return;
  for (int b = 0; b < p.n_prior; ++b) {
    const int kind = p.prior_kind[b], start = p.prior_start[b];
    const int rows = p.prior_end[b] - start;
    const float loc = p.prior_loc[b], a = p.prior_a[b];
    float part = 0.f;
    if (!kFull || kind == kGauss || kind == kGaussRaw) {
      for (int r = tid; r < rows; r += nt) {
        const float dif = q[start + r] - loc;
        part = fmaf(dif, dif, part);
      }
      prior_quad = fmaf(part, a, prior_quad);
    } else if (kind == kCauchy) {
      const float sign = p.prior_sign[b];
      for (int r = tid; r < rows; r += nt) {
        const float dif = q[start + r] - loc, d2 = dif * dif;
        part += log1pf(d2 / a);
      }
      prior_other = fmaf(sign, part, prior_other);
    } else {  // exp: loc holds the rate
      for (int r = tid; r < rows; r += nt) part += q[start + r];
      prior_other = fmaf(-loc, part, prior_other);
    }
  }
}

template <bool kFull>
__global__ void __launch_bounds__(kWideThreads, kWideBlocksPerSm)
    trajectory_kernel(const float* __restrict__ theta, const float* __restrict__ mom,
                                  const float* __restrict__ eta, const float* __restrict__ x,
                                  const float* __restrict__ y, const float* __restrict__ eps_c,
                                  const int* __restrict__ steps_c, const float* __restrict__ beta_c,
                                  const __grid_constant__ LayerTable table, int n_layers,
                                  const int* __restrict__ prior, int n_prior, int D,
                                  int H, int N, int lik, float sd, int sd_idx, bool merge,
                                  float* __restrict__ q_out, float* __restrict__ v_out,
                                  float* __restrict__ lp0_out, float* __restrict__ lp1_out,
                                  int* __restrict__ ut_out) {
  __shared__ Program p;
  extern __shared__ float dyn[];
  const int c = blockIdx.x, tid = threadIdx.x, nt = blockDim.x;
  const float* eta_c = eta + (size_t)c * H;

  if (tid == 0) {
    p.n_layers = n_layers;
    p.n_prior = n_prior;
    p.lik = lik;
    // the planes in order: x, then per layer its product's output (a dense
    // layer) and its activation's output (a layer with an activation)
    int width = table.v[0], off = 0, max_d = width;
    for (int l = 0; l < n_layers; ++l) {
      const int* row = table.v + kLayerCols * l;
      Layer& ly = p.layer[l];
      ly.d_in = row[0];
      ly.d_out = row[1];
      ly.act = row[2];
      ly.row_off = row[3];
      ly.slope_off = row[4];
      ly.alpha = __int_as_float(row[5]);
      ly.deriv = row[6];
      ly.rcp_in = reciprocal(ly.d_in);
      ly.rcp_out = reciprocal(ly.d_out);
      ly.in = off;
      int next = off + N * width;
      if (ly.d_in > 0) {
        ly.pre = next;
        if (ly.act != kNone) next += N * ly.d_out;
      } else {
        ly.pre = off;
      }
      ly.out = next;
      off = next;
      width = ly.d_out;
      max_d = max(max_d, width);
    }
    p.plane_total = off + N * width;
    p.max_d = max_d;
    // the Gaussian tail's sd, learned (eta[sd_idx]^2, clipped) or fixed, and
    // its normalizer over the k = N * dk events
    if (sd_idx >= 0) {
      const float s = eta_c[sd_idx];
      sd = fminf(fmaxf(s * s, 1e-8f), 1e8f);
    }
    p.inv_sd2 = 1.f / (sd * sd);
    p.one = 1.f;
    float cst = lik == kGaussian ? -0.5f * (float)(N * width) * (2.f * logf(sd) + kLog2Pi) : 0.f;
    p.const_ll = cst;
    // one normalizer per prior block (a scalar-sigma gaussian_logprob; the
    // Cauchy and exponential densities' per-row constants)
    int start = 0;
    if constexpr (!kFull) {
      // "gauss" blocks alone, in variant (a)'s expressions
      for (int b = 0; b < n_prior; ++b) {
        const int rows = prior[5 * b + 1];
        const float s = eta_c[prior[5 * b + 3]];
        const float sig = fminf(fmaxf(s * s, 1e-8f), 1e8f);
        p.prior_kind[b] = kGauss;
        p.prior_start[b] = start;
        p.prior_end[b] = start + rows;
        p.prior_loc[b] = eta_c[prior[5 * b + 2]];
        p.prior_a[b] = 1.f / (sig * sig);
        cst -= 0.5f * (2.f * logf(sig) + kLog2Pi);
        start += rows;
      }
    }
    for (int b = 0; kFull && b < n_prior; ++b) {
      const int kind = prior[5 * b], rows = prior[5 * b + 1];
      const float loc = eta_c[prior[5 * b + 2]], s = eta_c[prior[5 * b + 3]];
      p.prior_kind[b] = kind;
      p.prior_start[b] = start;
      p.prior_end[b] = start + rows;
      p.prior_loc[b] = loc;
      p.prior_sign[b] = (float)prior[5 * b + 4];
      if (kind == kGauss || kind == kGaussRaw) {
        const float sig = fminf(fmaxf(kind == kGauss ? s * s : s, 1e-8f), 1e8f);
        p.prior_a[b] = 1.f / (sig * sig);
        cst -= 0.5f * (2.f * logf(sig) + kLog2Pi);
      } else if (kind == kCauchy) {
        const float gam = s * s;
        p.prior_a[b] = gam * gam;
        cst -= (float)rows * logf(kPi * gam);
      } else {
        const float rate = fabsf(loc);
        p.prior_loc[b] = rate;
        cst += (float)rows * logf(rate);
      }
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
  const int d0 = table.v[0];
  for (int r = tid; r < D; r += nt) {
    q[r] = theta[(size_t)c * D + r];
    v[r] = mom[(size_t)c * D + r];
  }
  for (int r = tid; r < N * d0; r += nt) planes[r] = x[r];
  __syncthreads();

  const float eps = eps_c[c];
  const int L = steps_c[c];
  const float beta = beta_c != nullptr ? beta_c[c] : 1.f;
  const float lik_scale = p.inv_sd2 * beta;
  const bool record = ut_out != nullptr;
  const float* q0 = theta + (size_t)c * D;
  const int lane = tid & 31, warp = tid >> 5;
  // the warp that finishes each step's U-turn sum, and keeps ut in its lane
  // 0: the block's last, idle in a forward phase with fewer items than threads
  const int ut_warp = (nt >> 5) - 1;
  // the update's threads: the value threads when recording (the projection's
  // partials), else all. Row r is updated by thread r % upd; layer 0's
  // gradient rows [0, (d_in + 1) d_out) are written in the backward's last
  // phase by thread r % nt. With `merge` (the entry point checks that these
  // are the same thread) the update runs in that phase, with no barrier
  const int upd = record ? kValueThreads : nt;
  float lp0 = 0.f, lp = 0.f;
  int ut = 0;
  // the prior block of this thread's first update row, found once
  int b_first = 0;
  while (b_first + 1 < p.n_prior && tid >= p.prior_end[b_first]) ++b_first;
  for (int i = 0; i <= L; ++i) {
    const bool value = i == 0 || i == L;
    float quad = 0.f, lik_part = 0.f;
    forward<kFull>(p, q, planes, ga, y, N, lik_scale, beta, value, quad, lik_part);
    if (value) {
      // the tail's scale, then the prior's loops and the sum, in the order
      // that fixes lp's bits
      if (!kFull || p.lik == kGaussian) {
        quad *= lik_scale;
      } else {
        lik_part *= beta;
      }
      float prior_quad = 0.f, prior_other = 0.f;
      prior_value<kFull>(p, q, prior_quad, prior_other);
      // beta * const_ll + the prior normalizers, as const_term + (beta - 1) *
      // const_ll: exactly const_term when beta = 1
      const float part = kFull ? -0.5f * (quad + prior_quad) + lik_part + prior_other
                               : -0.5f * (quad + prior_quad);
      lp = block_sum(part, p.red) + p.const_term + (beta - 1.f) * p.const_ll;
      if (i == 0) lp0 = lp;
    }
    backward<kFull>(p, q, g, planes, ga, gb, N, merge);
    const float kick = (i == 0 || i == L) ? 0.5f * eps : eps;
    const bool drift = i < L;
    const bool rec = record && i >= 1;
    const float half_fix = i == L ? 0.5f * eps : 0.f;
    // the leapfrog update, each row's prior gradient added first; prior
    // block b holds rows [prior_start[b], prior_end[b]), and the walk stops
    // at the last block whatever the table says
    float proj = 0.f;
    int b = b_first;
    for (int r = tid; r < D && tid < upd; r += upd) {
      while (b + 1 < p.n_prior && r >= p.prior_end[b]) ++b;
      const float qr = q[r];
      float gr = g[r];
      const int kind = kFull ? p.prior_kind[b] : kGauss;
      if (!kFull || kind == kGauss || kind == kGaussRaw) {
        const float dif = qr - p.prior_loc[b];
        gr -= dif * p.prior_a[b];
      } else if (kind == kCauchy) {
        const float dif = qr - p.prior_loc[b], d2 = dif * dif;
        // __fadd_rn: d2 has no other use here, and fused into this add it
        // would move the gradient by an ulp from the value-and-gradient
        // loop's rounding
        gr += p.prior_sign[b] * 2.f * dif / __fadd_rn(p.prior_a[b], d2);
      } else {
        gr -= p.prior_loc[b];
      }
      const float vr = fmaf(kick, gr, v[r]);
      if (rec) proj = fmaf(qr - q0[r], fmaf(half_fix, gr, vr), proj);
      v[r] = vr;
      if (drift) q[r] = fmaf(eps, vr, qr);
    }
    if (rec && warp < kValueWarps) {
      // block_sum's first stage; its second runs after the barrier
      for (int o = 16; o > 0; o >>= 1) proj += __shfl_down_sync(0xffffffffu, proj, o);
      if (lane == 0) p.red_ut[i & 1][warp] = proj;
    }
    __syncthreads();
    if (rec && warp == ut_warp) {
      float t = lane < kValueWarps ? p.red_ut[i & 1][lane] : 0.f;
      for (int o = 16; o > 0; o >>= 1) t += __shfl_down_sync(0xffffffffu, t, o);
      if (lane == 0 && ut == 0 && t < 0.f) ut = i;
    }
  }

  for (int r = tid; r < D; r += nt) {
    q_out[(size_t)c * D + r] = q[r];
    v_out[(size_t)c * D + r] = v[r];
  }
  if (tid == 0) {
    lp0_out[c] = lp0;
    lp1_out[c] = lp;
  }
  if (record && tid == 32 * ut_warp) ut_out[c] = ut;
}

}  // namespace

// layers: the host's layer table, kLayerCols ints per layer (d_in, d_out, act,
// row_off, slope_off, alpha bits, deriv), as ops/fused_mlp.py's
// TrajectoryProgram.layers builds it: d_in = 0 for an op that does not follow
// a dense layer, act 0 for none, slope_off -1 but for prelu / sqprelu, deriv 1
// where the activation's derivative is applied by the next dense layer's
// input-gradient items or by the Gaussian / Bernoulli tail (no pass of its
// own). merge: the leapfrog update runs in layer 0's backward phase, with no
// barrier of its own. The wrapper decides both; the entry point refuses them
// where they cannot hold. prior: (kind, rows, loc_idx,
// scale_idx, sign) per block, on the device. lik: 0 Gaussian, 1 Bernoulli, 2
// categorical (y one-hot). sd_idx: the eta index of a learned sd, or -1 for
// the fixed sd. full: 0 only for a program of the Gaussian tail, gauss priors
// and the five activations (trajectory_kernel<false>), else 1.
// beta: per-chain inverse temperatures (C,), or null for an untempered run.
// ut_out: each chain's first U-turn step (C,), or null for no recording.
extern "C" int tbnn_fused_trajectory(const float* theta, const float* mom, const float* eta,
                                     const float* x, const float* y, const float* eps,
                                     const int* steps, const float* beta, const int* layers,
                                     int n_layers, const int* prior, int n_prior, int C, int D,
                                     int H, int N, int lik, float sd, int sd_idx, int full,
                                     int merge, int threads, int smem_bytes,
                                     float* q_out, float* v_out, float* lp0_out, float* lp1_out,
                                     int* ut_out, void* stream) {
  if (n_layers < 1 || n_layers > kMaxLayers || n_prior < 1 || n_prior > kMaxPrior ||
      (threads != kValueThreads && threads != kWideThreads) || N < 1 || lik < kGaussian ||
      lik > kCategorical || sd_idx >= H) {
    return (int)cudaErrorInvalidValue;
  }
  if (!full && lik != kGaussian) return (int)cudaErrorInvalidValue;
  // the table: widths chain, theta rows are covered in order, and every
  // range decoded by a multiply-high has index * divisor < 2^32
  LayerTable table;
  long long rows = 0;
  int width = layers[0];
  if (width < 1) return (int)cudaErrorInvalidValue;
  const long long kDecode = 1ll << 32;
  for (int l = 0; l < n_layers; ++l) {
    const int* row = layers + kLayerCols * l;
    const int d_in = row[0], d_out = row[1], act = row[2];
    const bool slopes = act == kPrelu || act == kSqPrelu;
    if (d_out < 1 || act < kNone || act > kSqPrelu || row[3] != rows ||
        slopes != (row[4] >= 0) || (!full && act > kElu)) {
      return (int)cudaErrorInvalidValue;
    }
    if (d_in > 0) {
      if (d_in != width) return (int)cudaErrorInvalidValue;
      rows += (long long)d_out + (long long)d_in * d_out;
    } else if (d_in < 0 || l == 0 || act == kNone || d_out != width) {
      return (int)cudaErrorInvalidValue;
    }
    if (slopes) {
      if (row[4] != rows) return (int)cudaErrorInvalidValue;
      rows += d_out;
    }
    if ((long long)N * d_out * d_out >= kDecode || (long long)(d_in + 1) * d_out * d_out >= kDecode ||
        (long long)N * d_in * d_in >= kDecode) {
      return (int)cudaErrorInvalidValue;
    }
    for (int k = 0; k < kLayerCols; ++k) table.v[kLayerCols * l + k] = row[k];
    width = d_out;
  }
  if (rows != D) return (int)cudaErrorInvalidValue;
  // a derivative is fused only into a dense layer's input-gradient items or
  // a Gaussian / Bernoulli tail, and the update shares layer 0's phase only
  // where each of layer 0's rows is written by the thread that updates it
  for (int l = 0; l < n_layers; ++l) {
    const int deriv = layers[kLayerCols * l + 6];
    const bool last = l == n_layers - 1;
    if (deriv != 0 && (deriv != 1 || !elementwise(layers[kLayerCols * l + 2]) ||
                       (last ? lik == kCategorical : layers[kLayerCols * (l + 1)] < 1))) {
      return (int)cudaErrorInvalidValue;
    }
  }
  if (merge && ut_out != nullptr && (long long)(layers[0] + 1) * layers[1] > kValueThreads) {
    return (int)cudaErrorInvalidValue;
  }
  auto kernel = full ? trajectory_kernel<true> : trajectory_kernel<false>;
  if (smem_bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<C, threads, smem_bytes, static_cast<cudaStream_t>(stream)>>>(
      theta, mom, eta, x, y, eps, steps, beta, table, n_layers, prior, n_prior, D, H, N, lik, sd,
      sd_idx, merge != 0, q_out, v_out, lp0_out, lp1_out, ut_out);
  return (int)cudaGetLastError();
}

extern "C" const char* tbnn_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
