// K2: every hyper-block leapfrog step of one epoch, for every chain, in one
// kernel launch.
//
// Replaces the Pallas kernel tensorbnn_tpu/ops/fused_hyper.py::_hyper_traj_kernel
// (:108; value+grad _stats_vg :45-105), launched there by
// make_fused_hyper_trajectory (:167).
//
// What bounds it on the H100: latency. A chain's hyper state is tiny (H <= 64
// hypers, S <= 64 sufficient statistics), and each of the n_steps + 1
// evaluations is a few dozen scalar operations per item that depend on the
// previous step, five of them IEEE divisions. Memory traffic is one read of
// (eta, momentum, stats) and one write of (q, v) per chain.
//
// What the design does about it: the stats potential separates exactly by
// item. A (loc, scale) pair of a dense block reads only its own two eta rows
// and its own (S1, S2, k) and writes only those two gradient rows; the coupled
// (R, K) term of a learned-sd likelihood reads and writes only its sd row.
// The stats and each chain's eps are fixed for the trajectory, so a chain's
// trajectory is, float operation for float operation, one independent
// trajectory per item. Each item runs on a lane of its own:
//   - the item table (ops/fused_hyper.py, one row per item in the value's
//     order, checked by the entry point) arrives as a kernel parameter; a
//     chain has `lanes` lanes (a power of two, >= its items, <= 32), so
//     32 / lanes chains share a warp;
//   - a lane keeps its two eta rows, their momenta, its statistics and eps in
//     registers, with no stack, no barrier and no trip to device memory
//     between the first load and the last store;
//   - the steps between the ends compute only the gradient; at i = 0 and
//     i = n the lanes also compute their value terms, and every lane of a
//     chain adds them, gathered by __shfl_sync, in the first design's order (per
//     pair the hyperprior term, then the conditional prior's; the coupled term
//     last). Lane 0 of the chain writes lp0 and lp1;
//   - the coupled term runs the pair's operations (its scale terms, with the
//     values that make them the coupled term's), so no warp splits between
//     two paths;
//   - lanes past the last item and chains past C run the same loop on a
//     dummy pair (the shuffles need every lane of the warp) and write
//     nothing.
// Each item's expressions are written as the first design (one thread per
// chain over the whole table) wrote them, so that the compiler contracts them
// the same way and every output keeps its bits; the leapfrog updates, which
// it contracted, are pinned with __fmaf_rn. Where the time goes now: each of
// a pair's five IEEE divisions is a branch region of its own (the range check
// and the call to the slow path), and regions do not overlap.
//
// The potential is the closed-form sufficient-statistics hyper potential
// (sampler/hyper_stats.py), term by term as _stats_vg: N(0, .1) hyperpriors
// on locations, N(1, .1) on squared scales, the clipped-sd conditional prior
// via (S1, S2), the in-range gradient masks of the clip, and, for a learned-sd
// Gaussian likelihood, the coupled (R, K) term. Schedule as the Pallas kernel:
// i = 0 half kick then drift, 0 < i < n full kick then drift, i = n half kick
// without drift.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxH = 64;
constexpr int kMaxS = 64;
constexpr int kMaxItems = 32;
constexpr int kMaxThreads = 1024;
// item table columns: row_a, row_b, col_a, col_b, k. A (loc, scale) pair:
// (loc_row, scale_row, S1's column, S2's column, k); the coupled term:
// (sd_idx, -1, R's column, K's column, 0)
constexpr int kItemCols = 5;
constexpr unsigned kFullMask = 0xffffffffu;
constexpr float kLog2Pi = 1.8378770664093453f;
constexpr float kSdLo = 1e-8f;
constexpr float kSdHi = 1e8f;

struct ItemTable {
  int v[kMaxItems * kItemCols];
};

// One item's gradient and, with kValue, its value terms (lp += t_hyper, then
// lp -= 0.5 t_cond). A (loc, scale) pair of a dense block: loc and x = scale,
// (sa, sb) = (S1, S2), k its count; gradient rows (g_loc, g_x). The coupled
// (R, K) term: x = the sd row, (sa, sb) = (R, K); gradient row g_x. Both run
// the pair's operations, so that a warp never splits between them: the
// coupled term's are the pair's scale terms with the hyperprior's gradient
// set to 0 (0 * 2x + m is m, and 0 + m then rounds a -0 as the first design
// did), R for quad_num and K for the 1 of -1 / sd, 2 log sd and log 2 pi
// (exact for a pair's 1). Each expression keeps the first design's shape.
template <bool kValue>
__device__ __forceinline__ void item_terms(bool pair, float loc, float x, float sa, float sb,
                                           float k, float& g_loc, float& g_x, float& t_hyper,
                                           float& t_cond) {
  const float hyper_const = -2.f * (logf(0.1f) + 0.5f * kLog2Pi);
  const float u = x * x;
  // hyperpriors: N(0, .1) on loc, N(1, .1) on the squared scale
  if (kValue) {
    const float z_loc = loc / 0.1f, z_u = (u - 1.f) / 0.1f;
    t_hyper = -0.5f * (z_loc * z_loc + z_u * z_u) + hyper_const;
  }
  g_loc = 0.f;
  g_loc += -loc / 0.01f;
  const float hyper_x = pair ? -(u - 1.f) / 0.01f : 0.f;
  float g_scale = hyper_x * (2.f * x);
  // conditional prior: sd = clip(x^2), quad = (S2 - 2 loc S1 + k loc^2) / sd^2 for
  // a pair, R / sd^2 for the coupled term
  const bool in_range = u >= kSdLo && u <= kSdHi;
  const float sd = fminf(fmaxf(u, kSdLo), kSdHi);
  const float quad_num = sb - 2.f * loc * sa + k * loc * loc;
  const float num = pair ? quad_num : sa;
  const float kk = pair ? 1.f : sb;
  const float inv_sd2 = 1.f / (sd * sd);
  if (kValue) t_cond = 2.f * kk * logf(sd) + num * inv_sd2 + kk * kLog2Pi;
  g_loc += (sa - k * loc) * inv_sd2;
  const float d_sd = -kk / sd + num * inv_sd2 / sd;
  g_scale += in_range ? d_sd * 2.f * x : 0.f;
  g_x = 0.f;
  g_x += g_scale;
}

// The chain's value from its lanes' terms, added in the table's order. Every
// lane of the warp calls it. 0.5 t_cond is exact, so the subtraction has the
// same bits whether or not it is contracted into an FMA.
__device__ __forceinline__ float gather_value(float t_hyper, float t_cond, int n_items,
                                              int lanes, bool coupled) {
  float lp = 0.f;
  for (int m = 0; m < n_items; ++m) {
    const float th = __shfl_sync(kFullMask, t_hyper, m, lanes);
    const float tc = __shfl_sync(kFullMask, t_cond, m, lanes);
    if (!coupled || m < n_items - 1) lp = __fadd_rn(lp, th);
    lp = __fmaf_rn(-0.5f, tc, lp);
  }
  return lp;
}

__global__ void __launch_bounds__(kMaxThreads)
    hyper_kernel(const float* __restrict__ eta, const float* __restrict__ mom,
                 const float* __restrict__ stats, const float* __restrict__ eps_c,
                 const ItemTable items, int n_items, int coupled, int lanes, int C, int H, int S,
                 int n_steps, float* __restrict__ q_out, float* __restrict__ v_out,
                 float* __restrict__ lp0_out, float* __restrict__ lp1_out) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  const int c = t / lanes;
  const int m = t & (lanes - 1);
  const bool live = c < C && m < n_items;

  // a pair's loc in slot a and scale in slot b; the coupled term's sd row in
  // slot b. A slot no row fills holds a value that keeps each division on its
  // fast path (a division of 0 takes the slow one, which its warp waits for):
  // the coupled term's loc 1; a lane with no item the pair (1, 2), stats
  // (1, 2), k 1 and eps 0, so that it never moves
  int row_a = -1, row_b = -1;
  bool pair = true;
  float qa = 1.f, qb = 2.f, va = 0.f, vb = 0.f, sa = 1.f, sb = 2.f, k = 1.f, eps = 0.f;
  if (live) {
    const int* it = items.v + kItemCols * m;
    pair = it[1] >= 0;
    row_a = pair ? it[0] : -1;
    row_b = pair ? it[1] : it[0];
    if (pair) {
      qa = eta[(size_t)c * H + row_a];
      va = mom[(size_t)c * H + row_a];
    }
    qb = eta[(size_t)c * H + row_b];
    vb = mom[(size_t)c * H + row_b];
    sa = stats[(size_t)c * S + it[2]];
    sb = stats[(size_t)c * S + it[3]];
    k = (float)it[4];
    eps = eps_c[c];
  }

  float lp0 = 0.f, lp1 = 0.f;
  for (int i = 0; i <= n_steps; ++i) {
    float ga, gb;
    const bool end = i == 0 || i == n_steps;
    if (end) {
      float t_hyper, t_cond;
      item_terms<true>(pair, qa, qb, sa, sb, k, ga, gb, t_hyper, t_cond);
      lp1 = gather_value(t_hyper, t_cond, n_items, lanes, coupled);
      if (i == 0) lp0 = lp1;
    } else {
      float unused_hyper, unused_cond;
      item_terms<false>(pair, qa, qb, sa, sb, k, ga, gb, unused_hyper, unused_cond);
    }
    const float kick = end ? 0.5f * eps : eps;
    va = __fmaf_rn(kick, pair ? ga : 0.f, va);  // the coupled term's loc stays 1
    vb = __fmaf_rn(kick, gb, vb);
    if (i < n_steps) {
      qa = __fmaf_rn(eps, va, qa);
      qb = __fmaf_rn(eps, vb, qb);
    }
  }
  if (!live) return;
  if (pair) {
    q_out[(size_t)c * H + row_a] = qa;
    v_out[(size_t)c * H + row_a] = va;
  }
  q_out[(size_t)c * H + row_b] = qb;
  v_out[(size_t)c * H + row_b] = vb;
  if (m == 0) {
    lp0_out[c] = lp0;
    lp1_out[c] = lp1;
  }
}

}  // namespace

// items: the host table, n_items rows of kItemCols. Refused with
// cudaErrorInvalidValue: a table that does not cover each of the H eta rows
// and each of the S stats columns exactly once (a pair's S2 column follows its
// S1 column, K follows R), a coupled term that is not the last row or is
// there without `coupled`, lanes that are not the least power of two at or
// above n_items, or threads that are not whole warps.
extern "C" int tbnn_fused_hyper(const float* eta, const float* mom, const float* stats,
                                const float* eps, const int* items, int n_items, int coupled,
                                int C, int H, int S, int n_steps, int lanes, int threads,
                                float* q_out, float* v_out, float* lp0_out, float* lp1_out,
                                void* stream) {
  if (n_items < 1 || n_items > kMaxItems || H < 1 || H > kMaxH || S < 1 || S > kMaxS ||
      C < 1 || n_steps < 0 || threads < 32 || threads > kMaxThreads || threads % 32 != 0 ||
      lanes < n_items || lanes > 32 || (lanes & (lanes - 1)) != 0 ||
      (lanes > 1 && lanes / 2 >= n_items)) {
    return (int)cudaErrorInvalidValue;
  }
  ItemTable table;
  unsigned long long rows = 0, cols = 0;
  for (int m = 0; m < n_items; ++m) {
    const int* it = items + kItemCols * m;
    const bool pair = it[1] >= 0;
    if (!pair && (!coupled || m != n_items - 1 || it[1] != -1 || it[4] != 0)) {
      return (int)cudaErrorInvalidValue;
    }
    if (it[0] < 0 || it[0] >= H || it[1] >= H || it[2] < 0 || it[3] != it[2] + 1 ||
        it[3] >= S || (pair && it[4] < 0)) {
      return (int)cudaErrorInvalidValue;
    }
    for (int r = 0; r < 2; ++r) {
      if (r == 1 && !pair) break;
      const unsigned long long bit = 1ull << it[r];
      if (rows & bit) return (int)cudaErrorInvalidValue;
      rows |= bit;
    }
    for (int s = 2; s < 4; ++s) {
      const unsigned long long bit = 1ull << it[s];
      if (cols & bit) return (int)cudaErrorInvalidValue;
      cols |= bit;
    }
    for (int j = 0; j < kItemCols; ++j) table.v[kItemCols * m + j] = it[j];
  }
  if (coupled && items[kItemCols * (n_items - 1) + 1] != -1) return (int)cudaErrorInvalidValue;
  const unsigned long long all_rows = H == 64 ? ~0ull : (1ull << H) - 1;
  const unsigned long long all_cols = S == 64 ? ~0ull : (1ull << S) - 1;
  if (rows != all_rows || cols != all_cols) return (int)cudaErrorInvalidValue;
  const long long total = (long long)C * lanes;
  const int grid = (int)((total + threads - 1) / threads);
  hyper_kernel<<<grid, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      eta, mom, stats, eps, table, n_items, coupled, lanes, C, H, S, n_steps, q_out, v_out,
      lp0_out, lp1_out);
  return (int)cudaGetLastError();
}
