// K5: K complete ADAPTIVE training iterations (embedded ARK trial loop
// under the basic controller, one-step MSE, gated stage-exact reverse,
// Adam) in one persistent cooperative launch.
//
// Replaces pnode_tpu/ops/fused_adaptive_loop.py: _kernel (:262), with
// _ark_trial (:123) and _ark_adjoint (:173), launched by
// fused_adaptive_train_loop (:607). Scope: K4's (ksponly, a frozen linear
// implicit part, f_EX = sign * MLP) with a SYMMETRIC J given by its
// eigenbasis (lam, Q), the basic controller, one output window [0, t_end].
// Per iteration k, from y0 = y_stack[k] and dt = the previous iteration's
// first accepted dt (the dt_first warm start):
//
//   trial n:  dt_try = max(min(dt, t_end - t), 0)
//             M = Q diag(1 / (1 - dt_try gamma lam)) Q^T   (stage inverse)
//             y1, err = ARK step of y with kI = Y J^T (not (Y - G)/(dt a_ii))
//             enorm = sqrt(mean((err / (atol + rtol max(|y|, |y1|)))^2))
//             accept = enorm <= 1 or dt_try <= 1e-14 t_end
//             fac = clip(safety exp(-log(max(enorm, 1e-10)) / (order + 1)),
//                        facmin, facmax), at most 1 after a rejection
//             dt <- dt fac; on accept t += dt_try, y = y1, landed when
//             t >= t_end - 1e-10 max(|t_end|, 1)
//   loss = mean((y_landed - tgt)^2); lam = 2 (y_landed - tgt) / (B d)
//   reverse: the accepted trials, last to first, each transposed from its
//            stored stage values (K3's body); rejected trials are identities
//   Adam (optax's form, K4's phase B)
//
// What bounds it on the H100: with the dt_first warm start a KS window
// (B 256, rtol = atol = 1e-4) takes ~3 accepted trials, so one iteration
// is ~3 K2-sized forward steps (~45 us each on an H100), ~3 K3-sized
// reverse steps (~120 us each), one stage inverse per trial and per
// reverse, one grid barrier per trial and one Adam update: latency-bound
// small products.
//
// Design: K4's plan and bodies (ark::forward_step, ark::reverse_step,
// csrc/ark_tiles.cuh), R rows per block, the grid capped at one block per
// SM, blocks striding over the row tiles past it.
// - The trial forward is forward_step with the embedded error output and
//   kI = Y J^T (kJY). It writes y1 to one of two (B, d) state buffers in
//   device memory (the other holds the current state), the stage values to
//   the trial's slot of a (max_trials, s, B, d) store (8.4 MB at KS with 32
//   trials: the reverse reads them as K3 does, with no replay; a replay
//   would cost one more forward step per accepted trial), and err to
//   shared memory. Each block reads and writes only its own rows there, so
//   its own stores are what it reads back.
// - The trial's stage inverse M = Q diag(w) Q^T is formed by each block in
//   fp32, M[i][j] = sum_k (Q_ik Q_jk) w_k, exactly symmetric, so the
//   forward's G M^T and the reverse's q M read the same matrix, straight
//   into the plan's resident inv region (at stride ld_op), where J is staged
//   once per launch. Q^T comes from device memory (the wrapper passes it
//   transposed, so a warp's reads are coalesced). The plan takes only
//   layouts with inv and J resident: wherever the gate
//   (fused_adaptive_loop_fits) opens, they are.
// - The accept test is a reduction over the WHOLE batch, once per trial:
//   each block writes its partial sum of squares to a slot, grid.sync(),
//   and every thread of the grid sums the slots in block order, so every
//   block reads the bit-identical enorm and takes the same accept and dt
//   decision (no atomics: their order would make the decision change from
//   run to run). The slots are double-buffered by trial parity, so one
//   barrier per trial suffices: a block rewrites a slot set only after the
//   next barrier, when every block has read it. The controller's scalar
//   math runs redundantly in every thread; a trial's dt_try and its
//   decision live in shared memory, the same in every block.
// - dt changes per trial inside the launch, so the tableau is scaled on the
//   device in fp32 (scale_tableau) into shared memory.
// - The reverse walks the accepted trials, last to first, each block over
//   its row tiles with reverse_step, carrying its rows of lam in a (B, d)
//   buffer; the dW/db partials and phase B are K4's. Weights and biases
//   are read through L2 (kCoherent), as K4's.
#include <cooperative_groups.h>

#include <cmath>
#include <cstdint>

#include "ark_tiles.cuh"

namespace cg = cooperative_groups;

namespace pnode {

constexpr int kAdaptReduce = 32;  // per-warp partial sums
constexpr int kStatCols = 6;      // loss, accepted, rejected, completed,
                                  // dt_first, dt_last
// floats of the shared Tableau, rounded up to a 16-byte multiple
constexpr int kTabFloats = ((int)sizeof(Tableau) + 15) / 16 * 4;

// The controller's constants, rounded to fp32 from the host's doubles as
// the reference's Python floats are.
struct Controller {
  float rtol, atol, safety, facmin, facmax;
  float neg_expo;  // -1 / (order + 1)
  float t_end;
  float tiny;      // 1e-14 t_end: a trial this short is accepted
  float land;      // t_end - 1e-10 max(|t_end|, 1): the landing bound
  float e_floor;   // 1e-10
  float gamma;     // the ESDIRK diagonal
  float inv_count, two_inv_count;  // 1 / (B d), 2 / (B d)
  int max_trials;
};

// Floats of the block's trial header, ahead of the plan's regions: the
// trial's tableau, the weights w (d), the warp sums, and per trial its
// dt_try and decision.
__host__ __device__ inline int adapt_head(int d, int max_trials) {
  return kTabFloats + ark::round4(d) + kAdaptReduce +
         ark::round4(2 * max_trials);
}

// Floats of the device workspace: the stage store (max_trials, s, B, d),
// two state buffers and lam (B, d each).
static inline long long adapt_ws_floats(int B, int d, int s,
                                        int max_trials) {
  return ((long long)max_trials * s + 3) * B * d;
}

// jnp.minimum / jnp.maximum: a NaN operand propagates (fminf and fmaxf
// would return the other one).
__device__ __forceinline__ float nan_min(float a, float b) {
  return (a != a || b != b) ? a + b : fminf(a, b);
}
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a || b != b) ? a + b : fmaxf(a, b);
}

// The trial's coefficients (scale_tableau, one thread) and its stage
// inverse M = Q diag(w) Q^T, w = 1 / (1 - (dt gamma) lam), in fp32 with the
// reference's roundings, into M (shared) at row stride ldm; Qt = Q^T in
// device memory. Starts and ends with a barrier.
__device__ __forceinline__ void prepare_trial(const Tableau& base, float dt,
                                              const Controller& c,
                                              const float* __restrict__ Qt,
                                              const float* __restrict__ lamv,
                                              int d, Tableau* tb, float* w,
                                              float* M, int ldm) {
  __syncthreads();  // every thread is done with the previous tb and M
  if (threadIdx.x == 0) scale_tableau(base, dt, tb);
  const float dtg = __fmul_rn(dt, c.gamma);
  for (int k = threadIdx.x; k < d; k += ark::kThreads)
    w[k] = __fdiv_rn(1.0f, __fsub_rn(1.0f, __fmul_rn(dtg, __ldg(lamv + k))));
  __syncthreads();
  for (int e = threadIdx.x; e < d * d; e += ark::kThreads) {
    const int i = e / d, j = e - (e / d) * d;
    float acc = 0.0f;
    for (int k = 0; k < d; ++k)
      acc = fmaf(__fmul_rn(__ldg(Qt + k * d + i), __ldg(Qt + k * d + j)),
                 w[k], acc);
    M[i * ldm + j] = acc;
  }
  __syncthreads();
}

template <int R>
__global__ void __launch_bounds__(ark::kThreads, 1)
adaptive_loop_kernel(const float* __restrict__ y_stack,
                     const float* __restrict__ tgt_stack,
                     const float* __restrict__ Qt,
                     const float* __restrict__ lamv, float* params,
                     float* m_state, float* v_state, float* partial,
                     float* lpart, float* eslot, float* ws, float* stats,
                     float* dt_io, int K, int B, float sign, ark::StepArgs a,
                     ark::RevPlan q, Adam adam, Controller ctl, int t0) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(16) float smem[];
  const Tableau& base = a.tb;  // the coefficients at dt = 1
  const int d = a.m.dims[0];
  const int s = base.s;
  Tableau* tb = reinterpret_cast<Tableau*>(smem);
  float* w = smem + kTabFloats;
  float* red = w + ark::round4(d);
  float* rdt = red + kAdaptReduce;  // dt_try per trial
  int* racc = reinterpret_cast<int*>(rdt + ctl.max_trials);  // accepted
  float* lam_s = smem + q.o_lam;
  float* err = smem + q.o_lp;  // the trial's err rows (lam_prev's region)
  const float* yb = smem + a.p.o_y;  // the trial's input rows
  float* M = smem + q.o_op;  // the trial's stage inverse, then J
  const int ntiles = (B + R - 1) / R;
  const size_t plane = (size_t)B * d;
  float* ysws = ws;  // (max_trials, s, B, d)
  float* ybuf = ysws + (size_t)ctl.max_trials * s * plane;  // 2 x (B, d)
  float* lamws = ybuf + 2 * plane;                          // (B, d)
  const int slice = ark::round4(a.m.wtotal);
  float* part = partial + (size_t)blockIdx.x * slice;
  const int gtid = blockIdx.x * blockDim.x + threadIdx.x;

  // J, once per launch
  ark::copy_cols(M + ark::round4(d * q.ld_op), q.ld_op, a.J, d, d, 0, d);
  ark::cp_async_commit();
  ark::cp_async_wait<0>();
  float dt_carry = __ldcg(dt_io);

  for (int k = 0; k < K; ++k) {
    const float* y0 = y_stack + (size_t)k * plane;
    const float* tgt = tgt_stack + (size_t)k * plane;
    // the state: y0 (cur -1) or state buffer cur
    auto state = [&](int cur) -> const float* {
      return cur < 0 ? y0 : ybuf + (size_t)cur * plane;
    };

    // ---- forward: the trial loop, grid-uniform ----------------------------
    float t = 0.0f, dt = dt_carry, dt_first = 0.0f;
    bool done = false, rejprev = false, have_first = false;
    int n_acc = 0, n_rej = 0, cur = -1, n = 0;
    for (; n < ctl.max_trials && !done; ++n) {
      const float dt_try = nan_max(nan_min(dt, ctl.t_end - t), 0.0f);
      prepare_trial(base, dt_try, ctl, Qt, lamv, d, tb, w, M, q.ld_op);
      const float* ypre = state(cur);
      const int nxt = cur == 0 ? 1 : 0;
      float* ynew = ybuf + (size_t)nxt * plane;
      float* ys = ysws + (size_t)n * s * plane;
      float esum = 0.0f;
      for (int tt = blockIdx.x; tt < ntiles; tt += gridDim.x) {
        const int rows = min(R, B - tt * R);
        const size_t row0 = (size_t)tt * R * d;
        ark::forward_step<R, true, true>(a, *tb, ypre + row0, ynew + row0,
                                         ys + row0, plane, err, rows, sign,
                                         false, smem);
        __syncthreads();
        // each thread reads back the y1 it wrote (forward_step's mapping)
        for (int e = threadIdx.x; e < rows * d; e += ark::kThreads) {
          const float y1 = ynew[row0 + e];
          const float sc = __fadd_rn(
              ctl.atol, __fmul_rn(ctl.rtol, fmaxf(fabsf(yb[e]), fabsf(y1))));
          const float r = err[e] / sc;
          esum = fmaf(r, r, esum);
        }
        __syncthreads();
      }
      const float bsum = block_sum(esum, red);
      float* slots = eslot + (size_t)(n & 1) * gridDim.x;
      if (threadIdx.x == 0) slots[blockIdx.x] = bsum;
      grid.sync();
      float total = 0.0f;
      for (int blk = 0; blk < (int)gridDim.x; ++blk)
        total += __ldcg(slots + blk);
      const float enorm = sqrtf(__fmul_rn(total, ctl.inv_count));

      // the controller (adaptive.trial_step_core), on the same numbers in
      // every thread of the grid
      const bool accept = enorm <= 1.0f || dt_try <= ctl.tiny;
      const float e_cur = nan_max(enorm, ctl.e_floor);
      float fac = __fmul_rn(ctl.safety,
                            expf(__fmul_rn(ctl.neg_expo, logf(e_cur))));
      fac = nan_min(nan_max(fac, ctl.facmin), ctl.facmax);
      if (rejprev) fac = nan_min(fac, 1.0f);
      dt = __fmul_rn(dt, fac);
      rejprev = !accept;
      if (threadIdx.x == 0) {
        rdt[n] = dt_try;
        racc[n] = accept;
      }
      if (accept) {
        t = __fadd_rn(t, dt_try);
        cur = nxt;
        ++n_acc;
        if (!have_first) {
          dt_first = dt_try;
          have_first = true;
        }
        done = t >= ctl.land;
      } else {
        ++n_rej;
      }
    }
    const bool completed = done;
    const float dt_last = dt;
    if (!have_first) dt_first = dt_last;
    const int n_trials = n;

    // ---- loss and seed: y at the landing, or y0 when the axis ran out -----
    const float* yout = completed ? state(cur) : y0;
    float lsum = 0.0f;
    for (int tt = blockIdx.x; tt < ntiles; tt += gridDim.x) {
      const size_t off = (size_t)tt * R * d;
      const int n_el = min(R, B - tt * R) * d;
      for (int e = threadIdx.x; e < n_el; e += ark::kThreads) {
        const float diff = yout[off + e] - tgt[off + e];
        lsum = fmaf(diff, diff, lsum);
        lamws[off + e] = ctl.two_inv_count * diff;
      }
    }

    // ---- reverse: the accepted trials, last to first ----------------------
    // (without a landing nothing seeds lam, and the gradient is zero). The
    // barrier publishes thread 0's last trial record to the block.
    __syncthreads();
    bool add = false;
    for (int mt = completed ? n_trials - 1 : -1; mt >= 0; --mt) {
      if (!racc[mt]) continue;  // a rejected trial reverses as the identity
      prepare_trial(base, rdt[mt], ctl, Qt, lamv, d, tb, w, M, q.ld_op);
      const float* ys = ysws + (size_t)mt * s * plane;
      for (int tt = blockIdx.x; tt < ntiles; tt += gridDim.x) {
        const int rows = min(R, B - tt * R);
        const size_t row0 = (size_t)tt * R * d;
        for (int e = threadIdx.x; e < rows * d; e += ark::kThreads)
          lam_s[e] = lamws[row0 + e];
        __syncthreads();
        // (M and J are resident: the reverse reads them there)
        ark::reverse_step<R, true>(q, a.m, *tb, a.J, nullptr, lam_s,
                                   ys + row0, plane, lamws + row0, part, rows,
                                   sign, false, add, smem);
        add = true;
      }
    }
    if (!add)  // no accepted trial (or row tile) reached the MLP
      for (int e = threadIdx.x; e < a.m.wtotal; e += ark::kThreads)
        part[e] = 0.0f;
    const float block_loss = block_sum(lsum, red);
    if (threadIdx.x == 0) lpart[blockIdx.x] = block_loss;
    grid.sync();

    // ---- phase B: ordered sum of the partials, then Adam (K4's) -----------
    sum_partials_adam(adam, t0 + k + 1, partial, a.m.wtotal, slice, params,
                      m_state, v_state);
    if (gtid == 0) {
      float l = 0.0f;
      for (int blk = 0; blk < (int)gridDim.x; ++blk)
        l += __ldcg(lpart + blk);
      float* row = stats + (size_t)k * kStatCols;
      row[0] = l * ctl.inv_count;
      row[1] = (float)n_acc;
      row[2] = (float)n_rej;
      row[3] = completed ? 1.0f : 0.0f;
      row[4] = dt_first;
      row[5] = dt_last;
    }
    grid.sync();
    dt_carry = dt_first;
  }
  if (gtid == 0) dt_io[0] = dt_carry;
}

// K5's plan: plan_rev's (kRevAdapt, after the trial header; `rows` 0, or
// 1, 2, 4 or 8 forced) with the grid capped at one block per SM, refused
// where inv and J are not resident. 0 or a CUDA error code.
static int adapt_plan(int B, int d, int s, int n_layers, const int* dims,
                      int max_trials, int rows, ark::RevPlan* q,
                      ark::Plan* f) {
  if (B < 1 || s < 1 || s > kMaxStages || n_layers < 1 ||
      n_layers > kMaxLayers || max_trials < 1 || dims[0] != d ||
      dims[n_layers] != d)
    return cudaErrorInvalidValue;
  for (int l = 0; l <= n_layers; ++l)
    if (dims[l] < 1) return cudaErrorInvalidValue;
  int sms, rc;
  if ((rc = ark::sm_count(&sms))) return rc;
  if (!ark::plan_rev(B, d, s, n_layers, dims, sms, ark::kRevAdapt, rows, q, f,
                     adapt_head(d, max_trials)) ||
      !q->resident)
    return cudaErrorInvalidValue;
  if (q->grid > sms) q->grid = f->grid = sms;
  return 0;
}

}  // namespace pnode

using namespace pnode;

extern "C" {

// K5's plan for y (B, d), s stages, the stack dims[0..n_layers] and
// max_trials: rows per block, grid, shared-memory bytes and the device
// workspace's floats (mirrored by ops/fused_adaptive_loop.py's
// adaptive_loop_plan). rows_in: 0 for the plan's rows, or 1, 2, 4 or 8
// forced. cudaErrorInvalidValue when the configuration does not fit.
int pnode_adaptive_loop_plan(int B, int d, int s, int n_layers,
                             const int* dims, int max_trials, int rows_in,
                             int* rows, int* grid, long long* smem,
                             long long* ws_floats) {
  ark::RevPlan q;
  ark::Plan f;
  const int rc =
      adapt_plan(B, d, s, n_layers, dims, max_trials, rows_in, &q, &f);
  if (rc) return rc;
  *rows = q.rows;
  *grid = q.grid;
  *smem = (long long)q.smem;
  *ws_floats = adapt_ws_floats(B, d, s, max_trials);
  return 0;
}

// K adaptive iterations on y_stack, tgt_stack (K, B, d). J and Qt (d, d),
// lamv (d): the frozen symmetric J and its eigenbasis, passed transposed
// (J = Q diag(lamv) Q^T, Qt = Q^T row-major). params, m, v: flat [W0, b0,
// W1, b1, ...] buffers, updated in place. Scratch at the plan's grid:
// partial (grid slices of round4(wtotal) floats, `partial_floats`), lpart
// (grid), eslot (2 grid), ws (the plan's `ws_floats`); a size that differs
// from the plan's is refused (cudaErrorInvalidValue). stats: K rows of
// (loss, accepted, rejected, completed, dt_first, dt_last). dt_io: the
// first iteration's dt on entry, the last iteration's dt_first on return
// (the next call's warm start). tab: host doubles aI (s*s), aE (s*s), bI
// (s), bE (s); err_tab: bI_err (s), bE_err (s). expo = 1 / (order + 1).
// rows: 0 for the plan's rows per block, or 1, 2, 4 or 8 forced. One
// cooperative launch on `stream`.
int pnode_adaptive_loop(const float* y_stack, const float* tgt_stack,
                        const float* J, const float* Qt, const float* lamv,
                        float* params, float* m_state, float* v_state,
                        float* partial, float* lpart, float* eslot,
                        float* ws, float* stats, float* dt_io, int K, int B,
                        int d, int s, const double* tab,
                        const double* err_tab, double gamma, float sign,
                        int n_layers, const int* dims, int act, int t0,
                        float lr, double b1, double b2, double eps,
                        int max_trials, double rtol, double atol,
                        double safety, double facmin, double facmax,
                        double expo, double t_end, int rows,
                        long long partial_floats, long long ws_floats,
                        void* stream) {
  if (K < 1 || err_tab == nullptr) return cudaErrorInvalidValue;
  ark::StepArgs a;
  a.J = J;
  a.inv = nullptr;  // formed per trial in shared memory
  int rc = flat_mlp(&a.m, params, n_layers, dims, d, act);
  if (rc) return rc;
  // the coefficients at dt = 1: the kernel scales them per trial
  if ((rc = make_tableau(&a.tb, s, tab, 1.0, err_tab))) return rc;
  ark::RevPlan q;
  if ((rc = adapt_plan(B, d, s, n_layers, dims, max_trials, rows, &q, &a.p)))
    return rc;
  if (partial_floats != (long long)q.grid * ark::round4(a.m.wtotal) ||
      ws_floats != adapt_ws_floats(B, d, s, max_trials))
    return cudaErrorInvalidValue;
  Adam adam = make_adam(lr, b1, b2, eps);
  Controller ctl;
  ctl.rtol = (float)rtol;
  ctl.atol = (float)atol;
  ctl.safety = (float)safety;
  ctl.facmin = (float)facmin;
  ctl.facmax = (float)facmax;
  ctl.neg_expo = (float)(-expo);
  ctl.t_end = (float)t_end;
  ctl.tiny = (float)(1e-14 * t_end);
  ctl.land = (float)(t_end - 1e-10 * std::fmax(std::fabs(t_end), 1.0));
  ctl.e_floor = (float)1e-10;
  ctl.gamma = (float)gamma;
  ctl.inv_count = (float)(1.0 / ((double)B * d));
  ctl.two_inv_count = (float)(2.0 / ((double)B * d));
  ctl.max_trials = max_trials;
  void* args[] = {(void*)&y_stack, (void*)&tgt_stack, (void*)&Qt,
                  (void*)&lamv,    (void*)&params,    (void*)&m_state,
                  (void*)&v_state, (void*)&partial,   (void*)&lpart,
                  (void*)&eslot,   (void*)&ws,        (void*)&stats,
                  (void*)&dt_io,   (void*)&K,         (void*)&B,
                  (void*)&sign,    (void*)&a,         (void*)&q,
                  (void*)&adam,    (void*)&ctl,       (void*)&t0};
  const cudaStream_t st = (cudaStream_t)stream;
  switch (q.rows) {
    case 1:
      return launch_cooperative(adaptive_loop_kernel<1>, q.grid, q.smem,
                                args, st);
    case 2:
      return launch_cooperative(adaptive_loop_kernel<2>, q.grid, q.smem,
                                args, st);
    case 4:
      return launch_cooperative(adaptive_loop_kernel<4>, q.grid, q.smem,
                                args, st);
    default:
      return launch_cooperative(adaptive_loop_kernel<8>, q.grid, q.smem,
                                args, st);
  }
}

}  // extern "C"
