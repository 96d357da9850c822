// K5: K complete ADAPTIVE training iterations (embedded ARK trial loop
// under the basic controller, one-step MSE, gated stage-exact reverse,
// Adam) in one persistent cooperative launch.
//
// Replaces pnode_tpu/ops/fused_adaptive_loop.py: _kernel (:262), with
// _ark_trial (:123) and _ark_adjoint (:173), launched by
// fused_adaptive_train_loop (:462). Scope: K4's (ksponly, a frozen linear
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
//   reverse: the accepted trials, last to first, each replayed from its
//            recorded pre-step state and transposed (K3's body); rejected
//            trials are identities
//   Adam (optax's form, K4's phase B)
//
// What bounds it on the H100: with the dt_first warm start a KS window
// (B 256, rtol = atol = 1e-4) takes 3 accepted trials, so one iteration is
// 3 K2-sized forward steps plus 3 replays and K3-sized reverse steps, one
// stage inverse per trial and per replay, and one grid-wide reduction per
// trial: latency-bound small products on 32 blocks, as K2-K4.
//
// Design: one cooperative launch (all blocks co-resident), blocks of 8 rows
// striding over the row tiles, as K4. The accept test is a reduction over
// the WHOLE batch, once per trial: each block writes its partial sum of
// squares to a slot, grid.sync(), and every thread of the grid sums the
// slots in block order, so every block reads the bit-identical enorm and
// takes the same accept and dt decision (no atomics: their order would
// make the decision change from run to run). The slots are double-buffered
// by trial parity, so one barrier per trial suffices: a block rewrites a
// slot set only after the next barrier, when every block has read it. The
// controller's scalar math runs redundantly in every thread. The trial loop
// ends when the window has landed, in every block at the same trial (the
// TPU kernel runs the rest of its static trial axis as masked no-ops; the
// outputs are the same). The state of trial n is a slot of a (max_trials,
// B, d) device workspace (2.1 MB at KS with 32 trials, L2-resident; each
// block reads and writes only its own rows), so the records are never
// register values (the TPU's unrolled loop spilled 131 MB of vregs); a
// trial's scalars (dt_try, pre-step slot or -1 when rejected) live in
// shared memory, the same in every block. dt changes per trial inside the
// launch, so the tableau is scaled on the device in fp32 (scale_tableau),
// and each block forms the trial's stage inverse M in shared memory: one
// (d, d) product per trial and per replay, with M[i][j] = sum_k (Q_ik
// Q_jk) w_k exactly symmetric, so the forward's G M^T and the reverse's
// q M read the same matrix. The reverse walks the accepted trials trial by
// trial, each block over its tiles, carrying its rows of lam in a (B, d)
// workspace; the dW/db partials and phase B are K4's.
#include <cooperative_groups.h>

#include <cmath>
#include <cstdint>

#include "pnode_kernels.cuh"

namespace cg = cooperative_groups;

namespace pnode {

constexpr int kAdaptReduce = 32;  // per-warp partial sums
constexpr int kStatCols = 6;      // loss, accepted, rejected, completed,
                                  // dt_first, dt_last

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

// jnp.minimum / jnp.maximum: a NaN operand propagates (fminf and fmaxf
// would return the other one).
__device__ __forceinline__ float nan_min(float a, float b) {
  return (a != a || b != b) ? a + b : fminf(a, b);
}
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a || b != b) ? a + b : fmaxf(a, b);
}

// Shared-memory layout of one block, in floats: the trial's tableau, Q^T,
// the trial's stage inverse M and its weights w, the s stage values, lam
// and lam_prev (persistent), the forward's or the reverse's scratch
// (overlaid), the reduction scratch, then the trial records.
struct AdaptSmem {
  int tile, tab, work, total;
  __host__ __device__ AdaptSmem(int d, int s, int maxd, int htotal,
                                int max_trials) {
    tile = kRows * d;
    tab = ((int)sizeof(Tableau) + 15) / 16 * 4;
    const int fwd = tile * (2 * s + 4) + 2 * kRows * maxd;  // y, kI, kE, G,
                                                            // y1, err, a, b
    const int rev = tile * (s + 4) + htotal + 2 * kRows * maxd;  // xis, u,
                                                      // uh, pv, q, hs, gA, gB
    work = fwd > rev ? fwd : rev;
    total = tab + 2 * d * d + d + tile * (s + 2) + work + kAdaptReduce +
            2 * max_trials;
  }
};

// The trial's coefficients (scale_tableau, one thread) and its stage inverse
// M = Q diag(w) Q^T, w = 1 / (1 - (dt gamma) lam), in fp32 with the
// reference's roundings; Qt = Q^T in shared memory (bank-conflict-free
// reads). Every thread returns after a barrier.
__device__ __forceinline__ void prepare_trial(const Tableau& base, float dt,
                                              const Controller& c,
                                              const float* Qt,
                                              const float* __restrict__ lamv,
                                              int d, Tableau* tb, float* w,
                                              float* M) {
  __syncthreads();  // every thread is done with the previous tb and M
  if (threadIdx.x == 0) scale_tableau(base, dt, tb);
  const float dtg = __fmul_rn(dt, c.gamma);
  for (int k = threadIdx.x; k < d; k += blockDim.x)
    w[k] = __fdiv_rn(1.0f, __fsub_rn(1.0f, __fmul_rn(dtg, __ldg(lamv + k))));
  __syncthreads();
  for (int e = threadIdx.x; e < d * d; e += blockDim.x) {
    const int i = e / d, j = e % d;
    float acc = 0.0f;
    for (int k = 0; k < d; ++k)
      acc = fmaf(__fmul_rn(Qt[k * d + i], Qt[k * d + j]), w[k], acc);
    M[e] = acc;
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads)
adaptive_loop_kernel(const float* __restrict__ y_stack,
                     const float* __restrict__ tgt_stack,
                     const float* __restrict__ J, const float* __restrict__ Q,
                     const float* __restrict__ lamv, float* params,
                     float* m_state, float* v_state, float* partial,
                     float* lpart, float* eslot, float* yws, float* lamws,
                     float* stats, float* dt_io, int K, int B, int d,
                     Tableau base, float sign, Mlp p, Adam adam,
                     Controller ctl, int t0) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ float smem[];
  const int s = base.s;
  const AdaptSmem lay(d, s, p.maxd, p.htotal, ctl.max_trials);
  const int tile = lay.tile;
  Tableau* tb = reinterpret_cast<Tableau*>(smem);
  float* Qt = smem + lay.tab;
  float* M = Qt + d * d;
  float* w = M + d * d;
  float* Ys = w + d;                  // s tiles: the stage values
  float* lam = Ys + s * tile;
  float* lp = lam + tile;
  float* work = lp + tile;
  // trial forward scratch
  float* yv = work;
  float* kI = yv + tile;
  float* kE = kI + s * tile;
  float* G = kE + s * tile;
  float* y1s = G + tile;
  float* errs = y1s + tile;
  float* a = errs + tile;
  float* b = a + kRows * p.maxd;
  // reverse scratch (overlays the forward's)
  float* xis = work;
  float* u = xis + s * tile;
  float* uh = u + tile;
  float* pv = uh + tile;
  float* q = pv + tile;
  float* hs = q + tile;
  float* gA = hs + p.htotal;
  float* gB = gA + kRows * p.maxd;
  float* red = work + lay.work;
  float* rdt = red + kAdaptReduce;                   // dt_try per trial
  int* rpre = reinterpret_cast<int*>(rdt + ctl.max_trials);  // pre-step
                                                     // slot, -1: rejected
  float* part = partial + (size_t)blockIdx.x * p.wtotal;

  for (int e = threadIdx.x; e < d * d; e += blockDim.x)
    Qt[(e % d) * d + e / d] = __ldg(Q + e);

  const int ntiles = (B + kRows - 1) / kRows;
  const size_t plane = (size_t)B * d;
  const int gtid = blockIdx.x * blockDim.x + threadIdx.x;
  float dt_carry = __ldcg(dt_io);

  for (int k = 0; k < K; ++k) {
    const float* y0 = y_stack + (size_t)k * plane;
    const float* tgt = tgt_stack + (size_t)k * plane;
    // slot 0 is y0; slot n + 1 holds trial n's candidate y1
    auto state = [&](int slot) -> const float* {
      return slot == 0 ? y0 : yws + (size_t)(slot - 1) * plane;
    };

    // ---- forward: the trial loop, grid-uniform ----------------------------
    float t = 0.0f, dt = dt_carry, dt_first = 0.0f;
    bool done = false, rejprev = false, have_first = false;
    int n_acc = 0, n_rej = 0, cur = 0, n = 0;
    for (; n < ctl.max_trials && !done; ++n) {
      const float dt_try = nan_max(nan_min(dt, ctl.t_end - t), 0.0f);
      prepare_trial(base, dt_try, ctl, Qt, lamv, d, tb, w, M);
      const float* ypre = state(cur);
      float* ynew = yws + (size_t)n * plane;
      float esum = 0.0f;
      for (int tt = blockIdx.x; tt < ntiles; tt += gridDim.x) {
        const int row0 = tt * kRows;
        const int rows = min(kRows, B - row0);
        copy_rows<true>(ypre + (size_t)row0 * d, d, yv, d, rows, d, 1.0f);
        __syncthreads();
        ark_forward_tile<true, true, true>(p, *tb, sign, J, M, d, rows, yv,
                                           kI, kE, G, Ys, 0, nullptr, 0, a, b,
                                           y1s, errs);
        __syncthreads();
        for (int e = threadIdx.x; e < rows * d; e += blockDim.x) {
          const float y1 = y1s[e];
          const float sc = __fadd_rn(
              ctl.atol, __fmul_rn(ctl.rtol, fmaxf(fabsf(yv[e]), fabsf(y1))));
          const float r = errs[e] / sc;
          esum = fmaf(r, r, esum);
          ynew[(size_t)row0 * d + e] = y1;
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
        rpre[n] = accept ? cur : -1;
      }
      if (accept) {
        t = __fadd_rn(t, dt_try);
        cur = n + 1;
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
      const size_t off = (size_t)tt * kRows * d;
      const int n_el = min(kRows, B - tt * kRows) * d;
      for (int e = threadIdx.x; e < n_el; e += blockDim.x) {
        const float diff = __ldcg(yout + off + e) - tgt[off + e];
        lsum = fmaf(diff, diff, lsum);
        lamws[off + e] = ctl.two_inv_count * diff;
      }
    }

    // ---- reverse: the accepted trials, last to first ----------------------
    // (without a landing nothing seeds lam, and the gradient is zero). The
    // barrier publishes thread 0's last trial record to the block: a thread
    // that read a stale rpre would skip or replay the wrong trial.
    __syncthreads();
    bool first_grad = true;
    for (int m = completed ? n_trials - 1 : -1; m >= 0; --m) {
      const int pre = rpre[m];
      if (pre < 0) continue;  // a rejected trial reverses as the identity
      prepare_trial(base, rdt[m], ctl, Qt, lamv, d, tb, w, M);
      const float* ypre = state(pre);
      for (int tt = blockIdx.x; tt < ntiles; tt += gridDim.x) {
        const int row0 = tt * kRows;
        const int rows = min(kRows, B - row0);
        copy_rows<true>(ypre + (size_t)row0 * d, d, yv, d, rows, d, 1.0f);
        copy_rows<true>(lamws + (size_t)row0 * d, d, lam, d, rows, d, 1.0f);
        copy_rows<true>(lamws + (size_t)row0 * d, d, lp, d, rows, d, 1.0f);
        __syncthreads();
        ark_forward_tile<true, true, true>(p, *tb, sign, J, M, d, rows, yv,
                                           kI, kE, G, Ys, tile, nullptr, 0, a,
                                           b, y1s);
        __syncthreads();
        ark_reverse_tile<true, true>(p, *tb, sign, J, M, d, rows, lam, Ys,
                                     (size_t)tile, xis, u, uh, pv, q, hs, gA,
                                     gB, lp, part, first_grad);
        copy_rows(lp, d, lamws + (size_t)row0 * d, d, rows, d, 1.0f);
        __syncthreads();
      }
    }
    if (first_grad) {  // no accepted trial reached the MLP
      for (int e = threadIdx.x; e < p.wtotal; e += blockDim.x) part[e] = 0.0f;
    }
    const float block_loss = block_sum(lsum, red);
    if (threadIdx.x == 0) lpart[blockIdx.x] = block_loss;
    grid.sync();

    // ---- phase B: ordered sum of the partials, then Adam (K4's) -----------
    sum_partials_adam(adam, t0 + k + 1, partial, p.wtotal, params, m_state,
                      v_state);
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

}  // namespace pnode

using namespace pnode;

extern "C" {

// Shared memory of one adaptive_loop_kernel block, in bytes (mirrored by
// fused_adaptive_loop.py's fits check).
size_t pnode_adaptive_loop_smem(int d, int s, int maxd, int htotal,
                                int max_trials) {
  return sizeof(float) *
         (size_t)AdaptSmem(d, s, maxd, htotal, max_trials).total;
}

// Co-resident adaptive_loop_kernel blocks on the current device with
// `smem` bytes of dynamic shared memory each, into *blocks.
int pnode_adaptive_loop_capacity(size_t smem, int* blocks) {
  int dev = 0, coop = 0, sms = 0, per_sm = 0;
  int rc;
  if ((rc = (int)cudaGetDevice(&dev))) return rc;
  if ((rc = (int)cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch,
                                        dev)))
    return rc;
  if (!coop) return cudaErrorNotSupported;
  if ((rc = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                        dev)))
    return rc;
  if ((rc = prepare_smem(adaptive_loop_kernel, smem))) return rc;
  if ((rc = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, adaptive_loop_kernel, kThreads, smem)))
    return rc;
  *blocks = per_sm * sms;
  return 0;
}

// K adaptive iterations on y_stack, tgt_stack (K, B, d). J, Q (d, d) and
// lamv (d): the frozen symmetric J and its eigenbasis (J = Q diag(lamv)
// Q^T). params, m, v: flat [W0, b0, W1, b1, ...] buffers, updated in place.
// Scratch: partial (grid * wtotal), lpart (grid), eslot (2 * grid), yws
// (max_trials * B * d), lamws (B * d). stats: K rows of (loss, accepted,
// rejected, completed, dt_first, dt_last). dt_io: the first iteration's dt
// on entry, the last iteration's dt_first on return (the next call's warm
// start). tab: host doubles aI (s*s), aE (s*s), bI (s), bE (s); err_tab:
// bI_err (s), bE_err (s). expo = 1 / (order + 1). grid must not exceed
// pnode_adaptive_loop_capacity's answer.
int pnode_adaptive_loop(const float* y_stack, const float* tgt_stack,
                        const float* J, const float* Q, const float* lamv,
                        float* params, float* m_state, float* v_state,
                        float* partial, float* lpart, float* eslot,
                        float* yws, float* lamws, float* stats, float* dt_io,
                        int K, int B, int d, int s, const double* tab,
                        const double* err_tab, double gamma, float sign,
                        int n_layers, const int* dims, int act, int t0,
                        float lr, double b1, double b2, double eps,
                        int max_trials, double rtol, double atol,
                        double safety, double facmin, double facmax,
                        double expo, double t_end, int grid, void* stream) {
  if (n_layers < 1 || n_layers > kMaxLayers) return cudaErrorInvalidValue;
  if (K < 1 || B < 1 || grid < 1 || max_trials < 1 || dims[0] != d ||
      dims[n_layers] != d || err_tab == nullptr)
    return cudaErrorInvalidValue;
  const void* Ws[kMaxLayers];
  const void* bs[kMaxLayers];
  size_t off = 0;
  for (int l = 0; l < n_layers; ++l) {
    Ws[l] = params + off;
    off += (size_t)dims[l] * dims[l + 1];
    bs[l] = params + off;
    off += dims[l + 1];
  }
  Mlp p;
  Tableau base;
  int rc = make_mlp(&p, n_layers, dims, Ws, bs, act);
  if (rc) return rc;
  // the coefficients at dt = 1: the kernel scales them per trial
  if ((rc = make_tableau(&base, s, tab, 1.0, err_tab))) return rc;
  const Adam adam = make_adam(lr, b1, b2, eps);
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
  const size_t smem =
      pnode_adaptive_loop_smem(d, s, p.maxd, p.htotal, max_trials);
  if ((rc = prepare_smem(adaptive_loop_kernel, smem))) return rc;
  void* args[] = {(void*)&y_stack, (void*)&tgt_stack, (void*)&J,
                  (void*)&Q,       (void*)&lamv,      (void*)&params,
                  (void*)&m_state, (void*)&v_state,   (void*)&partial,
                  (void*)&lpart,   (void*)&eslot,     (void*)&yws,
                  (void*)&lamws,   (void*)&stats,     (void*)&dt_io,
                  (void*)&K,       (void*)&B,         (void*)&d,
                  (void*)&base,    (void*)&sign,      (void*)&p,
                  (void*)&adam,    (void*)&ctl,       (void*)&t0};
  rc = (int)cudaLaunchCooperativeKernel((const void*)adaptive_loop_kernel,
                                        dim3(grid), dim3(kThreads), args,
                                        smem, (cudaStream_t)stream);
  if (rc) return rc;
  return (int)cudaGetLastError();
}

}  // extern "C"
