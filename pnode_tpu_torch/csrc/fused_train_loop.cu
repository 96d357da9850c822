// K4: K complete training iterations (forward ARK step, one-step MSE,
// stage-exact reverse step, Adam) in one persistent cooperative launch.
//
// Replaces pnode_tpu/ops/fused_train_loop.py: _kernel (:284), which runs
// _fwd_bwd_iteration (:132) and the Adam update (:356-368), launched by
// fused_train_loop (:512). Same scope as K2 and K3 (ksponly, a frozen
// linear implicit part with its pre-inverted stage operator, f_EX = sign *
// MLP), plus the MSE seed lam = 2 (y1 - tgt) / (B d) and optax's Adam
//
//   m <- b1 m + (1 - b1) g;  v <- b2 v + (1 - b2) g^2
//   p <- p - lr (m / c1) / (sqrt(v / c2) + eps),  c = 1 - exp(t ln b)
//
// with t = t0 + k + 1 counting updates from 1 and ln b taken on the host.
//
// What bounds it on the H100: one iteration is one K12 (a K2-sized forward
// and a K3-sized reverse, ~0.38 GFLOP at KS B 256, 5.6 us at the fp32
// peak; latency and the weight stream bound K12 at ~170 us on an H100)
// plus an ordered sum of the block partials and an Adam update of the
// 46,240 KS parameters. The TPU ran the whole batch on one core, so the dW
// sum before each update was free; here it crosses blocks.
//
// Design: K12's body (csrc/fused_grad_step.cu) in one cooperative launch
// (all blocks co-resident, so a grid-wide barrier cannot deadlock) that
// runs every iteration of the call:
//   phase A, per block, over its row tiles of R rows (tiles blockIdx.x,
//     + gridDim.x, ...): ark::forward_step with the s stage values and y1
//     kept in shared memory, the squared error and the seed two_inv_count
//     (y1 - tgt) in place of y1, then ark::reverse_step from those stage
//     values into the block's dW/db partial (its first tile overwrites it,
//     later tiles add: reverse_step's `add`). inv and J are staged once per
//     launch where the plan keeps them resident (else the forward streams
//     them through the ring and the reverse reads them in place). The
//     block's loss sum goes to lpart.
//   grid.sync()
//   phase B, every thread of the grid: for its slice of the parameters, sum
//     the block partials in block order (deterministic, no atomics) and
//     update W, b, m and v in place (sum_partials_adam); thread 0 sums the
//     loss partials in block order and writes losses[k].
//   grid.sync()
// The plan is K12's (plan_rev, kRevGrad: R rows per block, the fewest in
// {1, 2, 4, 8} whose grid fits one block per SM) with the grid capped at
// one block per SM: R 2 and 128 blocks at KS B 256 on 132 SMs; past 132
// row tiles the blocks stride. Weights and biases change inside the launch
// and an SM's L1 does not see another SM's stores, so every weight and bias
// read goes through L2 (the bodies' kCoherent). Parameters and moments live
// in one flat [W0, b0, W1, b1, ...] buffer each, the layout of the
// gradient partials, so phase B is one loop over that layout.
//
// The grid form (csrc/ark_grid.cuh, whose note gives the design): where
// the row plan cannot keep inv and J in shared memory (Burgers-512, B 200,
// 512 -> 576 x4 -> 512, among them), each iteration runs over the whole
// grid of one block per SM instead: the forward step's products (K2's
// arithmetic, so its stage values and layer inputs are the row form's),
// the MSE seed in the last product's epilogue, the reverse's backprop and
// stiff products (no recompute: the forward's layer inputs are kept), then
// one dW/db product per layer over the (stage, row) axis whose epilogue
// applies Adam (adam_step, sum_partials_adam's update without partials),
// with a grid-wide barrier between dependent products. The row form
// wrote 132 partials of the 6.35 MB stack per iteration at Burgers (~0.84
// GB) and pulled the stack through every block's ring twice a stage; none
// of that remains. What bounds it: ~10.6 GFLOP an iteration, 0.16 ms at
// the fp32 FMA peak; ~47 barriers an iteration on top (1.57 ms an
// iteration on an H100 SXM at 700 W, PERF.md, against 13.26 for the row
// form at R 1 and 8.22 for the plain version). The loss is a
// per-row sum (each row one block's fixed-order sum), then the rows' sum
// in a fixed order, so it too has the same bits at any grid.
#include <cooperative_groups.h>

#include <cstdint>

#include "ark_grid.cuh"
#include "ark_tiles.cuh"

namespace cg = cooperative_groups;

namespace pnode {

template <int R>
__global__ void __launch_bounds__(ark::kThreads, 1)
train_loop_kernel(const float* __restrict__ y_stack,
                  const float* __restrict__ tgt_stack, float* params,
                  float* m_state, float* v_state, float* partial,
                  float* lpart, float* losses, int K, int B, float sign,
                  float inv_count, float two_inv_count, ark::StepArgs a,
                  ark::RevPlan q, Adam adam, int t0) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(16) float smem[];
  const int d = a.m.dims[0];
  const int ntiles = (B + R - 1) / R;
  const int slice = ark::round4(a.m.wtotal);
  float* part = partial + (size_t)blockIdx.x * slice;
  float* Ys = smem + q.o_ys;
  float* seed = smem + q.o_lam;
  const int gtid = blockIdx.x * blockDim.x + threadIdx.x;
  bool staged = false;

  for (int k = 0; k < K; ++k) {
    // ---- phase A: this block's row tiles ----------------------------------
    const float* y = y_stack + (size_t)k * B * d;
    const float* tgt = tgt_stack + (size_t)k * B * d;
    float lsum = 0.0f;
    bool add = false;
    for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
      const int rows = min(R, B - t * R);
      const size_t row0 = (size_t)t * R * d;
      ark::forward_step<R, false, true>(a, a.tb, y + row0, seed, Ys,
                                        (size_t)R * d, nullptr, rows, sign,
                                        !staged, smem);
      staged = true;
      __syncthreads();
      for (int e = threadIdx.x; e < rows * d; e += ark::kThreads) {
        const float diff = seed[e] - tgt[row0 + e];
        lsum = fmaf(diff, diff, lsum);
        seed[e] = two_inv_count * diff;
      }
      __syncthreads();
      ark::reverse_step<R, true>(q, a.m, a.tb, a.J, a.inv, seed, Ys,
                                 (size_t)R * d, nullptr, part, rows, sign,
                                 false, add, smem);
      add = true;
    }
    if (!add)  // a block without a row tile
      for (int e = threadIdx.x; e < a.m.wtotal; e += ark::kThreads)
        part[e] = 0.0f;
    // the ring is idle here: its first floats take the warp sums
    const float block_loss = block_sum(lsum, smem + q.o_ring);
    if (threadIdx.x == 0) lpart[blockIdx.x] = block_loss;
    grid.sync();

    // ---- phase B: ordered sum of the partials, then Adam ------------------
    sum_partials_adam(adam, t0 + k + 1, partial, a.m.wtotal, slice, params,
                      m_state, v_state);
    if (gtid == 0) {
      float l = 0.0f;
      for (int blk = 0; blk < (int)gridDim.x; ++blk)
        l += __ldcg(lpart + blk);
      losses[k] = l * inv_count;
    }
    grid.sync();
  }
}

// The grid form: K iterations over the whole cooperative grid (the
// covectors of the stages that reach no MLP zeroed once).
__global__ void __launch_bounds__(ark::kGBlockThreads, 1)
train_loop_grid_kernel(const float* __restrict__ y_stack,
                       const float* __restrict__ tgt_stack, int K, int t0,
                       const ark::GridArgs a) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(16) float smem[];
  ark::mark(ark::kMarkStart);
  const size_t bd = (size_t)a.B * a.m.dims[0];
  ark::zero_unreached(a);
  for (int k = 0; k < K; ++k) {
    ark::Iter it{y_stack + k * bd, tgt_stack + k * bd, 0.0f, 0.0f, k};
    adam_corrections(a.adam, t0 + k + 1, &it.c1, &it.c2);
    ark::grid_step(grid, a, it, smem, ark::Cursor{ark::kSecFwd, 0, -1});
  }
  ark::grid_loss(a, K - 1);  // its per-row sums a barrier old
  ark::mark(ark::kMarkEnd);
}

// K4's plan: K12's (plan_rev, kRevGrad; `rows` 0, or 1, 2, 4 or 8 forced)
// with the grid capped at one block per SM; where the rule's plan cannot
// keep inv and J resident (rows 0), the grid form's (*g, *grid_form set).
// 0 or a CUDA error code.
static int train_plan(int B, int d, int s, int n_layers, const int* dims,
                      int rows, ark::RevPlan* q, ark::Plan* f,
                      ark::GridPlan* g, bool* grid_form) {
  if (B < 1 || s < 1 || s > kMaxStages || n_layers < 1 ||
      n_layers > kMaxLayers || dims[0] != d || dims[n_layers] != d)
    return cudaErrorInvalidValue;
  for (int l = 0; l <= n_layers; ++l)
    if (dims[l] < 1) return cudaErrorInvalidValue;
  int sms, rc;
  if ((rc = ark::sm_count(&sms))) return rc;
  if (!ark::plan_rev(B, d, s, n_layers, dims, sms, ark::kRevGrad, rows, q, f))
    return cudaErrorInvalidValue;
  if (q->grid > sms) q->grid = f->grid = sms;
  *grid_form = rows == 0 && !q->resident;
  if (*grid_form)
    ark::plan_grid(ark::kGridLoop, B, d, s, n_layers, dims, sms, g);
  return 0;
}

}  // namespace pnode

using namespace pnode;

extern "C" {

// K4's plan for y (B, d), s stages and the stack dims[0..n_layers]: rows
// per block (0: the grid form), grid and shared-memory bytes (mirrored by
// ops/fused_train_loop.py's train_loop_plan). rows_in: 0 for the plan's
// form, or 1, 2, 4 or 8 forced (the row form). cudaErrorInvalidValue when
// the configuration does not fit.
int pnode_train_loop_plan(int B, int d, int s, int n_layers, const int* dims,
                          int rows_in, int* rows, int* grid,
                          long long* smem) {
  ark::RevPlan q;
  ark::Plan f;
  ark::GridPlan g;
  bool grid_form;
  const int rc =
      train_plan(B, d, s, n_layers, dims, rows_in, &q, &f, &g, &grid_form);
  if (rc) return rc;
  *rows = grid_form ? 0 : q.rows;
  *grid = grid_form ? g.grid : q.grid;
  *smem = (long long)(grid_form ? g.smem : q.smem);
  return 0;
}

// K iterations on y_stack, tgt_stack (K, B, d). params, m, v: flat [W0, b0,
// W1, b1, ...] buffers of the stack (dims[0..n_layers]), updated in place.
// tab: host doubles aI (s*s), aE (s*s), bI (s), bE (s). rows: 0 for the
// plan's form, or 1, 2, 4 or 8 to force the row form at those rows per
// block. Row form: scratch at the plan's grid, partial of grid slices of
// round4(wtotal) floats, lpart of grid floats. Grid form: partial is the
// workspace of pnode_ark_grid_plan's floats (lpart unused), and `grid` (0:
// the plan's) a smaller co-resident grid if wanted; every output has the
// same bits at any grid. `partial_floats` must give the floats
// (cudaErrorInvalidValue otherwise). losses: K floats. One cooperative
// launch on `stream`.
int pnode_train_loop(const float* y_stack, const float* tgt_stack,
                     const float* J, const float* inv, float* params,
                     float* m_state, float* v_state, float* partial,
                     float* lpart, float* losses, int K, int B, int d, int s,
                     const double* tab, double dt, float sign, int n_layers,
                     const int* dims, int act, int t0, float lr, double b1,
                     double b2, double eps, int rows, int grid,
                     long long partial_floats, void* stream) {
  if (K < 1 || grid < 0) return cudaErrorInvalidValue;
  ark::StepArgs a;
  a.J = J;
  a.inv = inv;
  int rc = flat_mlp(&a.m, params, n_layers, dims, d, act);
  if (rc) return rc;
  if ((rc = make_tableau(&a.tb, s, tab, dt))) return rc;
  ark::RevPlan q;
  ark::GridPlan gp;
  bool grid_form;
  if ((rc = train_plan(B, d, s, n_layers, dims, rows, &q, &a.p, &gp,
                       &grid_form)))
    return rc;
  Adam adam = make_adam(lr, b1, b2, eps);
  float inv_count = (float)(1.0 / ((double)B * d));
  float two_inv_count = (float)(2.0 / ((double)B * d));
  const cudaStream_t st = (cudaStream_t)stream;
  if (grid_form) {
    if (partial_floats != gp.ws) return cudaErrorInvalidValue;
    ark::GridArgs ga{};
    ga.m = a.m;
    ga.tb = a.tb;
    ga.J = J;
    ga.inv = inv;
    ga.B = B;
    ga.s = s;
    ga.sign = sign;
    ark::reach_masks(a.tb, &ga.umask, &ga.emask);
    ark::grid_regions(gp, partial, n_layers, &ga);
    ga.params = params;
    ga.m_state = m_state;
    ga.v_state = v_state;
    ga.losses = losses;
    ga.adam = adam;
    ga.inv_count = inv_count;
    ga.two_inv_count = two_inv_count;
    void* gargs[] = {(void*)&y_stack, (void*)&tgt_stack, (void*)&K,
                     (void*)&t0, (void*)&ga};
    return launch_cooperative(train_loop_grid_kernel, grid ? grid : gp.grid,
                              gp.smem, gargs, st, ark::kGBlockThreads);
  }
  if (grid != 0 ||
      partial_floats != (long long)q.grid * ark::round4(a.m.wtotal))
    return cudaErrorInvalidValue;
  void* args[] = {(void*)&y_stack, (void*)&tgt_stack, (void*)&params,
                  (void*)&m_state, (void*)&v_state,   (void*)&partial,
                  (void*)&lpart,   (void*)&losses,    (void*)&K,
                  (void*)&B,       (void*)&sign,      (void*)&inv_count,
                  (void*)&two_inv_count, (void*)&a,   (void*)&q,
                  (void*)&adam,    (void*)&t0};
  switch (q.rows) {
    case 1:
      return launch_cooperative(train_loop_kernel<1>, q.grid, q.smem, args,
                                st);
    case 2:
      return launch_cooperative(train_loop_kernel<2>, q.grid, q.smem, args,
                                st);
    case 4:
      return launch_cooperative(train_loop_kernel<4>, q.grid, q.smem, args,
                                st);
    default:
      return launch_cooperative(train_loop_kernel<8>, q.grid, q.smem, args,
                                st);
  }
}

#ifdef ARK_TRACE
// The last K4 launch's phase marks (csrc/ark_tiles.cuh), as
// pnode_ark_adj_marks reads K3's.
int pnode_train_loop_marks(long long* t, int* tags, int* n,
                           unsigned long long* ns) {
  int rc;
  if ((rc = (int)cudaMemcpyFromSymbol(t, ark::mark_t, sizeof(ark::mark_t))))
    return rc;
  if ((rc = (int)cudaMemcpyFromSymbol(tags, ark::mark_tag,
                                      sizeof(ark::mark_tag))))
    return rc;
  if ((rc = (int)cudaMemcpyFromSymbol(n, ark::mark_n, sizeof(int))))
    return rc;
  return (int)cudaMemcpyFromSymbol(ns, ark::mark_ns, sizeof(ark::mark_ns));
}
#endif

}  // extern "C"
