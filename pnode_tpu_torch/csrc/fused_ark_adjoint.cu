// K3: one whole stage-exact ARK-IMEX reverse step in one kernel.
//
// Replaces pnode_tpu/ops/fused_ark_adjoint.py: _kernel (:304), launched by
// fused_ark_step_adj (:458). Same scope as K2. For i = s-1 .. 0:
//
//   u_i  = dt (bI_i lam + sum_{m>i} aI_mi xi_m)     covector into kI_i
//   uh_i = dt (bE_i lam + sum_{m>i} aE_mi xi_m)     covector into kE_i
//   p_i  = u_i J (explicit stage) + MLP_vjp_x(Y_i, sign uh_i)
//   xi_i = (u_i/(dt aI_ii) + p_i) inv - u_i/(dt aI_ii)   (implicit stage)
//   xi_i = p_i                                            (explicit stage)
//   dW  += MLP_vjp_W(Y_i, sign uh_i)
//   lam_prev = lam + sum_i xi_i
//
// (the implicit line is inv^T J^T u = (inv^T u - u)/(dt aI_ii) folded into
// the transposed solve: one stiff product per stage, as on the TPU).
//
// Bound on the H100: per ARK3 reverse step at the KS shapes (B 256, 64 ->
// 104 x4 -> 64), 4 stiff products and 4 MLP recompute + backprop passes,
// ~275 MFLOP, 4.1 us at the fp32 peak; the products depend on each other,
// so latency bounds it, not FLOPs. The body is ark::reverse_step
// (csrc/ark_tiles.cuh, whose note gives the design): R rows per block from
// the plan (plan_rev), inv and J staged once (read in place from device
// memory where the two copies do not fit), the weights streamed through
// the two-slot ring at an odd row stride (the backprop's W^T products read
// shared memory column-wise, never device memory), every stage value,
// covector and layer activation in shared memory, and dW/db formed once
// per block from the stored layer inputs and covectors. The TPU summed dW
// over batch tiles in one revisited output block; Hopper blocks run in
// parallel, so each block writes its own dW/db partial (46,240 floats at
// KS), and a second launch sums the partials in block order
// (deterministic, no atomics).
//
// Rows per block, device us per call with the sum on an H100 SXM at KS B
// 256 (PERF.md): R 1 236.8, R 2 121.6, R 4 145.9, R 8 290.0. The plan's
// rule, the fewest rows whose grid fits one block per SM, takes R 2.
//
// The grid form (csrc/ark_grid.cuh, whose note gives the design): where
// the row plan cannot keep inv and J in shared memory (past d ~160 at
// KS-like stacks; Burgers-512, B 200, 512 -> 576 x4 -> 512, among them),
// the plan takes one cooperative launch of one block per SM instead, in
// which every product of the step (the recompute of all stages' layer
// inputs at once, each backprop, each stiff product, the dW/db products
// over the (stage, row) axis) is tiled over the whole grid, with a
// grid-wide barrier between dependent ones. At Burgers the row form pulled
// the 6.35 MB stack through every block's ring twice a stage and wrote
// 200 dW/db partials of it (~1.27 GB a call); here each weight byte leaves
// L2 once per output tile row, and no partial exists. What bounds it:
// ~8.0 GFLOP a call, 0.12 ms at the fp32 FMA peak; the ~29 barriers and
// the M = 200 products' ragged tile count on top (1.17 ms a call on an
// H100 SXM at 700 W, PERF.md, against 10.05 for the row form at R 1 and
// 6.69 for the plain version). A forced `rows` still takes the row form,
// for kernel comparisons.
#include <cooperative_groups.h>

#include <cstdint>

#include "ark_grid.cuh"
#include "ark_tiles.cuh"

namespace cg = cooperative_groups;

namespace pnode {

template <int R>
__global__ void __launch_bounds__(ark::kThreads, 1)
ark_adj_kernel(const float* __restrict__ ys, const float* __restrict__ lam,
               const float* __restrict__ J, const float* __restrict__ inv,
               float* __restrict__ lam_prev, float* __restrict__ partial,
               int B, float sign, ark::RevPlan q, Mlp m, Tableau tb) {
  extern __shared__ __align__(16) float smem[];
  ark::mark(ark::kMarkStart);
  const int d = m.dims[0];
  const int rows = min(R, B - (int)blockIdx.x * R);
  const size_t row0 = (size_t)blockIdx.x * R * d;
  float* lam_s = smem + q.o_lam;
  for (int e = threadIdx.x; e < rows * d; e += ark::kThreads)
    lam_s[e] = lam[row0 + e];
  ark::reverse_step<R>(q, m, tb, J, inv, lam_s, ys + row0, (size_t)B * d,
                       lam_prev + row0,
                       partial + (size_t)blockIdx.x * m.wtotal, rows, sign,
                       true, false, smem);
  ark::mark(ark::kMarkEnd);
}

// The grid form: one reverse step over the whole cooperative grid.
__global__ void __launch_bounds__(ark::kGBlockThreads, 1)
ark_adj_grid_kernel(const ark::GridArgs a) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(16) float smem[];
  ark::mark(ark::kMarkStart);
  const ark::Iter it{nullptr, nullptr, 0.0f, 0.0f, 0};
  ark::grid_step(grid, a, it, smem, ark::Cursor{ark::kSecStage, 0, 0});
  ark::mark(ark::kMarkEnd);
}

template <int R>
static int launch_adj(const float* ys, const float* lam, const float* J,
                      const float* inv, float* lam_prev, float* partial,
                      int B, float sign, const ark::RevPlan& q, const Mlp& m,
                      const Tableau& tb, cudaStream_t stream) {
  int rc = prepare_smem(ark_adj_kernel<R>, q.smem);
  if (rc) return rc;
  ark_adj_kernel<R><<<q.grid, ark::kThreads, q.smem, stream>>>(
      ys, lam, J, inv, lam_prev, partial, B, sign, q, m, tb);
  return (int)cudaGetLastError();
}

}  // namespace pnode

using namespace pnode;

extern "C" {

// K3's plan for lam (B, d), s stages and the stack dims[0..n_layers]: rows
// per block (0: the grid form), grid and shared-memory bytes (mirrored by
// ops/fused_ark_adjoint.py's ark_adj_plan). cudaErrorInvalidValue when the
// configuration does not fit.
int pnode_ark_adj_plan(int B, int d, int s, int n_layers, const int* dims,
                       int* rows, int* grid, long long* smem) {
  if (B < 1 || s < 1 || s > kMaxStages || n_layers < 1 ||
      n_layers > kMaxLayers || dims[0] != d || dims[n_layers] != d)
    return cudaErrorInvalidValue;
  for (int l = 0; l <= n_layers; ++l)
    if (dims[l] < 1) return cudaErrorInvalidValue;
  int sms, rc;
  if ((rc = ark::sm_count(&sms))) return rc;
  ark::RevPlan q;
  if (!ark::plan_rev(B, d, s, n_layers, dims, sms, ark::kRevStep, 0, &q,
                     nullptr))
    return cudaErrorInvalidValue;
  if (!q.resident) {
    ark::GridPlan g;
    ark::plan_grid(ark::kGridStep, B, d, s, n_layers, dims, sms, &g);
    *rows = 0;
    *grid = g.grid;
    *smem = (long long)g.smem;
    return 0;
  }
  *rows = q.rows;
  *grid = q.grid;
  *smem = (long long)q.smem;
  return 0;
}

// The grid form's plan of `kind` (ark::GridKind: 0 K3's step, 1 K4's
// loop, 2 K12's gradient step, 3 K2's forward step) for (B, d), s stages
// and dims[0..n_layers] on this card: grid, shared-memory bytes and
// workspace floats (mirrored by ops/fused_ark_adjoint.py's grid_plan).
int pnode_ark_grid_plan(int kind, int B, int d, int s, int n_layers,
                        const int* dims, int* grid, long long* smem,
                        long long* ws) {
  if (kind < 0 || kind >= ark::kGridKinds || B < 1 || s < 1 ||
      s > kMaxStages || n_layers < 1 || n_layers > kMaxLayers ||
      dims[0] != d || dims[n_layers] != d)
    return cudaErrorInvalidValue;
  int sms, rc;
  if ((rc = ark::sm_count(&sms))) return rc;
  ark::GridPlan g;
  ark::plan_grid(kind, B, d, s, n_layers, dims, sms, &g);
  *grid = g.grid;
  *smem = (long long)g.smem;
  *ws = g.ws;
  return 0;
}

// The grid form's phases of `kind` (as pnode_ark_grid_plan's) at
// iteration k (K4) as next_phase generates them, one record of
// kGridRecord long longs per product: phase, per-block work, epilogue,
// stage, layer, M, N, K, G, v, ones row, A and B k-major, lda, ldb, ldo,
// then the addresses of A, B, the output and aux (0 where none). The
// workspace and operands are taken at the addresses given (ws, J, inv, y,
// K2's stage values ys, Ws[l], bs[l]), never read. tab: as pnode_ark_adj's.
// *n: the records; cudaErrorInvalidValue past `cap` (mirrored by
// ops/fused_ark_adjoint.py's grid_phases).
constexpr int kGridRecord = 20;

int pnode_ark_grid_phases(int kind, int B, int d, int s, int n_layers,
                          const int* dims, const double* tab, int k,
                          const void* ws, const void* J, const void* inv,
                          const void* y, const void* ys,
                          const void* const* Ws, const void* const* bs,
                          long long* rec, int cap, int* n) {
  if (kind < 0 || kind >= ark::kGridKinds || B < 1 ||
      n_layers < 1 || n_layers > kMaxLayers || dims[0] != d ||
      dims[n_layers] != d)
    return cudaErrorInvalidValue;
  ark::GridArgs a{};
  int rc = make_mlp(&a.m, n_layers, dims, Ws, bs, kActRelu);
  if (rc) return rc;
  if ((rc = make_tableau(&a.tb, s, tab, 1.0))) return rc;
  a.J = static_cast<const float*>(J);
  a.inv = static_cast<const float*>(inv);
  a.B = B;
  a.s = s;
  ark::reach_masks(a.tb, &a.umask, &a.emask);
  ark::GridPlan g;
  ark::plan_grid(kind, B, d, s, n_layers, dims, 1, &g);
  ark::grid_regions(g, static_cast<float*>(const_cast<void*>(ws)), n_layers,
                    &a);
  if (kind == ark::kGridFwd)  // K2's stage values: the caller's ys
    a.h[0] = static_cast<float*>(const_cast<void*>(ys));
  const ark::Iter it{static_cast<const float*>(y), nullptr, 0.0f, 0.0f, k};
  ark::Cursor c = kind == ark::kGridStep ? ark::Cursor{ark::kSecStage, 0, 0}
                                         : ark::Cursor{ark::kSecFwd, 0, -1};
  ark::Gemm gs[kMaxLayers] = {};
  int ng, tag, pre, phase = 0;
  *n = 0;
  while (ark::next_phase(a, it, c, gs, &ng, &tag, &pre)) {
    for (int p = 0; p < (ng ? ng : 1); ++p, ++*n) {
      if (*n >= cap) return cudaErrorInvalidValue;
      long long* r = rec + (size_t)*n * kGridRecord;
      const ark::Gemm& q = gs[p];
      const bool none = ng == 0;  // a phase of per-block work alone
      const long long f[kGridRecord] = {
          phase, pre, none ? -1 : q.epi, q.stage, q.layer, q.M, q.N, q.K,
          q.G, q.v, q.ones_row, q.a_kmajor, q.b_kmajor, q.lda, q.ldb, q.ldo,
          (long long)(uintptr_t)q.a, (long long)(uintptr_t)q.b,
          (long long)(uintptr_t)q.out, (long long)(uintptr_t)q.aux};
      for (int j = 0; j < kGridRecord; ++j) r[j] = none && j > 2 ? 0 : f[j];
    }
    ++phase;
  }
  return 0;
}

// lam_prev (B, d) and grads ([W0, b0, W1, b1, ...]) of one reverse ARK step
// from the stage values ys (s, B, d) and lam (B, d); J, inv (d, d). rows: 0
// for the plan's form, or 1, 2, 4 or 8 to force the row form at those rows
// per block (kernel comparisons). Row form: partial is scratch of grid *
// wtotal floats at the launch's grid. Grid form: partial is the workspace
// of pnode_ark_grid_plan's floats, and `grid` (0: the plan's) a smaller
// co-resident grid if wanted; every output has the same bits at any grid.
// `partial_floats` must give the floats (cudaErrorInvalidValue otherwise).
int pnode_ark_adj(const float* ys, const float* lam, const float* J,
                  const float* inv, float* lam_prev, float* partial,
                  float* grads, int B, int d, int s, const double* tab,
                  double dt, float sign, int n_layers, const int* dims,
                  const void* const* Ws, const void* const* bs, int act,
                  int rows, int grid, long long partial_floats,
                  void* stream) {
  Mlp m;
  Tableau tb;
  int rc = make_mlp(&m, n_layers, dims, Ws, bs, act);
  if (rc) return rc;
  if ((rc = make_tableau(&tb, s, tab, dt))) return rc;
  if (B < 1 || dims[0] != d || dims[n_layers] != d || grid < 0)
    return cudaErrorInvalidValue;
  int sms;
  if ((rc = ark::sm_count(&sms))) return rc;
  ark::RevPlan q;
  if (!ark::plan_rev(B, d, s, n_layers, dims, sms, ark::kRevStep, rows, &q,
                     nullptr))
    return cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (rows == 0 && !q.resident) {
    ark::GridPlan g;
    ark::plan_grid(ark::kGridStep, B, d, s, n_layers, dims, sms, &g);
    if (partial_floats != g.ws) return cudaErrorInvalidValue;
    ark::GridArgs a{};
    a.m = m;
    a.tb = tb;
    a.J = J;
    a.inv = inv;
    a.B = B;
    a.s = s;
    a.sign = sign;
    ark::reach_masks(tb, &a.umask, &a.emask);
    a.lam = lam;
    a.ys_in = ys;
    a.lam_prev = lam_prev;
    a.grads = grads;
    ark::grid_regions(g, partial, n_layers, &a);
    void* args[] = {(void*)&a};
    return launch_cooperative(ark_adj_grid_kernel, grid ? grid : g.grid,
                              g.smem, args, st, ark::kGBlockThreads);
  }
  if (grid != 0 || partial_floats != (long long)q.grid * m.wtotal)
    return cudaErrorInvalidValue;
  switch (q.rows) {
    case 1: rc = launch_adj<1>(ys, lam, J, inv, lam_prev, partial, B, sign,
                               q, m, tb, st); break;
    case 2: rc = launch_adj<2>(ys, lam, J, inv, lam_prev, partial, B, sign,
                               q, m, tb, st); break;
    case 4: rc = launch_adj<4>(ys, lam, J, inv, lam_prev, partial, B, sign,
                               q, m, tb, st); break;
    default: rc = launch_adj<8>(ys, lam, J, inv, lam_prev, partial, B, sign,
                                q, m, tb, st); break;
  }
  if (rc) return rc;
  launch_sum_partials(partial, q.grid, m.wtotal, grads, st);
  return (int)cudaGetLastError();
}

#ifdef ARK_TRACE
// The last K3 launch's phase marks (csrc/ark_tiles.cuh): up to kMarks
// clock64() values and their tags, their count, and the two globaltimer
// readings.
int pnode_ark_adj_marks(long long* t, int* tags, int* n,
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
