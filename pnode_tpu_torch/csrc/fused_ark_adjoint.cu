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
#include <cstdint>

#include "ark_tiles.cuh"

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
// per block, grid and shared-memory bytes (mirrored by
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
  *rows = q.rows;
  *grid = q.grid;
  *smem = (long long)q.smem;
  return 0;
}

// lam_prev (B, d) and grads ([W0, b0, W1, b1, ...]) of one reverse ARK step
// from the stage values ys (s, B, d) and lam (B, d); J, inv (d, d). rows: 0
// for the plan's rows per block, or 1, 2, 4 or 8 to force them (kernel
// comparisons). partial: scratch of grid * wtotal floats at the launch's
// grid; `partial_floats` must say so (cudaErrorInvalidValue otherwise).
int pnode_ark_adj(const float* ys, const float* lam, const float* J,
                  const float* inv, float* lam_prev, float* partial,
                  float* grads, int B, int d, int s, const double* tab,
                  double dt, float sign, int n_layers, const int* dims,
                  const void* const* Ws, const void* const* bs, int act,
                  int rows, long long partial_floats, void* stream) {
  Mlp m;
  Tableau tb;
  int rc = make_mlp(&m, n_layers, dims, Ws, bs, act);
  if (rc) return rc;
  if ((rc = make_tableau(&tb, s, tab, dt))) return rc;
  if (B < 1 || dims[0] != d || dims[n_layers] != d)
    return cudaErrorInvalidValue;
  int sms;
  if ((rc = ark::sm_count(&sms))) return rc;
  ark::RevPlan q;
  if (!ark::plan_rev(B, d, s, n_layers, dims, sms, ark::kRevStep, rows, &q,
                     nullptr))
    return cudaErrorInvalidValue;
  if (partial_floats != (long long)q.grid * m.wtotal)
    return cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
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
