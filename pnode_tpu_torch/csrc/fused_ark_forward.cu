// K2: one whole ARK-IMEX forward step in one kernel.
//
// Replaces pnode_tpu/ops/fused_ark_forward.py: _kernel (:53), launched by
// fused_ark_step_fwd (:157). Scope: -snes_type ksponly, a frozen shared
// (d, d) Jacobian J of a certified-linear implicit part, the pre-inverted
// stage operator inv = (I - dt gamma J)^{-1}, and f_EX = sign * MLP. For a
// linear f_IM the single linearized solve is exact Newton, and the stage
// loop collapses to products:
//
//   G_i  = y + sum_{j<i} (dt aI_ij kI_j + dt aE_ij kE_j)
//   Y_i  = G_i inv^T,  kI_i = (Y_i - G_i) / (dt aI_ii)   (implicit stage)
//   Y_i  = G_i,        kI_i = Y_i J^T                    (explicit stage)
//   kE_i = sign * MLP(Y_i)
//   y1   = y + sum_i (dt bI_i kI_i + dt bE_i kE_i)
//   err  = sum_i (dt (bI - bI_err)_i kI_i + dt (bE - bE_err)_i kE_i)
//
// err, the embedded error estimate of the adaptive controller
// (-ts_adapt_type basic), is written only when the caller passes the
// embedded weights; it costs one more pass over the stage derivatives the
// block already holds, and one (B, d) store.
//
// Bound on the H100: per ARK3 step at the KS shapes, 4 stiff (B,64)x(64,64)
// products and 4 MLP evaluations, ~102 MFLOP (1.5 us at the fp32 peak)
// against 185 KB of weights and 32 KB of operators. The step's 24 products
// depend on each other, so latency bounds it, not FLOPs. Design
// (csrc/ark_tiles.cuh): R rows per block from the plan, a grid that fills
// the card, every stage value and derivative in shared memory for the
// whole step, the operators staged once and the weights streamed through
// a two-slot ring, the MLP's products on R x 4 register tiles with k split
// over thread groups, the stiff products one FMA chain per output. Only
// y1, the stage values (the adjoint's trajectory payload) and err go back
// to device memory.
//
// Rows per block, device us per call on an H100 SXM (PERF.md): KS
// B 256: R 1 83.7-84.4, R 2 44.7-45.0, R 4 55.0-55.4, R 8 77.4-78.0;
// Burgers B 200: R 1 1635-1644, R 2 929-937, R 4 1200-1216 (R 8 does not
// fit). The plan's rule, the fewest rows whose grid fits one block per SM,
// takes R 2 at both.
#include <cstdint>

#include "ark_tiles.cuh"

namespace pnode {

template <int R>
__global__ void __launch_bounds__(ark::kThreads, 1)
ark_fwd_kernel(const float* __restrict__ y, float* __restrict__ y1,
               float* __restrict__ ys, float* __restrict__ err, int B,
               float sign, ark::StepArgs a) {
  extern __shared__ __align__(16) float smem[];
  const int d = a.m.dims[0];
  const size_t row0 = (size_t)blockIdx.x * R * d;
  ark::forward_step<R>(a, a.tb, y + row0, y1 + row0, ys + row0,
                       (size_t)B * d, err != nullptr ? err + row0 : nullptr,
                       min(R, B - (int)blockIdx.x * R), sign, true, smem);
}

template <int R>
static int launch_fwd(const float* y, float* y1, float* ys, float* err,
                      int B, float sign, const ark::StepArgs& a,
                      cudaStream_t stream) {
  int rc = prepare_smem(ark_fwd_kernel<R>, a.p.smem);
  if (rc) return rc;
  ark_fwd_kernel<R><<<a.p.grid, ark::kThreads, a.p.smem, stream>>>(
      y, y1, ys, err, B, sign, a);
  return (int)cudaGetLastError();
}

}  // namespace pnode

using namespace pnode;

extern "C" {

// K2's plan for y (B, d), s stages and the stack dims[0..n_layers]: rows
// per block, grid and shared-memory bytes (mirrored by
// ops/fused_ark_adjoint.py's ark_fwd_plan). cudaErrorInvalidValue when the
// configuration does not fit.
int pnode_ark_fwd_plan(int B, int d, int s, int n_layers, const int* dims,
                       int* rows, int* grid, long long* smem) {
  if (B < 1 || s < 1 || s > kMaxStages || n_layers < 1 ||
      n_layers > kMaxLayers || dims[0] != d || dims[n_layers] != d)
    return cudaErrorInvalidValue;
  for (int l = 0; l <= n_layers; ++l)
    if (dims[l] < 1) return cudaErrorInvalidValue;
  int sms, rc;
  if ((rc = ark::sm_count(&sms))) return rc;
  ark::Plan p;
  if (!ark::plan_fwd(B, d, s, n_layers, dims, sms, &p))
    return cudaErrorInvalidValue;
  *rows = p.rows;
  *grid = p.grid;
  *smem = (long long)p.smem;
  return 0;
}

// y1 (B, d), ys (s, B, d) of one ARK step from y (B, d); J, inv (d, d).
// tab: host doubles aI (s*s), aE (s*s), bI (s), bE (s). With err_tab (host
// doubles bI_err (s), bE_err (s)) also the embedded error estimate err
// (B, d); err and err_tab are both null or both given. rows: 0 for the
// plan's rows per block, or 1, 2, 4 or 8 to force them (kernel
// comparisons).
int pnode_ark_fwd(const float* y, const float* J, const float* inv,
                  float* y1, float* ys, float* err, int B, int d, int s,
                  const double* tab, const double* err_tab, double dt,
                  float sign, int n_layers, const int* dims,
                  const void* const* Ws, const void* const* bs, int act,
                  int rows, void* stream) {
  ark::StepArgs a;
  a.J = J;
  a.inv = inv;
  int rc = make_mlp(&a.m, n_layers, dims, Ws, bs, act);
  if (rc) return rc;
  if ((err == nullptr) != (err_tab == nullptr)) return cudaErrorInvalidValue;
  if ((rc = make_tableau(&a.tb, s, tab, dt, err_tab))) return rc;
  if (B < 1 || dims[0] != d || dims[n_layers] != d)
    return cudaErrorInvalidValue;
  int sms;
  if ((rc = ark::sm_count(&sms))) return rc;
  const bool ok =
      rows == 0 ? ark::plan_fwd(B, d, s, n_layers, dims, sms, &a.p)
                : ((rows == 1 || rows == 2 || rows == 4 || rows == 8) &&
                   ark::plan_rows(rows, B, d, s, n_layers, dims, &a.p));
  if (!ok) return cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  switch (a.p.rows) {
    case 1: return launch_fwd<1>(y, y1, ys, err, B, sign, a, st);
    case 2: return launch_fwd<2>(y, y1, ys, err, B, sign, a, st);
    case 4: return launch_fwd<4>(y, y1, ys, err, B, sign, a, st);
    default: return launch_fwd<8>(y, y1, ys, err, B, sign, a, st);
  }
}

}  // extern "C"
