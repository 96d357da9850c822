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
//
// Bound on the H100: per ARK3 step at the KS shapes, 4 stiff (B,64)x(64,64)
// products and 4 MLP evaluations, ~102 MFLOP against 185 KB of weights and
// 32 KB of operators. Latency and L2 weight streaming bound it, not FLOPs.
// Design: one block per 8 batch rows holds y, every kI/kE, G and Y in
// shared memory for the whole step, so nothing but y1 and the stage values
// (the adjoint's trajectory payload) goes back to device memory. The step
// body is ark_forward_tile (pnode_kernels.cuh), which K4 shares.
#include <cstdint>

#include "pnode_kernels.cuh"

namespace pnode {

__global__ void __launch_bounds__(kThreads)
ark_fwd_kernel(const float* __restrict__ y, const float* __restrict__ J,
               const float* __restrict__ inv, float* __restrict__ y1,
               float* __restrict__ ys, int B, int d, Tableau tb, float sign,
               Mlp p) {
  extern __shared__ float smem[];
  const int row0 = blockIdx.x * kRows;
  const int rows = min(kRows, B - row0);
  const int s = tb.s;
  const int tile = kRows * d;
  float* ys_ = smem;               // y rows
  float* kI = ys_ + tile;          // s tiles
  float* kE = kI + s * tile;       // s tiles
  float* G = kE + s * tile;
  float* Y = G + tile;             // the current stage value
  float* a = Y + tile;             // MLP ping-pong, kRows * maxd each
  float* b = a + kRows * p.maxd;
  copy_rows(y + (size_t)row0 * d, d, ys_, d, rows, d, 1.0f);
  __syncthreads();
  ark_forward_tile<false>(p, tb, sign, J, inv, d, rows, ys_, kI, kE, G, Y, 0,
                          ys + (size_t)row0 * d, (size_t)B * d, a, b,
                          y1 + (size_t)row0 * d);
}

}  // namespace pnode

using namespace pnode;

extern "C" {

// Shared memory of one ark_fwd_kernel block, in bytes (mirrored by
// fused_ark_forward.py's fits check).
size_t pnode_ark_fwd_smem(int d, int s, int maxd) {
  return sizeof(float) * ((size_t)kRows * d * (3 + 2 * s) +
                          2 * (size_t)kRows * maxd);
}

// y1 (B, d), ys (s, B, d) of one ARK step from y (B, d); J, inv (d, d).
// tab: host doubles aI (s*s), aE (s*s), bI (s), bE (s).
int pnode_ark_fwd(const float* y, const float* J, const float* inv,
                  float* y1, float* ys, int B, int d, int s,
                  const double* tab, double dt, float sign, int n_layers,
                  const int* dims, const void* const* Ws,
                  const void* const* bs, int act, void* stream) {
  Mlp p;
  Tableau tb;
  int rc = make_mlp(&p, n_layers, dims, Ws, bs, act);
  if (rc) return rc;
  if ((rc = make_tableau(&tb, s, tab, dt))) return rc;
  if (B < 1 || dims[0] != d || dims[n_layers] != d)
    return cudaErrorInvalidValue;
  const size_t smem = pnode_ark_fwd_smem(d, s, p.maxd);
  if ((rc = prepare_smem(ark_fwd_kernel, smem))) return rc;
  const int nblk = (B + kRows - 1) / kRows;
  ark_fwd_kernel<<<nblk, kThreads, smem, (cudaStream_t)stream>>>(
      y, J, inv, y1, ys, B, d, tb, sign, p);
  return (int)cudaGetLastError();
}

}  // extern "C"
