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
// Bound on the H100: per ARK3 reverse step at the KS shapes, 4 stiff
// products and 4 MLP recompute + backprop passes (~3x the forward MLP
// FLOPs, ~290 MFLOP), weights read from L2 once per stage per block.
// Latency and L2 streaming bound it. Design: one block per 8 batch rows
// keeps lam, every xi, the covectors and the recomputed layer inputs in
// shared memory. The TPU summed dW over batch tiles in one revisited
// output block; Hopper blocks run in parallel, so each block accumulates
// its own dW/db partial over the stages in a scratch slice, and a second
// launch sums the slices in block order (deterministic). The step body is
// ark_reverse_tile (pnode_kernels.cuh), which K4 shares.
#include <cstdint>

#include "pnode_kernels.cuh"

namespace pnode {

__global__ void __launch_bounds__(kThreads)
ark_adj_kernel(const float* __restrict__ ys, const float* __restrict__ lam,
               const float* __restrict__ J, const float* __restrict__ inv,
               float* __restrict__ lam_prev, float* __restrict__ partial,
               int B, int d, Tableau tb, float sign, Mlp p) {
  extern __shared__ float smem[];
  const int row0 = blockIdx.x * kRows;
  const int rows = min(kRows, B - row0);
  const int s = tb.s;
  const int tile = kRows * d;
  float* lam_s = smem;
  float* lp = lam_s + tile;        // lam_prev accumulator
  float* xis = lp + tile;          // s tiles
  float* u = xis + s * tile;
  float* uh = u + tile;
  float* pv = uh + tile;
  float* q = pv + tile;
  float* hs = q + tile;            // p.htotal: recomputed layer inputs
  float* gA = hs + p.htotal;       // kRows * maxd
  float* gB = gA + kRows * p.maxd;
  float* part = partial + (size_t)blockIdx.x * p.wtotal;

  copy_rows(lam + (size_t)row0 * d, d, lam_s, d, rows, d, 1.0f);
  copy_rows(lam + (size_t)row0 * d, d, lp, d, rows, d, 1.0f);
  __syncthreads();

  bool first_grad = true;
  ark_reverse_tile<false>(p, tb, sign, J, inv, d, rows, lam_s,
                          ys + (size_t)row0 * d, (size_t)B * d, xis, u, uh,
                          pv, q, hs, gA, gB, lp, part, first_grad);

  copy_rows(lp, d, lam_prev + (size_t)row0 * d, d, rows, d, 1.0f);
  if (first_grad) {  // no stage reached the MLP: its gradient is zero
    for (int e = threadIdx.x; e < p.wtotal; e += blockDim.x) part[e] = 0.0f;
  }
}

}  // namespace pnode

using namespace pnode;

extern "C" {

// Shared memory of one ark_adj_kernel block, in bytes (mirrored by
// fused_ark_adjoint.py's fits check).
size_t pnode_ark_adj_smem(int d, int s, int maxd, int htotal) {
  return sizeof(float) * ((size_t)kRows * d * (6 + s) + (size_t)htotal +
                          2 * (size_t)kRows * maxd);
}

// lam_prev (B, d) and grads ([W0, b0, W1, b1, ...]) of one reverse ARK step
// from the stage values ys (s, B, d) and lam (B, d); J, inv (d, d).
// partial is scratch of ceil(B / 8) * wtotal floats.
int pnode_ark_adj(const float* ys, const float* lam, const float* J,
                  const float* inv, float* lam_prev, float* partial,
                  float* grads, int B, int d, int s, const double* tab,
                  double dt, float sign, int n_layers, const int* dims,
                  const void* const* Ws, const void* const* bs, int act,
                  void* stream) {
  Mlp p;
  Tableau tb;
  int rc = make_mlp(&p, n_layers, dims, Ws, bs, act);
  if (rc) return rc;
  if ((rc = make_tableau(&tb, s, tab, dt))) return rc;
  if (B < 1 || dims[0] != d || dims[n_layers] != d)
    return cudaErrorInvalidValue;
  const size_t smem = pnode_ark_adj_smem(d, s, p.maxd, p.htotal);
  if ((rc = prepare_smem(ark_adj_kernel, smem))) return rc;
  const int nblk = (B + kRows - 1) / kRows;
  cudaStream_t st = (cudaStream_t)stream;
  ark_adj_kernel<<<nblk, kThreads, smem, st>>>(ys, lam, J, inv, lam_prev,
                                               partial, B, d, tb, sign, p);
  if ((rc = (int)cudaGetLastError())) return rc;
  launch_sum_partials(partial, nblk, p.wtotal, grads, st);
  return (int)cudaGetLastError();
}

}  // extern "C"
