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
// launch sums the slices in block order (deterministic).
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

  bool active[kMaxStages] = {};
  bool first_grad = true;
  for (int i = s - 1; i >= 0; --i) {
    bool has_u = tb.nzbI[i], has_uh = tb.nzbE[i];
    for (int m = i + 1; m < s; ++m) {
      if (!active[m]) continue;
      has_u = has_u || tb.nzI[m][i];
      has_uh = has_uh || tb.nzE[m][i];
    }
    active[i] = has_u || has_uh;
    if (!active[i]) continue;
    const bool implicit = tb.nzI[i][i];

    // covectors, in the reference's order (lam term, then m ascending)
    for (int e = threadIdx.x; e < rows * d; e += blockDim.x) {
      float au = 0.0f, auh = 0.0f;
      if (tb.nzbI[i]) au = tb.cbI[i] * lam_s[e];
      if (tb.nzbE[i]) auh = tb.cbE[i] * lam_s[e];
      for (int m = i + 1; m < s; ++m) {
        if (!active[m]) continue;
        if (tb.nzI[m][i]) au = au + tb.cI[m][i] * xis[m * tile + e];
        if (tb.nzE[m][i]) auh = auh + tb.cE[m][i] * xis[m * tile + e];
      }
      u[e] = au;
      uh[e] = sign * auh;  // backprop seed of f_EX = sign * MLP
    }
    __syncthreads();

    bool has_p = false;
    if (has_u && !implicit) {
      rows_matmul(u, d, rows, d, J, false, d, nullptr, kActNone, pv, d);
      has_p = true;
    }
    if (has_uh) {
      copy_rows(ys + ((size_t)i * B + row0) * d, d, hs, d, rows, d, 1.0f);
      copy_rows(uh, d, gA, d, rows, d, 1.0f);
      __syncthreads();
      mlp_forward_store(p, hs, rows, nullptr, 0);
      const float* dyE = mlp_backward(p, hs, rows, gA, gB, part, first_grad);
      first_grad = false;
      for (int e = threadIdx.x; e < rows * d; e += blockDim.x)
        pv[e] = has_p ? pv[e] + dyE[e] : dyE[e];
      has_p = true;
    }
    __syncthreads();

    float* xi = xis + i * tile;
    if (implicit) {
      if (has_u) {
        const float inv_dtg = tb.inv_dt[i];
        for (int e = threadIdx.x; e < rows * d; e += blockDim.x) {
          const float c = u[e] * inv_dtg;
          u[e] = c;
          q[e] = has_p ? c + pv[e] : c;
        }
        __syncthreads();
        rows_matmul(q, d, rows, d, inv, false, d, nullptr, kActNone, xi, d);
        __syncthreads();
        for (int e = threadIdx.x; e < rows * d; e += blockDim.x)
          xi[e] = xi[e] - u[e];
      } else {
        rows_matmul(pv, d, rows, d, inv, false, d, nullptr, kActNone, xi, d);
      }
    } else {
      copy_rows(pv, d, xi, d, rows, d, 1.0f);
    }
    __syncthreads();
    for (int e = threadIdx.x; e < rows * d; e += blockDim.x)
      lp[e] = lp[e] + xi[e];
    __syncthreads();
  }

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
