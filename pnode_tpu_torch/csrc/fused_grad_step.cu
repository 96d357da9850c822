// K12: one training iteration's forward ARK step, one-step MSE and
// stage-exact reverse step, the loss and the flat gradient of the local
// shard without Adam: the per-rank kernel of the data-parallel loop.
//
// Replaces pnode_tpu/ops/fused_train_loop.py: _grad_kernel (:613),
// launched by fused_grad_step (:688) from parallel/fused_dp.py. Scope: K2's
// and K3's (ksponly, a frozen linear implicit part with its pre-inverted
// stage operator, f_EX = sign * MLP), plus the seed
//
//   lam = 2 (y1 - tgt) / count,   loss = sum((y1 - tgt)^2) / count
//
// (count the local B d unless the caller gives the global one). The caller
// all-reduces the loss and the gradient and runs Adam.
//
// What bounds it on the H100: one K2 and one K3 at the same shapes (~0.38
// GFLOP at the KS shard of B 256, 5.6 us at the fp32 peak), latency bound.
// Design: one ordinary launch (no co-residency to guarantee, so several
// processes can share one card) of R rows per block from the plan
// (plan_rev, grad), each block one tile: ark::forward_step with its stage
// values and y1 kept in shared memory, the squared error and the seed in
// place of y1, then ark::reverse_step from those stage values into the
// block's dW/db partial, and the block's loss sum after it. inv and J are
// staged once for both where they fit (else the forward streams them
// through the ring and the reverse reads them in place); the forward's
// scratch and the reverse's overlay each other; the weight ring is shared.
// A second launch (grad_step_sum_kernel) sums the partials and the losses
// in block order (deterministic, no atomics). The weights do not change
// during the launch, so the biases are read through the read-only path.
//
// Rows per block, device us per call on an H100 SXM (PERF.md): B_local
// 256: R 1 329.8, R 2 169.6, R 4 199.9, R 8 427.5; B_local 128: R 1
// 157.1, R 2 165.4. The rule (K3's) takes R 2 and R 1 there.
#include <cstdint>

#include "ark_tiles.cuh"

namespace pnode {

// One block's tile; `partial`'s slice per block (slice_floats: wtotal + 1
// rounded up to a multiple of 4, so every slice is 16-byte aligned): its
// dW/db partial (wtotal floats), then its sum of squared differences.
template <int R>
__global__ void __launch_bounds__(ark::kThreads, 1)
grad_step_kernel(const float* __restrict__ y, const float* __restrict__ tgt,
                 float* __restrict__ partial, int B, float sign,
                 float two_inv_count, ark::StepArgs a, ark::RevPlan q) {
  extern __shared__ __align__(16) float smem[];
  ark::mark(ark::kMarkStart);
  const int d = a.m.dims[0];
  const int rows = min(R, B - (int)blockIdx.x * R);
  const size_t row0 = (size_t)blockIdx.x * R * d;
  float* Ys = smem + q.o_ys;
  float* seed = smem + q.o_lam;
  ark::forward_step<R>(a, a.tb, y + row0, seed, Ys, (size_t)R * d, nullptr,
                       rows, sign, true, smem);
  __syncthreads();
  ark::mark(ark::kMarkForward);
  float lsum = 0.0f;
  for (int e = threadIdx.x; e < rows * d; e += ark::kThreads) {
    const float diff = seed[e] - tgt[row0 + e];
    lsum = fmaf(diff, diff, lsum);
    seed[e] = two_inv_count * diff;
  }
  __syncthreads();
  ark::mark(ark::kMarkSeed);
  float* part = partial + (size_t)blockIdx.x * ark::round4(a.m.wtotal + 1);
  ark::reverse_step<R>(q, a.m, a.tb, a.J, a.inv, seed, Ys, (size_t)R * d,
                       nullptr, part, rows, sign, false, false, smem);
  const float block_loss = block_sum(lsum, smem + q.o_red);
  if (threadIdx.x == 0) part[a.m.wtotal] = block_loss;
  ark::mark(ark::kMarkEnd);
}

// out[i] = sum_b partial[b * slice + i], i <= wtotal, in block order
// (deterministic, no atomics); the last slot, the squared-error sum, times
// inv_count is the loss.
__global__ void grad_step_sum_kernel(const float* __restrict__ partial,
                                     int nblk, int wtotal, float inv_count,
                                     float* __restrict__ out) {
  const int n = wtotal + 1, slice = ark::round4(n);
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += gridDim.x * blockDim.x) {
    float acc = 0.0f;
    for (int b = 0; b < nblk; ++b) acc += partial[(size_t)b * slice + i];
    out[i] = i == wtotal ? acc * inv_count : acc;
  }
}

template <int R>
static int launch_grad(const float* y, const float* tgt, float* partial,
                       int B, float sign, float two_inv_count,
                       const ark::StepArgs& a, const ark::RevPlan& q,
                       cudaStream_t stream) {
  int rc = prepare_smem(grad_step_kernel<R>, q.smem);
  if (rc) return rc;
  grad_step_kernel<R><<<q.grid, ark::kThreads, q.smem, stream>>>(
      y, tgt, partial, B, sign, two_inv_count, a, q);
  return (int)cudaGetLastError();
}

}  // namespace pnode

using namespace pnode;

extern "C" {

// K12's plan for a (B, d) shard, s stages and the stack dims[0..n_layers]:
// rows per block, grid and shared-memory bytes (mirrored by
// ops/fused_ark_adjoint.py's grad_step_plan). cudaErrorInvalidValue when
// the configuration does not fit.
int pnode_grad_step_plan(int B, int d, int s, int n_layers, const int* dims,
                         int* rows, int* grid, long long* smem) {
  if (B < 1 || s < 1 || s > kMaxStages || n_layers < 1 ||
      n_layers > kMaxLayers || dims[0] != d || dims[n_layers] != d)
    return cudaErrorInvalidValue;
  for (int l = 0; l <= n_layers; ++l)
    if (dims[l] < 1) return cudaErrorInvalidValue;
  int sms, rc;
  if ((rc = ark::sm_count(&sms))) return rc;
  ark::RevPlan q;
  ark::Plan f;
  if (!ark::plan_rev(B, d, s, n_layers, dims, sms, ark::kRevGrad, 0, &q, &f))
    return cudaErrorInvalidValue;
  *rows = q.rows;
  *grid = q.grid;
  *smem = (long long)q.smem;
  return 0;
}

// One iteration's loss and gradient on y, tgt (B, d) without Adam. out
// (wtotal + 1 floats): the flat [W0, b0, W1, b1, ...] gradient, then the
// loss sum((y1 - tgt)^2) / count; the seed is 2 (y1 - tgt) / count.
// params: the flat [W0, b0, ...] buffer of the stack (read only). tab:
// host doubles aI (s*s), aE (s*s), bI (s), bE (s). rows: 0 for the plan's
// rows per block, or 1, 2, 4 or 8 to force them. partial: scratch of grid
// slices of round4(wtotal + 1) floats at the launch's grid;
// `partial_floats` must say so (cudaErrorInvalidValue otherwise). Two
// ordinary launches on `stream`.
int pnode_grad_step(const float* y, const float* tgt, const float* J,
                    const float* inv, const float* params, float* partial,
                    float* out, int B, int d, int s, const double* tab,
                    double dt, float sign, int n_layers, const int* dims,
                    int act, double count, int rows, long long partial_floats,
                    void* stream) {
  if (B < 1 || !(count > 0.0)) return cudaErrorInvalidValue;
  ark::StepArgs a;
  a.J = J;
  a.inv = inv;
  int rc = flat_mlp(&a.m, params, n_layers, dims, d, act);
  if (rc) return rc;
  if ((rc = make_tableau(&a.tb, s, tab, dt))) return rc;
  int sms;
  if ((rc = ark::sm_count(&sms))) return rc;
  ark::RevPlan q;
  if (!ark::plan_rev(B, d, s, n_layers, dims, sms, ark::kRevGrad, rows, &q,
                     &a.p))
    return cudaErrorInvalidValue;
  if (partial_floats != (long long)q.grid * ark::round4(a.m.wtotal + 1))
    return cudaErrorInvalidValue;
  const float inv_count = (float)(1.0 / count);
  const float two_inv_count = (float)(2.0 / count);
  const cudaStream_t st = (cudaStream_t)stream;
  switch (q.rows) {
    case 1: rc = launch_grad<1>(y, tgt, partial, B, sign, two_inv_count, a,
                                q, st); break;
    case 2: rc = launch_grad<2>(y, tgt, partial, B, sign, two_inv_count, a,
                                q, st); break;
    case 4: rc = launch_grad<4>(y, tgt, partial, B, sign, two_inv_count, a,
                                q, st); break;
    default: rc = launch_grad<8>(y, tgt, partial, B, sign, two_inv_count, a,
                                 q, st); break;
  }
  if (rc) return rc;
  const int n = a.m.wtotal + 1;
  grad_step_sum_kernel<<<(n + ark::kThreads - 1) / ark::kThreads,
                         ark::kThreads, 0, st>>>(partial, q.grid,
                                                 a.m.wtotal, inv_count, out);
  return (int)cudaGetLastError();
}

#ifdef ARK_TRACE
// The last K12 launch's phase marks (as pnode_ark_adj_marks).
int pnode_grad_step_marks(long long* t, int* tags, int* n,
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
