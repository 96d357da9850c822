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
// What bounds it on the H100: one iteration is one K2 and one K3 at the
// same shapes (~0.4 GFLOP at B 256, latency and L2 weight streaming bound),
// plus an Adam update of the 46,240 KS parameters. The TPU ran the whole
// batch on one core, so the dW sum before each update was free; here it
// crosses blocks. Per-step launches left the host in the step: the device
// worked ~0.96 ms of a 2.0-4.2 ms step on the per-step kernel path.
//
// Design: one cooperative launch (all blocks co-resident, so a grid-wide
// barrier cannot deadlock) runs every iteration of the call:
//   phase A, per block of 8 rows: the forward step with all s stage values
//     kept in shared memory (never written to device memory), the loss and
//     its seed, and the reverse step (recomputing each stage's layer inputs;
//     the TPU kernel cached them). The block writes its dW/db
//     partial and its partial loss sum to its own scratch slice. Rows past B
//     are never computed, the counterpart of the TPU's row_mask.
//   grid.sync()
//   phase B, every thread of the grid: for its slice of the parameters, sum
//     the block partials in block order (deterministic, no atomics) and
//     update W, b, m and v in place; thread 0 sums the loss partials in
//     block order and writes losses[k].
//   grid.sync()
// The grid is min(ceil(B/8), co-resident blocks); blocks stride over row
// tiles beyond it. Weights and biases change inside the launch, so phase A
// reads them with coherent loads (load_operand<true>), never through the
// read-only path. Parameters and moments live in one flat [W0, b0, W1, b1,
// ...] buffer each, the layout of the gradient partials, so phase B is one
// loop over that layout. (K12, one iteration's phase A without Adam, is
// csrc/fused_grad_step.cu.)
#include <cooperative_groups.h>

#include <cmath>
#include <cstdint>

#include "pnode_kernels.cuh"

namespace cg = cooperative_groups;

namespace pnode {

constexpr int kReduceFloats = 32;  // per-warp loss sums

// Shared-memory layout of one block, in floats: the s stage values and the
// seed tile persist from the forward to the reverse; the forward's and the
// reverse's scratch overlay each other.
struct LoopSmem {
  int tile, fwd, rev, total;
  __host__ __device__ LoopSmem(int d, int s, int maxd, int htotal) {
    tile = kRows * d;
    fwd = tile * (2 + 2 * s) + 2 * kRows * maxd;          // y, kI, kE, G, a, b
    rev = tile * (s + 4) + htotal + 2 * kRows * maxd;     // xis, u, uh, pv, q,
                                                          // hs, gA, gB
    total = tile * (s + 1) + (fwd > rev ? fwd : rev) + kReduceFloats;
  }
};

// Phase A of one training iteration on this block's 8-row tiles (tiles
// blockIdx.x, + gridDim.x, ...): the forward step with all s stage values
// kept in shared memory, the squared error and its seed two_inv_count (y1 -
// tgt), and the reverse step into this block's dW/db partial `part` (the
// first tile overwrites it, later tiles add). Rows past B are never
// computed. Returns the block's sum of squared differences in thread 0.
// kCoherent: K4 rewrites the weights between iterations of one launch.
template <bool kCoherent>
__device__ __forceinline__ float loop_phase_a(
    const float* y, const float* tgt, const float* J, const float* inv, int B,
    int d, const Tableau& tb, float sign, const Mlp& p, float two_inv_count,
    float* smem, float* part) {
  const int s = tb.s;
  const LoopSmem lay(d, s, p.maxd, p.htotal);
  const int tile = lay.tile;
  float* Ys = smem;                   // s tiles: the stage values
  float* lam = Ys + s * tile;         // y1, then the loss seed
  float* work = lam + tile;
  // forward scratch
  float* yv = work;
  float* kI = yv + tile;
  float* kE = kI + s * tile;
  float* G = kE + s * tile;
  float* a = G + tile;
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
  float* red = smem + lay.total - kReduceFloats;

  const int ntiles = (B + kRows - 1) / kRows;
  bool first_grad = true;
  float lsum = 0.0f;
  for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
    const int row0 = t * kRows;
    const int rows = min(kRows, B - row0);
    copy_rows(y + (size_t)row0 * d, d, yv, d, rows, d, 1.0f);
    __syncthreads();
    ark_forward_tile<kCoherent>(p, tb, sign, J, inv, d, rows, yv, kI, kE, G,
                                Ys, tile, nullptr, 0, a, b, lam);
    __syncthreads();
    for (int e = threadIdx.x; e < rows * d; e += blockDim.x) {
      const float diff = lam[e] - tgt[(size_t)row0 * d + e];
      lsum = fmaf(diff, diff, lsum);
      lam[e] = two_inv_count * diff;
    }
    __syncthreads();
    ark_reverse_tile<kCoherent>(p, tb, sign, J, inv, d, rows, lam, Ys,
                                (size_t)tile, xis, u, uh, pv, q, hs, gA, gB,
                                nullptr, part, first_grad);
    __syncthreads();
  }
  if (first_grad) {  // no stage of any tile reached the MLP
    for (int e = threadIdx.x; e < p.wtotal; e += blockDim.x) part[e] = 0.0f;
  }
  return block_sum(lsum, red);
}

__global__ void __launch_bounds__(kThreads)
train_loop_kernel(const float* __restrict__ y_stack,
                  const float* __restrict__ tgt_stack,
                  const float* __restrict__ J, const float* __restrict__ inv,
                  float* params, float* m_state, float* v_state,
                  float* partial, float* lpart, float* losses, int K, int B,
                  int d, Tableau tb, float sign, Mlp p, Adam adam, int t0,
                  float inv_count, float two_inv_count) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ float smem[];
  float* part = partial + (size_t)blockIdx.x * p.wtotal;
  const int gtid = blockIdx.x * blockDim.x + threadIdx.x;

  for (int k = 0; k < K; ++k) {
    // ---- phase A: this block's row tiles ----------------------------------
    const float block_loss = loop_phase_a<true>(
        y_stack + (size_t)k * B * d, tgt_stack + (size_t)k * B * d, J, inv, B,
        d, tb, sign, p, two_inv_count, smem, part);
    if (threadIdx.x == 0) lpart[blockIdx.x] = block_loss;
    grid.sync();

    // ---- phase B: ordered sum of the partials, then Adam ------------------
    sum_partials_adam(adam, t0 + k + 1, partial, p.wtotal, params, m_state,
                      v_state);
    if (gtid == 0) {
      float l = 0.0f;
      for (int blk = 0; blk < (int)gridDim.x; ++blk)
        l += __ldcg(lpart + blk);
      losses[k] = l * inv_count;
    }
    grid.sync();
  }
}

}  // namespace pnode

using namespace pnode;

extern "C" {

// Shared memory of one train_loop_kernel block, in bytes (mirrored by
// fused_train_loop.py's fits check).
size_t pnode_train_loop_smem(int d, int s, int maxd, int htotal) {
  return sizeof(float) * (size_t)LoopSmem(d, s, maxd, htotal).total;
}

// Co-resident train_loop_kernel blocks on the current device with `smem`
// bytes of dynamic shared memory each (blocks per SM x SMs), into *blocks.
// Fails when the device has no cooperative launch.
int pnode_train_loop_capacity(size_t smem, int* blocks) {
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
  if ((rc = prepare_smem(train_loop_kernel, smem))) return rc;
  if ((rc = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, train_loop_kernel, kThreads, smem)))
    return rc;
  *blocks = per_sm * sms;
  return 0;
}

// K iterations on y_stack, tgt_stack (K, B, d). params, m, v: flat [W0, b0,
// W1, b1, ...] buffers of the stack (dims[0..n_layers]), updated in place.
// partial: grid * wtotal floats of scratch; lpart: grid floats; losses: K.
// tab: host doubles aI (s*s), aE (s*s), bI (s), bE (s). grid must not
// exceed pnode_train_loop_capacity's answer (the cooperative launch refuses
// it otherwise).
int pnode_train_loop(const float* y_stack, const float* tgt_stack,
                     const float* J, const float* inv, float* params,
                     float* m_state, float* v_state, float* partial,
                     float* lpart, float* losses, int K, int B, int d, int s,
                     const double* tab, double dt, float sign, int n_layers,
                     const int* dims, int act, int t0, float lr, double b1,
                     double b2, double eps, int grid, void* stream) {
  if (K < 1 || B < 1 || grid < 1) return cudaErrorInvalidValue;
  Mlp p;
  Tableau tb;
  int rc = flat_mlp(&p, params, n_layers, dims, d, act);
  if (rc) return rc;
  if ((rc = make_tableau(&tb, s, tab, dt))) return rc;
  const Adam adam = make_adam(lr, b1, b2, eps);
  const float inv_count = (float)(1.0 / ((double)B * d));
  const float two_inv_count = (float)(2.0 / ((double)B * d));
  const size_t smem = pnode_train_loop_smem(d, s, p.maxd, p.htotal);
  if ((rc = prepare_smem(train_loop_kernel, smem))) return rc;
  void* args[] = {(void*)&y_stack, (void*)&tgt_stack, (void*)&J,
                  (void*)&inv,     (void*)&params,    (void*)&m_state,
                  (void*)&v_state, (void*)&partial,   (void*)&lpart,
                  (void*)&losses,  (void*)&K,         (void*)&B,
                  (void*)&d,       (void*)&tb,        (void*)&sign,
                  (void*)&p,       (void*)&adam,      (void*)&t0,
                  (void*)&inv_count, (void*)&two_inv_count};
  rc = (int)cudaLaunchCooperativeKernel((const void*)train_loop_kernel,
                                        dim3(grid), dim3(kThreads), args,
                                        smem, (cudaStream_t)stream);
  if (rc) return rc;
  return (int)cudaGetLastError();
}

}  // extern "C"
