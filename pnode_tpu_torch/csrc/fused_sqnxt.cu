// K6-K9: the fused SqueezeNext ODE dynamics (the CIFAR-10 ODE-net's
// BasicBlock2: five layers of conv -> +b -> batch-stats norm -> ReLU), and
// their stage-exact backward.
//
// Replaces pnode_tpu/ops/fused_sqnxt.py:
//   K6 sqnxt_fwd_kernel<5>    _fwd_kernel (:192), launched at :339
//   K7 sqnxt_bwd_kernel<5>    _bwd_kernel (:206), launched at :361
//   K8 sqnxt_fwd_kernel<1>    _fwd_layer_kernel (:508), launched at :589
//   K9 sqnxt_bwd_kernel<1>    _bwd_layer_kernel (:522), launched at :632
// K6/K7 run the whole chain in one launch (stages 2-3 of the model); K8/K9
// one layer per launch (stage 1, whose five anchors are 46 MB at B 128).
//
// What bounds them on the H100: one chain evaluation is 4.5 D^2 N FLOP
// (604 MFLOP at every ODE stage of the full-width model, ~9 us at the 67
// TFLOP/s fp32 CUDA-core peak) against 2 D N 4 B of input and output (33.6
// MB at stage 1, ~10 us at 3.35 TB/s): balanced, so neither bound is far.
// What the TPU kernel got for free and this card does not: the batch
// statistics are a reduction over all N per channel, inside the chain, five
// times (ten with the centered variance's second pass, more backward). The
// TPU held all of N in one core's VMEM; here N spreads over every SM.
//
// Design (simple and right first; the tile functions are in
// csrc/sqnxt_kernels.cuh): one
// cooperative launch per call, its grid min(co-resident blocks, N / 64
// tiles), blocks striding over 64-column tiles. Per layer: the conv as a
// shared-memory tiled fp32-FMA product (no tensor cores, no TF32), the
// shifted taps read with their image-boundary masks from the previous
// layer's anchor in device memory (the (3,1) taps reach +-W columns, across
// tiles, so a layer starts only after the one before it is complete: a
// grid.sync() separates them); the anchor z_l (conv + bias) written to a
// device workspace, the counterpart of the TPU kernel's VMEM scratch
// (:368-370; at stages 2-3 it is 11.5-23 MB and stays in the 50 MB L2);
// the per-channel statistics as per-block partials, a grid.sync(), and an
// ordered sum in every block (no atomics: bitwise repeatable). A layer's
// ReLU(norm(z)) is never stored: the next layer's loads recompute it from
// the anchor and the statistics in shared memory, as the TPU kernel's
// backward recomputes its layer inputs. The backward recomputes the forward
// from x (five anchors), then per layer in reverse: the four row sums of
// the norm's backward, a barrier, g_z into device memory with d_b's sums, a
// barrier, dW as per-block (Cout x taps*Cin) partials over the block's
// columns and g_h gathered from g_z at n - s_t, a barrier, and the dW
// partials summed in block order. Both variance branches of BatchStatsNorm
// (single pass above 2^20 elements, centered below) run, chosen per layer.
#include <cooperative_groups.h>

#include <cstdint>

#include "sqnxt_kernels.cuh"

using namespace sqnxt;

namespace {

constexpr int kIntsPerLayer = 5;  // cin, cout, taps, axis, single_pass
constexpr int kPtrsPerLayer = 9;  // w, b, gam, bet, z, dw, db, dgam, dbet

template <int kLayers>
__global__ void __launch_bounds__(kThreads)
sqnxt_fwd_kernel(Chain<kLayers> c, const float* __restrict__ x, float* out,
                 float* part) {
  cg::grid_group grid = cg::this_grid();
  __shared__ Smem<kLayers> s;
  const size_t slot_size = (size_t)gridDim.x * kMaxQ * kMaxC;
  int slot = 0;
  forward_chain(c, s, x, part, slot_size, slot, grid);
  normalize_out(c, s, out);
}

template <int kLayers>
__global__ void __launch_bounds__(kThreads)
sqnxt_bwd_kernel(Chain<kLayers> c, const float* __restrict__ x,
                 const float* __restrict__ g, float* dx, float* part,
                 float* dwpart, int dw_stride, float* gbuf, size_t gstride,
                 float* gz) {
  cg::grid_group grid = cg::this_grid();
  __shared__ Smem<kLayers> s;
  const size_t slot_size = (size_t)gridDim.x * kMaxQ * kMaxC;
  int slot = 0;
  forward_chain(c, s, x, part, slot_size, slot, grid);
#pragma unroll
  for (int l = kLayers - 1; l >= 0; --l) {
    const float* gin = l == kLayers - 1 ? g : gbuf + (size_t)((l + 1) & 1) * gstride;
    float* gout = l == 0 ? dx : gbuf + (size_t)(l & 1) * gstride;
    // gout is complete at backward_layer's last grid.sync, before the
    // ordered dW sum: the next layer reads it with no further barrier
    backward_layer(c, s, l, x, gin, gout, gz, part, slot_size, slot, dwpart,
                   dw_stride, grid);
  }
}

template <int kLayers>
int make_chain(Chain<kLayers>* c, int nl, const int* ints, void* const* ptrs,
               int N, int H, int W, bool backward) {
  if (nl != kLayers || N < 1 || H < 1 || W < 1 || N % (H * W) != 0)
    return (int)cudaErrorInvalidValue;
  for (int l = 0; l < kLayers; ++l) {
    Layer& p = c->L[l];
    const int* q = ints + l * kIntsPerLayer;
    void* const* v = ptrs + l * kPtrsPerLayer;
    p.cin = q[0];
    p.cout = q[1];
    p.taps = q[2];
    p.axis = q[3];
    p.single_pass = q[4];
    if (p.cin < 1 || p.cin > kMaxC || p.cout < 1 || p.cout > kMaxC)
      return (int)cudaErrorInvalidValue;
    if (!((p.taps == 1 && p.axis == 0) ||
          (p.taps == 3 && (p.axis == 1 || p.axis == 2))))
      return (int)cudaErrorInvalidValue;
    if (l > 0 && p.cin != c->L[l - 1].cout) return (int)cudaErrorInvalidValue;
    p.w = (const float*)v[0];
    p.b = (const float*)v[1];
    p.gam = (const float*)v[2];
    p.bet = (const float*)v[3];
    p.z = (float*)v[4];
    p.dw = (float*)v[5];
    p.db = (float*)v[6];
    p.dgam = (float*)v[7];
    p.dbet = (float*)v[8];
    if (!p.w || !p.b || !p.gam || !p.bet || !p.z)
      return (int)cudaErrorInvalidValue;
    if (backward && (!p.dw || !p.db || !p.dgam || !p.dbet))
      return (int)cudaErrorInvalidValue;
  }
  c->N = N;
  c->H = H;
  c->W = W;
  c->inv_n = (float)(1.0 / (double)N);
  return 0;
}

template <typename Kernel>
int capacity(Kernel kernel, int* blocks) {
  int dev = 0, coop = 0, sms = 0, per_sm = 0, rc;
  if ((rc = (int)cudaGetDevice(&dev))) return rc;
  if ((rc = (int)cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch,
                                        dev)))
    return rc;
  if (!coop) return (int)cudaErrorNotSupported;
  if ((rc = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                        dev)))
    return rc;
  if ((rc = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kernel, kThreads, 0)))
    return rc;
  *blocks = per_sm * sms;
  return 0;
}

template <int kLayers>
int launch_fwd(const float* x, float* out, int nl, const int* ints,
               void* const* ptrs, int N, int H, int W, float* part, int grid,
               void* stream) {
  Chain<kLayers> c;
  int rc = make_chain(&c, nl, ints, ptrs, N, H, W, false);
  if (rc) return rc;
  if (grid < 1) return (int)cudaErrorInvalidValue;
  void* args[] = {(void*)&c, (void*)&x, (void*)&out, (void*)&part};
  rc = (int)cudaLaunchCooperativeKernel((const void*)sqnxt_fwd_kernel<kLayers>,
                                        dim3(grid), dim3(kThreads), args, 0,
                                        (cudaStream_t)stream);
  if (rc) return rc;
  return (int)cudaGetLastError();
}

template <int kLayers>
int launch_bwd(const float* x, const float* g, float* dx, int nl,
               const int* ints, void* const* ptrs, int N, int H, int W,
               float* part, float* dwpart, int dw_stride, float* gbuf,
               float* gz, int grid, void* stream) {
  Chain<kLayers> c;
  int rc = make_chain(&c, nl, ints, ptrs, N, H, W, true);
  if (rc) return rc;
  if (grid < 1) return (int)cudaErrorInvalidValue;
  size_t gstride = 0;
  for (int l = 0; l < kLayers; ++l)
    if ((size_t)c.L[l].cin * N > gstride) gstride = (size_t)c.L[l].cin * N;
  void* args[] = {(void*)&c,      (void*)&x,        (void*)&g,
                  (void*)&dx,     (void*)&part,     (void*)&dwpart,
                  (void*)&dw_stride, (void*)&gbuf,  (void*)&gstride,
                  (void*)&gz};
  rc = (int)cudaLaunchCooperativeKernel((const void*)sqnxt_bwd_kernel<kLayers>,
                                        dim3(grid), dim3(kThreads), args, 0,
                                        (cudaStream_t)stream);
  if (rc) return rc;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Co-resident blocks of kernel `which` (0: K6, 1: K7, 2: K8, 3: K9) on the
// current device: blocks per SM x SMs. Fails without cooperative launch.
int pnode_sqnxt_capacity(int which, int* blocks) {
  switch (which) {
    case 0: return capacity(sqnxt_fwd_kernel<5>, blocks);
    case 1: return capacity(sqnxt_bwd_kernel<5>, blocks);
    case 2: return capacity(sqnxt_fwd_kernel<1>, blocks);
    case 3: return capacity(sqnxt_bwd_kernel<1>, blocks);
    default: return (int)cudaErrorInvalidValue;
  }
}

// K6 (nl 5) and K8 (nl 1): out (cout_last, N) from x (cin_0, N). ints: per
// layer cin, cout, taps, axis (0 1x1, 1 j, 2 i), single_pass; ptrs: per
// layer w (taps, cout, cin), b, gam, bet, z (cout, N) workspace, then four
// unused slots. part: 2 * grid * 4 * 128 floats. grid must not exceed
// pnode_sqnxt_capacity's answer.
int pnode_sqnxt_fwd(const float* x, float* out, int nl, const int* ints,
                    void* const* ptrs, int N, int H, int W, float* part,
                    int grid, void* stream) {
  return launch_fwd<5>(x, out, nl, ints, ptrs, N, H, W, part, grid, stream);
}

int pnode_sqnxt_fwd_layer(const float* x, float* out, int nl, const int* ints,
                          void* const* ptrs, int N, int H, int W, float* part,
                          int grid, void* stream) {
  return launch_fwd<1>(x, out, nl, ints, ptrs, N, H, W, part, grid, stream);
}

// K7 (nl 5) and K9 (nl 1): dx (cin_0, N) and every layer's dw, db, dgam,
// dbet from x and the output cotangent g. dwpart: grid * dw_stride floats
// (dw_stride >= max taps * cin * cout); gbuf: 2 * max cin * N floats; gz:
// max cout * N floats.
int pnode_sqnxt_bwd(const float* x, const float* g, float* dx, int nl,
                    const int* ints, void* const* ptrs, int N, int H, int W,
                    float* part, float* dwpart, int dw_stride, float* gbuf,
                    float* gz, int grid, void* stream) {
  return launch_bwd<5>(x, g, dx, nl, ints, ptrs, N, H, W, part, dwpart,
                       dw_stride, gbuf, gz, grid, stream);
}

int pnode_sqnxt_bwd_layer(const float* x, const float* g, float* dx, int nl,
                          const int* ints, void* const* ptrs, int N, int H,
                          int W, float* part, float* dwpart, int dw_stride,
                          float* gbuf, float* gz, int grid, void* stream) {
  return launch_bwd<1>(x, g, dx, nl, ints, ptrs, N, H, W, part, dwpart,
                       dw_stride, gbuf, gz, grid, stream);
}

}  // extern "C"
