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
// backward recomputes its layer inputs. Both variance branches of
// BatchStatsNorm (single pass above 2^20 elements, centered below) run,
// chosen per layer.
//
// K7 and K9 (sqnxt_bwd_kernel<5> and <1>, redesigned) have their own tile
// code, forward recompute included, in csrc/sqnxt_bwd.cuh, whose note
// gives their bound and design: row tiles shaped to each layer, each input
// staged once with its halo, g_z kept in shared memory, two grid barriers
// per backward layer, dynamic shared memory sized per launch. Their entry
// points own the grid (pnode_sqnxt_bwd_plan) and take one scratch
// allocation whose size they check.
#include <cooperative_groups.h>

#include <cstdint>
#include <mutex>

#include "sqnxt_bwd.cuh"
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
int make_chain(Chain<kLayers>* c, int nl, const int* ints, void* const* ptrs,
               int N, int H, int W) {
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
  int rc = make_chain(&c, nl, ints, ptrs, N, H, W);
  if (rc) return rc;
  if (grid < 1) return (int)cudaErrorInvalidValue;
  void* args[] = {(void*)&c, (void*)&x, (void*)&out, (void*)&part};
  rc = (int)cudaLaunchCooperativeKernel((const void*)sqnxt_fwd_kernel<kLayers>,
                                        dim3(grid), dim3(kThreads), args, 0,
                                        (cudaStream_t)stream);
  if (rc) return rc;
  return (int)cudaGetLastError();
}

// -- K7 and K9 --------------------------------------------------------------

namespace sb = sqnxt_bwd;

// K7 (kLayers 5) and K9 (kLayers 1): the forward recompute, then every
// layer's backward in reverse (csrc/sqnxt_bwd.cuh). The plan rides as a
// __grid_constant__ parameter, copied once into shared memory.
template <int kLayers>
__global__ void __launch_bounds__(sb::kThreads, 1)
sqnxt_bwd_kernel(const __grid_constant__ sb::Chain c,
                 const float* __restrict__ x, const float* __restrict__ g,
                 float* dx, float* scratch) {
  extern __shared__ float4 sqnxt_bwd_smem[];
  SQNXT_BWD_NS(0);
  SQNXT_BWD_MARK(sb::kMarks - 2);
  float* base = reinterpret_cast<float*>(sqnxt_bwd_smem);
  const int* src = reinterpret_cast<const int*>(&c);
  int* dst = reinterpret_cast<int*>(base);
  for (int e = threadIdx.x; e < (int)(sizeof(sb::Chain) / 4); e += sb::kThreads)
    dst[e] = src[e];
  __syncthreads();
  const sb::Smem& s = sb::shared_view(base);
  sb::stage_norm_params(s);
  cg::grid_group grid = cg::this_grid();
  const size_t slot_size = (size_t)gridDim.x * sb::kMaxQ * sb::kMaxC;
  float* part = scratch;
  float* dwpart = scratch + 2 * slot_size;
  float* gbuf = dwpart + (size_t)gridDim.x * c.dw_stride;
  int slot = 0;
  sb::forward_recompute(s, x, part, slot_size, slot, grid);
#pragma unroll 1
  for (int l = kLayers - 1; l >= 0; --l) {
    const float* gin =
        l == kLayers - 1 ? g : gbuf + (size_t)((l + 1) & 1) * c.gstride;
    float* gout = l == 0 ? dx : gbuf + (size_t)(l & 1) * c.gstride;
    // gout is complete at backward_layer's second grid.sync, before the
    // ordered dW sum: the next layer reads it with no further barrier
    sb::backward_layer(s, l, x, gin, gout, part, slot_size, slot, dwpart,
                       grid);
  }
  SQNXT_BWD_MARK(sb::kMarks - 1);
  SQNXT_BWD_NS(1);
}

// The layer table from ints (per layer cin, cout, taps, axis, single_pass)
// and its plan; cudaErrorInvalidValue for a chain the kernels do not take.
int bwd_shape(sb::Chain* c, int nl, const int* ints, int N, int H, int W) {
  if (nl < 1 || nl > sb::kMaxLayers || N < 1 || H < 1 || W < 1 ||
      N % (H * W) != 0)
    return (int)cudaErrorInvalidValue;
  *c = sb::Chain{};
  c->nl = nl;
  c->N = N;
  c->H = H;
  c->W = W;
  c->inv_n = (float)(1.0 / (double)N);
  for (int l = 0; l < nl; ++l) {
    sb::Layer& p = c->L[l];
    const int* q = ints + l * kIntsPerLayer;
    p.cin = q[0];
    p.cout = q[1];
    p.taps = q[2];
    p.axis = q[3];
    p.single_pass = q[4];
    if (p.cin < 1 || p.cin > sb::kMaxC || p.cout < 1 || p.cout > sb::kMaxC)
      return (int)cudaErrorInvalidValue;
    if (!((p.taps == 1 && p.axis == 0) ||
          (p.taps == 3 && (p.axis == 1 || p.axis == 2))))
      return (int)cudaErrorInvalidValue;
    if (l > 0 && p.cin != c->L[l - 1].cout) return (int)cudaErrorInvalidValue;
  }
  return sb::plan(*c) ? (int)cudaErrorInvalidValue : 0;
}

int bwd_pointers(sb::Chain* c, void* const* ptrs) {
  for (int l = 0; l < c->nl; ++l) {
    sb::Layer& p = c->L[l];
    void* const* v = ptrs + l * kPtrsPerLayer;
    for (int k = 0; k < kPtrsPerLayer; ++k)
      if (!v[k]) return (int)cudaErrorInvalidValue;
    p.w = (const float*)v[0];
    p.b = (const float*)v[1];
    p.gam = (const float*)v[2];
    p.bet = (const float*)v[3];
    p.z = (float*)v[4];
    p.dw = (float*)v[5];
    p.db = (float*)v[6];
    p.dgam = (float*)v[7];
    p.dbet = (float*)v[8];
  }
  return 0;
}

// Blocks per SM of a kernel at `smem` bytes of dynamic shared memory on
// the current device, raising its opt-in attribute where needed; cached
// per (kernel, device, size): the wrapper asks before every launch.
template <typename Kernel>
int bwd_occupancy(Kernel kernel, size_t smem, int* per_sm, int* sms) {
  struct Entry {
    const void* fn;
    int dev;
    size_t smem;
    int per_sm, sms;
  };
  static Entry cache[64];
  static int used = 0;
  static std::mutex mu;
  std::lock_guard<std::mutex> lock(mu);
  int dev = 0, rc;
  if ((rc = (int)cudaGetDevice(&dev))) return rc;
  for (int i = 0; i < used; ++i)
    if (cache[i].fn == (const void*)kernel && cache[i].dev == dev &&
        cache[i].smem == smem) {
      *per_sm = cache[i].per_sm;
      *sms = cache[i].sms;
      return 0;
    }
  int coop = 0, optin = 0;
  if ((rc = (int)cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch,
                                        dev)))
    return rc;
  if (!coop) return (int)cudaErrorNotSupported;
  if ((rc = (int)cudaDeviceGetAttribute(
           &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev)))
    return rc;
  if (smem > (size_t)optin) return (int)cudaErrorInvalidValue;
  if ((rc = (int)cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount,
                                        dev)))
    return rc;
  // the attribute only grows: a smaller launch stays within it
  int attr_max = 0;
  for (int i = 0; i < used; ++i)
    if (cache[i].fn == (const void*)kernel && cache[i].dev == dev &&
        (int)cache[i].smem > attr_max)
      attr_max = (int)cache[i].smem;
  if ((int)smem > attr_max &&
      (rc = (int)cudaFuncSetAttribute(
           kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem)))
    return rc;
  if ((rc = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           per_sm, kernel, sb::kThreads, smem)))
    return rc;
  if (*per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  if (used < 64) cache[used++] = Entry{(const void*)kernel, dev, smem, *per_sm,
                                       *sms};
  return 0;
}

// The cooperative grid: co-resident blocks at the plan's shared memory,
// at most the largest tile count of any pass.
template <int kLayers>
int bwd_grid(const sb::Chain& c, int* grid) {
  int per_sm = 0, sms = 0;
  const int rc = bwd_occupancy(sqnxt_bwd_kernel<kLayers>,
                               (size_t)c.smem_floats * 4, &per_sm, &sms);
  if (rc) return rc;
  int tiles = 1;
  for (int l = 0; l < c.nl; ++l) {
    const int tf = (c.N + c.L[l].tn_f - 1) / c.L[l].tn_f;
    const int tb = (c.N + c.L[l].tn_b - 1) / c.L[l].tn_b;
    tiles = tiles > tf ? tiles : tf;
    tiles = tiles > tb ? tiles : tb;
  }
  *grid = per_sm * sms < tiles ? per_sm * sms : tiles;
  return 0;
}

int bwd_plan(int nl, const int* ints, int N, int H, int W, int* grid,
             long long* scratch) {
  sb::Chain c;
  int rc = bwd_shape(&c, nl, ints, N, H, W);
  if (rc) return rc;
  if (nl == 5)
    rc = bwd_grid<5>(c, grid);
  else if (nl == 1)
    rc = bwd_grid<1>(c, grid);
  else
    return (int)cudaErrorInvalidValue;
  if (rc) return rc;
  *scratch = (long long)sb::scratch_floats(c, *grid);
  return 0;
}

template <int kLayers>
int launch_bwd(const float* x, const float* g, float* dx, int nl,
               const int* ints, void* const* ptrs, int N, int H, int W,
               float* scratch, long long scratch_floats, int grid,
               void* stream) {
  sb::Chain c;
  if (nl != kLayers || !x || !g || !dx || !scratch)
    return (int)cudaErrorInvalidValue;
  int rc = bwd_shape(&c, nl, ints, N, H, W);
  if (rc || (rc = bwd_pointers(&c, ptrs))) return rc;
  int want = 0;
  if ((rc = bwd_grid<kLayers>(c, &want))) return rc;
  if (grid != want ||
      scratch_floats != (long long)sb::scratch_floats(c, grid))
    return (int)cudaErrorInvalidValue;
  void* args[] = {(void*)&c, (void*)&x, (void*)&g, (void*)&dx,
                  (void*)&scratch};
  rc = (int)cudaLaunchCooperativeKernel(
      (const void*)sqnxt_bwd_kernel<kLayers>, dim3(grid), dim3(sb::kThreads),
      args, (size_t)c.smem_floats * 4, (cudaStream_t)stream);
  if (rc) return rc;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Co-resident blocks of kernel `which` (0: K6, 2: K8) on the current
// device: blocks per SM x SMs. Fails without cooperative launch. K7's and
// K9's grids depend on the launch's shared memory: pnode_sqnxt_bwd_plan.
int pnode_sqnxt_capacity(int which, int* blocks) {
  switch (which) {
    case 0: return capacity(sqnxt_fwd_kernel<5>, blocks);
    case 2: return capacity(sqnxt_fwd_kernel<1>, blocks);
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

// K7 (nl 5) and K9 (nl 1): the grid their launch takes and the floats of
// its one scratch allocation (two partial-slot buffers of grid x 4 x 128,
// grid dW slots of round4(max taps * cin * cout), and for nl 5 two g
// buffers of max cin_l * N, l >= 1). ints as for pnode_sqnxt_fwd.
int pnode_sqnxt_bwd_plan(int nl, const int* ints, int N, int H, int W,
                         int* grid, long long* scratch_floats) {
  return bwd_plan(nl, ints, N, H, W, grid, scratch_floats);
}

// dx (cin_0, N) and every layer's dw, db, dgam, dbet from x and the output
// cotangent g. ptrs: per layer w, b, gam, bet, z (cout, N) workspace, dw,
// db, dgam, dbet. grid and scratch_floats must equal the plan's (else
// cudaErrorInvalidValue).
int pnode_sqnxt_bwd(const float* x, const float* g, float* dx, int nl,
                    const int* ints, void* const* ptrs, int N, int H, int W,
                    float* scratch, long long scratch_floats, int grid,
                    void* stream) {
  return launch_bwd<5>(x, g, dx, nl, ints, ptrs, N, H, W, scratch,
                       scratch_floats, grid, stream);
}

int pnode_sqnxt_bwd_layer(const float* x, const float* g, float* dx, int nl,
                          const int* ints, void* const* ptrs, int N, int H,
                          int W, float* scratch, long long scratch_floats,
                          int grid, void* stream) {
  return launch_bwd<1>(x, g, dx, nl, ints, ptrs, N, H, W, scratch,
                       scratch_floats, grid, stream);
}

#ifdef SQNXT_BWD_TRACE
// The last K7/K9 launch's phase marks (csrc/sqnxt_bwd.cuh): kMarks
// clock64() values, then the two globaltimer readings.
int pnode_sqnxt_bwd_marks(long long* marks, unsigned long long* ns) {
  int rc = (int)cudaMemcpyFromSymbol(marks, sb::marks, sizeof(sb::marks));
  if (rc) return rc;
  return (int)cudaMemcpyFromSymbol(ns, sb::ns, sizeof(sb::ns));
}
#endif

}  // extern "C"
