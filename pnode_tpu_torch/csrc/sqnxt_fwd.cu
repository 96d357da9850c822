// K6 and K8: the forward of the fused SqueezeNext ODE dynamics (the
// CIFAR-10 ODE-net's BasicBlock2: five layers of conv -> +b -> batch-stats
// norm -> ReLU): fp32 FFMA on the CUDA cores (no TF32), and the bf16
// instances on the tensor cores (csrc/sqnxt_tiles.cuh note 9).
//
// Replaces pnode_tpu/ops/fused_sqnxt.py:
//   K6 sqnxt_fwd_kernel<5>    _fwd_kernel (:192), launched at :339
//   K8 sqnxt_fwd_kernel<1>    _fwd_layer_kernel (:508), launched at :589
// K6 runs the whole chain in one launch, (dim, N) -> (dim, N) (stages 2-3
// of the model); K8 one layer, (Cin, N) -> (Cout, N), five launches per
// evaluation (stage 1, whose five anchors are 46 MB at B 128).
//
// What bounds them on the H100 (67 TFLOP/s fp32 FFMA, 3.35 TB/s): a chain
// evaluation is 4.5 D^2 N FLOP, 604 MFLOP at every ODE stage of SqNxt-23
// at B 128, 9.0 us; K6 moves its x and out (8.4 MB each at stage 2, 5.0
// us), so it is set by operations. K8's five launches read and write
// every layer's input and output, 176 channels x N x 4 B = 92.3 MB at
// stage 1: 27.5 us, set by bytes. What the TPU kernel got for free and
// this card does not: the batch statistics are a reduction over all N per
// channel, inside the chain, after every layer (twice where the variance
// is centered). The TPU held all of N in one core's VMEM; here N spreads
// over every SM, so each layer ends at a grid barrier.
//
// Design (the tile functions are csrc/sqnxt_tiles.cuh's, shared with K7
// and K9, whose forward recompute is this same forward): one cooperative
// launch per call. Per layer, column tiles of 4096 / RT columns (RT the
// layer's rows rounded up to 8-128, halved tiles with a split reduction
// below 256 tiles), each tile's input staged once with its halo by
// cp.async and turned in place into the previous layer's ReLU(z sc + sh),
// a 4 x 4 register tile of fp32 FMAs per thread at every width; the row
// sums per block, a grid barrier, ordered sums of every block's partials
// (no atomics: two calls are bitwise equal), the next layer's weights
// copied in while the grid meets. Then the normalize-out pass writes
// out = ReLU(z sc + sh) of the last layer. A layer's anchor z_l goes to
// device memory only where another block reads it (the next layer's halo);
// the last layer's z and a centered layer's z stay in a store of the
// block's own tiles in shared memory where it fits 128 KB at the launch's
// grid (plan_fwd), so the normalize-out pass and the centered variance
// read shared memory, and K8 has no anchor at the CIFAR shapes. The entry
// points own the grid (pnode_sqnxt_fwd_plan: the largest co-resident grid
// at the plan's shared memory, at most the largest tile count) and take
// one scratch allocation (the partial slots and the anchors) whose size
// they check.
//
// Each kernel has two instances: fp32 (pnode_sqnxt_fwd, _fwd_layer) and
// bf16 storage (pnode_sqnxt_fwd_bf16, _fwd_layer_bf16: x, the taps, b, the
// anchors and out in bf16, the statistics in fp32, rounded where the JAX
// kernels cast; csrc/sqnxt_tiles.cuh note 8). The bf16 instances of K6
// and K8 stage their operands as bf16 and run their products on mma.sync
// with fp32 accumulation (note 9); the fp32 instances keep fp32 shared
// memory and FFMA. The bf16 instances' bound takes bf16 operands at the
// tensor cores' 989 TFLOP/s: 0.6 us for a chain evaluation, so bytes set
// it, 16.8 MB for the stage-1 chain's x, out and parameters at B 128, 5.0
// us, and 46.1 MB for K8's five launches there, 13.8 us.
#include <cooperative_groups.h>

#include <cstdint>

#include "sqnxt_tiles.cuh"

namespace {

namespace cg = cooperative_groups;
namespace sq = sqnxt;

constexpr int kPtrsPerLayer = 4;  // w, b, gam, bet
// Blocks per SM that __launch_bounds__ asks registers for: only the
// forward product is instantiated here, so two fit without spill
constexpr int kBlocksPerSm = 2;
constexpr int kMaxBlocksPerSm = 8;  // 2048 threads an SM

// K6 (kLayers 5) and K8 (kLayers 1), storage type T. The plan rides as a
// __grid_constant__ parameter, copied once into shared memory.
template <typename T, int kLayers>
__global__ void __launch_bounds__(sq::kThreads, kBlocksPerSm)
sqnxt_fwd_kernel(const __grid_constant__ sq::Chain c,
                 const T* __restrict__ x, T* out, float* part) {
  extern __shared__ float4 sqnxt_smem[];
  SQNXT_NS(0);
  SQNXT_MARK(sq::kMarks - 2);
  float* base = reinterpret_cast<float*>(sqnxt_smem);
  const int* src = reinterpret_cast<const int*>(&c);
  int* dst = reinterpret_cast<int*>(base);
  for (int e = threadIdx.x; e < (int)(sizeof(sq::Chain) / 4); e += sq::kThreads)
    dst[e] = src[e];
  __syncthreads();
  const sq::Smem& s = sq::shared_view(base);
  sq::stage_norm_params(s);
  cg::grid_group grid = cg::this_grid();
  const size_t slot_size = (size_t)gridDim.x * sq::kMaxQ * sq::kMaxC;
  int slot = 0;
  constexpr bool kTC = sq::kTensorCores<T>;
  sq::forward_layers<T, false, kTC>(s, x, part, slot_size, slot, grid);
  if constexpr (kTC)
    sq::tc::normalize_out(s, out);
  else
    sq::normalize_out(s, out);
  SQNXT_MARK(sq::kMarkBwd);
  SQNXT_MARK(sq::kMarks - 1);
  SQNXT_NS(1);
}

// The largest cooperative grid of kernel<kLayers> for the chain c (shaped
// by sq::shape): for k = 1, 2, ... blocks per SM, the grid min(k SMs,
// tiles) is planned (the store sized at that grid) and kept where that
// many blocks are co-resident at the plan's shared memory. c ends planned
// at the grid chosen. cudaErrorInvalidValue where no grid fits.
template <typename T, int kLayers>
int fwd_grid(sq::Chain& c, int* grid) {
  int dev = 0, sms = 0, rc;
  if ((rc = (int)cudaGetDevice(&dev)) ||
      (rc = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                        dev)))
    return rc;
  sq::derive(c, sq::kTensorCores<T>);
  int tiles = 1;
  for (int l = 0; l < c.nl; ++l) {
    const int t = (c.N + c.L[l].tn_f - 1) / c.L[l].tn_f;
    tiles = tiles > t ? tiles : t;
  }
  int best = 0, prev = 0;
  for (int k = 1; k <= kMaxBlocksPerSm; ++k) {
    const int g = k * sms < tiles ? k * sms : tiles;
    if (g == prev) break;
    prev = g;
    sq::plan_fwd(c, g, sq::kTensorCores<T>);
    int per_sm = 0, n_sm = 0;
    rc = sq::occupancy(sqnxt_fwd_kernel<T, kLayers>,
                       (size_t)c.smem_floats * 4, &per_sm, &n_sm);
    if (rc == (int)cudaErrorInvalidValue) continue;  // over the opt-in size
    if (rc) return rc;
    if (per_sm * n_sm >= g) best = g;
  }
  if (!best) return (int)cudaErrorInvalidValue;
  sq::plan_fwd(c, best, sq::kTensorCores<T>);
  *grid = best;
  return 0;
}

template <typename T>
int fwd_plan(int nl, const int* ints, int N, int H, int W, int* grid,
             long long* scratch) {
  sq::Chain c;
  int rc = sq::shape(&c, nl, ints, N, H, W);
  if (rc) return rc;
  if (nl == 5)
    rc = fwd_grid<T, 5>(c, grid);
  else if (nl == 1)
    rc = fwd_grid<T, 1>(c, grid);
  else
    return (int)cudaErrorInvalidValue;
  if (rc) return rc;
  *scratch = (long long)sq::fwd_scratch_floats(c, *grid, sizeof(T));
  return 0;
}

template <typename T, int kLayers>
int launch_fwd(const void* xv, void* outv, int nl, const int* ints,
               void* const* ptrs, int N, int H, int W, float* scratch,
               long long scratch_floats, int grid, void* stream) {
  const T* x = static_cast<const T*>(xv);
  T* out = static_cast<T*>(outv);
  sq::Chain c;
  if (nl != kLayers || !x || !out || !ptrs || !scratch)
    return (int)cudaErrorInvalidValue;
  int rc = sq::shape(&c, nl, ints, N, H, W);
  if (rc) return rc;
  int want = 0;
  if ((rc = fwd_grid<T, kLayers>(c, &want))) return rc;
  if (grid != want ||
      scratch_floats != (long long)sq::fwd_scratch_floats(c, grid, sizeof(T)))
    return (int)cudaErrorInvalidValue;
  // the anchors follow the partial slots in the scratch
  float* z = scratch + (size_t)2 * grid * sq::kMaxQ * sq::kMaxC;
  for (int l = 0; l < nl; ++l) {
    sq::Layer& p = c.L[l];
    void* const* v = ptrs + l * kPtrsPerLayer;
    for (int k = 0; k < kPtrsPerLayer; ++k)
      if (!v[k]) return (int)cudaErrorInvalidValue;
    p.w = v[0];
    p.b = v[1];
    p.gam = (const float*)v[2];
    p.bet = (const float*)v[3];
    p.z = nullptr;
    if (l + 1 < nl || !p.keep) {
      p.z = z;
      z += sq::elem_floats((size_t)p.cout * N, sizeof(T));
    }
  }
  void* args[] = {(void*)&c, (void*)&x, (void*)&out, (void*)&scratch};
  rc = (int)cudaLaunchCooperativeKernel(
      (const void*)sqnxt_fwd_kernel<T, kLayers>, dim3(grid), dim3(sq::kThreads),
      args, (size_t)c.smem_floats * 4, (cudaStream_t)stream);
  if (rc) return rc;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// K6 (nl 5) and K8 (nl 1): the grid their launch takes and the floats of
// its one scratch allocation (two partial-slot buffers of grid x 4 x 128,
// then the anchors z_l (cout_l x N, in floats: cout_l N fp32, ceil(cout_l
// N / 2) for bf16) of every layer but the last, and of the last where the
// plan does not keep it in shared memory). ints: per layer cin, cout,
// taps, axis (0 1x1, 1 j, 2 i), single_pass. _bf16: the bf16 instances.
int pnode_sqnxt_fwd_plan(int nl, const int* ints, int N, int H, int W,
                         int* grid, long long* scratch_floats) {
  return fwd_plan<float>(nl, ints, N, H, W, grid, scratch_floats);
}

int pnode_sqnxt_fwd_plan_bf16(int nl, const int* ints, int N, int H, int W,
                              int* grid, long long* scratch_floats) {
  return fwd_plan<sq::bf16>(nl, ints, N, H, W, grid, scratch_floats);
}

// out (cout_last, N) from x (cin_0, N). ptrs: per layer w (taps, cout,
// cin), b, gam, bet (w, b, x and out fp32, or bf16 for _bf16; gam, bet
// fp32). grid and scratch_floats must equal the plan's (else
// cudaErrorInvalidValue, before any launch).
int pnode_sqnxt_fwd(const void* x, void* out, int nl, const int* ints,
                    void* const* ptrs, int N, int H, int W, float* scratch,
                    long long scratch_floats, int grid, void* stream) {
  return launch_fwd<float, 5>(x, out, nl, ints, ptrs, N, H, W, scratch,
                              scratch_floats, grid, stream);
}

int pnode_sqnxt_fwd_layer(const void* x, void* out, int nl,
                          const int* ints, void* const* ptrs, int N, int H,
                          int W, float* scratch, long long scratch_floats,
                          int grid, void* stream) {
  return launch_fwd<float, 1>(x, out, nl, ints, ptrs, N, H, W, scratch,
                              scratch_floats, grid, stream);
}

int pnode_sqnxt_fwd_bf16(const void* x, void* out, int nl, const int* ints,
                         void* const* ptrs, int N, int H, int W,
                         float* scratch, long long scratch_floats, int grid,
                         void* stream) {
  return launch_fwd<sq::bf16, 5>(x, out, nl, ints, ptrs, N, H, W, scratch,
                                 scratch_floats, grid, stream);
}

int pnode_sqnxt_fwd_layer_bf16(const void* x, void* out, int nl,
                               const int* ints, void* const* ptrs, int N,
                               int H, int W, float* scratch,
                               long long scratch_floats, int grid,
                               void* stream) {
  return launch_fwd<sq::bf16, 1>(x, out, nl, ints, ptrs, N, H, W, scratch,
                                 scratch_floats, grid, stream);
}

// The shared-memory regions a launch's plan lays out, in floats: out[0]
// the staged tile, out[1] the staged weights, out[2] 1 where the
// tensor-core layout applies (esize 2), else 0. backward 0:
// K6's or K8's plan (at a grid of one block: the store aside, the regions
// do not depend on it), 1: K7's or K9's. ints as for the plans.
int pnode_sqnxt_layout(int nl, const int* ints, int N, int H, int W,
                       int esize, int backward, long long* out) {
  sq::Chain c;
  int rc = sq::shape(&c, nl, ints, N, H, W);
  if (rc) return rc;
  if ((nl != 1 && nl != sq::kMaxLayers) || (esize != 2 && esize != 4) || !out)
    return (int)cudaErrorInvalidValue;
  const bool tc = esize == 2;
  if (backward) {
    if (sq::plan(c, tc)) return (int)cudaErrorInvalidValue;
  } else {
    sq::plan_fwd(c, 1, tc);
  }
  out[0] = c.tile_floats;
  out[1] = c.off_view - c.off_w;
  out[2] = tc;
  return 0;
}

#ifdef SQNXT_TRACE
// The last K6/K8 launch's phase marks (csrc/sqnxt_tiles.cuh): kMarks
// clock64() values, then the two globaltimer readings.
int pnode_sqnxt_fwd_marks(long long* marks, unsigned long long* ns) {
  int rc = (int)cudaMemcpyFromSymbol(marks, sq::marks, sizeof(sq::marks));
  if (rc) return rc;
  return (int)cudaMemcpyFromSymbol(ns, sq::ns, sizeof(sq::ns));
}
#endif

}  // extern "C"
