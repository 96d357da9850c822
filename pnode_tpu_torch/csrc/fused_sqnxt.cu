// K7 and K9: the stage-exact backward of the fused SqueezeNext ODE dynamics
// (the CIFAR-10 ODE-net's BasicBlock2: five layers of conv -> +b ->
// batch-stats norm -> ReLU).
//
// Replaces pnode_tpu/ops/fused_sqnxt.py:
//   K7 sqnxt_bwd_kernel<5>    _bwd_kernel (:206), launched at :361
//   K9 sqnxt_bwd_kernel<1>    _bwd_layer_kernel (:522), launched at :632
// K7 runs the whole chain in one launch (stages 2-3 of the model); K9 one
// layer per launch (stage 1, whose five anchors are 46 MB at B 128). The
// forward kernels K6 and K8 are csrc/sqnxt_fwd.cu.
//
// Bound and design: csrc/sqnxt_tiles.cuh, whose tile functions both
// sources share (a backward is 1.81 GFLOP at every stage of SqNxt-23 at
// B 128, 27.0 us at the 67 TFLOP/s fp32 FFMA peak). One cooperative
// launch: the forward recomputed (forward_layers), then per layer in
// reverse pass A, a barrier, pass B (g_z kept in shared memory, g_h and dW
// per column tile), a barrier, the ordered sums. Row tiles shaped to each
// layer, each input staged once with its halo, dynamic shared memory sized
// per launch. The entry points own the grid (pnode_sqnxt_bwd_plan) and
// take one scratch allocation whose size they check.
//
// Each kernel has two instances: fp32 (pnode_sqnxt_bwd, _bwd_layer) and
// bf16 storage (pnode_sqnxt_bwd_bf16, _bwd_layer_bf16: x, g, dx, the taps,
// b, the anchors and the g buffers in bf16; the parameter gradients, the
// statistics and the norm's backward in fp32, rounded where the JAX
// kernels cast; csrc/sqnxt_tiles.cuh note 8). The bf16 instances of K7
// and K9 stage their operands as bf16 by cp.async and run the recompute,
// g_h and dW on mma.sync with fp32 accumulation (note 9); the fp32
// instances run FFMA.
#include <cooperative_groups.h>

#include <cstdint>

#include "sqnxt_tiles.cuh"

namespace {

namespace cg = cooperative_groups;
namespace sq = sqnxt;

constexpr int kPtrsPerLayer = 9;  // w, b, gam, bet, z, dw, db, dgam, dbet

// K7 (kLayers 5) and K9 (kLayers 1), storage type T: the forward
// recompute, then every layer's backward in reverse (csrc/sqnxt_tiles.cuh).
// The plan rides as a __grid_constant__ parameter, copied once into shared
// memory. The FFMA instances (fp32) hold ~210 registers, one block an SM;
// the tensor-core instances (bf16) are held to 128, two blocks an SM where
// their shared memory allows.
template <typename T, int kLayers>
__global__ void __launch_bounds__(sq::kThreads, sq::kTensorCores<T> ? 2 : 1)
sqnxt_bwd_kernel(const __grid_constant__ sq::Chain c,
                 const T* __restrict__ x, const T* __restrict__ g,
                 T* dx, float* scratch) {
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
  float* part = scratch;
  float* dwpart = scratch + 2 * slot_size;
  T* gbuf = reinterpret_cast<T*>(dwpart + (size_t)gridDim.x * c.dw_stride);
  int slot = 0;
  constexpr bool kTC = sq::kTensorCores<T>;
  sq::forward_layers<T, true, kTC>(s, x, part, slot_size, slot, grid);
#pragma unroll 1
  for (int l = kLayers - 1; l >= 0; --l) {
    const T* gin =
        l == kLayers - 1 ? g : gbuf + (size_t)((l + 1) & 1) * c.gstride;
    T* gout = l == 0 ? dx : gbuf + (size_t)(l & 1) * c.gstride;
    // gout is complete at backward_layer's second grid.sync, before the
    // ordered dW sum: the next layer reads it with no further barrier
    sq::backward_layer<T, kTC>(s, l, x, gin, gout, part, slot_size, slot,
                               dwpart, grid);
  }
  SQNXT_MARK(sq::kMarks - 1);
  SQNXT_NS(1);
}

// The layer table from ints and its plan (tc: the bf16 instances'
// tensor-core layout); cudaErrorInvalidValue for a chain the kernels do
// not take.
int bwd_shape(sq::Chain* c, int nl, const int* ints, int N, int H, int W,
              bool tc) {
  const int rc = sq::shape(c, nl, ints, N, H, W);
  if (rc) return rc;
  return sq::plan(*c, tc) ? (int)cudaErrorInvalidValue : 0;
}

int bwd_pointers(sq::Chain* c, void* const* ptrs) {
  for (int l = 0; l < c->nl; ++l) {
    sq::Layer& p = c->L[l];
    void* const* v = ptrs + l * kPtrsPerLayer;
    for (int k = 0; k < kPtrsPerLayer; ++k)
      if (!v[k]) return (int)cudaErrorInvalidValue;
    p.w = v[0];
    p.b = v[1];
    p.gam = (const float*)v[2];
    p.bet = (const float*)v[3];
    p.z = v[4];
    p.dw = (float*)v[5];
    p.db = (float*)v[6];
    p.dgam = (float*)v[7];
    p.dbet = (float*)v[8];
  }
  return 0;
}

// The cooperative grid: co-resident blocks at the plan's shared memory,
// at most the largest tile count of any pass.
template <typename T, int kLayers>
int bwd_grid(const sq::Chain& c, int* grid) {
  int per_sm = 0, sms = 0;
  const int rc = sq::occupancy(sqnxt_bwd_kernel<T, kLayers>,
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

template <typename T>
int bwd_plan(int nl, const int* ints, int N, int H, int W, int* grid,
             long long* scratch) {
  sq::Chain c;
  int rc = bwd_shape(&c, nl, ints, N, H, W, sq::kTensorCores<T>);
  if (rc) return rc;
  if (nl == 5)
    rc = bwd_grid<T, 5>(c, grid);
  else if (nl == 1)
    rc = bwd_grid<T, 1>(c, grid);
  else
    return (int)cudaErrorInvalidValue;
  if (rc) return rc;
  *scratch = (long long)sq::scratch_floats(c, *grid, sizeof(T));
  return 0;
}

template <typename T, int kLayers>
int launch_bwd(const void* xv, const void* gv, void* dxv, int nl,
               const int* ints, void* const* ptrs, int N, int H, int W,
               float* scratch, long long scratch_floats, int grid,
               void* stream) {
  const T* x = static_cast<const T*>(xv);
  const T* g = static_cast<const T*>(gv);
  T* dx = static_cast<T*>(dxv);
  sq::Chain c;
  if (nl != kLayers || !x || !g || !dx || !scratch)
    return (int)cudaErrorInvalidValue;
  int rc = bwd_shape(&c, nl, ints, N, H, W, sq::kTensorCores<T>);
  if (rc || (rc = bwd_pointers(&c, ptrs))) return rc;
  int want = 0;
  if ((rc = bwd_grid<T, kLayers>(c, &want))) return rc;
  if (grid < 1 || grid > want ||
      scratch_floats != (long long)sq::scratch_floats(c, grid, sizeof(T)))
    return (int)cudaErrorInvalidValue;
  void* args[] = {(void*)&c, (void*)&x, (void*)&g, (void*)&dx,
                  (void*)&scratch};
  rc = (int)cudaLaunchCooperativeKernel(
      (const void*)sqnxt_bwd_kernel<T, kLayers>, dim3(grid), dim3(sq::kThreads),
      args, (size_t)c.smem_floats * 4, (cudaStream_t)stream);
  if (rc) return rc;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// K7 (nl 5) and K9 (nl 1): the grid their launch takes and the floats of
// its one scratch allocation (two partial-slot buffers of grid x 4 x 128,
// grid dW slots of round4(max taps * cin * cout), and for nl 5 two g
// buffers of max cin_l * N elements, l >= 1: 2 max cin_l N floats for
// fp32, max cin_l N for bf16). ints: per layer cin, cout, taps, axis (0
// 1x1, 1 j, 2 i), single_pass. _bf16: the bf16 instances.
int pnode_sqnxt_bwd_plan(int nl, const int* ints, int N, int H, int W,
                         int* grid, long long* scratch_floats) {
  return bwd_plan<float>(nl, ints, N, H, W, grid, scratch_floats);
}

int pnode_sqnxt_bwd_plan_bf16(int nl, const int* ints, int N, int H, int W,
                              int* grid, long long* scratch_floats) {
  return bwd_plan<sq::bf16>(nl, ints, N, H, W, grid, scratch_floats);
}

// dx (cin_0, N) and every layer's dw, db, dgam, dbet from x and the output
// cotangent g. ptrs: per layer w (taps, cout, cin), b, gam, bet, z (cout,
// N) workspace, dw, db, dgam, dbet (x, g, dx, w, b and z fp32, or bf16 for
// _bf16; gam, bet and the gradients fp32, each dW rounded through the
// storage type). grid is the plan's, or fewer blocks (a comparison of
// grids: the backward keeps nothing of a tile in shared memory across a
// barrier, so any grid covers its tiles), and scratch_floats the plan's
// count at that grid (else cudaErrorInvalidValue).
int pnode_sqnxt_bwd(const void* x, const void* g, void* dx, int nl,
                    const int* ints, void* const* ptrs, int N, int H, int W,
                    float* scratch, long long scratch_floats, int grid,
                    void* stream) {
  return launch_bwd<float, 5>(x, g, dx, nl, ints, ptrs, N, H, W, scratch,
                              scratch_floats, grid, stream);
}

int pnode_sqnxt_bwd_layer(const void* x, const void* g, void* dx, int nl,
                          const int* ints, void* const* ptrs, int N, int H,
                          int W, float* scratch, long long scratch_floats,
                          int grid, void* stream) {
  return launch_bwd<float, 1>(x, g, dx, nl, ints, ptrs, N, H, W, scratch,
                              scratch_floats, grid, stream);
}

int pnode_sqnxt_bwd_bf16(const void* x, const void* g, void* dx, int nl,
                         const int* ints, void* const* ptrs, int N, int H,
                         int W, float* scratch, long long scratch_floats,
                         int grid, void* stream) {
  return launch_bwd<sq::bf16, 5>(x, g, dx, nl, ints, ptrs, N, H, W, scratch,
                                 scratch_floats, grid, stream);
}

int pnode_sqnxt_bwd_layer_bf16(const void* x, const void* g, void* dx,
                               int nl, const int* ints, void* const* ptrs,
                               int N, int H, int W, float* scratch,
                               long long scratch_floats, int grid,
                               void* stream) {
  return launch_bwd<sq::bf16, 1>(x, g, dx, nl, ints, ptrs, N, H, W, scratch,
                                 scratch_floats, grid, stream);
}

#ifdef SQNXT_TRACE
// The last K7/K9 launch's phase marks (csrc/sqnxt_tiles.cuh): kMarks
// clock64() values, then the two globaltimer readings.
int pnode_sqnxt_bwd_marks(long long* marks, unsigned long long* ns) {
  int rc = (int)cudaMemcpyFromSymbol(marks, sq::marks, sizeof(sq::marks));
  if (rc) return rc;
  return (int)cudaMemcpyFromSymbol(ns, sq::ns, sizeof(sq::ns));
}
#endif

}  // extern "C"
