// K1: the dense stack Dense -> act -> ... -> Dense, forward and backward,
// as one tiled, fused layer per launch.
//
// Replaces pnode_tpu/ops/fused_mlp.py: _fwd_kernel (:75) and _bwd_kernel
// (:89), which keep every layer in the TPU's VMEM to turn ~15 small XLA
// ops per evaluation into one pallas_call.
//
// Bound on the H100 (fp32 FFMA at 67 TFLOP/s, HBM at 3.35 TB/s; inputs
// read once, outputs written once). The backward needs the forward of
// layers 0..n-2 (their outputs are the next layers' inputs) and the dX and
// dW products of every layer: B (6 sum K N - 2 K_{n-1} N_{n-1}) FLOPs.
// - KS, B 256, 64 -> 104 x4 -> 64 (46,240 weights): forward 23.4 MFLOP,
//   0.35 us; backward 66.9 MFLOP, 1.00 us. Both by operations.
// - Burgers, B 200, 512 -> 576 x4 -> 512 (6.35 MB of weights): forward
//   634 MFLOP, 9.5 us; backward 1.78 GFLOP, 26.6 us. Both by operations
//   (the bytes alone take 2.1 and 4.2 us).
//
// The previous design (one block per 8 batch rows, the whole stack per
// block) lost to cuBLAS 7x at the Burgers widths for four reasons; what
// this design does about each:
// 1. Too few blocks (25 on 132 SMs at B 200). Each layer is one launch
//    whose output is cut into 32 x 32 tiles, one block each: 126 blocks per
//    layer at Burgers (7 x 18), 32 at KS (8 x 4). 64 threads per tile left
//    ~2 warps per SM, which exposed every chunk's latency, so a block is
//    512 threads: 8 groups of 64, each thread a 4 x 4 register tile, each
//    group summing its own 8 of every 64-deep chunk; group 0 then adds the
//    others' tiles in group order. This form takes 70 / 194 us of device
//    time per Burgers forward / backward (chip_smoke.py phase 7(a) on an
//    H100 SXM at 700 W; PERF.md).
// 2. L2 latency (one scalar __ldg per weight, reused for 4 rows). A block
//    stages its 32 activation rows and its 32 weight columns, 64 deep, in
//    shared memory through cp.async, two stages, so the next chunk's copy
//    overlaps this chunk's FMAs. Each thread's 4 x 4 register tile is fed
//    by two 16-byte shared loads per 16 FMAs; a weight is read from L2 once
//    per 32 rows, not once per 4.
// 3. Uncoalesced transposed reads of W in g W^T. The dX product copies W's
//    tile with neighbouring threads on neighbouring addresses of a row of
//    W and reads it transposed from shared memory.
// 4. The ceil(B / 8) x wtotal partial buffer (159 MB at Burgers) and the
//    second launch that summed it. dW = H^T G is a product of its own with
//    (K + 1) x N output tiles: each dW element is summed over all B rows by
//    one block in a fixed order, so the result is deterministic with no
//    atomics and no scratch. db is the extra row K of the same product,
//    against a row of ones (the flat [W, b] layout keeps b right after W).
//    dW and dX read only G, so they share one launch per layer.
//
// Copies are 4-byte cp.async: the rows of ragged widths (13, 100) are not
// 16-byte aligned, and two of the three products land an operand
// transposed in shared memory; one copy path takes every width and layout.
// Elements past an edge are written as 0 (or 1 on the ones row), never
// read: rows and columns are masked, not padded.
//
// Chaining: one ordinary launch per layer from the C entry points (forward
// n, backward 2n - 1), no cooperative launch, so processes sharing a card
// need no co-residency guarantee. Activations pass between layers through
// scratch the wrapper allocates (B x max hidden width, two buffers), which
// stays in L2. Arithmetic: fp32 FFMA on the CUDA cores, no TF32.
//
// What bounds it now: a Burgers layer takes ~14 us against ~2 us of FFMA
// at the peak rate, about cuBLAS's own fp32 time for one such product
// (sm80_xmma_gemm 32x32, ~15 us in the plain path's trace): latency per
// chunk with 1-3 blocks per SM, not FLOPs or bytes.
//
// The entry points own the grids (tiles(B) x tiles(width) per product);
// the wrapper passes only the scratch it allocated, whose size they check
// (ops/fused_mlp.py mlp_scratch).
#include <climits>
#include <cstddef>

#include "pnode_kernels.cuh"

namespace pnode {
namespace k1 {

constexpr int kTile = 32;            // rows and columns of an output tile
constexpr int kReg = 4;              // a thread's register tile is 4 x 4
constexpr int kLanes = kTile / kReg;                 // 8 threads per row
constexpr int kGroupThreads = kLanes * kLanes;       // 64 cover one tile
constexpr int kGroups = 8;           // thread groups splitting each chunk
constexpr int kBlockThreads = kGroups * kGroupThreads;  // 512
constexpr int kTileK = 64;           // depth of one staged chunk
constexpr int kGroupK = kTileK / kGroups;            // 8 per group
constexpr int kStages = 2;           // chunks in shared memory at once
constexpr int kPad = kTile + 4;      // smem row stride: 16-byte aligned

// The stages while the chunks stream; afterwards the same bytes hold the
// register tiles of groups 1.. for group 0 to add.
union Smem {
  struct {
    float a[kStages][kTileK][kPad];  // A(m0 + i, k0 + kk) at a[.][kk][i]
    float b[kStages][kTileK][kPad];  // B(k0 + kk, n0 + j) at b[.][kk][j]
  } st;
  float red[kGroups - 1][kReg * kReg][kGroupThreads];
};
constexpr int kSmemBytes = (int)sizeof(Smem);  // 36,864 B
static_assert(kSmemBytes <= 48 * 1024, "K1's tile exceeds static smem");

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most kStages - 2 of this thread's newest copy groups are
// still in flight.
__device__ __forceinline__ void cp_async_wait_stage() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 2) : "memory");
}

// One operand of a product, as a matrix of (outer, k): the rows of A or the
// columns of B. Element (o, k) lies at p[o * ld + k] when kKFast (contiguous
// along k), else at p[k * ld + o]. o < n_outer holds data; o == ones_at
// reads 1 (the db row of dW's product); the rest reads 0.
struct Operand {
  const float* p;
  int ld;
  int n_outer;
  int ones_at;
};

// dst[kk][oo] = X(o0 + oo, k0 + kk) for the tile's 32 x kTileK elements.
// Neighbouring threads take neighbouring addresses of the operand's
// contiguous index, so every copy is coalesced.
template <bool kKFast>
__device__ __forceinline__ void stage_tile(float (*dst)[kPad],
                                           const Operand& op, int o0, int k0,
                                           int n_k) {
#pragma unroll
  for (int e = threadIdx.x; e < kTile * kTileK; e += kBlockThreads) {
    const int kk = kKFast ? e % kTileK : e / kTile;
    const int oo = kKFast ? e / kTileK : e % kTile;
    const int o = o0 + oo, k = k0 + kk;
    float* d = &dst[kk][oo];
    if (o < op.n_outer && k < n_k) {
      cp_async4(d, kKFast ? op.p + (size_t)o * op.ld + k
                          : op.p + (size_t)k * op.ld + o);
    } else {
      *d = (o == op.ones_at && k < n_k) ? 1.0f : 0.0f;
    }
  }
}

// acc[i][j] = sum_{k < n_k} A(m0 + 4 ty + i, k) B(k, n0 + 4 tx + j) in the
// threads of group 0 (threadIdx < 64; tx = thread % 8, ty = thread / 8).
// Group g sums depths 8 g .. 8 g + 7 of every chunk, chunks in order,
// with fmaf; then group 0 adds groups 1 .. 7 in that order, so each sum
// has one fixed order. kStages - 1 chunks are in flight while one is
// multiplied; one barrier per chunk.
template <bool kAKFast, bool kBKFast>
__device__ __forceinline__ void tile_product(Smem& sm, const Operand& A,
                                             const Operand& B, int m0,
                                             int n0, int n_k,
                                             float (&acc)[kReg][kReg]) {
  const int lane = threadIdx.x % kGroupThreads;
  const int grp = threadIdx.x / kGroupThreads;
  const int tx = lane % kLanes, ty = lane / kLanes;
#pragma unroll
  for (int i = 0; i < kReg; ++i)
#pragma unroll
    for (int j = 0; j < kReg; ++j) acc[i][j] = 0.0f;
  const int chunks = (n_k + kTileK - 1) / kTileK;
#pragma unroll
  for (int c = 0; c < kStages - 1; ++c) {
    if (c < chunks) {
      stage_tile<kAKFast>(sm.st.a[c], A, m0, c * kTileK, n_k);
      stage_tile<kBKFast>(sm.st.b[c], B, n0, c * kTileK, n_k);
    }
    cp_async_commit();
  }
  for (int c = 0; c < chunks; ++c) {
    cp_async_wait_stage();  // this thread's copies of chunk c have landed
    __syncthreads();        // everyone's have; chunk c - 1's stage is free
    const int next = c + kStages - 1;
    if (next < chunks) {
      stage_tile<kAKFast>(sm.st.a[next % kStages], A, m0, next * kTileK, n_k);
      stage_tile<kBKFast>(sm.st.b[next % kStages], B, n0, next * kTileK, n_k);
    }
    cp_async_commit();  // possibly empty: keeps the wait count uniform
    const int s = c % kStages;
#pragma unroll
    for (int q = 0; q < kGroupK; ++q) {
      const int kk = grp * kGroupK + q;
      const float4 a4 =
          *reinterpret_cast<const float4*>(&sm.st.a[s][kk][ty * kReg]);
      const float4 b4 =
          *reinterpret_cast<const float4*>(&sm.st.b[s][kk][tx * kReg]);
      const float av[kReg] = {a4.x, a4.y, a4.z, a4.w};
      const float bv[kReg] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
      for (int i = 0; i < kReg; ++i)
#pragma unroll
        for (int j = 0; j < kReg; ++j)
          acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
  }
  __syncthreads();  // the last chunk is multiplied: the stages become red
  if (grp > 0) {
#pragma unroll
    for (int i = 0; i < kReg; ++i)
#pragma unroll
      for (int j = 0; j < kReg; ++j)
        sm.red[grp - 1][i * kReg + j][lane] = acc[i][j];
  }
  __syncthreads();
  if (grp == 0) {
#pragma unroll
    for (int g = 0; g < kGroups - 1; ++g)
#pragma unroll
      for (int i = 0; i < kReg; ++i)
#pragma unroll
        for (int j = 0; j < kReg; ++j)
          acc[i][j] += sm.red[g][i * kReg + j][lane];
  }
}

// One layer forward: out (B, N) = act(in (B, K) W (K, N) + b).
struct FwdLayer {
  const float* in;
  const float* W;
  const float* b;
  float* out;
  int B, K, N, act, tiles_n;
};

__global__ void __launch_bounds__(kBlockThreads)
mlp_fwd_layer_kernel(FwdLayer L) {
  __shared__ __align__(16) Smem sm;
  const int m0 = (blockIdx.x / L.tiles_n) * kTile;
  const int n0 = (blockIdx.x % L.tiles_n) * kTile;
  float acc[kReg][kReg];
  tile_product<true, false>(sm, Operand{L.in, L.K, L.B, -1},
                            Operand{L.W, L.N, L.N, -1}, m0, n0, L.K, acc);
  if (threadIdx.x >= kGroupThreads) return;  // group 0 holds the sums
  const int tx = threadIdx.x % kLanes, ty = threadIdx.x / kLanes;
#pragma unroll
  for (int j = 0; j < kReg; ++j) {
    const int n = n0 + tx * kReg + j;
    if (n >= L.N) continue;
    const float bn = __ldg(L.b + n);
#pragma unroll
    for (int i = 0; i < kReg; ++i) {
      const int m = m0 + ty * kReg + i;
      if (m < L.B) L.out[(size_t)m * L.N + n] = act_fwd(acc[i][j] + bn, L.act);
    }
  }
}

// One layer backward, given G (B, N), the cotangent of the layer's output
// with the next activation's derivative already applied:
// - blocks [0, n_dx): gx (B, K) = (G W^T) * act'(h), or G W^T when
//   act == kActNone (layer 0, whose gx is dx);
// - blocks [n_dx, n_dx + tiles of dw): [dW; db] (K + 1, N) = [h, 1]^T G.
// The longer dX blocks come first in block order so they start first.
struct BwdLayer {
  const float* h;   // (B, K): the layer's input
  const float* g;   // (B, N)
  const float* W;   // (K, N)
  float* dw;        // (K + 1, N): dW then db
  float* gx;        // (B, K)
  int B, K, N, act, dx_tiles_n, n_dx, dw_tiles_n;
};

__global__ void __launch_bounds__(kBlockThreads)
mlp_bwd_layer_kernel(BwdLayer L) {
  __shared__ __align__(16) Smem sm;
  float acc[kReg][kReg];
  const int tx = threadIdx.x % kLanes, ty = threadIdx.x / kLanes;
  const bool sums = threadIdx.x < kGroupThreads;  // group 0 holds the sums
  if ((int)blockIdx.x < L.n_dx) {
    const int m0 = (blockIdx.x / L.dx_tiles_n) * kTile;
    const int n0 = (blockIdx.x % L.dx_tiles_n) * kTile;
    // A(r, j) = g[r N + j]; B(j, k) = W[k N + j]: W's rows are copied
    // along j and read transposed from shared memory
    tile_product<true, true>(sm, Operand{L.g, L.N, L.B, -1},
                             Operand{L.W, L.N, L.K, -1}, m0, n0, L.N, acc);
    if (!sums) return;
#pragma unroll
    for (int i = 0; i < kReg; ++i) {
      const int m = m0 + ty * kReg + i;
      if (m >= L.B) continue;
#pragma unroll
      for (int j = 0; j < kReg; ++j) {
        const int n = n0 + tx * kReg + j;
        if (n >= L.K) continue;
        const size_t e = (size_t)m * L.K + n;
        float v = acc[i][j];
        if (L.act != kActNone) v *= act_grad(__ldg(L.h + e), L.act);
        L.gx[e] = v;
      }
    }
  } else {
    const int blk = blockIdx.x - L.n_dx;
    const int m0 = (blk / L.dw_tiles_n) * kTile;
    const int n0 = (blk % L.dw_tiles_n) * kTile;
    // A(k, r) = h[r K + k] (row K reads 1: db); B(r, j) = g[r N + j]
    tile_product<false, false>(sm, Operand{L.h, L.K, L.K, L.K},
                               Operand{L.g, L.N, L.N, -1}, m0, n0, L.B, acc);
    if (!sums) return;
#pragma unroll
    for (int i = 0; i < kReg; ++i) {
      const int m = m0 + ty * kReg + i;
      if (m > L.K) continue;
#pragma unroll
      for (int j = 0; j < kReg; ++j) {
        const int n = n0 + tx * kReg + j;
        if (n < L.N) L.dw[(size_t)m * L.N + n] = acc[i][j];
      }
    }
  }
}

static inline long long tiles(long long extent) {
  return (extent + kTile - 1) / kTile;
}

// Scratch floats of one forward call (the hidden outputs, two buffers of
// B x the widest hidden width; one buffer for 2 layers, none for 1) and of
// one backward call (the recomputed inputs of layers 1..n-1 back to back,
// then buffers as the forward's for the hidden cotangents), as
// ops/fused_mlp.py mlp_scratch computes them. false on a stack the kernels
// do not take: a width or B below 1, more than kMaxLayers layers, or a grid
// beyond 2^31 - 1 blocks.
static bool scratch_floats(int B, int n, const int* dims, long long* fwd,
                           long long* bwd) {
  if (B < 1 || n < 1 || n > kMaxLayers) return false;
  long long maxw = 0, hsum = 0;
  for (int l = 0; l <= n; ++l) {
    if (dims[l] < 1) return false;
    if (l < n && (tiles(B) * tiles(dims[l + 1]) > INT_MAX ||
                  tiles(B) * tiles(dims[l]) +
                          tiles(dims[l] + 1LL) * tiles(dims[l + 1]) >
                      INT_MAX))
      return false;
  }
  for (int l = 1; l < n; ++l) {
    if (dims[l] > maxw) maxw = dims[l];
    hsum += dims[l];
  }
  *fwd = (long long)(n - 1 < 2 ? n - 1 : 2) * B * maxw;
  *bwd = (long long)B * hsum + *fwd;
  return true;
}

static int launch_fwd_layer(const float* in, const float* W, const float* b,
                            float* out, int B, int K, int N, int act,
                            cudaStream_t st) {
  FwdLayer L{in, W, b, out, B, K, N, act, (int)tiles(N)};
  mlp_fwd_layer_kernel<<<(int)(tiles(B) * tiles(N)), kBlockThreads, 0, st>>>(
      L);
  return (int)cudaGetLastError();
}

}  // namespace k1
}  // namespace pnode

using namespace pnode;

extern "C" {

const char* pnode_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// out (B, dims[n]) = MLP(x (B, dims[0])). scratch holds scratch_floats
// floats, the forward's count of k1::scratch_floats (else
// cudaErrorInvalidValue): the hidden layers' outputs.
int pnode_mlp_fwd(const float* x, float* out, float* scratch,
                  size_t scratch_size, int B, int n_layers, const int* dims,
                  const void* const* Ws, const void* const* bs, int act,
                  void* stream) {
  long long need, bwd_need;
  if (!k1::scratch_floats(B, n_layers, dims, &need, &bwd_need) ||
      (long long)scratch_size != need ||
      (act != kActRelu && act != kActTanh))
    return cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const size_t buf = n_layers > 2 ? (size_t)need / 2 : 0;
  const float* in = x;
  for (int l = 0; l < n_layers; ++l) {
    const bool last = l == n_layers - 1;
    float* dst = last ? out : scratch + (l & 1) * buf;
    int rc = k1::launch_fwd_layer(in, static_cast<const float*>(Ws[l]),
                                  static_cast<const float*>(bs[l]), dst, B,
                                  dims[l], dims[l + 1],
                                  last ? kActNone : act, st);
    if (rc) return rc;
    in = dst;
  }
  return 0;
}

// dx (B, dims[0]) and grads ([W0, b0, W1, b1, ...]) of <g, MLP(x)>.
// scratch holds the backward's count of k1::scratch_floats (else
// cudaErrorInvalidValue): the recomputed inputs of layers 1..n-1 (H), then
// two buffers of B x max hidden width for the cotangents.
int pnode_mlp_bwd(const float* x, const float* g, float* dx, float* grads,
                  float* scratch, size_t scratch_size, int B, int n_layers,
                  const int* dims, const void* const* Ws,
                  const void* const* bs, int act, void* stream) {
  long long fwd_need, need;
  if (!k1::scratch_floats(B, n_layers, dims, &fwd_need, &need) ||
      (long long)scratch_size != need ||
      (act != kActRelu && act != kActTanh))
    return cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int n = n_layers;
  float* G = scratch + (need - fwd_need);
  const size_t buf = n > 2 ? (size_t)fwd_need / 2 : 0;
  const float* h[kMaxLayers];  // layer l's input
  h[0] = x;
  size_t off = 0;
  for (int l = 1; l < n; ++l) {
    h[l] = scratch + off;
    off += (size_t)B * dims[l];
  }
  // recompute the hidden layers' outputs into H
  for (int l = 0; l + 1 < n; ++l) {
    int rc = k1::launch_fwd_layer(h[l], static_cast<const float*>(Ws[l]),
                                  static_cast<const float*>(bs[l]),
                                  const_cast<float*>(h[l + 1]), B, dims[l],
                                  dims[l + 1], act, st);
    if (rc) return rc;
  }
  size_t woff = 0;
  for (int l = 0; l + 1 < n; ++l)
    woff += (size_t)dims[l] * dims[l + 1] + dims[l + 1];
  const float* gcur = g;
  for (int l = n - 1; l >= 0; --l) {
    const int K = dims[l], N = dims[l + 1];
    float* gx = l == 0 ? dx : G + ((n - 1 - l) & 1) * buf;
    const int dx_blocks = (int)(k1::tiles(B) * k1::tiles(K));
    const int dw_blocks = (int)(k1::tiles(K + 1LL) * k1::tiles(N));
    k1::BwdLayer L{h[l], gcur, static_cast<const float*>(Ws[l]),
                   grads + woff, gx, B, K, N,
                   l == 0 ? (int)kActNone : act, (int)k1::tiles(K),
                   dx_blocks, (int)k1::tiles(N)};
    k1::mlp_bwd_layer_kernel<<<dx_blocks + dw_blocks, k1::kBlockThreads, 0,
                               st>>>(L);
    int rc = (int)cudaGetLastError();
    if (rc) return rc;
    gcur = gx;
    if (l > 0) woff -= (size_t)dims[l - 1] * K + K;
  }
  return 0;
}

}  // extern "C"
