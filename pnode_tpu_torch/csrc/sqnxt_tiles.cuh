// The tile machinery of the fused SqueezeNext kernels, sm_90a, fp32 FFMA on
// the CUDA cores (no tensor cores, no TF32): the forward kernels K6 and K8
// (csrc/sqnxt_fwd.cu's sqnxt_fwd_kernel<5> and <1>) and the stage-exact
// backward kernels K7 and K9 (csrc/fused_sqnxt.cu's sqnxt_bwd_kernel<5> and
// <1>), which recompute the same forward before they backprop.
//
// Replaces pnode_tpu/ops/fused_sqnxt.py: _fwd_kernel (:192) and _bwd_kernel
// (:206), the chain at ODE stages 2-3, and _fwd_layer_kernel (:508) and
// _bwd_layer_kernel (:522), one layer per launch at stage 1. A layer is
//   z = conv(h) + b;  zh = (z - m) / sr;  h' = ReLU(zh gam + bet)
// and its backward
//   g_a = g where zh gam + bet > 0;  g_zh = g_a gam
//   d_gam = sum g_a zh;  d_bet = sum g_a;  c1 = mean g_zh;  c2 = mean g_zh zh
//   g_z = (g_zh - c1 - zh c2) / sr;  d_b = sum g_z
//   dW[t, co, ci] = sum_n g_z[co, n] h[ci, n + s_t] ok_t(n)
//   g_h[ci, n] = sum_{t, co} W[t, co, ci] g_z[co, n - s_t] ok_t(n - s_t)
//
// Bound on the H100 (67 TFLOP/s fp32 FFMA, 3.35 TB/s): a forward is 4.5
// D^2 N FLOP, a backward 3x that (the recompute, dW and g_h): 604 MFLOP and
// 1.81 GFLOP at every stage of SqNxt-23 at B 128 (D 32, N 131,072; D 64, N
// 32,768; D 128, N 8,192), 9.0 and 27.0 us, set by operations for the chain
// (its x and out, 8.4 MB at stage 2, take 5.0 us). One layer per launch
// reads and writes every layer's input and output: 92.3 MB over K8's five
// launches at stage 1, 27.5 us, set by bytes.
//
// The design, per cause of lost time:
// 1. Row tiles shaped to the layer. Every product is a template on its row
//    tile RT (the layer's rows rounded up to 8, 16, 32, 64 or 128) and its
//    taps (1, or 3 along j or i: the axis only sets the shift and the
//    masks, so it is a runtime value). A block's 256 threads form RT / 4
//    thread rows by 1024 / RT thread columns; each thread holds 4 rows x 4
//    columns in registers at every RT, so a tile is RT x 4096 / RT. Rows
//    past the layer's are zero weights (staged as 0), not a test in the
//    FMA loop. dW, whose output (Cout x taps Cin, 32 to 12,288 entries) is
//    often smaller than 4096, splits its reduction over a tile's columns
//    into G groups of threads (G up to 1024 / RT / ceil(K / 4)), which
//    the block adds in group order; above 4096 entries a thread sweeps the
//    tile once for each of up to three 16-entry register tiles (the chain
//    of make_meta needs at most 12,288 entries: Cout 64 x 3 x 64 at D 128;
//    the backward refuses more). Where a pass would have fewer than 256
//    tiles (N 8,192 at stage 3, and the narrow layers at stage 2), its tile
//    is halved, once or twice, and the products' reduction is split over 2
//    or 4 thread groups that meet in shared memory, so the 16-output
//    register tile stays and every SM gets two tiles.
// 2. Each input staged once per tile, with its halo. A layer's column tile
//    is staged with 1 column ((1,3)) or W columns ((3,1)) on each side, and
//    the three taps are read from shared memory at offsets -s, 0, +s. Each
//    column's image coordinate and its two tap masks are computed once per
//    tile (the only integer division by a runtime value, outside every FMA
//    loop). The previous layer's ReLU(norm(z)) is computed once per staged
//    element as ReLU(z sc + sh) (sc = gam / sr, sh = bet - m sc, per channel
//    in shared memory: one FMA; the forward's output and the ReLU gates of
//    the norm's backward use the same form, so all three agree; the plain
//    version divides, so a value at 0 may round to either side). Rows come
//    in raw by cp.async, 16 bytes where N, the tile's first column and the
//    row stride are multiples of 4 and 4 bytes otherwise (K1's path in
//    csrc/fused_mlp.cu), and are turned in place. The next layer's weights
//    are copied in while the grid meets.
// 3. The forward keeps z on chip where it is read again. A layer's anchor
//    z_l (conv + bias) goes to device memory only where another block reads
//    it: the next layer's halo crosses tiles, so each layer but the chain's
//    last writes its anchor. The last layer's z (read by the normalize-out
//    pass after the statistics' grid barrier) and a layer's z with a
//    centered variance (read by its second pass) stay in a store of this
//    block's tiles in shared memory, where the store fits kStoreFloats at
//    the launch's grid (plan_fwd; L[l].keep), so K8 writes and reads no
//    anchor at the CIFAR shapes. The forward kernels instantiate only the
//    forward product, so the occupancy query may give them two blocks per
//    SM where the store is small.
// 4. One pass for the backward's g_z, d_b, dW and g_h. After pass A (the
//    four row sums of the norm's backward) and its grid.sync, each tile
//    computes g_z for itself and its halo in shared memory from z, g and
//    the statistics, adds d_b's row sums, runs g_h (written to device
//    memory for the next layer) and dW in one sweep over the staged tile,
//    and adds its dW into the block's partial (a block-private slot that
//    stays in L2: up to 48 KB of dW, beside the staged tile and the layer's
//    weights in shared memory). No g_z scratch. Then one grid.sync, and the
//    ordered sums of dW and d_b, which overlap the next layer's pass A. Two
//    grid barriers per backward layer, plus the forward's one per layer
//    (two where the variance is centered). After each barrier every block
//    sums every block's partials, spread over all its threads with 16-byte
//    loads; at 132 blocks that read, nb x Q x R floats a block, and the
//    barrier itself take 4-15 us (tools/trace_sqnxt.py), the largest cost
//    left beside the products.
// 5. Registers and occupancy: the backward kernels run at
//    __launch_bounds__(256, 1): about 210 registers, no spill, one block of
//    8 warps per SM (at (256, 2) the 128-register cap spilled 100-760 B).
//    Dynamic shared memory is sized per launch, and the same size is given
//    to the occupancy query that sets the grid. The layer table, and the
//    pointers into shared memory, live in shared memory, so no loop indexes
//    a by-value struct and no register holds them across the passes; the
//    products are out of line (their template instances inlined twice
//    would double the build).
// 6. Anchors, g buffers and partial slots are written inside the launch:
//    read with __ldcg (L2), never __ldg.
// 7. Deterministic: no atomics; statistics, d_b and dW are summed in fixed
//    orders (warp shuffle trees, group order, block order), only over the
//    blocks that had a tile, each float4 of dW entries by one warp.
// 8. Two storage types. Every kernel has an fp32 and a bf16 instance (T =
//    float or __nv_bfloat16, the JAX kernels' activation dtype): T is the
//    type of x, the taps, b, the anchors z_l, the output and the cotangents
//    (g, the g buffers, dx) in device memory. Shared memory, the products,
//    the statistics, the norm's backward and the partial slots stay fp32
//    (a bf16 value is exact in fp32, so the products of two bf16 values
//    are exact and only their sums round, as in the JAX kernels' f32
//    accumulation). The bf16 instance rounds where the JAX kernels cast to
//    the activation dtype (pnode_tpu/ops/fused_sqnxt.py): z = bf16(bf16(acc)
//    + b) (:157), the norm's output before the ReLU (:176), g_z (:277), g_h
//    (:301) and each dW through bf16 (:291); rnd<float> is the identity, so
//    the fp32 instance computes what it did before. The bf16 rows come in
//    by plain 4-byte (or 2-byte) loads converted on the way (cp.async
//    cannot convert), the fp32 rows by cp.async as above. The scratch is counted in floats for both: its
//    partial slots and dW slots are fp32, its anchors and g buffers take
//    ceil(elements * sizeof(T) / 4) floats (elem_floats), so at bf16 they
//    take half the room. The shared-memory layout, and with it the store
//    (kStoreFloats) and the grid, is the same for both.
#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <mutex>
#include <type_traits>

namespace sqnxt {

namespace cg = cooperative_groups;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxC = 128;      // channels of a layer
constexpr int kMaxLayers = 5;
constexpr int kMaxQ = 4;        // quantities of one row reduction
constexpr int kTileOut = 4096;  // outputs of one product tile (16 a thread)
constexpr int kMaxSub = 3;      // dW register tiles a thread may hold
constexpr int kMaxTN = kTileOut / 8;
constexpr int kMinTiles = 256;  // a pass's tiles, split smaller below it
constexpr int kViewFloats = 32;  // room for the Smem view
constexpr float kEps = 1e-5f;   // BatchStatsNorm eps

using bf16 = __nv_bfloat16;

// Floats that n elements of a storage type of esize bytes take.
__host__ __device__ inline size_t elem_floats(size_t n, int esize) {
  return (n * (size_t)esize + 3) / 4;
}

// The storage type's conversions: to_f exact, from_f round to nearest
// even, rnd<T>(v) = float(T(v)) (the identity for float).
__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float v) {
  return __float2bfloat16_rn(v);
}

template <typename T>
__device__ __forceinline__ float rnd(float v) { return to_f(from_f<T>(v)); }

// Loads as fp32: through L2 (ld_cg, for what the launch itself writes) or
// the read-only path (ld_in, for its inputs).
__device__ __forceinline__ float ld_cg(const float* p) { return __ldcg(p); }
__device__ __forceinline__ float ld_cg(const bf16* p) {
  return __uint_as_float(
      (unsigned)__ldcg(reinterpret_cast<const unsigned short*>(p)) << 16);
}
__device__ __forceinline__ float ld_in(const float* p) { return __ldg(p); }
__device__ __forceinline__ float ld_in(const bf16* p) {
  return __uint_as_float(
      (unsigned)__ldg(reinterpret_cast<const unsigned short*>(p)) << 16);
}

struct Layer {
  int cin, cout, taps, axis, single_pass;  // axis: 0 1x1, 1 j taps, 2 i taps
  int rt_o, rt_i;   // row tiles of Cout and Cin (8, 16, 32, 64, 128)
  int tn_f, tn_b;   // column tiles of the forward and the backward pass
  int ks_f, ks_b;   // their products' reduction groups (1, 2 or 4)
  int halo;         // staged columns each side: 0, 1 or W
  int step;         // column shift of one tap: 1 (j) or W (i)
  int dw_sub;       // dW register tiles a thread holds (1..3)
  int dw_groups;    // dW's thread groups over a tile's columns (G)
  int ld_b;         // row stride of the backward pass's staged tile
  int stat;         // offset of its rows in the statistics arrays
  int keep;         // forward kernels: z's tiles stay in the block's store
  const void* w;    // (taps, cout, cin), of the storage type T
  const void* b;    // (cout,), T
  const float* gam;
  const float* bet;
  void* z;          // the anchor (cout, N), T; null where keep holds all of z
  float* dw;        // outputs (fp32), shaped as w, b, gam, bet
  float* db;
  float* dgam;
  float* dbet;
};

// The launch's plan: the layer table and the shared-memory layout (in
// floats), computed on the host (plan() for the backward kernels,
// plan_fwd() for the forward ones) and copied into shared memory.
struct Chain {
  Layer L[kMaxLayers];
  int nl, N, H, W;
  float inv_n;
  int off_stats;   // mean, sr, gam, bet, sc, sh: each stat_floats, layer l's
                   // rows at L[l].stat
  int stat_floats;
  int off_acc;     // acc[kMaxQ][kMaxC]: this block's row sums
  int off_red;     // red[kMaxQ][kMaxC]: the grid's row sums
  int off_msk;     // kMaxTN bytes: tap masks of the tile's columns
  int off_w;       // the layer's weights
  int off_view;    // the Smem view itself (kViewFloats)
  int off_x;       // g_h's reduction groups meet here
  int off_tile;    // the staged tile, then dW's group sums
  int tile_floats;
  int off_zs;      // the forward's store of this block's z tiles
  int zs_floats;
  int smem_floats;
  int dw_stride;   // floats of one block's dW slot
  size_t gstride;  // floats of one g buffer
};

__host__ __device__ inline int row_tile(int c) {
  return c <= 8 ? 8 : c <= 16 ? 16 : c <= 32 ? 32 : c <= 64 ? 64 : 128;
}

__host__ __device__ inline int round4(int v) { return (v + 3) & ~3; }

// Reduction groups of a pass with row tile rt: 1, or 2 or 4 where 4096 /
// rt columns a tile would give fewer than kMinTiles tiles of N.
inline int split_for(int N, int rt) {
  int ks = 1;
  while (ks < 4 && (N + kTileOut / (rt * ks) - 1) / (kTileOut / (rt * ks)) <
                       kMinTiles)
    ks *= 2;
  return ks;
}

// The per-layer fields of c.L[0..nl) that both plans use.
inline void derive(Chain& c) {
  int stat = 0;
  for (int l = 0; l < c.nl; ++l) {
    Layer& p = c.L[l];
    p.rt_o = row_tile(p.cout);
    p.rt_i = row_tile(p.cin);
    // column tiles of 4096 / RT (both backward products' rows fill their
    // register tiles with the smaller RT), halved while a pass would have
    // fewer than kMinTiles of them, the halves' reduction split in groups
    const int rmin = p.rt_o < p.rt_i ? p.rt_o : p.rt_i;
    p.ks_f = split_for(c.N, p.rt_o);
    p.ks_b = split_for(c.N, rmin);
    p.tn_f = kTileOut / (p.rt_o * p.ks_f);
    p.tn_b = kTileOut / (rmin * p.ks_b);
    p.halo = p.axis == 0 ? 0 : (p.axis == 1 ? 1 : c.W);
    p.step = p.axis == 2 ? c.W : 1;
    const int K = p.taps * p.cin;
    const int cols = kTileOut / p.rt_o;  // dW columns one register tile spans
    p.dw_sub = (K + cols - 1) / cols;
    p.dw_groups = p.dw_sub == 1 ? cols / 4 / ((K + 3) / 4) : 1;
    // dW's lanes read row ci (and, for g_z, row co) at column g + G j: with
    // ld_b = G (mod 32) they fall on banks ci G + g, all different; with
    // G = 1 an odd ld_b is enough
    p.ld_b = p.tn_b + 2 * p.halo;
    if (p.dw_groups == 1)
      p.ld_b |= 1;
    else
      p.ld_b += ((p.dw_groups - p.ld_b) % 32 + 32) % 32;
    p.stat = stat;
    p.keep = 0;
    stat += round4(p.cout);
  }
  c.stat_floats = stat;
}

// The layout from the statistics to the staged tile (x_need floats for
// g_h's groups, tile_need for the tile); returns the next free offset.
inline int layout(Chain& c, int w_need, int x_need, int tile_need) {
  int off = round4((int)((sizeof(Chain) + 3) / 4));
  c.off_stats = off;
  off += 6 * c.stat_floats;
  c.off_acc = off;
  off += kMaxQ * kMaxC;
  c.off_red = off;
  off += kMaxQ * kMaxC;
  c.off_msk = off;
  off += kMaxTN / 4;
  c.off_w = off;
  off += round4(w_need);
  c.off_view = off;
  off += kViewFloats;
  c.off_x = off;
  off += round4(x_need);
  c.off_tile = off;
  c.tile_floats = round4(tile_need);
  return off + c.tile_floats;
}

// The backward kernels' plan: the derived fields and the layout. 0, or 1
// where the chain exceeds what the kernel takes (the caller refuses it).
inline int plan(Chain& c) {
  derive(c);
  int w_need = 0, tile_need = 0, dw_stride = 0, x_need = 0;
  size_t gmax = 0;
  for (int l = 0; l < c.nl; ++l) {
    const Layer& p = c.L[l];
    if (p.dw_sub > kMaxSub) return 1;
    const int xn = (p.ks_b - 1) * (kTileOut / p.ks_b);
    x_need = x_need > xn ? x_need : xn;
    const int wf = p.taps * p.cin * p.rt_o, wb = p.taps * p.cout * p.rt_i;
    w_need = w_need > wf ? w_need : wf;
    w_need = w_need > wb ? w_need : wb;
    const int t_f = p.cin * (p.tn_f + 2 * p.halo);
    const int t_b = (p.cin + p.cout) * p.ld_b;
    // kTileOut: the z tile with the groups' exchange, or dW's group sums
    int t = t_f > kTileOut ? t_f : kTileOut;
    t = t > t_b ? t : t_b;
    tile_need = tile_need > t ? tile_need : t;
    const int e = round4(p.taps * p.cin * p.cout);
    dw_stride = dw_stride > e ? dw_stride : e;
    if (l > 0 && (size_t)p.cin * c.N > gmax) gmax = (size_t)p.cin * c.N;
  }
  const int off = layout(c, w_need, x_need, tile_need);
  c.off_zs = off;
  c.zs_floats = 0;
  c.smem_floats = off;
  c.dw_stride = dw_stride;
  c.gstride = gmax;
  return 0;
}

// Floats of the backward kernels' one scratch allocation, for a grid of
// `grid` blocks and a storage type of esize bytes: two partial-slot
// buffers (grid x kMaxQ x kMaxC each), the dW slots (grid x dw_stride) and,
// for a chain, two g buffers of gstride elements of the storage type.
inline size_t scratch_floats(const Chain& c, int grid, int esize) {
  return (size_t)2 * grid * kMaxQ * kMaxC + (size_t)grid * c.dw_stride +
         elem_floats(2 * c.gstride, esize);
}

// The forward kernels' store of z tiles may take up to 128 KB of a block's
// shared memory, beside the staged tile and the weights within the 227 KB
// a block may have; past it a layer keeps its anchor in device memory.
constexpr int kStoreFloats = 32768;

// Floats of the store at a grid of `grid` blocks: the most that one block's
// tiles of z take (ceil(tiles / grid) tiles of cout x tn_f) over the layers
// whose z the forward reads again: the last (the normalize-out pass) and
// each one with a centered variance (its second pass).
inline int store_floats(const Chain& c, int grid) {
  int need = 0;
  for (int l = 0; l < c.nl; ++l) {
    const Layer& p = c.L[l];
    if (l + 1 < c.nl && p.single_pass) continue;
    const int tiles = (c.N + p.tn_f - 1) / p.tn_f;
    const int mine = (tiles + grid - 1) / grid * p.cout * p.tn_f;
    need = need > mine ? need : mine;
  }
  return round4(need);
}

// The forward kernels' plan at a grid of `grid` blocks: the derived fields
// and the layout (the staged tile with its halo, the layer's weights, the
// statistics, no g buffers or dW slots), with the store where it fits
// kStoreFloats at this grid (L[l].keep set for the layers it serves).
inline void plan_fwd(Chain& c, int grid) {
  derive(c);
  int w_need = 0, tile_need = kTileOut;  // the z tile with the groups' exchange
  for (int l = 0; l < c.nl; ++l) {
    const Layer& p = c.L[l];
    const int wf = p.taps * p.cin * p.rt_o, t_f = p.cin * (p.tn_f + 2 * p.halo);
    w_need = w_need > wf ? w_need : wf;
    tile_need = tile_need > t_f ? tile_need : t_f;
  }
  const int store = store_floats(c, grid), keep = store <= kStoreFloats;
  for (int l = 0; l < c.nl; ++l)
    c.L[l].keep = keep && (l + 1 == c.nl || !c.L[l].single_pass);
  const int off = layout(c, w_need, 0, tile_need);
  c.off_zs = off;
  c.zs_floats = keep ? store : 0;
  c.smem_floats = off + c.zs_floats;
  c.dw_stride = 0;
  c.gstride = 0;
}

// Floats of the forward kernels' one scratch allocation: two partial-slot
// buffers (grid x kMaxQ x kMaxC each), then the anchors that go to device
// memory, each elem_floats(cout N, esize): every layer's but the last's,
// and the last's where the store does not keep it.
inline size_t fwd_scratch_floats(const Chain& c, int grid, int esize) {
  size_t n = (size_t)2 * grid * kMaxQ * kMaxC;
  for (int l = 0; l < c.nl; ++l)
    if (l + 1 < c.nl || !c.L[l].keep)
      n += elem_floats((size_t)c.L[l].cout * c.N, esize);
  return n;
}

// -- shared memory, copies, reductions -----------------------------------------

struct Smem {
  const Chain* c;
  float* mean;  // layer l, row r at [L[l].stat + r]
  float* sr;    // 1 / sqrt(var + eps)
  float* gam;   // every layer's norm scale and shift
  float* bet;
  float* sc;    // gam / sqrt(var + eps), and bet - mean sc
  float* sh;
  float* acc;   // [q * kMaxC + r]
  float* red;
  unsigned char* msk;
  float* w;
  float* x;
  float* tile;
  float* zs;    // the forward's store: tile k of this block at k cout tn_f
};

__device__ __forceinline__ Smem smem_view(float* base) {
  const Chain* c = reinterpret_cast<const Chain*>(base);
  Smem s;
  s.c = c;
  s.mean = base + c->off_stats;
  s.sr = s.mean + c->stat_floats;
  s.gam = s.sr + c->stat_floats;
  s.bet = s.gam + c->stat_floats;
  s.sc = s.bet + c->stat_floats;
  s.sh = s.sc + c->stat_floats;
  s.acc = base + c->off_acc;
  s.red = base + c->off_red;
  s.msk = reinterpret_cast<unsigned char*>(base + c->off_msk);
  s.w = base + c->off_w;
  s.x = base + c->off_x;
  s.tile = base + c->off_tile;
  s.zs = base + c->off_zs;
  return s;
}

static_assert(sizeof(Smem) <= 4 * kViewFloats, "the Smem view outgrew its room");

// The view, built once by thread 0 into shared memory, so the passes read
// its pointers from there and hold none of them in registers.
__device__ __forceinline__ const Smem& shared_view(float* base) {
  Smem* v = reinterpret_cast<Smem*>(
      base + reinterpret_cast<const Chain*>(base)->off_view);
  if (threadIdx.x == 0) *v = smem_view(base);
  __syncthreads();
  return *v;
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ void zero_acc(const Smem& s) {
  for (int e = threadIdx.x; e < kMaxQ * kMaxC; e += kThreads) s.acc[e] = 0.0f;
  __syncthreads();
}

// This block's row sums acc[q][r] (q < Q, r < R) into its slot of `part`.
__device__ __forceinline__ void write_slot(const Smem& s, int Q, int R,
                                           float* part) {
  float* slot = part + (size_t)blockIdx.x * kMaxQ * kMaxC;
  for (int e = threadIdx.x; e < Q * kMaxC; e += kThreads)
    if ((e & (kMaxC - 1)) < R) slot[e] = s.acc[e];
}

// After a grid.sync: red[q][r] = the slots of blocks 0..nb-1 summed in
// block order, by every thread at once: thread t takes one float4 of a
// q's rows (C = Q ceil(R / 4) columns) and the blocks b = j, j + J, ... of
// its subset j (J = 256 / C), so each thread has a few 16-byte loads in
// flight and no thread waits on a long chain; then the J subsets' sums
// are added in subset order (through `buf`, 256 float4 of shared memory).
__device__ __forceinline__ void sum_slots(const Smem& s, const float* part,
                                          int nb, int Q, int R) {
  constexpr int kSlot4 = kMaxQ * kMaxC / 4;
  const int R4 = (R + 3) >> 2, C = Q * R4, J = kThreads / C;
  const int col = threadIdx.x % C, j = threadIdx.x / C;
  const int q = col / R4, r4 = col - q * R4;
  float4* buf = reinterpret_cast<float4*>(s.tile);
  if (j < J) {
    const float4* src = reinterpret_cast<const float4*>(part) +
                        q * (kMaxC / 4) + r4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 8
    for (int b = j; b < nb; b += J) {
      const float4 w = __ldcg(src + (size_t)b * kSlot4);
      v.x += w.x;
      v.y += w.y;
      v.z += w.z;
      v.w += w.w;
    }
    buf[j * C + col] = v;
  }
  __syncthreads();
  if (threadIdx.x < C) {
    float4 v = buf[col];
    for (int jj = 1; jj < J; ++jj) {
      const float4 w = buf[jj * C + col];
      v.x += w.x;
      v.y += w.y;
      v.z += w.z;
      v.w += w.w;
    }
    float* d = s.red + q * kMaxC + 4 * r4;
    d[0] = v.x;
    d[1] = v.y;
    d[2] = v.z;
    d[3] = v.w;
  }
  __syncthreads();
}

// Layer l's weights for the forward product: wf[(t cin + ci) rt_o + co] =
// W[t, co, ci], rows co >= cout zero (4-byte copies: the layout turns; bf16
// by plain loads). One warp a row (t, co) of W, its lanes along ci.
template <typename T>
__device__ __forceinline__ void stage_w_fwd(const Layer& p, float* wf) {
  const int rt = p.rt_o, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const T* w = static_cast<const T*>(p.w);
  for (int row = warp; row < p.taps * p.cout; row += kWarps) {
    const int t = row / p.cout, co = row - t * p.cout;
    for (int ci = lane; ci < p.cin; ci += 32) {
      float* d = wf + (t * p.cin + ci) * rt + co;
      if constexpr (std::is_same<T, float>::value)
        cp_async4(d, w + (size_t)row * p.cin + ci);
      else
        *d = ld_in(w + (size_t)row * p.cin + ci);
    }
  }
  const int pad = rt - p.cout;
  for (int k = warp; k < p.taps * p.cin; k += kWarps)
    for (int j = lane; j < pad; j += 32) wf[k * rt + p.cout + j] = 0.0f;
}

// Layer l's weights for g_h: wb[(t cout + co) rt_i + ci] = W[t, co, ci],
// columns ci >= cin zero; 16-byte copies where cin % 4 == 0 (and W is
// 16-byte aligned), else 4-byte ones; bf16 by plain loads.
template <typename T>
__device__ __forceinline__ void stage_w_bwd(const Layer& p, float* wb) {
  const int rt = p.rt_i, rows = p.taps * p.cout;
  if constexpr (!std::is_same<T, float>::value) {
    const T* w = static_cast<const T*>(p.w);
    for (int e = threadIdx.x; e < rows * rt; e += kThreads) {
      const int r = e / rt, j = e - r * rt;
      wb[e] = j < p.cin ? ld_in(w + (size_t)r * p.cin + j) : 0.0f;
    }
    return;
  }
  const float* w = static_cast<const float*>(p.w);
  if ((p.cin & 3) == 0 && (reinterpret_cast<size_t>(w) & 15) == 0) {
    const int v = rt >> 2;
    for (int e = threadIdx.x; e < rows * v; e += kThreads) {
      const int r = e / v, j = 4 * (e - r * v);
      float* d = wb + r * rt + j;
      if (j < p.cin)
        cp_async16(d, w + (size_t)r * p.cin + j);
      else
        *reinterpret_cast<float4*>(d) = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  } else {
    for (int e = threadIdx.x; e < rows * rt; e += kThreads) {
      const int r = e / rt, j = e - r * rt;
      if (j < p.cin)
        cp_async4(wb + e, w + (size_t)r * p.cin + j);
      else
        wb[e] = 0.0f;
    }
  }
}

// Tap masks of the tile's columns n0 .. n0 + tn - 1: bit 0 where the
// column's coordinate along the taps' axis has a neighbour at -1, bit 1
// where it has one at +1. The only divisions by H and W.
__device__ __forceinline__ void stage_masks(const Chain& c, const Layer& p,
                                            int n0, int tn,
                                            unsigned char* msk) {
  if (p.axis == 0) return;
  const int len = p.axis == 1 ? c.W : c.H;
  for (int j = threadIdx.x; j < tn; j += kThreads) {
    const int n = n0 + j;
    const int q = n / c.W;
    const int coord = p.axis == 1 ? n - q * c.W : q % c.H;
    msk[j] = (unsigned char)((coord >= 1 ? 1 : 0) | (coord + 1 < len ? 2 : 0));
  }
}

// dst[r * ld + j] = src[r * N + base + j] for r < rows, j < width, 0
// outside [0, N): cp.async, 16 bytes where N, base and ld are multiples
// of 4 (a float4 then lies wholly inside or outside [0, N); the last one
// of a row may run past width, within ld), 4 bytes otherwise. One warp a
// row; the caller waits.
__device__ __forceinline__ void copy_rows(float* dst, int ld,
                                          const float* src, int rows,
                                          int base, int width, int N) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (((N | base | ld) & 3) == 0 &&
      (reinterpret_cast<size_t>(src) & 15) == 0) {
    const int w4 = (width + 3) >> 2;
    for (int r = warp; r < rows; r += kWarps)
      for (int j4 = lane; j4 < w4; j4 += 32) {
        const int n = base + 4 * j4;
        float* d = dst + r * ld + 4 * j4;
        if ((unsigned)n < (unsigned)N)
          cp_async16(d, src + (size_t)r * N + n);
        else
          *reinterpret_cast<float4*>(d) = make_float4(0.f, 0.f, 0.f, 0.f);
      }
  } else {
    for (int r = warp; r < rows; r += kWarps)
      for (int j = lane; j < width; j += 32) {
        const int n = base + j;
        float* d = dst + r * ld + j;
        if ((unsigned)n < (unsigned)N)
          cp_async4(d, src + (size_t)r * N + n);
        else
          *d = 0.0f;
      }
  }
}

// The same from bf16 rows, converted to fp32 on the way: plain loads
// through L2 (the anchors and g buffers are written in the launch), 4 bytes
// (two columns) where N and base are even and the rows 4-byte aligned (a
// pair then lies wholly inside or outside [0, N); the second column is
// stored only inside width, since ld may equal width), else 2 bytes. One
// warp a row; stored before the function returns.
__device__ __forceinline__ void copy_rows(float* dst, int ld, const bf16* src,
                                          int rows, int base, int width,
                                          int N) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (((N | base) & 1) == 0 && (reinterpret_cast<size_t>(src) & 3) == 0) {
    const int w2 = (width + 1) >> 1;
    for (int r = warp; r < rows; r += kWarps) {
      const unsigned* sr =
          reinterpret_cast<const unsigned*>(src + (size_t)r * N);
      float* d = dst + r * ld;
#pragma unroll 4
      for (int j2 = lane; j2 < w2; j2 += 32) {
        const int j = 2 * j2, n = base + j;
        float lo = 0.0f, hi = 0.0f;
        if ((unsigned)n < (unsigned)N) {
          const unsigned v = __ldcg(sr + (n >> 1));
          lo = __uint_as_float(v << 16);  // column n: the low half
          hi = __uint_as_float(v & 0xffff0000u);
        }
        d[j] = lo;
        if (j + 1 < width) d[j + 1] = hi;
      }
    }
    return;
  }
  for (int r = warp; r < rows; r += kWarps) {
    const bf16* sr = src + (size_t)r * N;
    float* d = dst + r * ld;
#pragma unroll 4
    for (int j = lane; j < width; j += 32) {
      const int n = base + j;
      d[j] = (unsigned)n < (unsigned)N ? ld_cg(sr + n) : 0.0f;
    }
  }
}

// Layer l's input rows for the tile's columns n0 - halo .. (width of
// them, ld apart): x for the first layer, else the previous layer's
// anchor, copied raw and then turned in place into ReLU(z sc + sh) rounded
// to T, once per element (0 stays outside [0, N)). Ends with every
// element in place for every thread.
template <typename T>
__device__ __forceinline__ void stage_input(const Smem& s, int l,
                                            const T* x, int n0, int halo,
                                            int width, int ld, float* dst) {
  const Chain& c = *s.c;
  const int cin = c.L[l].cin, base = n0 - halo, N = c.N;
  copy_rows(dst, ld, l == 0 ? x : static_cast<const T*>(c.L[l - 1].z), cin,
            base, width, N);
  cp_async_wait_all();
  __syncthreads();
  if (l == 0) return;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int k = c.L[l - 1].stat;
  for (int ci = warp; ci < cin; ci += kWarps) {
    const float sc = s.sc[k + ci], sh = s.sh[k + ci];
    for (int j = lane; j < width; j += 32) {
      const int n = base + j;
      float* d = dst + ci * ld + j;
      if ((unsigned)n < (unsigned)N)
        *d = rnd<T>(fmaxf(fmaf(*d, sc, sh), 0.0f));
    }
  }
  __syncthreads();
}

// Every layer's norm scale and shift into shared memory (the kernel's
// start; they are inputs, never written in the launch).
__device__ __forceinline__ void stage_norm_params(const Smem& s) {
  const Chain& c = *s.c;
  for (int l = 0; l < c.nl; ++l)
    for (int r = threadIdx.x; r < c.L[l].cout; r += kThreads) {
      s.gam[c.L[l].stat + r] = __ldg(c.L[l].gam + r);
      s.bet[c.L[l].stat + r] = __ldg(c.L[l].bet + r);
    }
  __syncthreads();
}

// -- the products ----------------------------------------------------------------
//
// A product tile is RT rows by CT = 4096 / (RT KS) columns. The block's
// threads form KS groups of 256 / KS, each summing its share of the
// reduction (KS > 1 where one tile per 4096 outputs would leave too few
// tiles for the grid: the stage-3 shapes); a group's thread (ty, tx), ty =
// t / TX, holds rows 4 ty .. 4 ty + 3 (one float4 of the staged weights)
// and columns tx + TX q, q < 4 (neighbouring lanes on neighbouring
// columns: the staged activations are read without bank conflicts). Group
// 0 then adds the others' register tiles, in group order, from `xb`.

template <int RT, int KS = 1>
struct Shape {
  static constexpr int TG = kThreads / KS;
  static constexpr int TY = RT / 4;
  static constexpr int TX = TG / TY;
  static constexpr int CT = 4 * TX;
};

__device__ __forceinline__ void fma4x4(float (&acc)[4][4], const float4 a,
                                       const float (&b)[4]) {
  const float av[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[i][q] = fmaf(av[i], b[q], acc[i][q]);
}

// Group 0's acc += the other groups' (in group order) through xb; every
// thread calls it after its reduction loop.
template <int KS, int TG>
__device__ __forceinline__ void join_groups(float (&acc)[4][4], float* xb) {
  if (KS == 1) return;
  const int grp = threadIdx.x / TG, lt = threadIdx.x % TG;
  if (grp > 0)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int q = 0; q < 4; ++q)
        xb[((grp - 1) * 16 + i * 4 + q) * TG + lt] = acc[i][q];
  __syncthreads();
  if (grp == 0)
    for (int g = 1; g < KS; ++g)
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int q = 0; q < 4; ++q)
          acc[i][q] += xb[((g - 1) * 16 + i * 4 + q) * TG + lt];
}

// Forward: acc[i][q] = sum_{ci, t} W[t, 4 ty + i, ci] h[ci, c_q + s_t]
// ok_t(c_q) over the staged tile h (rows ld apart, `halo` columns of halo),
// this thread's group over its share of ci.
template <int RT, int TAPS, int KS>
__device__ __forceinline__ void fwd_product(const Layer& p, const float* wf,
                                            const float* h, int ld,
                                            const unsigned char* msk,
                                            float (&acc)[4][4]) {
  using S = Shape<RT, KS>;
  const int grp = threadIdx.x / S::TG, lt = threadIdx.x % S::TG;
  const int ty = lt / S::TX, tx = lt % S::TX;
  bool okm[4], okp[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const unsigned m = TAPS == 3 ? msk[tx + S::TX * q] : 3u;
    okm[q] = m & 1u;
    okp[q] = m & 2u;
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[i][q] = 0.0f;
  const float* hb = h + p.halo + tx;
  const float* wb = wf + 4 * ty;
  const int cin = p.cin, step = p.step, per = (cin + KS - 1) / KS;
  const int c1 = min(cin, (grp + 1) * per);
#pragma unroll 2
  for (int ci = grp * per; ci < c1; ++ci) {
#pragma unroll
    for (int t = 0; t < TAPS; ++t) {
      const float4 a =
          *reinterpret_cast<const float4*>(wb + (t * cin + ci) * RT);
      const float* hr = hb + ci * ld + (TAPS == 1 ? 0 : (t - 1) * step);
      float b[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float v = hr[S::TX * q];
        b[q] = TAPS == 1 || t == 1 ? v : (t == 0 ? (okm[q] ? v : 0.0f)
                                                 : (okp[q] ? v : 0.0f));
      }
      fma4x4(acc, a, b);
    }
  }
}

// g_h over the tile's columns: gout[ci, n0 + c] = sum_{t, co} W[t, co, ci]
// g_z[co, c - s_t] ok_t(c - s_t), with g_z staged (rows ld apart, halo
// columns each side). The tile's tn columns are tn / CT product tiles;
// the groups split co and meet in xb. gout is rounded to T.
template <typename T, int RT, int TAPS, int KS>
__device__ __forceinline__ void gh_product(const Chain& c, const Layer& p,
                                           const float* wb, const float* gz,
                                           int ld, const unsigned char* msk,
                                           int n0, int tn, T* gout,
                                           float* xb) {
  using S = Shape<RT, KS>;
  const int grp = threadIdx.x / S::TG, lt = threadIdx.x % S::TG;
  const int ty = lt / S::TX, tx = lt % S::TX;
  const int cout = p.cout, step = p.step, N = c.N;
  const int per = (cout + KS - 1) / KS, co0 = grp * per;
  const int co1 = min(cout, co0 + per);
  const float* wr = wb + 4 * ty;
  for (int c0 = 0; c0 < tn; c0 += S::CT) {
    bool okm[4], okp[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const unsigned m = TAPS == 3 ? msk[c0 + tx + S::TX * q] : 3u;
      okm[q] = m & 1u;
      okp[q] = m & 2u;
    }
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][q] = 0.0f;
    const float* gb = gz + p.halo + c0 + tx;
#pragma unroll
    for (int t = 0; t < TAPS; ++t) {
      // tap t reads g_z at c - s_t: source c + 1 (t = 0) exists where c
      // has a neighbour at +1, source c - 1 (t = 2) where it has one at -1
      const float* gt = gb - (TAPS == 1 ? 0 : (t - 1) * step);
      const float* wt = wr + t * cout * RT;
#pragma unroll 2
      for (int co = co0; co < co1; ++co) {
        const float4 a = *reinterpret_cast<const float4*>(wt + co * RT);
        float b[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float v = gt[co * ld + S::TX * q];
          b[q] = TAPS == 1 || t == 1 ? v : (t == 0 ? (okp[q] ? v : 0.0f)
                                                   : (okm[q] ? v : 0.0f));
        }
        fma4x4(acc, a, b);
      }
    }
    join_groups<KS, S::TG>(acc, xb);
    if (grp == 0)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int ci = 4 * ty + i;
        if (ci >= p.cin) continue;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int n = n0 + c0 + tx + S::TX * q;
          if (n < N) gout[(size_t)ci * N + n] = from_f<T>(acc[i][q]);
        }
      }
    if (KS > 1) __syncthreads();  // xb is free for the next product tile
  }
}

// dW of one tile, added to this block's slot (first tile: stored). Rows
// co = 4 ty + i, columns k = t cin + ci of K = TAPS cin, reduction over
// the tile's tn columns, one register tile at a time. Where K fits one
// span of 4 TX columns (p.dw_sub = 1), the thread columns split into G
// groups of Kt = ceil(K / 4) threads (thread column tx in group tx % G,
// so neighbouring lanes read neighbouring columns); group g sums columns
// g, g + G, ...; the groups' register tiles meet in shared memory (red)
// and are added in group order. Otherwise (G = 1) the span is 4 TX
// columns, k = s 4 TX + tx + TX q for each of dw_sub register tiles, and
// each goes to the slot as it is.
template <int RT, int TAPS>
__device__ __forceinline__ void dw_product(const Layer& p, const float* gz,
                                           const float* h, int ld,
                                           const unsigned char* msk, int tn,
                                           float* red, float* slot,
                                           bool first) {
  using S = Shape<RT>;
  const int ty = threadIdx.x / S::TX, tx = threadIdx.x % S::TX;
  const int cout = p.cout, cin = p.cin, K = TAPS * cin;
  const int Kt = p.dw_sub == 1 ? (K + 3) / 4 : S::TX;
  const int G = p.dw_groups;  // S::TX / Kt, or 1
  const int g = tx % G, kt = tx / G;
  const int width = 4 * Kt;  // columns of one register tile's span
  int go[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    go[i] = min(4 * ty + i, cout - 1) * ld + p.halo;
  for (int s = 0; s < p.dw_sub; ++s) {
    int bo[4];
    unsigned need = 0;  // 2 bits per q: the tap mask its column needs
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int k = s * width + kt + Kt * q;  // k = t cin + ci
      const int t = k / cin, ci = k - t * cin;
      const bool ok = k < K;
      bo[q] = ok ? ci * ld + p.halo + (TAPS == 1 ? 0 : (t - 1) * p.step)
                 : p.halo;
      need |= (TAPS == 1 || !ok ? 0u : (t == 0 ? 1u : (t == 2 ? 2u : 0u)))
              << (2 * q);
    }
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][q] = 0.0f;
    if (kt < Kt) {
      for (int n = g; n < tn; n += G) {
        float a[4], b[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = gz[go[i] + n];
#pragma unroll
        for (int q = 0; q < 4; ++q) b[q] = h[bo[q] + n];
        if (TAPS == 3) {
          const unsigned m = msk[n];
          if (m != 3u) {  // an image-edge column (uniform for G = 1)
#pragma unroll
            for (int q = 0; q < 4; ++q)
              if ((need >> (2 * q)) & ~m & 3u) b[q] = 0.0f;
          }
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[i][q] = fmaf(a[i], b[q], acc[i][q]);
      }
    }
    if (G == 1) {  // no groups to meet: the register tile goes to the slot
      if (kt >= Kt) continue;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int k = s * width + kt + Kt * q;
        if (k >= K) continue;
        const int t = TAPS == 1 ? 0 : (k >= cin) + (k >= 2 * cin);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = 4 * ty + i;
          if (r >= cout) continue;
          float* d = slot + ((size_t)t * cout + r) * cin + (k - t * cin);
          *d = first ? acc[i][q] : *d + acc[i][q];
        }
      }
      continue;
    }
    // G > 1 (dw_sub = 1): the groups meet in red, over the staged tile
    __syncthreads();  // every read of the staged tile is done
    if (kt < Kt)
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int q = 0; q < 4; ++q)
          red[(g * RT + 4 * ty + i) * width + kt + Kt * q] = acc[i][q];
    __syncthreads();
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    for (int r = warp; r < cout; r += kWarps)
      for (int j = lane; j < K; j += 32) {
        const int t = TAPS == 1 ? 0 : (j >= cin) + (j >= 2 * cin);
        float v = 0.0f;
        for (int gg = 0; gg < G; ++gg) v += red[(gg * RT + r) * width + j];
        float* d = slot + ((size_t)t * cout + r) * cin + (j - t * cin);
        *d = first ? v : *d + v;
      }
  }
}

// -- the passes ----------------------------------------------------------------
//
// Phase marks, compiled in only with -DSQNXT_TRACE (the build of
// tools/trace_sqnxt.py): thread 0 of block 0 stores clock64() at each
// phase boundary of the launch into marks[] (forward layer l at 4 l ..
// 4 l + 3, then the forward kernels' normalize-out pass ending at
// kMarkBwd, or backward layer l at kMarkBwd + 6 l .. + 5; inside block 0's
// first tile of forward layer l at kMarkSub + 3 l .. + 2 and of backward
// layer l at kMarkSub + 15 + 3 l .. + 2; the launch's start and end last),
// and the globaltimer at start and end into ns[]. Each source that
// includes this header has its own marks (static), read by its own entry
// point.
constexpr int kMarkBwd = 4 * kMaxLayers;
constexpr int kMarkSub = kMarkBwd + 6 * kMaxLayers;  // inside a first tile
constexpr int kMarks = kMarkSub + 6 * kMaxLayers + 2;
#ifdef SQNXT_TRACE
static __device__ long long marks[kMarks];
static __device__ unsigned long long ns[2];
#define SQNXT_MARK(k)                            \
  do {                                           \
    if (blockIdx.x == 0 && threadIdx.x == 0)     \
      ::sqnxt::marks[k] = clock64();             \
  } while (0)
#define SQNXT_NS(k)                                         \
  do {                                                      \
    if (blockIdx.x == 0 && threadIdx.x == 0) {              \
      unsigned long long t;                                 \
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t)); \
      ::sqnxt::ns[k] = t;                                   \
    }                                                       \
  } while (0)
#else
#define SQNXT_MARK(k) \
  do {                \
  } while (0)
#define SQNXT_NS(k) \
  do {              \
  } while (0)
#endif

// One forward tile of layer p: the product, then z = acc + b (in T's
// rounding: bf16(bf16(acc) + b)) into zt (CT columns a row, in shared
// memory: over the staged input xs, or the block's store, for the row
// sums) and, where the layer has one, into the anchor in device memory.
// The groups meet over xs.
template <typename T, int RT, int TAPS, int KS>
__device__ __forceinline__ void fwd_tile(const Chain& c, const Layer& p,
                                         const float* wf, const float* h,
                                         int ld, const unsigned char* msk,
                                         int n0, float* zt, float* xs) {
  using S = Shape<RT, KS>;
  float acc[4][4];
  fwd_product<RT, TAPS, KS>(p, wf, h, ld, msk, acc);
  __syncthreads();  // every read of the staged input is done
  join_groups<KS, S::TG>(acc, xs + RT * S::CT);
  const int grp = threadIdx.x / S::TG, lt = threadIdx.x % S::TG;
  if (grp > 0) return;
  const int ty = lt / S::TX, tx = lt % S::TX, N = c.N;
  T* z_out = static_cast<T*>(p.z);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = 4 * ty + i;
    if (r >= p.cout) continue;
    const float b = ld_in(static_cast<const T*>(p.b) + r);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int j = tx + S::TX * q, n = n0 + j;
      const float z = rnd<T>(rnd<T>(acc[i][q]) + b);
      zt[r * S::CT + j] = z;
      if (z_out && n < N) z_out[(size_t)r * N + n] = from_f<T>(z);
    }
  }
}

#define SQNXT_RT_SWITCH(rt, CALL)                     \
  switch (rt) {                                       \
    case 8: { constexpr int RT = 8; CALL; } break;    \
    case 16: { constexpr int RT = 16; CALL; } break;  \
    case 32: { constexpr int RT = 32; CALL; } break;  \
    case 64: { constexpr int RT = 64; CALL; } break;  \
    default: { constexpr int RT = 128; CALL; } break; \
  }

#define SQNXT_KS_SWITCH(ks, CALL)                   \
  switch (ks) {                                     \
    case 1: { constexpr int KS = 1; CALL; } break;  \
    case 2: { constexpr int KS = 2; CALL; } break;  \
    default: { constexpr int KS = 4; CALL; } break; \
  }

template <typename T>
static __device__ __noinline__ void fwd_tile_any(const Chain& c, const Layer& p,
                                                 const float* wf, const float* h,
                                                 int ld, const unsigned char* msk,
                                                 int n0, float* zt, float* xs) {
  if (p.taps == 1) {
    SQNXT_RT_SWITCH(p.rt_o, SQNXT_KS_SWITCH(p.ks_f, (fwd_tile<T, RT, 1, KS>(c, p, wf, h, ld, msk, n0, zt, xs))))
  } else {
    SQNXT_RT_SWITCH(p.rt_o, SQNXT_KS_SWITCH(p.ks_f, (fwd_tile<T, RT, 3, KS>(c, p, wf, h, ld, msk, n0, zt, xs))))
  }
}

// The forward tile at the layer's row tile, taps and reduction groups:
// inlined into the caller (kInline: the forward kernels, whose
// 128-register cap would otherwise save live values around the call), or
// the out-of-line fwd_tile_any (the backward kernels: their products
// inlined as well would double their build).
template <typename T, bool kInline>
__device__ __forceinline__ void fwd_tile_at(const Chain& c, const Layer& p,
                                            const float* wf, const float* h,
                                            int ld, const unsigned char* msk,
                                            int n0, float* zt, float* xs) {
  if constexpr (!kInline) {
    fwd_tile_any<T>(c, p, wf, h, ld, msk, n0, zt, xs);
  } else if (p.taps == 1) {
    SQNXT_RT_SWITCH(p.rt_o, SQNXT_KS_SWITCH(p.ks_f, (fwd_tile<T, RT, 1, KS>(c, p, wf, h, ld, msk, n0, zt, xs))))
  } else {
    SQNXT_RT_SWITCH(p.rt_o, SQNXT_KS_SWITCH(p.ks_f, (fwd_tile<T, RT, 3, KS>(c, p, wf, h, ld, msk, n0, zt, xs))))
  }
}

template <typename T>
static __device__ __noinline__ void gh_any(const Chain& c, const Layer& p,
                                           const float* wb, const float* gz, int ld,
                                           const unsigned char* msk, int n0, int tn,
                                           T* gout, float* xb) {
  if (p.taps == 1) {
    SQNXT_RT_SWITCH(p.rt_i, SQNXT_KS_SWITCH(p.ks_b, (gh_product<T, RT, 1, KS>(c, p, wb, gz, ld, msk, n0, tn, gout, xb))))
  } else {
    SQNXT_RT_SWITCH(p.rt_i, SQNXT_KS_SWITCH(p.ks_b, (gh_product<T, RT, 3, KS>(c, p, wb, gz, ld, msk, n0, tn, gout, xb))))
  }
}

static __device__ __noinline__ void dw_any(const Layer& p, const float* gz,
                                           const float* h, int ld,
                                           const unsigned char* msk, int tn,
                                           float* red, float* slot, bool first) {
  if (p.taps == 1) {
    SQNXT_RT_SWITCH(p.rt_o, (dw_product<RT, 1>(p, gz, h, ld, msk, tn, red, slot, first)))
  } else {
    SQNXT_RT_SWITCH(p.rt_o, (dw_product<RT, 3>(p, gz, h, ld, msk, tn, red, slot, first)))
  }
}

#undef SQNXT_RT_SWITCH
#undef SQNXT_KS_SWITCH

__device__ __forceinline__ float* slot_of(float* part, size_t slot_size,
                                          int& slot) {
  return part + (size_t)(slot++ & 1) * slot_size;
}

// The forward chain: every layer's statistics (mean, 1 / sqrt(var + eps),
// and the norm as sc, sh) in this block's shared memory, identical in
// every block; each layer's z in its anchor (device memory) where it has
// one and, for a layer with keep, this block's tiles of it in the store
// (tile k of the block at zs + k cout tn_f). kBackward (K7, K9): the
// backward's first weights are copied in after the last layer, and the
// tiles' products are called out of line (fwd_tile_at).
template <typename T, bool kBackward>
__device__ __forceinline__ void forward_layers(const Smem& s, const T* x,
                                               float* part, size_t slot_size,
                                               int& slot,
                                               cg::grid_group& grid) {
  const Chain& c = *s.c;
  const int N = c.N, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  stage_w_fwd<T>(c.L[0], s.w);
#pragma unroll 1
  for (int l = 0; l < c.nl; ++l) {
    const Layer& p = c.L[l];
    const int tn = p.tn_f, ld = tn + 2 * p.halo;
    const int ntiles = (N + tn - 1) / tn;
    SQNXT_MARK(4 * l);
    cp_async_wait_all();  // this layer's weights, issued before the barrier
    zero_acc(s);
    for (int tile = blockIdx.x, k = 0; tile < ntiles;
         tile += gridDim.x, ++k) {
      const int n0 = tile * tn, cols = min(tn, N - n0);
      const bool first = k == 0;
      float* zt = p.keep ? s.zs + k * p.cout * tn : s.tile;
      stage_input(s, l, x, n0, p.halo, ld, ld, s.tile);
      stage_masks(c, p, n0, tn, s.msk);
      __syncthreads();
      if (first) SQNXT_MARK(kMarkSub + 3 * l);
      fwd_tile_at<T, !kBackward>(c, p, s.w, s.tile, ld, s.msk, n0, zt,
                                 s.tile);
      __syncthreads();
      if (first) SQNXT_MARK(kMarkSub + 3 * l + 1);
      for (int r = warp; r < p.cout; r += kWarps) {
        float s1 = 0.0f, s2 = 0.0f;
        for (int j = lane; j < cols; j += 32) {
          const float z = zt[r * tn + j];
          s1 += z;
          s2 += z * z;
        }
        s1 = warp_sum(s1);
        s2 = warp_sum(s2);
        if (lane == 0) {
          s.acc[r] += s1;
          s.acc[kMaxC + r] += s2;
        }
      }
      __syncthreads();
      if (first) SQNXT_MARK(kMarkSub + 3 * l + 2);
    }
    SQNXT_MARK(4 * l + 1);
    // the next weights (K7's and K9's: the backward's first after the last
    // layer) land while the grid meets
    if (l + 1 < c.nl)
      stage_w_fwd<T>(c.L[l + 1], s.w);
    else if (kBackward)
      stage_w_bwd<T>(p, s.w);
    float* sl = slot_of(part, slot_size, slot);
    if (blockIdx.x < ntiles) write_slot(s, 2, p.cout, sl);
    grid.sync();
    const int nb = min((int)gridDim.x, ntiles);
    sum_slots(s, sl, nb, 2, p.cout);
    for (int r = threadIdx.x; r < p.cout; r += kThreads) {
      const float m = s.red[r] * c.inv_n;
      s.mean[p.stat + r] = m;
      if (p.single_pass)
        s.sr[p.stat + r] = 1.0f / sqrtf(
            fmaxf(s.red[kMaxC + r] * c.inv_n - m * m, 0.0f) + kEps);
    }
    __syncthreads();
    SQNXT_MARK(4 * l + 2);
    if (!p.single_pass) {  // centered variance: a second pass over z_l
      zero_acc(s);
      for (int tile = blockIdx.x, k = 0; tile < ntiles;
           tile += gridDim.x, ++k) {
        const int n0 = tile * tn, cols = min(tn, N - n0);
        const float* zt = s.zs + k * p.cout * tn;
        if (!p.keep) {
          copy_rows(s.tile, tn, static_cast<const T*>(p.z), p.cout, n0, cols,
                    N);
          cp_async_wait_all();
          __syncthreads();
          zt = s.tile;
        }
        for (int r = warp; r < p.cout; r += kWarps) {
          const float m = s.mean[p.stat + r];
          float v = 0.0f;
          for (int j = lane; j < cols; j += 32) {
            const float d = zt[r * tn + j] - m;
            v += d * d;
          }
          v = warp_sum(v);
          if (lane == 0) s.acc[r] += v;
        }
        __syncthreads();
      }
      __syncthreads();
      float* sl2 = slot_of(part, slot_size, slot);
      if (blockIdx.x < ntiles) write_slot(s, 1, p.cout, sl2);
      grid.sync();
      sum_slots(s, sl2, nb, 1, p.cout);
      for (int r = threadIdx.x; r < p.cout; r += kThreads)
        s.sr[p.stat + r] = 1.0f / sqrtf(s.red[r] * c.inv_n + kEps);
      __syncthreads();
    }
    for (int r = threadIdx.x; r < p.cout; r += kThreads) {
      const int k = p.stat + r;
      s.sc[k] = s.gam[k] * s.sr[k];
      s.sh[k] = s.bet[k] - s.mean[k] * s.sc[k];
    }
    __syncthreads();
    SQNXT_MARK(4 * l + 3);
  }
}

// The forward kernels' output: out = ReLU(z sc + sh) of the last layer
// over this block's tiles of it (the form of the staging and of the
// backward's ReLU gates), rounded to T, z read from the store where the
// layer keeps it, else from its anchor; fp32: 16-byte loads and stores
// where N is a multiple of 4 (every tile's first column is).
template <typename T>
__device__ __forceinline__ void normalize_out(const Smem& s, T* out) {
  const Chain& c = *s.c;
  const Layer& p = c.L[c.nl - 1];
  const int N = c.N, R = p.cout, tn = p.tn_f, st = p.stat;
  const int ntiles = (N + tn - 1) / tn;
  const int lg = __ffs(tn) - 1;  // tn is a power of two
  const bool keep = p.keep;
  const T* z = static_cast<const T*>(p.z);
  for (int tile = blockIdx.x, k = 0; tile < ntiles; tile += gridDim.x, ++k) {
    const int n0 = tile * tn, cols = min(tn, N - n0);
    const float* zt = s.zs + k * R * tn;
    if constexpr (!std::is_same<T, float>::value) {
      for (int e = threadIdx.x; e < R * tn; e += kThreads) {
        const int r = e >> lg, j = e & (tn - 1);
        if (j >= cols) continue;
        const size_t o = (size_t)r * N + n0 + j;
        const float v = keep ? zt[e] : ld_cg(z + o);
        out[o] = from_f<T>(fmaxf(fmaf(v, s.sc[st + r], s.sh[st + r]), 0.0f));
      }
    } else if ((N & 3) == 0) {
      for (int e = 4 * threadIdx.x; e < R * tn; e += 4 * kThreads) {
        const int r = e >> lg, j = e & (tn - 1);
        if (j >= cols) continue;
        const size_t o = (size_t)r * N + n0 + j;
        const float4 v = keep ? *reinterpret_cast<const float4*>(zt + e)
                              : __ldcg(reinterpret_cast<const float4*>(z + o));
        const float sc = s.sc[st + r], sh = s.sh[st + r];
        *reinterpret_cast<float4*>(out + o) = make_float4(
            fmaxf(fmaf(v.x, sc, sh), 0.0f), fmaxf(fmaf(v.y, sc, sh), 0.0f),
            fmaxf(fmaf(v.z, sc, sh), 0.0f), fmaxf(fmaf(v.w, sc, sh), 0.0f));
      }
    } else {
      for (int e = threadIdx.x; e < R * tn; e += kThreads) {
        const int r = e >> lg, j = e & (tn - 1);
        if (j >= cols) continue;
        const size_t o = (size_t)r * N + n0 + j;
        const float v = keep ? zt[e] : __ldcg(z + o);
        out[o] = fmaxf(fmaf(v, s.sc[st + r], s.sh[st + r]), 0.0f);
      }
    }
  }
}

// g_z of layer l in place over its staged anchor rows (dst[co * ld + j]
// at n = n0 - halo + j, 0 outside [0, N)), with g loaded from device
// memory: each warp walks its rows' elements 16 at a time, all 16 loads
// in flight before any is used. g_z is rounded to T (the JAX kernels'
// g_zd). Then d_b's row sums over the tile's own columns into acc[0][co].
// Ends with g_z in place for every thread.
template <typename T>
__device__ __forceinline__ void stage_gz(const Smem& s, int l,
                                         const T* gin, int n0, int tn,
                                         int ld, float* dst) {
  const Chain& c = *s.c;
  const Layer& p = c.L[l];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, N = c.N;
  const int R = p.cout, halo = p.halo, base = n0 - halo, k = p.stat;
  const int width = tn + 2 * halo;
  const int iters = (width + 31) >> 5;  // a row's steps of 32 columns
  const int rows = warp < R ? (R - 1 - warp) / kWarps + 1 : 0;
  int i = 0, jj = 0;  // the next element: row warp + 8 i, column lane + 32 jj
  while (i < rows) {
    const int i0 = i, jj0 = jj;  // the batch is walked twice from here
    float gv[16];
#pragma unroll
    for (int u = 0; u < 16; ++u) {
      const int r = warp + kWarps * i, j = lane + 32 * jj, n = base + j;
      gv[u] = i < rows && j < width && (unsigned)n < (unsigned)N
                  ? ld_cg(gin + (size_t)r * N + n)
                  : 0.0f;
      if (++jj == iters) {
        jj = 0;
        ++i;
      }
    }
    i = i0;
    jj = jj0;
#pragma unroll
    for (int u = 0; u < 16; ++u) {
      const int r = warp + kWarps * i, j = lane + 32 * jj, n = base + j;
      if (i < rows && j < width) {
        float* d = dst + r * ld + j;
        float v = 0.0f;
        if ((unsigned)n < (unsigned)N) {
          const float isr = s.sr[k + r], gam = s.gam[k + r], z = *d;
          const float zh = (z - s.mean[k + r]) * isr;
          const float ga =
              fmaf(z, s.sc[k + r], s.sh[k + r]) > 0.0f ? gv[u] : 0.0f;
          v = (ga * gam - s.red[2 * kMaxC + r] * c.inv_n -
               zh * (s.red[3 * kMaxC + r] * c.inv_n)) *
              isr;
        }
        *d = rnd<T>(v);
      }
      if (++jj == iters) {
        jj = 0;
        ++i;
      }
    }
  }
  __syncthreads();
  const int cols = min(tn, N - n0);
  for (int co = warp; co < R; co += kWarps) {
    float db = 0.0f;
    for (int j = lane; j < cols; j += 32) db += dst[co * ld + halo + j];
    db = warp_sum(db);
    if (lane == 0) s.acc[co] += db;
  }
}

// Stage-exact backprop of layer l: gin the cotangent of its output, gout
// of its input (complete at this function's grid.sync).
template <typename T>
__device__ __forceinline__ void backward_layer(const Smem& s, int l,
                                               const T* x,
                                               const T* gin, T* gout,
                                               float* part, size_t slot_size,
                                               int& slot, float* dwpart,
                                               cg::grid_group& grid) {
  const Chain& c = *s.c;
  const Layer& p = c.L[l];
  const T* z = static_cast<const T*>(p.z);
  const int N = c.N, R = p.cout, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int tn = p.tn_b, ld = p.ld_b, width = tn + 2 * p.halo;
  const int ntiles = (N + tn - 1) / tn, nb = min((int)gridDim.x, ntiles);
  SQNXT_MARK(kMarkBwd + 6 * l);
  zero_acc(s);  // this layer's weights were issued before the last barrier

  // pass A: the four row sums of the norm's backward, over z and g staged
  // in shared memory (wa columns at a time: both fit the tile region)
  const int wa = min(tn, (c.tile_floats / (2 * R)) & ~3);
  float* zs = s.tile;
  float* gs = s.tile + R * wa;
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    for (int a0 = tile * tn; a0 < min(tile * tn + tn, N); a0 += wa) {
      const int cols = min(min(wa, tile * tn + tn - a0), N - a0);
      copy_rows(zs, wa, z, R, a0, cols, N);
      copy_rows(gs, wa, gin, R, a0, cols, N);
      cp_async_wait_all();
      __syncthreads();
      for (int co = warp; co < R; co += kWarps) {
        const int k = p.stat + co;
        const float m = s.mean[k], isr = s.sr[k], gam = s.gam[k],
                    sc = s.sc[k], sh = s.sh[k];
        float a0s = 0.0f, a1 = 0.0f, a2 = 0.0f, a3 = 0.0f;
        for (int j = lane; j < cols; j += 32) {
          const float z = zs[co * wa + j], zh = (z - m) * isr;
          const float ga = fmaf(z, sc, sh) > 0.0f ? gs[co * wa + j] : 0.0f;
          const float gzh = ga * gam;
          a0s += ga * zh;
          a1 += ga;
          a2 += gzh;
          a3 += gzh * zh;
        }
        a0s = warp_sum(a0s);
        a1 = warp_sum(a1);
        a2 = warp_sum(a2);
        a3 = warp_sum(a3);
        if (lane == 0) {
          s.acc[co] += a0s;
          s.acc[kMaxC + co] += a1;
          s.acc[2 * kMaxC + co] += a2;
          s.acc[3 * kMaxC + co] += a3;
        }
      }
      __syncthreads();
    }
  }
  __syncthreads();
  SQNXT_MARK(kMarkBwd + 6 * l + 1);
  float* sl = slot_of(part, slot_size, slot);
  if (blockIdx.x < ntiles) write_slot(s, 4, R, sl);
  grid.sync();
  sum_slots(s, sl, nb, 4, R);
  SQNXT_MARK(kMarkBwd + 6 * l + 2);
  if (blockIdx.x == 0)
    for (int r = threadIdx.x; r < R; r += kThreads) {
      p.dgam[r] = s.red[r];
      p.dbet[r] = s.red[kMaxC + r];
    }
  cp_async_wait_all();
  zero_acc(s);  // its barrier also publishes the staged weights

  // pass B: g_z (shared memory only), d_b's sums, g_h and dW per tile
  float* gz = s.tile;
  float* h = s.tile + R * ld;
  float* mine = dwpart + (size_t)blockIdx.x * c.dw_stride;
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int n0 = tile * tn;
    copy_rows(gz, ld, z, R, n0 - p.halo, width, N);  // waited below
    stage_input<T>(s, l, x, n0, p.halo, width, ld, h);
    stage_gz<T>(s, l, gin, n0, tn, ld, gz);
    stage_masks(c, p, n0, tn, s.msk);
    __syncthreads();
    const bool first = tile == (int)blockIdx.x;
    if (first) SQNXT_MARK(kMarkSub + 15 + 3 * l);
    gh_any<T>(c, p, s.w, gz, ld, s.msk, n0, tn, gout, s.x);
    if (first) SQNXT_MARK(kMarkSub + 15 + 3 * l + 1);
    dw_any(p, gz, h, ld, s.msk, tn, s.tile, mine, first);
    __syncthreads();
    if (first) SQNXT_MARK(kMarkSub + 15 + 3 * l + 2);
  }
  SQNXT_MARK(kMarkBwd + 6 * l + 3);
  if (l > 0) stage_w_bwd<T>(c.L[l - 1], s.w);  // lands while the grid meets
  float* sl2 = slot_of(part, slot_size, slot);
  if (blockIdx.x < ntiles) write_slot(s, 1, R, sl2);
  grid.sync();
  SQNXT_MARK(kMarkBwd + 6 * l + 4);

  // d_b by the last block; dW by every block: each float4 of entries summed by
  // one warp, lane k over blocks b = k, k + 32, ... (in order), then a
  // fixed shuffle tree
  if (blockIdx.x == gridDim.x - 1) {  // the block with the fewest dW columns
    sum_slots(s, sl2, nb, 1, R);
    for (int r = threadIdx.x; r < R; r += kThreads) p.db[r] = s.red[r];
  }
  const int E = p.taps * p.cin * R, E4 = (E + 3) >> 2;
  const float4* src = reinterpret_cast<const float4*>(dwpart);
  for (int col = blockIdx.x * kWarps + warp; col < E4;
       col += gridDim.x * kWarps) {
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 8
    for (int b = lane; b < nb; b += 32) {
      const float4 w = __ldcg(src + (size_t)b * (c.dw_stride >> 2) + col);
      v.x += w.x;
      v.y += w.y;
      v.z += w.z;
      v.w += w.w;
    }
    v.x = warp_sum(v.x);
    v.y = warp_sum(v.y);
    v.z = warp_sum(v.z);
    v.w = warp_sum(v.w);
    if (lane == 0) {
      const float vv[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (4 * col + i < E) p.dw[4 * col + i] = rnd<T>(vv[i]);
    }
  }
  SQNXT_MARK(kMarkBwd + 6 * l + 5);
}

// -- host side: the launch's layer table and occupancy ------------------------

constexpr int kIntsPerLayer = 5;  // cin, cout, taps, axis, single_pass

// The layer table from ints (per layer cin, cout, taps, axis (0 1x1, 1 j,
// 2 i), single_pass) with N, H, W: 0, or cudaErrorInvalidValue for a chain
// the kernels do not take. The plans fill in the rest.
inline int shape(Chain* c, int nl, const int* ints, int N, int H, int W) {
  if (nl < 1 || nl > kMaxLayers || !ints || N < 1 || H < 1 || W < 1 ||
      N % (H * W) != 0)
    return (int)cudaErrorInvalidValue;
  *c = Chain{};
  c->nl = nl;
  c->N = N;
  c->H = H;
  c->W = W;
  c->inv_n = (float)(1.0 / (double)N);
  for (int l = 0; l < nl; ++l) {
    Layer& p = c->L[l];
    const int* q = ints + l * kIntsPerLayer;
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
  }
  return 0;
}

// Blocks per SM of a cooperative kernel at `smem` bytes of dynamic shared
// memory on the current device, and the device's SMs, raising the
// kernel's opt-in attribute where needed; cudaErrorInvalidValue where smem
// exceeds the device's opt-in limit. Cached per (kernel, device, size):
// the wrappers ask before every launch.
template <typename Kernel>
inline int occupancy(Kernel kernel, size_t smem, int* per_sm, int* sms) {
  struct Entry {
    const void* fn;
    int dev;
    size_t smem;
    int per_sm, sms;
  };
  static Entry cache[256];
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
           per_sm, kernel, kThreads, smem)))
    return rc;
  if (*per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  if (used < 256) cache[used++] = Entry{(const void*)kernel, dev, smem, *per_sm,
                                        *sms};
  return 0;
}

}  // namespace sqnxt
