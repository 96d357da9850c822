// The tile machinery of the fused SqueezeNext kernels, sm_90a: fp32 FFMA on
// the CUDA cores (no TF32) for the fp32 instances, bf16 mma.sync on the
// tensor cores with fp32 accumulation for every bf16 instance, the chain's
// and the one-layer ones (note 9): the forward kernels K6 and K8
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
//    (g, the g buffers, dx) in device memory. The fp32 instances run the
//    FFMA tiles of notes 1-7, fp32 throughout; the bf16 instances the
//    tensor-core tiles of note 9. In both the products' sums, the
//    statistics, the norm's backward and the partial slots are fp32 (a
//    bf16 value is exact in fp32, so the products of two bf16 values are
//    exact and only their sums round, as in the JAX kernels' f32
//    accumulation). The bf16 instances round where the JAX kernels cast to
//    the activation dtype (pnode_tpu/ops/fused_sqnxt.py): z = bf16(bf16(acc)
//    + b) (:157), the norm's output before the ReLU (:176), g_z (:277), g_h
//    (:301) and each dW through bf16 (:291; rnd<T>, the identity for
//    float). The scratch is counted in floats for both: its partial slots
//    and dW slots are fp32, its anchors and g buffers take ceil(elements *
//    sizeof(T) / 4) floats (elem_floats), so at bf16 they take half the
//    room. The fp32 instances have the FFMA tiles' shared-memory layout,
//    the bf16 ones the tensor-core layout (tc::need); both have the store
//    (kStoreFloats).
// 9. The bf16 instances on the tensor cores (kTensorCores: K6's and K7's
//    bf16 chain and, one layer per launch, K8's and K9's, whose time went
//    to the staging's plain loads, pass A and the FFMA products, each
//    slower than in the fp32 instance; tools/trace_sqnxt.py --dtype bf16).
//    A one-layer launch is a chain of one: its layer is layer 0 whatever
//    its taps, reading its input raw (the previous launch wrote it as
//    ReLU(norm(z)) in bf16), so a (1,3) or (3,1) layer builds its tap rows
//    straight from the staged x. Every product operand is an exact
//    bf16 value, so it is staged as bf16 and nothing rounds that did not:
//    x, the anchors, g and z raw by 16-byte cp.async (8 columns; the halo
//    rounded up to 8 columns so every row starts aligned); the input
//    turned in place (one tap) or into one row per (tap, channel), shifted
//    and masked at the image border (three taps); g_z computed in place
//    and turned into its tap rows the same way; the weights in the layouts
//    the fragments want. Each product is then a plain matrix product over
//    k = t C + c, K padded to 16 and Cout/Cin to 8 with zero rows, on
//    mma.sync.m16n8k16.row.col.f32.bf16.bf16.f32 with ldmatrix fragments
//    (tc::product_t, tc::dw_product). The epilogues round where the FFMA
//    path does (z = bf16(bf16(acc) + b), g_h, each dW through bf16); the
//    statistics, the norm's backward and the partial slots stay fp32 in
//    the FFMA path's order; only the order of each product's fp32 sums
//    moves (over k in chunks of 16, the chunks in order). Tiles keep the
//    FFMA path's column tiles (at least 32 columns, kTcMinTN) and store;
//    z's tile in shared memory is column-swizzled (tc::zsw) so the
//    fragments' stores are conflict-free. mma.sync and not wgmma: the
//    products are small (K 16-192, Cout 8-128; a chain's 0.6 GFLOP
//    forward is ~0.6 us at 989 TFLOP/s), and the kernels are bound by
//    staging, loads and barriers, not by the tensor cores' rate. The plans
//    lay out the bf16 tile and weights (tc::need; pnode_sqnxt_layout
//    reports them).
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

// The instances that run on the tensor cores (note 9): every bf16
// instance, K6's and K7's chain and K8's and K9's one layer; the fp32
// instances keep the FFMA tiles.
template <typename T>
constexpr bool kTensorCores = std::is_same<T, bf16>::value;

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

// The tensor-core path's least column tile (tc: the bf16 instances): a
// whole number of 32-column blocks, so each product's 16-column jobs and k
// steps and the z tile's swizzle (tc::zsw) stay inside the tile; and its
// largest backward tile, so the backward's bf16 tile fits two blocks an
// SM.
constexpr int kTcMinTN = 32;
constexpr int kTcMaxTNb = 256;

// The per-layer fields of c.L[0..nl) that both plans use (tc: column tiles
// of at least kTcMinTN, backward ones of at most kTcMaxTNb).
inline void derive(Chain& c, bool tc = false) {
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
    if (tc) {
      p.tn_f = p.tn_f > kTcMinTN ? p.tn_f : kTcMinTN;
      p.tn_b = p.tn_b > kTcMinTN ? p.tn_b : kTcMinTN;
      p.tn_b = p.tn_b < kTcMaxTNb ? p.tn_b : kTcMaxTNb;
    }
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

// The tensor-core layout (the bf16 instances of K6-K9; note 9). Sizes in
// bf16 elements: a layer's tile of tn columns stages hr columns each side
// (its halo rounded up to 8, so each staged row starts 16-byte aligned) in
// raw rows ldr apart, and its product operands in rows
// ldh apart (a row stride of 16 bytes times an odd number, so ldmatrix's
// eight rows fall on distinct banks); kf = taps cin and kb = taps cout
// rounded up to 16 (the mma's k), cf = cout and cb = cin rounded up to 8
// (its n).
namespace tc {

struct Geo {
  int tn, hr, ldr, ldh, kf, kb, cf, cb;
};

__host__ __device__ inline int r8(int v) { return (v + 7) & ~7; }
__host__ __device__ inline int r16(int v) { return (v + 15) & ~15; }

__host__ __device__ inline Geo geo(const Layer& p, int tn) {
  Geo g;
  g.tn = tn;
  g.hr = p.taps == 1 ? 0 : r8(p.halo);
  g.ldr = tn + 2 * g.hr + 8;
  g.ldh = tn + 8;
  g.kf = r16(p.taps * p.cin);
  g.kb = r16(p.taps * p.cout);
  g.cf = r8(p.cout);
  g.cb = r8(p.cin);
  return g;
}

// Floats of the forward tile's operands: the raw rows (three taps: cin x
// ldr, then the tap rows kf x ldh; one tap: the raw rows are the operand,
// kf x ldh). The z tile (cout x tn bf16) follows them.
__host__ __device__ inline int fwd_ops_floats(const Layer& p, const Geo& g) {
  return round4(((p.taps == 1 ? 0 : p.cin * g.ldr) + g.kf * g.ldh) / 2);
}

__host__ __device__ inline int fwd_tile_floats(const Layer& p) {
  return fwd_ops_floats(p, geo(p, p.tn_f)) + p.cout * p.tn_f / 2;
}

// Floats of the backward's pass-B tile: z (then g_z; one tap: kb rows,
// g_h's operand), g, the raw input (one tap: kf x ldh, the dW operand),
// and for three taps the tap rows of g_z (kb x ldh) and of the input (kf x
// ldh).
__host__ __device__ inline int bwd_tile_floats(const Layer& p) {
  const Geo g = geo(p, p.tn_b);
  const int zr = p.taps == 1 ? g.kb : p.cout;
  const int e = (zr + p.cout) * g.ldr +
                (p.taps == 1 ? g.kf * g.ldh
                             : p.cin * g.ldr + (g.kb + g.kf) * g.ldh);
  return round4(e / 2);
}

// Floats of the staged weights: the forward's cf x (kf + 8) (rows co, k =
// t cin + ci), the backward's g_h weights cb x (kb + 8) (rows ci, k = t
// cout + co).
__host__ __device__ inline int wf_floats(const Layer& p) {
  const Geo g = geo(p, 0);
  return round4(g.cf * (g.kf + 8) / 2);
}

__host__ __device__ inline int wb_floats(const Layer& p) {
  const Geo g = geo(p, 0);
  return round4(g.cb * (g.kb + 8) / 2);
}

// The weights' and the tile's floats over the chain's layers (backward:
// both passes and both weight layouts, the forward recompute's among
// them), at least kTileOut (sum_slots' exchange).
inline void need(const Chain& c, bool backward, int* w_need, int* tile_need) {
  *w_need = 0;
  *tile_need = kTileOut;
  for (int l = 0; l < c.nl; ++l) {
    const Layer& p = c.L[l];
    int w = wf_floats(p), t = fwd_tile_floats(p);
    if (backward) {
      w = w > wb_floats(p) ? w : wb_floats(p);
      t = t > bwd_tile_floats(p) ? t : bwd_tile_floats(p);
    }
    *w_need = *w_need > w ? *w_need : w;
    *tile_need = *tile_need > t ? *tile_need : t;
  }
}

}  // namespace tc

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

// The backward kernels' plan: the derived fields and the layout (tc: the
// bf16 instances' tensor-core tile and weights). 0, or 1 where the chain
// exceeds what the kernel takes (the caller refuses it).
inline int plan(Chain& c, bool tc = false) {
  derive(c, tc);
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
  if (tc) {
    tc::need(c, true, &w_need, &tile_need);
    x_need = 0;
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
// tiles of z take (ceil(tiles / grid) tiles of cout x tn_f; tc, the bf16
// instances: bf16 tiles, half the floats) over the layers whose z the
// forward reads again: the last (the normalize-out pass) and each one with
// a centered variance (its second pass).
inline int store_floats(const Chain& c, int grid, bool tc = false) {
  int need = 0;
  for (int l = 0; l < c.nl; ++l) {
    const Layer& p = c.L[l];
    if (l + 1 < c.nl && p.single_pass) continue;
    const int tiles = (c.N + p.tn_f - 1) / p.tn_f;
    const int mine = (tiles + grid - 1) / grid * p.cout * p.tn_f;
    need = need > mine ? need : mine;
  }
  return round4(tc ? (need + 1) / 2 : need);  // tc: bf16 z tiles
}

// The forward kernels' plan at a grid of `grid` blocks: the derived fields
// and the layout (the staged tile with its halo, the layer's weights, the
// statistics, no g buffers or dW slots), with the store where it fits
// kStoreFloats at this grid (L[l].keep set for the layers it serves); tc:
// the bf16 instances' tensor-core tile and weights.
inline void plan_fwd(Chain& c, int grid, bool tc = false) {
  derive(c, tc);
  int w_need = 0, tile_need = kTileOut;  // the z tile with the groups' exchange
  for (int l = 0; l < c.nl; ++l) {
    const Layer& p = c.L[l];
    const int wf = p.taps * p.cin * p.rt_o, t_f = p.cin * (p.tn_f + 2 * p.halo);
    w_need = w_need > wf ? w_need : wf;
    tile_need = tile_need > t_f ? tile_need : t_f;
  }
  if (tc) tc::need(c, false, &w_need, &tile_need);
  const int store = store_floats(c, grid, tc), keep = store <= kStoreFloats;
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

// Layer l's fp32 weights for the forward product (the FFMA tiles; the
// bf16 instances stage theirs by tc::stage_w_fwd): wf[(t cin + ci) rt_o +
// co] = W[t, co, ci], rows co >= cout zero (4-byte copies: the layout
// turns). One warp a row (t, co) of W, its lanes along ci.
__device__ __forceinline__ void stage_w_fwd(const Layer& p, float* wf) {
  const int rt = p.rt_o, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float* w = static_cast<const float*>(p.w);
  for (int row = warp; row < p.taps * p.cout; row += kWarps) {
    const int t = row / p.cout, co = row - t * p.cout;
    for (int ci = lane; ci < p.cin; ci += 32)
      cp_async4(wf + (t * p.cin + ci) * rt + co, w + (size_t)row * p.cin + ci);
  }
  const int pad = rt - p.cout;
  for (int k = warp; k < p.taps * p.cin; k += kWarps)
    for (int j = lane; j < pad; j += 32) wf[k * rt + p.cout + j] = 0.0f;
}

// Layer l's fp32 weights for g_h (the FFMA tiles; the bf16 instances'
// are tc::stage_w_bwd): wb[(t cout + co) rt_i + ci] = W[t, co, ci],
// columns ci >= cin zero; 16-byte copies where cin % 4 == 0 (and W is
// 16-byte aligned), else 4-byte ones.
__device__ __forceinline__ void stage_w_bwd(const Layer& p, float* wb) {
  const int rt = p.rt_i, rows = p.taps * p.cout;
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

// Layer l's input rows for the tile's columns n0 - halo .. (width of
// them, ld apart): x for the first layer, else the previous layer's
// anchor, copied raw and then turned in place into ReLU(z sc + sh), once
// per element (0 stays outside [0, N)). Ends with every element in place
// for every thread.
__device__ __forceinline__ void stage_input(const Smem& s, int l,
                                            const float* x, int n0, int halo,
                                            int width, int ld, float* dst) {
  const Chain& c = *s.c;
  const int cin = c.L[l].cin, base = n0 - halo, N = c.N;
  copy_rows(dst, ld, l == 0 ? x : static_cast<const float*>(c.L[l - 1].z),
            cin, base, width, N);
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
        *d = fmaxf(fmaf(*d, sc, sh), 0.0f);
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
// the groups split co and meet in xb.
template <int RT, int TAPS, int KS>
__device__ __forceinline__ void gh_product(const Chain& c, const Layer& p,
                                           const float* wb, const float* gz,
                                           int ld, const unsigned char* msk,
                                           int n0, int tn, float* gout,
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
          if (n < N) gout[(size_t)ci * N + n] = acc[i][q];
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

// One forward tile of layer p: the product, then z = acc + b into zt (CT
// columns a row, in shared memory: over the staged input xs, or the
// block's store, for the row sums) and, where the layer has one, into the
// anchor in device memory. The groups meet over xs.
template <int RT, int TAPS, int KS>
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
  float* z_out = static_cast<float*>(p.z);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = 4 * ty + i;
    if (r >= p.cout) continue;
    const float b = ld_in(static_cast<const float*>(p.b) + r);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int j = tx + S::TX * q, n = n0 + j;
      const float z = acc[i][q] + b;
      zt[r * S::CT + j] = z;
      if (z_out && n < N) z_out[(size_t)r * N + n] = z;
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

static __device__ __noinline__ void fwd_tile_any(const Chain& c, const Layer& p,
                                                 const float* wf, const float* h,
                                                 int ld, const unsigned char* msk,
                                                 int n0, float* zt, float* xs) {
  if (p.taps == 1) {
    SQNXT_RT_SWITCH(p.rt_o, SQNXT_KS_SWITCH(p.ks_f, (fwd_tile<RT, 1, KS>(c, p, wf, h, ld, msk, n0, zt, xs))))
  } else {
    SQNXT_RT_SWITCH(p.rt_o, SQNXT_KS_SWITCH(p.ks_f, (fwd_tile<RT, 3, KS>(c, p, wf, h, ld, msk, n0, zt, xs))))
  }
}

// The forward tile at the layer's row tile, taps and reduction groups:
// inlined into the caller (kInline: the forward kernels, whose
// 128-register cap would otherwise save live values around the call), or
// the out-of-line fwd_tile_any (the backward kernels: their products
// inlined as well would double their build).
template <bool kInline>
__device__ __forceinline__ void fwd_tile_at(const Chain& c, const Layer& p,
                                            const float* wf, const float* h,
                                            int ld, const unsigned char* msk,
                                            int n0, float* zt, float* xs) {
  if constexpr (!kInline) {
    fwd_tile_any(c, p, wf, h, ld, msk, n0, zt, xs);
  } else if (p.taps == 1) {
    SQNXT_RT_SWITCH(p.rt_o, SQNXT_KS_SWITCH(p.ks_f, (fwd_tile<RT, 1, KS>(c, p, wf, h, ld, msk, n0, zt, xs))))
  } else {
    SQNXT_RT_SWITCH(p.rt_o, SQNXT_KS_SWITCH(p.ks_f, (fwd_tile<RT, 3, KS>(c, p, wf, h, ld, msk, n0, zt, xs))))
  }
}

static __device__ __noinline__ void gh_any(const Chain& c, const Layer& p,
                                           const float* wb, const float* gz, int ld,
                                           const unsigned char* msk, int n0, int tn,
                                           float* gout, float* xb) {
  if (p.taps == 1) {
    SQNXT_RT_SWITCH(p.rt_i, SQNXT_KS_SWITCH(p.ks_b, (gh_product<RT, 1, KS>(c, p, wb, gz, ld, msk, n0, tn, gout, xb))))
  } else {
    SQNXT_RT_SWITCH(p.rt_i, SQNXT_KS_SWITCH(p.ks_b, (gh_product<RT, 3, KS>(c, p, wb, gz, ld, msk, n0, tn, gout, xb))))
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

// -- the bf16 instances on the tensor cores ---------------------------------
//
// K6's-K9's bf16 instances (note 9). Every operand is a bf16 value
// staged as bf16: raw rows by 16-byte cp.async, then, for a layer with
// three taps, one row per (tap, channel) holding the row shifted by the
// tap and masked at the image border (the mask baked in, so the products
// are plain matrix products over k = t C + c, padded with zero rows to a
// multiple of 16). Each product runs on mma.sync.m16n8k16 (bf16 operands,
// fp32 accumulation), its fragments loaded by ldmatrix:
//   forward  z^T[n][co]  = sum_k Hs[k][n] Wf[co][k]   (A = Hs^T: .trans)
//   g_h      gh^T[n][ci] = sum_k Gs[k][n] Wb[ci][k]   (the same form)
//   dW       dW[co][k]   = sum_n Gc[co][n] Hs[k][n]   (k = the tile's n)
// A warp takes jobs of 16 rows of the output by 8 NF columns; rows of B
// past the layer's (n-frags of a pair past cf or cb) read the last row and
// are not stored. The fp32 sums of each output run over k in chunks of 16,
// the chunks added in order.
namespace tc {

using u16 = unsigned short;

__device__ __forceinline__ float f(u16 v) {
  return __uint_as_float((unsigned)v << 16);
}
__device__ __forceinline__ u16 h(float v) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}

// The z tile's column swizzle: element (r, j) of a zt row of tn (>= 32)
// columns at r tn + zsw(r, j), so the product's epilogue (lanes on 8
// columns by 4 row pairs) stores to 32 distinct banks; a permutation
// inside each 32 columns, so a warp's row reads stay conflict-free.
__host__ __device__ inline int zsw(int r, int j) {
  return j ^ (((r >> 1) & 3) << 3);
}

__device__ __forceinline__ unsigned saddr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(saddr(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void ldsm4(unsigned (&r)[4], const u16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(saddr(p)));
}

__device__ __forceinline__ void ldsm4t(unsigned (&r)[4], const u16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(saddr(p)));
}

// d += a b on a 16 x 8 x 16 tile: a row-major (m, k), b column-major (k, n)
__device__ __forceinline__ void mma(float (&d)[4], const unsigned (&a)[4],
                                    unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// dst[r * ld + j] = src[r * N + base + j], raw bf16, for r < rows and j <
// width, 0 outside [0, N): 16-byte cp.async (8 columns) where N and base
// are multiples of 8 and src is 16-byte aligned (a chunk then lies wholly
// inside or outside [0, N); the last may run past width, within ld), else
// 2-byte loads through L2. One warp a row; the caller waits.
__device__ __forceinline__ void copy_rows(u16* dst, int ld, const bf16* srcb,
                                          int rows, int base, int width,
                                          int N) {
  const u16* src = reinterpret_cast<const u16*>(srcb);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (((N | base) & 7) == 0 && (reinterpret_cast<size_t>(src) & 15) == 0) {
    const int w8 = (width + 7) >> 3;
    for (int r = warp; r < rows; r += kWarps)
      for (int j8 = lane; j8 < w8; j8 += 32) {
        const int n = base + 8 * j8;
        u16* d = dst + r * ld + 8 * j8;
        if ((unsigned)n < (unsigned)N)
          cp16(d, src + (size_t)r * N + n);
        else
          *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
      }
    return;
  }
  for (int r = warp; r < rows; r += kWarps)
    for (int j = lane; j < width; j += 32) {
      const int n = base + j;
      dst[r * ld + j] =
          (unsigned)n < (unsigned)N ? __ldcg(src + (size_t)r * N + n) : (u16)0;
    }
}

// rows [r0, r1) of a tile operand (ld apart) zero over its tn columns: the
// K padding of a product
__device__ __forceinline__ void zero_rows(u16* a, int ld, int r0, int r1,
                                          int tn) {
  const int c8 = tn >> 3;
  for (int e = threadIdx.x; e < (r1 - r0) * c8; e += kThreads) {
    const int r = r0 + e / c8, j = 8 * (e % c8);
    *reinterpret_cast<uint4*>(a + r * ld + j) = make_uint4(0u, 0u, 0u, 0u);
  }
}

// The forward's weights: Wf[co][t cin + ci] = W[t, co, ci], cf rows kf + 8
// apart, zero past cout and past taps cin (4-byte cp.async where cin is
// even, else 2-byte loads); the caller waits.
__device__ __forceinline__ void stage_w_fwd(const Layer& p, float* wbase) {
  u16* wf = reinterpret_cast<u16*>(wbase);
  const Geo g = geo(p, 0);
  const int ld = g.kf + 8, K = p.taps * p.cin, cin = p.cin;
  const u16* w = static_cast<const u16*>(p.w);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const bool pairs = (cin & 1) == 0 && (reinterpret_cast<size_t>(w) & 3) == 0;
  for (int row = warp; row < p.taps * p.cout; row += kWarps) {
    const int t = row / p.cout, co = row - t * p.cout;
    u16* d = wf + co * ld + t * cin;
    const u16* sr = w + (size_t)row * cin;
    if (pairs) {
      for (int ci = 2 * lane; ci < cin; ci += 64) {
        const unsigned a = saddr(d + ci);
        asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(a),
                     "l"(sr + ci)
                     : "memory");
      }
    } else {
      for (int ci = lane; ci < cin; ci += 32) d[ci] = __ldg(sr + ci);
    }
  }
  for (int e = threadIdx.x; e < g.cf * g.kf; e += kThreads) {
    const int co = e / g.kf, k = e - co * g.kf;
    if (co >= p.cout || k >= K) wf[co * ld + k] = 0;
  }
}

// g_h's weights: Wb[ci][t cout + co] = W[t, co, ci], cb rows kb + 8 apart,
// zero past cin and past taps cout (2-byte loads: the layout turns).
__device__ __forceinline__ void stage_w_bwd(const Layer& p, float* wbase) {
  u16* wb = reinterpret_cast<u16*>(wbase);
  const Geo g = geo(p, 0);
  const int ld = g.kb + 8, K = p.taps * p.cout, cin = p.cin;
  const u16* w = static_cast<const u16*>(p.w);
  for (int e = threadIdx.x; e < g.cb * g.kb; e += kThreads) {
    const int k = e / g.cb, ci = e - k * g.cb;  // neighbouring threads on ci
    wb[ci * ld + k] = ci < cin && k < K ? __ldg(w + (size_t)k * cin + ci) : 0;
  }
}

// Columns j .. j + 7 of a staged row shifted by sft (row[j + sft + i]),
// element i zeroed where msk[j + i] lacks `bit` (0: none zeroed): one
// 16-byte load where sft is a multiple of 8, two and funnel shifts where
// it is +-1. j is a multiple of 8.
__device__ __forceinline__ uint4 shifted8(const u16* row, int j, int sft,
                                          const unsigned char* msk,
                                          unsigned bit) {
  uint4 v;
  if ((sft & 7) == 0) {
    v = *reinterpret_cast<const uint4*>(row + j + sft);
  } else {
    const uint4 a = *reinterpret_cast<const uint4*>(row + j);
    if (sft == 1) {
      const unsigned b = *reinterpret_cast<const unsigned*>(row + j + 8);
      v = make_uint4(__funnelshift_r(a.x, a.y, 16),
                     __funnelshift_r(a.y, a.z, 16),
                     __funnelshift_r(a.z, a.w, 16),
                     __funnelshift_r(a.w, b, 16));
    } else {  // sft == -1
      const unsigned b = *reinterpret_cast<const unsigned*>(row + j - 2);
      v = make_uint4(__funnelshift_r(b, a.x, 16), __funnelshift_r(a.x, a.y, 16),
                     __funnelshift_r(a.y, a.z, 16),
                     __funnelshift_r(a.z, a.w, 16));
    }
  }
  if (bit) {
    const uint2 mm = *reinterpret_cast<const uint2*>(msk + j);
    unsigned* w = reinterpret_cast<unsigned*>(&v);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const unsigned mb = (q < 2 ? mm.x : mm.y) >> (16 * (q & 1));
      w[q] &= ((mb & bit) ? 0xffffu : 0u) |
              (((mb >> 8) & bit) ? 0xffff0000u : 0u);
    }
  }
  return v;
}

// Tap rows over a tile's tn columns: dst[t rows + r][j] = src[r][j + sft_t]
// masked (sft_t = dir (t - 1) step; bits[t] the mask bit, 0 for none), for
// r < rows and t < 3, src rows lds apart from column 0 = the tile's first.
// 8 columns a thread (shifted8) where every shift allows, else 2.
__device__ __forceinline__ void tap_rows(const u16* src, int lds, int rows,
                                         int step, int dir,
                                         const unsigned (&bits)[3], u16* dst,
                                         int ldd, int tn,
                                         const unsigned char* msk) {
  if ((step & 7) == 0 || step == 1) {
    const int c8 = tn >> 3;
    for (int e = threadIdx.x; e < 3 * rows * c8; e += kThreads) {
      const int row = e / c8, j = 8 * (e - row * c8);
      const int t = (row >= rows) + (row >= 2 * rows), r = row - t * rows;
      *reinterpret_cast<uint4*>(dst + row * ldd + j) =
          shifted8(src + r * lds, j, dir * (t - 1) * step, msk, bits[t]);
    }
    return;
  }
  const int w2 = tn >> 1;
  for (int e = threadIdx.x; e < 3 * rows * w2; e += kThreads) {
    const int row = e / w2, j = 2 * (e - row * w2);
    const int t = (row >= rows) + (row >= 2 * rows), r = row - t * rows;
    const u16* sr = src + r * lds + dir * (t - 1) * step;
    unsigned o = 0;
#pragma unroll
    for (int i = 0; i < 2; ++i)
      if (!bits[t] || (msk[j + i] & bits[t]))
        o |= (unsigned)sr[j + i] << (16 * i);
    *reinterpret_cast<unsigned*>(dst + row * ldd + j) = o;
  }
}

// Rows [0, rows) of a staged input, columns [0, width) at n = base + j,
// turned in place into rnd(ReLU(z sc + sh)) of the previous layer's norm
// (statistics at st; 0 stays outside [0, N)), 8 columns a thread.
__device__ __forceinline__ void turn_rows(const Smem& s, int st, u16* R,
                                          int ld, int rows, int width,
                                          int base, int N) {
  const int c8 = width >> 3;
  for (int e = threadIdx.x; e < rows * c8; e += kThreads) {
    const int ci = e / c8, j = 8 * (e - ci * c8);
    uint4* q = reinterpret_cast<uint4*>(R + ci * ld + j);
    uint4 v = *q;
    u16* u = reinterpret_cast<u16*>(&v);
    const float sc = s.sc[st + ci], sh = s.sh[st + ci];
#pragma unroll
    for (int i = 0; i < 8; ++i)
      if ((unsigned)(base + j + i) < (unsigned)N)
        u[i] = h(fmaxf(fmaf(f(u[i]), sc, sh), 0.0f));
    *q = v;
  }
}

// Layer l's input as the product operand over the tile's columns n0 .. n0 +
// tn - 1: Hs[t cin + ci][j] = ok_t(n0 + j) h[ci][n0 + j + s_t], h = x (l =
// 0) or the previous layer's rnd(ReLU(z sc + sh)) (the fp32 path's
// stage_input form; 0 outside [0, N)), from the raw rows R (column hr at
// n0), turned in place first; rows taps cin .. kf - 1 zero. One tap: R is
// Hs. Layer 0 with three taps (a one-layer launch of the (1,3) or (3,1)
// conv) builds its tap rows from the raw rows as staged, which the
// caller's barrier after the copy has published. Ends without a barrier.
__device__ __forceinline__ void build_input(const Smem& s, int l,
                                            const Layer& p, const Geo& g,
                                            u16* R, u16* Hs,
                                            const unsigned char* msk, int n0) {
  const Chain& c = *s.c;
  if (l > 0)
    turn_rows(s, c.L[l - 1].stat, R, g.ldr, p.cin, g.tn + 2 * g.hr,
              n0 - g.hr, c.N);
  if (p.taps == 3) {
    if (l > 0) __syncthreads();
    const unsigned bits[3] = {1u, 0u, 2u};
    tap_rows(R + g.hr, g.ldr, p.cin, p.step, 1, bits, Hs, g.ldh, g.tn, msk);
  }
  zero_rows(Hs, g.ldh, p.taps * p.cin, g.kf, g.tn);
}

// out^T[m][n] = sum_k A[k][m] B[n][k] over a tile's tn columns m: A the
// tap rows (kdim of them, lda apart), B the staged weights (nrows rows, ldb
// apart). Warp jobs of 16 columns m by 8 NF rows n (NF even); epi(m, n, v)
// for each of the job's sums, n possibly past nrows.
template <int NF, typename Epi>
__device__ __forceinline__ void product_t(const u16* A, int lda, const u16* B,
                                          int ldb, int nrows, int kdim,
                                          int tn, Epi epi) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int li = lane >> 3, lr = lane & 7, gq = lane >> 2, tq = lane & 3;
  const int nm = tn >> 4, nn = (nrows + 8 * NF - 1) / (8 * NF);
  for (int job = warp; job < nm * nn; job += kWarps) {
    const int nb = job / nm, m0 = 16 * (job - nb * nm), c0 = 8 * NF * nb;
    float acc[NF][4];
#pragma unroll
    for (int q = 0; q < NF; ++q)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[q][e] = 0.0f;
    const u16* pa = A + (lr + 8 * (li >> 1)) * lda + m0 + 8 * (li & 1);
    const u16* pb[NF / 2];
#pragma unroll
    for (int q = 0; q < NF / 2; ++q)
      pb[q] = B + min(c0 + 16 * q + lr + 8 * (li >> 1), nrows - 1) * ldb +
              8 * (li & 1);
#pragma unroll 2
    for (int k0 = 0; k0 < kdim; k0 += 16) {
      unsigned a[4];
      ldsm4t(a, pa + k0 * lda);
#pragma unroll
      for (int q = 0; q < NF / 2; ++q) {
        unsigned b[4];
        ldsm4(b, pb[q] + k0);
        mma(acc[2 * q], a, b[0], b[1]);
        mma(acc[2 * q + 1], a, b[2], b[3]);
      }
    }
#pragma unroll
    for (int q = 0; q < NF; ++q)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        epi(m0 + gq + 8 * (e >> 1), c0 + 8 * q + 2 * tq + (e & 1), acc[q][e]);
  }
}

// One forward tile of layer l: the input staged raw and turned into the
// operand, the product, z = bf16(bf16(acc) + b) into the bf16 z tile zt
// (swizzled, zsw; row_sums writes the anchor from it).
__device__ __forceinline__ void fwd_tile(const Smem& s, int l, const bf16* x,
                                         int n0, u16* zt, bool first) {
  const Chain& c = *s.c;
  const Layer& p = c.L[l];
  const Geo g = geo(p, p.tn_f);
  const int cout = p.cout, tn = g.tn;
  u16* R = reinterpret_cast<u16*>(s.tile);
  u16* Hs = p.taps == 1 ? R : R + p.cin * g.ldr;
  copy_rows(R, g.ldr, l == 0 ? x : static_cast<const bf16*>(c.L[l - 1].z),
            p.cin, n0 - g.hr, tn + 2 * g.hr, c.N);
  stage_masks(c, p, n0, tn, s.msk);
  cp_async_wait_all();
  __syncthreads();
  build_input(s, l, p, g, R, Hs, s.msk, n0);
  __syncthreads();
  if (first) SQNXT_MARK(kMarkSub + 3 * l);
  const bf16* bias = static_cast<const bf16*>(p.b);
  auto epi = [&](int m, int co, float v) {
    if (co < cout)
      zt[co * tn + zsw(co, m)] = h(rnd<bf16>(v) + ld_in(bias + co));
  };
  const u16* wf = reinterpret_cast<const u16*>(s.w);
  if (g.cf <= 16)
    product_t<2>(Hs, g.ldh, wf, g.kf + 8, g.cf, g.kf, tn, epi);
  else
    product_t<4>(Hs, g.ldh, wf, g.kf + 8, g.cf, g.kf, tn, epi);
  __syncthreads();
}

// Layer p's row sums of z and z^2 over the tile's cols columns from its z
// tile zt (bf16, swizzled) into acc[0][r] and acc[1][r], in the FFMA
// path's order, and from the same reads its anchor, where it has one
// (lanes on neighbouring columns, as the fragments' 8 columns by 4 rows
// are not).
__device__ __forceinline__ void row_sums(const Smem& s, const Layer& p,
                                         const u16* zt, int n0, int cols) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int tn = p.tn_f, N = s.c->N;
  u16* zo = static_cast<u16*>(p.z);
  for (int r = warp; r < p.cout; r += kWarps) {
    float s1 = 0.0f, s2 = 0.0f;
    for (int j = lane; j < cols; j += 32) {
      const u16 v = zt[r * tn + zsw(r, j)];
      const float z = f(v);
      s1 += z;
      s2 += z * z;
      if (zo) zo[(size_t)r * N + n0 + j] = v;
    }
    s1 = warp_sum(s1);
    s2 = warp_sum(s2);
    if (lane == 0) {
      s.acc[r] += s1;
      s.acc[kMaxC + r] += s2;
    }
  }
}

// g_z of layer l in place over Z's columns 0 .. tn + 2 hr - 1 (n = n0 - hr
// + j; 0 outside [0, N)), from z (Z) and the cotangent g (G), rounded to
// bf16 (the fp32 path's stage_gz, 8 columns at a time); one tap: Z's rows
// cout .. kb - 1, g_h's K padding, zeroed. No barrier.
__device__ __forceinline__ void gz_in_place(const Smem& s, const Layer& p,
                                            const Geo& g, u16* Z, const u16* G,
                                            int n0) {
  const Chain& c = *s.c;
  const int N = c.N, R = p.cout, k = p.stat, base = n0 - g.hr;
  const int w8 = (g.tn + 2 * g.hr) >> 3;
  for (int e = threadIdx.x; e < R * w8; e += kThreads) {
    const int r = e / w8, j = 8 * (e - r * w8);
    const float isr = s.sr[k + r], gam = s.gam[k + r], m = s.mean[k + r];
    const float sc = s.sc[k + r], sh = s.sh[k + r];
    const float c1 = s.red[2 * kMaxC + r] * c.inv_n;
    const float c2 = s.red[3 * kMaxC + r] * c.inv_n;
    uint4* q = reinterpret_cast<uint4*>(Z + r * g.ldr + j);
    uint4 zv = *q;
    const uint4 gv = *reinterpret_cast<const uint4*>(G + r * g.ldr + j);
    u16* zu = reinterpret_cast<u16*>(&zv);
    const u16* gu = reinterpret_cast<const u16*>(&gv);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      float v = 0.0f;
      if ((unsigned)(base + j + i) < (unsigned)N) {
        const float z = f(zu[i]);
        const float zh = (z - m) * isr;
        const float ga = fmaf(z, sc, sh) > 0.0f ? f(gu[i]) : 0.0f;
        v = (ga * gam - c1 - zh * c2) * isr;
      }
      zu[i] = h(v);
    }
    *q = zv;
  }
  if (p.taps == 1) zero_rows(Z, g.ldr, R, g.kb, g.tn);
}

// g_h's operand for three taps: Gs[t cout + co][j] = Z[co][hr + j - s_t]
// where the source column exists (t = 0: the column has a neighbour at +1,
// t = 2: at -1), else 0; rows 3 cout .. kb - 1 zero. No barrier.
__device__ __forceinline__ void gz_taps(const Layer& p, const Geo& g,
                                        const u16* Z, u16* Gs,
                                        const unsigned char* msk) {
  const unsigned bits[3] = {2u, 0u, 1u};
  tap_rows(Z + g.hr, g.ldr, p.cout, p.step, -1, bits, Gs, g.ldh, g.tn, msk);
  zero_rows(Gs, g.ldh, 3 * p.cout, g.kb, g.tn);
}

// dW of one tile, added to this block's slot (first tile: stored):
// dW[co][k] = sum_n Gc[co][n] Hs[k][n] over the tile's tn columns, k = t
// cin + ci < taps cin. Warp jobs of 16 rows co by 16 k, n in steps of 16.
__device__ __forceinline__ void dw_product(const Layer& p, const Geo& g,
                                           const u16* Gc, const u16* Hs,
                                           float* slot, bool first) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int li = lane >> 3, lr = lane & 7, gq = lane >> 2, tq = lane & 3;
  const int cout = p.cout, cin = p.cin, K = p.taps * cin;
  const int nc = (cout + 15) >> 4, nk = g.kf >> 4;
  for (int job = warp; job < nc * nk; job += kWarps) {
    const int kb = job / nc, co0 = 16 * (job - kb * nc), k0 = 16 * kb;
    float acc[2][4];
#pragma unroll
    for (int q = 0; q < 2; ++q)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[q][e] = 0.0f;
    const u16* pa = Gc + min(co0 + lr + 8 * (li & 1), cout - 1) * g.ldh +
                    8 * (li >> 1);
    const u16* pb = Hs + (k0 + lr + 8 * (li >> 1)) * g.ldh + 8 * (li & 1);
#pragma unroll 2
    for (int n0 = 0; n0 < g.tn; n0 += 16) {
      unsigned a[4], b[4];
      ldsm4(a, pa + n0);
      ldsm4(b, pb + n0);
      mma(acc[0], a, b[0], b[1]);
      mma(acc[1], a, b[2], b[3]);
    }
#pragma unroll
    for (int q = 0; q < 2; ++q)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int co = co0 + gq + 8 * (e >> 1);
        const int k = k0 + 8 * q + 2 * tq + (e & 1);
        if (co >= cout || k >= K) continue;
        const int t = (k >= cin) + (k >= 2 * cin);
        float* d = slot + ((size_t)t * cout + co) * cin + (k - t * cin);
        *d = first ? acc[q][e] : *d + acc[q][e];
      }
  }
}

// Pass A's staging: z and g, wa columns a row from a0, raw into the tile
// region (zs at 0, gs after it), waited on; returns gs.
__device__ __forceinline__ const u16* stage_pass_a(u16* zs, int wa,
                                                   const bf16* z,
                                                   const bf16* gin, int R,
                                                   int a0, int cols, int N) {
  u16* gs = zs + R * wa;
  copy_rows(zs, wa, z, R, a0, cols, N);
  copy_rows(gs, wa, gin, R, a0, cols, N);
  cp_async_wait_all();
  __syncthreads();
  return gs;
}

// One pass-B tile of layer l: z, g and the input staged raw; the input
// turned into the dW operand, g_z in place (then d_b's row sums over the
// tile's own columns into acc[0][co]) and, for three taps, into g_h's tap
// rows; g_h (to gout) and dW (into the block's slot).
__device__ __forceinline__ void bwd_tile(const Smem& s, int l, const bf16* x,
                                         const bf16* gin, bf16* gout, int n0,
                                         float* slot, bool first) {
  const Chain& c = *s.c;
  const Layer& p = c.L[l];
  const Geo g = geo(p, p.tn_b);
  const int N = c.N, cout = p.cout, cin = p.cin, tn = g.tn;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const bool one = p.taps == 1;
  u16* Z = reinterpret_cast<u16*>(s.tile);  // z, then g_z (one tap: kb rows)
  u16* G = Z + (one ? g.kb : cout) * g.ldr;
  u16* H = G + cout * g.ldr;  // the raw input (one tap: the dW operand)
  u16* Gs = one ? Z : H + cin * g.ldr;
  u16* Hs = one ? H : Gs + g.kb * g.ldh;
  const int base = n0 - g.hr, width = tn + 2 * g.hr;
  copy_rows(Z, g.ldr, static_cast<const bf16*>(p.z), cout, base, width, N);
  copy_rows(G, g.ldr, gin, cout, base, width, N);
  copy_rows(H, g.ldr, l == 0 ? x : static_cast<const bf16*>(c.L[l - 1].z),
            cin, base, width, N);
  stage_masks(c, p, n0, tn, s.msk);
  cp_async_wait_all();
  __syncthreads();
  build_input(s, l, p, g, H, Hs, s.msk, n0);
  gz_in_place(s, p, g, Z, G, n0);
  __syncthreads();
  const int cols = min(tn, N - n0);
  for (int co = warp; co < cout; co += kWarps) {
    float db = 0.0f;
    for (int j = lane; j < cols; j += 32) db += f(Z[co * g.ldr + g.hr + j]);
    db = warp_sum(db);
    if (lane == 0) s.acc[co] += db;
  }
  if (!one) gz_taps(p, g, Z, Gs, s.msk);
  __syncthreads();
  if (first) SQNXT_MARK(kMarkSub + 15 + 3 * l);
  auto epi = [&](int m, int ci, float v) {
    if (ci < cin && n0 + m < N) gout[(size_t)ci * N + n0 + m] = from_f<bf16>(v);
  };
  const u16* wb = reinterpret_cast<const u16*>(s.w);
  if (g.cb <= 16)
    product_t<2>(Gs, g.ldh, wb, g.kb + 8, g.cb, g.kb, tn, epi);
  else
    product_t<4>(Gs, g.ldh, wb, g.kb + 8, g.cb, g.kb, tn, epi);
  if (first) SQNXT_MARK(kMarkSub + 15 + 3 * l + 1);
  dw_product(p, g, one ? Z : Gs + cout * g.ldh, Hs, slot, first);
  __syncthreads();
  if (first) SQNXT_MARK(kMarkSub + 15 + 3 * l + 2);
}

// The forward kernel's output from the last layer's z (the block's store,
// bf16 and swizzled, or its anchor): out = bf16(ReLU(z sc + sh)).
__device__ __forceinline__ void normalize_out(const Smem& s, bf16* out) {
  const Chain& c = *s.c;
  const Layer& p = c.L[c.nl - 1];
  const int N = c.N, R = p.cout, tn = p.tn_f, st = p.stat;
  const int ntiles = (N + tn - 1) / tn;
  const int lg = __ffs(tn) - 1;  // tn is a power of two
  const bool keep = p.keep;
  const u16* z = static_cast<const u16*>(p.z);
  u16* o = reinterpret_cast<u16*>(out);
  const bool vec = keep && (N & 7) == 0;  // whole 16-byte chunks
  for (int tile = blockIdx.x, k = 0; tile < ntiles; tile += gridDim.x, ++k) {
    const int n0 = tile * tn, cols = min(tn, N - n0);
    const u16* zt = reinterpret_cast<const u16*>(s.zs) + k * R * tn;
    if (vec) {  // 8 columns a thread: zsw keeps each aligned 8 together
      for (int e = 8 * threadIdx.x; e < R * tn; e += 8 * kThreads) {
        const int r = e >> lg, j = e & (tn - 1);
        if (j >= cols) continue;
        uint4 v = *reinterpret_cast<const uint4*>(zt + r * tn + zsw(r, j));
        u16* u = reinterpret_cast<u16*>(&v);
        const float sc = s.sc[st + r], sh = s.sh[st + r];
#pragma unroll
        for (int i = 0; i < 8; ++i)
          u[i] = h(fmaxf(fmaf(f(u[i]), sc, sh), 0.0f));
        *reinterpret_cast<uint4*>(o + (size_t)r * N + n0 + j) = v;
      }
      continue;
    }
    for (int e = threadIdx.x; e < R * tn; e += kThreads) {
      const int r = e >> lg, j = e & (tn - 1);
      if (j >= cols) continue;
      const size_t off = (size_t)r * N + n0 + j;
      const float v = f(keep ? zt[r * tn + zsw(r, j)] : __ldcg(z + off));
      o[off] = h(fmaxf(fmaf(v, s.sc[st + r], s.sh[st + r]), 0.0f));
    }
  }
}

}  // namespace tc

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
// tiles' products are called out of line (fwd_tile_at). kTC: the bf16
// instances' tiles on the tensor cores (tc::fwd_tile; its z tiles
// swizzled).
template <typename T, bool kBackward, bool kTC = false>
__device__ __forceinline__ void forward_layers(const Smem& s, const T* x,
                                               float* part, size_t slot_size,
                                               int& slot,
                                               cg::grid_group& grid) {
  const Chain& c = *s.c;
  const int N = c.N, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if constexpr (kTC)
    tc::stage_w_fwd(c.L[0], s.w);
  else
    stage_w_fwd(c.L[0], s.w);
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
      if constexpr (kTC) {  // z in bf16: the store's tile k, or after the
                            // tile's operands
        tc::u16* zt = reinterpret_cast<tc::u16*>(
            p.keep ? s.zs : s.tile + tc::fwd_ops_floats(p, tc::geo(p, tn)));
        if (p.keep) zt += k * p.cout * tn;
        tc::fwd_tile(s, l, x, n0, zt, first);
        if (first) SQNXT_MARK(kMarkSub + 3 * l + 1);
        tc::row_sums(s, p, zt, n0, cols);
      } else {
        float* zt = p.keep ? s.zs + k * p.cout * tn : s.tile;
        stage_input(s, l, x, n0, p.halo, ld, ld, s.tile);
        stage_masks(c, p, n0, tn, s.msk);
        __syncthreads();
        if (first) SQNXT_MARK(kMarkSub + 3 * l);
        fwd_tile_at<!kBackward>(c, p, s.w, s.tile, ld, s.msk, n0, zt,
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
      }
      __syncthreads();
      if (first) SQNXT_MARK(kMarkSub + 3 * l + 2);
    }
    SQNXT_MARK(4 * l + 1);
    // the next weights (K7's and K9's: the backward's first after the last
    // layer) land while the grid meets
    if constexpr (kTC) {
      if (l + 1 < c.nl)
        tc::stage_w_fwd(c.L[l + 1], s.w);
      else if (kBackward)
        tc::stage_w_bwd(p, s.w);
    } else if (l + 1 < c.nl) {
      stage_w_fwd(c.L[l + 1], s.w);
    } else if (kBackward) {
      stage_w_bwd(p, s.w);
    }
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
        // kTC: z in bf16, the store's tiles swizzled (tc::zsw), a tile
        // copied from the anchor not
        const float* zt = s.zs + k * p.cout * tn;
        const tc::u16* z16 =
            reinterpret_cast<const tc::u16*>(s.zs) + k * p.cout * tn;
        bool sw = kTC;
        if (!p.keep) {
          if constexpr (kTC)
            tc::copy_rows(reinterpret_cast<tc::u16*>(s.tile), tn,
                          static_cast<const bf16*>(p.z), p.cout, n0, cols, N);
          else
            copy_rows(s.tile, tn, static_cast<const T*>(p.z), p.cout, n0,
                      cols, N);
          cp_async_wait_all();
          __syncthreads();
          zt = s.tile;
          z16 = reinterpret_cast<const tc::u16*>(s.tile);
          sw = false;
        }
        for (int r = warp; r < p.cout; r += kWarps) {
          const float m = s.mean[p.stat + r];
          float v = 0.0f;
          for (int j = lane; j < cols; j += 32) {
            const float d =
                (kTC ? tc::f(z16[r * tn + (sw ? tc::zsw(r, j) : j)])
                     : zt[r * tn + j]) -
                m;
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

// The fp32 forward kernels' output (the bf16 instances' is
// tc::normalize_out): out = ReLU(z sc + sh) of the last layer over this
// block's tiles of it (the form of the staging and of the backward's ReLU
// gates), z read from the store where the layer keeps it, else from its
// anchor; 16-byte loads and stores where N is a multiple of 4 (every
// tile's first column is).
__device__ __forceinline__ void normalize_out(const Smem& s, float* out) {
  const Chain& c = *s.c;
  const Layer& p = c.L[c.nl - 1];
  const int N = c.N, R = p.cout, tn = p.tn_f, st = p.stat;
  const int ntiles = (N + tn - 1) / tn;
  const int lg = __ffs(tn) - 1;  // tn is a power of two
  const bool keep = p.keep;
  const float* z = static_cast<const float*>(p.z);
  for (int tile = blockIdx.x, k = 0; tile < ntiles; tile += gridDim.x, ++k) {
    const int n0 = tile * tn, cols = min(tn, N - n0);
    const float* zt = s.zs + k * R * tn;
    if ((N & 3) == 0) {
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
// in flight before any is used. Then d_b's row sums over the tile's own
// columns into acc[0][co]. Ends with g_z in place for every thread.
__device__ __forceinline__ void stage_gz(const Smem& s, int l,
                                         const float* gin, int n0, int tn,
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
        *d = v;
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
// of its input (complete at this function's grid.sync). kTC: the bf16
// instances' pass A staged raw by cp.async and pass B on the tensor cores
// (tc::bwd_tile).
template <typename T, bool kTC = false>
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
  // (kTC: bf16 rows, so twice the columns fit, a multiple of 8)
  const int wa = kTC ? min(tn, (c.tile_floats / R) & ~7)
                     : min(tn, (c.tile_floats / (2 * R)) & ~3);
  float* zs = s.tile;
  float* gs = s.tile + R * wa;
  tc::u16* zh16 = reinterpret_cast<tc::u16*>(s.tile);
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    for (int a0 = tile * tn; a0 < min(tile * tn + tn, N); a0 += wa) {
      const int cols = min(min(wa, tile * tn + tn - a0), N - a0);
      const tc::u16* gh16 = nullptr;
      if constexpr (kTC) {
        gh16 = tc::stage_pass_a(zh16, wa, z, gin, R, a0, cols, N);
      } else {
        copy_rows(zs, wa, z, R, a0, cols, N);
        copy_rows(gs, wa, gin, R, a0, cols, N);
        cp_async_wait_all();
        __syncthreads();
      }
      for (int co = warp; co < R; co += kWarps) {
        const int k = p.stat + co;
        const float m = s.mean[k], isr = s.sr[k], gam = s.gam[k],
                    sc = s.sc[k], sh = s.sh[k];
        float a0s = 0.0f, a1 = 0.0f, a2 = 0.0f, a3 = 0.0f;
        for (int j = lane; j < cols; j += 32) {
          const float z = kTC ? tc::f(zh16[co * wa + j]) : zs[co * wa + j];
          const float zh = (z - m) * isr;
          const float gv = kTC ? tc::f(gh16[co * wa + j]) : gs[co * wa + j];
          const float ga = fmaf(z, sc, sh) > 0.0f ? gv : 0.0f;
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
    const bool first = tile == (int)blockIdx.x;
    if constexpr (kTC) {
      tc::bwd_tile(s, l, x, gin, gout, n0, mine, first);
    } else {
      copy_rows(gz, ld, z, R, n0 - p.halo, width, N);  // waited below
      stage_input(s, l, x, n0, p.halo, width, ld, h);
      stage_gz(s, l, gin, n0, tn, ld, gz);
      stage_masks(c, p, n0, tn, s.msk);
      __syncthreads();
      if (first) SQNXT_MARK(kMarkSub + 15 + 3 * l);
      gh_any(c, p, s.w, gz, ld, s.msk, n0, tn, gout, s.x);
      if (first) SQNXT_MARK(kMarkSub + 15 + 3 * l + 1);
      dw_any(p, gz, h, ld, s.msk, tn, s.tile, mine, first);
      __syncthreads();
      if (first) SQNXT_MARK(kMarkSub + 15 + 3 * l + 2);
    }
  }
  SQNXT_MARK(kMarkBwd + 6 * l + 3);
  if (l > 0) {  // lands while the grid meets
    if constexpr (kTC)
      tc::stage_w_bwd(c.L[l - 1], s.w);
    else
      stage_w_bwd(c.L[l - 1], s.w);
  }
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
