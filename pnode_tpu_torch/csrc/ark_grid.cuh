// The grid form of K3's reverse step, K4's training iteration, K12's
// gradient step and K2's forward step: every dependent product of the step
// runs over the whole cooperative grid. The plans (plan_rev's caller in
// each source) take it where the row form (ark_tiles.cuh) cannot keep inv
// and J in shared memory (RevPlan.resident 0: past d ~160 at KS-like
// stacks, Burgers-512 among them; K2 and K12 from kGridMinD up); KS keeps
// the row form.
//
// What it answers: at Burgers-512 (B 200, 512 -> 576 x4 -> 512) the row
// form gives each block one batch row and pulls the whole 6.35 MB weight
// stack through its ring twice a stage, ~0.8 FLOP a byte of L2 traffic, and
// writes a dW/db partial of the whole stack per block (1.27 GB a K3 call).
// A product there is a real matrix product, 200 x 576 x 576, so here:
//
// - A product's (M x N) output is cut into 32 x 32 tiles that the grid's
//   tile groups walk: one block per SM, two groups of 128 threads a block,
//   so a phase's first 132 tiles land on distinct SMs (a product of 200
//   rows has 112-126). A group stages 64-deep chunks of the tile's input
//   rows and of the operand in shared memory, two buffers: the next chunk
//   is loaded through L2 (ld.global.cg, volatile, so the loads stay ahead
//   of the FMAs they overlap; 16-byte where the rows are aligned) into
//   registers while the current one multiplies, then stored. Each thread
//   keeps a 2 x 4 register tile (its 2 rows of A as a float2, its 4
//   columns of B as a float4 per position, conflict-free) and runs one
//   FMA chain per output, fp32 on the CUDA cores: no TF32, no tensor
//   cores. cp.async does not fit: its 4-byte form allocates in L1 (stale
//   for what another SM wrote in the launch), its 16-byte form cannot
//   transpose, and half the operands are read transposed.
// - The reduction runs in the row form's order: one chain over k
//   ascending, or where the row form splits k over G thread groups
//   (split_k), G chains over the positions each group takes (k mod G, or
//   blocks of 4 n in the backprop where the width allows), summed in
//   group order. So the recompute's ReLU decisions, the forward of K4,
//   K12 and K2 (K2's arithmetic) and K3's lam_prev carry the row form's
//   bits, and every output is one fixed sum whatever the grid.
// - A grid-wide barrier separates dependent products; the elementwise
//   terms fold into the epilogue of the product before them: the stage
//   sums G_i, kI_i, y1, K2's err and the MSE seed (forward), u_i / uh_i,
//   p_i, q_i, xi_i and lam_prev (reverse), in the row form's order, each
//   thread's 8 outputs' operands loaded together. K3 recomputes every
//   stage's layer inputs at once (M = s B rows); K4 and K12 keep their
//   forward's, which have the recompute's bits. An explicit stage's u J
//   shares the first backprop's barrier, its stiff forward product the
//   first layer's where the stack has more than one layer. No phase
//   writes what another tile of it reads, beyond a thread's own outputs.
// - Layer inputs, covectors and stage values of every stage live in a
//   device workspace (plan_grid; ~22 MB at Burgers, L2-resident), in
//   stage-descending slots (K2, which forms no dW/db, in ascending ones:
//   its stage values are the caller's ys in stage order), written by one
//   SM and read by another within the launch, so every read of it, and of
//   K4's weights that Adam rewrites, goes through L2 (ld.global.cg).
// - dW/db: one product per layer over the (slot, row) axis, stages
//   descending, rows ascending, db as a row of ones against the
//   covectors: no per-block partials and no second pass. K4 applies Adam
//   in that product's epilogue, K3 and K12 write the flat gradient; K4's
//   and K12's loss is summed per row, then over the rows in a fixed order.
// - The phases come from one generator (next_phase, by the launch's
//   GridKind), so each kernel holds one copy of the tile loop. It runs on
//   the host too: pnode_ark_grid_phases lists its products, which
//   chip_smoke.py holds against ops/fused_ark_adjoint.py's grid_phases,
//   the mirror whose reads and writes the tests check phase by phase.
//
// Bound on the H100 (fp32 FMA peak, 67 TFLOP/s at 700 W): ~8.0 GFLOP per
// K3 call at Burgers (the recompute at M 800, 4 x 5 backprop products,
// 4 stiff products, the dW products over 800 rows), ~0.12 ms; ~10.6 GFLOP
// per K4 iteration (a forward in place of the recompute), ~0.16 ms, and
// per K12 call; ~2.95 GFLOP per K2 call (the forward alone), ~0.044 ms. The
// FMA loop issues 8 FMAs and 2 shared loads per position, so the products
// run at most ~80% of that, and the M = 200 products fill 112-126 of the
// 132 SMs with one tile group each; each barrier costs a few
// microseconds, ~29 per K3 call, ~47 per K4 iteration or K12 call and 23
// per K2 call.
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "ark_tiles.cuh"

namespace pnode {
namespace ark {

namespace cg = cooperative_groups;

constexpr int kGThreads = 128;  // threads of a tile group
constexpr int kGGroups = 2;     // tile groups per block, one block per SM
constexpr int kGBlockThreads = kGGroups * kGThreads;
constexpr int kGTile = 32;        // output tile: kGTile x kGTile
constexpr int kGChunk = 64;       // reduction positions per staged chunk
constexpr int kGLd = kGTile + 4;  // row stride of a staged chunk
constexpr int kGPer = kGChunk * kGTile / kGThreads;  // a thread's elements
constexpr int kGBuf = 4 * kGChunk * kGLd;  // a group's two (A, B) buffers
// each group's buffers, then 32 floats for block sums
constexpr int kGSmemFloats = kGGroups * kGBuf + 32;

// The launches that run the grid form: K3's step (the staged stage values,
// the recompute, the reverse, dW/db), K4's loop (per iteration the forward,
// the MSE seed, the reverse, dW/db with Adam), K12's gradient step (K4's
// iteration with the flat gradient and the loss in place of Adam) and K2's
// forward step (the forward alone: y1, err and the stage values out).
enum GridKind { kGridStep = 0, kGridLoop = 1, kGridGrad = 2, kGridFwd = 3 };
constexpr int kGridKinds = 4;

// K2 and K12 take the grid form where K3's and K4's plans do (inv and J
// not resident) only from this state width up: their row form streams
// inv or J (d x d) through every block's ring each stage, and below ~d
// 280 that stream costs less than the grid form's 11-47 phases (an H100,
// B 37: K2 at d 200 84 us in the row form against 160 in the grid form,
// at d 384 214 against 142; K12 217 / 337 and 531 / 302; PERF.md).
constexpr int kGridMinD = 280;

__host__ __device__ inline long long round4ll(long long v) {
  return (v + 3) & ~3LL;
}

// The grid form's launch (one block per SM) and device workspace; offsets
// in floats, each region 16-byte aligned, -1 where the kind has none. h_l,
// g_l and the stage values hold stage i in slot s - 1 - i (K2: slot i).
struct GridPlan {
  int kind;
  int grid;
  size_t smem;                // bytes of dynamic shared memory per block
  long long ws;               // workspace floats
  long long o_h[kMaxLayers];  // h_l, l >= 1: (s, B, dims[l])
  long long o_g[kMaxLayers];  // g_l: (s, B, dims[l + 1]); g_{n-1} the seeds
  long long o_xi, o_u, o_q;   // (s, B, d) each
  long long o_pv;             // (B, d)
  long long o_ys;             // (s, B, d): the stage values, h_0 (not K2's)
  // K4, K12 and K2: kI and kE (s, B, d), G (B, d); K4 and K12: the seed
  // lam and y1 - tgt (B, d), the per-row losses (B)
  long long o_kI, o_kE, o_G, o_lam, o_diff, o_lrow;
};

// Host: the grid form of `kind` for (B, d), s stages and the stack
// dims[0..n_layers] on `sms` SMs (mirrored by ops/fused_ark_adjoint.py's
// grid_plan).
static inline void plan_grid(int kind, int B, int d, int s, int n_layers,
                             const int* dims, int sms, GridPlan* p) {
  *p = GridPlan{};
  p->kind = kind;
  p->grid = sms;
  p->smem = sizeof(float) * kGSmemFloats;
  const long long sb = (long long)s * B, bd = (long long)B * d;
  long long off = 0;
  auto take = [&off](long long n) {
    const long long o = off;
    off += round4ll(n);
    return o;
  };
  for (int l = 0; l < kMaxLayers; ++l) p->o_h[l] = p->o_g[l] = -1;
  p->o_xi = p->o_u = p->o_q = p->o_pv = p->o_ys = -1;
  p->o_kI = p->o_kE = p->o_G = p->o_lam = p->o_diff = p->o_lrow = -1;
  for (int l = 1; l < n_layers; ++l) p->o_h[l] = take(sb * dims[l]);
  if (kind != kGridFwd) {  // the reverse's
    for (int l = 0; l < n_layers; ++l) p->o_g[l] = take(sb * dims[l + 1]);
    p->o_xi = take(sb * d);
    p->o_u = take(sb * d);
    p->o_q = take(sb * d);
    p->o_pv = take(bd);
    p->o_ys = take(sb * d);
  }
  if (kind != kGridStep) {  // the forward's
    p->o_kI = take(sb * d);
    p->o_kE = take(sb * d);
    p->o_G = take(bd);
  }
  if (kind == kGridLoop || kind == kGridGrad) {  // the MSE's
    p->o_lam = take(bd);
    p->o_diff = take(bd);
    p->o_lrow = take(B);
  }
  p->ws = off;
}

// What the grid body reads and writes. K3: lam and ys_in its inputs,
// lam_prev and grads its outputs. K4: lam, kI, kE, G, diff, lrow in the
// workspace; W and b views of `params`, which Adam updates in place. K12:
// K4's workspace, grads and losses (the loss) its outputs. K2: kI, kE and
// G in the workspace, h[0] the caller's ys, y1 and err its outputs.
struct GridArgs {
  int kind;  // GridKind
  Mlp m;
  Tableau tb;
  const float* J;
  const float* inv;
  int B, s;
  float sign;
  unsigned umask, emask;  // reach_masks
  const float* lam;       // (B, d) the covector (K4: the MSE seed)
  const float* ys_in;     // K3's stage values (s, B, d), stage order
  float* lam_prev;        // K3
  float* grads;           // K3, K12: [W0, b0, W1, b1, ...]
  float* h[kMaxLayers];   // h[0]: the stage values, in slots
  float* g[kMaxLayers];
  float* xi;
  float* u;
  float* q;
  float* pv;
  // K4
  float* kI;
  float* kE;
  float* Gb;
  float* lam_w;  // = lam, written by the forward's last epilogue
  float* diff;
  float* lrow;
  float* params;
  float* m_state;
  float* v_state;
  float* losses;  // K4: one an iteration; K12: the loss
  float* y1;      // K2
  float* err;     // K2, or null
  Adam adam;
  float inv_count, two_inv_count;
};

// Host: a's kind and its workspace regions in ws at plan p (null where the
// kind has none; K2's h[0] is the caller's).
static inline void grid_regions(const GridPlan& p, float* ws, int n_layers,
                                GridArgs* a) {
  auto at = [ws](long long o) { return o >= 0 ? ws + o : nullptr; };
  a->kind = p.kind;
  a->h[0] = at(p.o_ys);
  for (int l = 1; l < n_layers; ++l) a->h[l] = at(p.o_h[l]);
  for (int l = 0; l < n_layers; ++l) a->g[l] = at(p.o_g[l]);
  a->xi = at(p.o_xi);
  a->u = at(p.o_u);
  a->q = at(p.o_q);
  a->pv = at(p.o_pv);
  a->kI = at(p.o_kI);
  a->kE = at(p.o_kE);
  a->Gb = at(p.o_G);
  a->lam_w = at(p.o_lam);
  a->diff = at(p.o_diff);
  a->lrow = at(p.o_lrow);
  if (a->lam_w != nullptr) a->lam = a->lam_w;
}

// One training iteration's operands (K4, K12; K2: y alone).
struct Iter {
  const float* y;    // (B, d)
  const float* tgt;  // (B, d)
  float c1, c2;      // Adam's bias corrections at this update
  int k;             // the iteration
};

__host__ __device__ __forceinline__ bool reached_u(const GridArgs& a, int i) {
  return (a.umask >> i) & 1u;
}
__host__ __device__ __forceinline__ bool reached_e(const GridArgs& a, int i) {
  return (a.emask >> i) & 1u;
}
__host__ __device__ __forceinline__ bool reached(const GridArgs& a, int i) {
  return ((a.umask | a.emask) >> i) & 1u;
}
// The first stage the reverse reaches (the highest), or -1.
__host__ __device__ __forceinline__ int first_reached(const GridArgs& a) {
  int i = 31;
  while (i >= 0 && !reached(a, i)) --i;
  return i;
}
// Stage i's slot in h_l, g_l and the stage values: descending, the order
// the dW/db products sum them in; K2's ascending, the caller's ys.
__host__ __device__ __forceinline__ size_t slot_of(const GridArgs& a, int i) {
  return (size_t)(a.kind == kGridFwd ? i : a.s - 1 - i);
}

// -- epilogues ---------------------------------------------------------------------

// Epilogues: what a product's output values become.
enum GridEpi {
  kEpiAct,        // out = act(v + b_l)                   (h_{l+1})
  kEpiBackprop,   // out = v act'(h_l)                    (g_{l-1})
  kEpiPv,         // pv = v                               (u_i J)
  kEpiStageEnd,   // p_i = (pv +) v; then q_i, or xi_i = p_i
  kEpiXi,         // xi_i = v (- c_i)
  kEpiGrad,       // dW/db element (K3's and K12's grads)
  kEpiAdam,       // dW/db element, Adam's update (K4)
  kEpiFwdStiff,   // Y_i and kI_i (the forward: K4, K12, K2)
  kEpiFwdKE,      // kE_i; then G_{i+1}, or y1 and the seed and covectors
                  // (K2: y1 and err)
};

// u_i, and the seed g_{n-1} = sign uh_i where stage i reaches the MLP, at
// the N elements e (ok bit j: e[j] lies in the product; the others are
// loaded, not stored): the lam term, then m ascending over the reached
// stages (xi_m from the workspace, stage `cur`'s from xc); an implicit
// stage without an MLP term takes q_i = c_i = u_i / (dt aI_ii) here.
template <int N>
__device__ __forceinline__ void covectors(const GridArgs& a, int i,
                                          const size_t (&e)[N],
                                          const float (&lamv)[N],
                                          unsigned ok, int cur,
                                          const float (&xc)[N]) {
  const Tableau& tb = a.tb;
  const size_t bd = (size_t)a.B * a.m.dims[0];
  float au[N], auh[N];
#pragma unroll
  for (int j = 0; j < N; ++j) {
    au[j] = auh[j] = 0.0f;
    if (tb.nzbI[i]) au[j] = tb.cbI[i] * lamv[j];
    if (tb.nzbE[i]) auh[j] = tb.cbE[i] * lamv[j];
  }
  for (int mm = i + 1; mm < a.s; ++mm) {
    if (!reached(a, mm)) continue;
    float x[N];
#pragma unroll
    for (int j = 0; j < N; ++j)
      x[j] = mm == cur ? xc[j] : __ldcg(a.xi + mm * bd + e[j]);
#pragma unroll
    for (int j = 0; j < N; ++j) {
      if (tb.nzI[mm][i]) au[j] = au[j] + tb.cI[mm][i] * x[j];
      if (tb.nzE[mm][i]) auh[j] = auh[j] + tb.cE[mm][i] * x[j];
    }
  }
  const bool seed = reached_e(a, i);
  const bool qc = tb.nzI[i][i] && reached_u(a, i) && !seed;
  float* gs = a.g[a.m.n - 1] + slot_of(a, i) * bd;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    if (!((ok >> j) & 1u)) continue;
    a.u[i * bd + e[j]] = au[j];
    if (seed) gs[e[j]] = a.sign * auh[j];
    if (qc) a.q[i * bd + e[j]] = au[j] * tb.inv_dt[i];
  }
}

// xi_i at the elements e is x: store it, then the next reached stage's
// covectors, or (K3, after the last) lam_prev = lam + xi_{s-1} + ... in
// the stages' order.
template <int N>
__device__ __forceinline__ void xi_done(const GridArgs& a, int i,
                                        const size_t (&e)[N], unsigned ok,
                                        const float (&x)[N]) {
  const size_t bd = (size_t)a.B * a.m.dims[0];
  float lamv[N];
#pragma unroll
  for (int j = 0; j < N; ++j) {
    lamv[j] = __ldcg(a.lam + e[j]);
    if ((ok >> j) & 1u) a.xi[i * bd + e[j]] = x[j];
  }
  int nx = i - 1;
  while (nx >= 0 && !reached(a, nx)) --nx;
  if (nx >= 0) {
    covectors<N>(a, nx, e, lamv, ok, i, x);
  } else if (a.lam_prev != nullptr) {
    float lp[N];
#pragma unroll
    for (int j = 0; j < N; ++j) lp[j] = lamv[j];
    for (int st = a.s - 1; st >= 0; --st) {
      if (!reached(a, st)) continue;
      float xs[N];
#pragma unroll
      for (int j = 0; j < N; ++j)
        xs[j] = st == i ? x[j] : __ldcg(a.xi + st * bd + e[j]);
#pragma unroll
      for (int j = 0; j < N; ++j) lp[j] = lp[j] + xs[j];
    }
#pragma unroll
    for (int j = 0; j < N; ++j)
      if ((ok >> j) & 1u) a.lam_prev[e[j]] = lp[j];
  }
}

// out(m, n) = epi(sum_k A(m, k) B(k, n)), m < M, n < N, k < K. An operand
// is k-major (the reduction index picks its row: A(m, k) = a[k lda + m],
// B(k, n) = b[k ldb + n]) or not (A(m, k) = a[m lda + k], B(k, n) =
// b[n ldb + k]).
struct Gemm {
  const float* a;
  const float* b;
  int lda, ldb, a_kmajor, b_kmajor;
  int M, N, K;
  int G, v;      // reduction groups: blocks of v positions dealt round-robin
  int ones_row;  // A's row m that reads 1 (dW's db row), else -1
  int epi, stage, layer;
  float* out;
  int ldo;
  const float* aux;  // kEpiBackprop's h_l
};

// The epilogue of a thread's 8 outputs v (rows m0 + o / 4, columns n0 + o
// % 4): their operands are loaded first (at clamped indices, so every load
// is in range), then the outputs in the product are stored.
__device__ __forceinline__ void tile_epilogue(const Gemm& gm,
                                              const GridArgs& a,
                                              const Iter& it, int m0, int n0,
                                              const float (&v)[8]) {
  const Tableau& tb = a.tb;
  const int i = gm.stage;
  const size_t bd = (size_t)a.B * a.m.dims[0];
  size_t e[8];
  int nc[8];
  unsigned ok = 0;
#pragma unroll
  for (int o = 0; o < 8; ++o) {
    const int m = m0 + o / 4, n = n0 + o % 4;
    ok |= (unsigned)(m < gm.M && n < gm.N) << o;
    nc[o] = min(n, gm.N - 1);
    e[o] = (size_t)min(m, gm.M - 1) * gm.ldo + nc[o];
  }
  auto store = [&](float* p, const float (&w)[8]) {
#pragma unroll
    for (int o = 0; o < 8; ++o)
      if ((ok >> o) & 1u) p[e[o]] = w[o];
  };
  float w[8], t[8];
  switch (gm.epi) {
    case kEpiAct: {
      const float* b = a.m.b[gm.layer];
#pragma unroll
      for (int o = 0; o < 8; ++o) t[o] = __ldcg(b + nc[o]);
#pragma unroll
      for (int o = 0; o < 8; ++o) w[o] = act_fwd(v[o] + t[o], a.m.act);
      store(gm.out, w);
      return;
    }
    case kEpiBackprop: {
#pragma unroll
      for (int o = 0; o < 8; ++o) t[o] = __ldcg(gm.aux + e[o]);
#pragma unroll
      for (int o = 0; o < 8; ++o) w[o] = v[o] * act_grad(t[o], a.m.act);
      store(gm.out, w);
      return;
    }
    case kEpiPv:
      store(a.pv, v);
      return;
    case kEpiStageEnd: {
      const bool hu = reached_u(a, i), impl = tb.nzI[i][i];
      const bool add = reached_e(a, i) && hu && !impl;
#pragma unroll
      for (int o = 0; o < 8; ++o) w[o] = add ? __ldcg(a.pv + e[o]) + v[o] : v[o];
      if (!impl) {
        xi_done<8>(a, i, e, ok, w);
        return;
      }
      if (hu) {
#pragma unroll
        for (int o = 0; o < 8; ++o) t[o] = __ldcg(a.u + i * bd + e[o]);
        // c rounded on its own, as the row form stores it (no FMA)
#pragma unroll
        for (int o = 0; o < 8; ++o)
          w[o] = __fmul_rn(t[o], tb.inv_dt[i]) + w[o];
      }
      store(a.q + i * bd, w);
      return;
    }
    case kEpiXi: {
#pragma unroll
      for (int o = 0; o < 8; ++o) w[o] = v[o];
      if (reached_u(a, i)) {
#pragma unroll
        for (int o = 0; o < 8; ++o) t[o] = __ldcg(a.u + i * bd + e[o]);
#pragma unroll
        for (int o = 0; o < 8; ++o)
          w[o] = w[o] - __fmul_rn(t[o], tb.inv_dt[i]);
      }
      xi_done<8>(a, i, e, ok, w);
      return;
    }
    case kEpiGrad:
      store(a.grads + a.m.woff[gm.layer], v);
      return;
    case kEpiAdam: {
      const size_t base = a.m.woff[gm.layer];
      float mo[8], vo[8];
#pragma unroll
      for (int o = 0; o < 8; ++o) {
        mo[o] = __ldcg(a.m_state + base + e[o]);
        vo[o] = __ldcg(a.v_state + base + e[o]);
        t[o] = __ldcg(a.params + base + e[o]);
      }
#pragma unroll
      for (int o = 0; o < 8; ++o) {
        if (!((ok >> o) & 1u)) continue;
        adam_step(a.adam, it.c1, it.c2, v[o], mo[o], vo[o], t[o]);
        a.m_state[base + e[o]] = mo[o];
        a.v_state[base + e[o]] = vo[o];
        a.params[base + e[o]] = t[o];
      }
      return;
    }
    case kEpiFwdStiff: {
#pragma unroll
      for (int o = 0; o < 8; ++o) t[o] = __ldcg(gm.a + e[o]);  // G_i
      float* ys = a.h[0] + slot_of(a, i) * bd;
      if (tb.nzI[i][i]) {
#pragma unroll
        for (int o = 0; o < 8; ++o) w[o] = (v[o] - t[o]) * tb.inv_dt[i];
        store(ys, v);
        store(a.kI + i * bd, w);
      } else {
        store(a.kI + i * bd, v);
        store(ys, t);
      }
      return;
    }
    case kEpiFwdKE: {
      const float* b = a.m.b[a.m.n - 1];
#pragma unroll
      for (int o = 0; o < 8; ++o) {
        t[o] = __ldcg(b + nc[o]);
        w[o] = __ldcg(it.y + e[o]);  // the sums start from y
      }
      float ke[8];
#pragma unroll
      for (int o = 0; o < 8; ++o) {
        ke[o] = v[o] + t[o];
        ke[o] = a.sign == 1.0f ? ke[o] : a.sign * ke[o];
      }
      store(a.kE + i * bd, ke);
      const bool last = i + 1 == a.s;
      // K2's err: from 0 with the weight differences, as y1
      const bool with_err = last && a.err != nullptr;
      float ea[8];
#pragma unroll
      for (int o = 0; o < 8; ++o) ea[o] = 0.0f;
      // G_{i+1} = y + sum_{j<=i} (dt aI kI_j + dt aE kE_j), or y1 with the
      // weights b, j ascending, implicit term first
      for (int j = 0; j <= i; ++j) {
        float kIj[8], kEj[8];
#pragma unroll
        for (int o = 0; o < 8; ++o) {
          kIj[o] = __ldcg(a.kI + j * bd + e[o]);
          kEj[o] = j == i ? ke[o] : __ldcg(a.kE + j * bd + e[o]);
        }
        const bool zI = last ? tb.nzbI[j] : tb.nzI[i + 1][j];
        const bool zE = last ? tb.nzbE[j] : tb.nzE[i + 1][j];
        const float cI = last ? tb.cbI[j] : tb.cI[i + 1][j];
        const float cE = last ? tb.cbE[j] : tb.cE[i + 1][j];
#pragma unroll
        for (int o = 0; o < 8; ++o) {
          if (zI) w[o] = w[o] + cI * kIj[o];
          if (zE) w[o] = w[o] + cE * kEj[o];
        }
        if (with_err) {
#pragma unroll
          for (int o = 0; o < 8; ++o) {
            if (tb.nzerrI[j]) ea[o] = ea[o] + tb.cerrI[j] * kIj[o];
            if (tb.nzerrE[j]) ea[o] = ea[o] + tb.cerrE[j] * kEj[o];
          }
        }
      }
      if (!last) {
        store(a.Gb, w);
        return;
      }
      if (a.kind == kGridFwd) {  // K2: y1 and err out
        store(a.y1, w);
        if (with_err) store(a.err, ea);
        return;
      }
      // y1 - tgt, the seed, then the first reached stage's covectors
#pragma unroll
      for (int o = 0; o < 8; ++o) w[o] = w[o] - __ldcg(it.tgt + e[o]);
      store(a.diff, w);
#pragma unroll
      for (int o = 0; o < 8; ++o) t[o] = a.two_inv_count * w[o];
      store(a.lam_w, t);
      const int first = first_reached(a);
      if (first >= 0) covectors<8>(a, first, e, t, ok, -1, t);
      return;
    }
  }
}

// -- the tiled product --------------------------------------------------------

// A staged chunk: positions q0 .. q0 + kGChunk - 1 (those < len) of group g.
struct Chunk {
  int g, q0, len;
};

__device__ __forceinline__ int group_len(int g, int K, int G, int v) {
  const int nb = (K + v - 1) / v;
  return g < nb ? (nb - g + G - 1) / G * v : 0;
}

__device__ __forceinline__ Chunk next_chunk(Chunk c, const Gemm& gm) {
  c.q0 += kGChunk;
  while (c.g < gm.G && c.q0 >= c.len) {
    ++c.g;
    c.q0 = 0;
    c.len = c.g < gm.G ? group_len(c.g, gm.K, gm.G, gm.v) : 0;
  }
  return c;
}

// Reduction index of position q of group g (v 1 or 4).
__device__ __forceinline__ int red_index(const Gemm& gm, int g, int q) {
  return gm.v == 1 ? g + gm.G * q : 4 * (g + gm.G * (q >> 2)) + (q & 3);
}

// Loads through L2 that stay where they are written (volatile): ahead of
// the FMAs they overlap.
__device__ __forceinline__ float ld_cg(const float* p) {
  float v;
  asm volatile("ld.global.cg.f32 %0, [%1];" : "=f"(v) : "l"(p));
  return v;
}

__device__ __forceinline__ float4 ld_cg4(const float* p) {
  float4 v;
  asm volatile("ld.global.cg.v4.f32 {%0, %1, %2, %3}, [%4];"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "l"(p));
  return v;
}

// One operand of a tile, as this thread loads it, in one of two forms.
// 16-byte (vec: the rows 16-byte aligned, the reduction in runs of 4
// where it is contiguous): k-major, a warp reads 4 positions' 128-byte
// rows, the thread columns 4 (tid % 8) .. + 3 at positions tid / 8 + 16 i;
// otherwise a warp reads 64 bytes of 8 rows, the thread rows tid % 8 + 8 i
// at positions 4 (tid / 8) .. + 3. 4-byte: k-major, a warp reads a
// 128-byte row per position, the thread column tid % 32 at positions warp
// + 4 i; otherwise 32 bytes of 4 rows, the thread rows 4 j + lane / 8 at
// positions 8 (warp + 4 h) + lane % 8. Indices are clamped into the
// operand (off: the thread's column, or its rows' offsets); okx bit j:
// column or row j lies in it; ones: the column that reads 1.
struct TileOp {
  const float* p;
  int ld, kmajor, vec;
  int off[8];
  unsigned okx;
  int ones;
};

__device__ __forceinline__ TileOp tile_op(const float* p, int ld, int kmajor,
                                          int x0, int X, int ones,
                                          const Gemm& gm) {
  const int tg = threadIdx.x % kGThreads;  // thread of the tile group
  TileOp t;
  t.p = p;
  t.ld = ld;
  t.kmajor = kmajor;
  t.okx = 0;
  t.ones = ones;
  const int lane = threadIdx.x % 32;
  const int Xmem = ones >= 0 ? X - 1 : X;  // rows or columns in memory
  const bool aligned = ((uintptr_t)p & 15) == 0 && ld % 4 == 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) t.off[j] = 0;
  if (kmajor) {
    t.vec = aligned && Xmem % 4 == 0;
    const int xx = x0 + (t.vec ? 4 * (tg % 8) : lane);
    t.okx = xx < X;
    t.off[0] = min(xx, t.vec ? Xmem - 4 : Xmem - 1);
  } else {
    t.vec = aligned && (gm.v == 4 || (gm.G == 1 && gm.K % 4 == 0));
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int xx = x0 + (t.vec ? tg % 8 + 8 * j
                                 : 4 * j + lane / 8);
      t.okx |= (unsigned)(xx < X && (t.vec ? j < 4 : true)) << j;
      t.off[j] = min(xx, Xmem - 1) * ld;
    }
  }
  return t;
}

// This thread's kGPer elements of chunk c of operand t (see TileOp), zero
// past the chunk's positions and past the operand.
__device__ __forceinline__ void load_chunk(float (&r)[kGPer], const TileOp& t,
                                           const Chunk& c, const Gemm& gm) {
  const int tg = threadIdx.x % kGThreads;  // thread of the tile group
  const int lane = threadIdx.x % 32, warp = (tg / 32);
  if (t.vec && t.kmajor) {
#pragma unroll
    for (int i = 0; i < kGPer / 4; ++i) {
      const int q = c.q0 + tg / 8 + 16 * i;
      const bool ok = q < c.len;
      const int k = ok ? red_index(gm, c.g, q) : 0;
      const float4 v = ld_cg4(t.p + (size_t)k * t.ld + t.off[0]);
      const bool in = ok && t.okx;
      r[4 * i] = in ? v.x : 0.0f;
      r[4 * i + 1] = in ? v.y : 0.0f;
      r[4 * i + 2] = in ? v.z : 0.0f;
      r[4 * i + 3] = in ? v.w : 0.0f;
    }
  } else if (t.vec) {
    const int q = c.q0 + 4 * (tg / 8);
    const bool ok = q < c.len;
    const int k = ok ? red_index(gm, c.g, q) : 0;
#pragma unroll
    for (int j = 0; j < kGPer / 4; ++j) {
      const float4 v = ld_cg4(t.p + (size_t)t.off[j] + k);
      const bool in = ok && ((t.okx >> j) & 1u);
      r[4 * j] = in ? v.x : 0.0f;
      r[4 * j + 1] = in ? v.y : 0.0f;
      r[4 * j + 2] = in ? v.z : 0.0f;
      r[4 * j + 3] = in ? v.w : 0.0f;
    }
  } else if (t.kmajor) {
#pragma unroll
    for (int i = 0; i < kGPer; ++i) {
      const int q = c.q0 + warp + 4 * i;
      const bool ok = q < c.len;
      const int k = ok ? red_index(gm, c.g, q) : 0;
      r[i] = ok && t.okx ? ld_cg(t.p + (size_t)k * t.ld + t.off[0]) : 0.0f;
    }
  } else {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int q = c.q0 + 8 * (warp + 4 * h) + lane % 8;
      const bool ok = q < c.len;
      const int k = ok ? red_index(gm, c.g, q) : 0;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float v = ld_cg(t.p + (size_t)t.off[j] + k);
        r[2 * j + h] = ok && ((t.okx >> j) & 1u) ? v : 0.0f;
      }
    }
  }
}

// Store this thread's elements of a chunk at their places (rows kGLd
// floats apart; the ones column of a k-major operand set here).
__device__ __forceinline__ void store_chunk(const float (&r)[kGPer],
                                            float* dst, const TileOp& t,
                                            int x0, int q0, int len) {
  const int tg = threadIdx.x % kGThreads;  // thread of the tile group
  const int lane = threadIdx.x % 32, warp = (tg / 32);
  if (t.vec && t.kmajor) {
    const int x = 4 * (tg % 8);
#pragma unroll
    for (int i = 0; i < kGPer / 4; ++i) {
      const int pos = tg / 8 + 16 * i;
      float4 v = make_float4(r[4 * i], r[4 * i + 1], r[4 * i + 2],
                             r[4 * i + 3]);
      if (t.ones >= 0 && x0 + x <= t.ones && t.ones < x0 + x + 4 &&
          q0 + pos < len) {
        const int cc = t.ones - x0 - x;
        v = make_float4(cc == 0 ? 1.0f : 0.0f, cc == 1 ? 1.0f : 0.0f,
                        cc == 2 ? 1.0f : 0.0f, cc == 3 ? 1.0f : 0.0f);
      }
      *reinterpret_cast<float4*>(dst + pos * kGLd + x) = v;
    }
  } else if (t.vec) {
    const int pos = 4 * (tg / 8);
#pragma unroll
    for (int j = 0; j < kGPer / 4; ++j)
#pragma unroll
      for (int cc = 0; cc < 4; ++cc)
        dst[(pos + cc) * kGLd + tg % 8 + 8 * j] = r[4 * j + cc];
  } else if (t.kmajor) {
#pragma unroll
    for (int i = 0; i < kGPer; ++i) {
      const int pos = warp + 4 * i;
      dst[pos * kGLd + lane] =
          x0 + lane == t.ones && q0 + pos < len ? 1.0f : r[i];
    }
  } else {
#pragma unroll
    for (int i = 0; i < kGPer; ++i)
      dst[(8 * (warp + 4 * (i % 2)) + lane % 8) * kGLd + 4 * (i / 2) +
          lane / 8] = r[i];
  }
}

// The barrier of this thread's tile group (named barrier 1 + group).
__device__ __forceinline__ void group_sync() {
  asm volatile("bar.sync %0, %1;" ::"r"(1 + (int)(threadIdx.x / kGThreads)),
               "n"(kGThreads)
               : "memory");
}

// One 32 x 32 output tile of gm (tile: row-major over the tile grid), by
// this thread's tile group, its epilogue applied. Ends with a barrier of
// the group.
__device__ __forceinline__ void gemm_tile(const Gemm& gm, int tile,
                                          const GridArgs& a, const Iter& it,
                                          float* smem) {
  const int tg = threadIdx.x % kGThreads;  // thread of the tile group
  mark(kMarkGTile);
  const int ntn = (gm.N + kGTile - 1) / kGTile;
  const int m0 = tile / ntn * kGTile, n0 = tile % ntn * kGTile;
  const int ty = tg / 8, tx = tg % 8;
  constexpr int kBuf = 2 * kGChunk * kGLd;  // one (A, B) buffer
  smem += (threadIdx.x / kGThreads) * kGBuf;  // the group's buffers
  const TileOp ta =
      tile_op(gm.a, gm.lda, gm.a_kmajor, m0, gm.M, gm.ones_row, gm);
  const TileOp tb = tile_op(gm.b, gm.ldb, gm.b_kmajor, n0, gm.N, -1, gm);
  float acc[8], tot[8];
#pragma unroll
  for (int o = 0; o < 8; ++o) acc[o] = tot[o] = 0.0f;
  bool started = false;
  Chunk c{0, 0, group_len(0, gm.K, gm.G, gm.v)};
  float ra[kGPer], rb[kGPer];
  load_chunk(ra, ta, c, gm);
  load_chunk(rb, tb, c, gm);
  store_chunk(ra, smem, ta, m0, c.q0, c.len);
  store_chunk(rb, smem + kGChunk * kGLd, tb, n0, c.q0, c.len);
  group_sync();
  int buf = 0;
  for (;;) {
    const Chunk nx = next_chunk(c, gm);
    const bool more = nx.g < gm.G;
    if (more) {
      load_chunk(ra, ta, nx, gm);
      load_chunk(rb, tb, nx, gm);
    }
    const float* As = smem + buf * kBuf;
    const float* Bs = As + kGChunk * kGLd;
#pragma unroll
    for (int pos = 0; pos < kGChunk; ++pos) {
      const float2 x = *reinterpret_cast<const float2*>(As + pos * kGLd +
                                                        2 * ty);
      const float4 w = *reinterpret_cast<const float4*>(Bs + pos * kGLd +
                                                        4 * tx);
      acc[0] = fmaf(x.x, w.x, acc[0]);
      acc[1] = fmaf(x.x, w.y, acc[1]);
      acc[2] = fmaf(x.x, w.z, acc[2]);
      acc[3] = fmaf(x.x, w.w, acc[3]);
      acc[4] = fmaf(x.y, w.x, acc[4]);
      acc[5] = fmaf(x.y, w.y, acc[5]);
      acc[6] = fmaf(x.y, w.z, acc[6]);
      acc[7] = fmaf(x.y, w.w, acc[7]);
    }
    if (more) {
      store_chunk(ra, smem + (buf ^ 1) * kBuf, ta, m0, nx.q0, nx.len);
      store_chunk(rb, smem + (buf ^ 1) * kBuf + kGChunk * kGLd, tb, n0,
                  nx.q0, nx.len);
    }
    group_sync();
    if (!more) break;
    if (nx.g != c.g) {  // a group's chain is done: sum it in group order
#pragma unroll
      for (int o = 0; o < 8; ++o) {
        tot[o] = started ? tot[o] + acc[o] : acc[o];
        acc[o] = 0.0f;
      }
      started = true;
    }
    c = nx;
    buf ^= 1;
  }
#pragma unroll
  for (int o = 0; o < 8; ++o) tot[o] = started ? tot[o] + acc[o] : acc[o];
  mark(kMarkGEpi);
  tile_epilogue(gm, a, it, m0 + 2 * ty, n0 + 4 * tx, tot);
  mark(kMarkGTileDone);
}

__device__ __forceinline__ int gemm_tiles(const Gemm& gm) {
  return ((gm.M + kGTile - 1) / kGTile) * ((gm.N + kGTile - 1) / kGTile);
}

// -- the products ---------------------------------------------------------------

// Layer l's forward on M rows: in (M, dims[l]) -> out, the row form's
// split of k (split_k).
__host__ __device__ __forceinline__ Gemm mlp_gemm(const GridArgs& a, int l,
                                         const float* in, int M, float* out,
                                         int epi, int stage) {
  const int K = a.m.dims[l], N = a.m.dims[l + 1];
  Gemm gm{};
  gm.a = in;
  gm.lda = K;
  gm.b = a.m.W[l];
  gm.ldb = N;
  gm.b_kmajor = 1;
  gm.M = M;
  gm.N = N;
  gm.K = K;
  gm.G = split_k(K, N);
  gm.v = 1;
  gm.ones_row = -1;
  gm.epi = epi;
  gm.stage = stage;
  gm.layer = l;
  gm.out = out;
  gm.ldo = N;
  return gm;
}

// Layer l's backprop of stage i: g_l W_l^T, then act'(h_l) into g_{l-1}
// (l > 0) or the stage's end (l = 0: dyE), the row form's split of n
// (blocks of 4 where the width allows).
__host__ __device__ __forceinline__ Gemm backprop_gemm(const GridArgs& a, int l,
                                              int i) {
  const int K = a.m.dims[l], N = a.m.dims[l + 1];
  const size_t sb = slot_of(a, i) * a.B;
  Gemm gm{};
  gm.a = a.g[l] + sb * N;
  gm.lda = N;
  gm.b = a.m.W[l];
  gm.ldb = N;
  gm.M = a.B;
  gm.N = K;
  gm.K = N;
  gm.G = split_k(N, K);
  gm.v = N % 4 == 0 ? 4 : 1;
  gm.ones_row = -1;
  gm.epi = l > 0 ? kEpiBackprop : kEpiStageEnd;
  gm.stage = i;
  gm.layer = l;
  gm.out = l > 0 ? a.g[l - 1] + sb * K : nullptr;
  gm.ldo = K;
  gm.aux = l > 0 ? a.h[l] + sb * K : nullptr;
  return gm;
}

// The step's stiff products on the (B, d) operand `in` of stage i: the
// forward's in op^T (op = inv on an implicit stage, else J), or the
// reverse's in op (u_i J, q_i inv).
__host__ __device__ __forceinline__ Gemm stiff_gemm(const GridArgs& a, const float* in,
                                           const float* op, bool transposed,
                                           int epi, int i) {
  const int d = a.m.dims[0];
  Gemm gm{};
  gm.a = in;
  gm.lda = d;
  gm.b = op;
  gm.ldb = d;
  gm.b_kmajor = !transposed;
  gm.M = a.B;
  gm.N = d;
  gm.K = d;
  gm.G = 1;
  gm.v = 1;
  gm.ones_row = -1;
  gm.epi = epi;
  gm.stage = i;
  gm.ldo = d;
  return gm;
}

// Layer l's [dW; db] over every slot's rows (stages descending).
__host__ __device__ __forceinline__ Gemm grad_gemm(const GridArgs& a, int l, int epi) {
  const int K = a.m.dims[l], N = a.m.dims[l + 1];
  Gemm gm{};
  gm.a = a.h[l];
  gm.lda = K;
  gm.a_kmajor = 1;
  gm.b = a.g[l];
  gm.ldb = N;
  gm.b_kmajor = 1;
  gm.M = K + 1;
  gm.N = N;
  gm.K = a.s * a.B;
  gm.G = 1;
  gm.v = 1;
  gm.ones_row = K;
  gm.epi = epi;
  gm.layer = l;
  gm.ldo = N;
  return gm;
}

// -- the phases -------------------------------------------------------------------

// Per-block work a phase does before its tiles.
enum GridPre {
  kPreNone,
  kPreStage,  // K3: the stage values into their slots, the first reached
              // stage's covectors (or lam_prev = lam), zero covectors of the
              // stages that reach no MLP
  kPreLoss,   // K4: the previous iteration's loss (block 0)
  kPreRows,   // K4, K12: this block's rows of the loss
};

// The step's position in its phases: the forward of K4, K12 and K2 (stage
// i, layer l; -1: the stiff product), K3's staging and recompute (layer
// l), the reverse's stages (stage i, step l), the dW/db products.
enum GridSection { kSecFwd, kSecStage, kSecRec, kSecRev, kSecGrads, kSecDone };

struct Cursor {
  int sect, i, l;
};

// The next phase of the step of kind a.kind at cursor c, or false after
// the last: its products gs[0..*ng), its mark and its per-block work.
__host__ __device__ __forceinline__ bool next_phase(const GridArgs& a, const Iter& it,
                                           Cursor& c, Gemm (&gs)[kMaxLayers],
                                           int* ng, int* tag, int* pre) {
  const int n = a.m.n;
  const size_t bd = (size_t)a.B * a.m.dims[0];
  *ng = 0;
  *pre = kPreNone;
  for (;;) {
    switch (c.sect) {
      case kSecFwd: {
        if (c.i >= a.s) {  // K2 ends with its forward
          c = a.kind == kGridFwd ? Cursor{kSecDone, 0, 0}
                                 : Cursor{kSecRev, first_reached(a), 0};
          continue;
        }
        const int i = c.i;
        const bool impl = a.tb.nzI[i][i];
        const size_t sb = slot_of(a, i) * a.B;
        *tag = kMarkGForward;
        if (c.l < 0) {
          // the stiff product; an explicit stage's first layer takes G_i
          // (= Y_i) beside it unless it is the last: kE_i's epilogue reads
          // kI_i, which the stiff product's writes, and writes G_{i+1}
          // over the G_i both read, so it takes Y_i from its slot in a
          // phase of its own
          const float* Gin = i == 0 ? it.y : a.Gb;
          gs[(*ng)++] =
              stiff_gemm(a, Gin, impl ? a.inv : a.J, true, kEpiFwdStiff, i);
          const bool beside = !impl && n > 1;
          if (beside)
            gs[(*ng)++] = mlp_gemm(a, 0, Gin, a.B, a.h[1] + sb * a.m.dims[1],
                                   kEpiAct, i);
          if (i == 0 && it.k > 0 && a.kind == kGridLoop) *pre = kPreLoss;
          c.l = beside ? 1 : 0;
          return true;
        }
        if (c.l < n) {
          const int l = c.l++;
          const bool last = l == n - 1;
          gs[(*ng)++] = mlp_gemm(
              a, l, a.h[l] + sb * a.m.dims[l], a.B,
              last ? a.kE + i * bd : a.h[l + 1] + sb * a.m.dims[l + 1],
              last ? kEpiFwdKE : kEpiAct, i);
          return true;
        }
        c = Cursor{kSecFwd, i + 1, -1};
        continue;
      }
      case kSecStage:
        *tag = kMarkGRecompute;
        *pre = kPreStage;
        c = Cursor{kSecRec, 0, 0};
        return true;
      case kSecRec: {
        if (c.l >= n - 1) {
          c = Cursor{kSecRev, first_reached(a), 0};
          continue;
        }
        const int l = c.l++;
        *tag = kMarkGRecompute;
        gs[(*ng)++] = mlp_gemm(a, l, a.h[l], a.s * a.B, a.h[l + 1], kEpiAct,
                               0);
        return true;
      }
      case kSecRev: {
        const int i = c.i;
        if (i < 0) {
          c = Cursor{kSecGrads, 0, 0};
          continue;
        }
        const bool hu = reached_u(a, i), he = reached_e(a, i);
        const bool impl = a.tb.nzI[i][i];
        const bool pv = hu && !impl;
        const float* ui = a.u + i * bd;
        const int step = c.l++;
        if (step == 0) {  // u_i J before the one backprop that adds to it
          if (!(he && pv && n == 1)) continue;
          *tag = kMarkGStiff;
          gs[(*ng)++] = stiff_gemm(a, ui, a.J, false, kEpiPv, i);
          return true;
        }
        if (step <= n) {  // backprop of layer n - step
          if (!he) continue;
          const int l = n - step;
          *tag = kMarkGBackprop;
          gs[(*ng)++] = backprop_gemm(a, l, i);
          if (pv && n > 1 && l == n - 1)
            gs[(*ng)++] = stiff_gemm(a, ui, a.J, false, kEpiPv, i);
          return true;
        }
        if (step == n + 1) {  // an explicit stage's u J without an MLP term
          if (he || !pv) continue;
          *tag = kMarkGStiff;
          gs[(*ng)++] = stiff_gemm(a, ui, a.J, false, kEpiStageEnd, i);
          return true;
        }
        if (step == n + 2) {  // an implicit stage's solve
          if (!impl) continue;
          *tag = kMarkGStiff;
          gs[(*ng)++] = stiff_gemm(a, a.q + i * bd, a.inv, false, kEpiXi, i);
          return true;
        }
        int nx = i - 1;
        while (nx >= 0 && !reached(a, nx)) --nx;
        c = Cursor{kSecRev, nx, 0};
        continue;
      }
      case kSecGrads:
        *tag = kMarkGGrads;
        for (int l = 0; l < n; ++l)
          gs[(*ng)++] =
              grad_gemm(a, l, a.kind == kGridLoop ? kEpiAdam : kEpiGrad);
        if (a.kind != kGridStep) *pre = kPreRows;
        c = Cursor{kSecDone, 0, 0};
        return true;
      default:
        return false;
    }
  }
}

// K4, K12: the loss of iteration k, from the per-row losses lrow, summed
// over the rows in a fixed order (lane-strided, then a shuffle tree) by
// block 0's first warp.
__device__ __forceinline__ void grid_loss(const GridArgs& a, int k) {
  if (blockIdx.x != 0 || threadIdx.x >= 32) return;
  float l = 0.0f;
  for (int r = threadIdx.x; r < a.B; r += 32) l += __ldcg(a.lrow + r);
  for (int off = 16; off > 0; off >>= 1)
    l += __shfl_down_sync(0xffffffffu, l, off);
  if (threadIdx.x == 0) a.losses[k] = l * a.inv_count;
}

// Zero the covectors of the stages that reach no MLP: such a stage adds
// nothing to dW/db (K3 in its staging; K4 and K12 once, before their
// first phase's barrier).
__device__ __forceinline__ void zero_unreached(const GridArgs& a) {
  const int gtid = blockIdx.x * blockDim.x + threadIdx.x;
  const int nthreads = gridDim.x * blockDim.x;
  for (int i = 0; i < a.s; ++i) {
    if (reached_e(a, i)) continue;
    for (int l = 0; l < a.m.n; ++l) {
      const size_t w = (size_t)a.B * a.m.dims[l + 1];
      for (size_t e = gtid; e < w; e += nthreads)
        a.g[l][slot_of(a, i) * w + e] = 0.0f;
    }
  }
}

// A phase's per-block work before its tiles.
__device__ __forceinline__ void phase_pre(int pre, const GridArgs& a,
                                          const Iter& it, float* smem) {
  const int d = a.m.dims[0];
  const size_t bd = (size_t)a.B * d;
  const int gtid = blockIdx.x * blockDim.x + threadIdx.x;
  const int nthreads = gridDim.x * blockDim.x;
  switch (pre) {
    case kPreStage: {
      const int first = first_reached(a);
      for (size_t e = gtid; e < bd; e += nthreads) {
        for (int i = 0; i < a.s; ++i)
          a.h[0][slot_of(a, i) * bd + e] = __ldg(a.ys_in + i * bd + e);
        const size_t ee[1] = {e};
        const float lamv[1] = {__ldg(a.lam + e)};
        if (first >= 0)
          covectors<1>(a, first, ee, lamv, 1u, -1, lamv);
        else
          a.lam_prev[e] = lamv[0];
      }
      zero_unreached(a);
      return;
    }
    case kPreLoss:
      grid_loss(a, it.k - 1);
      return;
    case kPreRows:
      // each block's rows of the loss: one chain per thread over the row,
      // then the block's fixed-order sum
      for (int r = blockIdx.x; r < a.B; r += gridDim.x) {
        float ls = 0.0f;
        for (int c = threadIdx.x; c < d; c += kGBlockThreads) {
          const float x = __ldcg(a.diff + (size_t)r * d + c);
          ls = fmaf(x, x, ls);
        }
        const float tot = block_sum(ls, smem + kGGroups * kGBuf);
        if (threadIdx.x == 0) a.lrow[r] = tot;
      }
      return;
    default:
      return;
  }
}

// The step from cursor `start`: every phase in turn, its per-block work,
// then its tiles walked by the grid's tile groups (tile t of the phase:
// group t / grid of block t % grid, and so on every 2 grid tiles: the
// first grid tiles land on distinct SMs), then the grid-wide barrier. K3
// starts at kSecStage; K4's iterations, K12 and K2 at kSecFwd.
__device__ __forceinline__ void grid_step(cg::grid_group& grid,
                                          const GridArgs& a, const Iter& it,
                                          float* smem, Cursor c) {
  Gemm gs[kMaxLayers];
  int ng, tag, pre;
  while (next_phase(a, it, c, gs, &ng, &tag, &pre)) {
    mark(tag);
    phase_pre(pre, a, it, smem);
    int total = 0;
    for (int p = 0; p < ng; ++p) total += gemm_tiles(gs[p]);
    for (int t = blockIdx.x + (threadIdx.x / kGThreads) * gridDim.x;
         t < total; t += kGGroups * gridDim.x) {
      int p = 0, base = 0;
      while (t - base >= gemm_tiles(gs[p])) base += gemm_tiles(gs[p++]);
      gemm_tile(gs[p], t - base, a, it, smem);
    }
    mark(kMarkGDone);
    grid.sync();
  }
}

}  // namespace ark
}  // namespace pnode
