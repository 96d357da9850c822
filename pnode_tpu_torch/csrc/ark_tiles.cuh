// The ARK bodies of K2, K3, K4, K5 and K12: one ARK-IMEX forward step
// (forward_step) and one stage-exact reverse step (reverse_step) on R batch
// rows per block, their operands staged in shared memory and their products
// on register tiles. K2 runs forward_step alone, K3 reverse_step alone, K12
// one of each; the loop kernels (K4, K5) run them inside one cooperative
// launch, with Adam between iterations.
//
// - Rows per block, R in {1, 2, 4, 8}, come from a plan (plan_fwd): the
//   fewest rows whose grid, ceil(B / R), fits one block per SM, so the grid
//   fills the card where B allows (R 2, 128 blocks at B 256 on 132 SMs).
// - The stiff operators inv and J are staged once per block by cp.async,
//   each (d, d) row n at a stride ld_op = d | 1 (odd), so the transposed
//   products' threads, which take consecutive n at one k, read
//   consecutive banks. The MLP weights go through a ring of two slots:
//   the next chunk is copied in (16-byte cp.async where aligned, else
//   4-byte) while the current one multiplies. A chunk is a range of k rows
//   of one operand: W_l's rows are contiguous in device memory, so a layer
//   whose whole W fits a slot is one contiguous copy. Where inv and J do
//   not fit beside the ring (d 512), they go through the ring too, as
//   k-column blocks of every row n at an odd stride.
// - A product out = post(in M) gives each thread an R x C register tile:
//   columns n = c + nct j (j < C, nct = ceil(N / C)), every row of the
//   block, and one residue class of k mod G. Per k a thread reads R values
//   of the input row (broadcast) and C operand values (consecutive lanes,
//   consecutive banks) for R x C FMAs. The MLP layers take C = kCols and
//   split k (split_k: G groups of nct threads, as many as the block holds,
//   at least 4 k each); their groups' partials meet in shared memory and
//   are summed in group order. The stiff products keep G = 1, one FMA
//   chain over k ascending per output (C = 1 up to 256 columns), as the
//   plain version's matmul sums them: the stage derivative kI = (Y - G) /
//   (dt aI_ii) and the error estimate built on it cancel most of Y, and a
//   split sum's other rounding there showed 1.6e-4 of max |err| from the
//   plain version where the chain stays under 1e-4. Every output is one
//   fixed sum, so two calls, and any two R, give the same bits.
// - The stage sums run j ascending, implicit term first, as the plain
//   version's; the implicit stages' derivative is the difference quotient
//   kI = (Y - G) / (dt aI_ii) (K2, K4, K12) or the product kI = Y J^T
//   (kJY: K5, whose error estimate the quotient's cancellation would put a
//   dt-independent floor under, stalling the controller). Ys keeps its (s,
//   B, d) layout, which K3 reads.
// - Coherence (kCoherent, the loop kernels): Adam rewrites W and b in
//   place between iterations of one launch, and the L1 of an SM is not
//   kept coherent with another SM's stores. So in the loop kernels every
//   weight and bias read goes through L2: 16-byte cp.async.cg, 4-byte
//   copies as __ldcg plus a shared store (cp.async.ca would allocate in
//   L1), biases by __ldcg (not the read-only __ldg). K2, K3 and K12 keep
//   cp.async.ca and __ldg: their weights never change inside a launch.
//
// Bound on the H100 at KS (B 256, 64 -> 104 x4 -> 64, ARK3): ~102 MFLOP
// per step, 1.5 us at the fp32 peak. What limits this design on the card
// (45 us a step at KS, PERF.md) is each block's stream of the 185 KB stack
// four times a step: the chunks arrive at ~25 GB/s per SM whatever the
// copy (16-byte cp.async or a TMA bulk copy read the same) or the number
// of SMs pulling, so each product waits ~1.9 us for its next chunk.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

#include "pnode_kernels.cuh"

namespace pnode {
namespace ark {

constexpr int kThreads = 256;
constexpr int kCols = 4;                     // register tile columns
constexpr int kMaxWidth = kThreads * kCols;  // widest layer a product takes
constexpr int kMaxRows = 8;

// Split of an MLP layer's k over thread groups: as many groups of
// ceil(N / kCols) threads as the block holds, each taking at least 4 k.
__host__ __device__ inline int split_k(int K, int N) {
  const int nct = (N + kCols - 1) / kCols;
  int g = kThreads / nct;
  const int gk = K / 4 > 1 ? K / 4 : 1;
  if (g > gk) g = gk;
  return g > 1 ? g : 1;
}

__host__ __device__ inline int round4(int v) { return (v + 3) & ~3; }

// The launch's layout. Offsets and sizes in floats, each region 16-byte
// aligned.
struct Plan {
  int rows;      // R, batch rows per block
  int grid;
  int resident;  // inv and J staged once (else through the ring)
  int ld_op;     // row stride of a resident or streamed operator (odd)
  int kc_op;     // k per chunk of a streamed operator
  int slot;      // floats of each ring slot
  int kc[kMaxLayers];  // rows of W_l per chunk
  int o_y, o_kI, o_kE, o_G, o_Y, o_a, o_b, o_red, o_op, o_ring;
  size_t smem;   // bytes
};

// Host: forward_step's regions of *p at R rows per block (y, kI, kE, G, Y,
// two layer buffers, the split-k partials) from offset `off`; returns the
// end. K2's plan and K12's (over the reverse's scratch) both lay them out
// here.
static inline int layout_fwd(int R, int d, int s, int n_layers,
                             const int* dims, int off, Plan* p) {
  int maxd = d, red = 0;
  for (int l = 0; l < n_layers; ++l) {
    const int K = dims[l], N = dims[l + 1];
    if (N > maxd) maxd = N;
    if (K > maxd) maxd = K;
    const int g = split_k(K, N);
    if (g > 1 && g * N > red) red = g * N;
  }
  p->o_y = off;   off += round4(R * d);
  p->o_kI = off;  off += round4(s * R * d);
  p->o_kE = off;  off += round4(s * R * d);
  p->o_G = off;   off += round4(R * d);
  p->o_Y = off;   off += round4(R * d);
  p->o_a = off;   off += round4(R * maxd);
  p->o_b = off;   off += round4(R * maxd);
  p->o_red = off; off += round4(R * red);
  return off;
}

// Host: the ring's chunks of *p (slot and resident set): rows of W_l per
// chunk, and where inv and J stream, the most k columns of every operator
// row n at an odd stride.
static inline void ring_chunks(int d, int n_layers, const int* dims,
                               Plan* p) {
  if (p->resident) {
    p->ld_op = d | 1;
    p->kc_op = d;
  } else {
    int kc = d;
    while (d * (kc | 1) > p->slot) --kc;
    p->kc_op = kc;
    p->ld_op = kc | 1;
  }
  for (int l = 0; l < n_layers; ++l) {
    const int kc = p->slot / dims[l + 1];
    p->kc[l] = kc < dims[l] ? kc : dims[l];
  }
}

// Host: the layout at R rows per block for y (B, d), s stages and the
// stack dims[0..n_layers]; false when it does not fit kMaxSmemBytes.
static inline bool plan_rows(int R, int B, int d, int s, int n_layers,
                             const int* dims, Plan* p) {
  int maxd = d, maxW = 0;
  for (int l = 0; l < n_layers; ++l) {
    const int K = dims[l], N = dims[l + 1];
    if (N > maxd) maxd = N;
    if (K > maxd) maxd = K;
    if (K * N > maxW) maxW = K * N;
  }
  if (maxd > kMaxWidth) return false;
  *p = Plan{};
  p->rows = R;
  p->grid = (B + R - 1) / R;
  const int off = layout_fwd(R, d, s, n_layers, dims, 0, p);
  p->o_op = off;
  const int budget = kMaxSmemBytes / 4;
  const int op = round4(d * (d | 1));
  const int whole = round4(maxW);
  if (off + 2 * op + 2 * whole <= budget) {
    p->resident = 1;
    p->slot = whole;
    p->o_ring = off + 2 * op;
  } else {
    p->resident = 0;
    int slot = ((budget - off) / 2) & ~3;
    const int need = whole > op ? whole : op;
    if (slot > need) slot = need;
    if (slot < round4(maxd)) return false;
    p->slot = slot;
    p->o_ring = off;
  }
  ring_chunks(d, n_layers, dims, p);
  p->smem = sizeof(float) * ((size_t)p->o_ring + 2 * (size_t)p->slot);
  return true;
}

// Host: the plan. R is the fewest rows per block in {1, 2, 4, 8} whose
// grid fits one block per SM (else 8), halved while it does not fit the
// shared memory. false when not even R = 1 fits.
static inline bool plan_fwd(int B, int d, int s, int n_layers,
                            const int* dims, int sms, Plan* p) {
  int R = 1;
  while (R < kMaxRows && (B + R - 1) / R > sms) R *= 2;
  for (; R >= 1; R /= 2)
    if (plan_rows(R, B, d, s, n_layers, dims, p)) return true;
  return false;
}

// Host: the current device's SM count (cached per device).
static inline int sm_count(int* sms) {
  static int cached[64] = {};
  int dev = 0, rc;
  if ((rc = (int)cudaGetDevice(&dev))) return rc;
  if (dev < 64 && cached[dev]) {
    *sms = cached[dev];
    return 0;
  }
  if ((rc = (int)cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount,
                                        dev)))
    return rc;
  if (dev < 64) cached[dev] = *sms;
  return 0;
}

// -- asynchronous copies -----------------------------------------------------

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most `kPending` of this thread's newest groups are in
// flight.
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// One float into shared memory: cp.async.ca, or (kCoherent) a load
// through L2 and a shared store, complete before the next commit.
template <bool kCoherent>
__device__ __forceinline__ void copy4(float* dst, const float* src) {
  if constexpr (kCoherent)
    *dst = __ldcg(src);
  else
    cp_async4(dst, src);
}

// A bias read: through L2 in the loop kernels (kCoherent), else the
// read-only path.
template <bool kCoherent>
__device__ __forceinline__ float load_bias(const float* p) {
  if constexpr (kCoherent)
    return __ldcg(p);
  else
    return __ldg(p);
}

// n contiguous floats, by the block: 16-byte copies where both ends are
// aligned and n is a multiple of 4, else 4-byte copies.
template <bool kCoherent = false>
__device__ __forceinline__ void copy_contig(float* dst, const float* src,
                                           int n) {
  if ((((uintptr_t)dst | (uintptr_t)src) & 15) == 0 && (n & 3) == 0) {
    for (int e = 4 * threadIdx.x; e < n; e += 4 * kThreads)
      cp_async16(dst + e, src + e);
  } else {
    for (int e = threadIdx.x; e < n; e += kThreads)
      copy4<kCoherent>(dst + e, src + e);
  }
}

// Columns k0 .. k0 + kn - 1 of every row n < N of the row-major (N, K)
// operator, to dst[n * ld + (k - k0)].
__device__ __forceinline__ void copy_cols(float* dst, int ld, const float* src,
                                          int N, int K, int k0, int kn) {
  for (int e = threadIdx.x; e < N * kn; e += kThreads) {
    const int n = e / kn, k = e - n * kn;
    cp_async4(dst + n * ld + k, src + (size_t)n * K + k0 + k);
  }
}

// -- the chunk stream ----------------------------------------------------------

// The step's operand sequence, block-uniform: per stage, when inv and J
// are not resident, the stage operator (u = -2: inv on an implicit stage,
// else J) and, with kI = Y J^T (jy) on an implicit stage, J (u = -1);
// then W_0 .. W_{n-1}; each in chunks of k rows. The chunk in flight is in
// slot `par`.
struct Stream {
  int stage, u, k0, par, jy;
};

struct StepArgs {
  const float* J;
  const float* inv;
  Plan p;
  Mlp m;
  Tableau tb;
};

// Rows of operand u per chunk, its depth K and its width N.
__device__ __forceinline__ void operand_shape(const StepArgs& a, int u,
                                              int* kc, int* K, int* N) {
  if (u < 0) {
    *kc = a.p.kc_op;
    *K = *N = a.m.dims[0];
  } else {
    *kc = a.p.kc[u];
    *K = a.m.dims[u];
    *N = a.m.dims[u + 1];
  }
}

__device__ __forceinline__ void stream_advance(const StepArgs& a,
                                              const Tableau& tb, Stream* st) {
  int kc, K, N;
  operand_shape(a, st->u, &kc, &K, &N);
  st->k0 += kc;
  if (st->k0 < K) return;
  st->k0 = 0;
  if (st->u == -2 && st->jy && tb.nzI[st->stage][st->stage]) {
    st->u = -1;
  } else if (st->u < 0) {
    st->u = 0;
  } else if (++st->u == a.m.n) {
    st->u = a.p.resident ? 0 : -2;
    ++st->stage;
  }
}

// Copy chunk *st into ring slot `slot` and commit it (an empty group past
// the last chunk, so that every wait counts the same groups).
template <bool kCoherent>
__device__ __forceinline__ void stream_issue(const StepArgs& a,
                                            const Tableau& tb,
                                            const Stream& st, float* slot) {
  if (st.stage < tb.s) {
    int kc, K, N;
    operand_shape(a, st.u, &kc, &K, &N);
    const int kn = min(kc, K - st.k0);
    if (st.u < 0) {
      const float* op =
          st.u == -2 && tb.nzI[st.stage][st.stage] ? a.inv : a.J;
      copy_cols(slot, a.p.ld_op, op, N, K, st.k0, kn);
    } else {
      copy_contig<kCoherent>(slot, a.m.W[st.u] + (size_t)st.k0 * N, kn * N);
    }
  }
  cp_async_commit();
}

// -- the product ------------------------------------------------------------------

// acc[r][j] += sum over kl = kl0, kl0 + G, ... < kn of ip[r * ldi + kl] *
// mp[kl * ldk + nct * j * ldn], one FMA chain per (r, j) in kl order;
// columns j with !ok[j] read 0.
template <int R, int C>
__device__ __forceinline__ void tile_fma(float (&acc)[R][C], const float* mp,
                                         int ldk, int ldn, int nct,
                                         const bool (&ok)[C],
                                         const float* ip, int ldi, int kl0,
                                         int kn, int G) {
#pragma unroll 4
  for (int kl = kl0; kl < kn; kl += G) {
    float m[C];
#pragma unroll
    for (int j = 0; j < C; ++j)
      m[j] = ok[j] ? mp[kl * ldk + nct * j * ldn] : 0.0f;
    float x[R];
#pragma unroll
    for (int r = 0; r < R; ++r) x[r] = ip[r * ldi + kl];
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int j = 0; j < C; ++j) acc[r][j] = fmaf(x[r], m[j], acc[r][j]);
  }
}

// out[r * ldo + n] = scale * act(sum_k in[r * ldi + k] M(k, n) + bias[n])
// for r < rows, n < N, k < K (bias may be null), on R x C register tiles,
// k split over G thread groups (ceil(N / C) G <= kThreads).
// M is either the resident operator `res` (M(k, n) = res[n * ld_op + k]),
// or the stream's next operand, taken chunk by chunk from the ring (W
// chunks: M(k, n) = slot[(k - k0) * N + n]; operator chunks: slot[n *
// ld_op + (k - k0)]). red: the split-k partials. Ends with a barrier.
template <int R, int C, bool kCoherent>
__device__ __forceinline__ void product(const StepArgs& a, const Tableau& tb,
                                        Stream* st,
                                        float* ring, const float* res,
                                        const float* in, int ldi, int rows,
                                        int K, int N, int G,
                                        const float* bias, int act,
                                        float scale, float* out, int ldo,
                                        float* red) {
  const int nct = (N + C - 1) / C;
  const int c = threadIdx.x % nct, g = threadIdx.x / nct;
  const bool active = g < G;
  bool ok[C];
#pragma unroll
  for (int j = 0; j < C; ++j) ok[j] = c + nct * j < N;
  float acc[R][C];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int j = 0; j < C; ++j) acc[r][j] = 0.0f;

  int k0 = 0;
  while (k0 < K) {
    const float* M;
    int kn, ldk, ldn;  // M(k0 + kl, n) = M[kl * ldk + n * ldn]
    if (res != nullptr) {
      M = res;
      kn = K;
      ldk = 1;
      ldn = a.p.ld_op;
    } else {
      // this thread's copies of the chunk have landed; after the barrier
      // everyone's have, and the other slot's last reader is done
      cp_async_wait<0>();
      __syncthreads();
      M = ring + st->par * a.p.slot;
      int kc, KK, NN;
      operand_shape(a, st->u, &kc, &KK, &NN);
      kn = min(kc, K - k0);
      const bool tmajor = st->u < 0;
      ldk = tmajor ? 1 : N;
      ldn = tmajor ? a.p.ld_op : 1;
      stream_advance(a, tb, st);
      st->par ^= 1;
      stream_issue<kCoherent>(a, tb, *st, ring + st->par * a.p.slot);
    }
    if (active) {
      const int r0 = k0 % G;
      tile_fma<R, C>(acc, M + c * ldn, ldk, ldn, nct, ok, in + k0, ldi,
                     g >= r0 ? g - r0 : g - r0 + G, kn, G);
    }
    k0 += kn;
  }

  auto post = [&](float v, int n) {
    if (bias != nullptr) v = v + load_bias<kCoherent>(bias + n);
    v = act_fwd(v, act);
    return scale == 1.0f ? v : scale * v;
  };
  if (G == 1) {
    if (active) {
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int j = 0; j < C; ++j)
          if (r < rows && ok[j])
            out[r * ldo + c + nct * j] = post(acc[r][j], c + nct * j);
    }
  } else {
    if (active) {
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int j = 0; j < C; ++j)
          if (ok[j]) red[(g * R + r) * N + c + nct * j] = acc[r][j];
    }
    __syncthreads();
    for (int e = threadIdx.x; e < rows * N; e += kThreads) {
      const int r = e / N, n = e - r * N;
      float v = red[r * N + n];
      for (int gg = 1; gg < G; ++gg) v += red[(gg * R + r) * N + n];
      out[r * ldo + n] = post(v, n);
    }
  }
  __syncthreads();
}

// -- the step -----------------------------------------------------------------------

// One ARK-IMEX forward step on the block's `rows` rows: y, y1 and err
// (when not null) point at the block's first row (row stride d), stage i's
// rows go to ys + i * ys_step. K2 passes device memory; K4 and K12 keep y1
// and the stage values in their shared memory; K5 writes y1 and the stage
// values to device memory and err to shared memory. tb: the step's tableau
// (K5's is rescaled per trial in shared memory; the others pass a.tb).
// stage_ops: copy inv and J into the resident region first (K5 forms its
// stage inverse there itself and stages J once per launch; K4 stages both
// on its first call only). kJY: implicit stages take kI = Y J^T, not the
// difference quotient. Ends with no barrier.
template <int R, bool kJY = false, bool kCoherent = false>
__device__ __forceinline__ void forward_step(const StepArgs& a,
                                             const Tableau& tb,
                                             const float* y, float* y1,
                                             float* ys, size_t ys_step,
                                             float* err, int rows,
                                             float sign, bool stage_ops,
                                             float* smem) {
  const Plan& p = a.p;
  const Mlp& m = a.m;
  const int d = m.dims[0];
  const int s = tb.s;
  const int tile = R * d;
  float* yb = smem + p.o_y;
  float* kI = smem + p.o_kI;
  float* kE = smem + p.o_kE;
  float* Gb = smem + p.o_G;
  float* Yb = smem + p.o_Y;
  float* ha = smem + p.o_a;
  float* hb = smem + p.o_b;
  float* red = smem + p.o_red;
  float* ops = smem + p.o_op;  // inv, then J, when resident
  float* ring = smem + p.o_ring;
  const int opf = round4(d * p.ld_op);

  // y's rows and the resident operators, then the stream's first chunk
  copy_contig<kCoherent>(yb, y, rows * d);
  if (p.resident && stage_ops) {
    copy_cols(ops, p.ld_op, a.inv, d, d, 0, d);
    copy_cols(ops + opf, p.ld_op, a.J, d, d, 0, d);
  }
  cp_async_commit();
  Stream st{0, p.resident ? 0 : -2, 0, 0, kJY};
  stream_issue<kCoherent>(a, tb, st, ring);
  cp_async_wait<1>();
  __syncthreads();

  // out = in op^T on the block's rows (res: the resident operator, else
  // the stream's next operand): one FMA chain per output
  auto stiff = [&](const float* res, const float* in, float* out) {
    if (d <= kThreads)
      product<R, 1, kCoherent>(a, tb, &st, ring, res, in, d, rows, d, d, 1,
                               nullptr, kActNone, 1.0f, out, d, red);
    else if (d <= 2 * kThreads)
      product<R, 2, kCoherent>(a, tb, &st, ring, res, in, d, rows, d, d, 1,
                               nullptr, kActNone, 1.0f, out, d, red);
    else
      product<R, 4, kCoherent>(a, tb, &st, ring, res, in, d, rows, d, d, 1,
                               nullptr, kActNone, 1.0f, out, d, red);
  };

  for (int i = 0; i < s; ++i) {
    // G = y + sum_{j<i} (dt aI_ij kI_j + dt aE_ij kE_j), in the reference's
    // order (j ascending, implicit term first)
    for (int e = threadIdx.x; e < rows * d; e += kThreads) {
      float acc = yb[e];
      for (int j = 0; j < i; ++j) {
        if (tb.nzI[i][j]) acc = acc + tb.cI[i][j] * kI[j * tile + e];
        if (tb.nzE[i][j]) acc = acc + tb.cE[i][j] * kE[j * tile + e];
      }
      Gb[e] = acc;
    }
    __syncthreads();
    float* kIi = kI + i * tile;
    const bool implicit = tb.nzI[i][i];
    const float* Jres = p.resident ? ops + opf : nullptr;
    // implicit: Y = G inv^T, then kI = Y J^T (kJY) or (Y - G) / (dt aI_ii);
    // explicit: kI = G J^T (and Y = G)
    if (implicit) {
      stiff(p.resident ? ops : nullptr, Gb, Yb);
      if constexpr (kJY) {
        stiff(Jres, Yb, kIi);
      } else {
        const float inv_dt = tb.inv_dt[i];
        for (int e = threadIdx.x; e < rows * d; e += kThreads)
          kIi[e] = (Yb[e] - Gb[e]) * inv_dt;
      }
    } else {
      stiff(Jres, Gb, kIi);
    }
    const float* Yi = implicit ? Yb : Gb;
    float* yo = ys + i * ys_step;
    for (int e = threadIdx.x; e < rows * d; e += kThreads) yo[e] = Yi[e];
    // kE_i = sign * MLP(Y_i)
    const float* src = Yi;
    float* kEi = kE + i * tile;
    for (int l = 0; l < m.n; ++l) {
      const bool last = l == m.n - 1;
      float* dst = last ? kEi : ((l & 1) ? hb : ha);
      const int K = m.dims[l], N = m.dims[l + 1];
      product<R, kCols, kCoherent>(a, tb, &st, ring, nullptr, src, K, rows, K,
                                   N, split_k(K, N), m.b[l],
                                   last ? kActNone : m.act,
                                   last ? sign : 1.0f, dst, last ? d : N,
                                   red);
      src = dst;
    }
  }

  // y1 = y + sum_i (dt bI_i kI_i + dt bE_i kE_i), stage order; err likewise
  // from 0 with the weight differences
  for (int e = threadIdx.x; e < rows * d; e += kThreads) {
    float acc = yb[e];
    for (int i = 0; i < s; ++i) {
      if (tb.nzbI[i]) acc = acc + tb.cbI[i] * kI[i * tile + e];
      if (tb.nzbE[i]) acc = acc + tb.cbE[i] * kE[i * tile + e];
    }
    y1[e] = acc;
    if (err != nullptr) {
      float ea = 0.0f;
      for (int i = 0; i < s; ++i) {
        if (tb.nzerrI[i]) ea = ea + tb.cerrI[i] * kI[i * tile + e];
        if (tb.nzerrE[i]) ea = ea + tb.cerrE[i] * kE[i * tile + e];
      }
      err[e] = ea;
    }
  }
}


// -- the reverse step ---------------------------------------------------------------
//
// K3's, K4's, K5's and K12's body: one stage-exact reverse step on R rows
// per block, on forward_step's pieces. For i = s-1 .. 0 (the stages some
// covector reaches), in the plain version's order:
//
//   u_i  = dt (bI_i lam + sum_{m>i} aI_mi xi_m)   (lam term, m ascending)
//   uh_i = dt (bE_i lam + sum_{m>i} aE_mi xi_m)
//   p_i  = u_i J (explicit stage) + MLP_vjp_x(Y_i, sign uh_i)
//   xi_i = (c + p_i) inv - c, c = u_i / (dt aI_ii)   (implicit stage)
//   lam_prev = lam + sum_i xi_i
//
// - inv and J are staged once per block at the odd stride ld_op (K12 reads
//   the copies its forward staged). The reverse reads them row-wise, M(k,
//   n) = op[k][n], one FMA chain per output over k ascending (G = 1), as
//   the plain version's matmul sums them. Where the
//   two copies do not fit beside the rest (past d ~160 at KS-like stacks; the
//   plan says), the reverse reads them in place from device memory, still
//   row-wise (consecutive lanes on consecutive n, coalesced), with the same
//   chains and so the same bits, and K12's forward streams them through the
//   ring as K2 does at d 512.
// - W_l streams through a two-slot ring in chunks of k rows, each row at
//   the stride ldw = row_stride(N): the recompute h_{l+1} = act(h_l W_l +
//   b_l) reads a chunk row-wise (consecutive lanes, consecutive n), the
//   backprop g_{l-1} = (g_l W_l^T) act'(h_l) column-wise (consecutive lanes
//   on consecutive k, ldw apart), so no product reads device memory
//   transposed. Where N is a multiple of 4, ldw is too, with ldw / 4 odd:
//   the rows take 16-byte copies, and the backprop reads 4 n at a time
//   (float4), each quarter warp on distinct 16-byte bank groups; else ldw
//   is odd and every access is 4 bytes, lanes on distinct banks. A stage
//   uses W_0 .. W_{n-2}, then W_{n-1} .. W_0; a chunk that one slot still
//   holds is not copied again (at KS 6 copies of the 9 uses per stage).
//   What bounds the step on the H100 (tools/trace_ark.py, KS B 256, R 2):
//   a warp's cp.async stalls while it has too much in flight, so issuing a
//   45 KB chunk takes the 8 warps ~1.6 us (~27 GB/s per SM), a third of
//   the block's ~120 us; the products' FMAs, their split-k epilogues and
//   the dW/db flush take most of the rest. One warp issuing alone (5x
//   slower), one TMA bulk copy per row (2x) and the issue split around the
//   FMAs (4% slower) were measured and dropped.
// - Each MLP stage keeps its layer inputs h_l and covectors g_l for the
//   block's rows in a store of nst stage slots. When the store is full, and
//   after the last MLP stage, dW_l = sum h_l^T g_l and db_l = sum g_l are
//   formed, one FMA chain per element (stages descending, rows ascending;
//   4 x 4 tiles, each thread's 4 columns consecutive and stored as one
//   float4 where N allows), and written to the block's partial: once per
//   step where the store holds every stage (overwrite, no read; the plan
//   halves R until it does), else once per flush (the first overwrites,
//   later ones add).
// - Split k as forward_step's: its G depends on the widths only, so lam_prev
//   has the same bits at every R; dW/db group rows by R and may differ.

// Phase marks, compiled in only with -DARK_TRACE (the build of
// tools/trace_ark.py): thread 0 of block 0 logs (clock64(), tag) at each
// phase boundary of the launch, and the globaltimer at its start and end.
// Each source that launches a marked kernel has its own copy and its own
// reader (pnode_ark_adj_marks, pnode_grad_step_marks).
enum MarkTag {
  kMarkStart, kMarkStaged, kMarkCovec, kMarkStiff, kMarkWait, kMarkGot,
  kMarkFwd, kMarkBwd, kMarkPv, kMarkGrads, kMarkXi, kMarkForward,
  kMarkSeed, kMarkEnd, kMarkIssued, kMarkTile
};
#ifdef ARK_TRACE
constexpr int kMarks = 2048;
static __device__ long long mark_t[kMarks];
static __device__ int mark_tag[kMarks];
static __device__ int mark_n;
static __device__ unsigned long long mark_ns[2];
__device__ __forceinline__ void mark(int tag) {
  if (blockIdx.x != 0 || threadIdx.x != 0) return;
  unsigned long long t;
  if (tag == kMarkStart || tag == kMarkEnd) {
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    mark_ns[tag == kMarkEnd] = t;
  }
  if (tag == kMarkStart) mark_n = 0;
  if (mark_n < kMarks) {
    mark_t[mark_n] = clock64();
    mark_tag[mark_n] = tag;
    ++mark_n;
  }
}
#else
__device__ __forceinline__ void mark(int) {}
#endif

// Row stride of a streamed W_l chunk (N columns): a multiple of 4 with an
// odd quotient where N is a multiple of 4, else odd.
__host__ __device__ inline int row_stride(int N) {
  return N % 4 ? (N | 1) : (N / 4 % 2 ? N : N + 4);
}

// The reverse's layout; offsets and sizes in floats, each region 16-byte
// aligned.
struct RevPlan {
  int rows;      // R, batch rows per block
  int grid;
  int nst;       // stage slots of the layer store
  int sst;       // floats of one stage slot: h_0 .. h_{n-1}, g_0 .. g_{n-1}
  int ho[kMaxLayers], go[kMaxLayers];  // h_l and g_l in a stage slot
  int resident;  // inv and J staged in shared memory (else read in place)
  int ld_op;     // row stride of inv and J as read: staged (odd) or d
  int slot;      // floats of each ring slot
  int kc[kMaxLayers];  // rows of W_l per chunk, at row_stride(N)
  int o_ys, o_lam, o_lp, o_xi, o_u, o_pv, o_q, o_st, o_red, o_op, o_ring;
  size_t smem;   // bytes
};

// The reverse's layouts: K3's (kRevStep: lam, lam_prev, then the
// reverse's scratch), K4's and K12's (kRevGrad: the stage values and the
// seed, then the forward's scratch overlaid by the reverse's) and K5's
// (kRevAdapt: lam, lam_prev, then both scratches overlaid). Where the
// forward runs too, *f is its plan over the same ring, with inv and J
// streamed through it where they are not resident.
enum RevKind { kRevStep = 0, kRevGrad = 1, kRevAdapt = 2 };

// Host: the layout of `kind` at R rows per block with nst store slots,
// from offset `head` (floats the kernel keeps for itself: K5's trial
// header). `resident`: inv and J staged whole, else the reverse reads them
// from device memory. false when it does not fit kMaxSmemBytes or a layer
// is wider than a product takes.
static inline bool plan_rev_rows(int R, int B, int d, int s, int n_layers,
                                 const int* dims, int nst, int kind,
                                 bool resident, RevPlan* q, Plan* f,
                                 int head = 0) {
  const bool fwd = kind != kRevStep;
  int maxd = d, redw = 0, whole = 0, minslot = 0;
  int hw = 0, gw = 0;  // floats of a stage slot's layer inputs, covectors
  for (int l = 0; l < n_layers; ++l) {
    const int K = dims[l], N = dims[l + 1];
    if (N > maxd) maxd = N;
    if (K > maxd) maxd = K;
    const int gf = split_k(K, N), gt = split_k(N, K);
    if (gf * N > redw) redw = gf * N;
    if (gt * K > redw) redw = gt * K;
    if (K * row_stride(N) > whole) whole = K * row_stride(N);
    if (row_stride(N) > minslot) minslot = row_stride(N);
  }
  if (maxd > kMaxWidth) return false;
  *q = RevPlan{};
  q->rows = R;
  q->grid = (B + R - 1) / R;
  q->nst = nst;
  for (int l = 0; l < n_layers; ++l) {
    q->ho[l] = hw;
    hw += round4(R * dims[l]);
  }
  for (int l = 0; l < n_layers; ++l) {
    q->go[l] = hw + gw;
    gw += round4(R * dims[l + 1]);
  }
  q->sst = hw + gw;
  int off = head;
  if (kind == kRevGrad) {
    q->o_ys = off;  off += round4(s * R * d);
    q->o_lam = off; off += round4(R * d);  // the seed
  } else {
    q->o_lam = off; off += round4(R * d);
    q->o_lp = off;  off += round4(R * d);
  }
  const int scratch = off;
  q->o_xi = off;  off += round4(s * R * d);
  q->o_u = off;   off += round4(R * d);
  q->o_pv = off;  off += round4(R * d);
  q->o_q = off;   off += round4(R * d);
  q->o_st = off;  off += nst * q->sst;
  q->o_red = off; off += round4(R * redw);
  if (fwd) {
    *f = Plan{};
    f->rows = R;
    f->grid = q->grid;
    const int fo = layout_fwd(R, d, s, n_layers, dims, scratch, f);
    if (fo > off) off = fo;
  }
  q->resident = resident;
  q->ld_op = resident ? d | 1 : d;
  q->o_op = off;
  if (resident) off += 2 * round4(d * q->ld_op);
  q->o_ring = off;
  const int avail = kMaxSmemBytes / 4 - off;
  q->slot = round4(whole);
  if (2 * q->slot > avail) q->slot = (avail / 2) & ~3;
  if (q->slot < round4(minslot)) return false;
  for (int l = 0; l < n_layers; ++l) {
    const int kc = q->slot / row_stride(dims[l + 1]);
    q->kc[l] = kc < dims[l] ? kc : dims[l];
  }
  q->smem = sizeof(float) * ((size_t)q->o_ring + 2 * (size_t)q->slot);
  if (fwd) {
    f->resident = resident;
    f->slot = q->slot;
    f->o_op = q->o_op;
    f->o_ring = q->o_ring;
    f->smem = q->smem;
    ring_chunks(d, n_layers, dims, f);
  }
  return true;
}

// Host: the plan of `kind` (K3's, K4's and K12's, or K5's, after `head`
// floats). R is the fewest rows per block in {1, 2, 4, 8} whose grid
// ceil(B / R) fits one block per SM (else 8),
// halved while the store of all s stages does not fit; at R = 1 the store
// then shrinks to the most stage slots that fit. All of that first with
// inv and J resident, then with them read from device memory (where the
// two (d, d) copies do not fit beside the rest, past d ~160 at KS-like
// stacks). false when nothing fits. `rows` 1, 2, 4 or 8 forces R (with
// the whole store, inv and J resident where they fit).
static inline bool plan_rev(int B, int d, int s, int n_layers,
                            const int* dims, int sms, int kind, int rows,
                            RevPlan* q, Plan* f, int head = 0) {
  for (int resident = 1; resident >= 0; --resident) {
    if (rows != 0) {
      if ((rows == 1 || rows == 2 || rows == 4 || rows == 8) &&
          plan_rev_rows(rows, B, d, s, n_layers, dims, s, kind, resident, q,
                        f, head))
        return true;
      continue;
    }
    int R = 1;
    while (R < kMaxRows && (B + R - 1) / R > sms) R *= 2;
    for (; R >= 1; R /= 2)
      if (plan_rev_rows(R, B, d, s, n_layers, dims, s, kind, resident, q, f,
                        head))
        return true;
    for (int nst = s - 1; nst >= 1; --nst)
      if (plan_rev_rows(1, B, d, s, n_layers, dims, nst, kind, resident, q,
                        f, head))
        return true;
  }
  return false;
}

// The ring of the reverse: the chunk the next ring_acquire returns is
// chunk k0 of use `pos` of stage `stage` (-1: none left), in slot nslot;
// held0/held1 name the chunk each slot holds (-1: none). A stage's uses:
// pos 0 .. n-2 the recompute of W_pos, pos n-1 .. 2n-2 the backprop of
// W_{2n-2-pos}. Block-uniform.
struct RevRing {
  int stage, pos, k0, nslot, held0, held1;
};

__device__ __forceinline__ int rev_layer_of(int pos, int n) {
  return pos < n - 1 ? pos : 2 * n - 2 - pos;
}

__device__ __forceinline__ int chunk_id(int l, int k0) {
  return l * (kMaxWidth + 1) + k0;
}

// Copy chunk k0 of W_l into `slot`, rows at row_stride(N), a warp per
// row (16-byte copies where N and W_l allow), and commit it.
template <bool kCoherent>
__device__ __forceinline__ void ring_issue(const RevPlan& q, const Mlp& m,
                                           int l, int k0, float* slot) {
  const int N = m.dims[l + 1], ldw = row_stride(N);
  const int kn = min(q.kc[l], m.dims[l] - k0);
  const float* src = m.W[l] + (size_t)k0 * N;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (N % 4 == 0 && ((uintptr_t)m.W[l] & 15) == 0) {
    for (int k = warp; k < kn; k += kThreads / 32)
      for (int v = 4 * lane; v < N; v += 4 * 32)
        cp_async16(slot + k * ldw + v, src + (size_t)k * N + v);
  } else {
    for (int k = warp; k < kn; k += kThreads / 32)
      for (int n = lane; n < N; n += 32)
        copy4<kCoherent>(slot + k * ldw + n, src + (size_t)k * N + n);
  }
  cp_async_commit();
}

// Start the ring at the first MLP stage (the highest bit of `mlp`).
template <bool kCoherent>
__device__ __forceinline__ void ring_start(const RevPlan& q, const Mlp& m,
                                           unsigned mlp, RevRing* rg,
                                           float* ring) {
  *rg = RevRing{31 - __clz((int)mlp), 0, 0, 0, -1, -1};
  if (mlp == 0) {
    rg->stage = -1;
    return;
  }
  const int l = rev_layer_of(0, m.n);
  ring_issue<kCoherent>(q, m, l, 0, ring);
  rg->held0 = chunk_id(l, 0);
}

// The chunk in use from here to the next call (it has landed, and every
// reader of the other slot is done); the one after it is brought into the
// other slot unless a slot holds it already.
template <bool kCoherent>
__device__ __forceinline__ const float* ring_acquire(const RevPlan& q,
                                                     const Mlp& m,
                                                     unsigned mlp,
                                                     RevRing* rg,
                                                     float* ring) {
  mark(kMarkWait);
  cp_async_wait<0>();
  __syncthreads();
  mark(kMarkGot);
  const int cur = rg->nslot;
  const float* M = ring + cur * q.slot;
  // advance to the following chunk
  int l = rev_layer_of(rg->pos, m.n);
  rg->k0 += q.kc[l];
  if (rg->k0 >= m.dims[l]) {
    rg->k0 = 0;
    if (++rg->pos == 2 * m.n - 1) {
      rg->pos = 0;
      int i = rg->stage - 1;
      while (i >= 0 && !((mlp >> i) & 1u)) --i;
      rg->stage = i;
    }
  }
  if (rg->stage >= 0) {
    l = rev_layer_of(rg->pos, m.n);
    const int id = chunk_id(l, rg->k0);
    const int here = cur == 0 ? rg->held0 : rg->held1;
    const int there = cur == 0 ? rg->held1 : rg->held0;
    if (here == id) {
      rg->nslot = cur;
    } else {
      rg->nslot = cur ^ 1;
      if (there != id) {
        ring_issue<kCoherent>(q, m, l, rg->k0, ring + (cur ^ 1) * q.slot);
        if (cur == 0) rg->held1 = id;
        else rg->held0 = id;
        mark(kMarkIssued);
      }
    }
  }
  return M;
}

// The split-k epilogue of a register tile: columns col = c + nct j (< N
// where ok[j]) of rows r < rows get post(v, r, col), v the tile's sum, or
// the groups' partials met in red and summed in group order (G > 1). Ends
// with no barrier.
template <int R, int C, typename Post>
__device__ __forceinline__ void tile_store(const float (&acc)[R][C], int c,
                                          int g, int nct, int G,
                                          const bool (&ok)[C], int rows,
                                          int N, float* red, Post post) {
  if (G == 1) {
    if (g < 1) {
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int j = 0; j < C; ++j)
          if (r < rows && ok[j]) post(acc[r][j], r, c + nct * j);
    }
    return;
  }
  if (g < G) {
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int j = 0; j < C; ++j)
        if (ok[j]) red[(g * R + r) * N + c + nct * j] = acc[r][j];
  }
  __syncthreads();
  for (int e = threadIdx.x; e < rows * N; e += kThreads) {
    const int r = e / N, n = e - r * N;
    float v = red[r * N + n];
    for (int gg = 1; gg < G; ++gg) v += red[(gg * R + r) * N + n];
    post(v, r, n);
  }
}

// out[r * d + n] = sum_k in[r * d + k] op[k * ld_op + n] (op: the staged
// copy, or inv or J in device memory at ld_op d, read row-wise either way):
// one FMA chain per output over k ascending, one thread per column, kThreads
// columns at a time. Ends with a barrier.
template <int R>
__device__ __forceinline__ void stiff_product(const float* op, int ld_op,
                                              const float* in, int rows,
                                              int d, float* out) {
  const bool ok[1] = {true};
  for (int c0 = 0; c0 < d; c0 += kThreads) {
    const int w = min(kThreads, d - c0);
    const int c = threadIdx.x % w, g = threadIdx.x / w;
    float acc[R][1] = {};
    if (g < 1)
      tile_fma<R, 1>(acc, op + c0 + c, ld_op, 1, w, ok, in, d, 0, d, 1);
    tile_store<R, 1>(acc, c, g, w, 1, ok, rows, w, nullptr,
                     [&](float v, int r, int n) { out[r * d + c0 + n] = v; });
  }
  __syncthreads();
}

// The recompute of layer l, h_{l+1} = act(h_l W_l + b_l) (in: rows x K,
// out: rows x N), over the ring's chunks of W_l. Ends with a barrier.
template <int R, bool kCoherent>
__device__ __forceinline__ void rev_forward(const RevPlan& q, const Mlp& m,
                                            unsigned mlp, RevRing* rg,
                                            float* ring, int l,
                                            const float* in, int rows,
                                            float* out, float* red) {
  constexpr int C = kCols;
  const int K = m.dims[l], N = m.dims[l + 1], ldw = row_stride(N);
  const int G = split_k(K, N);
  const int nct = (N + C - 1) / C;
  const int c = threadIdx.x % nct, g = threadIdx.x / nct;
  bool ok[C];
#pragma unroll
  for (int j = 0; j < C; ++j) ok[j] = c + nct * j < N;
  float acc[R][C] = {};
  for (int k0 = 0; k0 < K; k0 += q.kc[l]) {
    const float* M = ring_acquire<kCoherent>(q, m, mlp, rg, ring);
    const int kn = min(q.kc[l], K - k0);
    if (g < G) {
      const int r0 = k0 % G;
      tile_fma<R, C>(acc, M + c, ldw, 1, nct, ok, in + k0, K,
                     g >= r0 ? g - r0 : g - r0 + G, kn, G);
    }
    mark(kMarkTile);
  }
  const float* bias = m.b[l];
  const int act = m.act;
  tile_store<R, C>(acc, c, g, nct, G, ok, rows, N, red,
                   [&](float v, int r, int n) {
                     out[r * N + n] =
                         act_fwd(v + load_bias<kCoherent>(bias + n), act);
                   });
  __syncthreads();
  mark(kMarkFwd);
}

// acc[r][j] += sum over n4 = g, g + G, ... < N / 4 of the 4 products
// in[r * N + 4 n4 + i] M[(c + nct j) ldw + 4 n4 + i], i = 0 .. 3 in order:
// rev_backward's tile with every operand read as a float4 (N, ldw, in and
// M 16-byte aligned).
template <int R, int C>
__device__ __forceinline__ void tile_fma4(float (&acc)[R][C], const float* M,
                                          int ldw, int nct, int c,
                                          const bool (&ok)[C],
                                          const float* in, int N, int g,
                                          int G) {
  for (int n4 = g; 4 * n4 < N; n4 += G) {
    float4 m[C];
#pragma unroll
    for (int j = 0; j < C; ++j)
      m[j] = ok[j] ? *reinterpret_cast<const float4*>(
                         M + (c + nct * j) * ldw + 4 * n4)
                   : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float4 x = *reinterpret_cast<const float4*>(in + r * N + 4 * n4);
#pragma unroll
      for (int j = 0; j < C; ++j) {
        float a = acc[r][j];
        a = fmaf(x.x, m[j].x, a);
        a = fmaf(x.y, m[j].y, a);
        a = fmaf(x.z, m[j].z, a);
        acc[r][j] = fmaf(x.w, m[j].w, a);
      }
    }
  }
}

// The backprop of layer l: out = (in W_l^T) act'(hg) (in: rows x N, out
// and hg: rows x K; hg null: no activation), chunk by chunk of W_l's rows
// (each chunk a block of outputs, summed over all of n; 4 n at a time
// where N is a multiple of 4). Ends with a barrier.
template <int R, bool kCoherent>
__device__ __forceinline__ void rev_backward(const RevPlan& q, const Mlp& m,
                                             unsigned mlp, RevRing* rg,
                                             float* ring, int l,
                                             const float* in, int rows,
                                             const float* hg, float* out,
                                             float* red) {
  constexpr int C = kCols;
  const int K = m.dims[l], N = m.dims[l + 1], ldw = row_stride(N);
  const int G = split_k(N, K);
  const int act = m.act;
  for (int k0 = 0; k0 < K; k0 += q.kc[l]) {
    const float* M = ring_acquire<kCoherent>(q, m, mlp, rg, ring);
    const int kn = min(q.kc[l], K - k0);
    const int nct = (kn + C - 1) / C;
    const int c = threadIdx.x % nct, g = threadIdx.x / nct;
    bool ok[C];
#pragma unroll
    for (int j = 0; j < C; ++j) ok[j] = c + nct * j < kn;
    float acc[R][C] = {};
    if (g < G) {
      if (N % 4 == 0)
        tile_fma4<R, C>(acc, M, ldw, nct, c, ok, in, N, g, G);
      else
        tile_fma<R, C>(acc, M + c * ldw, 1, ldw, nct, ok, in, N, g, N, G);
    }
    mark(kMarkTile);
    tile_store<R, C>(acc, c, g, nct, G, ok, rows, kn, red,
                     [&](float v, int r, int k) {
                       const int e = r * K + k0 + k;
                       out[e] = hg != nullptr ? v * act_grad(hg[e], act) : v;
                     });
  }
  __syncthreads();
  mark(kMarkBwd);
}

// dW_l = sum h_l^T g_l and db_l = sum g_l over the store's first cnt stage
// slots (stages descending) and the block's rows: one chain per element,
// slots ascending, rows ascending, written to part ([W0, b0, W1, b1,
// ...]; added to what it holds when `add`). Each thread takes 4 x 4 tiles
// of dW: 4 rows k, and 4 consecutive columns read and stored as float4s
// where N and part allow (else columns nct apart, lanes on consecutive
// columns either way).
template <int R>
__device__ __forceinline__ void form_grads(const RevPlan& q, const Mlp& m,
                                           const float* store, int cnt,
                                           int rows, float* part, bool add) {
  for (int l = 0; l < m.n; ++l) {
    const int K = m.dims[l], N = m.dims[l + 1];
    const float* h = store + q.ho[l];
    const float* g = store + q.go[l];
    float* dW = part + m.woff[l];
    float* db = dW + (size_t)K * N;
    const bool vec = N % 4 == 0 && ((uintptr_t)dW & 15) == 0;
    const int nct = (N + 3) / 4, nkb = (K + 3) / 4;
    for (int t = threadIdx.x; t < nct * nkb; t += kThreads) {
      const int c = t % nct, k0 = (t / nct) * 4;
      float acc[4][4] = {};
      for (int st = 0; st < cnt; ++st) {
        const float* hs = h + st * q.sst;
        const float* gs = g + st * q.sst;
#pragma unroll
        for (int r = 0; r < R; ++r) {
          if (r >= rows) break;
          float hv[4], gv[4];
#pragma unroll
          for (int i = 0; i < 4; ++i)
            hv[i] = k0 + i < K ? hs[r * K + k0 + i] : 0.0f;
          if (vec) {
            const float4 v =
                *reinterpret_cast<const float4*>(gs + r * N + 4 * c);
            gv[0] = v.x;
            gv[1] = v.y;
            gv[2] = v.z;
            gv[3] = v.w;
          } else {
#pragma unroll
            for (int j = 0; j < 4; ++j)
              gv[j] = c + nct * j < N ? gs[r * N + c + nct * j] : 0.0f;
          }
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j)
              acc[i][j] = fmaf(hv[i], gv[j], acc[i][j]);
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (k0 + i >= K) break;
        if (vec) {
          float4* o = reinterpret_cast<float4*>(dW + (size_t)(k0 + i) * N +
                                                4 * c);
          float4 v = make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
          if (add) {
            const float4 w = *o;
            v = make_float4(w.x + v.x, w.y + v.y, w.z + v.z, w.w + v.w);
          }
          *o = v;
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            if (c + nct * j >= N) continue;
            float* o = dW + (size_t)(k0 + i) * N + c + nct * j;
            *o = add ? *o + acc[i][j] : acc[i][j];
          }
        }
      }
    }
    for (int n = threadIdx.x; n < N; n += kThreads) {
      float acc = 0.0f;
      for (int st = 0; st < cnt; ++st)
        for (int r = 0; r < rows; ++r) acc += g[st * q.sst + r * N + n];
      db[n] = add ? db[n] + acc : acc;
    }
  }
}

// One stage-exact reverse step on the block's `rows` rows. lam (shared,
// R x d): the incoming covector; stage i's values at ys + i * ys_step (the
// block's first row: K3's device-memory trajectory, K12's shared stage
// values; K5's stored trial). lam_prev (device memory, the block's first
// row) or null. part: the block's dW/db partial (m.wtotal floats), written
// whole, or added to (`add`: a loop kernel's block past its first row tile
// or trial). stage_ops: stage inv and J here where the plan keeps them
// resident (K3); K4's, K5's and K12's are staged already. Ends with a
// barrier.
template <int R, bool kCoherent = false>
__device__ __forceinline__ void reverse_step(
    const RevPlan& q, const Mlp& m, const Tableau& tb, const float* J,
    const float* inv, const float* lam, const float* ys, size_t ys_step,
    float* lam_prev, float* part, int rows, float sign, bool stage_ops,
    bool add, float* smem) {
  const int d = m.dims[0];
  const int s = tb.s;
  const int n = m.n;
  const int tile = R * d;
  float* xis = smem + q.o_xi;
  float* u = smem + q.o_u;
  float* pv = smem + q.o_pv;
  float* qb = smem + q.o_q;
  float* store = smem + q.o_st;
  float* red = smem + q.o_red;
  float* ops = smem + q.o_op;  // inv, then J, when resident
  float* ring = smem + q.o_ring;
  const float* invop = q.resident ? ops : inv;
  const float* Jop = q.resident ? ops + round4(d * q.ld_op) : J;

  // the stages a covector into kI (umask) or kE (emask) reaches
  unsigned umask = 0, emask = 0;
  for (int i = s - 1; i >= 0; --i) {
    bool hu = tb.nzbI[i], he = tb.nzbE[i];
    for (int mm = i + 1; mm < s; ++mm) {
      if (!(((umask | emask) >> mm) & 1u)) continue;
      hu = hu || tb.nzI[mm][i];
      he = he || tb.nzE[mm][i];
    }
    umask |= (unsigned)hu << i;
    emask |= (unsigned)he << i;
  }
  const int last_mlp = emask ? __ffs((int)emask) - 1 : -1;

  if (stage_ops && q.resident) {
    copy_cols(ops, q.ld_op, inv, d, d, 0, d);
    copy_cols(ops + round4(d * q.ld_op), q.ld_op, J, d, d, 0, d);
    cp_async_commit();
  }
  RevRing rg;
  ring_start<kCoherent>(q, m, emask, &rg, ring);
  float* lp = lam_prev != nullptr ? smem + q.o_lp : nullptr;
  if (lp != nullptr)
    for (int e = threadIdx.x; e < rows * d; e += kThreads) lp[e] = lam[e];
  cp_async_wait<0>();
  __syncthreads();
  mark(kMarkStaged);

  int cnt = 0;         // stage slots of the store in use
  bool flushed = add;  // the partial holds what the next flush adds to
  for (int i = s - 1; i >= 0; --i) {
    const bool has_u = (umask >> i) & 1u, has_uh = (emask >> i) & 1u;
    if (!has_u && !has_uh) continue;
    const bool implicit = tb.nzI[i][i];
    float* slot = store + cnt * q.sst;
    float* gseed = slot + q.go[n - 1];  // g_{n-1} = sign uh_i

    // covectors, in the reference's order (lam term, then m ascending)
    for (int e = threadIdx.x; e < rows * d; e += kThreads) {
      float au = 0.0f, auh = 0.0f;
      if (tb.nzbI[i]) au = tb.cbI[i] * lam[e];
      if (tb.nzbE[i]) auh = tb.cbE[i] * lam[e];
      for (int mm = i + 1; mm < s; ++mm) {
        if (!(((umask | emask) >> mm) & 1u)) continue;
        if (tb.nzI[mm][i]) au = au + tb.cI[mm][i] * xis[mm * tile + e];
        if (tb.nzE[mm][i]) auh = auh + tb.cE[mm][i] * xis[mm * tile + e];
      }
      u[e] = au;
      if (has_uh) {
        gseed[e] = sign * auh;  // backprop seed of f_EX = sign * MLP
        slot[q.ho[0] + e] = ys[i * ys_step + e];
      }
    }
    __syncthreads();
    mark(kMarkCovec);

    bool has_p = false;
    if (has_u && !implicit) {
      stiff_product<R>(Jop, q.ld_op, u, rows, d, pv);
      has_p = true;
      mark(kMarkStiff);
    }
    if (has_uh) {
      for (int l = 0; l < n - 1; ++l)
        rev_forward<R, kCoherent>(q, m, emask, &rg, ring, l, slot + q.ho[l],
                                  rows, slot + q.ho[l + 1], red);
      for (int l = n - 1; l >= 0; --l)
        rev_backward<R, kCoherent>(q, m, emask, &rg, ring, l,
                                   slot + q.go[l], rows,
                                   l > 0 ? slot + q.ho[l] : nullptr,
                                   l > 0 ? slot + q.go[l - 1] : qb, red);
      for (int e = threadIdx.x; e < rows * d; e += kThreads)
        pv[e] = has_p ? pv[e] + qb[e] : qb[e];
      has_p = true;
      if (++cnt == q.nst || i == last_mlp) {
        __syncthreads();
        mark(kMarkPv);
        form_grads<R>(q, m, store, cnt, rows, part, flushed);
        flushed = true;
        cnt = 0;
        mark(kMarkGrads);
      }
    }
    __syncthreads();

    float* xi = xis + i * tile;
    if (implicit) {
      if (has_u) {
        const float inv_dtg = tb.inv_dt[i];
        for (int e = threadIdx.x; e < rows * d; e += kThreads) {
          const float c = u[e] * inv_dtg;
          u[e] = c;
          qb[e] = has_p ? c + pv[e] : c;
        }
        __syncthreads();
        stiff_product<R>(invop, q.ld_op, qb, rows, d, xi);
        for (int e = threadIdx.x; e < rows * d; e += kThreads)
          xi[e] = xi[e] - u[e];
      } else {
        stiff_product<R>(invop, q.ld_op, pv, rows, d, xi);
      }
    } else {
      for (int e = threadIdx.x; e < rows * d; e += kThreads) xi[e] = pv[e];
    }
    __syncthreads();
    mark(kMarkXi);
    if (lp != nullptr) {
      for (int e = threadIdx.x; e < rows * d; e += kThreads)
        lp[e] = lp[e] + xi[e];
      __syncthreads();
    }
  }
  if (!flushed)  // no stage reached the MLP: its gradient is zero
    for (int e = threadIdx.x; e < m.wtotal; e += kThreads) part[e] = 0.0f;
  if (lp != nullptr)
    for (int e = threadIdx.x; e < rows * d; e += kThreads)
      lam_prev[e] = lp[e];
  __syncthreads();
}

}  // namespace ark
}  // namespace pnode
