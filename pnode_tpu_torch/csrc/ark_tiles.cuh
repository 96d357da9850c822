// K2's body: one ARK-IMEX forward step on R batch rows per block, its
// operands staged in shared memory and its products on register tiles.
//
// csrc/pnode_kernels.cuh's ark_forward_tile (which K4 and K5 keep) takes 8
// rows per block and reads every operand element with one __ldg per k per
// thread, straight from L2, the stiff products' reads strided by K. Here:
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
//   chain over k ascending per output (C = 1 up to 256 columns), as
//   ark_forward_tile and the plain version's matmul sum them: the stage
//   derivative kI = (Y - G) / (dt aI_ii) and the error estimate built on
//   it cancel most of Y, and a split sum's other rounding there showed
//   1.6e-4 of max |err| from the plain version where the chain stays
//   under 1e-4. Every output is one fixed sum, so two calls, and any two
//   R, give the same bits.
// - The stage sums keep ark_forward_tile's order (j ascending, implicit
//   term first) and the difference quotient kI = (Y - G) / (dt aI_ii); Ys
//   keeps its (s, B, d) layout, which K3 reads.
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

// Host: the layout at R rows per block for y (B, d), s stages and the
// stack dims[0..n_layers]; false when it does not fit kMaxSmemBytes.
static inline bool plan_rows(int R, int B, int d, int s, int n_layers,
                             const int* dims, Plan* p) {
  int maxd = d, maxW = 0, red = 0;
  for (int l = 0; l < n_layers; ++l) {
    const int K = dims[l], N = dims[l + 1];
    if (N > maxd) maxd = N;
    if (K > maxd) maxd = K;
    if (K * N > maxW) maxW = K * N;
    const int g = split_k(K, N);
    if (g > 1 && g * N > red) red = g * N;
  }
  if (maxd > kMaxWidth) return false;
  *p = Plan{};
  p->rows = R;
  p->grid = (B + R - 1) / R;
  int off = 0;
  p->o_y = off;   off += round4(R * d);
  p->o_kI = off;  off += round4(s * R * d);
  p->o_kE = off;  off += round4(s * R * d);
  p->o_G = off;   off += round4(R * d);
  p->o_Y = off;   off += round4(R * d);
  p->o_a = off;   off += round4(R * maxd);
  p->o_b = off;   off += round4(R * maxd);
  p->o_red = off; off += round4(R * red);
  p->o_op = off;
  const int budget = kMaxSmemBytes / 4;
  const int ld = d | 1;
  const int op = round4(d * ld);
  const int whole = round4(maxW);
  if (off + 2 * op + 2 * whole <= budget) {
    p->resident = 1;
    p->ld_op = ld;
    p->kc_op = d;
    p->slot = whole;
    p->o_ring = off + 2 * op;
  } else {
    p->resident = 0;
    int slot = ((budget - off) / 2) & ~3;
    const int need = whole > op ? whole : op;
    if (slot > need) slot = need;
    if (slot < round4(maxd)) return false;
    p->slot = slot;
    int kc = d;  // the most k columns of every operator row n at odd stride
    while (d * (kc | 1) > slot) --kc;
    p->kc_op = kc;
    p->ld_op = kc | 1;
    p->o_ring = off;
  }
  for (int l = 0; l < n_layers; ++l) {
    const int kc = p->slot / dims[l + 1];
    p->kc[l] = kc < dims[l] ? kc : dims[l];
  }
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

// n contiguous floats, by the block: 16-byte copies where both ends are
// aligned and n is a multiple of 4, else 4-byte copies.
__device__ __forceinline__ void copy_contig(float* dst, const float* src,
                                           int n) {
  if ((((uintptr_t)dst | (uintptr_t)src) & 15) == 0 && (n & 3) == 0) {
    for (int e = 4 * threadIdx.x; e < n; e += 4 * kThreads)
      cp_async16(dst + e, src + e);
  } else {
    for (int e = threadIdx.x; e < n; e += kThreads) cp_async4(dst + e, src + e);
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

// The step's operand sequence, block-uniform: per stage, the stage
// operator (when not resident; u = -1), then W_0 .. W_{n-1}, each in
// chunks of k rows. `cur` is the chunk in flight in slot `par`.
struct Stream {
  int stage, u, k0, par;
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

__device__ __forceinline__ void stream_advance(const StepArgs& a, Stream* st) {
  int kc, K, N;
  operand_shape(a, st->u, &kc, &K, &N);
  st->k0 += kc;
  if (st->k0 < K) return;
  st->k0 = 0;
  if (++st->u == a.m.n) {
    st->u = a.p.resident ? 0 : -1;
    ++st->stage;
  }
}

// Copy chunk *st into ring slot `slot` and commit it (an empty group past
// the last chunk, so that every wait counts the same groups).
__device__ __forceinline__ void stream_issue(const StepArgs& a,
                                            const Stream& st, float* slot) {
  if (st.stage < a.tb.s) {
    int kc, K, N;
    operand_shape(a, st.u, &kc, &K, &N);
    const int kn = min(kc, K - st.k0);
    if (st.u < 0) {
      const float* op = a.tb.nzI[st.stage][st.stage] ? a.inv : a.J;
      copy_cols(slot, a.p.ld_op, op, N, K, st.k0, kn);
    } else {
      copy_contig(slot, a.m.W[st.u] + (size_t)st.k0 * N, kn * N);
    }
  }
  cp_async_commit();
}

// -- the product ------------------------------------------------------------------

// out[r * ldo + n] = scale * act(sum_k in[r * ldi + k] M(k, n) + bias[n])
// for r < rows, n < N, k < K (bias may be null), on R x C register tiles,
// k split over G thread groups (ceil(N / C) G <= kThreads).
// M is either the resident operator `res` (M(k, n) = res[n * ld_op + k]),
// or the stream's next operand, taken chunk by chunk from the ring (W
// chunks: M(k, n) = slot[(k - k0) * N + n]; operator chunks: slot[n *
// ld_op + (k - k0)]). red: the split-k partials. Ends with a barrier.
template <int R, int C>
__device__ __forceinline__ void product(const StepArgs& a, Stream* st,
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
      stream_advance(a, st);
      st->par ^= 1;
      stream_issue(a, *st, ring + st->par * a.p.slot);
    }
    if (active) {
      const int r0 = k0 % G;
      int kl = g >= r0 ? g - r0 : g - r0 + G;
      const float* mp = M + c * ldn;
      const float* ip = in + k0;
#pragma unroll 4
      for (; kl < kn; kl += G) {
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
          for (int j = 0; j < C; ++j)
            acc[r][j] = fmaf(x[r], m[j], acc[r][j]);
      }
    }
    k0 += kn;
  }

  auto post = [&](float v, int n) {
    if (bias != nullptr) v = v + __ldg(bias + n);
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

// One ARK-IMEX forward step on the block's rows row0 .. row0 + rows - 1:
// y1 (B, d) and ys (s, B, d) in device memory, err (B, d) when not null.
template <int R>
__device__ __forceinline__ void forward_step(const StepArgs& a,
                                             const float* y, float* y1,
                                             float* ys, float* err, int B,
                                             float sign, float* smem) {
  const Plan& p = a.p;
  const Tableau& tb = a.tb;
  const Mlp& m = a.m;
  const int d = m.dims[0];
  const int s = tb.s;
  const int row0 = blockIdx.x * R;
  const int rows = min(R, B - row0);
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
  copy_contig(yb, y + (size_t)row0 * d, rows * d);
  if (p.resident) {
    copy_cols(ops, p.ld_op, a.inv, d, d, 0, d);
    copy_cols(ops + opf, p.ld_op, a.J, d, d, 0, d);
  }
  cp_async_commit();
  Stream st{0, p.resident ? 0 : -1, 0, 0};
  stream_issue(a, st, ring);
  cp_async_wait<1>();
  __syncthreads();

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
    const float* res =
        p.resident ? (implicit ? ops : ops + opf) : nullptr;
    // implicit: Y = G inv^T; explicit: kI = G J^T (and Y = G); one FMA
    // chain per output
    float* so = implicit ? Yb : kIi;
    if (d <= kThreads)
      product<R, 1>(a, &st, ring, res, Gb, d, rows, d, d, 1, nullptr,
                    kActNone, 1.0f, so, d, red);
    else if (d <= 2 * kThreads)
      product<R, 2>(a, &st, ring, res, Gb, d, rows, d, d, 1, nullptr,
                    kActNone, 1.0f, so, d, red);
    else
      product<R, 4>(a, &st, ring, res, Gb, d, rows, d, d, 1, nullptr,
                    kActNone, 1.0f, so, d, red);
    const float* Yi = implicit ? Yb : Gb;
    if (implicit) {
      const float inv_dt = tb.inv_dt[i];
      for (int e = threadIdx.x; e < rows * d; e += kThreads)
        kIi[e] = (Yb[e] - Gb[e]) * inv_dt;
    }
    float* yo = ys + (size_t)i * B * d + (size_t)row0 * d;
    for (int e = threadIdx.x; e < rows * d; e += kThreads) yo[e] = Yi[e];
    // kE_i = sign * MLP(Y_i)
    const float* src = Yi;
    float* kEi = kE + i * tile;
    for (int l = 0; l < m.n; ++l) {
      const bool last = l == m.n - 1;
      float* dst = last ? kEi : ((l & 1) ? hb : ha);
      product<R, kCols>(a, &st, ring, nullptr, src, m.dims[l], rows,
                        m.dims[l], m.dims[l + 1],
                        split_k(m.dims[l], m.dims[l + 1]), m.b[l],
                        last ? kActNone : m.act, last ? sign : 1.0f, dst,
                        last ? d : m.dims[l + 1], red);
      src = dst;
    }
  }

  // y1 = y + sum_i (dt bI_i kI_i + dt bE_i kE_i), stage order; err likewise
  // from 0 with the weight differences
  float* y1o = y1 + (size_t)row0 * d;
  float* erro = err != nullptr ? err + (size_t)row0 * d : nullptr;
  for (int e = threadIdx.x; e < rows * d; e += kThreads) {
    float acc = yb[e];
    for (int i = 0; i < s; ++i) {
      if (tb.nzbI[i]) acc = acc + tb.cbI[i] * kI[i * tile + e];
      if (tb.nzbE[i]) acc = acc + tb.cbE[i] * kE[i * tile + e];
    }
    y1o[e] = acc;
    if (erro != nullptr) {
      float ea = 0.0f;
      for (int i = 0; i < s; ++i) {
        if (tb.nzerrI[i]) ea = ea + tb.cerrI[i] * kI[i * tile + e];
        if (tb.nzerrE[i]) ea = ea + tb.cerrE[i] * kE[i * tile + e];
      }
      erro[e] = ea;
    }
  }
}

}  // namespace ark
}  // namespace pnode
