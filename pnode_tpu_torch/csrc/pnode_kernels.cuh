// Shared pieces of the port's Hopper kernels (sm_90a, fp32 CUDA cores).
//
// Counterpart of what pnode_tpu/ops/fused_mlp.py supplies to the TPU's ARK
// kernels: the MLP forward, the MLP backprop, and a row-block x matrix
// product. Every kernel works on one tile of kRows batch rows per block:
// activations and stage values live in shared memory, weights and the
// stiff (d, d) operators are read from global memory (the KS stack is
// 185 KB and stays in the 50 MB L2). Every product is a plain fp32 FMA
// chain: no TF32, no bf16 -- the stiff operators (J ~ 1/dx^4) must stay at
// true fp32.
//
// Weight gradients: blocks run in parallel and in no order, so each block
// writes its own partial dW/db slice (over its rows) to a scratch buffer,
// and sum_partials_kernel adds the slices in a fixed order. The result is
// deterministic. Rows past B are masked, never padded.
#pragma once

#include <cuda_runtime.h>

#include <cmath>

namespace pnode {

constexpr int kRows = 8;        // batch rows per block
constexpr int kThreads = 256;   // threads per block
constexpr int kRowChunk = 4;    // rows one thread carries per output column
constexpr int kMaxLayers = 8;
constexpr int kMaxStages = 8;
constexpr int kMaxSmemBytes = 232448;  // 227 KB opt-in limit of one block

enum Act { kActNone = 0, kActRelu = 1, kActTanh = 2 };

// Dense stack Dense(W0,b0) -> act -> ... -> Dense(Wn-1,bn-1); W_l is
// (dims[l], dims[l+1]) row-major (the JAX package's kernel layout).
struct Mlp {
  int n;
  int act;
  int maxd;                  // max(dims)
  int wtotal;                // floats of [W0, b0, W1, b1, ...]
  int htotal;                // floats of the per-block layer-input store
  int dims[kMaxLayers + 1];
  int woff[kMaxLayers];      // offset of W_l in the [W0, b0, ...] layout
  int hoff[kMaxLayers];      // offset of layer l's input rows in smem
  const float* W[kMaxLayers];
  const float* b[kMaxLayers];
};

// ARK-IMEX tableau with every coefficient already multiplied by dt: on the
// host in double precision (then rounded to fp32, as the plain PyTorch
// version rounds its Python-float coefficients) for the step kernels, or on
// the device in fp32 (scale_tableau) where dt changes inside a launch. nz*
// keep the tableau's own zero pattern, so control flow does not depend on
// dt. The err rows are the embedded pair's weight differences b - b_err
// (nzerr* all 0 when the tableau carries no embedded pair).
struct Tableau {
  int s;
  float cI[kMaxStages][kMaxStages];  // dt * aI
  float cE[kMaxStages][kMaxStages];  // dt * aE
  float cbI[kMaxStages];             // dt * bI
  float cbE[kMaxStages];             // dt * bE
  float cerrI[kMaxStages];           // dt * (bI - bI_err)
  float cerrE[kMaxStages];           // dt * (bE - bE_err)
  float inv_dt[kMaxStages];          // 1 / (dt * aI_ii), 0 when dt == 0
  unsigned char nzI[kMaxStages][kMaxStages];
  unsigned char nzE[kMaxStages][kMaxStages];
  unsigned char nzbI[kMaxStages];
  unsigned char nzbE[kMaxStages];
  unsigned char nzerrI[kMaxStages];
  unsigned char nzerrE[kMaxStages];
};

__device__ __forceinline__ float act_fwd(float z, int act) {
  if (act == kActRelu) return fmaxf(z, 0.0f);
  if (act == kActTanh) return tanhf(z);
  return z;
}

// Derivative of the activation from its OUTPUT h = act(z): relu(z) > 0
// exactly when z > 0, and tanh'(z) = 1 - tanh(z)^2.
__device__ __forceinline__ float act_grad(float h, int act) {
  if (act == kActRelu) return h > 0.0f ? 1.0f : 0.0f;
  if (act == kActTanh) return 1.0f - h * h;
  return 1.0f;
}

// A load of a matrix or bias operand. The read-only path (__ldg, ld.global.nc)
// is valid only for data that no thread writes during the launch: the step
// kernels' weights and every kernel's stiff operators. The training loop
// (K4) rewrites its weights between iterations of one launch, so its weight
// and bias reads are coherent: __ldcg reads through L2, which every SM sees
// after a grid-wide barrier.
// kPlain: an ordinary load, for an operand in shared memory (K5 forms its
// per-trial stage inverse there).
template <bool kCoherent, bool kPlain = false>
__device__ __forceinline__ float load_operand(const float* p) {
  if constexpr (kPlain) {
    return *p;
  } else if constexpr (kCoherent) {
    return __ldcg(p);
  } else {
    return __ldg(p);
  }
}

// out[r][j] = act(sum_k in[r][k] * M(k, j) + bias[j]) for r < rows, j < N.
// M(k, j) = M[k*N + j], or M[j*K + k] when trans_m (the row-vector product
// with M^T). `in` is shared memory with row stride ldi; `out` is shared or
// global memory with row stride ldo. Consecutive threads take consecutive
// columns j, so the reads of M are coalesced when !trans_m, and each
// thread reuses one M element for kRowChunk rows. kCoherent and kPlain
// select the loads of M and bias (load_operand); M and bias carry no
// __restrict__, since K4 and K5 write them during the launch.
template <bool kCoherent = false, bool kPlain = false>
__device__ __forceinline__ void rows_matmul(
    const float* in, int ldi, int rows, int K, const float* M, bool trans_m,
    int N, const float* bias, int act, float* out, int ldo) {
  const int n_chunks = (rows + kRowChunk - 1) / kRowChunk;
  for (int item = threadIdx.x; item < N * n_chunks; item += blockDim.x) {
    const int j = item % N;
    const int r0 = (item / N) * kRowChunk;
    float acc[kRowChunk];
#pragma unroll
    for (int c = 0; c < kRowChunk; ++c) acc[c] = 0.0f;
    for (int k = 0; k < K; ++k) {
      const float m =
          trans_m ? load_operand<kCoherent, kPlain>(M + (size_t)j * K + k)
                  : load_operand<kCoherent, kPlain>(M + (size_t)k * N + j);
#pragma unroll
      for (int c = 0; c < kRowChunk; ++c)
        if (r0 + c < rows) acc[c] = fmaf(in[(r0 + c) * ldi + k], m, acc[c]);
    }
    const float bj =
        bias != nullptr ? load_operand<kCoherent, kPlain>(bias + j) : 0.0f;
#pragma unroll
    for (int c = 0; c < kRowChunk; ++c)
      if (r0 + c < rows) out[(r0 + c) * ldo + j] = act_fwd(acc[c] + bj, act);
  }
}

// Copy `rows` rows of width w between row-major arrays (strides ld_src,
// ld_dst), scaled by `scale`. kCoherent reads the source through L2
// (__ldcg): for device-memory workspaces that the same launch rewrites.
template <bool kCoherent = false>
__device__ __forceinline__ void copy_rows(const float* src, int ld_src,
                                          float* dst, int ld_dst, int rows,
                                          int w, float scale) {
  for (int e = threadIdx.x; e < rows * w; e += blockDim.x) {
    const int r = e / w, c = e % w;
    const float v = kCoherent ? __ldcg(src + r * ld_src + c)
                              : src[r * ld_src + c];
    dst[r * ld_dst + c] = scale * v;
  }
}

// Layer inputs of the stack for the block's rows: hs + p.hoff[0] must hold
// the input rows on entry; on return hs + p.hoff[l] holds the input of
// layer l for every l. The last layer's output goes to `out` (row stride
// ldo), or is skipped when out == nullptr (backprop needs only the inputs).
template <bool kCoherent = false>
__device__ __forceinline__ void mlp_forward_store(const Mlp& p, float* hs,
                                                  int rows, float* out,
                                                  int ldo) {
  for (int l = 0; l < p.n; ++l) {
    const bool last = l == p.n - 1;
    if (last && out == nullptr) break;
    float* dst = last ? out : hs + p.hoff[l + 1];
    rows_matmul<kCoherent>(hs + p.hoff[l], p.dims[l], rows, p.dims[l],
                           p.W[l], false, p.dims[l + 1], p.b[l],
                           last ? kActNone : p.act, dst,
                           last ? ldo : p.dims[l + 1]);
    __syncthreads();
  }
}

// The stack on `rows` rows of `in` (shared, stride dims[0]) with two
// ping-pong buffers a, b of kRows * maxd floats; result to `out` (ldo).
template <bool kCoherent = false>
__device__ __forceinline__ void mlp_forward(const Mlp& p, const float* in,
                                            int rows, float* a, float* b,
                                            float* out, int ldo) {
  const float* src = in;
  for (int l = 0; l < p.n; ++l) {
    const bool last = l == p.n - 1;
    float* dst = last ? out : ((l & 1) ? b : a);
    rows_matmul<kCoherent>(src, p.dims[l], rows, p.dims[l], p.W[l], false,
                           p.dims[l + 1], p.b[l], last ? kActNone : p.act,
                           dst, last ? ldo : p.dims[l + 1]);
    __syncthreads();
    src = dst;
  }
}

// Backprop through the stack for the block's rows. On entry gA holds the
// output covector (stride dims[n]) and hs the layer inputs from
// mlp_forward_store. Writes (overwrite) or adds (!overwrite) this block's
// partial dW/db over its rows to `part` in the [W0, b0, W1, b1, ...]
// layout. Returns the buffer (gA or gB) that holds dL/dx, stride dims[0].
template <bool kCoherent = false>
__device__ __forceinline__ float* mlp_backward(const Mlp& p, const float* hs,
                                               int rows, float* gA, float* gB,
                                               float* part, bool overwrite) {
  for (int l = p.n - 1; l >= 0; --l) {
    const int K = p.dims[l], N = p.dims[l + 1];
    if (l < p.n - 1) {
      const float* h = hs + p.hoff[l + 1];
      for (int e = threadIdx.x; e < rows * N; e += blockDim.x)
        gA[e] *= act_grad(h[e], p.act);
      __syncthreads();
    }
    // dW_l[k][j] = sum_r h_l[r][k] g[r][j];  db_l[j] = sum_r g[r][j]
    const float* h = hs + p.hoff[l];
    float* dW = part + p.woff[l];
    float* db = dW + (size_t)K * N;
    for (int e = threadIdx.x; e < K * N; e += blockDim.x) {
      const int k = e / N, j = e % N;
      float acc = 0.0f;
      for (int r = 0; r < rows; ++r) acc = fmaf(h[r * K + k], gA[r * N + j], acc);
      dW[e] = overwrite ? acc : dW[e] + acc;
    }
    for (int j = threadIdx.x; j < N; j += blockDim.x) {
      float acc = 0.0f;
      for (int r = 0; r < rows; ++r) acc += gA[r * N + j];
      db[j] = overwrite ? acc : db[j] + acc;
    }
    // g <- g W_l^T: the product with W_l stored (K, N), read transposed
    rows_matmul<kCoherent>(gA, N, rows, N, p.W[l], true, K, nullptr,
                           kActNone, gB, K);
    __syncthreads();
    float* t = gA;
    gA = gB;
    gB = t;
  }
  return gA;
}

// One ARK-IMEX forward step on one tile of `rows` rows (K4's and K5's;
// K2 and K12 run ark::forward_step, csrc/ark_tiles.cuh). Shared memory: y
// (the input rows), kI and kE (s tiles each of kRows * d), G (one tile), a
// and b (MLP ping-pong, kRows * maxd each). Stage value i goes to Ys + i *
// ys_step (shared memory: K4 keeps all s tiles for its reverse sweep), and,
// when ys_out != nullptr, to ys_out + i * ys_out_step (a global trajectory
// payload). y1 (row stride d) is shared or global memory; so is
// err, the embedded error estimate sum_i (dt (bI - bI_err)_i kI_i + dt (bE -
// bE_err)_i kE_i), written when err != nullptr.
// kInvPlain: `inv` lies in shared memory (K5's per-trial stage inverse).
// kStageJY: the implicit stages' derivative is kI = Y J^T, as K5 needs, not
// the difference quotient (Y - G) / (dt aI_ii) of K2 and K4: equal in exact
// arithmetic, but the quotient's fp32 cancellation puts a dt-independent
// floor under the error estimate, which stalls the adaptive controller.
template <bool kCoherent, bool kInvPlain = false, bool kStageJY = false>
__device__ __forceinline__ void ark_forward_tile(
    const Mlp& p, const Tableau& tb, float sign, const float* J,
    const float* inv, int d, int rows, const float* y, float* kI, float* kE,
    float* G, float* Ys, int ys_step, float* ys_out, size_t ys_out_step,
    float* a, float* b, float* y1, float* err = nullptr) {
  const int s = tb.s;
  const int tile = kRows * d;
  for (int i = 0; i < s; ++i) {
    // G = y + sum_{j<i} (dt aI_ij kI_j + dt aE_ij kE_j), in the reference's
    // order (j ascending, implicit term first)
    for (int e = threadIdx.x; e < rows * d; e += blockDim.x) {
      float acc = y[e];
      for (int j = 0; j < i; ++j) {
        if (tb.nzI[i][j]) acc = acc + tb.cI[i][j] * kI[j * tile + e];
        if (tb.nzE[i][j]) acc = acc + tb.cE[i][j] * kE[j * tile + e];
      }
      G[e] = acc;
    }
    __syncthreads();
    float* kIi = kI + i * tile;
    float* Yi = Ys + i * ys_step;
    if (tb.nzI[i][i]) {
      rows_matmul<false, kInvPlain>(G, d, rows, d, inv, true, d, nullptr,
                                    kActNone, Yi, d);
      __syncthreads();
      if constexpr (kStageJY) {
        rows_matmul(Yi, d, rows, d, J, true, d, nullptr, kActNone, kIi, d);
      } else {
        const float inv_dt = tb.inv_dt[i];
        for (int e = threadIdx.x; e < rows * d; e += blockDim.x)
          kIi[e] = (Yi[e] - G[e]) * inv_dt;
      }
    } else {
      rows_matmul(G, d, rows, d, J, true, d, nullptr, kActNone, kIi, d);
      copy_rows(G, d, Yi, d, rows, d, 1.0f);
    }
    __syncthreads();
    if (ys_out != nullptr)
      copy_rows(Yi, d, ys_out + i * ys_out_step, d, rows, d, 1.0f);
    float* kEi = kE + i * tile;
    mlp_forward<kCoherent>(p, Yi, rows, a, b, kEi, d);
    for (int e = threadIdx.x; e < rows * d; e += blockDim.x)
      kEi[e] = sign * kEi[e];
    __syncthreads();
  }

  // y1 = y + sum_i (dt bI_i kI_i + dt bE_i kE_i), stage order; err likewise
  // from 0 with the weight differences
  for (int e = threadIdx.x; e < rows * d; e += blockDim.x) {
    float acc = y[e];
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

// One stage-exact reverse step on one tile of `rows` rows (K4's and K5's;
// K3 and K12 run ark::reverse_step, csrc/ark_tiles.cuh; kInvPlain as in
// ark_forward_tile). lam_s: the incoming covector (shared). Stage value i
// is read from Ys + i * ys_step (K4, K5: their shared-memory stages). Shared scratch: xis (s tiles), u, uh, pv, q (one
// tile each), hs (p.htotal: recomputed layer inputs), gA and gB (kRows *
// maxd each). When lp != nullptr, lam_prev = lam + sum_i xi_i is added to
// lp (shared, holding lam on entry). The tile's dW/db go to `part` in the
// [W0, b0, W1, b1, ...] layout: overwritten at the first stage that
// reaches the MLP while first_grad is set (which clears it), added after.
template <bool kCoherent, bool kInvPlain = false>
__device__ __forceinline__ void ark_reverse_tile(
    const Mlp& p, const Tableau& tb, float sign, const float* J,
    const float* inv, int d, int rows, const float* lam_s, const float* Ys,
    size_t ys_step, float* xis, float* u, float* uh, float* pv, float* q,
    float* hs, float* gA, float* gB, float* lp, float* part,
    bool& first_grad) {
  const int s = tb.s;
  const int tile = kRows * d;
  bool active[kMaxStages] = {};
  for (int i = s - 1; i >= 0; --i) {
    bool has_u = tb.nzbI[i], has_uh = tb.nzbE[i];
    for (int m = i + 1; m < s; ++m) {
      if (!active[m]) continue;
      has_u = has_u || tb.nzI[m][i];
      has_uh = has_uh || tb.nzE[m][i];
    }
    active[i] = has_u || has_uh;
    if (!active[i]) continue;
    const bool implicit = tb.nzI[i][i];

    // covectors, in the reference's order (lam term, then m ascending)
    for (int e = threadIdx.x; e < rows * d; e += blockDim.x) {
      float au = 0.0f, auh = 0.0f;
      if (tb.nzbI[i]) au = tb.cbI[i] * lam_s[e];
      if (tb.nzbE[i]) auh = tb.cbE[i] * lam_s[e];
      for (int m = i + 1; m < s; ++m) {
        if (!active[m]) continue;
        if (tb.nzI[m][i]) au = au + tb.cI[m][i] * xis[m * tile + e];
        if (tb.nzE[m][i]) auh = auh + tb.cE[m][i] * xis[m * tile + e];
      }
      u[e] = au;
      uh[e] = sign * auh;  // backprop seed of f_EX = sign * MLP
    }
    __syncthreads();

    bool has_p = false;
    if (has_u && !implicit) {
      rows_matmul(u, d, rows, d, J, false, d, nullptr, kActNone, pv, d);
      has_p = true;
    }
    if (has_uh) {
      copy_rows(Ys + i * ys_step, d, hs, d, rows, d, 1.0f);
      copy_rows(uh, d, gA, d, rows, d, 1.0f);
      __syncthreads();
      mlp_forward_store<kCoherent>(p, hs, rows, nullptr, 0);
      const float* dyE =
          mlp_backward<kCoherent>(p, hs, rows, gA, gB, part, first_grad);
      first_grad = false;
      for (int e = threadIdx.x; e < rows * d; e += blockDim.x)
        pv[e] = has_p ? pv[e] + dyE[e] : dyE[e];
      has_p = true;
    }
    __syncthreads();

    float* xi = xis + i * tile;
    if (implicit) {
      if (has_u) {
        const float inv_dtg = tb.inv_dt[i];
        for (int e = threadIdx.x; e < rows * d; e += blockDim.x) {
          const float c = u[e] * inv_dtg;
          u[e] = c;
          q[e] = has_p ? c + pv[e] : c;
        }
        __syncthreads();
        rows_matmul<false, kInvPlain>(q, d, rows, d, inv, false, d, nullptr,
                                      kActNone, xi, d);
        __syncthreads();
        for (int e = threadIdx.x; e < rows * d; e += blockDim.x)
          xi[e] = xi[e] - u[e];
      } else {
        rows_matmul<false, kInvPlain>(pv, d, rows, d, inv, false, d, nullptr,
                                      kActNone, xi, d);
      }
    } else {
      copy_rows(pv, d, xi, d, rows, d, 1.0f);
    }
    __syncthreads();
    if (lp != nullptr) {
      for (int e = threadIdx.x; e < rows * d; e += blockDim.x)
        lp[e] = lp[e] + xi[e];
      __syncthreads();
    }
  }
}

// Adam's constants, rounded to fp32 from host doubles as the reference's
// Python floats are (K4, K5).
struct Adam {
  float lr, b1, b2, omb1, omb2, eps, ln_b1, ln_b2;
};

// Sum of v over the block in a fixed order: each warp by shuffles, then
// warp 0 over the warp sums. Returns the sum in thread 0.
__device__ __forceinline__ float block_sum(float v, float* red) {
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_down_sync(0xffffffffu, v, off);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float total = 0.0f;
  if (threadIdx.x == 0)
    for (int w = 0; w < (int)(blockDim.x / 32); ++w) total += red[w];
  __syncthreads();
  return total;
}

// The loop kernels' phase B, on every thread of a cooperative grid: for its
// slice of the flat [W0, b0, W1, b1, ...] parameters, sum the grid's block
// partials in block order (deterministic, no atomics), then optax's Adam
// update number t (counting from 1) in place:
//   m <- b1 m + (1 - b1) g;  v <- b2 v + (1 - b2) g^2
//   p <- p - lr (m / c1) / (sqrt(v / c2) + eps),  c = 1 - exp(t ln b)
__device__ __forceinline__ void sum_partials_adam(const Adam& adam, int t,
                                                  const float* partial,
                                                  int wtotal, float* params,
                                                  float* m_state,
                                                  float* v_state) {
  const float tf = (float)t;
  const float c1 = 1.0f - expf(tf * adam.ln_b1);
  const float c2 = 1.0f - expf(tf * adam.ln_b2);
  const int gtid = blockIdx.x * blockDim.x + threadIdx.x;
  const int nthreads = gridDim.x * blockDim.x;
  for (int i = gtid; i < wtotal; i += nthreads) {
    float g = 0.0f;
    for (int blk = 0; blk < (int)gridDim.x; ++blk)
      g += __ldcg(partial + (size_t)blk * wtotal + i);
    const float mi = adam.b1 * __ldcg(m_state + i) + adam.omb1 * g;
    const float vi = adam.b2 * __ldcg(v_state + i) + adam.omb2 * (g * g);
    m_state[i] = mi;
    v_state[i] = vi;
    params[i] = __ldcg(params + i) -
                adam.lr * (mi / c1) / (sqrtf(vi / c2) + adam.eps);
  }
}

// The tableau at step size dt, scaled on the device in fp32 as the JAX
// package scales it for a traced dt (fp32 dt times the coefficient rounded
// to fp32); `base` holds the coefficients at dt = 1 (make_tableau with dt
// 1.0). One thread writes `out`.
__device__ __forceinline__ void scale_tableau(const Tableau& base, float dt,
                                              Tableau* out) {
  *out = base;
  for (int i = 0; i < base.s; ++i) {
    for (int j = 0; j < base.s; ++j) {
      out->cI[i][j] = __fmul_rn(dt, base.cI[i][j]);
      out->cE[i][j] = __fmul_rn(dt, base.cE[i][j]);
    }
    out->cbI[i] = __fmul_rn(dt, base.cbI[i]);
    out->cbE[i] = __fmul_rn(dt, base.cbE[i]);
    out->cerrI[i] = __fmul_rn(dt, base.cerrI[i]);
    out->cerrE[i] = __fmul_rn(dt, base.cerrE[i]);
    out->inv_dt[i] = (dt == 0.0f || !base.nzI[i][i])
                         ? 0.0f
                         : __fdiv_rn(1.0f, __fmul_rn(dt, base.cI[i][i]));
  }
}

// out[i] = sum_b partial[b * n + i], b in order 0..nblk-1 (deterministic).
static __global__ void sum_partials_kernel(const float* __restrict__ partial,
                                           int nblk, int n,
                                           float* __restrict__ out) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += gridDim.x * blockDim.x) {
    float acc = 0.0f;
    for (int b = 0; b < nblk; ++b) acc += partial[(size_t)b * n + i];
    out[i] = acc;
  }
}

static inline void launch_sum_partials(const float* partial, int nblk, int n,
                                       float* out, cudaStream_t stream) {
  const int grid = (n + kThreads - 1) / kThreads;
  sum_partials_kernel<<<grid, kThreads, 0, stream>>>(partial, nblk, n, out);
}

// Host: fill an Mlp from the C-interface arrays. Returns 0, or
// cudaErrorInvalidValue for a configuration the kernels do not take.
static inline int make_mlp(Mlp* p, int n_layers, const int* dims,
                           const void* const* Ws, const void* const* bs,
                           int act) {
  if (n_layers < 1 || n_layers > kMaxLayers) return cudaErrorInvalidValue;
  if (act != kActRelu && act != kActTanh) return cudaErrorInvalidValue;
  p->n = n_layers;
  p->act = act;
  p->maxd = 0;
  p->wtotal = 0;
  p->htotal = 0;
  for (int l = 0; l <= n_layers; ++l) {
    if (dims[l] < 1) return cudaErrorInvalidValue;
    p->dims[l] = dims[l];
    if (dims[l] > p->maxd) p->maxd = dims[l];
  }
  for (int l = 0; l < n_layers; ++l) {
    p->W[l] = static_cast<const float*>(Ws[l]);
    p->b[l] = static_cast<const float*>(bs[l]);
    p->woff[l] = p->wtotal;
    p->wtotal += dims[l] * dims[l + 1] + dims[l + 1];
    p->hoff[l] = p->htotal;
    p->htotal += kRows * dims[l];
  }
  return 0;
}

// Host: the Mlp of a flat [W0, b0, W1, b1, ...] parameter buffer.
static inline int flat_mlp(Mlp* p, const float* params, int n_layers,
                           const int* dims, int d, int act) {
  if (n_layers < 1 || n_layers > kMaxLayers) return cudaErrorInvalidValue;
  if (dims[0] != d || dims[n_layers] != d) return cudaErrorInvalidValue;
  const void* Ws[kMaxLayers];
  const void* bs[kMaxLayers];
  size_t off = 0;
  for (int l = 0; l < n_layers; ++l) {
    Ws[l] = params + off;
    off += (size_t)dims[l] * dims[l + 1];
    bs[l] = params + off;
    off += dims[l + 1];
  }
  return make_mlp(p, n_layers, dims, Ws, bs, act);
}

// Host: fill a Tableau from the raw (aI s*s, aE s*s, bI s, bE s) doubles
// and, when err != nullptr, the embedded weights (bI_err s, bE_err s).
static inline int make_tableau(Tableau* t, int s, const double* tab,
                               double dt, const double* err = nullptr) {
  if (s < 1 || s > kMaxStages) return cudaErrorInvalidValue;
  const double* aI = tab;
  const double* aE = tab + s * s;
  const double* bI = tab + 2 * s * s;
  const double* bE = bI + s;
  *t = Tableau{};
  t->s = s;
  for (int i = 0; i < s; ++i) {
    for (int j = 0; j < s; ++j) {
      t->cI[i][j] = static_cast<float>(dt * aI[i * s + j]);
      t->cE[i][j] = static_cast<float>(dt * aE[i * s + j]);
      t->nzI[i][j] = aI[i * s + j] != 0.0;
      t->nzE[i][j] = aE[i * s + j] != 0.0;
    }
    t->cbI[i] = static_cast<float>(dt * bI[i]);
    t->cbE[i] = static_cast<float>(dt * bE[i]);
    t->nzbI[i] = bI[i] != 0.0;
    t->nzbE[i] = bE[i] != 0.0;
    if (err != nullptr) {
      // the weight differences in double, as the reference's Python floats
      const double dI = bI[i] - err[i], dE = bE[i] - err[s + i];
      t->cerrI[i] = static_cast<float>(dt * dI);
      t->cerrE[i] = static_cast<float>(dt * dE);
      t->nzerrI[i] = dI != 0.0;
      t->nzerrE[i] = dE != 0.0;
    }
    const double aii = aI[i * s + i];
    t->inv_dt[i] = (dt == 0.0 || aii == 0.0)
                       ? 0.0f
                       : static_cast<float>(1.0 / (dt * aii));
  }
  return 0;
}

// Host: Adam's constants from the reference's Python floats.
static inline Adam make_adam(float lr, double b1, double b2, double eps) {
  return Adam{lr,
              (float)b1,
              (float)b2,
              (float)(1.0 - b1),
              (float)(1.0 - b2),
              (float)eps,
              (float)std::log(b1),
              (float)std::log(b2)};
}

// Host: opt the kernel into `bytes` of dynamic shared memory when it needs
// more than the default 48 KB.
template <typename Kernel>
static inline int prepare_smem(Kernel kernel, size_t bytes) {
  if (bytes > (size_t)kMaxSmemBytes) return cudaErrorInvalidValue;
  if (bytes > 48 * 1024)
    return cudaFuncSetAttribute(kernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)bytes);
  return 0;
}

}  // namespace pnode
