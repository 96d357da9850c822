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

// ARK-IMEX tableau with every coefficient already multiplied by dt on the
// host in double precision (then rounded to fp32, as the plain PyTorch
// version rounds its Python-float coefficients). nz* keep the tableau's
// own zero pattern, so control flow does not depend on dt.
struct Tableau {
  int s;
  float cI[kMaxStages][kMaxStages];  // dt * aI
  float cE[kMaxStages][kMaxStages];  // dt * aE
  float cbI[kMaxStages];             // dt * bI
  float cbE[kMaxStages];             // dt * bE
  float inv_dt[kMaxStages];          // 1 / (dt * aI_ii), 0 when dt == 0
  unsigned char nzI[kMaxStages][kMaxStages];
  unsigned char nzE[kMaxStages][kMaxStages];
  unsigned char nzbI[kMaxStages];
  unsigned char nzbE[kMaxStages];
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

// out[r][j] = act(sum_k in[r][k] * M(k, j) + bias[j]) for r < rows, j < N.
// M(k, j) = M[k*N + j], or M[j*K + k] when trans_m (the row-vector product
// with M^T). `in` is shared memory with row stride ldi; `out` is shared or
// global memory with row stride ldo. Consecutive threads take consecutive
// columns j, so the reads of M are coalesced when !trans_m, and each
// thread reuses one M element for kRowChunk rows.
__device__ __forceinline__ void rows_matmul(
    const float* in, int ldi, int rows, int K, const float* __restrict__ M,
    bool trans_m, int N, const float* __restrict__ bias, int act, float* out,
    int ldo) {
  const int n_chunks = (rows + kRowChunk - 1) / kRowChunk;
  for (int item = threadIdx.x; item < N * n_chunks; item += blockDim.x) {
    const int j = item % N;
    const int r0 = (item / N) * kRowChunk;
    float acc[kRowChunk];
#pragma unroll
    for (int c = 0; c < kRowChunk; ++c) acc[c] = 0.0f;
    for (int k = 0; k < K; ++k) {
      const float m = trans_m ? __ldg(M + (size_t)j * K + k)
                              : __ldg(M + (size_t)k * N + j);
#pragma unroll
      for (int c = 0; c < kRowChunk; ++c)
        if (r0 + c < rows) acc[c] = fmaf(in[(r0 + c) * ldi + k], m, acc[c]);
    }
    const float bj = bias != nullptr ? __ldg(bias + j) : 0.0f;
#pragma unroll
    for (int c = 0; c < kRowChunk; ++c)
      if (r0 + c < rows) out[(r0 + c) * ldo + j] = act_fwd(acc[c] + bj, act);
  }
}

// Copy `rows` rows of width w between row-major arrays (strides ld_src,
// ld_dst), scaled by `scale`.
__device__ __forceinline__ void copy_rows(const float* src, int ld_src,
                                          float* dst, int ld_dst, int rows,
                                          int w, float scale) {
  for (int e = threadIdx.x; e < rows * w; e += blockDim.x) {
    const int r = e / w, c = e % w;
    dst[r * ld_dst + c] = scale * src[r * ld_src + c];
  }
}

// Layer inputs of the stack for the block's rows: hs + p.hoff[0] must hold
// the input rows on entry; on return hs + p.hoff[l] holds the input of
// layer l for every l. The last layer's output goes to `out` (row stride
// ldo), or is skipped when out == nullptr (backprop needs only the inputs).
__device__ __forceinline__ void mlp_forward_store(const Mlp& p, float* hs,
                                                  int rows, float* out,
                                                  int ldo) {
  for (int l = 0; l < p.n; ++l) {
    const bool last = l == p.n - 1;
    if (last && out == nullptr) break;
    float* dst = last ? out : hs + p.hoff[l + 1];
    rows_matmul(hs + p.hoff[l], p.dims[l], rows, p.dims[l], p.W[l], false,
                p.dims[l + 1], p.b[l], last ? kActNone : p.act, dst,
                last ? ldo : p.dims[l + 1]);
    __syncthreads();
  }
}

// The stack on `rows` rows of `in` (shared, stride dims[0]) with two
// ping-pong buffers a, b of kRows * maxd floats; result to `out` (ldo).
__device__ __forceinline__ void mlp_forward(const Mlp& p, const float* in,
                                            int rows, float* a, float* b,
                                            float* out, int ldo) {
  const float* src = in;
  for (int l = 0; l < p.n; ++l) {
    const bool last = l == p.n - 1;
    float* dst = last ? out : ((l & 1) ? b : a);
    rows_matmul(src, p.dims[l], rows, p.dims[l], p.W[l], false,
                p.dims[l + 1], p.b[l], last ? kActNone : p.act, dst,
                last ? ldo : p.dims[l + 1]);
    __syncthreads();
    src = dst;
  }
}

// Backprop through the stack for the block's rows. On entry gA holds the
// output covector (stride dims[n]) and hs the layer inputs from
// mlp_forward_store. Writes (overwrite) or adds (!overwrite) this block's
// partial dW/db over its rows to `part` in the [W0, b0, W1, b1, ...]
// layout. Returns the buffer (gA or gB) that holds dL/dx, stride dims[0].
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
    rows_matmul(gA, N, rows, N, p.W[l], true, K, nullptr, kActNone, gB, K);
    __syncthreads();
    float* t = gA;
    gA = gB;
    gB = t;
  }
  return gA;
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

// Host: fill a Tableau from the raw (aI s*s, aE s*s, bI s, bE s) doubles.
static inline int make_tableau(Tableau* t, int s, const double* tab,
                               double dt) {
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
    const double aii = aI[i * s + i];
    t->inv_dt[i] = (dt == 0.0 || aii == 0.0)
                       ? 0.0f
                       : static_cast<float>(1.0 / (dt * aii));
  }
  return 0;
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
