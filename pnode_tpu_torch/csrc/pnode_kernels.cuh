// Shared pieces of the port's Hopper kernels (sm_90a, fp32 CUDA cores):
// the MLP stack and ARK tableau descriptors, the activations, Adam, the
// block sum, the ordered sum of per-block partials, and the host helpers
// that fill the descriptors and opt a kernel into its shared memory. The
// ARK bodies themselves are csrc/ark_tiles.cuh's.
//
// Every product is a plain fp32 FMA chain: no TF32, no bf16 -- the stiff
// operators (J ~ 1/dx^4) must stay at true fp32. Weight gradients: blocks
// run in parallel and in no order, so each block writes its own partial
// dW/db slice (over its rows) to a scratch buffer, and the slices are
// summed in a fixed order (sum_partials_kernel, sum_partials_adam). The
// result is deterministic. Rows past B are masked, never padded.
#pragma once

#include <cuda_runtime.h>

#include <cmath>

namespace pnode {

constexpr int kThreads = 256;   // threads per block
constexpr int kMaxLayers = 8;
constexpr int kMaxStages = 8;
constexpr int kMaxSmemBytes = 232448;  // 227 KB opt-in limit of one block

enum Act { kActNone = 0, kActRelu = 1, kActTanh = 2 };

// Dense stack Dense(W0,b0) -> act -> ... -> Dense(Wn-1,bn-1); W_l is
// (dims[l], dims[l+1]) row-major (the JAX package's kernel layout).
struct Mlp {
  int n;
  int act;
  int wtotal;                // floats of [W0, b0, W1, b1, ...]
  int dims[kMaxLayers + 1];
  int woff[kMaxLayers];      // offset of W_l in the [W0, b0, ...] layout
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

// Adam's bias corrections c1, c2 = 1 - exp(t ln b) at update number t.
__device__ __forceinline__ void adam_corrections(const Adam& adam, int t,
                                                 float* c1, float* c2) {
  const float tf = (float)t;
  *c1 = 1.0f - expf(tf * adam.ln_b1);
  *c2 = 1.0f - expf(tf * adam.ln_b2);
}

// optax's Adam update of one parameter p with moments m, v and gradient g,
// in place:
//   m <- b1 m + (1 - b1) g;  v <- b2 v + (1 - b2) g^2
//   p <- p - lr (m / c1) / (sqrt(v / c2) + eps)
__device__ __forceinline__ void adam_step(const Adam& adam, float c1,
                                          float c2, float g, float& m,
                                          float& v, float& p) {
  m = adam.b1 * m + adam.omb1 * g;
  v = adam.b2 * v + adam.omb2 * (g * g);
  p = p - adam.lr * (m / c1) / (sqrtf(v / c2) + adam.eps);
}

// The loop kernels' phase B, on every thread of a cooperative grid: for its
// slice of the flat [W0, b0, W1, b1, ...] parameters, sum the grid's block
// partials (block b's at partial + b * slice) in block order
// (deterministic, no atomics), then Adam's update number t (counting from
// 1) in place (adam_step; moments and parameters read through L2: other
// SMs wrote them in the launch).
__device__ __forceinline__ void sum_partials_adam(const Adam& adam, int t,
                                                  const float* partial,
                                                  int wtotal, int slice,
                                                  float* params,
                                                  float* m_state,
                                                  float* v_state) {
  float c1, c2;
  adam_corrections(adam, t, &c1, &c2);
  const int gtid = blockIdx.x * blockDim.x + threadIdx.x;
  const int nthreads = gridDim.x * blockDim.x;
  for (int i = gtid; i < wtotal; i += nthreads) {
    float g = 0.0f;
    for (int blk = 0; blk < (int)gridDim.x; ++blk)
      g += __ldcg(partial + (size_t)blk * slice + i);
    float m = __ldcg(m_state + i), v = __ldcg(v_state + i);
    float p = __ldcg(params + i);
    adam_step(adam, c1, c2, g, m, v, p);
    m_state[i] = m;
    v_state[i] = v;
    params[i] = p;
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
  p->wtotal = 0;
  for (int l = 0; l <= n_layers; ++l) {
    if (dims[l] < 1) return cudaErrorInvalidValue;
    p->dims[l] = dims[l];
  }
  for (int l = 0; l < n_layers; ++l) {
    p->W[l] = static_cast<const float*>(Ws[l]);
    p->b[l] = static_cast<const float*>(bs[l]);
    p->woff[l] = p->wtotal;
    p->wtotal += dims[l] * dims[l + 1] + dims[l + 1];
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

// Host: a cooperative launch of `kernel` (`threads` a block, `smem` bytes
// of dynamic shared memory) on `grid` blocks, after checking that the
// device takes one and that every block is co-resident (so a grid-wide
// barrier cannot deadlock): the loop kernels' (K4, K5) and the grid form's
// (K2, K3, K4, K12; csrc/ark_grid.cuh).
template <typename Kernel>
static inline int launch_cooperative(Kernel kernel, int grid, size_t smem,
                                     void** args, cudaStream_t stream,
                                     int threads = kThreads) {
  int dev = 0, coop = 0, sms = 0, per_sm = 0, rc;
  if ((rc = (int)cudaGetDevice(&dev))) return rc;
  if ((rc = (int)cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch,
                                        dev)))
    return rc;
  if (!coop) return cudaErrorNotSupported;
  if ((rc = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                        dev)))
    return rc;
  if ((rc = prepare_smem(kernel, smem))) return rc;
  if ((rc = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kernel, threads, smem)))
    return rc;
  if (grid > per_sm * sms) return cudaErrorCooperativeLaunchTooLarge;
  if ((rc = (int)cudaLaunchCooperativeKernel((const void*)kernel, dim3(grid),
                                             dim3(threads), args, smem,
                                             stream)))
    return rc;
  return (int)cudaGetLastError();
}

}  // namespace pnode
