// K1: the whole dense stack in one kernel, forward and backward.
//
// Replaces pnode_tpu/ops/fused_mlp.py: _fwd_kernel (:75) and _bwd_kernel
// (:89), which keep every layer in the TPU's VMEM to turn ~15 small XLA
// ops per evaluation into one launch.
//
// Bound on the H100: at the KS shapes (B 256, 64 -> 104 x4 -> 64, 46,240
// parameters) one evaluation is 23.4 MFLOP against 185 KB of weights, so
// the kernel is bound by launch latency and by how fast each block streams
// the weights from L2, not by FLOPs. Design: one block per 8 batch rows,
// activations in shared memory, weights read through the read-only cache,
// fp32 FMAs. The backward recomputes the layer inputs, backprops in
// shared memory, writes a per-block dW/db partial, and a second launch
// sums the partials in block order (deterministic).
#include <cstdint>

#include "pnode_kernels.cuh"

namespace pnode {

__global__ void __launch_bounds__(kThreads)
mlp_fwd_kernel(const float* __restrict__ x, float* __restrict__ out, int B,
               Mlp p) {
  extern __shared__ float smem[];
  const int row0 = blockIdx.x * kRows;
  const int rows = min(kRows, B - row0);
  float* xin = smem;                        // kRows * dims[0]
  float* a = xin + kRows * p.dims[0];       // kRows * maxd
  float* b = a + kRows * p.maxd;            // kRows * maxd
  copy_rows(x + (size_t)row0 * p.dims[0], p.dims[0], xin, p.dims[0], rows,
            p.dims[0], 1.0f);
  __syncthreads();
  mlp_forward(p, xin, rows, a, b, out + (size_t)row0 * p.dims[p.n],
              p.dims[p.n]);
}

__global__ void __launch_bounds__(kThreads)
mlp_bwd_kernel(const float* __restrict__ x, const float* __restrict__ g,
               float* __restrict__ dx, float* __restrict__ partial, int B,
               Mlp p) {
  extern __shared__ float smem[];
  const int row0 = blockIdx.x * kRows;
  const int rows = min(kRows, B - row0);
  float* hs = smem;                 // p.htotal
  float* gA = hs + p.htotal;        // kRows * maxd
  float* gB = gA + kRows * p.maxd;  // kRows * maxd
  const int d_in = p.dims[0], d_out = p.dims[p.n];
  copy_rows(x + (size_t)row0 * d_in, d_in, hs, d_in, rows, d_in, 1.0f);
  copy_rows(g + (size_t)row0 * d_out, d_out, gA, d_out, rows, d_out, 1.0f);
  __syncthreads();
  mlp_forward_store(p, hs, rows, nullptr, 0);
  float* res = mlp_backward(p, hs, rows, gA, gB,
                            partial + (size_t)blockIdx.x * p.wtotal, true);
  copy_rows(res, d_in, dx + (size_t)row0 * d_in, d_in, rows, d_in, 1.0f);
}

static size_t mlp_fwd_smem(const Mlp& p) {
  return sizeof(float) * (size_t)(kRows * p.dims[0] + 2 * kRows * p.maxd);
}

static size_t mlp_bwd_smem(const Mlp& p) {
  return sizeof(float) * (size_t)(p.htotal + 2 * kRows * p.maxd);
}

}  // namespace pnode

using namespace pnode;

extern "C" {

const char* pnode_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// out (B, dims[n]) = MLP(x (B, dims[0])).
int pnode_mlp_fwd(const float* x, float* out, int B, int n_layers,
                  const int* dims, const void* const* Ws,
                  const void* const* bs, int act, void* stream) {
  Mlp p;
  int rc = make_mlp(&p, n_layers, dims, Ws, bs, act);
  if (rc) return rc;
  if (B < 1) return cudaErrorInvalidValue;
  const size_t smem = mlp_fwd_smem(p);
  if ((rc = prepare_smem(mlp_fwd_kernel, smem))) return rc;
  const int nblk = (B + kRows - 1) / kRows;
  mlp_fwd_kernel<<<nblk, kThreads, smem, (cudaStream_t)stream>>>(x, out, B,
                                                                  p);
  return (int)cudaGetLastError();
}

// dx (B, dims[0]) and grads ([W0, b0, W1, b1, ...], p.wtotal floats) of
// <g, MLP(x)>; partial is scratch of ceil(B / 8) * wtotal floats.
int pnode_mlp_bwd(const float* x, const float* g, float* dx, float* partial,
                  float* grads, int B, int n_layers, const int* dims,
                  const void* const* Ws, const void* const* bs, int act,
                  void* stream) {
  Mlp p;
  int rc = make_mlp(&p, n_layers, dims, Ws, bs, act);
  if (rc) return rc;
  if (B < 1) return cudaErrorInvalidValue;
  const size_t smem = mlp_bwd_smem(p);
  if ((rc = prepare_smem(mlp_bwd_kernel, smem))) return rc;
  const int nblk = (B + kRows - 1) / kRows;
  cudaStream_t st = (cudaStream_t)stream;
  mlp_bwd_kernel<<<nblk, kThreads, smem, st>>>(x, g, dx, partial, B, p);
  if ((rc = (int)cudaGetLastError())) return rc;
  launch_sum_partials(partial, nblk, p.wtotal, grads, st);
  return (int)cudaGetLastError();
}

// Dynamic shared memory of one block of the forward (backward == 0) or
// backward kernel at these widths; 0 for widths make_mlp refuses.
size_t pnode_mlp_smem(int n_layers, const int* dims, int backward) {
  const void* none[kMaxLayers] = {};
  Mlp p;
  if (make_mlp(&p, n_layers, dims, none, none, kActRelu)) return 0;
  return backward ? mlp_bwd_smem(p) : mlp_fwd_smem(p);
}

}  // extern "C"
