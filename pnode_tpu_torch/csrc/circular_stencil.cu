// K10 and K11: the periodic k-point stencil along a row, forward and
// backward.
//
// Replaces pnode_tpu/ops/circular_stencil.py: _fwd_kernel (:32), the
// cross-correlation out[r, i] = sum_j w[j] y[r, (i + j - k/2) mod N], and
// _bwd_kernel (:41), its VJP: dy[r, i] = sum_j w[j] g[r, (i - j + k/2) mod N]
// (the flipped stencil) and dw[j] = sum_{r, i} g[r, i] y[r, (i + j - k/2)
// mod N]. On the TPU one VMEM-resident kernel replaced a chain of rolls.
//
// Bound on the H100: k multiply-adds per element against 8 bytes moved
// forward (y in, out out) and 12 backward (y and g in, dy out), so both are
// bound by bytes: at the Burgers stage shape (200, 512) the forward moves
// 0.82 MB (0.24 us at 3.35 TB/s) and the backward 1.23 MB (0.37 us); at
// these sizes both sit at launch latency. Design, simple first: each block
// stages a tile of whole rows (rows_per_block, ~1024 elements, chosen by the
// wrapper) in shared memory and computes its outputs with the periodic wrap
// done by index, so any N >= 1 and any k >= 1 are taken (k > N wraps more
// than once); a tile over the 48 KB default is read from global memory
// instead. Each output is summed over j in the plain version's order with
// unfused fp32 multiplies and adds (__fmul_rn, __fadd_rn): K10 and K11's dy
// equal the roll chain bitwise, so a Jacobian assembled through K10 equals
// one assembled from the roll chain exactly. dw: each block writes its k
// sums (a fixed-order block reduction) to a (blocks, k) buffer, which
// sum_partials_kernel adds in block order: no atomics, bitwise repeatable.
#include "pnode_kernels.cuh"

namespace pnode {

constexpr int kStageFloats = 12288;  // 48 KB: no opt-in needed

// ((x % n) + n) % n
__host__ __device__ __forceinline__ int wrap_index(int x, int n) {
  const int r = x % n;
  return r < 0 ? r + n : r;
}

template <bool kStaged>
__global__ void __launch_bounds__(kThreads)
stencil_fwd_kernel(const float* __restrict__ y, const float* __restrict__ w,
                   float* __restrict__ out, int rows, int n, int k, int rpb) {
  extern __shared__ float tile[];
  const int r0 = blockIdx.x * rpb;
  const int count = min(rpb, rows - r0) * n;
  const float* src = y + (size_t)r0 * n;
  if (kStaged) {
    for (int e = threadIdx.x; e < count; e += blockDim.x) tile[e] = src[e];
    __syncthreads();
    src = tile;
  }
  const int start = wrap_index(-(k / 2), n);  // tap 0 reads y[i - k/2]
  for (int e = threadIdx.x; e < count; e += blockDim.x) {
    const int r = e / n, i = e - r * n;
    const float* row = src + r * n;
    int p = i + start;
    if (p >= n) p -= n;
    float acc = __fmul_rn(__ldg(w), row[p]);
    for (int j = 1; j < k; ++j) {
      if (++p == n) p = 0;
      acc = __fadd_rn(acc, __fmul_rn(__ldg(w + j), row[p]));
    }
    out[(size_t)r0 * n + e] = acc;
  }
}

template <bool kStaged>
__global__ void __launch_bounds__(kThreads)
stencil_bwd_kernel(const float* __restrict__ y, const float* __restrict__ g,
                   const float* __restrict__ w, float* __restrict__ dy,
                   float* __restrict__ partial, int rows, int n, int k,
                   int rpb, int need_dw) {
  extern __shared__ float tile[];  // the g rows, then the y rows (dw pass)
  __shared__ float red[kThreads / 32];
  const int r0 = blockIdx.x * rpb;
  const int count = min(rpb, rows - r0) * n;
  const float* gs = g + (size_t)r0 * n;
  const float* ys = y + (size_t)r0 * n;
  if (kStaged) {
    for (int e = threadIdx.x; e < count; e += blockDim.x) {
      tile[e] = gs[e];
      if (need_dw) tile[count + e] = ys[e];
    }
    __syncthreads();
    gs = tile;
    ys = tile + count;
  }
  // dy: tap j reads g[i - j + k/2], walking left
  const int back = wrap_index(k / 2, n);
  for (int e = threadIdx.x; e < count; e += blockDim.x) {
    const int r = e / n, i = e - r * n;
    const float* row = gs + r * n;
    int p = i + back;
    if (p >= n) p -= n;
    float acc = __fmul_rn(__ldg(w), row[p]);
    for (int j = 1; j < k; ++j) {
      p = (p == 0) ? n - 1 : p - 1;
      acc = __fadd_rn(acc, __fmul_rn(__ldg(w + j), row[p]));
    }
    dy[(size_t)r0 * n + e] = acc;
  }
  if (!need_dw) return;
  // dw[j]: this block's sum of g[r, i] y[r, i + j - k/2]
  for (int j = 0; j < k; ++j) {
    const int off = wrap_index(j - k / 2, n);
    float acc = 0.0f;
    for (int e = threadIdx.x; e < count; e += blockDim.x) {
      const int r = e / n, i = e - r * n;
      int p = i + off;
      if (p >= n) p -= n;
      acc = fmaf(gs[e], ys[r * n + p], acc);
    }
    const float s = block_sum(acc, red);
    if (threadIdx.x == 0) partial[(size_t)blockIdx.x * k + j] = s;
  }
}

}  // namespace pnode

using namespace pnode;

extern "C" {

// out (rows, n) = stencil(y (rows, n), w (k)); rpb rows per block.
int pnode_stencil_fwd(const float* y, const float* w, float* out, int rows,
                      int n, int k, int rpb, void* stream) {
  if (rows < 1 || n < 1 || k < 1 || rpb < 1) return cudaErrorInvalidValue;
  const int nblk = (rows + rpb - 1) / rpb;
  const size_t floats = (size_t)(rpb < rows ? rpb : rows) * n;
  cudaStream_t st = (cudaStream_t)stream;
  if (floats <= (size_t)kStageFloats)
    stencil_fwd_kernel<true><<<nblk, kThreads, floats * sizeof(float), st>>>(
        y, w, out, rows, n, k, rpb);
  else
    stencil_fwd_kernel<false><<<nblk, kThreads, 0, st>>>(y, w, out, rows, n,
                                                         k, rpb);
  return (int)cudaGetLastError();
}

// dy (rows, n) of <g, stencil(y, w)> and, when need_dw, dw (k) through
// partial, scratch of ceil(rows / rpb) * k floats.
int pnode_stencil_bwd(const float* y, const float* g, const float* w,
                      float* dy, float* partial, float* dw, int rows, int n,
                      int k, int rpb, int need_dw, void* stream) {
  if (rows < 1 || n < 1 || k < 1 || rpb < 1) return cudaErrorInvalidValue;
  const int nblk = (rows + rpb - 1) / rpb;
  const size_t floats =
      (size_t)(need_dw ? 2 : 1) * (rpb < rows ? rpb : rows) * n;
  cudaStream_t st = (cudaStream_t)stream;
  if (floats <= (size_t)kStageFloats)
    stencil_bwd_kernel<true><<<nblk, kThreads, floats * sizeof(float), st>>>(
        y, g, w, dy, partial, rows, n, k, rpb, need_dw);
  else
    stencil_bwd_kernel<false><<<nblk, kThreads, 0, st>>>(
        y, g, w, dy, partial, rows, n, k, rpb, need_dw);
  int rc = (int)cudaGetLastError();
  if (rc || !need_dw) return rc;
  launch_sum_partials(partial, nblk, k, dw, st);
  return (int)cudaGetLastError();
}

}  // extern "C"
