// Shared tile functions of the fused SqueezeNext forward kernels K6 and K8
// (csrc/fused_sqnxt.cu), sm_90a, fp32 CUDA cores. The backward kernels K7
// and K9 have their own, in csrc/sqnxt_bwd.cuh.
//
// Layout: activations ride as (C, N), N = B*H*W ordered b-major, then i,
// then j (ops/fused_sqnxt.py to_cn); no pad columns. One conv layer is
//
//   z[co, n] = b[co] + sum_{t, ci} W[t, co, ci] * h[ci, n + s_t] * ok_t(n)
//
// with shift s_t in {0} (1x1), {-1, 0, 1} ((1,3), ok_t from n % W) or
// {-W, 0, W} ((3,1), ok_t from (n / W) % H): a (Cout x taps*Cin) by
// (taps*Cin x N) product whose right operand is read shifted and masked.
// Every product here is one routine: a 256-thread block computes a tile of
// at most kMaxC rows by kTileN columns, each thread 8 rows x 4 columns in
// registers, with the reduction dimension staged through shared memory in
// chunks of kChunk (A: chunk x rows, X: chunk x columns; both padded by one
// float per row so the column-strided stores do not conflict on banks).
//
// Batch statistics reduce over all N per channel, across blocks: each
// block sums its own tiles (fixed order, then a fixed shuffle tree over the
// 16 threads of a row group) into its slot of a partial buffer; one
// grid.sync() of the cooperative launch; then every block sums the slots in
// block order (each sum by one warp: lane-strided, then a fixed shuffle
// tree). No atomics: runs are bitwise repeatable, and every block holds the
// same statistics. Partial slots alternate between two buffers, so a block
// that reads one reduction's slots can never see the next one's writes
// (those need another grid.sync, which it reaches only after reading).
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace sqnxt {

namespace cg = cooperative_groups;

constexpr int kThreads = 256;
constexpr int kTileN = 64;          // columns of one tile
constexpr int kChunk = 32;          // reduction depth per shared-memory chunk
constexpr int kMaxC = 128;          // rows of one tile: channels of a layer
constexpr int kAStride = kMaxC + 1;
constexpr int kXStride = kTileN + 1;
constexpr int kMaxQ = 4;            // quantities of one row reduction
constexpr float kEps = 1e-5f;       // BatchStatsNorm eps

struct Layer {
  int cin, cout, taps, axis, single_pass;  // axis: 0 1x1, 1 j taps, 2 i taps
  const float* w;    // (taps, cout, cin)
  const float* b;    // (cout,)
  const float* gam;  // (cout,)
  const float* bet;  // (cout,)
  float* z;          // conv + bias output, the recompute anchor: (cout, N)
  float* dw;         // backward outputs, shaped as w, b, gam, bet
  float* db;
  float* dgam;
  float* dbet;
};

template <int kLayers>
struct Chain {
  Layer L[kLayers];
  int N, H, W;
  float inv_n;
};

template <int kLayers>
struct Smem {
  float mean[kLayers][kMaxC];
  float sr[kLayers][kMaxC];  // sqrt(var + eps)
  float red[kMaxQ][kMaxC];
  float A[kChunk * kAStride];
  float X[kChunk * kXStride];
};

struct Acc {
  float v[8][4];
};

__device__ __forceinline__ int tap_shift(int axis, int t, int W) {
  return axis == 0 ? 0 : (axis == 1 ? t - 1 : (t - 1) * W);
}

// Tap t's source n + s_t lies inside the image (the TPU kernel's _tap_masks).
__device__ __forceinline__ bool tap_ok(int axis, int t, int n, int H, int W) {
  if (axis == 0 || t == 1) return true;
  if (axis == 1) {
    const int j = n % W + t - 1;
    return j >= 0 && j < W;
  }
  const int i = (n / W) % H + t - 1;
  return i >= 0 && i < H;
}

// Layer l's input at (ci, n): x for the first layer, else the previous
// layer's ReLU(norm(z)) recomputed from its anchor (the TPU kernel's _act).
// Anchors are written inside the launch by other blocks: coherent loads.
template <int kLayers>
__device__ __forceinline__ float layer_input(const Chain<kLayers>& c,
                                             const Smem<kLayers>& s, int l,
                                             const float* x, int ci, int n) {
  if (l == 0) return __ldg(x + (size_t)ci * c.N + n);
  const Layer& p = c.L[l - 1];
  const float a = (__ldcg(p.z + (size_t)ci * c.N + n) - s.mean[l - 1][ci]) /
                      s.sr[l - 1][ci] * __ldg(p.gam + ci) +
                  __ldg(p.bet + ci);
  return fmaxf(a, 0.0f);
}

__device__ __forceinline__ void acc_zero(Acc& a) {
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) a.v[i][cc] = 0.0f;
}

// a.v[i][cc] += sum_kk A[kk][tr + 16 i] * X[kk][tn + 16 cc] for rows < R.
__device__ __forceinline__ void acc_chunk(Acc& a, const float* A,
                                          const float* X, int kc, int R) {
  const int tn = threadIdx.x & 15, tr = threadIdx.x >> 4;
  for (int kk = 0; kk < kc; ++kk) {
    float xv[4];
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) xv[cc] = X[kk * kXStride + tn + 16 * cc];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      if (tr + 16 * i < R) {
        const float av = A[kk * kAStride + tr + 16 * i];
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) a.v[i][cc] = fmaf(av, xv[cc], a.v[i][cc]);
      }
    }
  }
}

// Reduce each thread's per-row sums over the 16 threads of its row group
// (a fixed shuffle tree) and store this block's slot: slot[blk][q][r].
template <int Q>
__device__ __forceinline__ void write_partials(float (&acc)[Q][8], int R,
                                               float* slot) {
  const int tn = threadIdx.x & 15, tr = threadIdx.x >> 4;
#pragma unroll
  for (int q = 0; q < Q; ++q)
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      float v = acc[q][i];
      v += __shfl_xor_sync(0xffffffffu, v, 8);
      v += __shfl_xor_sync(0xffffffffu, v, 4);
      v += __shfl_xor_sync(0xffffffffu, v, 2);
      v += __shfl_xor_sync(0xffffffffu, v, 1);
      const int r = tr + 16 * i;
      if (tn == 0 && r < R)
        slot[((size_t)blockIdx.x * kMaxQ + q) * kMaxC + r] = v;
    }
}

// After a grid.sync: red[q][r] = the sum of every block's slot, in block
// order per lane, then a fixed shuffle tree (lane 0's value is stored).
__device__ __forceinline__ void sum_partials(const float* slot, int Q, int R,
                                             float* red) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int e = warp; e < Q * R; e += kThreads / 32) {
    const int q = e / R, r = e - q * R;
    float v = 0.0f;
    for (int b = lane; b < (int)gridDim.x; b += 32)
      v += __ldcg(slot + ((size_t)b * kMaxQ + q) * kMaxC + r);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v += __shfl_xor_sync(0xffffffffu, v, off);
    if (lane == 0) red[q * kMaxC + r] = v;
  }
  __syncthreads();
}

// Conv + bias of layer l over this block's tiles into the anchor z_l, with
// the per-row sums of z and z^2 written to `slot`.
template <int kLayers>
__device__ __forceinline__ void conv_layer(const Chain<kLayers>& c,
                                           Smem<kLayers>& s, int l,
                                           const float* x, float* slot) {
  const Layer& p = c.L[l];
  const int N = c.N, R = p.cout, K = p.taps * p.cin;
  const int tn = threadIdx.x & 15, tr = threadIdx.x >> 4;
  const int ntiles = (N + kTileN - 1) / kTileN;
  float part[2][8];
#pragma unroll
  for (int i = 0; i < 8; ++i) part[0][i] = part[1][i] = 0.0f;
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int n0 = tile * kTileN;
    Acc a;
    acc_zero(a);
    for (int k0 = 0; k0 < K; k0 += kChunk) {
      const int kc = min(kChunk, K - k0);
      for (int e = threadIdx.x; e < kc * R; e += kThreads) {
        const int kk = e / R, r = e - kk * R, k = k0 + kk;
        const int t = k / p.cin, ci = k - t * p.cin;
        s.A[kk * kAStride + r] = __ldg(p.w + ((size_t)t * R + r) * p.cin + ci);
      }
      for (int e = threadIdx.x; e < kc * kTileN; e += kThreads) {
        const int kk = e / kTileN, j = e - kk * kTileN, k = k0 + kk;
        const int t = k / p.cin, ci = k - t * p.cin, n = n0 + j;
        float v = 0.0f;
        if (n < N && tap_ok(p.axis, t, n, c.H, c.W))
          v = layer_input(c, s, l, x, ci, n + tap_shift(p.axis, t, c.W));
        s.X[kk * kXStride + j] = v;
      }
      __syncthreads();
      acc_chunk(a, s.A, s.X, kc, R);
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = tr + 16 * i;
      if (r >= R) continue;
      const float b = __ldg(p.b + r);
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        const int n = n0 + tn + 16 * cc;
        if (n < N) {
          const float z = a.v[i][cc] + b;
          p.z[(size_t)r * N + n] = z;
          part[0][i] += z;
          part[1][i] += z * z;
        }
      }
    }
  }
  write_partials<2>(part, R, slot);
}

// The forward chain: every layer's anchor in device memory and every
// layer's statistics in this block's shared memory, identical in all blocks.
template <int kLayers>
__device__ __forceinline__ void forward_chain(const Chain<kLayers>& c,
                                              Smem<kLayers>& s,
                                              const float* x, float* part,
                                              size_t slot_size, int& slot,
                                              cg::grid_group& grid) {
  const int N = c.N, tn = threadIdx.x & 15, tr = threadIdx.x >> 4;
  const int ntiles = (N + kTileN - 1) / kTileN;
#pragma unroll
  for (int l = 0; l < kLayers; ++l) {
    const Layer& p = c.L[l];
    float* sl = part + (size_t)(slot++ & 1) * slot_size;
    conv_layer(c, s, l, x, sl);
    grid.sync();
    sum_partials(sl, 2, p.cout, &s.red[0][0]);
    for (int r = threadIdx.x; r < p.cout; r += kThreads) {
      const float m = s.red[0][r] * c.inv_n;
      s.mean[l][r] = m;
      if (p.single_pass)
        s.sr[l][r] = sqrtf(fmaxf(s.red[1][r] * c.inv_n - m * m, 0.0f) + kEps);
    }
    __syncthreads();
    if (!p.single_pass) {  // centered variance: a second pass over z_l
      float* sl2 = part + (size_t)(slot++ & 1) * slot_size;
      float acc[1][8];
#pragma unroll
      for (int i = 0; i < 8; ++i) acc[0][i] = 0.0f;
      for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
        const int n0 = tile * kTileN;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int r = tr + 16 * i;
          if (r >= p.cout) continue;
#pragma unroll
          for (int cc = 0; cc < 4; ++cc) {
            const int n = n0 + tn + 16 * cc;
            if (n < N) {
              const float d = __ldcg(p.z + (size_t)r * N + n) - s.mean[l][r];
              acc[0][i] += d * d;
            }
          }
        }
      }
      write_partials<1>(acc, p.cout, sl2);
      grid.sync();
      sum_partials(sl2, 1, p.cout, &s.red[0][0]);
      for (int r = threadIdx.x; r < p.cout; r += kThreads)
        s.sr[l][r] = sqrtf(s.red[0][r] * c.inv_n + kEps);
      __syncthreads();
    }
  }
}

// out = ReLU(norm(z)) of the last layer over this block's tiles.
template <int kLayers>
__device__ __forceinline__ void normalize_out(const Chain<kLayers>& c,
                                              const Smem<kLayers>& s,
                                              float* out) {
  constexpr int l = kLayers - 1;
  const Layer& p = c.L[l];
  const int N = c.N, tn = threadIdx.x & 15, tr = threadIdx.x >> 4;
  const int ntiles = (N + kTileN - 1) / kTileN;
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int n0 = tile * kTileN;
    for (int i = 0; i < 8; ++i) {
      const int r = tr + 16 * i;
      if (r >= p.cout) continue;
      const float m = s.mean[l][r], sr = s.sr[l][r];
      const float gam = __ldg(p.gam + r), bet = __ldg(p.bet + r);
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        const int n = n0 + tn + 16 * cc;
        if (n < N) {
          const float a = (__ldcg(p.z + (size_t)r * N + n) - m) / sr * gam + bet;
          out[(size_t)r * N + n] = fmaxf(a, 0.0f);
        }
      }
    }
  }
}

}  // namespace sqnxt
