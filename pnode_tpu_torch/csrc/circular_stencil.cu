// K10 and K11: the periodic k-point stencil along a row, forward and
// backward.
//
// Replaces pnode_tpu/ops/circular_stencil.py: _fwd_kernel (:32), the
// cross-correlation out[r, i] = sum_j w[j] y[r, (i + j - k/2) mod N], and
// _bwd_kernel (:41), its VJP: dy[r, i] = sum_j w[j] g[r, (i - j + k/2) mod N]
// (the flipped stencil) and dw[j] = sum_{r, i} g[r, i] y[r, (i + j - k/2)
// mod N]. On the TPU one VMEM-resident kernel replaced a chain of rolls.
//
// Bound on the H100: k multiply-adds per element against 8 bytes moved by
// the forward (y in, out out) and by dy alone (g in, dy out), 12 with dw (y
// and g in): all bound by bytes. At the Burgers stage shape (200, 512) the
// forward and dy move 0.82 MB (0.24 us at 3.35 TB/s), dy with dw 1.23 MB
// (0.37 us): less than one launch's own device time. So the design aims at
// one short launch per call, in every mode.
//
// The register tile (stencil_fwd_tile, stencil_bwd_tile: one body,
// tile_body, with the direction as a template parameter). L lanes own a row,
// L the largest power of two <= 32 dividing N/4 (a warp at N 512, a
// half-warp at N 64); lane s holds the row's float4s s + c L, c < C, so
// every load and store is a coalesced 16-byte access (C 4 at N 512: 16
// floats a lane). The k/2-wide halo on each side of a float4 is the tail of
// the float4 before it and the head of the one after, taken by __shfl_sync
// over the row's L lanes; lane 0 takes its left halo from lane L-1's chunk
// c-1 and lane L-1 its right halo from lane 0's chunk c+1 (mod C): the
// periodic wrap is that rotation. No shared memory, no barrier, no division;
// the taps are read once per thread into registers. Templated on C (1, 2,
// 4) and H = k/2 (0-4): k <= 9 keeps each halo within one neighbouring
// float4, and k may exceed N there (the taps wrap through the same
// float4s). Each output is summed over j in the plain version's order with
// unfused fp32 multiplies and adds (__fmul_rn, __fadd_rn): K10 and K11's dy
// equal the roll chain bitwise, so a Jacobian assembled through K10 equals
// one assembled from the roll chain exactly.
//
// The staged body (stencil_fwd_kernel, stencil_bwd_kernel) takes every
// other shape: N not a multiple of 4, rows longer than the register tile
// (N/4 / L above 4 or not a power of two: N 100, N > 512), k > 9, or an
// operand not 16-byte aligned. Each block stages a tile of whole rows (~1024
// elements) in shared memory (read from global memory past 48 KB) and wraps
// by index; a thread walks its elements' (row, column) without a division.
//
// dw, in the same launch on both bodies: each block sums its products per
// tap in a fixed order (lanes, then warps) into one partial per tap, which
// thread 0 writes; it then takes a ticket, one acquire-release add on a
// counter, before the block stores dy. The last block to arrive sums the
// grid's partials in a fixed order (lane-strided over the blocks, then a
// shuffle tree), writes dw and resets the counter to 0. No value is added
// atomically: dw is bitwise repeatable. The counter and the partials are
// scratch the wrapper keeps per device and stream (ops/circular_stencil.py):
// launches on one stream run one after another, so two launches in flight
// never share a counter. The tickets and the chain behind them (the last
// block's wait, its loads) cost ~1 us on the card at the stage shapes,
// however the sum is laid out: the price of one launch in place of two.
//
// One C plan (make_plan; pnode_stencil_plan, mirrored by stencil_plan in
// ops/circular_stencil.py) picks the body and the grid: the register tile
// where the shape fits and the operands are 16-byte aligned, with 8, 4, 2
// or 1 warps a block, the most that still give at least one block per SM,
// and 8 with dw (fewer tickets); the staged rows otherwise.
#include "pnode_kernels.cuh"

namespace pnode {
namespace stencil {

constexpr int kStageFloats = 12288;  // 48 KB: no opt-in needed
constexpr int kStageElems = 1024;    // elements of a staged block's rows
constexpr int kMaxStageRows = 64;
constexpr int kMaxChunks = 4;        // float4s of a row a lane holds
constexpr int kMaxHalf = 4;          // k/2 and k-1-k/2 within one float4
constexpr int kMaxTileWarps = 8;
constexpr unsigned kFull = 0xffffffffu;

struct Plan {
  int body;            // 1: the register tile, 0: the staged rows
  int rows_per_warp;   // the tile's 32 / L; 0 for the staged body
  int rows_per_block;
  int grid;
};

// Lanes per row of the register tile at row length n; 0 where it does not
// fit (N % 4, or more than kMaxChunks float4s a lane, or not a power of 2)
inline int tile_lanes(int n) {
  if (n % 4) return 0;
  const int v4 = n / 4;
  int lanes = 32;
  while (v4 % lanes) lanes >>= 1;
  const int chunks = v4 / lanes;
  return chunks <= kMaxChunks && (chunks & (chunks - 1)) == 0 ? lanes : 0;
}

inline Plan make_plan(int rows, int n, int k, bool aligned, bool need_dw,
                      int sms) {
  Plan p;
  const int lanes = aligned && k <= 2 * kMaxHalf + 1 ? tile_lanes(n) : 0;
  if (lanes) {
    p.body = 1;
    p.rows_per_warp = 32 / lanes;
    const int warps = (rows + p.rows_per_warp - 1) / p.rows_per_warp;
    int w = kMaxTileWarps;
    while (!need_dw && w > 1 && (warps + w - 1) / w < sms) w >>= 1;
    p.rows_per_block = w * p.rows_per_warp;
    p.grid = (warps + w - 1) / w;
  } else {
    const int rpb = kStageElems / n;
    p.body = 0;
    p.rows_per_warp = 0;
    p.rows_per_block = rpb < 1 ? 1 : (rpb > kMaxStageRows ? kMaxStageRows
                                                          : rpb);
    p.grid = (rows + p.rows_per_block - 1) / p.rows_per_block;
  }
  return p;
}

// The SM count of the current device, read once per device
inline int sm_count(int* sms) {
  static int cache[64];
  int dev = 0, rc;
  if ((rc = (int)cudaGetDevice(&dev))) return rc;
  if (dev < 64 && cache[dev]) {
    *sms = cache[dev];
    return 0;
  }
  if ((rc = (int)cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount,
                                        dev)))
    return rc;
  if (dev < 64) cache[dev] = *sms;
  return 0;
}

inline bool aligned16(const void* p) {
  return ((unsigned long long)p & 15ull) == 0;
}

// ((x % n) + n) % n
__host__ __device__ __forceinline__ int wrap_index(int x, int n) {
  const int r = x % n;
  return r < 0 ? r + n : r;
}

// Thread 0 of a block, once it has written the block's partials: whether
// this block is the last of the grid to arrive. One acquire-release add at
// device scope: it releases the partials this thread wrote and, in the last
// block, acquires the others' (the block's barrier then orders its other
// threads' reads after it).
__device__ __forceinline__ bool take_ticket(unsigned* ticket) {
  unsigned before;
  asm volatile("atom.acq_rel.gpu.global.add.u32 %0, [%1], 1;"
               : "=r"(before) : "l"(ticket) : "memory");
  return before == gridDim.x - 1;
}

// The last block: dw[j] = the grid's partials of tap j (tap-major:
// partial[j * gridDim.x + b]) summed in a fixed order, lane-strided over
// the blocks and then a shuffle tree, a warp a tap; the counter back to 0.
__device__ __forceinline__ void sum_dw(const float* partial,
                                       unsigned* ticket, int k, float* dw) {
  const int warps = blockDim.x >> 5, warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  for (int j = warp; j < k; j += warps) {
    float v = 0.0f;
    for (int b = lane; b < (int)gridDim.x; b += 32)
      v += __ldcg(partial + (size_t)j * gridDim.x + b);
    for (int off = 16; off > 0; off >>= 1)
      v += __shfl_xor_sync(kFull, v, off);
    if (lane == 0) dw[j] = v;
  }
  if (threadIdx.x == 0) *ticket = 0u;
}

// -- the register tile --------------------------------------------------------

struct TileArgs {
  const float* src;   // y (forward) or g (backward)
  const float* y;     // the dw pass's y
  const float* w;
  float* out;         // out (forward) or dy
  float* partial;     // dw: k partials per block, tap-major
  unsigned* ticket;   // dw: the counter, 0 between launches
  float* dw;
  int rows, n, k, lane_bits;  // L = 1 << lane_bits lanes a row
};

// Lane sub's C float4s of one row (zeros on a lane past the last row)
template <int C>
__device__ __forceinline__ void load_row(const float* row, int sub,
                                         int lane_bits, bool live,
                                         float (&x)[4 * C]) {
  const float4* r4 = reinterpret_cast<const float4*>(row);
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const float4 v = live ? __ldg(r4 + sub + (c << lane_bits))
                          : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    x[4 * c] = v.x;
    x[4 * c + 1] = v.y;
    x[4 * c + 2] = v.z;
    x[4 * c + 3] = v.w;
  }
}

// win[t] = the row's element 4 q - H + t, t < 4 + 2 H, q = sub + c L the
// lane's float4 number c: the last H elements of float4 q - 1, float4 q,
// the first H of float4 q + 1 (mod N / 4). c is a constant after unrolling.
template <int C, int H>
__device__ __forceinline__ void window(const float (&x)[4 * C], int c,
                                       int sub, int lanes,
                                       float (&win)[4 + 2 * H]) {
  const int prev = (c + C - 1) % C, next = (c + 1) % C;
  const bool first = sub == 0, last = sub == lanes - 1;
  const int from_left = (sub - 1) & (lanes - 1);
  const int from_right = (sub + 1) & (lanes - 1);
#pragma unroll
  for (int t = 0; t < H; ++t) {
    // lane L-1 serves lane 0 its chunk c-1; lane 0 serves lane L-1 chunk c+1
    const float to_right = last ? x[4 * prev + 4 - H + t]
                                : x[4 * c + 4 - H + t];
    const float to_left = first ? x[4 * next + t] : x[4 * c + t];
    win[t] = __shfl_sync(kFull, to_right, from_left, lanes);
    win[H + 4 + t] = __shfl_sync(kFull, to_left, from_right, lanes);
  }
#pragma unroll
  for (int e = 0; e < 4; ++e) win[H + e] = x[4 * c + e];
}

// out[i] = sum_j w[j] src[i + j - H] (forward) or sum_j w[j] src[i - j + H]
// (kBack: dy, src = g), j < k in order; with kDw also dw.
template <int C, int H, bool kBack, bool kDw>
__device__ __forceinline__ void tile_body(const TileArgs& a) {
  constexpr int kTaps = 2 * H + 1;  // k is kTaps or kTaps - 1
  const int lanes = 1 << a.lane_bits;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int sub = lane & (lanes - 1);
  const int row = ((blockIdx.x * (blockDim.x >> 5) + warp)
                   << (5 - a.lane_bits)) + (lane >> a.lane_bits);
  const bool live = row < a.rows;
  const bool odd = a.k == kTaps;
  const size_t base = live ? (size_t)row * a.n : 0;
  float taps[kTaps];
#pragma unroll
  for (int j = 0; j < kTaps; ++j)
    taps[j] = (j < kTaps - 1 || odd) ? __ldg(a.w + j) : 0.0f;
  float x[4 * C], yv[kDw ? 4 * C : 1];
  load_row<C>(a.src + base, sub, a.lane_bits, live, x);
  if constexpr (kDw) load_row<C>(a.y + base, sub, a.lane_bits, live, yv);
  float s[kTaps];  // dw: this lane's sum of products per tap
#pragma unroll
  for (int j = 0; j < kTaps; ++j) s[j] = 0.0f;
  float o[4 * C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    float win[4 + 2 * H];
    window<C, H>(x, c, sub, lanes, win);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      // forward: tap j reads element i + j - H = win[e + j]; backward:
      // i - j + H = win[e + 2 H - j]
      float acc = __fmul_rn(taps[0], win[kBack ? e + 2 * H : e]);
#pragma unroll
      for (int j = 1; j < kTaps; ++j)
        if (j < kTaps - 1 || odd)
          acc = __fadd_rn(acc, __fmul_rn(taps[j],
                                         win[kBack ? e + 2 * H - j : e + j]));
      o[4 * c + e] = acc;
    }
    if constexpr (kDw) {
      // dw[j] += g[i] y[i + j - H]
      float yw[4 + 2 * H];
      window<C, H>(yv, c, sub, lanes, yw);
#pragma unroll
      for (int e = 0; e < 4; ++e)
#pragma unroll
        for (int j = 0; j < kTaps; ++j)
          if (j < kTaps - 1 || odd) s[j] = fmaf(x[4 * c + e], yw[e + j], s[j]);
    }
  }
  bool last = false;
  if constexpr (kDw) {
    // the block's partial per tap (lanes, then warps, in order); thread 0
    // writes them and takes the ticket before it stores its outputs, so its
    // fence waits on the partials alone
    __shared__ float red[kMaxTileWarps][kTaps];
    __shared__ bool is_last;
#pragma unroll
    for (int j = 0; j < kTaps; ++j) {
      float v = s[j];
      for (int off = 16; off > 0; off >>= 1)
        v += __shfl_xor_sync(kFull, v, off);
      if (lane == 0) red[warp][j] = v;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      for (int j = 0; j < a.k; ++j) {
        float v = 0.0f;
        for (int wi = 0; wi < (int)(blockDim.x >> 5); ++wi) v += red[wi][j];
        a.partial[(size_t)j * gridDim.x + blockIdx.x] = v;
      }
      is_last = take_ticket(a.ticket);
    }
    __syncthreads();
    last = is_last;
  }
  if (live) {
    float4* out4 = reinterpret_cast<float4*>(a.out + base);
#pragma unroll
    for (int c = 0; c < C; ++c)
      out4[sub + (c << a.lane_bits)] = make_float4(
          o[4 * c], o[4 * c + 1], o[4 * c + 2], o[4 * c + 3]);
  }
  if (last) sum_dw(a.partial, a.ticket, a.k, a.dw);
}

template <int C, int H>
__global__ void __launch_bounds__(32 * kMaxTileWarps)
stencil_fwd_tile(const TileArgs a) {
  tile_body<C, H, false, false>(a);
}

template <int C, int H, bool kDw>
__global__ void __launch_bounds__(32 * kMaxTileWarps)
stencil_bwd_tile(const TileArgs a) {
  tile_body<C, H, true, kDw>(a);
}

template <bool kBack, bool kDw, int C, int H>
void launch_tile_ch(const Plan& p, const TileArgs& a, cudaStream_t st) {
  const int threads = 32 * (p.rows_per_block / p.rows_per_warp);
  if constexpr (kBack)
    stencil_bwd_tile<C, H, kDw><<<p.grid, threads, 0, st>>>(a);
  else
    stencil_fwd_tile<C, H><<<p.grid, threads, 0, st>>>(a);
}

template <bool kBack, bool kDw, int C>
int launch_tile_c(const Plan& p, const TileArgs& a, cudaStream_t st) {
  switch (a.k / 2) {
    case 0: launch_tile_ch<kBack, kDw, C, 0>(p, a, st); break;
    case 1: launch_tile_ch<kBack, kDw, C, 1>(p, a, st); break;
    case 2: launch_tile_ch<kBack, kDw, C, 2>(p, a, st); break;
    case 3: launch_tile_ch<kBack, kDw, C, 3>(p, a, st); break;
    case 4: launch_tile_ch<kBack, kDw, C, 4>(p, a, st); break;
    default: return cudaErrorInvalidValue;
  }
  return 0;
}

template <bool kBack, bool kDw>
int launch_tile(const Plan& p, const TileArgs& a, cudaStream_t st) {
  switch ((a.n / 4) >> a.lane_bits) {
    case 1: return launch_tile_c<kBack, kDw, 1>(p, a, st);
    case 2: return launch_tile_c<kBack, kDw, 2>(p, a, st);
    case 4: return launch_tile_c<kBack, kDw, 4>(p, a, st);
    default: return cudaErrorInvalidValue;
  }
}

inline int lane_bits_of(const Plan& p) {
  int bits = 0;  // rows per warp = 32 >> lane bits
  while ((32 >> bits) != p.rows_per_warp) ++bits;
  return bits;
}

// -- the staged rows ----------------------------------------------------------

// (row, column) of element e = threadIdx.x + t blockDim.x of rows of n,
// advanced one stride at a time without a division
struct RowWalk {
  int r, i, dr, di, n;
  __device__ explicit RowWalk(int n_) : n(n_) {
    r = threadIdx.x / n;
    i = threadIdx.x - r * n;
    dr = blockDim.x / n;
    di = blockDim.x - dr * n;
  }
  __device__ void next() {
    r += dr;
    i += di;
    if (i >= n) {
      i -= n;
      ++r;
    }
  }
};

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
  RowWalk at(n);
  for (int e = threadIdx.x; e < count; e += blockDim.x, at.next()) {
    const float* row = src + at.r * n;
    int p = at.i + start;
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
                   float* __restrict__ partial, unsigned* ticket,
                   float* __restrict__ dw, int rows, int n, int k, int rpb,
                   int need_dw) {
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
  RowWalk at(n);
  for (int e = threadIdx.x; e < count; e += blockDim.x, at.next()) {
    const float* row = gs + at.r * n;
    int p = at.i + back;
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
    RowWalk el(n);
    for (int e = threadIdx.x; e < count; e += blockDim.x, el.next()) {
      int p = el.i + off;
      if (p >= n) p -= n;
      acc = fmaf(gs[e], ys[el.r * n + p], acc);
    }
    const float s = block_sum(acc, red);
    if (threadIdx.x == 0) partial[(size_t)j * gridDim.x + blockIdx.x] = s;
  }
  __shared__ bool is_last;
  if (threadIdx.x == 0) is_last = take_ticket(ticket);
  __syncthreads();
  if (is_last) sum_dw(partial, ticket, k, dw);
}

}  // namespace stencil
}  // namespace pnode

using namespace pnode;
using namespace pnode::stencil;

extern "C" {

// The plan at (rows, n, k) on the current device, the operands 16-byte
// aligned or not, with or without dw: out[0..4) = body (1 register tile, 0
// staged), rows per warp, rows per block, grid.
int pnode_stencil_plan(int rows, int n, int k, int aligned, int need_dw,
                       int* out) {
  if (rows < 1 || n < 1 || k < 1) return cudaErrorInvalidValue;
  int sms = 0, rc;
  if ((rc = sm_count(&sms))) return rc;
  const Plan p = make_plan(rows, n, k, aligned != 0, need_dw != 0, sms);
  out[0] = p.body;
  out[1] = p.rows_per_warp;
  out[2] = p.rows_per_block;
  out[3] = p.grid;
  return 0;
}

// out (rows, n) = stencil(y (rows, n), w (k)): one launch.
int pnode_stencil_fwd(const float* y, const float* w, float* out, int rows,
                      int n, int k, void* stream) {
  if (rows < 1 || n < 1 || k < 1) return cudaErrorInvalidValue;
  int sms = 0, rc;
  if ((rc = sm_count(&sms))) return rc;
  const Plan p = make_plan(rows, n, k, aligned16(y) && aligned16(out), false,
                           sms);
  cudaStream_t st = (cudaStream_t)stream;
  if (p.body) {
    const TileArgs a{y, nullptr, w, out, nullptr, nullptr, nullptr,
                     rows, n, k, lane_bits_of(p)};
    if ((rc = launch_tile<false, false>(p, a, st))) return rc;
  } else {
    const int rpb = p.rows_per_block;
    const size_t floats = (size_t)(rpb < rows ? rpb : rows) * n;
    if (floats <= (size_t)kStageFloats)
      stencil_fwd_kernel<true><<<p.grid, kThreads, floats * sizeof(float),
                                 st>>>(y, w, out, rows, n, k, rpb);
    else
      stencil_fwd_kernel<false><<<p.grid, kThreads, 0, st>>>(y, w, out, rows,
                                                             n, k, rpb);
  }
  return (int)cudaGetLastError();
}

// dy (rows, n) of <g, stencil(y, w)> and, when need_dw, dw (k): one launch.
// scratch (scratch_floats 4-byte words, needed only with need_dw): the
// counter in word 0, 0 between launches, and from word 4 k partials per
// block of the plan's grid.
int pnode_stencil_bwd(const float* y, const float* g, const float* w,
                      float* dy, float* dw, float* scratch,
                      long long scratch_floats, int rows, int n, int k,
                      int need_dw, void* stream) {
  if (rows < 1 || n < 1 || k < 1) return cudaErrorInvalidValue;
  int sms = 0, rc;
  if ((rc = sm_count(&sms))) return rc;
  const bool aligned = aligned16(g) && aligned16(dy)
                       && (!need_dw || aligned16(y));
  const Plan p = make_plan(rows, n, k, aligned, need_dw != 0, sms);
  if (need_dw && scratch_floats < 4 + (long long)k * p.grid)
    return cudaErrorInvalidValue;
  unsigned* ticket = reinterpret_cast<unsigned*>(scratch);
  float* partial = need_dw ? scratch + 4 : nullptr;
  cudaStream_t st = (cudaStream_t)stream;
  if (p.body) {
    const TileArgs a{g, y, w, dy, partial, ticket, dw,
                     rows, n, k, lane_bits_of(p)};
    rc = need_dw ? launch_tile<true, true>(p, a, st)
                 : launch_tile<true, false>(p, a, st);
    if (rc) return rc;
  } else {
    const int rpb = p.rows_per_block;
    const size_t floats =
        (size_t)(need_dw ? 2 : 1) * (rpb < rows ? rpb : rows) * n;
    if (floats <= (size_t)kStageFloats)
      stencil_bwd_kernel<true><<<p.grid, kThreads, floats * sizeof(float),
                                 st>>>(y, g, w, dy, partial, ticket, dw, rows,
                                       n, k, rpb, need_dw);
    else
      stencil_bwd_kernel<false><<<p.grid, kThreads, 0, st>>>(
          y, g, w, dy, partial, ticket, dw, rows, n, k, rpb, need_dw);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
