// K13: the shared-memory probe's kernel.
//
// Replaces tools/probe_vmem_limit.py: kernel (:35), launched by try_size
// (:41), which kept x, out and a scratch copy resident in the TPU's VMEM
// under a given limit to find the largest resident set that compiles and
// runs. On Hopper the resident set that can fail is one block's dynamic
// shared memory (at most the card's opt-in limit, which the port's gates
// hard-code as 232,448 B). Each block takes exactly `bytes` of dynamic
// shared memory as the scratch of its tile of `bytes` / 4 floats of x,
// writes 2x into every slot of it and forms out = scratch + x. The launch
// opts into `bytes` with cudaFuncSetAttribute(MaxDynamicSharedMemorySize);
// a size over the card's limit comes back as a failed launch, never as a
// wrong answer.
//
// What bounds it: device memory, 8 bytes per element (x read once, out
// written once): 18.3 us for the probe's 132 tiles of 232,448 B on an H100
// SXM. A block that takes all of the shared memory leaves one block per
// SM, so the one block must keep the whole tile's loads in flight and
// overlap them with its stores:
// - one thread issues TMA bulk copies (cp.async.bulk, no registers or
//   instructions spent per element) of the tile into the scratch, in
//   chunks of kChunkBytes, all up front, each completing on its own
//   mbarrier;
// - the threads take the chunks in order: they wait on the chunk's
//   mbarrier, and each thread reads its two float4s of x, writes 2x over
//   them, reads that back and writes out = 2x + x over it; after
//   fence.proxy.async and a barrier, one thread stores the chunk with a
//   TMA bulk store (cp.async.bulk.global.shared::cta), while the later
//   chunks are still landing. x is read from device memory once, out
//   written once, each in bulk transfers of a chunk. Where out's alignment
//   differs from x's, the threads store out with st.global instead.
// Chunk size, device time on an H100 SXM at the probe's 132 tiles
// (PERF.md): 4 KB chunks with st.global.v4 stores 26.6 us, with
// bulk stores 24.0; 16 KB 22.6-22.7, 32 KB 22.3, 64 KB 22.3 (torch.mul(x,
// 3) 21.2-21.4 in the same calls).
// The bulk copies need 16-byte alignment on both sides, so element i of
// the tile lives in slot (i + sh) mod tile, sh being the source's
// misalignment in floats: a slot that is a multiple of 4 then has an
// aligned source. The mbarriers live in the top bytes of the scratch
// (static shared memory would lower the largest size that launches).
// What the chunks leave -- the head and tail of a tile whose size is not a
// multiple of 16 B, the barrier bytes once the chunks are done, slots past
// n -- takes plain loads and stores in the same kernel.
// (The Ampere-style cp.async would spend one instruction and one register
// address per 16 B in every thread; TMA spends one instruction per chunk.)
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kProbeThreads = 1024;
constexpr int kChunkBytes = 32768;
constexpr int kChunkFloats = kChunkBytes / 4;
constexpr int kVecs = kChunkFloats / 4 / kProbeThreads;  // float4s a thread
static_assert(kVecs * 4 * kProbeThreads == kChunkFloats,
              "a chunk is a whole number of float4s per thread");

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_inval(uint64_t* bar) {
  asm volatile("mbarrier.inval.shared::cta.b64 [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}

// The one arrival of the chunk's barrier, with the bytes its copy brings,
// then the copy itself: `bytes` (a multiple of 16) from global src to
// shared dst, both 16-byte aligned.
__device__ __forceinline__ void bulk_load(float* dst, const float* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// Wait for the barrier's first phase (the chunk has landed).
// `bytes` (a multiple of 16) from shared src to global dst, both 16-byte
// aligned, as one bulk-group store of this thread.
__device__ __forceinline__ void bulk_store(float* dst, const float* src,
                                           uint32_t bytes) {
  asm volatile(
      "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
      "cp.async.bulk.commit_group;\n" ::"l"(dst),
      "r"(smem_u32(src)), "r"(bytes)
      : "memory");
}

// This thread's bulk stores have read their shared-memory source.
__device__ __forceinline__ void bulk_store_drain() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// This thread's shared-memory writes, visible to the bulk copies that
// follow the next barrier.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_wait0(uint64_t* bar) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(0u)
        : "memory");
  }
}

__global__ void __launch_bounds__(kProbeThreads)
probe_smem_kernel(const float* __restrict__ x, float* __restrict__ out,
                  long long n, int tile) {
  extern __shared__ __align__(16) float smem[];
  const long long base = (long long)blockIdx.x * tile;
  const int valid = (int)min((long long)tile, n - base);
  const int sh = (int)((reinterpret_cast<uintptr_t>(x + base) >> 2) & 3);
  // the barriers: the top 8-byte words of the scratch, one per chunk the
  // tile could hold
  const int nbar = (tile + kChunkFloats - 1) / kChunkFloats;
  const int bar_top = (tile * 4) & ~7;                 // bytes
  const int bar_lo = bar_top - 8 * nbar;               // bytes, 8-aligned
  uint64_t* bars = reinterpret_cast<uint64_t*>(
      reinterpret_cast<char*>(smem) + bar_lo);
  // slots [a, b) take the bulk copies: aligned, below the barriers, with
  // a source element below n
  int a = (sh + 3) & ~3;
  int b = min(sh + valid, bar_lo >= 0 ? bar_lo / 4 : 0) & ~3;
  if (b <= a) a = b = 0;
  const int nch = (b - a + kChunkFloats - 1) / kChunkFloats;
  const bool vec_out = ((reinterpret_cast<uintptr_t>(out) -
                         reinterpret_cast<uintptr_t>(x)) & 15) == 0;

  if (threadIdx.x == 0) {
    for (int c = 0; c < nch; ++c) mbar_init(bars + c);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int c = 0; c < nch; ++c) {
      const int s0 = a + c * kChunkFloats;
      const int len = min(kChunkFloats, b - s0);
      bulk_load(smem + s0, x + base + (s0 - sh), 4u * len, bars + c);
    }
  }
  for (int c = 0; c < nch; ++c) {
    mbar_wait0(bars + c);
    const int s0 = a + c * kChunkFloats;
#pragma unroll
    for (int k = 0; k < kVecs; ++k) {
      const int s = s0 + 4 * (threadIdx.x + k * kProbeThreads);
      if (s >= b) break;
      float4* slot = reinterpret_cast<float4*>(smem + s);
      const float4 v = *slot;
      *slot = make_float4(2.0f * v.x, 2.0f * v.y, 2.0f * v.z, 2.0f * v.w);
      asm volatile("" ::: "memory");  // read the scratch back, not v
      const float4 w = *slot;
      const float4 o = make_float4(w.x + v.x, w.y + v.y, w.z + v.z,
                                   w.w + v.w);
      if (vec_out) {
        *slot = o;
      } else {
        float* dst = out + base + (s - sh);
        dst[0] = o.x;
        dst[1] = o.y;
        dst[2] = o.z;
        dst[3] = o.w;
      }
    }
    if (vec_out) {
      fence_proxy_async();
      __syncthreads();
      if (threadIdx.x == 0)
        bulk_store(out + base + (s0 - sh), smem + s0,
                   4u * min(kChunkFloats, b - s0));
    }
  }
  if (vec_out && threadIdx.x == 0) bulk_store_drain();
  // every chunk has landed and been read (and stored): the barrier words
  // become scratch
  __syncthreads();
  if (threadIdx.x == 0)
    for (int c = 0; c < nch; ++c) mbar_inval(bars + c);
  __syncthreads();
  // the rest, slots [0, a) and [b, tile), by plain loads: element i of slot
  // s, 0 past n (not stored)
  const int plain = a + (tile - b);
  for (int j = threadIdx.x; j < plain; j += blockDim.x) {
    const int s = j < a ? j : b + (j - a);
    const int i = (s - sh + 4 * tile) % tile;  // sh may exceed a tiny tile
    const float v = i < valid ? x[base + i] : 0.0f;
    smem[s] = 2.0f * v;
    asm volatile("" ::: "memory");
    const float w = smem[s];
    if (i < valid) out[base + i] = w + v;
  }
}

}  // namespace

extern "C" {

// The card's opt-in limit of dynamic shared memory per block, in bytes
// (cudaDevAttrMaxSharedMemoryPerBlockOptin), into *bytes.
int pnode_smem_optin(int* bytes) {
  int dev = 0, rc;
  if ((rc = (int)cudaGetDevice(&dev))) return rc;
  return (int)cudaDeviceGetAttribute(
      bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
}

// out = 3 x over n floats, through `bytes` of dynamic shared memory per
// block (a multiple of 4). Returns the launch's error, else the opt-in's;
// either way the error state is cleared, so the next launch of any kernel
// does not read this one's failure.
int pnode_probe_smem(const float* x, float* out, long long n, int bytes,
                     void* stream) {
  if (n < 1 || bytes < 4 || bytes % 4) return (int)cudaErrorInvalidValue;
  const int tile = bytes / 4;
  const long long grid = (n + tile - 1) / tile;
  if (grid > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const int attr = (int)cudaFuncSetAttribute(
      probe_smem_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  cudaGetLastError();
  probe_smem_kernel<<<(unsigned)grid, kProbeThreads, (size_t)bytes,
                      (cudaStream_t)stream>>>(x, out, n, tile);
  const int launch = (int)cudaGetLastError();
  return launch ? launch : attr;
}

}  // extern "C"
