// K13: the shared-memory probe's kernel.
//
// Replaces tools/probe_vmem_limit.py: kernel (:35), launched by try_size
// (:41), which kept x, out and a scratch copy resident in the TPU's VMEM
// under a given limit to find the largest resident set that compiles and
// runs. On Hopper the resident set that can fail is one block's dynamic
// shared memory (at most the card's opt-in limit, which the port's gates
// hard-code as 232,448 B). Each block stages its tile of `bytes` / 4 floats
// of x into dynamic shared memory as 2x, then, after a barrier, writes out
// = smem + x, reading the tile back in reverse order so that every thread
// reads what others wrote. The launch opts into `bytes` with
// cudaFuncSetAttribute(MaxDynamicSharedMemorySize); a size over the card's
// limit comes back as a failed launch, never as a wrong answer.
//
// What bounds it: device memory, 8 bytes per element (x read once, out
// written once; the second read of x hits L2). A block that takes all of
// the shared memory leaves one block per SM, so the design keeps many
// loads in flight from that one block: 1024 threads, and 16-byte loads
// (float4) where the tile and x allow them.
#include <cuda_runtime.h>

namespace {

constexpr int kProbeThreads = 1024;

__global__ void __launch_bounds__(kProbeThreads)
probe_smem_kernel(const float* __restrict__ x, float* __restrict__ out,
                  long long n, int tile) {
  extern __shared__ float smem[];
  const long long base = (long long)blockIdx.x * tile;
  if ((tile & 3) == 0 && (n & 3) == 0 &&
      ((reinterpret_cast<size_t>(x) | reinterpret_cast<size_t>(out)) & 15) ==
          0) {
    // whole float4s: base, tile and n are multiples of 4
    const int tile4 = tile / 4;
    const float4* x4 = reinterpret_cast<const float4*>(x + base);
    float4* out4 = reinterpret_cast<float4*>(out + base);
    float4* s4 = reinterpret_cast<float4*>(smem);
    for (int i = threadIdx.x; i < tile4; i += blockDim.x) {
      float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (base + 4LL * i < n) v = x4[i];
      s4[i] = make_float4(2.0f * v.x, 2.0f * v.y, 2.0f * v.z, 2.0f * v.w);
    }
    __syncthreads();
    for (int i = threadIdx.x; i < tile4; i += blockDim.x) {
      const int r = tile4 - 1 - i;
      if (base + 4LL * r < n) {
        const float4 s = s4[r], v = x4[r];
        out4[r] = make_float4(s.x + v.x, s.y + v.y, s.z + v.z, s.w + v.w);
      }
    }
    return;
  }
  for (int i = threadIdx.x; i < tile; i += blockDim.x) {
    const long long g = base + i;
    smem[i] = g < n ? 2.0f * x[g] : 0.0f;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < tile; i += blockDim.x) {
    const int r = tile - 1 - i;
    const long long g = base + r;
    if (g < n) out[g] = smem[r] + x[g];
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
