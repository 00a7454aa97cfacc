// hashmix: fused k-way murmur-mix hashing for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/hashmix.py::hashmix (_kernel), which
// the JAX step computes as core/hashing.py::hash_positions:
//   pos[e, f] = fmix32(keys[e] ^ seeds[f]) reduced to [0, s) by a mask when
//   s is a power of two and by % s otherwise, stored as int32.
//
// What bounds it on the card: bytes. It reads 4 B per key and writes
// 4 B per (key, row); its ~10 integer operations per output are far below
// the card's rate. The TPU kernel tiled the batch in 2048-key VMEM blocks;
// here one thread computes one (key, row) output, neighbouring threads
// write neighbouring int32 outputs (coalesced stores), and the k-fold
// re-read of each key hits L1. uint32_t arithmetic wraps by definition, so
// the result is bit-identical to the reference's wrapping uint32.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ uint32_t fmix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

__global__ void hashmix_kernel(const uint32_t* __restrict__ keys,
                               const uint32_t* __restrict__ seeds,
                               int32_t* __restrict__ out, int n, int k,
                               uint32_t s, int pow2) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  int e = i / k;
  int f = i - e * k;
  uint32_t x = fmix32(keys[e] ^ seeds[f]);
  out[i] = static_cast<int32_t>(pow2 ? (x & (s - 1u)) : (x % s));
}

}  // namespace

// keys (b,) and seeds (k,) uint32, out (b, k) int32 row-major; s in
// [1, 2^31]. Launches on `stream`; returns cudaGetLastError().
extern "C" int hashmix_launch(const void* keys, const void* seeds, void* out,
                              int b, int k, uint32_t s, void* stream) {
  int n = b * k;
  if (n > 0) {
    int threads = 256;
    int blocks = (n + threads - 1) / threads;
    int pow2 = (s & (s - 1u)) == 0u;
    hashmix_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(keys), static_cast<const uint32_t*>(seeds),
        static_cast<int32_t*>(out), n, k, s, pow2);
  }
  return static_cast<int>(cudaGetLastError());
}
