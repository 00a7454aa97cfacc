// scatter_delta: OR-union of bit masks into a packed (k, W) delta, for
// Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/scatter_delta.py::scatter_delta
// (_kernel): word_idx (B, k) int32, bit_mask (B, k) uint32 -> delta (k, W)
// uint32, delta[f, w] = OR of bit_mask[e, f] over the e with
// word_idx[e, f] == w. Lanes whose index lies outside [0, W) (the -1 of
// ops.scatter_or, the >= W of the reference's padding) are dropped.
//
// What bounds it on the card: bytes — the (k, W) delta must be written
// whole (the wrapper zero-fills it), against 8 B of index and mask per
// (element, row) and one scattered read-modify-write each. The TPU has no
// fast scatter, so its kernel rebuilt the scatter as O(B·W) dense
// compare-broadcast work with a tree-OR over the batch. Hopper has a
// native 32-bit atomicOr: one thread per (element, row) ORs its mask into
// its word. OR does not depend on order, so the result is exact.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__global__ void scatter_delta_kernel(const int32_t* __restrict__ word_idx,
                                     const uint32_t* __restrict__ bit_mask,
                                     uint32_t* __restrict__ delta, int n,
                                     int k, long long w) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  long long wi = word_idx[i];
  uint32_t m = bit_mask[i];
  if (wi < 0 || wi >= w || m == 0u) return;
  atomicOr(&delta[(i % k) * w + wi], m);
}

}  // namespace

// word_idx and bit_mask (b, k) row-major; delta (k, w), zeroed by the
// caller. Launches on `stream`; returns cudaGetLastError().
extern "C" int scatter_delta_launch(const void* word_idx,
                                    const void* bit_mask, void* delta, int b,
                                    int k, long long w, void* stream) {
  int n = b * k;
  if (n > 0) {
    int threads = 256;
    scatter_delta_kernel<<<(n + threads - 1) / threads, threads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(word_idx),
        static_cast<const uint32_t*>(bit_mask),
        static_cast<uint32_t*>(delta), n, k, w);
  }
  return static_cast<int>(cudaGetLastError());
}
