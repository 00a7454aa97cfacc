// bloom_probe: packed Bloom-filter probe for Hopper (sm_90a) — gather one
// word per (element, row) and test one bit.
//
// Replaces the TPU kernel repro/kernels/bloom_probe.py::bloom_probe
// (_kernel): words (k, W) uint32, word_idx (B, k) int32, bit_mask (B, k)
// uint32 -> hits (B, k) uint8, hits[e, f] = (words[f, word_idx[e, f]] &
// bit_mask[e, f]) != 0. An index outside [0, W) reads a clamped word, as a
// JAX gather does.
//
// What bounds it on the card: bytes — 8 B of index and mask in, one
// scattered 4 B word and 1 B out per (element, row); nothing to compute.
// The TPU kernel pinned each filter row in VMEM (hence its 8 MiB row
// limit) so that the gathers hit fast memory; the card has no such limit
// to respect: one thread per (element, row) gathers straight from device
// memory (or L2), neighbouring threads reading neighbouring index and mask
// entries and writing neighbouring hits.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__global__ void bloom_probe_kernel(const uint32_t* __restrict__ words,
                                   const int32_t* __restrict__ word_idx,
                                   const uint32_t* __restrict__ bit_mask,
                                   uint8_t* __restrict__ hits, int n, int k,
                                   long long w) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  int f = i % k;
  long long wi = word_idx[i];
  wi = wi < 0 ? 0 : (wi >= w ? w - 1 : wi);
  hits[i] = (words[f * w + wi] & bit_mask[i]) != 0u ? 1 : 0;
}

}  // namespace

// words (k, w), word_idx and bit_mask (b, k) row-major, hits (b, k).
// Launches on `stream`; returns cudaGetLastError().
extern "C" int bloom_probe_launch(const void* words, const void* word_idx,
                                  const void* bit_mask, void* hits, int b,
                                  int k, long long w, void* stream) {
  int n = b * k;
  if (n > 0) {
    int threads = 256;
    bloom_probe_kernel<<<(n + threads - 1) / threads, threads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(words),
        static_cast<const int32_t*>(word_idx),
        static_cast<const uint32_t*>(bit_mask), static_cast<uint8_t*>(hits),
        n, k, w);
  }
  return static_cast<int>(cudaGetLastError());
}
