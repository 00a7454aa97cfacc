// bloom_probe and fused_probe: the packed Bloom-filter probe for Hopper
// (sm_90a) — gather one word per (element, row) and test one bit.
//
// bloom_probe replaces the TPU kernel repro/kernels/bloom_probe.py::
// bloom_probe (_kernel): words (k, W) uint32, word_idx (B, k) int32,
// bit_mask (B, k) uint32 -> hits (B, k) uint8, hits[e, f] = (words[f,
// word_idx[e, f]] & bit_mask[e, f]) != 0. An index outside [0, W) reads a
// clamped word, as a JAX gather does.
//
// fused_probe is repro/kernels/ops.py::fused_probe — hashmix, the split
// into word index and mask, bloom_probe and the AND over the k rows, which
// the reference runs as two kernels with XLA glue between — as one launch:
// keys (B,) -> hits (B, k) uint8, dup (B,) bool and pos (B, k) int32. Its
// positions come from hashmix.cuh, the port's one definition of the hash.
//
// What bounds both on the card: latency, not bytes (8 B of operands and
// one scattered 4 B word in, 1 B out per (element, row): ~0.06 µs at
// B = 8192, k = 2). What is left is the launch ramp and the chain of
// dependent DRAM round trips: the operand load, then the word gather. The
// TPU kernel pinned each filter row in VMEM (hence its 8 MiB row limit) so
// that the gathers hit fast memory; the card has no such limit to respect.
//
// bloom_probe takes one thread per (element, row), neighbouring threads
// reading neighbouring index and mask entries and writing neighbouring
// hits. One thread per element — its k index/mask pairs read with one
// vector load, all its gathers issued before any test — was built and
// held equal to it, and was not faster on an H100 (80 GB HBM3, 700 W) in
// turns: the chain keeps its two round trips.
//
// fused_probe's chain is shorter: the key load, then the gathers, the
// hash in registers between them. One thread takes one key: it hashes its
// k rows, issues up to 8 gathers before it tests any bit, writes its hits
// and positions, and ANDs its hits into dup. It replaces four launches of
// the reference's form (hashmix, the split's elementwise kernels,
// bloom_probe, the AND) and a round trip of the positions.

#include <cuda_runtime.h>

#include "hashmix.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kGathers = 8;  // gathers in flight per thread

__device__ __forceinline__ long long clamp_index(long long wi, long long w) {
  return wi < 0 ? 0 : (wi >= w ? w - 1 : wi);
}

__global__ void bloom_probe_kernel(const uint32_t* __restrict__ words,
                                   const int32_t* __restrict__ word_idx,
                                   const uint32_t* __restrict__ bit_mask,
                                   uint8_t* __restrict__ hits, int n, int k,
                                   long long w) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  int f = i % k;
  long long wi = clamp_index(word_idx[i], w);
  hits[i] = (words[f * w + wi] & bit_mask[i]) != 0u ? 1 : 0;
}

template <bool kDev>  // k > 32: the seeds from device memory
__global__ void fused_probe_kernel(const uint32_t* __restrict__ words,
                                   const uint32_t* __restrict__ keys,
                                   uint8_t* __restrict__ hits,
                                   uint8_t* __restrict__ dup,
                                   int32_t* __restrict__ pos, int b,
                                   long long w, const HashSpec h) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= b) return;
  const int k = h.k;
  const uint32_t key = keys[e];
  const long long base = static_cast<long long>(e) * k;
  bool all = true;
  for (int f0 = 0; f0 < k; f0 += kGathers) {
    uint32_t word[kGathers];
    int32_t p[kGathers];
#pragma unroll
    for (int j = 0; j < kGathers; ++j) {
      if (f0 + j < k) {
        p[j] = hash_position<kDev>(key, f0 + j, h);
        word[j] = words[static_cast<long long>(f0 + j) * w +
                        clamp_index(static_cast<long long>(p[j]) >> 5, w)];
      }
    }
#pragma unroll
    for (int j = 0; j < kGathers; ++j) {
      if (f0 + j < k) {
        const bool hit = (word[j] >> (p[j] & 31)) & 1u;
        hits[base + f0 + j] = hit;
        pos[base + f0 + j] = p[j];
        all = all && hit;
      }
    }
  }
  dup[e] = all;
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

// words (k, w); keys (b,); hits (b, k) uint8, dup (b,) bool, pos (b, k)
// int32; seeds: k host values, read for k <= 32; dseeds: for k > 32, the k
// seeds on the card; s in [1, 2^31]. Launches on `stream`; returns
// cudaGetLastError().
extern "C" int fused_probe_launch(const void* words, const void* keys,
                                  void* hits, void* dup, void* pos, int b,
                                  long long w, const uint32_t* seeds,
                                  const uint32_t* dseeds, int k, uint32_t s,
                                  void* stream) {
  if (k > kMaxHashRows && dseeds == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  if (b > 0 && k > 0) {
    const HashSpec h = make_hash_spec(seeds, nullptr, dseeds, k, s, 0);
    const int blocks = (b + kThreads - 1) / kThreads;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    auto* kernel = k > kMaxHashRows ? fused_probe_kernel<true>
                                    : fused_probe_kernel<false>;
    kernel<<<blocks, kThreads, 0, st>>>(
        static_cast<const uint32_t*>(words),
        static_cast<const uint32_t*>(keys), static_cast<uint8_t*>(hits),
        static_cast<uint8_t*>(dup), static_cast<int32_t*>(pos), b, w, h);
  }
  return static_cast<int>(cudaGetLastError());
}
