// hashmix: fused k-way murmur-mix hashing for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/hashmix.py::hashmix (_kernel), which
// the JAX step computes as core/hashing.py::hash_positions: keys (B,) ->
// positions (B, k) int32, fmix32(key ^ seed_f) reduced to [0, s) — and the
// blocked layout of DESIGN §3.3 in the same launch (hashmix.cuh holds the
// one definition of the hash that every kernel of the port uses).
//
// What bounds it on the card: latency, not bytes. It reads 4 B per key and
// writes 4 B per (key, row) — ~0.03 µs of bytes at B = 8192, k = 2 — and
// its ~10 integer operations per output are far below the card's rate;
// what is left is the launch ramp and one DRAM round trip of the keys.
// The bitset step and fused_probe compute the same positions inside their
// own launches and launch no hashmix at all; this kernel serves the
// counter family, whose sorted event lists need the positions in memory
// before the counter step runs.
//
// The design, as measured on an H100 (80 GB HBM3, 700 W), in turns with
// the L2 flushed, against the first form of this kernel (one thread per
// (key, row), the seeds loaded from device memory): on the flat layout it
// is as fast as the first form, within the spread of such a comparison.
// What it gains is the blocked layout in the same launch, which the first
// form ran as two launches and three eager ops, and no seed load: the
// seeds come in the argument block and are staged in shared memory while
// the key load is in flight (read from the argument block per lane, lanes
// of different rows asked for different words and the kernel was
// slower). One thread per key, its k positions stored together (a vector
// store), was slower too: two hashes in a row per thread, for no fewer
// round trips. Past 32 rows the seeds come from device memory (hashmix.cuh)
// and are read where they are used, not staged.

#include <cuda_runtime.h>

#include "hashmix.cuh"

namespace {

constexpr int kThreads = 256;

// kDev: k > 32, the seeds read from device memory where they are used;
// otherwise staged in shared memory from the argument block
template <bool kDev>
__global__ void hashmix_kernel(const uint32_t* __restrict__ keys,
                               int32_t* __restrict__ out, int n,
                               const HashSpec h) {
  __shared__ uint32_t seeds[2 * kMaxHashRows];  // probe, then block seeds
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int e = i / h.k;
  const uint32_t key = i < n ? keys[e] : 0u;
  if constexpr (!kDev) {
    if (threadIdx.x < h.k) {
      seeds[threadIdx.x] = h.seeds[threadIdx.x];
      seeds[kMaxHashRows + threadIdx.x] = h.bseeds[threadIdx.x];
    }
    __syncthreads();
  }
  if (i >= n) return;
  const int f = i - e * h.k;
  const uint32_t x = fmix32(key ^ (kDev ? h.dseeds[f] : seeds[f]));
  out[i] = h.n_blocks == 0u
               ? static_cast<int32_t>(reduce_to(x, h.s))
               : blocked_position(
                     x,
                     fmix32(key ^ (kDev ? h.dseeds[h.k + f]
                                        : seeds[kMaxHashRows + f])),
                     h);
}

}  // namespace

// keys (b,) uint32, out (b, k) int32 row-major; seeds
// and, for block_bits > 0, bseeds: k host values each, read for k <= 32;
// dseeds: for k > 32, the 2k seeds (probe, then block) on the card; s in
// [1, 2^31]. Launches on `stream`; returns cudaGetLastError().
extern "C" int hashmix_launch(const void* keys, void* out, int b,
                              const uint32_t* seeds, const uint32_t* bseeds,
                              const uint32_t* dseeds, int k, uint32_t s,
                              int block_bits, void* stream) {
  const long long n = static_cast<long long>(b) * k;
  if (k > kMaxHashRows && dseeds == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n > 0x7FFFFFFFLL) return static_cast<int>(cudaErrorInvalidValue);
  if (n > 0) {
    const HashSpec h = make_hash_spec(seeds, bseeds, dseeds, k, s,
                                      block_bits);
    const unsigned blocks = static_cast<unsigned>((n + kThreads - 1) /
                                                  kThreads);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (k > kMaxHashRows)
      hashmix_kernel<true><<<blocks, kThreads, 0, st>>>(
          static_cast<const uint32_t*>(keys), static_cast<int32_t*>(out),
          static_cast<int>(n), h);
    else
      hashmix_kernel<false><<<blocks, kThreads, 0, st>>>(
          static_cast<const uint32_t*>(keys), static_cast<int32_t*>(out),
          static_cast<int>(n), h);
  }
  return static_cast<int>(cudaGetLastError());
}
