// The probe hash of the port's kernels, in one place: hashmix.cu,
// bitset_step.cu and bloom_probe.cu include it, so the three cannot drift
// apart. It is the device form of repro/core/hashing.py::hash_positions
// (the TPU kernel repro/kernels/hashmix.py::hashmix computes its flat
// layout):
//
//   flat    (n_blocks == 0): fmix32(key ^ seed_f) reduced to [0, s), by a
//           mask when s is a power of two and by % s otherwise;
//   blocked (n_blocks > 0, DESIGN §3.3): (fmix32(key ^ bseed_f) % n_blocks)
//           * 2^block_bits + (fmix32(key ^ seed_f) & (2^block_bits - 1)),
//           the product taken in 64 bits and kept to its low 32, as the
//           reference's uint32 arithmetic keeps it.
//
// Up to kMaxHashRows rows the seeds travel in the kernel's argument block
// (HashSpec, by value), so no launch loads them; past that (the reference
// takes any k >= 1) the argument block holds a pointer to them in device
// memory instead, the probe seeds then the block seeds, 2k words, and each
// read is a load. uint32_t arithmetic wraps by definition, so every
// position is bit-identical to the reference's.

#pragma once

#include <cstdint>

constexpr int kMaxHashRows = 32;

struct HashSpec {
  uint32_t seeds[kMaxHashRows];   // probe seeds, channel 0
  uint32_t bseeds[kMaxHashRows];  // block seeds, channel 1 (blocked only)
  const uint32_t* dseeds;         // k > kMaxHashRows: the probe seeds, then
                                  //   the block seeds, in device memory;
                                  //   null otherwise
  uint32_t s;                     // positions in [0, s), s in [1, 2^31]
  uint32_t n_blocks;              // 0: flat layout
  uint32_t bsize;                 // 2^block_bits (blocked only)
  int k;                          // rows, k >= 1
};

// seeds / bseeds: k host values each (bseeds may be null when n_blocks is
// 0), read for k <= kMaxHashRows; dseeds: 2k words on the card, used (and
// then required) for k > kMaxHashRows. Runs on the host, before a launch.
inline HashSpec make_hash_spec(const uint32_t* seeds, const uint32_t* bseeds,
                               const uint32_t* dseeds, int k, uint32_t s,
                               int block_bits) {
  HashSpec h{};
  h.k = k;
  h.s = s;
  if (k > kMaxHashRows) {
    h.dseeds = dseeds;
  } else {
    for (int f = 0; f < k; ++f) {
      h.seeds[f] = seeds[f];
      h.bseeds[f] = bseeds ? bseeds[f] : 0u;
    }
  }
  if (block_bits > 0) {
    h.bsize = 1u << block_bits;
    h.n_blocks = s / h.bsize > 0u ? s / h.bsize : 1u;
  }
  return h;
}

__device__ __forceinline__ uint32_t fmix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

// x reduced to [0, m): a mask for a power of two, % otherwise
__device__ __forceinline__ uint32_t reduce_to(uint32_t x, uint32_t m) {
  return (m & (m - 1u)) == 0u ? (x & (m - 1u)) : (x % m);
}

// the blocked layout's position from the probe hash x and the block hash
__device__ __forceinline__ int32_t blocked_position(uint32_t x, uint32_t xb,
                                                    const HashSpec& h) {
  uint64_t block = reduce_to(xb, h.n_blocks);
  uint64_t pos = block * h.bsize + (x & (h.bsize - 1u));
  return static_cast<int32_t>(static_cast<uint32_t>(pos));
}

// row f's probe and block seeds: from the argument block, or (kDev, for
// k > 32) from device memory. A template argument, so a launch of 32 rows
// or fewer carries no branch for the wide case.
template <bool kDev>
__device__ __forceinline__ uint32_t probe_seed(const HashSpec& h, int f) {
  if constexpr (kDev) return h.dseeds[f];
  return h.seeds[f];
}

template <bool kDev>
__device__ __forceinline__ uint32_t block_seed(const HashSpec& h, int f) {
  if constexpr (kDev) return h.dseeds[h.k + f];
  return h.bseeds[f];
}

// row f's bit position of `key`, as the int32 the reference stores; f is
// the same for every lane of a warp where the callers use it, so each seed
// read is one broadcast from the argument block (or one load)
template <bool kDev>
__device__ __forceinline__ int32_t hash_position(uint32_t key, int f,
                                                 const HashSpec& h) {
  uint32_t x = fmix32(key ^ probe_seed<kDev>(h, f));
  if (h.n_blocks == 0u) return static_cast<int32_t>(reduce_to(x, h.s));
  return blocked_position(x, fmix32(key ^ block_seed<kDev>(h, f)), h);
}
