// The bitset-family step for Hopper (sm_90a): probe, decide, R = (A & ~D) | I
// and the exact per-row load delta, for rsbf, bsbf, bsbfsd and rlbsbf.
//
// Replaces the TPU kernel repro/kernels/fused_template.py::
// _make_bitset_kernel_step (inner `kernel`). Same outputs, bit for bit:
// the updated (k, W) words, dup (B,), inserted (B,) and the load (k,).
//
// The probe positions are hashed here, from the keys (hashmix.cuh, the
// port's one definition of the hash): (A) hashes each key in registers
// and (C) hashes it again rather than reading a stored position, so the
// step launches no hashmix and its positions never travel through device
// memory. (C)'s loads of ins[e] and key[e] are independent, so its chain
// is one load and the atomic.
//
// Why not the TPU design. The TPU kernel keeps the filter in VMEM and
// sweeps all of it every batch, building the update words by
// compare-broadcast tree-ORs, O(B·W) work: at the paper's 256 MB table that
// is >= 512 MiB of traffic per 8192-key batch. What bounds this step on the
// card is memory traffic, so it touches only the words the batch needs: the
// B·k probe words, the deleted and the inserted words.
//
// Snapshot order. The TPU's one sequential program gave probe-before-update
// for free; CTAs here run concurrently, so the step is three launches in
// stream order:
//   (A) probe + decide — reads the words and the batch-entry load only;
//       writes dup, inserted and a per-element bitmask of rows to delete;
//   (B) deletes — old = atomicAnd(&w[f][dw], ~dm);
//   (C) inserts — old = atomicOr(&w[f][iw], im).
// Every probe reads A, every delete precedes every insert (insertions win).
//
// What bounds it: latency, not bytes. Each launch is a small grid (32 or
// 32·k blocks at B = 8192) doing one or two dependent scattered accesses
// per thread: ~8.4 µs per 256 MB rlbsbf step on an H100 against a ~0.07 µs
// byte bound. One cooperative launch of a persistent grid, with grid-wide
// barriers between the three phases, was built and held equal to this
// design, and measured slower on the same H100 (80 GB HBM3, 700 W), in
// turns on the same inputs: 9.1 against 8.4 µs per rlbsbf 256 MB step,
// 10.1 against 8.8 µs per 32 x 8 MB fleet step. A grid barrier costs about
// what the ramp of the launch it replaces does, and the gap between two
// launches is not device time; so the step stays three launches.
//
// Exact load from the atomics' return values. A cleared bit is seen set by
// exactly one atomicAnd, so (B) counts popcount(A & D); a set bit is seen
// clear by exactly one atomicOr, so (C) counts popcount(I & ~(A & ~D)). The
// difference is popcount(I & ~A) - popcount(A & D & ~I), the reference's
// delta. Each block reduces its count (__syncthreads_count) and adds it
// with one integer atomic: order-independent, so bit-exact.
//
// Tenant axis (DESIGN §4.6). A fleet of T filters is one launch of each
// phase: words (T, k, W), per-element operands (T, C) and (T, C, k), load
// (T, k). The grid's y axis (z for (B) and (C)) is the tenant, so a block
// works inside one tenant's row and its load reduce goes to that row. Past
// the 65535 those axes hold, the grids are one-dimensional with the
// tenant folded into x (block g of (A) works on tenant g / nb, nb the
// blocks per row of C elements; (B) and (C) fold the (tenant, row) pair),
// so a fleet of any size fits, as in counter_step.cu. The fold is a
// template instance of its own: folded in every case, the step measured
// 3% slower on an H100 (80 GB HBM3, 700 W) at the rlbsbf 256 MB and 32 x
// 8 MB fleet shapes, the two divisions on every thread's way to its first
// load. The reference vmaps its kernel over T; tenants' rows are disjoint,
// so the three phases keep snapshot order for all tenants at once. One
// filter is T = 1.
//
// Any k. (A) records the rows to delete as bits of ceil(k / 32) words per
// element. Rows 0-31 of the probe's clear-bit mask stay in a register;
// the words past them (k > 32 only) are parked in the element's delete
// words until the decision overwrites them. That path is a template
// instance too: its first form, with the k <= 32 decision written as the
// one-word case of the word loop, measured 2% slower in (A) at k = 2 on
// the same H100.
//
// Decisions divide in float32 with __fdiv_rn/__int2float_rn (IEEE
// round-to-nearest, as the reference's f32 division); do not build with
// fast-math. Lanes that are invalid or not inserted touch no word.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

#include "hashmix.cuh"

namespace {

constexpr int kThreads = 256;

enum Variant { RSBF = 0, BSBF = 1, BSBFSD = 2, RLBSBF = 3 };

struct StepArgs {
  uint32_t* words;        // (T, k, W) filters, updated in place
  long long w;            // words per row
  int k, t, b;            // b: elements per tenant (the slot width C)
  int nw;                 // delete-mask words per element: ceil(k / 32)
  int nb;                 // blocks per tenant row of b elements
  const uint32_t* keys;   // (T, B) keys hashed in (A) and (C)
  const int32_t* del_pos; // (T, B, k) candidate delete positions
  const uint8_t* valid;   // (T, B) bool
  const uint8_t* seen;    // (T, B) bool — an equal key earlier in the row
  const int32_t* i_t;     // (T, B) 1-indexed stream positions
  const float* u_bern;    // (T, B) rsbf phase-2 uniforms
  const float* u_aux;     // (T, B, k) rlbsbf per-row uniforms
  const int32_t* which;   // (T, B) bsbfsd row
  const int32_t* load_in; // (T, k) batch-entry load
  int32_t* load_out;      // (T, k) = load_in on entry; atomics add deltas
  uint8_t* dup;           // (T, B) bool
  uint8_t* ins;           // (T, B) bool
  uint32_t* del_rows;     // (T, B, nw): bit f % 32 of word f / 32 set:
                          //   delete row f
  int variant;
  int s;                  // bits per row
  float s_f;              // float32(s)
  float p_star;           // float32(p*)
  HashSpec h;             // seeds, s and layout of the probe hash
};

// row f's probe / insert position of a key
template <bool kWide>
__device__ __forceinline__ uint32_t position(const StepArgs& a, uint32_t key,
                                             int f) {
  return static_cast<uint32_t>(hash_position<kWide>(key, f, a.h));
}

// the bits of rows [32c, min(k, 32c + 32))
__device__ __forceinline__ uint32_t rows_mask(int k, int c) {
  const int n = min(k - 32 * c, 32);
  return n == 32 ? 0xFFFFFFFFu : ((1u << n) - 1u);
}

// Both template arguments select index math, so the common case (fewer
// than 65536 tenants, k <= 32) runs without the wide cases' work:
//   kFolded: the grid is one-dimensional with the tenant (and, in (B) and
//            (C), the row) folded into blockIdx.x — a fleet of more than
//            65535 tenants, past what a grid's y and z axes hold, found by
//            32-bit division; otherwise blockIdx.y / z carry them;
//   kWide:   k > 32 — ceil(k / 32) delete-mask words per element and the
//            seeds read from device memory.

// grid (nb, T), or nb · T blocks folded. Rows 0-31 are decided as one
// 32-bit mask; past them (kWide) each further word of rows is decided in
// its own pass, its clear-bit mask parked in the element's delete words
// meanwhile. Without kWide the extra terms fold away, leaving the body
// that decided k <= 32 before any wider k was taken.
template <bool kFolded, bool kWide>
__global__ void probe_decide(StepArgs a) {
  int i;
  long long t;
  if constexpr (kFolded) {
    const unsigned g = blockIdx.x;
    const unsigned tu = g / static_cast<unsigned>(a.nb);
    i = static_cast<int>(g - tu * a.nb) * blockDim.x + threadIdx.x;
    t = tu;
  } else {
    i = blockIdx.x * blockDim.x + threadIdx.x;
    t = blockIdx.y;
  }
  if (i >= a.b) return;
  const int k = a.k;
  const long long e = t * a.b + i;  // (T, B) index
  const uint32_t* words = a.words + t * k * a.w;
  const int32_t* load_in = a.load_in + t * k;
  uint32_t* del_out = a.del_rows + (kWide ? e * a.nw : e);
  const uint32_t key = a.keys[e];
  uint32_t zero_rows = 0;  // rows 0-31 whose probed bit is clear
  bool parked = false;     // a clear row past 31
  if constexpr (kWide)
    for (int c = 1; c < a.nw; ++c) del_out[c] = 0u;
  for (int f = 0; f < k; ++f) {
    uint32_t p = position<kWide>(a, key, f);
    uint32_t word = words[f * a.w + (p >> 5)];
    if (((word >> (p & 31u)) & 1u) == 0u) {
      if (!kWide || f < 32) {
        zero_rows |= 1u << f;
      } else {
        del_out[f >> 5] |= 1u << (f & 31);
        parked = true;
      }
    }
  }
  const int k0 = kWide ? 32 : k;  // rows in the first mask word
  const uint32_t all_rows = (k0 == 32) ? 0xFFFFFFFFu : ((1u << k0) - 1u);
  const bool valid = a.valid[e] != 0;
  const bool dup = ((zero_rows == 0u && !parked) || a.seen[e] != 0) &&
                   valid;
  const bool distinct = valid && !dup;
  bool insert = distinct;
  uint32_t del = 0;
  switch (a.variant) {
    case RSBF: {
      int it = a.i_t[e];
      float p_ins = __fdiv_rn(a.s_f, __int2float_rn(it));
      bool ph1 = it <= a.s;
      bool ph3 = p_ins <= a.p_star;
      bool bern = a.u_bern[e] < p_ins;
      insert = ph1 ? valid : (ph3 ? distinct : (distinct && bern));
      if (ph3) {
        del = insert ? zero_rows : 0u;
      } else {
        del = (!ph1 && insert) ? all_rows : 0u;
      }
      break;
    }
    case BSBF:
      del = insert ? all_rows : 0u;
      break;
    case BSBFSD: {
      int w = a.which[e];
      del = (insert && w >= 0 && w < k0 && w < k) ? (1u << w) : 0u;
      break;
    }
    case RLBSBF:
      if (insert) {
        for (int f = 0; f < k0 && f < k; ++f) {
          float p_del = __fdiv_rn(__int2float_rn(load_in[f]), a.s_f);
          if (a.u_aux[e * k + f] < p_del) del |= 1u << f;
        }
      }
      break;
  }
  a.dup[e] = dup ? 1 : 0;
  a.ins[e] = insert ? 1 : 0;
  del_out[0] = del;
  if constexpr (kWide) {
    // rows 32 and up, a word at a time, as the switch above decides
    // rows 0-31 (rsbf's phase flags recomputed from i_t)
    const int it = a.i_t[e];
    const bool ph1 = it <= a.s;
    const bool ph3 = __fdiv_rn(a.s_f, __int2float_rn(it)) <= a.p_star;
    const int w = a.variant == BSBFSD ? a.which[e] : -1;
    for (int c = 1; c < a.nw; ++c) {
      uint32_t d = 0;
      switch (a.variant) {
        case RSBF:
          if (ph3) {
            d = insert ? del_out[c] : 0u;
          } else {
            d = (!ph1 && insert) ? rows_mask(k, c) : 0u;
          }
          break;
        case BSBF:
          d = insert ? rows_mask(k, c) : 0u;
          break;
        case BSBFSD:
          d = (insert && w < k && (w >> 5) == c) ? (1u << (w & 31)) : 0u;
          break;
        case RLBSBF:
          if (insert) {
            const int f1 = min(k, 32 * c + 32);
            for (int f = 32 * c; f < f1; ++f) {
              float p_del = __fdiv_rn(__int2float_rn(load_in[f]), a.s_f);
              if (a.u_aux[e * k + f] < p_del) d |= 1u << (f & 31);
            }
          }
          break;
      }
      del_out[c] = d;
    }
  }
}

// this thread's element i, row f and tenant t in (B) and (C): grid (nb,
// k, T), or nb · k · T blocks folded
template <bool kFolded>
__device__ __forceinline__ void apply_index(const StepArgs& a, int& i,
                                            int& f, long long& t) {
  if constexpr (kFolded) {
    const unsigned g = blockIdx.x;
    const unsigned ru = g / static_cast<unsigned>(a.nb);
    i = static_cast<int>(g - ru * a.nb) * blockDim.x + threadIdx.x;
    const unsigned tu = ru / static_cast<unsigned>(a.k);
    f = static_cast<int>(ru - tu * a.k);
    t = tu;
  } else {
    i = blockIdx.x * blockDim.x + threadIdx.x;
    f = blockIdx.y;
    t = blockIdx.z;
  }
}

// row f's delete bit of element e
template <bool kWide>
__device__ __forceinline__ bool deletes(const StepArgs& a, long long e,
                                        int f) {
  if constexpr (kWide)
    return (a.del_rows[e * a.nw + (f >> 5)] >> (f & 31)) & 1u;
  return (a.del_rows[e] >> f) & 1u;
}

template <bool kFolded, bool kWide>
__global__ void apply_deletes(StepArgs a) {
  int i, f;
  long long t;
  apply_index<kFolded>(a, i, f, t);
  const long long e = t * a.b + i;
  const long long row = t * a.k + f;
  int cleared = 0;
  if (i < a.b && deletes<kWide>(a, e, f)) {
    uint32_t p = static_cast<uint32_t>(a.del_pos[e * a.k + f]);
    uint32_t m = 1u << (p & 31u);
    uint32_t old = atomicAnd(&a.words[row * a.w + (p >> 5)], ~m);
    cleared = (old & m) != 0u;
  }
  int n = __syncthreads_count(cleared);
  if (threadIdx.x == 0 && n) atomicSub(&a.load_out[row], n);
}

template <bool kFolded, bool kWide>
__global__ void apply_inserts(StepArgs a) {
  int i, f;
  long long t;
  apply_index<kFolded>(a, i, f, t);
  const long long e = t * a.b + i;
  const long long row = t * a.k + f;
  int gained = 0;
  bool insert = false;
  uint32_t key = 0;
  if (i < a.b) {  // two independent loads
    insert = a.ins[e] != 0;
    key = a.keys[e];
  }
  if (insert) {
    uint32_t p = position<kWide>(a, key, f);
    uint32_t m = 1u << (p & 31u);
    uint32_t old = atomicOr(&a.words[row * a.w + (p >> 5)], m);
    gained = (old & m) == 0u;
  }
  int n = __syncthreads_count(gained);
  if (threadIdx.x == 0 && n) atomicAdd(&a.load_out[row], n);
}

template <bool kFolded, bool kWide>
int launch(const StepArgs& a, cudaStream_t st) {
  dim3 grid1(a.nb, a.t), grid2(a.nb, a.k, a.t);
  if constexpr (kFolded) {
    const long long blocks = static_cast<long long>(a.nb) * a.k * a.t;
    if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
    grid1 = dim3(static_cast<unsigned>(static_cast<long long>(a.nb) * a.t));
    grid2 = dim3(static_cast<unsigned>(blocks));
  }
  probe_decide<kFolded, kWide><<<grid1, kThreads, 0, st>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  apply_deletes<kFolded, kWide><<<grid2, kThreads, 0, st>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  apply_inserts<kFolded, kWide><<<grid2, kThreads, 0, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// One step of T filters: launches (A), (B), (C) on `stream` in that
// order. b is the elements per tenant. load_out must hold load_in on entry.
// keys (T, b) uint32, hashed with the k host seeds (and, for block_bits >
// 0, the k host block seeds) for k <= 32, or with dseeds, the 2k seeds
// (probe, then block) on the card, for k > 32. del_rows is uint32 scratch
// of T·b·ceil(k / 32) words.
// Returns the first non-zero cudaGetLastError().
extern "C" int bitset_step_launch(
    void* words, long long w, int k, int t, int b, const void* keys,
    const uint32_t* seeds, const uint32_t* bseeds, const uint32_t* dseeds,
    int block_bits, const void* del_pos, const void* valid,
    const void* seen, const void* i_t, const void* u_bern, const void* u_aux,
    const void* which,
    const void* load_in, void* load_out, void* dup, void* ins, void* del_rows,
    int variant, int s, float s_f, float p_star, void* stream) {
  const bool wide = k > kMaxHashRows;
  if (k < 1 || (wide && dseeds == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (b <= 0 || t <= 0) return static_cast<int>(cudaGetLastError());
  StepArgs a;
  a.words = static_cast<uint32_t*>(words);
  a.w = w;
  a.k = k;
  a.t = t;
  a.b = b;
  a.nw = (k + 31) / 32;
  a.nb = (b + kThreads - 1) / kThreads;  // b is an int: nb fits
  a.keys = static_cast<const uint32_t*>(keys);
  a.del_pos = static_cast<const int32_t*>(del_pos);
  a.valid = static_cast<const uint8_t*>(valid);
  a.seen = static_cast<const uint8_t*>(seen);
  a.i_t = static_cast<const int32_t*>(i_t);
  a.u_bern = static_cast<const float*>(u_bern);
  a.u_aux = static_cast<const float*>(u_aux);
  a.which = static_cast<const int32_t*>(which);
  a.load_in = static_cast<const int32_t*>(load_in);
  a.load_out = static_cast<int32_t*>(load_out);
  a.dup = static_cast<uint8_t*>(dup);
  a.ins = static_cast<uint8_t*>(ins);
  a.del_rows = static_cast<uint32_t*>(del_rows);
  a.variant = variant;
  a.s = s;
  a.s_f = s_f;
  a.p_star = p_star;
  a.h = make_hash_spec(seeds, bseeds, dseeds, k, static_cast<uint32_t>(s),
                       block_bits);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // a grid's y and z axes hold at most 65535
  if (t > 65535 || k > 65535)
    return wide ? launch<true, true>(a, st) : launch<true, false>(a, st);
  return wide ? launch<false, true>(a, st) : launch<false, false>(a, st);
}
