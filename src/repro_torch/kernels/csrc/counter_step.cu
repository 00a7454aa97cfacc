// The counter-family step for Hopper (sm_90a): probe, decide, saturating
// subtract, then set-to-Max or saturating add on d-bit cells stored as d
// bit-planes, and the exact nonzero-cell load delta — for sbf, swbf, cms
// and hh (DESIGN §3.6-§3.8).
//
// Replaces the TPU kernel repro/kernels/fused_template.py::
// _make_counter_kernel_step (inner `kernel`), in both of its operand modes
// (delta planes and cfg.kernel_accumulate's per-event operands) and in its
// params_aware form, which the tenant fleet vmaps over T (DESIGN §4.6).
// Same outputs, bit for bit: the updated (d, W) planes, dup (B,) and the
// load, per tenant.
//
// Per event, never the whole filter. The TPU kernel keeps the planes in
// VMEM and sweeps all of (d, W) every batch against (d, W) delta planes
// that XLA scattered first: >= 1.25 GiB of traffic per 8192-key batch at
// the paper's 256 MB table. This kernel touches only the words the batch's
// events name and never builds a delta plane: ~1.6 MB of HBM traffic per
// sbf step, ~0.5 µs at 3.35 TB/s.
//
// What bounded the earlier design. Its apply ran one thread per slot of
// compacted run-head lists (n_sub = B·P = 106,496 and n_ins = B·k = 24,576
// on sbf at 256 MB), and each owner found its word's events by
// binary-searching both lists again (a third search for an insert-only
// owner): 32-49 dependent reads per thread, ~4.6 M scattered reads per
// step, ~28 µs on an H100. Around it, ~100 eager PyTorch ops per step
// compacted the run heads and clamped the run lengths (~1 ms of host
// time).
//
// This design reads the sorted int64 event lists as the step builds them
// (sentinel 32·W padded, one row per tenant) and finds every owner
// without a per-thread search:
//   (A) probe + decide, and the merge-path partition, in one launch of two
//       kinds of block that read nothing the other writes. Probe blocks:
//       one thread per element, the k cells' nonzero bit (OR of the d
//       plane words) or d-bit value (shift-OR), the plane words of
//       kProbeUnroll cells gathered at once; the decision is min over k >=
//       threshold (1 for the nonzero probe), OR'd with the intra-batch
//       join where the sketch uses it, AND valid. Partition blocks: the
//       merged order of a tenant's (subtract, insert) events (subtract
//       first on equal cells) is cut into tiles of kTile events; one block
//       per tile finds where its tile starts in each list with one
//       block-wide search (all threads probe the range at once: 3
//       dependent rounds instead of a binary search's 17) and stores it.
//   (B) apply — one block per tile reads its start and end, stages its
//       stretch of both lists in shared memory with coalesced loads, and
//       places each thread's event in the merged order by a search in
//       shared memory. The owner of a word is its
//       first event in the merged order (no earlier event of either list
//       names the word). It loads the word's d plane words and each list's
//       first event together, walks the word's events in both lists (from
//       shared memory inside the tile, device memory past its end),
//       counting equal cells to their run length clamped at the count cap
//       (the fleet-wide Max for sbf's decrements, 2^d - 1 for adds; set
//       mode takes each cell's bit), applies the borrow chain and then the
//       set or carry chain, writes back, and counts popcount(post nonzero)
//       - popcount(pre nonzero). One owner per word: no atomics touch the
//       planes, and the result does not depend on order. Each tile reduces
//       its load delta and adds it with one integer atomic.
// The plane arrays are sized by D, the power of two at or above d (a
// template argument), so few planes hold few registers and many blocks
// stay resident. d runs to 32, the widest cell the reference's plane
// layout holds (sbf with Max up to 2^32 - 1; a wider Max overflows its
// uint32 counts). Counts and run lengths stay below 2^31 (there are fewer
// events than that), so the caller clamps the caps there; a set-to-Max
// value is read bit by bit, so Max >= 2^31 travels as its int32 bit
// pattern.
//
// What bounds it now: latency, not bytes. On an H100 the probe launch
// waits on two dependent scattered reads (positions, then plane words),
// its partition blocks on three search rounds beside them, and the apply
// on the owners' scattered read-modify-writes, against a ~0.5 µs byte
// bound per 256 MB sbf step.
//
// Snapshot order. (A) must read the batch-entry planes, so it runs before
// (B): two launches in stream order. One cooperative launch with a
// grid-wide barrier between the phases measured no faster on an H100
// (a barrier costs about what the second launch's ramp does, and the gap
// between launches is not device time), so the step stays two launches.
// Set-to-Max writes the tenant's `set_value` bit by bit, which may lie
// below 2^d - 1. Plane arrays are indexed by unrolled constants so they
// stay in registers.
//
// Tenant axis. Planes (T, d, W), pos (T, B, k), valid/seen/dup (T, B), each
// event list (T, n) sorted per row, load (T,). The threshold and the
// set-to-Max value are (T,) int32 rows on the device, read here — the
// params_aware kernel's per-tenant operands. Tiles never cross a tenant's
// row: each tenant's lists are searched inside its own row, and cells stay
// row-local (never offset by t·32W), so they stay below 2^31. One filter
// is T = 1.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = kThreads;            // merged events per tile
constexpr int kMaxPlanes = 32;             // the reference's widest cell
constexpr int kProbeUnroll = 4;            // probes gathered at once

struct CounterArgs {
  uint32_t* planes;          // (T, d, W) words, updated in place
  long long w;
  int d, t, b, k;            // b: elements per tenant (the slot width C)
  const int32_t* pos;        // (T, B, k) probe cells
  const uint8_t* valid;      // (T, B) bool
  const uint8_t* seen;       // (T, B) bool, or null when not joined
  int value_probe;           // 1: d-bit values; 0: nonzero bit
  const int32_t* threshold;  // (T,) verdict thresholds, or null: 1
  int32_t* load_out;         // (T,) = load_in on entry; tiles add deltas
  uint8_t* dup;              // (T, B) bool
  const long long* sub;      // (T, n_sub) sorted cells, sentinel padded
  int n_sub;                 // 0: no subtract
  int sub_cap;               // subtract counts clamp here
  const long long* ins;      // (T, n_ins) sorted cells, sentinel padded
  int n_ins;
  int ins_cap;               // add counts clamp here (unused in set mode)
  int set_mode;
  const int32_t* set_value;  // (T,) set-to-Max values (set mode)
  int tiles;                 // tiles per tenant row
  int* splits;               // (T, tiles) sub events before each tile
  long long probe_blocks;    // the probe launch's blocks before its
                             //   partition blocks
};

struct TileShared {
  int cells[kTile];          // the tile's stretch of sub, then of ins
  int sums[kWarps];
};

// Probe + decide for the flattened (tenant, element) index e. The probes'
// plane words are gathered kProbeUnroll cells at a time, all loads issued
// before any is used, so a step waits about one memory latency per
// kProbeUnroll probes instead of one per probe and plane.
template <int D>
__device__ void probe_decide(const CounterArgs& a, long long e) {
  const long long t = e / a.b;
  const uint32_t* planes = a.planes + t * a.d * a.w;
  const int32_t* pe = a.pos + e * a.k;
  int minv = INT_MAX;
  for (int f0 = 0; f0 < a.k; f0 += kProbeUnroll) {
    long long wi[kProbeUnroll];
    uint32_t bit[kProbeUnroll];
#pragma unroll
    for (int u = 0; u < kProbeUnroll; ++u) {
      // past k the last cell repeats, which leaves the min as it is
      const uint32_t p = static_cast<uint32_t>(pe[min(f0 + u, a.k - 1)]);
      wi[u] = min(static_cast<long long>(p >> 5), a.w - 1);  // a gather
      bit[u] = p & 31u;                                     // clamps
    }
    uint32_t nz[kProbeUnroll] = {};
    int v[kProbeUnroll] = {};
#pragma unroll
    for (int q = 0; q < D; ++q) {
      if (q < a.d) {
#pragma unroll
        for (int u = 0; u < kProbeUnroll; ++u) {
          const uint32_t x = planes[q * a.w + wi[u]];
          nz[u] |= x;
          v[u] |= static_cast<int>((x >> bit[u]) & 1u) << q;
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kProbeUnroll; ++u)
      minv = min(minv, a.value_probe
                           ? v[u]
                           : static_cast<int>((nz[u] >> bit[u]) & 1u));
  }
  const int threshold = a.threshold != nullptr ? a.threshold[t] : 1;
  bool dup = minv >= threshold || (a.seen != nullptr && a.seen[e] != 0);
  a.dup[e] = (dup && a.valid[e] != 0) ? 1 : 0;
}

// One tenant's view of a tile: its rows and the tile's stretch of each
// list, [s0, s1) of sub and [i0, i1) of ins, staged in shared memory.
struct Tile {
  uint32_t* planes;
  const long long* sub;
  const long long* ins;
  int s0, s1, i0, i1;
  const int* cells;          // sub's stretch, then ins's

  __device__ long long sub_at(int x) const {
    return x >= s0 && x < s1 ? cells[x - s0] : sub[x];
  }
  __device__ long long ins_at(int x) const {
    return x >= i0 && x < i1 ? cells[s1 - s0 + x - i0] : ins[x];
  }
};

// The merge-path split of a tenant's merged order at diagonal `diag`: how
// many sub events come before it (sub first on equal cells). The block's
// threads probe kThreads evenly spaced points of the remaining range at
// once, so each round cuts it kThreads-fold: three dependent rounds for a
// 256 MB sbf step's 131,072 events, where one thread's binary search takes
// seventeen. Every thread of the block must call it; all get the answer.
__device__ int block_split(const long long* sub, int ns, const long long* ins,
                           int ni, int diag) {
  // the answer is the first i in [lo, hi] with !(sub[i] <= ins[diag-i-1])
  int lo = max(0, diag - ni), hi = min(diag, ns);
  while (hi > lo) {                       // uniform across the block
    const int step = (hi - lo + kThreads - 1) / kThreads;
    const int p = lo + threadIdx.x * step;
    const int c = __syncthreads_count(p < hi && sub[p] <= ins[diag - p - 1]);
    // the probes that hold are a prefix: the answer lies past the last of
    // them and at or before the first that fails
    if (c == 0) {
      hi = lo;
    } else {
      const int last = lo + (c - 1) * step;
      hi = min(last + step, hi);
      lo = last + 1;
    }
  }
  return lo;
}

// ORs the events of `word` in one sorted list into per-plane masks c:
// each distinct cell's run length, clamped at cap, written bit by bit into
// plane q's mask. The walk starts at index x, whose event `cell` the
// caller loaded ahead.
template <int D, bool kSub>
__device__ void gather(const CounterArgs& a, const Tile& tl, int x, int n,
                       long long cell, long long word, int cap,
                       uint32_t (&c)[D]) {
  while (x < n && (cell >> 5) == word) {
    int run = 0;
    long long next;
    do {
      ++run;
      ++x;
      next = x < n ? (kSub ? tl.sub_at(x) : tl.ins_at(x)) : -1;
    } while (next == cell);
    const int cnt = min(run, cap);
    const uint32_t m = 1u << (static_cast<uint32_t>(cell) & 31u);
#pragma unroll
    for (int q = 0; q < D; ++q)
      if (q < a.d && ((cnt >> q) & 1)) c[q] |= m;
    cell = next;
  }
}

// The owner's update of `word`: subtract the word's sub events starting at
// sub index gs, then set or add its ins events starting at ins index gi;
// -> popcount(post nonzero) - popcount(pre nonzero). The word's plane
// words and each list's first event are loaded together, before the walks.
template <int D>
__device__ int own_word(const CounterArgs& a, const Tile& tl, int set_value,
                        long long word, int gs, int gi) {
  uint32_t r[D];
  uint32_t pre_nz = 0, post_nz = 0;
  uint32_t* p = tl.planes + word;
#pragma unroll
  for (int q = 0; q < D; ++q) r[q] = q < a.d ? p[q * a.w] : 0u;
  const long long sub_first = gs < a.n_sub ? tl.sub_at(gs) : -1;
  const long long ins_first = gi < a.n_ins ? tl.ins_at(gi) : -1;
#pragma unroll
  for (int q = 0; q < D; ++q) pre_nz |= r[q];
  if (a.n_sub > 0) {                      // saturating subtract
    uint32_t c[D] = {};
    gather<D, true>(a, tl, gs, a.n_sub, sub_first, word, a.sub_cap, c);
    uint32_t borrow = 0;
#pragma unroll
    for (int q = 0; q < D; ++q) {
      if (q < a.d) {
        uint32_t xq = r[q];
        r[q] = xq ^ c[q] ^ borrow;
        borrow = (~xq & (c[q] | borrow)) | (c[q] & borrow);
      }
    }
#pragma unroll
    for (int q = 0; q < D; ++q) r[q] &= ~borrow;
  }
  uint32_t c[D] = {};
  // set mode takes each inserted cell once: its bit in plane 0's mask
  gather<D, false>(a, tl, gi, a.n_ins, ins_first, word,
                   a.set_mode ? 1 : a.ins_cap, c);
  if (a.set_mode) {                       // set to Max: c[0] is the OR mask
    const uint32_t m = c[0];
#pragma unroll
    for (int q = 0; q < D; ++q)
      r[q] = ((set_value >> q) & 1) ? (r[q] | m) : (r[q] & ~m);
  } else {                                // saturating add
    uint32_t carry = 0;
#pragma unroll
    for (int q = 0; q < D; ++q) {
      if (q < a.d) {
        uint32_t xq = r[q];
        r[q] = xq ^ c[q] ^ carry;
        carry = (xq & c[q]) | (xq & carry) | (c[q] & carry);
      }
    }
#pragma unroll
    for (int q = 0; q < D; ++q) r[q] |= carry;
  }
#pragma unroll
  for (int q = 0; q < D; ++q) {
    if (q < a.d) {
      p[q * a.w] = r[q];
      post_nz |= r[q];
    }
  }
  return __popc(post_nz) - __popc(pre_nz);
}

__device__ int warp_sum(int v) {
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_down_sync(0xFFFFFFFFu, v, off);
  return v;
}

// Phase (B) for tile g of the flattened (tenant, tile) index, one merged
// event per thread.
template <int D>
__device__ void apply_tile(const CounterArgs& a, long long g, TileShared& sh) {
  const int t = static_cast<int>(g / a.tiles);
  const int d0 = static_cast<int>(g - static_cast<long long>(t) * a.tiles) *
                 kTile;
  const int d1 = min(d0 + kTile, a.n_sub + a.n_ins);
  const long long ts = t;
  Tile tl;
  tl.planes = a.planes + ts * a.d * a.w;
  tl.sub = a.sub != nullptr ? a.sub + ts * a.n_sub : nullptr;
  tl.ins = a.ins + ts * a.n_ins;
  // the partition found the tile's start; its end is the next tile's
  tl.s0 = a.splits[g];
  tl.s1 = d1 < a.n_sub + a.n_ins ? a.splits[g + 1] : a.n_sub;
  tl.i0 = d0 - tl.s0;
  tl.i1 = d1 - tl.s1;
  tl.cells = sh.cells;
  const int ns = tl.s1 - tl.s0, total = d1 - d0, ni = total - ns;
  for (int x = threadIdx.x; x < total; x += kThreads)
    sh.cells[x] = static_cast<int>(x < ns ? tl.sub[tl.s0 + x]
                                          : tl.ins[tl.i0 + x - ns]);
  __syncthreads();
  const int* ss = sh.cells;
  const int* si = sh.cells + ns;
  const int set_value = a.set_mode ? a.set_value[t] : 0;
  int delta = 0;
  const int q = threadIdx.x;                // this thread's merged event
  if (q < total) {
    // its place in the tile's merged order: i sub and j ins events of the
    // tile come before it (a search in shared memory)
    int lo = max(0, q - ni), hi = min(q, ns);
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (ss[mid] <= si[q - mid - 1]) lo = mid + 1;
      else hi = mid;
    }
    const int i = lo, j = q - lo;
    const bool is_sub = i < ns && (j >= ni || ss[i] <= si[j]);
    const long long word = (is_sub ? ss[i] : si[j]) >> 5;
    const int gs = tl.s0 + i, gi = tl.i0 + j;   // events before this one
    // the owner: no earlier event of either list names the word
    if (word < a.w &&
        (gs == 0 || (tl.sub_at(gs - 1) >> 5) != word) &&
        (gi == 0 || (tl.ins_at(gi - 1) >> 5) != word))
      delta = own_word<D>(a, tl, set_value, word, gs, gi);
  }
  const int sum = warp_sum(delta);
  if ((threadIdx.x & 31) == 0) sh.sums[threadIdx.x >> 5] = sum;
  __syncthreads();
  if (threadIdx.x < 32) {
    int v = threadIdx.x < kWarps ? sh.sums[threadIdx.x] : 0;
    v = warp_sum(v);
    if (threadIdx.x == 0 && v != 0) atomicAdd(&a.load_out[t], v);
  }
}

// grid: probe_blocks blocks of one thread per element of the T·B, then
// one partition block per tile of the T·tiles, which finds the tile's
// merge-path start (the two parts read nothing the other writes)
template <int D>
__global__ void __launch_bounds__(kThreads) counter_probe_partition(
    CounterArgs a) {
  if (blockIdx.x < a.probe_blocks) {
    const long long e = static_cast<long long>(blockIdx.x) * kThreads +
                        threadIdx.x;
    if (e < static_cast<long long>(a.t) * a.b) probe_decide<D>(a, e);
    return;
  }
  const long long g = blockIdx.x - a.probe_blocks;
  const long long t = g / a.tiles;
  const int d0 = static_cast<int>(g - t * a.tiles) * kTile;
  const int s0 = block_split(
      a.sub != nullptr ? a.sub + t * a.n_sub : nullptr, a.n_sub,
      a.ins + t * a.n_ins, a.n_ins, d0);
  if (threadIdx.x == 0) a.splits[g] = s0;
}

// grid: one block per tile of the T·tiles
template <int D>
__global__ void __launch_bounds__(kThreads) counter_merge_apply(
    CounterArgs a) {
  __shared__ TileShared sh;
  apply_tile<D>(a, blockIdx.x, sh);
}

long long ceil_div(long long x, long long y) { return (x + y - 1) / y; }

// (A) then (B) in stream order, planes held in arrays of D.
template <int D>
int launch(const CounterArgs& a, cudaStream_t st) {
  const long long tile_blocks = static_cast<long long>(a.t) * a.tiles;
  if (a.probe_blocks + tile_blocks > 0) {
    counter_probe_partition<D><<<static_cast<unsigned>(a.probe_blocks +
                                                       tile_blocks),
                                 kThreads, 0, st>>>(a);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (tile_blocks > 0)
    counter_merge_apply<D><<<static_cast<unsigned>(tile_blocks), kThreads,
                             0, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// One step of T filters on `stream`: (A) then (B), two launches in stream
// order. b is the elements per tenant; sub and ins are each tenant's
// sorted int64 event rows, n_sub and n_ins long (a null sub means no
// subtract). Subtract counts clamp at sub_cap, add counts at ins_cap; set
// mode reads set_value (T,) and takes each inserted cell once. splits is
// int32 scratch of T·ceil((n_sub + n_ins) / kTile) for the partition.
// load_out (T,) must hold the batch-entry load on entry: (B) adds its
// deltas to it. A null seen skips the join; a null threshold decides at 1
// (the nonzero probe). Returns the first launch error or non-zero
// cudaGetLastError().
extern "C" int counter_step_launch(
    void* planes, long long w, int d, int t, int b, int k, const void* pos,
    const void* valid, const void* seen, int value_probe,
    const void* threshold, void* load_out, void* dup, const void* sub,
    int n_sub, int sub_cap, const void* ins, int n_ins, int ins_cap,
    int set_mode, const void* set_value, void* splits, void* stream) {
  const long long n_events =
      static_cast<long long>(sub != nullptr ? n_sub : 0) + n_ins;
  if (d < 1 || d > kMaxPlanes || t < 1 || n_sub < 0 || n_ins < 0 ||
      n_events > INT_MAX || (set_mode && set_value == nullptr) ||
      (n_events > 0 && splits == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  CounterArgs a;
  a.planes = static_cast<uint32_t*>(planes);
  a.w = w;
  a.d = d;
  a.t = t;
  a.b = b;
  a.k = k;
  a.pos = static_cast<const int32_t*>(pos);
  a.valid = static_cast<const uint8_t*>(valid);
  a.seen = static_cast<const uint8_t*>(seen);
  a.value_probe = value_probe;
  a.threshold = static_cast<const int32_t*>(threshold);
  a.load_out = static_cast<int32_t*>(load_out);
  a.dup = static_cast<uint8_t*>(dup);
  a.sub = static_cast<const long long*>(sub);
  a.n_sub = sub != nullptr ? n_sub : 0;
  a.sub_cap = sub_cap;
  a.ins = static_cast<const long long*>(ins);
  a.n_ins = n_ins;
  a.ins_cap = ins_cap;
  a.set_mode = set_mode;
  a.set_value = static_cast<const int32_t*>(set_value);
  a.tiles = static_cast<int>(ceil_div(n_events, kTile));
  a.splits = static_cast<int*>(splits);
  a.probe_blocks =
      ceil_div(static_cast<long long>(t) * (b > 0 ? b : 0), kThreads);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // the plane arrays are sized by the smallest power of two >= d, so a
  // step of few planes holds few registers
  if (d == 1) return launch<1>(a, st);
  if (d == 2) return launch<2>(a, st);
  if (d <= 4) return launch<4>(a, st);
  if (d <= 8) return launch<8>(a, st);
  if (d <= 16) return launch<16>(a, st);
  return launch<32>(a, st);
}
