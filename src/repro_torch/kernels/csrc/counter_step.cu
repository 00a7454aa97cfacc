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
// What bounds it on the card: bytes, and few of them. The TPU kernel keeps
// the planes in VMEM and sweeps all of (d, W) every batch against (d, W)
// delta planes that XLA scattered first. At the paper's 256 MB table that
// is >= 1.25 GiB of traffic per 8192-key batch (planes read and written,
// decrement planes, set mask, and building those), >= 0.4 ms at 3.35 TB/s,
// for some 131k events that touch at most ~131k words per plane. This
// kernel touches only those words and never builds a delta plane.
//
// Design. Two launches in stream order, so every probe reads the
// batch-entry planes (the TPU's one sequential program gave that for free):
//   (A) probe + decide — one thread per element: the k cells' nonzero bit
//       (OR of the d plane words) or d-bit value (shift-OR); the decision is
//       min over k >= threshold (1 for the nonzero probe), OR'd with the
//       intra-batch join where the sketch uses it, AND valid.
//   (B) update — the operands are the run HEADS of the sorted subtract and
//       insert event lists (cell, clamped count), sentinel padded: the
//       information of the reference's accumulate-mode _event_operands,
//       with each plane's contribution mask formed here. One thread owns
//       each touched word: the first head of that word in the subtract
//       list, or, for words only inserted into, the first in the insert
//       list. It reads the word's d plane words once, ORs in its events'
//       per-plane masks (heads are distinct cells, at most 32 per word per
//       list), applies the borrow chain and then the set or carry chain,
//       writes back, and counts popcount(post nonzero) - popcount(pre
//       nonzero). One owner per word: no atomics touch the planes, and the
//       result does not depend on order. Each block reduces its load delta
//       and adds it with one integer atomic.
// Set-to-Max writes the tenant's `set_value` bit by bit, which may lie below
// 2^d - 1. Plane arrays are indexed by unrolled constants so they stay in
// registers.
//
// Tenant axis. A fleet of T filters is one launch of each phase, with
// blockIdx.y the tenant: planes (T, d, W), pos (T, B, k), valid/seen/dup
// (T, B), each event list (T, n) sorted per row, load (T,). The threshold
// and the set-to-Max value are (T,) int32 rows on the device, read here —
// the params_aware kernel's per-tenant operands — so no step reads them on
// the host. A block works inside one tenant's row: its owner search runs
// over that row only, and its load reduce goes to that tenant. Cells stay
// row-local (never offset by t·32W), so they stay below 2^31. One filter
// is T = 1.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxPlanes = 16;

struct CounterArgs {
  uint32_t* planes;          // (T, d, W) words, updated in place
  long long w;
  int d, t, b, k;            // b: elements per tenant (the slot width C)
  const int32_t* pos;        // (T, B, k) probe cells
  const uint8_t* valid;      // (T, B) bool
  const uint8_t* seen;       // (T, B) bool, or null when not joined
  int value_probe;           // 1: d-bit values; 0: nonzero bit
  const int32_t* threshold;  // (T,) verdict thresholds, or null: 1
  int32_t* load_out;         // (T,) = load_in on entry; blocks add deltas
  uint8_t* dup;              // (T, B) bool
  const int32_t* sub_cells;  // (T, n_sub) sorted heads, sentinel padded
  const int32_t* sub_counts; // (T, n_sub) clamped run lengths
  int n_sub;
  const int32_t* ins_cells;  // (T, n_ins) sorted heads, sentinel padded
  const int32_t* ins_counts; // (T, n_ins) clamped run lengths; null: set
  int n_ins;
  int set_mode;
  const int32_t* set_value;  // (T,) set-to-Max values (set mode)
};

// One tenant's view of the step: its planes and its event rows.
struct TenantRows {
  uint32_t* planes;
  const int32_t* sub_cells;
  const int32_t* sub_counts;
  const int32_t* ins_cells;
  const int32_t* ins_counts;
};

__device__ TenantRows tenant_rows(const CounterArgs& a, int t) {
  TenantRows r;
  const long long ts = t, ns = a.n_sub, ni = a.n_ins;
  r.planes = a.planes + ts * a.d * a.w;
  r.sub_cells = a.sub_cells != nullptr ? a.sub_cells + ts * ns : nullptr;
  r.sub_counts = a.sub_counts != nullptr ? a.sub_counts + ts * ns : nullptr;
  r.ins_cells = a.ins_cells + ts * ni;
  r.ins_counts = a.ins_counts != nullptr ? a.ins_counts + ts * ni : nullptr;
  return r;
}

// grid (ceil(B / kThreads), T): blockIdx.y is the tenant
__global__ void counter_probe_decide(CounterArgs a) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= a.b) return;
  const int t = blockIdx.y;
  const long long e = static_cast<long long>(t) * a.b + i;  // (T, B) index
  const uint32_t* planes = a.planes + static_cast<long long>(t) * a.d * a.w;
  int minv = INT_MAX;
  for (int f = 0; f < a.k; ++f) {
    uint32_t p = static_cast<uint32_t>(a.pos[e * a.k + f]);
    long long wi = p >> 5;
    if (wi >= a.w) wi = a.w - 1;          // a gather clamps, as in JAX
    uint32_t bit = p & 31u;
    int v = 0;
    if (a.value_probe) {
      for (int q = 0; q < a.d; ++q)
        v |= static_cast<int>((planes[q * a.w + wi] >> bit) & 1u) << q;
    } else {
      uint32_t nz = 0;
      for (int q = 0; q < a.d; ++q) nz |= planes[q * a.w + wi];
      v = static_cast<int>((nz >> bit) & 1u);
    }
    minv = min(minv, v);
  }
  const int threshold = a.threshold != nullptr ? a.threshold[t] : 1;
  bool dup = minv >= threshold || (a.seen != nullptr && a.seen[e] != 0);
  a.dup[e] = (dup && a.valid[e] != 0) ? 1 : 0;
}

// first index in the sorted cells whose word is >= `word`
__device__ int lower_bound_word(const int32_t* cells, int n, long long word) {
  int lo = 0, hi = n;
  while (lo < hi) {
    int mid = (lo + hi) >> 1;
    if ((static_cast<long long>(cells[mid]) >> 5) < word) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

// ORs the events of `word` into per-plane masks c[q]: bit (cell & 31) of
// plane q where bit q of the event's count is set (count == 1 in set mode)
__device__ void gather_masks(const int32_t* cells, const int32_t* counts,
                             int n, long long word, int d,
                             uint32_t (&c)[kMaxPlanes]) {
  int e = lower_bound_word(cells, n, word);
  for (; e < n && (static_cast<long long>(cells[e]) >> 5) == word; ++e) {
    uint32_t m = 1u << (static_cast<uint32_t>(cells[e]) & 31u);
    int cnt = counts != nullptr ? counts[e] : 1;
#pragma unroll
    for (int q = 0; q < kMaxPlanes; ++q)
      if (q < d && ((cnt >> q) & 1)) c[q] |= m;
  }
}

__device__ int update_word(const CounterArgs& a, const TenantRows& tr,
                           int set_value, long long word) {
  uint32_t r[kMaxPlanes];
  uint32_t pre_nz = 0, post_nz = 0;
#pragma unroll
  for (int q = 0; q < kMaxPlanes; ++q) {
    r[q] = q < a.d ? tr.planes[q * a.w + word] : 0u;
    pre_nz |= r[q];
  }
  if (a.n_sub > 0) {                      // saturating subtract
    uint32_t c[kMaxPlanes] = {};
    gather_masks(tr.sub_cells, tr.sub_counts, a.n_sub, word, a.d, c);
    uint32_t borrow = 0;
#pragma unroll
    for (int q = 0; q < kMaxPlanes; ++q) {
      if (q < a.d) {
        uint32_t x = r[q];
        r[q] = x ^ c[q] ^ borrow;
        borrow = (~x & (c[q] | borrow)) | (c[q] & borrow);
      }
    }
#pragma unroll
    for (int q = 0; q < kMaxPlanes; ++q) r[q] &= ~borrow;
  }
  uint32_t c[kMaxPlanes] = {};
  gather_masks(tr.ins_cells, tr.ins_counts, a.n_ins, word, a.d, c);
  if (a.set_mode) {                       // set to Max: c[0] is the OR mask
    uint32_t m = c[0];
#pragma unroll
    for (int q = 0; q < kMaxPlanes; ++q)
      r[q] = ((set_value >> q) & 1) ? (r[q] | m) : (r[q] & ~m);
  } else {                                // saturating add
    uint32_t carry = 0;
#pragma unroll
    for (int q = 0; q < kMaxPlanes; ++q) {
      if (q < a.d) {
        uint32_t x = r[q];
        r[q] = x ^ c[q] ^ carry;
        carry = (x & c[q]) | (x & carry) | (c[q] & carry);
      }
    }
#pragma unroll
    for (int q = 0; q < kMaxPlanes; ++q) r[q] |= carry;
  }
#pragma unroll
  for (int q = 0; q < kMaxPlanes; ++q) {
    if (q < a.d) {
      tr.planes[q * a.w + word] = r[q];
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

// grid (ceil((n_sub + n_ins) / kThreads), T): blockIdx.y is the tenant;
// one thread per slot of the tenant's subtract row, then of its insert row
__global__ void counter_apply(CounterArgs a) {
  __shared__ int warp_sums[kThreads / 32];
  const int t = blockIdx.y;
  const TenantRows tr = tenant_rows(a, t);
  const int set_value = a.set_mode ? a.set_value[t] : 0;
  int j = blockIdx.x * blockDim.x + threadIdx.x;
  int delta = 0;
  if (j < a.n_sub) {
    long long word = static_cast<long long>(tr.sub_cells[j]) >> 5;
    bool first = j == 0 ||
        (static_cast<long long>(tr.sub_cells[j - 1]) >> 5) != word;
    if (word < a.w && first) delta = update_word(a, tr, set_value, word);
  } else if (j < a.n_sub + a.n_ins) {
    int i = j - a.n_sub;
    long long word = static_cast<long long>(tr.ins_cells[i]) >> 5;
    bool first = i == 0 ||
        (static_cast<long long>(tr.ins_cells[i - 1]) >> 5) != word;
    if (word < a.w && first && a.n_sub > 0) {
      // a word the subtract row also touches belongs to its owner there
      int s = lower_bound_word(tr.sub_cells, a.n_sub, word);
      first = !(s < a.n_sub &&
                (static_cast<long long>(tr.sub_cells[s]) >> 5) == word);
    }
    if (word < a.w && first) delta = update_word(a, tr, set_value, word);
  }
  int sum = warp_sum(delta);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = sum;
  __syncthreads();
  if (threadIdx.x < 32) {
    int v = threadIdx.x < kThreads / 32 ? warp_sums[threadIdx.x] : 0;
    v = warp_sum(v);
    if (threadIdx.x == 0 && v != 0) atomicAdd(&a.load_out[t], v);
  }
}

}  // namespace

// One step of T filters: launches (A) then (B) on `stream`. b is the
// elements per tenant, n_sub and n_ins the length of each tenant's event
// row. load_out (T,) must hold the batch-entry load on entry: (B) adds its
// deltas to it. A null seen skips the join; a null threshold decides at 1
// (the nonzero probe); null sub_cells means no subtract; set mode reads
// set_value (T,) and no ins_counts. Returns the first non-zero
// cudaGetLastError().
extern "C" int counter_step_launch(
    void* planes, long long w, int d, int t, int b, int k, const void* pos,
    const void* valid, const void* seen, int value_probe,
    const void* threshold, void* load_out, void* dup, const void* sub_cells,
    const void* sub_counts, int n_sub, const void* ins_cells,
    const void* ins_counts, int n_ins, int set_mode, const void* set_value,
    void* stream) {
  if (d < 1 || d > kMaxPlanes || t < 1 || (set_mode && set_value == nullptr))
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
  a.sub_cells = static_cast<const int32_t*>(sub_cells);
  a.sub_counts = static_cast<const int32_t*>(sub_counts);
  a.n_sub = sub_cells != nullptr ? n_sub : 0;
  a.ins_cells = static_cast<const int32_t*>(ins_cells);
  a.ins_counts = static_cast<const int32_t*>(ins_counts);
  a.n_ins = n_ins;
  a.set_mode = set_mode;
  a.set_value = static_cast<const int32_t*>(set_value);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (b > 0) {
    dim3 grid((b + kThreads - 1) / kThreads, t);
    counter_probe_decide<<<grid, kThreads, 0, st>>>(a);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  int n = a.n_sub + a.n_ins;
  if (n > 0) {
    dim3 grid((n + kThreads - 1) / kThreads, t);
    counter_apply<<<grid, kThreads, 0, st>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}
