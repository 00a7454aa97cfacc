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
// (T, k); the grid's y axis (z for (B) and (C)) is the tenant, so a block
// works inside one tenant's rows and its load reduce goes to that tenant.
// The reference vmaps its kernel over T; tenants' rows are disjoint, so the
// three phases keep snapshot order for all tenants at once. One filter is
// T = 1.
//
// Decisions divide in float32 with __fdiv_rn/__int2float_rn (IEEE
// round-to-nearest, as the reference's f32 division); do not build with
// fast-math. Lanes that are invalid or not inserted touch no word.

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
  uint32_t* del_rows;     // (T, B) bit f set: delete row f
  int variant;
  int s;                  // bits per row
  float s_f;              // float32(s)
  float p_star;           // float32(p*)
  HashSpec h;             // seeds, s and layout of the probe hash
};

// row f's probe / insert position of a key
__device__ __forceinline__ uint32_t position(const StepArgs& a, uint32_t key,
                                             int f) {
  return static_cast<uint32_t>(hash_position(key, f, a.h));
}

// grid (ceil(B / kThreads), T): blockIdx.y is the tenant
__global__ void probe_decide(StepArgs a) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= a.b) return;
  const int k = a.k;
  const int t = blockIdx.y;
  const long long e = static_cast<long long>(t) * a.b + i;  // (T, B) index
  const uint32_t* words = a.words + static_cast<long long>(t) * k * a.w;
  const int32_t* load_in = a.load_in + t * k;
  const uint32_t key = a.keys[e];
  uint32_t zero_rows = 0;  // rows whose probed bit is clear
  for (int f = 0; f < k; ++f) {
    uint32_t p = position(a, key, f);
    uint32_t word = words[f * a.w + (p >> 5)];
    if (((word >> (p & 31u)) & 1u) == 0u) zero_rows |= 1u << f;
  }
  const uint32_t all_rows = (k == 32) ? 0xFFFFFFFFu : ((1u << k) - 1u);
  const bool valid = a.valid[e] != 0;
  const bool dup = ((zero_rows == 0u) || a.seen[e] != 0) && valid;
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
      del = (insert && w >= 0 && w < k) ? (1u << w) : 0u;
      break;
    }
    case RLBSBF:
      if (insert) {
        for (int f = 0; f < k; ++f) {
          float p_del = __fdiv_rn(__int2float_rn(load_in[f]), a.s_f);
          if (a.u_aux[e * k + f] < p_del) del |= 1u << f;
        }
      }
      break;
  }
  a.dup[e] = dup ? 1 : 0;
  a.ins[e] = insert ? 1 : 0;
  a.del_rows[e] = del;
}

// grid (ceil(B / kThreads), k, T): blockIdx.y is the row, blockIdx.z the
// tenant
__global__ void apply_deletes(StepArgs a) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  int f = blockIdx.y;
  int t = blockIdx.z;
  long long e = static_cast<long long>(t) * a.b + i;
  long long row = static_cast<long long>(t) * a.k + f;
  int cleared = 0;
  if (i < a.b && ((a.del_rows[e] >> f) & 1u)) {
    uint32_t p = static_cast<uint32_t>(a.del_pos[e * a.k + f]);
    uint32_t m = 1u << (p & 31u);
    uint32_t old = atomicAnd(&a.words[row * a.w + (p >> 5)], ~m);
    cleared = (old & m) != 0u;
  }
  int n = __syncthreads_count(cleared);
  if (threadIdx.x == 0 && n) atomicSub(&a.load_out[row], n);
}

__global__ void apply_inserts(StepArgs a) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  int f = blockIdx.y;
  int t = blockIdx.z;
  long long e = static_cast<long long>(t) * a.b + i;
  long long row = static_cast<long long>(t) * a.k + f;
  int gained = 0;
  bool insert = false;
  uint32_t key = 0;
  if (i < a.b) {  // two independent loads
    insert = a.ins[e] != 0;
    key = a.keys[e];
  }
  if (insert) {
    uint32_t p = position(a, key, f);
    uint32_t m = 1u << (p & 31u);
    uint32_t old = atomicOr(&a.words[row * a.w + (p >> 5)], m);
    gained = (old & m) == 0u;
  }
  int n = __syncthreads_count(gained);
  if (threadIdx.x == 0 && n) atomicAdd(&a.load_out[row], n);
}

}  // namespace

// One step of T filters: launches (A), (B), (C) on `stream` in that
// order. b is the elements per tenant. load_out must hold load_in on entry.
// keys (T, b) uint32, hashed with the k host seeds (and, for block_bits >
// 0, the k host block seeds).
// Returns the first non-zero cudaGetLastError().
extern "C" int bitset_step_launch(
    void* words, long long w, int k, int t, int b, const void* keys,
    const uint32_t* seeds, const uint32_t* bseeds, int block_bits,
    const void* del_pos, const void* valid,
    const void* seen, const void* i_t, const void* u_bern, const void* u_aux,
    const void* which,
    const void* load_in, void* load_out, void* dup, void* ins, void* del_rows,
    int variant, int s, float s_f, float p_star, void* stream) {
  StepArgs a;
  a.words = static_cast<uint32_t*>(words);
  a.w = w;
  a.k = k;
  a.t = t;
  a.b = b;
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
  a.h = make_hash_spec(seeds, bseeds, k, static_cast<uint32_t>(s),
                       block_bits);
  if (b <= 0 || t <= 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  dim3 grid1((b + kThreads - 1) / kThreads, t);
  dim3 grid2((b + kThreads - 1) / kThreads, k, t);
  probe_decide<<<grid1, kThreads, 0, st>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  apply_deletes<<<grid2, kThreads, 0, st>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  apply_inserts<<<grid2, kThreads, 0, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}
