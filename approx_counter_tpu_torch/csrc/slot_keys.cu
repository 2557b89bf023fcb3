// The exact stage's step 3 on fixed (code, count) slots in one kernel: each
// slot's DUST dimer sum, the filters, the masked count and the ranking keys
// of step 4.
//
// Replaces no TPU kernel: the JAX package leaves these elementwise ops to
// XLA, which fuses them.  The port's plain version
// (kernels/exact_stage.py:slot_keys_ref, core/complexity.py:dimer_sum)
// counts equal dimer pairs with 2·C(k-1, 2) + 3(k-1) elementwise ops (255
// launches at k = 16) and masks and keys with a dozen more, each over every
// slot.
//
// The function, per slot s with int64 code c (uint64 bits) and count n:
//   dimer  = dimer_sum(c, k) (dimer_sum.cuh);
//   keep   = n > 0, dimer < lc_sum_thr, c not among the forbidden codes,
//            and n >= solid_km when solid_km > 0;
//   count  = keep ? n : 0;
// and one of two output sets: the keys of count/exact.py:_topk_rank,
//   key1   = ((2^40 - count) << key_bits) | dimer, ncode = ~(c ^ 2^63),
// or compare_count_order's inputs, dimer and keep; and over all slots
// n_pass (slots kept) and n_unique (slots with n > 0).
//
// Layout: one thread a slot; reads and writes of neighbouring slots
// coalesce.  The forbidden codes pass through shared memory in tiles,
// which every thread of the block reads at the same address (a broadcast).
// What bounds it: the bytes, 16 read and up to 24 written a slot; the ops,
// about eight a dimer, are far under the integer pipe's rate.  The totals
// are block sums and one 64-bit atomic each a block: exact, in any order of
// the blocks.
//
// Built by approx_counter_tpu_torch/kernels/_build.py with nvcc for sm_90a
// and called through ctypes.

#include <cuda_runtime.h>

#include <cstdint>

#include "dimer_sum.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 1024;  // forbidden codes a shared-memory tile holds
constexpr unsigned long long kSign = 1ull << 63;
constexpr long long kCountCeil = 1ll << 40;  // kernels/exact_stage.py:COUNT_CEIL

__device__ __forceinline__ unsigned long long warp_sum(unsigned long long v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(~0u, v, off);
  return v;
}

__global__ void __launch_bounds__(kThreads)
slot_keys_kernel(const unsigned long long* __restrict__ codes,
                 const long long* __restrict__ counts,
                 const unsigned long long* __restrict__ forbidden,
                 long long* __restrict__ count_out,
                 long long* __restrict__ key1, long long* __restrict__ ncode,
                 int* __restrict__ dimer_out, uint8_t* __restrict__ keep_out,
                 unsigned long long* __restrict__ totals, long long n_slots,
                 int n_forbidden, int k, int lc_sum_thr, long long solid_km,
                 int key_bits) {
  __shared__ unsigned long long tile[kTile];
  __shared__ unsigned long long part[2][kWarps];
  const long long s = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  const bool in = s < n_slots;
  const unsigned long long code = in ? codes[s] : 0;
  bool forbid = false;
  // every thread takes part in loading the tiles: no return before this
  for (int f0 = 0; f0 < n_forbidden; f0 += kTile) {
    const int nf = min(kTile, n_forbidden - f0);
    __syncthreads();  // the previous tile's reads are done
    for (int i = threadIdx.x; i < nf; i += kThreads) tile[i] = forbidden[f0 + i];
    __syncthreads();
    for (int i = 0; i < nf; ++i) forbid |= code == tile[i];
  }
  unsigned long long kept = 0, unique = 0;
  if (in) {
    const int dimer = dimer_sum(code, k);
    const long long n = counts[s];
    const bool keep = n > 0 && dimer < lc_sum_thr && !forbid &&
                      (solid_km <= 0 || n >= solid_km);
    const long long count = keep ? n : 0;
    count_out[s] = count;
    if (key1) key1[s] = ((kCountCeil - count) << key_bits) | dimer;
    if (ncode) ncode[s] = static_cast<long long>(~(code ^ kSign));
    if (dimer_out) dimer_out[s] = dimer;
    if (keep_out) keep_out[s] = keep;
    kept = keep;
    unique = n > 0;
  }
  kept = warp_sum(kept);
  unique = warp_sum(unique);
  const int warp = threadIdx.x / 32;
  if (threadIdx.x % 32 == 0) {
    part[0][warp] = kept;
    part[1][warp] = unique;
  }
  __syncthreads();
  if (threadIdx.x < 2) {
    unsigned long long t = 0;
#pragma unroll
    for (int i = 0; i < kWarps; ++i) t += part[threadIdx.x][i];
    if (t) atomicAdd(totals + threadIdx.x, t);
  }
}

}  // namespace

// codes, counts: int64 [n_slots]; forbidden: int64 [n_forbidden] (any
// n_forbidden >= 0); count_out: int64 [n_slots]; either key1 and ncode
// (int64 [n_slots]) with dimer and keep null, or dimer (int32 [n_slots])
// and keep (bool [n_slots]) with key1 and ncode null; totals: int64 [2]
// (n_pass, n_unique), zeroed here on the stream before the kernel adds to
// it.  2 <= k <= 32, 0 <= key_bits <= 22.  Returns the cudaError_t of the
// memset or of the launch (0 on success).
extern "C" int slot_keys(const void* codes, const void* counts,
                         const void* forbidden, void* count_out, void* key1,
                         void* ncode, void* dimer, void* keep, void* totals,
                         long long n_slots, int n_forbidden, int k,
                         int lc_sum_thr, long long solid_km, int key_bits,
                         void* stream) {
  const bool keys = key1 && ncode && !dimer && !keep;
  const bool order = !key1 && !ncode && dimer && keep;
  if (k < 2 || k > 32 || n_slots < 0 || n_forbidden < 0 || key_bits < 0 ||
      key_bits > 22 || !(keys || order))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  auto* tot = static_cast<unsigned long long*>(totals);
  const cudaError_t e = cudaMemsetAsync(tot, 0, 2 * sizeof(*tot), s);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (n_slots == 0) return 0;
  const long long blocks = (n_slots + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffll) return static_cast<int>(cudaErrorInvalidValue);
  slot_keys_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
      static_cast<const unsigned long long*>(codes),
      static_cast<const long long*>(counts),
      static_cast<const unsigned long long*>(forbidden),
      static_cast<long long*>(count_out), static_cast<long long*>(key1),
      static_cast<long long*>(ncode), static_cast<int*>(dimer),
      static_cast<uint8_t*>(keep), tot, n_slots, n_forbidden, k, lc_sum_thr,
      solid_km, key_bits);
  return static_cast<int>(cudaGetLastError());
}
