// SWAR-packed level NFA: approximate k-mer counts on Hopper.
//
// Replaces approx_counter_tpu/kernels/bpm.py:_nfa_kernel_packed (the Pallas
// TPU kernel behind approx_counts_pallas_packed(algo="nfa")).  It computes
// the same function as the other approximate-count kernels -- per
// candidate, the sum over valid windows of max(0, maxerr + 1 - d_min) --
// with PACK candidates in the fw = 32 / PACK bit fields of one word
// (PACK 1, 2, 4, 8, 16 for k <= 32, 16, 8, 4, 2).  The result is int32 and
// exact.
//
// Per error level d a state word R_d: bit i of a field set iff the pattern's
// first i+1 bases match a substring ending at the current text symbol with
// <= d edits.  Per text symbol (Wu-Manber, search mode):
//
//   R'_0 = ((R_0 << 1) | ONES) & Eq
//   R'_d = ((R_d << 1) & Eq) | R_{d-1} | (R_{d-1} << 1) | (R'_{d-1} << 1)
//          (| ONES for d = 1 only)
//   h_d |= R'_d
//
// The levels nest, so a window adds sum_d [bit k-1 of h_d's field], which is
// max(0, maxerr + 1 - d_min).  As in the TPU kernel:
//   * there are no inter-field leak masks: a left shift carries the top bit
//     of a field into bit 0 of the next, and bit 0 of every R'_d is forced by
//     the recurrence (R'_0's is Eq's, R'_1's is set by | ONES, R'_d's for
//     d >= 2 is set through R_{d-1}), so the leaked bit never counts;
//   * the initial state R_d = (2^d - 1) in each field is cut to the field
//     width, so that at PACK 8 and 16 (fw <= maxerr is possible) it does not
//     spill into the next field;
//   * h starts from that initial state, so k <= maxerr counts the alignment
//     to the empty substring, as the Myers kernels' score of k does.
//
// Layout: word n holds candidates PACK*n ... PACK*n + PACK - 1 (the
// wrapper interleaves them).  A thread owns one window and kWords words in
// registers; the block's words come through shared memory.  The text loop
// runs exactly m rows.
//
// What bounds it on this card: integer logic, about 4 + 7 * maxerr ops per
// (word, window, text symbol) for PACK candidates.  PACK and maxerr are
// template parameters (20 instances, switched at the C entry); k is an
// argument, read only where the counts are taken.
//
// Built by approx_counter_tpu_torch/kernels/_build.py with nvcc for sm_90a
// and called through ctypes.

#include "approx_common.cuh"

namespace {

using approx::kBlock;

constexpr int kWords = 8;  // packed words per thread (and per block)

template <int PACK, int E>
__global__ void __launch_bounds__(kBlock)
nfa_packed_kernel(const uint32_t* __restrict__ words,
                  const uint8_t* __restrict__ windows_t,
                  const uint8_t* __restrict__ wvalid,
                  int32_t* __restrict__ out, int n_words, int m, int W,
                  int k) {
  constexpr int kFw = 32 / PACK;
  // bit 0 of every field: (2^32 - 1) / (2^fw - 1) = sum_f 2^(fw*f)
  constexpr uint32_t kOnes =
      0xFFFFFFFFu / static_cast<uint32_t>((1ull << kFw) - 1);
  constexpr int kSlots = kWords * PACK;

  __shared__ uint32_t s_mask[2][kWords];
  __shared__ int s_acc[kSlots];

  const long long n0 = static_cast<long long>(blockIdx.y) * kWords;
  const int tid = threadIdx.x;
  const long long w = static_cast<long long>(blockIdx.x) * kBlock + tid;
  const bool in_range = w < W;
  const bool valid = in_range && wvalid[w] != 0;

  if (tid < kWords) {
    const long long n = n0 + tid;
    const uint32_t* p = words + 4 * (n < n_words ? n : 0);
    s_mask[0][tid] = n < n_words ? p[1] | p[3] : 0u;
    s_mask[1][tid] = n < n_words ? p[2] | p[3] : 0u;
  }
  for (int s = tid; s < kSlots; s += kBlock) s_acc[s] = 0;
  __syncthreads();

  uint32_t mask0[kWords], mask1[kWords], R[kWords][E + 1], h[kWords][E + 1];
#pragma unroll
  for (int i = 0; i < kWords; ++i) {
    mask0[i] = s_mask[0][i];
    mask1[i] = s_mask[1][i];
#pragma unroll
    for (int d = 0; d <= E; ++d) {
      // bit i < d set: the first d pattern bases can be deleted before any
      // text; cut to the field width
      const uint64_t field = ((1ull << d) - 1) & ((1ull << kFw) - 1);
      R[i][d] = static_cast<uint32_t>(field * kOnes);
      h[i][d] = R[i][d];
    }
  }

  approx::scan_text(windows_t, w, in_range, m, W, [&](approx::TextMasks t) {
#pragma unroll
    for (int i = 0; i < kWords; ++i) {
      const uint32_t Eq = approx::eq_select(mask0[i], mask1[i], t);
      uint32_t Rn[E + 1];
      Rn[0] = ((R[i][0] << 1) | kOnes) & Eq;
#pragma unroll
      for (int d = 1; d <= E; ++d) {
        Rn[d] = ((R[i][d] << 1) & Eq) | R[i][d - 1] | (R[i][d - 1] << 1) |
                (Rn[d - 1] << 1);
        if (d == 1) Rn[d] |= kOnes;  // restart; implied by R_{d-1} for d >= 2
      }
#pragma unroll
      for (int d = 0; d <= E; ++d) {
        R[i][d] = Rn[d];
        h[i][d] |= Rn[d];
      }
    }
  });

  int value[kSlots];
#pragma unroll
  for (int i = 0; i < kWords; ++i) {
#pragma unroll
    for (int f = 0; f < PACK; ++f) {
      const int bit = kFw * f + k - 1;
      int hits = 0;
#pragma unroll
      for (int d = 0; d <= E; ++d) hits += (h[i][d] >> bit) & 1u;
      value[i * PACK + f] = valid ? hits : 0;
    }
  }
  approx::block_add(value, s_acc, out, n0 * PACK,
                    static_cast<long long>(n_words) * PACK);
}

template <int PACK>
void launch(dim3 grid, cudaStream_t s, const uint32_t* wp, const uint8_t* tp,
            const uint8_t* vp, int32_t* op, int n_words, int m, int W, int k,
            int maxerr) {
  switch (maxerr) {
    case 0: nfa_packed_kernel<PACK, 0><<<grid, kBlock, 0, s>>>(wp, tp, vp, op, n_words, m, W, k); break;
    case 1: nfa_packed_kernel<PACK, 1><<<grid, kBlock, 0, s>>>(wp, tp, vp, op, n_words, m, W, k); break;
    case 2: nfa_packed_kernel<PACK, 2><<<grid, kBlock, 0, s>>>(wp, tp, vp, op, n_words, m, W, k); break;
    default: nfa_packed_kernel<PACK, 3><<<grid, kBlock, 0, s>>>(wp, tp, vp, op, n_words, m, W, k); break;
  }
}

}  // namespace

// out[n_words * pack] must be zeroed by the caller; out[pack*n + f] is the
// count of field f of word n.  words is [n_words, 4] uint32 (interleaved
// peq), windows_t is [m, W] uint8, wvalid is [W] bytes (0 or 1).  Returns
// the cudaError_t of the launch (0 on success).
extern "C" int nfa_packed(const void* words, const void* windows_t,
                          const void* wvalid, void* out, int n_words, int m,
                          int W, int k, int maxerr, int pack, void* stream) {
  const int groups = (n_words + kWords - 1) / kWords;
  const bool pack_ok =
      pack == 1 || pack == 2 || pack == 4 || pack == 8 || pack == 16;
  if (n_words <= 0 || groups > 65535 || W <= 0 || m < 0 || k < 2 ||
      maxerr < 0 || maxerr > 3 || !pack_ok || k > 32 / pack)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((W + kBlock - 1) / kBlock, groups);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* wp = static_cast<const uint32_t*>(words);
  const auto* tp = static_cast<const uint8_t*>(windows_t);
  const auto* vp = static_cast<const uint8_t*>(wvalid);
  auto* op = static_cast<int32_t*>(out);
  switch (pack) {
    case 1: launch<1>(grid, s, wp, tp, vp, op, n_words, m, W, k, maxerr); break;
    case 2: launch<2>(grid, s, wp, tp, vp, op, n_words, m, W, k, maxerr); break;
    case 4: launch<4>(grid, s, wp, tp, vp, op, n_words, m, W, k, maxerr); break;
    case 8: launch<8>(grid, s, wp, tp, vp, op, n_words, m, W, k, maxerr); break;
    default: launch<16>(grid, s, wp, tp, vp, op, n_words, m, W, k, maxerr); break;
  }
  return static_cast<int>(cudaGetLastError());
}
