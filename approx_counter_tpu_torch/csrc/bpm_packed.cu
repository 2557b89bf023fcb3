// SWAR-packed Myers bit-vector DP: approximate k-mer counts on Hopper.
//
// Replaces approx_counter_tpu/kernels/bpm.py:_bpm_kernel_packed (the Pallas
// TPU kernel behind approx_counts_pallas_packed(algo="myers")).  It computes
// the same function as bpm_myers.cu -- per candidate, the sum over valid
// windows of max(0, maxerr + 1 - d_min) -- with PACK candidates in the
// fw = 32 / PACK bit fields of one word (PACK 2: k <= 16, PACK 4: k <= 8).
// The result is int32 and exact.
//
// What keeps the fields apart, each exactly as in the TPU kernel:
//   * the only carry-coupled op, (Eq & VP) + VP, is a per-field add mod 2^fw:
//       ((a & ~H) + (b & ~H)) ^ ((a ^ b) & H),   H = top bit of each field
//     (the low fw-1 bits add normally, the top bit is a ^ b ^ carry-in, and
//     the carry out of the field is dropped; carries only move upward, so
//     single-word Myers never feeds them back either);
//   * after each left shift, LEAK = ~ONES clears the bit that came in from
//     the field below;
//   * one packed int32 score holds every field's score, each +-1 landing on
//     its field's bit 0 (SBIT = ONES).  A field holds the semi-global
//     distance, in [0, k], so it never borrows or overflows;
//   * the per-field running minimum of that packed score is one SIMD
//     unsigned min per field width (__vminu2 / __vminu4), exact for field
//     values in [0, k].
//
// Layout: word n holds candidates PACK*n ... PACK*n + PACK - 1 (the
// wrapper interleaves them, as the TPU wrapper does).  A thread owns one
// window and kWords words in registers; the block's words come through
// shared memory.  The text loop runs exactly m rows.
//
// What bounds it on this card: integer logic and adds, about 20 per (word,
// window, text symbol) for PACK candidates.  k and maxerr are arguments;
// PACK is a template parameter, switched at the C entry.
//
// Built by approx_counter_tpu_torch/kernels/_build.py with nvcc for sm_90a
// and called through ctypes.

#include "approx_common.cuh"

namespace {

using approx::kBlock;

constexpr int kWords = 8;  // packed words per thread (and per block)

template <int PACK>
struct Swar {
  static constexpr int kFw = 32 / PACK;
  static constexpr uint32_t kOnes = PACK == 2 ? 0x00010001u : 0x01010101u;
  static constexpr uint32_t kH = kOnes << (kFw - 1);
  static constexpr uint32_t kLeak = ~kOnes;
  static constexpr uint32_t kFieldMask = (1u << kFw) - 1u;
  static __device__ __forceinline__ uint32_t min_fields(uint32_t a,
                                                        uint32_t b) {
    return PACK == 2 ? __vminu2(a, b) : __vminu4(a, b);
  }
};

template <int PACK>
__global__ void __launch_bounds__(kBlock)
bpm_packed_kernel(const uint32_t* __restrict__ words,
                  const uint8_t* __restrict__ windows_t,
                  const uint8_t* __restrict__ wvalid,
                  int32_t* __restrict__ out, int n_words, int m, int W, int k,
                  int maxerr) {
  static_assert(PACK == 2 || PACK == 4, "Myers packs 2 or 4 fields");
  using S = Swar<PACK>;
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
  if (tid < kSlots) s_acc[tid] = 0;
  __syncthreads();

  uint32_t mask0[kWords], mask1[kWords], VP[kWords], VN[kWords];
  uint32_t score[kWords], mins[kWords];
#pragma unroll
  for (int i = 0; i < kWords; ++i) {
    mask0[i] = s_mask[0][i];
    mask1[i] = s_mask[1][i];
    VP[i] = approx::kFull;
    VN[i] = 0u;
    score[i] = static_cast<uint32_t>(k) * S::kOnes;  // k in every field
    mins[i] = score[i];
  }
  const int top = k - 1;  // each field's score reads its bit k-1

  approx::scan_text(windows_t, w, in_range, m, W, [&](approx::TextMasks t) {
#pragma unroll
    for (int i = 0; i < kWords; ++i) {
      const uint32_t Eq = approx::eq_select(mask0[i], mask1[i], t);
      const uint32_t Xv = Eq | VN[i];
      const uint32_t a = Eq & VP[i];
      const uint32_t add = ((a & ~S::kH) + (VP[i] & ~S::kH)) ^ ((a ^ VP[i]) & S::kH);
      const uint32_t Xh = (add ^ VP[i]) | Eq;
      uint32_t Ph = VN[i] | ~(Xh | VP[i]);
      uint32_t Mh = VP[i] & Xh;
      score[i] = score[i] + ((Ph >> top) & S::kOnes) - ((Mh >> top) & S::kOnes);
      mins[i] = S::min_fields(mins[i], score[i]);
      Ph = (Ph << 1) & S::kLeak;
      Mh = (Mh << 1) & S::kLeak;
      VP[i] = Mh | ~(Xv | Ph);
      VN[i] = Ph & Xv;
    }
  });

  int value[kSlots];
#pragma unroll
  for (int i = 0; i < kWords; ++i) {
#pragma unroll
    for (int f = 0; f < PACK; ++f) {
      const int mn = static_cast<int>((mins[i] >> (S::kFw * f)) & S::kFieldMask);
      value[i * PACK + f] = valid ? max(0, maxerr + 1 - mn) : 0;
    }
  }
  approx::block_add(value, s_acc, out, n0 * PACK,
                    static_cast<long long>(n_words) * PACK);
}

}  // namespace

// out[n_words * pack] must be zeroed by the caller; out[pack*n + f] is the
// count of field f of word n.  words is [n_words, 4] uint32 (interleaved
// peq), windows_t is [m, W] uint8, wvalid is [W] bytes (0 or 1).  Returns
// the cudaError_t of the launch (0 on success).
extern "C" int bpm_packed(const void* words, const void* windows_t,
                          const void* wvalid, void* out, int n_words, int m,
                          int W, int k, int maxerr, int pack, void* stream) {
  const int groups = (n_words + kWords - 1) / kWords;
  if (n_words <= 0 || groups > 65535 || W <= 0 || m < 0 || k < 2 ||
      maxerr < 0 || maxerr > 3 || (pack != 2 && pack != 4) || k > 32 / pack)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((W + kBlock - 1) / kBlock, groups);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* wp = static_cast<const uint32_t*>(words);
  const auto* tp = static_cast<const uint8_t*>(windows_t);
  const auto* vp = static_cast<const uint8_t*>(wvalid);
  auto* op = static_cast<int32_t*>(out);
  if (pack == 2)
    bpm_packed_kernel<2><<<grid, kBlock, 0, s>>>(wp, tp, vp, op, n_words, m, W, k, maxerr);
  else
    bpm_packed_kernel<4><<<grid, kBlock, 0, s>>>(wp, tp, vp, op, n_words, m, W, k, maxerr);
  return static_cast<int>(cudaGetLastError());
}
