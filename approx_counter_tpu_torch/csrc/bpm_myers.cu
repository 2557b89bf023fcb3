// Unpacked Myers bit-vector DP: approximate k-mer counts on Hopper.
//
// Replaces approx_counter_tpu/kernels/bpm.py:_bpm_kernel (the Pallas TPU
// kernel behind approx_counts_pallas).  It computes the same function: for
// each candidate k-mer c, the sum over valid windows w of
// max(0, maxerr + 1 - d_min(c, w)), where d_min is the least edit distance
// between c and any substring of w (Myers 1999, semi-global: the score starts
// at k and its running minimum over the text is d_min).  Text symbols >= 4
// (N, pad) match nothing.  The result is int32 and exact.
//
// Layout: one 32-bit state word (VP, VN) plus a score and its minimum per
// (candidate, window).  A thread owns one window and kCands candidates, all
// in registers; the block's kCands candidates' masks come through shared
// memory.  The text loop runs exactly m rows: the TPU kernel's padding of m
// to 8 rows was a vector-layout constraint, and pad symbols cannot lower
// d_min anyway.
//
// What bounds it on this card: integer logic and adds, about 17 per
// (candidate, window, text symbol), against one byte of text per window and
// step shared by the thread's kCands candidates.  k and maxerr are arguments:
// k only sets the score bit and maxerr only the final clamp.
//
// Built by approx_counter_tpu_torch/kernels/_build.py with nvcc for sm_90a
// and called through ctypes.

#include "approx_common.cuh"

namespace {

using approx::kBlock;

constexpr int kCands = 8;  // candidates per thread (and per block)

__global__ void __launch_bounds__(kBlock)
bpm_myers_kernel(const uint32_t* __restrict__ peq,
                 const uint8_t* __restrict__ windows_t,
                 const uint8_t* __restrict__ wvalid,
                 int32_t* __restrict__ out, int C, int m, int W, int k,
                 int maxerr) {
  __shared__ uint32_t s_mask[2][kCands];
  __shared__ int s_acc[kCands];

  const long long c0 = static_cast<long long>(blockIdx.y) * kCands;
  const int tid = threadIdx.x;
  const long long w = static_cast<long long>(blockIdx.x) * kBlock + tid;
  const bool in_range = w < W;
  const bool valid = in_range && wvalid[w] != 0;

  if (tid < kCands) {
    const long long c = c0 + tid;
    const uint32_t* p = peq + 4 * (c < C ? c : 0);
    s_mask[0][tid] = c < C ? p[1] | p[3] : 0u;  // bases C, T: bit 0 set
    s_mask[1][tid] = c < C ? p[2] | p[3] : 0u;  // bases G, T: bit 1 set
    s_acc[tid] = 0;
  }
  __syncthreads();

  uint32_t mask0[kCands], mask1[kCands], VP[kCands], VN[kCands];
  int score[kCands], minsc[kCands];
#pragma unroll
  for (int i = 0; i < kCands; ++i) {
    mask0[i] = s_mask[0][i];
    mask1[i] = s_mask[1][i];
    VP[i] = approx::kFull;
    VN[i] = 0u;
    score[i] = k;
    minsc[i] = k;
  }
  const int top = k - 1;  // the score reads bit k-1

  approx::scan_text(windows_t, w, in_range, m, W, [&](approx::TextMasks t) {
#pragma unroll
    for (int i = 0; i < kCands; ++i) {
      const uint32_t Eq = approx::eq_select(mask0[i], mask1[i], t);
      const uint32_t Xv = Eq | VN[i];
      const uint32_t Xh = (((Eq & VP[i]) + VP[i]) ^ VP[i]) | Eq;
      uint32_t Ph = VN[i] | ~(Xh | VP[i]);
      uint32_t Mh = VP[i] & Xh;
      score[i] += static_cast<int>((Ph >> top) & 1u) -
                  static_cast<int>((Mh >> top) & 1u);
      Ph <<= 1;
      Mh <<= 1;
      VP[i] = Mh | ~(Xv | Ph);
      VN[i] = Ph & Xv;
      minsc[i] = min(minsc[i], score[i]);
    }
  });

  int value[kCands];
#pragma unroll
  for (int i = 0; i < kCands; ++i)
    value[i] = valid ? max(0, maxerr + 1 - minsc[i]) : 0;
  approx::block_add(value, s_acc, out, c0, C);
}

}  // namespace

// out[C] must be zeroed by the caller.  peq is [C, 4] uint32 (bit i of
// peq[c][b] set iff pattern base i of candidate c is b), windows_t is [m, W]
// uint8, wvalid is [W] bytes (0 or 1).  Returns the cudaError_t of the
// launch (0 on success).
extern "C" int bpm_myers(const void* peq, const void* windows_t,
                         const void* wvalid, void* out, int C, int m, int W,
                         int k, int maxerr, void* stream) {
  const int groups = (C + kCands - 1) / kCands;
  if (C <= 0 || groups > 65535 || W <= 0 || m < 0 || k < 2 || k > 32 ||
      maxerr < 0 || maxerr > 3)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((W + kBlock - 1) / kBlock, groups);
  bpm_myers_kernel<<<grid, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(peq), static_cast<const uint8_t*>(windows_t),
      static_cast<const uint8_t*>(wvalid), static_cast<int32_t*>(out), C, m, W,
      k, maxerr);
  return static_cast<int>(cudaGetLastError());
}
