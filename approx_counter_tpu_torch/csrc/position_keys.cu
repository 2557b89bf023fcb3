// The exact stage's step 1 on a window batch in one kernel: the sort-ready
// int64 key of every sliding position, and the batch's valid and
// N-containing position totals.
//
// Replaces no TPU kernel: the JAX package packs the k-mers with jnp ops
// that XLA fuses into one loop.  The port's plain version
// (kernels/exact_stage.py:position_keys_ref, count/exact.py before it)
// runs k iterations of seven elementwise ops over every position, then the
// masks and keys: about 120 launches a pass at k = 16, each one reading
// and writing the whole int64 [p, n] code array.
//
// The function, on text-major uint8 windows [m, n] (row j holds base j of
// every window; 0-3 ACGT, 4 N, >= 5 pad) and a bool row mask [n]: for
// position i of window w (p = m - k + 1 positions a window) the k-mer of
// rows i..i+k-1 packed two bits a base, first base highest (at k = 32 the
// code fills the 64 bits, as the int64 shift wraps); it is valid when its
// window is real and it holds no N and no pad.  keys[i * n + w] is the code
// XOR the sign bit when valid and the sign bit alone otherwise: invalid
// positions sort as code 0, and the signed sort of the keys is the unsigned
// sort of the codes.  totals[0] counts the valid positions, totals[1] the
// positions of real windows that hold an N and no pad.
//
// Layout: one thread a window column.  It rolls the code down its column,
// so each base is read once, and a warp's 32 threads read 32 neighbouring
// bytes of a row and write 32 neighbouring keys of a position (256 bytes):
// every access coalesces.  The last row that held an N and the last that
// held a pad tell whether the k rows behind the current one hold either.
// What bounds it: the 8-byte key a position, written once (27.5 MB at the
// default run's 3.44 M positions); the totals are block sums of integers
// and one 64-bit atomic each a block, so they are exact and do not depend
// on the order the blocks run in.
//
// Built by approx_counter_tpu_torch/kernels/_build.py with nvcc for sm_90a
// and called through ctypes.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr unsigned long long kSign = 1ull << 63;

__device__ __forceinline__ unsigned long long warp_sum(unsigned long long v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(~0u, v, off);
  return v;
}

__global__ void __launch_bounds__(kThreads)
position_keys_kernel(const uint8_t* __restrict__ win,
                     const uint8_t* __restrict__ row_mask,
                     long long* __restrict__ keys,
                     unsigned long long* __restrict__ totals, int m, int n,
                     int k) {
  const int w = blockIdx.x * kThreads + threadIdx.x;
  unsigned long long n_valid = 0, had_n = 0;
  if (w < n) {
    const bool real = row_mask[w] != 0;
    const unsigned long long mask = k == 32 ? ~0ull : (1ull << (2 * k)) - 1;
    unsigned long long code = 0;
    int last_n = -1, last_pad = -1;  // the last row with an N, with a pad
    const uint8_t* col = win + w;
    long long* out = keys + w;
#pragma unroll 8
    for (int j = 0; j < m; ++j) {
      const unsigned sym = col[static_cast<size_t>(j) * n];
      code = ((code << 2) | (sym & 3)) & mask;
      last_n = sym == 4 ? j : last_n;
      last_pad = sym >= 5 ? j : last_pad;
      const int i = j - k + 1;  // the position whose k-mer ends at row j
      if (i >= 0) {
        const bool has_n = last_n >= i;
        const bool has_pad = last_pad >= i;
        const bool valid = real && !has_n && !has_pad;
        out[static_cast<size_t>(i) * n] =
            static_cast<long long>((valid ? code : 0ull) ^ kSign);
        n_valid += valid;
        had_n += real && has_n && !has_pad;
      }
    }
  }
  __shared__ unsigned long long part[2][kWarps];
  n_valid = warp_sum(n_valid);
  had_n = warp_sum(had_n);
  const int warp = threadIdx.x / 32;
  if (threadIdx.x % 32 == 0) {
    part[0][warp] = n_valid;
    part[1][warp] = had_n;
  }
  __syncthreads();
  if (threadIdx.x < 2) {
    unsigned long long s = 0;
#pragma unroll
    for (int i = 0; i < kWarps; ++i) s += part[threadIdx.x][i];
    if (s) atomicAdd(totals + threadIdx.x, s);
  }
}

}  // namespace

// windows: uint8 [m, n], contiguous; row_mask: bool [n]; keys: int64
// [(m - k + 1) * n]; totals: int64 [2], zeroed here on the stream before
// the kernel adds to it.  2 <= k <= 32, k <= m.  Returns the cudaError_t
// of the memset or of the launch (0 on success).
extern "C" int position_keys(const void* windows, const void* row_mask,
                             void* keys, void* totals, int m, int n, int k,
                             void* stream) {
  if (k < 2 || k > 32 || m < k || n < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  auto* tot = static_cast<unsigned long long*>(totals);
  const cudaError_t e = cudaMemsetAsync(tot, 0, 2 * sizeof(*tot), s);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (n == 0) return 0;
  const int blocks = (n + kThreads - 1) / kThreads;
  position_keys_kernel<<<blocks, kThreads, 0, s>>>(
      static_cast<const uint8_t*>(windows),
      static_cast<const uint8_t*>(row_mask), static_cast<long long*>(keys),
      tot, m, n, k);
  return static_cast<int>(cudaGetLastError());
}
