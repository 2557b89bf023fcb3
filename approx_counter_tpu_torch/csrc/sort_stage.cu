// Compare-exchange stage network on int32 [rows, 128]: the bitonic-stage
// probe on Hopper.
//
// Replaces the Pallas kernel `kernel` in make_probe
// (native/sort_stage_probe5.py:48), which measured the stage rate a
// hand-written blocked bitonic sort would run at.  It computes the same
// function: split the rows into groups of 16; a stage compares rows 0-7 of
// each group with rows 8-15 of the same lane (signed int32) and puts the
// minimum first and the maximum second.  With transpose_every == 0 it runs
// `stages` stages; with transpose_every = t > 0 it runs stages / t levels,
// each t stages followed by a transpose of every 128 x 128 tile (the
// remainder, stages % t, is not run, as in the probe).  The result is exact.
//
// Layout: groups never cross a tile and tiles never cross each other, so a
// CTA owns one 128 x 128 tile and nothing passes between CTAs (the TPU
// kernel's [8192, 128] VMEM blocks were a VMEM size, not part of the
// function).  Thread t holds lane t % 128 of group t / 128: its 16 rows,
// 8 (min, max) pairs, in registers, so a stage is 16 register min/max and
// no memory traffic.  A warp loads and stores 32 neighbouring lanes of a
// row: 128 coalesced bytes.  The transpose goes through a [128][129] int32
// shared tile; the pad column puts both the row-wise writes and the
// column-wise reads of a warp on 32 different banks.
//
// What bounds it on this card: the integer pipe.  A stage is one min or max
// per element, 16 per thread, against 8 bytes per element moved once for
// the whole network.  A CTA loads, runs every stage, then stores, so the
// load and store do not overlap the stages; with all tiles in one wave the
// bytes add to the stages' time.  The stage loop keeps `#pragma unroll 1`
// and a runtime trip count: a stage is idempotent, and an unrolled chain
// of them is one the compiler may fold into a single stage, which would
// leave the result right and the time meaningless.
//
// Built by approx_counter_tpu_torch/kernels/_build.py with nvcc for sm_90a
// and called through ctypes.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kLanes = 128;              // row width, also the tile's side
constexpr int kGroup = 16;               // rows of a compare-exchange group
constexpr int kHalf = kGroup / 2;        // the partner distance
constexpr int kThreads = kLanes * kLanes / kGroup;  // 1024 per tile
constexpr int kPitch = kLanes + 1;       // padded shared row
constexpr int kSmemBytes = kLanes * kPitch * static_cast<int>(sizeof(int32_t));

__device__ __forceinline__ void stage(int32_t (&v)[kGroup]) {
#pragma unroll
  for (int i = 0; i < kHalf; ++i) {
    const int32_t lo = min(v[i], v[i + kHalf]);
    const int32_t hi = max(v[i], v[i + kHalf]);
    v[i] = lo;
    v[i + kHalf] = hi;
  }
}

__device__ __forceinline__ void run_stages(int32_t (&v)[kGroup], int n) {
#pragma unroll 1
  for (int s = 0; s < n; ++s) stage(v);
}

template <bool kTranspose>
__global__ void __launch_bounds__(kThreads)
sort_stage_kernel(const int32_t* __restrict__ in, int32_t* __restrict__ out,
                  int rows, int stages, int transpose_every) {
  const int lane = threadIdx.x % kLanes;
  const int row_in_tile = threadIdx.x / kLanes * kGroup;
  const long long row0 =
      static_cast<long long>(blockIdx.x) * kLanes + row_in_tile;
  // a partial last tile (no transposes) has fewer groups; no barrier
  // follows on that path
  if (!kTranspose && row0 >= rows) return;

  int32_t v[kGroup];
  const int32_t* src = in + row0 * kLanes + lane;
#pragma unroll
  for (int r = 0; r < kGroup; ++r) v[r] = src[r * kLanes];

  if (kTranspose) {
    extern __shared__ int32_t tile[];  // [kLanes][kPitch]
    const int levels = stages / transpose_every;
#pragma unroll 1
    for (int l = 0; l < levels; ++l) {
      run_stages(v, transpose_every);
      __syncthreads();  // the previous level's reads are done
#pragma unroll
      for (int r = 0; r < kGroup; ++r)
        tile[(row_in_tile + r) * kPitch + lane] = v[r];
      __syncthreads();
#pragma unroll
      for (int r = 0; r < kGroup; ++r)
        v[r] = tile[lane * kPitch + row_in_tile + r];
    }
  } else {
    run_stages(v, stages);
  }

  int32_t* dst = out + row0 * kLanes + lane;
#pragma unroll
  for (int r = 0; r < kGroup; ++r) dst[r * kLanes] = v[r];
}

}  // namespace

// in and out are int32 [rows, 128], distinct.  rows % 16 == 0, and
// rows % 128 == 0 when transpose_every > 0; stages >= 0.  Returns the
// cudaError_t of the shared-memory attribute or of the launch (0 on
// success).
extern "C" int sort_stage(const void* in, void* out, int rows, int stages,
                          int transpose_every, void* stream) {
  if (rows < 0 || rows % kGroup || stages < 0 || transpose_every < 0 ||
      (transpose_every > 0 && rows % kLanes))
    return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0) return 0;
  const int tiles = (rows + kLanes - 1) / kLanes;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* x = static_cast<const int32_t*>(in);
  auto* y = static_cast<int32_t*>(out);
  if (transpose_every > 0) {
    const cudaError_t e = cudaFuncSetAttribute(
        sort_stage_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kSmemBytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    sort_stage_kernel<true><<<tiles, kThreads, kSmemBytes, s>>>(
        x, y, rows, stages, transpose_every);
  } else {
    sort_stage_kernel<false><<<tiles, kThreads, 0, s>>>(x, y, rows, stages, 0);
  }
  return static_cast<int>(cudaGetLastError());
}
