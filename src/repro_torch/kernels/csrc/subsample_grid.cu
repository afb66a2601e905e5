// subsample_grid.cu: the paper's binned subsample statistics (EAGLET `alod`,
// Netflix `monthly_mean`) for a wave of map tasks, for Hopper (sm_90a).
//
// Replaces no Pallas kernel: the reference computes these with XLA
// scatter-adds, src/repro/core/subsample.py::map_task (:89-91, :98-100)
// under jax.vmap in src/repro/platform/compute.py::_jnp_wave_jit (:434).
// Its plain version is repro_torch/kernels/ref.py::grid_partial.
//
// Computes, for every task b of a wave, with block = data[rows[b]]
// ([ns, sl] fp32; months[rows[b]] int32 beside it) and indices
// idx[b] [draws, ns, ds] int32 in [0, sl):
//   out[b, 0, c] = sum of value(s, d, j) over the (s, d, j) whose cell is c
//   out[b, 1, c] = how many (s, d, j) have cell c
// where x = block[s, idx[d, s, j]] and
//   alod:         cell = clamp(trunc(fl(fl(idx / sl) * grid)), 0, grid - 1),
//                 value = |x - mean| / (std + 1e-6), the mean and the
//                 population std taken over the ds values of row (s, d)
//   monthly_mean: cell = clamp(months[rows[b]][s, idx], 0, grid - 1),
//                 value = x
// The arena is read through the slot vector `rows`: no copy of the wave's
// blocks is made.
//
// Determinism.  PyTorch's scatter-adds on the card (index_add_,
// scatter_add_, a weighted bincount) add floats with atomics in an order
// that changes from launch to launch; the platform needs wave == per-task
// == repeat runs bit for bit.  So nothing here adds a float with an
// atomic.  Every sum has one fixed order that depends on neither the wave
// width B, nor the slot, nor the run:
//   * one CTA of kWarps warps per (task b, sample s); warp w takes the
//     draws d = w, w + kWarps, ...;
//   * the mean and the sum of squared deviations of a row: each lane adds
//     its elements j = lane, lane + 32, ... in order, then a fixed xor
//     shuffle tree (every lane ends with the same bits: a + b == b + a);
//   * binning, 32 elements a round: lanes with one cell are found with
//     __match_any_sync; the lowest of them adds the group's values in lane
//     order and adds that to its warp's own bins in shared memory;
//   * the warps' bins are added in warp order into the (b, s) partial,
//     written to scratch; a second kernel adds the samples of each task
//     in sample order.
// Counts are whole numbers below 2^24 (checked by the wrapper), so they
// are exact whatever the order.  The cell arithmetic is the reference's
// IEEE fp32 divide and multiply (__fdiv_rn, __fmul_rn) and a truncation,
// with no fast-math flags, so a cell is the reference's to the bit.
//
// Bound: bytes.  The indices are read once (4 bytes a drawn element) and
// each drawn element of the block (and of the months) once; the
// arithmetic is a few fp32 operations an element.  The gather is random:
// each 4-byte element costs a 32-byte sector that no neighbour shares,
// which is the thesis' cache-hostile access pattern; `alod` reads each
// row's elements three times (mean, deviations, binning), the second and
// third from L1/L2.  Later work: keep a row in registers, stage bins
// across draws, fuse the index draw.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxGrid = 512;  // bins a warp holds in shared memory
constexpr unsigned kFull = 0xffffffffu;

enum Statistic { kAlod = 0, kMonthlyMean = 1 };

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v = __fadd_rn(v, __shfl_xor_sync(kFull, v, off));
  }
  return v;
}

// Adds `value` into bin `cell` of this warp's bins for every lane with
// `active`, in a fixed order: the lanes that share a cell are added in
// lane order by the lowest of them.  Warp-collective.
__device__ __forceinline__ void bin_add(float* __restrict__ bins,
                                        unsigned* __restrict__ counts,
                                        float* __restrict__ stage, int lane,
                                        bool active, int cell, float value) {
  const int key = active ? cell : -1;
  const unsigned peers = __match_any_sync(kFull, key);
  stage[lane] = value;
  __syncwarp();
  if (active && lane == __ffs(peers) - 1) {
    float acc = value;
    unsigned rest = peers & (peers - 1);  // the leader's own bit cleared
    while (rest) {
      const int l = __ffs(rest) - 1;
      acc = __fadd_rn(acc, stage[l]);
      rest &= rest - 1;
    }
    bins[cell] = __fadd_rn(bins[cell], acc);
    counts[cell] += static_cast<unsigned>(__popc(peers));
  }
  __syncwarp();
}

template <int STAT>
__global__ void __launch_bounds__(kThreads)
grid_partial_kernel(const float* __restrict__ data,
                    const int32_t* __restrict__ months,
                    const int32_t* __restrict__ rows,
                    const int32_t* __restrict__ idx,
                    float* __restrict__ scratch, int64_t ns, int64_t sl,
                    int draws, int ds, int grid) {
  extern __shared__ float smem[];
  float* bins_all = smem;                                   // [kWarps][grid]
  unsigned* counts_all =
      reinterpret_cast<unsigned*>(smem + kWarps * grid);    // [kWarps][grid]
  float* stage_all = smem + 2 * kWarps * grid;              // [kWarps][32]

  const int64_t s = blockIdx.x;
  const int64_t b = blockIdx.y;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  for (int i = threadIdx.x; i < kWarps * grid; i += kThreads) {
    bins_all[i] = 0.0f;
    counts_all[i] = 0u;
  }
  __syncthreads();

  float* bins = bins_all + warp * grid;
  unsigned* counts = counts_all + warp * grid;
  float* stage = stage_all + warp * 32;

  const int64_t slot = rows[b];
  const float* __restrict__ row_data = data + (slot * ns + s) * sl;
  const int32_t* __restrict__ row_months =
      STAT == kMonthlyMean ? months + (slot * ns + s) * sl : nullptr;
  const float sl_f = static_cast<float>(sl);
  const float grid_f = static_cast<float>(grid);
  const float ds_f = static_cast<float>(ds);

  for (int d = warp; d < draws; d += kWarps) {
    const int32_t* __restrict__ row_idx =
        idx + ((b * draws + d) * ns + s) * static_cast<int64_t>(ds);
    float mean = 0.0f, sd = 0.0f;
    if constexpr (STAT == kAlod) {
      float acc = 0.0f;
      for (int j = lane; j < ds; j += 32) {
        acc = __fadd_rn(acc, __ldg(row_data + __ldg(row_idx + j)));
      }
      mean = __fdiv_rn(warp_sum(acc), ds_f);
      float sq = 0.0f;
      for (int j = lane; j < ds; j += 32) {
        const float dev =
            __fsub_rn(__ldg(row_data + __ldg(row_idx + j)), mean);
        sq = __fadd_rn(sq, __fmul_rn(dev, dev));
      }
      sd = __fadd_rn(__fsqrt_rn(__fdiv_rn(warp_sum(sq), ds_f)), 1e-6f);
    }
    for (int j0 = 0; j0 < ds; j0 += 32) {
      const int j = j0 + lane;
      const bool active = j < ds;
      int cell = 0;
      float value = 0.0f;
      if (active) {
        const int32_t ix = __ldg(row_idx + j);
        const float x = __ldg(row_data + ix);
        if constexpr (STAT == kAlod) {
          const float pos = __fdiv_rn(static_cast<float>(ix), sl_f);
          cell = __float2int_rz(__fmul_rn(pos, grid_f));
          value = fabsf(__fdiv_rn(__fsub_rn(x, mean), sd));
        } else {
          cell = __ldg(row_months + ix);
          value = x;
        }
        cell = min(max(cell, 0), grid - 1);
      }
      bin_add(bins, counts, stage, lane, active, cell, value);
    }
  }
  __syncthreads();

  float* out = scratch + (b * ns + s) * 2 * static_cast<int64_t>(grid);
  for (int c = threadIdx.x; c < grid; c += kThreads) {
    float acc = 0.0f;
    unsigned n = 0u;
    for (int w = 0; w < kWarps; ++w) {
      acc = __fadd_rn(acc, bins_all[w * grid + c]);
      n += counts_all[w * grid + c];
    }
    out[c] = acc;
    out[grid + c] = static_cast<float>(n);
  }
}

// out[b, r, c] = sum over s in order of scratch[b, s, r, c].
__global__ void __launch_bounds__(kThreads)
sum_samples_kernel(const float* __restrict__ scratch, float* __restrict__ out,
                   int64_t ns, int grid) {
  const int64_t b = blockIdx.x;
  const float* __restrict__ task = scratch + b * ns * 2 * grid;
  for (int k = threadIdx.x; k < 2 * grid; k += kThreads) {
    float acc = 0.0f;
    for (int64_t s = 0; s < ns; ++s) {
      acc = __fadd_rn(acc, task[s * 2 * grid + k]);
    }
    out[b * 2 * grid + k] = acc;
  }
}

}  // namespace

// Launch both kernels on `stream` (PyTorch's current stream).  Pointers
// are device pointers; the caller has checked shapes, dtypes, contiguity
// and that rows lie in [0, n_slots) and indices in [0, sl).  `scratch`
// holds b * ns * 2 * grid floats.  Returns cudaGetLastError() after the
// launches.
extern "C" int subsample_grid_launch(const void* data, const void* months,
                                     const void* rows, const void* idx,
                                     void* scratch, void* out, int64_t b,
                                     int64_t ns, int64_t sl, int draws, int ds,
                                     int grid, int statistic, void* stream) {
  if (grid < 1 || grid > kMaxGrid || draws < 0 || ds < 0 || b > 65535 ||
      ns > 2147483647 || (statistic != kAlod && statistic != kMonthlyMean) ||
      (statistic == kMonthlyMean && months == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (b == 0) return static_cast<int>(cudaSuccess);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* x = static_cast<const float*>(data);
  const int32_t* mo = static_cast<const int32_t*>(months);
  const int32_t* r = static_cast<const int32_t*>(rows);
  const int32_t* ix = static_cast<const int32_t*>(idx);
  float* part = static_cast<float*>(scratch);
  float* o = static_cast<float*>(out);
  if (ns > 0) {
    const size_t smem = sizeof(float) * (2 * kWarps * grid + kWarps * 32);
    const dim3 blocks(static_cast<unsigned>(ns), static_cast<unsigned>(b));
    if (statistic == kAlod) {
      grid_partial_kernel<kAlod><<<blocks, kThreads, smem, st>>>(
          x, mo, r, ix, part, ns, sl, draws, ds, grid);
    } else {
      grid_partial_kernel<kMonthlyMean><<<blocks, kThreads, smem, st>>>(
          x, mo, r, ix, part, ns, sl, draws, ds, grid);
    }
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  sum_samples_kernel<<<static_cast<unsigned>(b), kThreads, 0, st>>>(
      part, o, ns, grid);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* subsample_grid_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
