// subsample_grid.cu: the paper's binned subsample statistics (EAGLET `alod`,
// Netflix `monthly_mean`) for a wave of map tasks, for Hopper (sm_90a).
//
// Replaces no Pallas kernel: the reference computes these in one jitted
// program, src/repro/core/subsample.py::map_task (the draws with
// jax.random.randint at :70, XLA scatter-adds at :89-91, :98-100) under
// jax.vmap in src/repro/platform/compute.py::_jnp_wave_jit (:434).  Its
// plain versions are repro_torch/kernels/ref.py::grid_partial and, with
// the draws, ref.py::subsample_grid_seeded_ref.
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
// Two index sources, one template:
//   * Draw (subsample_grid_seeded_launch, the platform's path): idx[b] is
//     jax.random.randint(PRNGKey(seeds[b]), (draws, ns, ds), 0, sl), drawn
//     in the kernel (threefry.cuh): the CTA (b, s) derives the split keys
//     of seed b once, and element (d, s, j) is the draw at the flat
//     counter n = (d * ns + s) * ds + j.  The indices never exist in
//     memory.  `alod` visits a row three times (mean, deviations,
//     binning); the first pass keeps each index it draws in a per-warp
//     stash of ds ints in shared memory, and the later passes read it
//     there (each lane reads back only what it wrote).  Where the stash
//     would take the CTA past 48 KB of shared memory (ds above about
//     1,300 at grid 64), the later passes draw the index again.
//   * Read (subsample_grid_launch): idx from memory, as given.  It is the
//     oracle the draw form is held against: with the same indices the
//     two add the same values in the same order, so they agree bit for
//     bit.
// threefry_randint_launch writes the drawn indices out, [B, n] int32, so
// that the card's draws can be held against prng.randint.
//
// Bound: operations, for the draw form.  Each drawn element costs one
// Threefry-2x32 hash, about 75 32-bit integer operations, when the
// span's multiplier is 0 (every power-of-two sl, which the platform's
// blocks have), and two hashes and three remainders, about 150, when it
// is not.  At 16.7 T INT32 operations a second (derived: 64 INT32
// results a clock an SM x 132 SMs x 1.98 GHz; the data sheet lists no
// INT32 rate) that outweighs the bytes: no index is read, each drawn
// element of the block (and of the months) once, and a few fp32
// operations an element.  The gather is random: each 4-byte element
// costs a 32-byte sector that no neighbour shares, which is the thesis'
// cache-hostile access pattern; `alod` reads each row's elements three
// times, the second and third from L1/L2.  The read form also reads 4
// bytes of index a drawn element and is bound by bytes.  Later work:
// keep a row's values in registers, stage bins across draws.

#include <cuda_runtime.h>
#include <stdint.h>

#include "threefry.cuh"

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

// Read: indices from memory, idx [B, draws, ns, ds] int32.
struct ReadIndices {
  const int32_t* __restrict__ idx;

  struct Row {
    const int32_t* __restrict__ base;  // &idx[b, 0, s, 0]
    int64_t draw_stride;               // ns * ds
    __device__ __forceinline__ int operator()(int d, int j) const {
      return __ldg(base + d * draw_stride + j);
    }
  };
  __device__ __forceinline__ Row row(int64_t b, int64_t s, int64_t ns,
                                     int draws, int ds) const {
    return Row{idx + ((b * draws) * ns + s) * ds, ns * ds};
  }
};

// Draw: jax's randint(PRNGKey(seeds[b]), (draws, ns, ds), 0, sl).
struct DrawIndices {
  const int32_t* __restrict__ seeds;
  threefry::Span span;  // sl and its multiplier

  struct Row {
    threefry::Key k1, k2;
    uint32_t base, draw_stride;  // s * ds, ns * ds: n = d * stride + base + j
    threefry::Span span;
    __device__ __forceinline__ int operator()(int d, int j) const {
      const uint32_t n = static_cast<uint32_t>(d) * draw_stride + base +
                         static_cast<uint32_t>(j);
      return static_cast<int>(threefry::randint_at(k1, k2, n, span));
    }
  };
  __device__ __forceinline__ Row row(int64_t b, int64_t s, int64_t ns,
                                     int /*draws*/, int ds) const {
    const threefry::Key key = threefry::jax_key(__ldg(seeds + b));
    const threefry::Key k1 = span.multiplier
                                 ? threefry::jax_split_first(key)
                                 : threefry::Key{0u, 0u};
    return Row{k1, threefry::jax_split_second(key),
               static_cast<uint32_t>(s * ds), static_cast<uint32_t>(ns * ds),
               span};
  }
};

// `stash_ds` is ds when each warp keeps its row's indices in shared memory
// for `alod`'s second and third passes, else 0 (they are fetched again
// from the source).
template <int STAT, class Indices>
__global__ void __launch_bounds__(kThreads)
grid_partial_kernel(const float* __restrict__ data,
                    const int32_t* __restrict__ months,
                    const int32_t* __restrict__ rows, const Indices indices,
                    float* __restrict__ scratch, int64_t ns, int64_t sl,
                    int draws, int ds, int grid, int stash_ds) {
  extern __shared__ float smem[];
  float* bins_all = smem;                                   // [kWarps][grid]
  unsigned* counts_all =
      reinterpret_cast<unsigned*>(smem + kWarps * grid);    // [kWarps][grid]
  float* stage_all = smem + 2 * kWarps * grid;              // [kWarps][32]
  int32_t* stash_all = reinterpret_cast<int32_t*>(
      stage_all + kWarps * 32);                             // [kWarps][stash_ds]

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
  int32_t* stash = stash_all + warp * stash_ds;

  const int64_t slot = rows[b];
  const float* __restrict__ row_data = data + (slot * ns + s) * sl;
  const int32_t* __restrict__ row_months =
      STAT == kMonthlyMean ? months + (slot * ns + s) * sl : nullptr;
  const float sl_f = static_cast<float>(sl);
  const float grid_f = static_cast<float>(grid);
  const float ds_f = static_cast<float>(ds);
  const auto index = indices.row(b, s, ns, draws, ds);

  for (int d = warp; d < draws; d += kWarps) {
    // the index of element j of this row once the first pass has run
    auto again = [&](int j) { return stash_ds ? stash[j] : index(d, j); };
    float mean = 0.0f, sd = 0.0f;
    if constexpr (STAT == kAlod) {
      float acc = 0.0f;
      for (int j = lane; j < ds; j += 32) {
        const int ix = index(d, j);
        if (stash_ds) stash[j] = ix;
        acc = __fadd_rn(acc, __ldg(row_data + ix));
      }
      mean = __fdiv_rn(warp_sum(acc), ds_f);
      float sq = 0.0f;
      for (int j = lane; j < ds; j += 32) {
        const float dev = __fsub_rn(__ldg(row_data + again(j)), mean);
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
        const int ix = STAT == kAlod ? again(j) : index(d, j);
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

// out[b, n] = jax.random.randint(PRNGKey(seeds[b]), (n_total,), lo,
// lo + span)[n], for n < n_total.
__global__ void __launch_bounds__(kThreads)
threefry_randint_kernel(const int32_t* __restrict__ seeds,
                        int32_t* __restrict__ out, int64_t n_total,
                        uint32_t lo, threefry::Span span) {
  const int64_t b = blockIdx.y;
  const threefry::Key key = threefry::jax_key(__ldg(seeds + b));
  const threefry::Key k1 = span.multiplier ? threefry::jax_split_first(key)
                                           : threefry::Key{0u, 0u};
  const threefry::Key k2 = threefry::jax_split_second(key);
  int32_t* __restrict__ row = out + b * n_total;
  for (int64_t n = blockIdx.x * static_cast<int64_t>(kThreads) + threadIdx.x;
       n < n_total; n += static_cast<int64_t>(gridDim.x) * kThreads) {
    row[n] = static_cast<int32_t>(
        lo + threefry::randint_at(k1, k2, static_cast<uint32_t>(n), span));
  }
}

constexpr size_t kStashSmem = 48 * 1024;  // no opt-in attribute needed
constexpr uint64_t kCounters = 1ull << 32;  // a key's flat positions

bool bad_shape(int64_t b, int64_t ns, int draws, int ds, int grid,
               int statistic, const void* months) {
  return grid < 1 || grid > kMaxGrid || draws < 0 || ds < 0 || b > 65535 ||
         ns > 2147483647 ||
         (statistic != kAlod && statistic != kMonthlyMean) ||
         (statistic == kMonthlyMean && months == nullptr);
}

// Both kernels on `st`; the partial kernel's template over `Indices`.
template <class Indices>
int launch(const void* data, const void* months, const void* rows,
           Indices indices, void* scratch, void* out, int64_t b, int64_t ns,
           int64_t sl, int draws, int ds, int grid, int statistic,
           bool stash, cudaStream_t st) {
  if (b == 0) return static_cast<int>(cudaSuccess);
  const float* x = static_cast<const float*>(data);
  const int32_t* mo = static_cast<const int32_t*>(months);
  const int32_t* r = static_cast<const int32_t*>(rows);
  float* part = static_cast<float*>(scratch);
  float* o = static_cast<float*>(out);
  if (ns > 0) {
    size_t smem = sizeof(float) * (2 * kWarps * grid + kWarps * 32);
    const size_t stash_bytes = sizeof(int32_t) * kWarps * ds;
    const int stash_ds = stash && statistic == kAlod &&
                                 smem + stash_bytes <= kStashSmem
                             ? ds
                             : 0;
    smem += sizeof(int32_t) * kWarps * stash_ds;
    const dim3 blocks(static_cast<unsigned>(ns), static_cast<unsigned>(b));
    if (statistic == kAlod) {
      grid_partial_kernel<kAlod, Indices><<<blocks, kThreads, smem, st>>>(
          x, mo, r, indices, part, ns, sl, draws, ds, grid, stash_ds);
    } else {
      grid_partial_kernel<kMonthlyMean, Indices>
          <<<blocks, kThreads, smem, st>>>(x, mo, r, indices, part, ns, sl,
                                           draws, ds, grid, 0);
    }
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  sum_samples_kernel<<<static_cast<unsigned>(b), kThreads, 0, st>>>(
      part, o, ns, grid);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launch both kernels on `stream` (PyTorch's current stream), the indices
// read from `idx` [b, draws, ns, ds].  Pointers are device pointers; the
// caller has checked shapes, dtypes, contiguity and that rows lie in [0,
// n_slots) and indices in [0, sl).  `scratch` holds b * ns * 2 * grid
// floats.  Returns cudaGetLastError() after the launches.
extern "C" int subsample_grid_launch(const void* data, const void* months,
                                     const void* rows, const void* idx,
                                     void* scratch, void* out, int64_t b,
                                     int64_t ns, int64_t sl, int draws, int ds,
                                     int grid, int statistic, void* stream) {
  if (bad_shape(b, ns, draws, ds, grid, statistic, months)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch(data, months, rows,
                ReadIndices{static_cast<const int32_t*>(idx)}, scratch, out,
                b, ns, sl, draws, ds, grid, statistic, false,
                static_cast<cudaStream_t>(stream));
}

// The same with task b's indices drawn in the kernel from the int32 seed
// seeds[b]: jax.random.randint(PRNGKey(seeds[b]), (draws, ns, ds), 0, sl),
// `multiplier` being prng._randint_multiplier(0, sl)'s.  Refuses sl < 1,
// sl past int32, and draws * ns * ds of 2^32 or more.
extern "C" int subsample_grid_seeded_launch(
    const void* data, const void* months, const void* rows, const void* seeds,
    void* scratch, void* out, int64_t b, int64_t ns, int64_t sl, int draws,
    int ds, int grid, int statistic, uint32_t multiplier, void* stream) {
  const uint64_t per_draw = static_cast<uint64_t>(ns) * ds;
  if (bad_shape(b, ns, draws, ds, grid, statistic, months) || sl < 1 ||
      sl > 2147483647 ||
      (per_draw > 0 &&
       static_cast<uint64_t>(draws) > (kCounters - 1) / per_draw)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const DrawIndices indices{
      static_cast<const int32_t*>(seeds),
      threefry::make_span(static_cast<uint32_t>(sl), multiplier)};
  return launch(data, months, rows, indices, scratch, out, b, ns, sl, draws,
                ds, grid, statistic, true, static_cast<cudaStream_t>(stream));
}

// out [b, n] int32 = jax.random.randint(PRNGKey(seeds[b]), (n,), lo,
// lo + span) for each int32 seed, `multiplier` being
// prng._randint_multiplier(lo, lo + span)'s.  Refuses n of 2^32 or more.
extern "C" int threefry_randint_launch(const void* seeds, void* out,
                                       int64_t b, int64_t n, int32_t lo,
                                       uint32_t span, uint32_t multiplier,
                                       void* stream) {
  if (b < 0 || b > 65535 || n < 0 || static_cast<uint64_t>(n) >= kCounters ||
      span == 0u) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (b == 0 || n == 0) return static_cast<int>(cudaSuccess);
  const int64_t tiles = (n + kThreads - 1) / kThreads;
  const dim3 blocks(static_cast<unsigned>(tiles < 1024 ? tiles : 1024),
                    static_cast<unsigned>(b));
  threefry_randint_kernel<<<blocks, kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(seeds), static_cast<int32_t*>(out), n,
      static_cast<uint32_t>(lo), threefry::make_span(span, multiplier));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* subsample_grid_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
