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
// What holds the work back, and what this design does about it (measured
// on the card against the first design, one 8-warp CTA a (task, sample)
// that drew, loaded and binned one element a lane at a time: PERF.md §6):
//   * Too few CTAs at the jobs' waves of 1-10 tasks.  A (task, sample) is
//     cut into `groups` CTAs, fixed by the shape (draws, ds, sl, grid) and
//     never by the wave width B (kernels/subsample_grid.py::plan):
//     `monthly_mean` cuts its draws * ds elements into runs of whole
//     32-element rows, `alod` gives each warp one draw (its mean and std
//     are the warp's), kWarps draws a CTA.
//   * One dependent load in flight a warp.  Each lane draws kBatch
//     indices (a full batch without a branch, so the hashes interleave),
//     issues all kBatch loads, and draws the next batch before it uses
//     them.  `alod` keeps a draw's values in registers (ds <= 32 *
//     kBatch), so its mean, deviation and binning passes read memory once.
//     One thread derives the task's keys for the CTA.
//   * Binning.  Each warp holds `copies` private copies of its bins ({sum,
//     count} pairs) in shared memory, laid out [cell][copy]; lane l adds
//     into copy l % copies, and the 32 / copies lanes that share a copy
//     take turns (phases, in lane order, __syncwarp between).  In a phase
//     the active lanes hit distinct banks whatever their cells.  No lane
//     waits on another's cell (no __match_any_sync, no serial leader).
//     `copies` is the most, up to 32, whose bins fit 48 KB, so it is fixed
//     by the grid (4 at grid 120, 8 at grid 64).
//   * Sectors.  A drawn element costs a 32-byte sector of the block and
//     one of the months, which L2 serves once a row is in it.  Where a
//     `monthly_mean` sample row fits in shared memory beside the bins and
//     has at least as many draws as elements (NETFLIX_HIGH's rows of
//     16,384), the staged body copies the row's values in once by
//     cp.async.bulk behind an mbarrier, and its months, clamped to the
//     grid, as bytes, and gathers from shared memory.  Elsewhere
//     (NETFLIX_HIGH's rows of 32,768 and more, NETFLIX_LOW's 256 draws a
//     row, and every `alod` row: EAGLET's are 1-8 MB) the direct body
//     gathers from global memory.  The launcher is told which body to run;
//     both run the same loop, differing only in where an element is read,
//     so they agree bit for bit.

// Determinism.  PyTorch's scatter-adds on the card (index_add_,
// scatter_add_, a weighted bincount) add floats with atomics in an order
// that changes from launch to launch; the platform needs wave == per-task
// == repeat runs bit for bit.  So nothing here uses an atomic.  Every sum
// has one fixed order that depends on the shape alone (draws, ds, sl, grid
// and the statistic fix `groups` and `copies`), not on the wave width B,
// the slot, the body, the index form or the run:
//   * the mean and the sum of squared deviations of an `alod` row: each
//     lane adds its elements j = lane, lane + 32, ... in order, then a
//     fixed xor shuffle tree (every lane ends with the same bits);
//   * a bin copy: the warp's batches in order; in a batch, the lanes of
//     the copy in lane order; a lane's kBatch elements in order;
//   * a CTA's partial: each warp's copies in copy order, then the warps in
//     warp order, written to scratch at (b, s, g);
//   * a task's sum (sum_samples_kernel): thread w of 32 adds (s, g) for
//     s = w, w + 32, ... and g = 0 .. groups - 1 in that order; the 32
//     results are added in w order.
// kernels/subsample_grid.py::plan fixes the shape's split, and the test
// tests/test_torch_subsample.py emulates the order on the CPU.  Counts are
// whole numbers below 2^24 (checked by the wrapper), so they are exact
// whatever the order.  The cell arithmetic is the reference's IEEE fp32
// divide and multiply (__fdiv_rn, __fmul_rn) and a truncation, with no
// fast-math flags, so a cell is the reference's to the bit.
//
// Two index sources, one template:
//   * Draw (subsample_grid_seeded_launch, the platform's path): idx[b] is
//     jax.random.randint(PRNGKey(seeds[b]), (draws, ns, ds), 0, sl), drawn
//     in the kernel (threefry.cuh): element (d, s, j) is the draw at the
//     flat counter n = (d * ns + s) * ds + j.  The indices never exist in
//     memory.
//   * Read (subsample_grid_launch): idx from memory, as given.  It is the
//     oracle the draw form is held against: with the same indices the
//     two add the same values in the same order, so they agree bit for
//     bit.
// threefry_randint_launch writes the drawn indices out, [B, n] int32, so
// that the card's draws can be held against prng.randint.
//
// Bound: operations for the draw form where a row's draws are few beside
// its sectors, else bytes.  Each drawn element costs one Threefry-2x32
// hash, about 75 32-bit integer operations, when the span's multiplier is
// 0 (every power-of-two sl, which the platform's blocks have), and two
// hashes and three remainders, about 150, when it is not, at 16.7 T INT32
// operations a second (derived: 64 INT32 results a clock an SM x 132 SMs
// x 1.98 GHz; the data sheet lists no INT32 rate).  The bytes: each
// distinct element touched once (and its month), at sector granularity
// the sectors touched; NETFLIX_HIGH's 16,384 draws a row touch nearly
// every sector of it.  The read form also reads 4 bytes of index a drawn
// element and is bound by bytes.

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "threefry.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kBatch = 8;               // indices a lane draws before loading
constexpr int kMaxGrid = 512;
constexpr int kMaxStagedGrid = 256;     // staged months are bytes
constexpr size_t kMaxSmem = 232448 - 128;  // 227 KB a CTA, less s_bar
constexpr uint32_t kChunk = 16384;      // bytes a bulk copy
constexpr int kMaxDevices = 64;

enum Statistic { kAlod = 0, kMonthlyMean = 1 };
enum Body { kDirect = 0, kStaged = 1 };

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

// until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// `bytes` (a multiple of 16) from global `src` to shared `dst`, both
// 16-byte aligned, completing on the mbarrier `bar`.
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, off));
  }
  return v;
}

// Adds value[k] into cell[k] for the k whose bit is set in `valid` (a
// prefix of the batch: a lane's elements run in order to the end), into
// this lane's copy of the warp's bins ([grid][copies] of {sum, count}, the
// count an fp32 whole number).  The lanes of one copy take turns in lane
// order, a lane its elements in k order.  Warp-collective.
__device__ __forceinline__ void bin_batch(float2* __restrict__ bins,
                                          int copies, int lane,
                                          const int (&cell)[kBatch],
                                          const float (&value)[kBatch],
                                          unsigned valid) {
  const int copy = lane & (copies - 1);
  const int phase = lane / copies;
  const int n = __popc(valid);  // the valid k are always a prefix
  for (int p = 0; p < 32 / copies; ++p) {
    if (p == phase) {
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {
        if (k >= n) break;
        float2& bin = bins[cell[k] * copies + copy];
        bin = make_float2(__fadd_rn(bin.x, value[k]), __fadd_rn(bin.y, 1.0f));
      }
    }
    __syncwarp();
  }
}

// Read: indices from memory, idx [B, draws, ns, ds] int32.
struct ReadIndices {
  const int32_t* __restrict__ idx;

  struct Task {};  // nothing to derive a task
  __device__ __forceinline__ Task task(int64_t) const { return Task{}; }

  struct Row {
    const int32_t* __restrict__ base;  // &idx[b, 0, s, 0]
    int64_t draw_stride;               // ns * ds
    __device__ __forceinline__ int operator()(int d, int j) const {
      return __ldg(base + d * draw_stride + j);
    }
  };
  __device__ __forceinline__ Row row(const Task&, int64_t b, int64_t s,
                                     int64_t ns, int draws, int ds) const {
    return Row{idx + ((b * draws) * ns + s) * ds, ns * ds};
  }
};

// Draw: jax's randint(PRNGKey(seeds[b]), (draws, ns, ds), 0, sl).  POW2:
// sl is a power of two above 1 and the multiplier is 0 (the platform's
// blocks), so a draw is one hash and a mask, with no branch, and a lane's
// kBatch hashes interleave.
template <bool POW2>
struct DrawIndices {
  const int32_t* __restrict__ seeds;
  threefry::Span span;  // sl and its multiplier

  struct Task {
    threefry::Key k1, k2;  // jax.random.split(PRNGKey(seeds[b]))
  };
  __device__ __forceinline__ Task task(int64_t b) const {
    const threefry::Key key = threefry::jax_key(__ldg(seeds + b));
    return Task{span.multiplier ? threefry::jax_split_first(key)
                                : threefry::Key{0u, 0u},
                threefry::jax_split_second(key)};
  }

  struct Row {
    threefry::Key k1, k2;
    uint32_t base, draw_stride;  // s * ds, ns * ds: n = d * stride + base + j
    threefry::Span span;
    __device__ __forceinline__ int operator()(int d, int j) const {
      const uint32_t n = static_cast<uint32_t>(d) * draw_stride + base +
                         static_cast<uint32_t>(j);
      if constexpr (POW2) {
        return static_cast<int>(threefry::bits_at(k2, n) & span.pow2_mask);
      } else {
        return static_cast<int>(threefry::randint_at(k1, k2, n, span));
      }
    }
  };
  __device__ __forceinline__ Row row(const Task& t, int64_t /*b*/,
                                     int64_t s, int64_t ns, int /*draws*/,
                                     int ds) const {
    return Row{t.k1, t.k2, static_cast<uint32_t>(s * ds),
               static_cast<uint32_t>(ns * ds), span};
  }
};

// out[k] = index(d[k], j[k]) for k < kBatch, or only for k < n (the
// warp's last, partial batch).  A full batch takes no branch, so its
// kBatch hashes interleave.
template <class Index>
__device__ __forceinline__ void hash_batch(const Index& index,
                                           const int (&d)[kBatch],
                                           const int (&j)[kBatch], int n,
                                           int (&out)[kBatch]) {
  if (n >= kBatch) {
#pragma unroll
    for (int k = 0; k < kBatch; ++k) out[k] = index(d[k], j[k]);
  } else {
#pragma unroll
    for (int k = 0; k < kBatch; ++k) out[k] = k < n ? index(d[k], j[k]) : 0;
  }
}

// Where an element of the CTA's sample row is read: global memory (the
// direct body) or the row staged in shared memory (the staged body, whose
// months are already clamped to the grid; `monthly_mean` only).
template <int STAT, bool STAGED>
struct RowSource {
  static_assert(!STAGED || STAT == kMonthlyMean, "alod is never staged");
  const float* __restrict__ data;
  const int32_t* __restrict__ months;
  const float* __restrict__ s_data;
  const uint8_t* __restrict__ s_months;
  int grid;

  __device__ __forceinline__ float value(int ix) const {
    if constexpr (STAGED) {
      return s_data[ix];
    } else {
      return __ldg(data + ix);
    }
  }
  __device__ __forceinline__ int cell(int ix) const {
    if constexpr (STAGED) {
      return s_months[ix];
    } else {
      return min(max(__ldg(months + ix), 0), grid - 1);
    }
  }
};

// One CTA per (task b, sample s, group g): blockIdx.x = s * groups + g,
// blockIdx.y = b.  Shared memory: bins [kWarps][grid][copies] of {sum,
// count}, then for the staged body the row's sl fp32 values and its sl
// months as bytes.
template <int STAT, bool STAGED, class Indices>
__global__ void __launch_bounds__(kThreads, 3)
grid_partial_kernel(const float* __restrict__ data,
                    const int32_t* __restrict__ months,
                    const int32_t* __restrict__ rows, const Indices indices,
                    float* __restrict__ scratch, int64_t ns, int64_t sl,
                    int draws, int ds, int grid, int groups, int copies) {
  extern __shared__ __align__(128) float smem[];
  __shared__ uint64_t s_bar;
  const int n_bins = kWarps * grid * copies;
  float2* bins_all = reinterpret_cast<float2*>(smem);
  float* s_data = smem + 2 * n_bins;
  uint8_t* s_months = reinterpret_cast<uint8_t*>(s_data + sl);

  const int64_t s = blockIdx.x / groups;
  const int g = static_cast<int>(blockIdx.x % groups);
  const int64_t b = blockIdx.y;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int64_t slot = __ldg(rows + b);
  const float* __restrict__ row_data = data + (slot * ns + s) * sl;
  const int32_t* __restrict__ row_months =
      STAT == kMonthlyMean ? months + (slot * ns + s) * sl : nullptr;

  // one thread of warp 1 derives the task's keys (two hashes) for the CTA
  // while thread 0 starts the staged body's copy
  __shared__ typename Indices::Task s_task;
  if (threadIdx.x == 32) s_task = indices.task(b);

  const uint32_t bar = smem_addr(&s_bar);
  if constexpr (STAGED) {
    // the draws below overlap the row's copy
    if (threadIdx.x == 0) {
      mbar_init(bar, 1);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
      const uint32_t bytes = static_cast<uint32_t>(sl) * 4u;
      mbar_expect_tx(bar, bytes);
      for (uint32_t off = 0; off < bytes; off += kChunk) {
        const uint32_t n = bytes - off < kChunk ? bytes - off : kChunk;
        bulk_copy(smem_addr(s_data) + off,
                  reinterpret_cast<const char*>(row_data) + off, n, bar);
      }
    }
    const int4* __restrict__ src = reinterpret_cast<const int4*>(row_months);
    uint32_t* dst = reinterpret_cast<uint32_t*>(s_months);
    for (int64_t i = threadIdx.x; i < sl / 4; i += kThreads) {
      const int4 m = __ldg(src + i);
      dst[i] = static_cast<uint32_t>(min(max(m.x, 0), grid - 1)) |
               static_cast<uint32_t>(min(max(m.y, 0), grid - 1)) << 8 |
               static_cast<uint32_t>(min(max(m.z, 0), grid - 1)) << 16 |
               static_cast<uint32_t>(min(max(m.w, 0), grid - 1)) << 24;
    }
  }
  {
    float4* z = reinterpret_cast<float4*>(smem);
    for (int i = threadIdx.x; i < n_bins / 2; i += kThreads) {
      z[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
  }
  __syncthreads();

  float2* bins = bins_all + warp * grid * copies;
  const RowSource<STAT, STAGED> src{row_data, row_months, s_data, s_months,
                                    grid};
  const auto index = indices.row(s_task, b, s, ns, draws, ds);
  int ix[kBatch];
  float x[kBatch];
  int cell[kBatch];
  unsigned valid = 0u;

  if constexpr (STAT == kAlod) {
    // warp w of group g: draw d = g * kWarps + w, elements j = lane + 32 i
    const int d = g * kWarps + warp;
    const int n_i = (ds + 31) / 32;
    // draw the batch of i in [i0, i0 + kBatch), then load it
    auto draw = [&](int i0) {
      valid = 0u;
      int dk[kBatch], jk[kBatch];
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {
        const int j = lane + 32 * (i0 + k);
        const bool on = i0 + k < n_i && j < ds;
        valid |= static_cast<unsigned>(on) << k;
        dk[k] = d;
        jk[k] = on ? j : 0;
      }
      hash_batch(index, dk, jk, n_i - i0, ix);
    };
    auto load = [&]() {
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {
        x[k] = valid >> k & 1u ? src.value(ix[k]) : 0.0f;
      }
    };
    auto fetch = [&](int i0) {
      draw(i0);
      load();
    };
    if (d < draws) {
      draw(0);
      load();
      const float ds_f = static_cast<float>(ds);
      const float sl_f = static_cast<float>(sl);
      const float grid_f = static_cast<float>(grid);
      float acc = 0.0f;
      for (int i0 = 0; i0 < n_i; i0 += kBatch) {
        if (i0 > 0) fetch(i0);
#pragma unroll
        for (int k = 0; k < kBatch; ++k) {
          if (valid >> k & 1u) acc = __fadd_rn(acc, x[k]);
        }
      }
      const float mean = __fdiv_rn(warp_sum(acc), ds_f);
      float sq = 0.0f;
      for (int i0 = 0; i0 < n_i; i0 += kBatch) {
        if (n_i > kBatch) fetch(i0);
#pragma unroll
        for (int k = 0; k < kBatch; ++k) {
          if (valid >> k & 1u) {
            const float dev = __fsub_rn(x[k], mean);
            sq = __fadd_rn(sq, __fmul_rn(dev, dev));
          }
        }
      }
      const float sd =
          __fadd_rn(__fsqrt_rn(__fdiv_rn(warp_sum(sq), ds_f)), 1e-6f);
      for (int i0 = 0; i0 < n_i; i0 += kBatch) {
        if (n_i > kBatch) fetch(i0);
#pragma unroll
        for (int k = 0; k < kBatch; ++k) {
          const float pos = __fdiv_rn(static_cast<float>(ix[k]), sl_f);
          cell[k] = min(max(__float2int_rz(__fmul_rn(pos, grid_f)), 0),
                        grid - 1);
          x[k] = fabsf(__fdiv_rn(__fsub_rn(x[k], mean), sd));
        }
        bin_batch(bins, copies, lane, cell, x, valid);
      }
    }
  } else {
    // the (b, s) row's draws * ds elements e = d * ds + j as 32-element
    // rows t (e = 32 t + lane); group g takes rows [g, g + 1) * per_group,
    // warp w of it [w, w + 1) * per_warp of those
    const int n_e = draws * ds;
    const int n_t = (n_e + 31) / 32;
    const int per_group = (n_t + groups - 1) / groups;
    const int per_warp = (per_group + kWarps - 1) / kWarps;
    const int g_end = min(n_t, (g + 1) * per_group);
    const int t_begin = min(g_end, g * per_group + warp * per_warp);
    const int t_end = min(g_end, t_begin + per_warp);
    // draw the indices of rows [t0, t0 + kBatch) below t_end
    auto draw = [&](int t0, int (&out)[kBatch]) {
      unsigned v = 0u;
      int dk[kBatch], jk[kBatch];
      int e = 32 * t0 + lane;
      int d = e / ds;
      int j = e - d * ds;
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {
        const bool on = t0 + k < t_end && e < n_e;
        v |= static_cast<unsigned>(on) << k;
        dk[k] = on ? d : 0;
        jk[k] = on ? j : 0;
        e += 32;
        j += 32;
        while (j >= ds) {
          j -= ds;
          ++d;
        }
      }
      hash_batch(index, dk, jk, t_end - t0, out);
      return v;
    };
    if (t_begin < t_end) valid = draw(t_begin, ix);
    if constexpr (STAGED) mbar_wait(bar, 0);
    for (int t0 = t_begin; t0 < t_end; t0 += kBatch) {
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {
        const bool on = valid >> k & 1u;
        x[k] = on ? src.value(ix[k]) : 0.0f;
        cell[k] = on ? src.cell(ix[k]) : 0;
      }
      int next[kBatch] = {};
      const unsigned next_valid =
          t0 + kBatch < t_end ? draw(t0 + kBatch, next) : 0u;
      bin_batch(bins, copies, lane, cell, x, valid);
#pragma unroll
      for (int k = 0; k < kBatch; ++k) ix[k] = next[k];
      valid = next_valid;
    }
  }
  __syncthreads();

  // each warp's copies in copy order, into copy 0
  for (int i = threadIdx.x; i < kWarps * grid; i += kThreads) {
    float2* cell_bins = bins_all + i * copies;
    float2 acc = make_float2(0.0f, 0.0f);
    for (int k = 0; k < copies; ++k) {
      acc = make_float2(__fadd_rn(acc.x, cell_bins[k].x),
                        __fadd_rn(acc.y, cell_bins[k].y));
    }
    cell_bins[0] = acc;
  }
  __syncthreads();
  // then the warps in warp order
  float* out = scratch + ((b * ns + s) * groups + g) * 2 *
                             static_cast<int64_t>(grid);
  for (int c = threadIdx.x; c < grid; c += kThreads) {
    float2 acc = make_float2(0.0f, 0.0f);
    for (int w = 0; w < kWarps; ++w) {
      const float2 v = bins_all[(w * grid + c) * copies];
      acc = make_float2(__fadd_rn(acc.x, v.x), __fadd_rn(acc.y, v.y));
    }
    out[c] = acc.x;
    out[grid + c] = acc.y;
  }
}

// out[b, k] for k < 2 * grid: thread (w, lane) of a CTA of kSumWarps
// warps adds scratch[b, s, g, k] over s = w, w + kSumWarps, ... and g in
// order; then the warps' sums in warp order.  blockIdx.y picks 32 of the
// k.
constexpr int kSumWarps = 32;

__global__ void __launch_bounds__(kSumWarps * 32)
sum_samples_kernel(const float* __restrict__ scratch, float* __restrict__ out,
                   int64_t ns, int groups, int grid) {
  __shared__ float part[kSumWarps][33];
  const int64_t b = blockIdx.x;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int k = blockIdx.y * 32 + lane;
  const int width = 2 * grid;
  float acc = 0.0f;
  if (k < width) {
    const float* __restrict__ task = scratch + b * ns * groups * width + k;
    for (int64_t s = warp; s < ns; s += kSumWarps) {
      const float* __restrict__ p = task + s * groups * width;
#pragma unroll 8
      for (int g = 0; g < groups; ++g) acc = __fadd_rn(acc, p[g * width]);
    }
  }
  part[warp][lane] = acc;
  __syncthreads();
  if (warp == 0 && k < width) {
    float total = 0.0f;
    for (int w = 0; w < kSumWarps; ++w) {
      total = __fadd_rn(total, part[w][lane]);
    }
    out[b * width + k] = total;
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

constexpr uint64_t kCounters = 1ull << 32;  // a key's flat positions

// Shared memory of a CTA of `body` (the dynamic part).
size_t smem_bytes(int64_t sl, int grid, int body, int copies) {
  size_t bytes = sizeof(float2) * kWarps * grid * copies;
  if (body == kStaged) bytes += (sizeof(float) + 1) * sl;
  return bytes;
}

bool bad_shape(int64_t b, int64_t ns, int64_t sl, int draws, int ds,
               int grid, int statistic, const void* data, const void* months,
               int body, int groups, int copies) {
  if (grid < 1 || grid > kMaxGrid || draws < 0 || ds < 0 || b > 65535 ||
      ns < 0 || groups < 1 || copies < 1 || copies > 32 ||
      (copies & (copies - 1)) != 0 || ns * groups > 2147483647 ||
      static_cast<int64_t>(draws) * ds > 2147483647 - 31 ||
      (statistic != kAlod && statistic != kMonthlyMean) ||
      (statistic == kMonthlyMean && months == nullptr) ||
      (body != kDirect && body != kStaged) ||
      smem_bytes(sl, grid, body, copies) > kMaxSmem) {
    return true;
  }
  if (statistic == kAlod && groups * kWarps < draws) return true;
  if (body == kStaged &&
      (statistic != kMonthlyMean || sl % 4 != 0 || grid > kMaxStagedGrid ||
       reinterpret_cast<uintptr_t>(data) % 16 != 0 ||
       reinterpret_cast<uintptr_t>(months) % 16 != 0)) {
    return true;
  }
  return false;
}

template <int STAT, bool STAGED, class Indices>
cudaError_t launch_partial(dim3 blocks, size_t smem, cudaStream_t st,
                           const float* x, const int32_t* mo,
                           const int32_t* r, Indices indices, float* part,
                           int64_t ns, int64_t sl, int draws, int ds,
                           int grid, int groups, int copies) {
  auto kern = grid_partial_kernel<STAT, STAGED, Indices>;
  // The dynamic shared-memory ceiling, raised to kMaxSmem once a device
  // and kernel.  The attribute is the process's and takes effect at once,
  // so a ceiling set to each launch's own size would let one thread lower
  // it between another thread's set and launch; a fixed ceiling never
  // moves.  It is only a ceiling: each launch's `smem` sets its occupancy.
  // Raised for every launch size, since the static barrier and keys count
  // against the 48 KB a launch may take without it.
  static std::atomic<bool> raised[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!raised[dev].load(std::memory_order_acquire)) {
    err = cudaFuncSetAttribute(kern,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(kMaxSmem));
    if (err != cudaSuccess) return err;
    raised[dev].store(true, std::memory_order_release);
  }
  kern<<<blocks, kThreads, smem, st>>>(x, mo, r, indices, part, ns, sl, draws,
                                       ds, grid, groups, copies);
  return cudaGetLastError();
}

// Both kernels on `st`; the partial kernel's template over the statistic,
// the body and `Indices`.
template <class Indices>
int launch(const void* data, const void* months, const void* rows,
           Indices indices, void* scratch, void* out, int64_t b, int64_t ns,
           int64_t sl, int draws, int ds, int grid, int statistic, int body,
           int groups, int copies, cudaStream_t st) {
  if (b == 0) return static_cast<int>(cudaSuccess);
  const float* x = static_cast<const float*>(data);
  const int32_t* mo = static_cast<const int32_t*>(months);
  const int32_t* r = static_cast<const int32_t*>(rows);
  float* part = static_cast<float*>(scratch);
  float* o = static_cast<float*>(out);
  if (ns > 0) {
    const size_t smem = smem_bytes(sl, grid, body, copies);
    const dim3 blocks(static_cast<unsigned>(ns * groups),
                      static_cast<unsigned>(b));
    cudaError_t err;
    if (statistic == kAlod) {  // never staged (bad_shape)
      err = launch_partial<kAlod, false>(blocks, smem, st, x, mo, r, indices,
                                         part, ns, sl, draws, ds, grid,
                                         groups, copies);
    } else {
      err = body == kStaged
                ? launch_partial<kMonthlyMean, true>(
                      blocks, smem, st, x, mo, r, indices, part, ns, sl,
                      draws, ds, grid, groups, copies)
                : launch_partial<kMonthlyMean, false>(
                      blocks, smem, st, x, mo, r, indices, part, ns, sl,
                      draws, ds, grid, groups, copies);
    }
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 blocks(static_cast<unsigned>(b),
                    static_cast<unsigned>((2 * grid + 31) / 32));
  sum_samples_kernel<<<blocks, kSumWarps * 32, 0, st>>>(part, o, ns, groups,
                                                        grid);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launch both kernels on `stream` (PyTorch's current stream), the indices
// read from `idx` [b, draws, ns, ds].  Pointers are device pointers; the
// caller has checked shapes, dtypes, contiguity and that rows lie in [0,
// n_slots) and indices in [0, sl).  `body` (0 direct, 1 staged), `groups`
// and `copies` are kernels/subsample_grid.py::plan's.  `scratch` holds
// b * ns * groups * 2 * grid floats.  Returns cudaGetLastError() after the
// launches.
extern "C" int subsample_grid_launch(const void* data, const void* months,
                                     const void* rows, const void* idx,
                                     void* scratch, void* out, int64_t b,
                                     int64_t ns, int64_t sl, int draws, int ds,
                                     int grid, int statistic, int body,
                                     int groups, int copies, void* stream) {
  if (bad_shape(b, ns, sl, draws, ds, grid, statistic, data, months, body,
                groups, copies)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch(data, months, rows,
                ReadIndices{static_cast<const int32_t*>(idx)}, scratch, out,
                b, ns, sl, draws, ds, grid, statistic, body, groups, copies,
                static_cast<cudaStream_t>(stream));
}

// The same with task b's indices drawn in the kernel from the int32 seed
// seeds[b]: jax.random.randint(PRNGKey(seeds[b]), (draws, ns, ds), 0, sl),
// `multiplier` being prng._randint_multiplier(0, sl)'s.  Refuses sl < 1,
// sl past int32, and draws * ns * ds of 2^32 or more.
extern "C" int subsample_grid_seeded_launch(
    const void* data, const void* months, const void* rows, const void* seeds,
    void* scratch, void* out, int64_t b, int64_t ns, int64_t sl, int draws,
    int ds, int grid, int statistic, int body, int groups, int copies,
    uint32_t multiplier, void* stream) {
  const uint64_t per_draw = static_cast<uint64_t>(ns) * ds;
  if (bad_shape(b, ns, sl, draws, ds, grid, statistic, data, months, body,
                groups, copies) ||
      sl < 1 || sl > 2147483647 ||
      (per_draw > 0 &&
       static_cast<uint64_t>(draws) > (kCounters - 1) / per_draw)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const threefry::Span span =
      threefry::make_span(static_cast<uint32_t>(sl), multiplier);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int32_t* s32 = static_cast<const int32_t*>(seeds);
  if (multiplier == 0u && span.pow2_mask != 0u) {
    return launch(data, months, rows, DrawIndices<true>{s32, span}, scratch,
                  out, b, ns, sl, draws, ds, grid, statistic, body, groups,
                  copies, st);
  }
  return launch(data, months, rows, DrawIndices<false>{s32, span}, scratch,
                out, b, ns, sl, draws, ds, grid, statistic, body, groups,
                copies, st);
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
