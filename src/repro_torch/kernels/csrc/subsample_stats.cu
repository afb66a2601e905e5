// subsample_stats.cu: the `moments` map task of a wave, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/subsample_gather.py::subsample_stats_wave
//   (body _stats_wave_kernel), reached from repro.kernels.ops.subsample_stats;
// in its draw form, the reference's whole wave,
//   src/repro/platform/compute.py::_moments_wave_jit: the slot gather
//   (jnp.take), the vmapped jax.random.randint and that kernel.
//
// Computes, for every task b of a wave, with block = data[slot(b)] [N, D]
// fp32 and T indices idx[b] in [0, N),
//   stats[b, 0, :] = sum_t block[idx[b, t], :]
//   stats[b, 1, :] = sum_t block[idx[b, t], :]^2
// into stats [B, 2, D] fp32.  No gathered [T, D] array is ever written.
// Two forms over one body:
//   * Read (subsample_stats_launch): data [B, N, D], slot(b) = b, idx
//     [B, T] int32 read from memory.  The Pallas kernel's contract, and the
//     oracle the draw form is held against.
//   * Draw (subsample_stats_seeded_launch, the platform's path): data is
//     the resident arena [S, N, D], slot(b) = rows[b], and idx[b] is
//     jax.random.randint(PRNGKey(seeds[b]), (T,), 0, N), drawn in the
//     kernel at flat positions 0..T-1 (threefry.cuh).  Neither a copy of
//     the wave's blocks nor its indices ever exist in device memory.
//
// Order of summation (the reference's, and the plain PyTorch version's in
// kernels/ref.py): T is cut into groups of `rows_per_step` rows in index
// order, the tail group masked to zero past T.  The rows of a group are
// added one after another into a group sum, then the group sum is added to
// the fp32 accumulator.  Adds and squares use __fadd_rn / __fmul_rn, so the
// compiler contracts nothing into a fused multiply-add and the result is
// the plain version's, bit for bit.  T is never split across CTAs.  So
// with the same indices both forms and both bodies below add the same
// values in the same order: they agree bit for bit, and a task's stats
// depend on neither the wave width B nor its slot.
//
// Tensor cores do not apply.  The sums could be written as the product of
// a task's [N] count of draws of each row with its [N, D] block, but that
// adds each row once, scaled by its count, where the reference adds it once
// a draw, in index order: the rounding would differ, and with it the
// equality with the plain version and wave == per-task execution.
//
// Two bodies, one order, chosen by the shape:
//   * Staged (the rule).  One CTA per (task b, tile of C columns).  Warp 0
//     issues one cp.async.bulk copy per row of the block's tile (C * 4
//     bytes, completing on an mbarrier), so the tile's N rows come from
//     device memory once.  While they fly, the CTA draws (or reads) the
//     task's indices into shared memory, so the hash's integer work
//     overlaps the copy; it keeps each drawn row's offset in the tile.
//     Then it walks the groups in index order, each row read from shared
//     memory: thread i owns VEC = C / blockDim adjacent columns (scalar,
//     float2 or float4 reads; a warp reads one row's consecutive words, so
//     no bank conflicts).  C is the widest power of two in [32, 512], and
//     no wider than D needs, whose tile of N * C * 4 bytes leaves room for
//     two CTAs an SM (kTwoCtaBytes); blockDim is C up to 128 threads.  At
//     the main path's N = 64 that is C = 256 (VEC = 2): a 64 KB tile plus
//     4 KB of indices, so three CTAs share an SM's 228 KB and one CTA's
//     copy overlaps the others' sums.  Where even C = 32 leaves room for
//     one CTA only, C = 32, up to kMaxTileBytes (N up to 1,760 rows).
//   * Global, where a bulk copy cannot serve: N * 32 * 4 bytes past
//     kMaxTileBytes, or D not a multiple of 4 or the data not 16-byte
//     aligned (a bulk copy moves multiples of 16 bytes between 16-byte
//     aligned addresses), or T = 0.  One CTA of 256 threads per (task b,
//     tile of 256 * VEC columns); each drawn row is read from device
//     memory through L2, as float4 (VEC = 4) where D and the alignment
//     allow.
// At rows_per_step = 8 (the platform's, and the reference's) both bodies
// take two groups a step, software-pipelined: the next 16 rows are loaded
// into registers while these 16 are added, and the two groups' sums, each
// depending only on its own rows, are added side by side, then into the
// accumulator in group order.  A warp then waits on the adds' own chain
// and not on every load: staging alone, with one row added after another,
// left the kernel as slow as reading the rows through L2.  Any other group
// size, and the masked tail group, go row by row.
//
// Shared memory a CTA: the tile (staged only; dynamic, past 48 KB after
// cudaFuncSetAttribute), kStage int32 indices (4 KB) and one mbarrier.
//
// Bound: bytes.  Draw form: each distinct row of a task's block that its
// draws touch read once, the task's slot and seed read once and its stats
// written once, over the card's 3.35 TB/s; at the main path's wave (16
// tasks of [64, 65,536], T = 512: every row touched) 268 MB, 0.08 ms.  The
// arithmetic is below it: 3 fp32 operations a drawn element (1.6 G a wave,
// 0.024 ms at 67 TFLOP/s), and one Threefry hash (about 75 integer
// operations) an index a CTA.  The staged body reads each byte of a tile
// from device memory once; the repeat reads of a row (512 draws of 64 rows
// read each row about 8 times, 2.15 GB a wave) come from shared memory,
// 16 MB an SM at 128 bytes a clock, about 0.06 ms.  The sums from shared
// memory, not the copies, set the kernel's time.  The read form also reads
// 4 bytes of index a draw.

#include <cuda_runtime.h>
#include <stdint.h>

#include "threefry.cuh"

namespace {

constexpr int kThreads = 256;        // the global body's CTA
constexpr int kStagedThreads = 128;  // the staged body's CTA, at most
constexpr int kStage = 1024;         // indices one stage holds in shared memory
constexpr int kMaxRowsPerStep = 256;
constexpr int64_t kMinCols = 32, kMaxCols = 512;
// An SM has 228 KB of shared memory, and each CTA costs 1 KB more: two
// CTAs with their 4 KB of indices fit beside tiles of up to 104 KB each,
// and one CTA (at most 227 KB) beside a tile of up to 220 KB.
constexpr int64_t kTwoCtaBytes = 104 * 1024;
constexpr int64_t kMaxTileBytes = 220 * 1024;
constexpr uint64_t kCounters = 1ull << 32;  // a key's flat positions

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

template <int VEC>
__device__ __forceinline__ void load_global(const float* __restrict__ p,
                                            float (&v)[VEC]) {
  if constexpr (VEC == 4) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = q.x;
    v[1] = q.y;
    v[2] = q.z;
    v[3] = q.w;
  } else {
#pragma unroll
    for (int k = 0; k < VEC; ++k) v[k] = __ldg(p + k);
  }
}

template <int VEC>
__device__ __forceinline__ void load_shared(const float* p, float (&v)[VEC]) {
  if constexpr (VEC == 4) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    v[0] = q.x;
    v[1] = q.y;
    v[2] = q.z;
    v[3] = q.w;
  } else if constexpr (VEC == 2) {
    const float2 q = *reinterpret_cast<const float2*>(p);
    v[0] = q.x;
    v[1] = q.y;
  } else {
    v[0] = *p;
  }
}

template <int VEC>
__device__ __forceinline__ void store_row(float* __restrict__ p,
                                          const float (&v)[VEC]) {
  if constexpr (VEC == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int k = 0; k < VEC; ++k) p[k] = v[k];
  }
}

// Read: indices from memory, idx [B, T] int32.
struct ReadIndices {
  const int32_t* __restrict__ idx;
  int64_t t;

  struct Task {
    const int32_t* __restrict__ row;  // &idx[b, 0]
    __device__ __forceinline__ int32_t operator()(int64_t i) const {
      return __ldg(row + i);
    }
  };
  __device__ __forceinline__ Task task(int64_t b) const {
    return Task{idx + b * t};
  }
};

// Draw: jax.random.randint(PRNGKey(seeds[b]), (T,), 0, N) at position i.
struct DrawIndices {
  const int32_t* __restrict__ seeds;
  threefry::Span span;  // N and its multiplier

  struct Task {
    threefry::Key k1, k2;
    threefry::Span span;
    __device__ __forceinline__ int32_t operator()(int64_t i) const {
      return static_cast<int32_t>(threefry::randint_at(
          k1, k2, static_cast<uint32_t>(i), span));
    }
  };
  __device__ __forceinline__ Task task(int64_t b) const {
    const threefry::Key key = threefry::jax_key(__ldg(seeds + b));
    const threefry::Key k1 = span.multiplier
                                 ? threefry::jax_split_first(key)
                                 : threefry::Key{0u, 0u};
    return Task{k1, threefry::jax_split_second(key), span};
  }
};

// One CTA per (task blockIdx.y, tile blockIdx.x of blockDim.x * VEC
// columns).  `rows` is the slot vector, or null for slot(b) = b.
template <int VEC, bool STAGED, class Indices>
__global__ void __launch_bounds__(kThreads)
subsample_stats_kernel(const float* __restrict__ data,
                       const int32_t* __restrict__ rows,
                       const Indices indices, float* __restrict__ stats,
                       int64_t n, int64_t d, int64_t t, int rows_per_step) {
  __shared__ __align__(16) int32_t s_idx[kStage];
  __shared__ uint64_t s_bar;
  extern __shared__ __align__(128) float s_tile[];  // staged: [n][cols]

  const int64_t b = blockIdx.y;
  const int64_t cols = static_cast<int64_t>(blockDim.x) * VEC;
  const int64_t c0 = static_cast<int64_t>(blockIdx.x) * cols;
  const int lc = threadIdx.x * VEC;  // this thread's first column in the tile
  const bool active = c0 + lc < d;
  const int64_t slot = rows != nullptr ? __ldg(rows + b) : b;
  const float* __restrict__ block = data + slot * n * d;
  const auto index = indices.task(b);

  uint32_t bar = 0;
  if constexpr (STAGED) {
    bar = smem_addr(&s_bar);
    if (threadIdx.x == 0) {
      mbar_init(bar, 1);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
    if (threadIdx.x < 32) {
      const int64_t width = d - c0 < cols ? d - c0 : cols;  // the tail tile
      const uint32_t row_bytes = static_cast<uint32_t>(width) * 4u;
      if (threadIdx.x == 0) {
        mbar_expect_tx(bar, row_bytes * static_cast<uint32_t>(n));
      }
      __syncwarp();
      for (int64_t r = threadIdx.x; r < n; r += 32) {
        bulk_copy(smem_addr(s_tile + r * cols), block + r * d + c0,
                  row_bytes, bar);
      }
    }
  }

  float acc[VEC], acc2[VEC];
#pragma unroll
  for (int k = 0; k < VEC; ++k) acc[k] = acc2[k] = 0.0f;

  const float* __restrict__ col = block + c0 + lc;  // global body's rows
  const int64_t steps = (t + rows_per_step - 1) / rows_per_step;
  const int64_t t_pad = steps * rows_per_step;
  const int stage_rows = (kStage / rows_per_step) * rows_per_step;

  for (int64_t row0 = 0; row0 < t_pad; row0 += stage_rows) {
    const int rows_here =
        static_cast<int>(t_pad - row0 < stage_rows ? t_pad - row0 : stage_rows);
    // rows of this stage below t: all but those of a masked tail group
    const int valid =
        static_cast<int>(t - row0 < rows_here ? t - row0 : rows_here);
    __syncthreads();  // the previous stage's indices are consumed
    // the staged body keeps each drawn row's offset in the tile, so that a
    // thread adds it to its own column and multiplies nothing a row
    for (int i = threadIdx.x; i < rows_here; i += blockDim.x) {
      const int r = i < valid ? index(row0 + i) : 0;
      s_idx[i] = STAGED ? r * static_cast<int>(cols) : r;
    }
    if constexpr (STAGED) {
      if (row0 == 0) mbar_wait(bar, 0);  // the tile has landed
    }
    __syncthreads();
    if (!active) continue;
    // this thread's VEC columns of the row at stage entry `e`
    const float* tile_col = s_tile + lc;
    auto load = [&](int e, float (&v)[VEC]) {
      if constexpr (STAGED) {
        load_shared<VEC>(tile_col + e, v);
      } else {
        load_global<VEC>(col + static_cast<int64_t>(e) * d, v);
      }
    };
    int g = 0;
    if (rows_per_step == 8) {
      // The platform's groups of 8, two at a time and software-pipelined:
      // the next two groups' rows are loaded into registers while these
      // two are added, and the two groups' sums, which depend on nothing
      // but their own rows, are added side by side, then into the
      // accumulator in group order.
      const int pairs = valid & ~15;  // rows in full pairs of groups
      float cur[16][VEC], nxt[16][VEC];
      auto fetch = [&](int g0, float (&rows16)[16][VEC]) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int4 e = *reinterpret_cast<const int4*>(s_idx + g0 + 4 * q);
          load(e.x, rows16[4 * q]);
          load(e.y, rows16[4 * q + 1]);
          load(e.z, rows16[4 * q + 2]);
          load(e.w, rows16[4 * q + 3]);
        }
      };
      if (pairs > 0) fetch(0, cur);
      for (; g < pairs; g += 16) {
        if (g + 16 < pairs) fetch(g + 16, nxt);
        float gs[2][VEC], gq[2][VEC];
#pragma unroll
        for (int k = 0; k < VEC; ++k) {
          gs[0][k] = gq[0][k] = gs[1][k] = gq[1][k] = 0.0f;
        }
#pragma unroll
        for (int j = 0; j < 8; ++j) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
#pragma unroll
            for (int k = 0; k < VEC; ++k) {
              const float x = cur[8 * h + j][k];
              gs[h][k] = __fadd_rn(gs[h][k], x);
              gq[h][k] = __fadd_rn(gq[h][k], __fmul_rn(x, x));
            }
          }
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
#pragma unroll
          for (int k = 0; k < VEC; ++k) {
            acc[k] = __fadd_rn(acc[k], gs[h][k]);
            acc2[k] = __fadd_rn(acc2[k], gq[h][k]);
          }
        }
#pragma unroll
        for (int j = 0; j < 16; ++j) {
#pragma unroll
          for (int k = 0; k < VEC; ++k) cur[j][k] = nxt[j][k];
        }
      }
    }
    // any other group size, and the masked tail group: row by row
    for (; g < rows_here; g += rows_per_step) {
      float gs[VEC], gq[VEC];
#pragma unroll
      for (int k = 0; k < VEC; ++k) gs[k] = gq[k] = 0.0f;
      for (int j = 0; j < rows_per_step; ++j) {
        float v[VEC];
        if (g + j < valid) {
          load(s_idx[g + j], v);
        } else {
#pragma unroll
          for (int k = 0; k < VEC; ++k) v[k] = 0.0f;  // past t
        }
#pragma unroll
        for (int k = 0; k < VEC; ++k) {
          gs[k] = __fadd_rn(gs[k], v[k]);
          gq[k] = __fadd_rn(gq[k], __fmul_rn(v[k], v[k]));
        }
      }
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        acc[k] = __fadd_rn(acc[k], gs[k]);
        acc2[k] = __fadd_rn(acc2[k], gq[k]);
      }
    }
  }

  if (active) {
    float* out = stats + b * 2 * d + c0 + lc;
    store_row<VEC>(out, acc);
    store_row<VEC>(out + d, acc2);
  }
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// The staged body's tile width C for blocks of n rows and d columns at
// `data`, or 0 where the global body runs.
int64_t tile_cols(int64_t n, int64_t d, int64_t t, const void* data) {
  if (n < 1 || t < 1 || d % 4 != 0 || !aligned16(data)) return 0;
  int64_t c = kMaxCols;
  while (c > kMinCols && (n * c * 4 > kTwoCtaBytes || c / 2 >= d)) c >>= 1;
  return n * c * 4 <= kMaxTileBytes ? c : 0;
}

template <int VEC, bool STAGED, class Indices>
int run(const float* data, const int32_t* rows, Indices indices, float* out,
        int64_t n, int64_t d, int64_t t, int rows_per_step, int threads,
        int64_t b, cudaStream_t st) {
  auto kern = subsample_stats_kernel<VEC, STAGED, Indices>;
  const int64_t cols = static_cast<int64_t>(threads) * VEC;
  const size_t smem = STAGED ? static_cast<size_t>(n * cols * 4) : 0;
  if (STAGED) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err == cudaSuccess) {
      err = cudaFuncSetAttribute(
          kern, cudaFuncAttributePreferredSharedMemoryCarveout,
          cudaSharedmemCarveoutMaxShared);
    }
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(static_cast<unsigned>((d + cols - 1) / cols),
                  static_cast<unsigned>(b));
  kern<<<grid, threads, smem, st>>>(data, rows, indices, out, n, d, t,
                                    rows_per_step);
  return static_cast<int>(cudaGetLastError());
}

// Either body on `st`, as the shape chooses.
template <class Indices>
int launch(const void* data, const void* rows, Indices indices, void* stats,
           int64_t b, int64_t n, int64_t d, int64_t t, int rows_per_step,
           cudaStream_t st) {
  if (rows_per_step < 1 || rows_per_step > kMaxRowsPerStep || b < 0 ||
      b > 65535 || n < 0 || d < 0 || t < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (b == 0 || d == 0) return static_cast<int>(cudaSuccess);
  const float* x = static_cast<const float*>(data);
  const int32_t* r = static_cast<const int32_t*>(rows);
  float* out = static_cast<float*>(stats);
  const int64_t c = tile_cols(n, d, t, data);
  if (c > 0) {
    const int threads =
        static_cast<int>(c < kStagedThreads ? c : kStagedThreads);
    switch (c / threads) {
      case 4:
        return run<4, true>(x, r, indices, out, n, d, t, rows_per_step,
                            threads, b, st);
      case 2:
        return run<2, true>(x, r, indices, out, n, d, t, rows_per_step,
                            threads, b, st);
      default:
        return run<1, true>(x, r, indices, out, n, d, t, rows_per_step,
                            threads, b, st);
    }
  }
  if (d % 4 == 0 && aligned16(data)) {
    return run<4, false>(x, r, indices, out, n, d, t, rows_per_step,
                         kThreads, b, st);
  }
  return run<1, false>(x, r, indices, out, n, d, t, rows_per_step, kThreads,
                       b, st);
}

}  // namespace

// Launch on `stream` (PyTorch's current stream), the indices read from
// `indices` [b, t] and task b reading data[b] of data [b, n, d].  Pointers
// are device pointers; the caller has checked shapes, dtypes and
// contiguity, and that every index lies in [0, n).  Returns
// cudaGetLastError() after the launch.
extern "C" int subsample_stats_launch(const void* data, const void* indices,
                                      void* stats, int64_t b, int64_t n,
                                      int64_t d, int64_t t, int rows_per_step,
                                      void* stream) {
  return launch(data, nullptr,
                ReadIndices{static_cast<const int32_t*>(indices), t}, stats,
                b, n, d, t, rows_per_step, static_cast<cudaStream_t>(stream));
}

// The same with task b reading arena[rows[b]] of arena [s, n, d] in place,
// its n_idx indices drawn in the kernel from the int32 seed seeds[b]:
// jax.random.randint(PRNGKey(seeds[b]), (n_idx,), 0, n), `multiplier`
// being prng._randint_multiplier(0, n)'s.  The caller has checked that
// every slot lies in [0, s).  Refuses n < 1, n past int32 and n_idx of
// 2^32 or more.
extern "C" int subsample_stats_seeded_launch(
    const void* arena, const void* rows, const void* seeds, void* stats,
    int64_t b, int64_t n, int64_t d, int64_t n_idx, int rows_per_step,
    uint32_t multiplier, void* stream) {
  if (n < 1 || n > 2147483647 || n_idx < 0 ||
      static_cast<uint64_t>(n_idx) >= kCounters) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const DrawIndices indices{
      static_cast<const int32_t*>(seeds),
      threefry::make_span(static_cast<uint32_t>(n), multiplier)};
  return launch(arena, rows, indices, stats, b, n, d, n_idx, rows_per_step,
                static_cast<cudaStream_t>(stream));
}

// The staged body's tile width for blocks [n, d] at `data` and t indices a
// task, or 0 where the launch takes the global body.
extern "C" int64_t subsample_stats_tile_cols(int64_t n, int64_t d, int64_t t,
                                             const void* data) {
  return tile_cols(n, d, t, data);
}

extern "C" const char* subsample_stats_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
