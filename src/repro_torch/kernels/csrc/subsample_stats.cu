// subsample_stats.cu: the `moments` map task of a wave, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/subsample_gather.py::subsample_stats_wave
//   (body _stats_wave_kernel), reached from repro.kernels.ops.subsample_stats.
//
// Computes, for every task b of a wave,
//   stats[b, 0, :] = sum_t data[b, indices[b, t], :]
//   stats[b, 1, :] = sum_t data[b, indices[b, t], :]^2
// with data [B, N, D] fp32, indices [B, T] int32 and stats [B, 2, D] fp32.
// No gathered [T, D] array is ever written.
//
// Order of summation (the reference's, and the plain PyTorch version's in
// kernels/ref.py): T is cut into groups of `rows_per_step` rows in index
// order, the tail group masked to zero past T.  The rows of a group are
// added one after another into a group sum, then the group sum is added to
// the fp32 accumulator.  Adds and squares use __fadd_rn / __fmul_rn, so the
// compiler contracts nothing into a fused multiply-add and the result is
// the plain version's, bit for bit.
//
// Design.  One CTA per (task b, tile of 256 * VEC columns); each thread
// owns VEC adjacent columns (VEC = 4, one float4 load per row, when D is a
// multiple of 4 and the data is 16-byte aligned) and keeps its sums in
// registers.  The CTA stages the indices of up to kStage rows in shared
// memory, then walks its groups in index order.  T is never split across
// CTAs, so a task's order of summation does not depend on B: a wave is
// bit-identical to B launches of one task.
//
// Bound: bytes.  Each input byte read once is B*N*D*4 + B*T*4 bytes, plus
// B*2*D*4 written, over the card's 3.35 TB/s; the arithmetic (3 flops per
// gathered element) is far below the fp32 rate.  The rows a task gathers
// come from its own block of N rows, which the kneepoint sizes to fit the
// 50 MB L2 (64 rows x 65,536 columns x 4 B = 16 MB on the main path), so
// repeat reads of a row hit L2 rather than device memory.  cp.async
// pipelining and a fused threefry index draw are later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kStage = 256;  // rows whose indices one stage holds

template <int VEC>
__device__ __forceinline__ void load_row(const float* __restrict__ p,
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
__device__ __forceinline__ void store_row(float* __restrict__ p,
                                          const float (&v)[VEC]) {
  if constexpr (VEC == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int k = 0; k < VEC; ++k) p[k] = v[k];
  }
}

template <int VEC>
__global__ void __launch_bounds__(kThreads)
subsample_stats_kernel(const float* __restrict__ data,
                       const int32_t* __restrict__ indices,
                       float* __restrict__ stats, int64_t n, int64_t d,
                       int64_t t, int rows_per_step) {
  __shared__ int32_t s_idx[kStage];

  const int64_t b = blockIdx.y;
  const int64_t col =
      (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) * VEC;
  const bool active = col < d;
  const float* __restrict__ task = data + b * n * d + col;
  const int32_t* __restrict__ task_idx = indices + b * t;

  float acc[VEC], acc2[VEC];
#pragma unroll
  for (int k = 0; k < VEC; ++k) acc[k] = acc2[k] = 0.0f;

  const int64_t steps = (t + rows_per_step - 1) / rows_per_step;
  const int64_t t_pad = steps * rows_per_step;
  const int64_t stage_rows = (kStage / rows_per_step) * rows_per_step;

  for (int64_t row0 = 0; row0 < t_pad; row0 += stage_rows) {
    const int64_t rows_here =
        t_pad - row0 < stage_rows ? t_pad - row0 : stage_rows;
    __syncthreads();  // the previous stage's indices are consumed
    for (int64_t i = threadIdx.x; i < rows_here; i += kThreads) {
      s_idx[i] = row0 + i < t ? task_idx[row0 + i] : 0;
    }
    __syncthreads();
    if (!active) continue;
    for (int64_t g = 0; g < rows_here; g += rows_per_step) {
      float gs[VEC], gq[VEC];
#pragma unroll
      for (int k = 0; k < VEC; ++k) gs[k] = gq[k] = 0.0f;
#pragma unroll 8
      for (int j = 0; j < rows_per_step; ++j) {
        float v[VEC];
        if (row0 + g + j < t) {
          load_row<VEC>(task + static_cast<int64_t>(s_idx[g + j]) * d, v);
        } else {
#pragma unroll
          for (int k = 0; k < VEC; ++k) v[k] = 0.0f;  // masked tail
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
    float* out = stats + b * 2 * d + col;
    store_row<VEC>(out, acc);
    store_row<VEC>(out + d, acc2);
  }
}

}  // namespace

// Launch on `stream` (PyTorch's current stream).  Pointers are device
// pointers; the caller has checked shapes, dtypes and contiguity, and that
// every index lies in [0, n).  Returns cudaGetLastError() after the launch.
extern "C" int subsample_stats_launch(const void* data, const void* indices,
                                      void* stats, int64_t b, int64_t n,
                                      int64_t d, int64_t t, int rows_per_step,
                                      int vec, void* stream) {
  if (rows_per_step < 1 || rows_per_step > kStage || b > 65535 ||
      (vec != 1 && vec != 4) || (vec == 4 && d % 4 != 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (b == 0 || d == 0) return static_cast<int>(cudaSuccess);
  const int64_t cols = static_cast<int64_t>(kThreads) * vec;
  const dim3 grid(static_cast<unsigned>((d + cols - 1) / cols),
                  static_cast<unsigned>(b));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* x = static_cast<const float*>(data);
  const int32_t* idx = static_cast<const int32_t*>(indices);
  float* out = static_cast<float*>(stats);
  if (vec == 4) {
    subsample_stats_kernel<4><<<grid, kThreads, 0, s>>>(x, idx, out, n, d, t,
                                                        rows_per_step);
  } else {
    subsample_stats_kernel<1><<<grid, kThreads, 0, s>>>(x, idx, out, n, d, t,
                                                        rows_per_step);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* subsample_stats_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
