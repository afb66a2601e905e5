// subsample_gather.cu: one task's gathered rows and their statistics, for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/subsample_gather.py:64 subsample_gather
//   (body _gather_kernel), reached from repro.kernels.ops.subsample_gather.
//
// For data [N, D] (fp32 or bf16), indices [T] int32 and n_valid [1] int32
// (read here on the device, so the caller never waits for it) it writes
//   gathered[t, :] = data[indices[t], :]                  for every t < T
//   stats[0, :]    = sum_{t < n_valid} float(data[indices[t], :])
//   stats[1, :]    = sum_{t < n_valid} float(data[indices[t], :])^2
// gathered in the data's type, stats fp32 [2, D].  Rows past n_valid (the
// padded tail) are still gathered but add nothing to the stats.
//
// Order of summation (the TPU kernel's, and the plain PyTorch version's in
// kernels/ref.py subsample_gather_ref): one row after another, in t order,
// into one fp32 accumulator.  Adds and squares use __fadd_rn / __fmul_rn,
// so nothing is contracted into a fused multiply-add and the kernel equals
// its plain version bit for bit.
//
// Design (simple first).  One CTA of 64 threads per tile of 64 * VEC
// columns, so D = 65,536 gives 256 CTAs for the 132 SMs.  Each thread owns
// VEC adjacent columns (VEC = 4, one 16-byte fp32 or 8-byte bf16 load per
// row, when D is a multiple of 4 and the data is 16-byte aligned; VEC = 1
// otherwise) and keeps its sums in registers.  The CTA stages up to kStage
// indices in shared memory, then each thread walks them in order in groups
// of kGroup rows: the loads of the next group are issued before the
// current group is stored and summed, so kGroup rows are in flight ahead
// of the accumulation.  T is never split across CTAs: the stats need the
// sequential order, the gathered stores need none.
//
// Bound: bytes.  The distinct rows the indices touch read once, the
// indices read once, T * D gathered elements and the [2, D] stats written
// once; at [64, 65536] fp32 and T = 512 that is 16.8 MB read and 134 MB
// written, 0.045 ms at 3.35 TB/s (3 fp32 operations per counted element
// are far below the fp32 rate).  The write of the gathered rows dominates;
// the task's block (16 MB) stays in the 50 MB L2, so repeat reads of a row
// hit L2.  With two warps a CTA and about two CTAs an SM, the loads each
// thread keeps in flight limit this design; T split across CTAs with a
// fixed-order second pass, and TMA row copies, are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 64;
constexpr int kStage = 1024;  // indices one stage holds
constexpr int kGroup = 8;     // rows whose loads are in flight together

template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
subsample_gather_kernel(const T* __restrict__ data,
                        const int32_t* __restrict__ indices,
                        const int32_t* __restrict__ n_valid,
                        T* __restrict__ gathered, float* __restrict__ stats,
                        int64_t d, int64_t t) {
  using P = Pack<T, VEC>;
  __shared__ int32_t s_idx[kStage];

  const int64_t col =
      (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) * VEC;
  const bool active = col < d;
  const int64_t nv = __ldg(n_valid);  // rows t < nv count in the stats

  float acc[VEC], acc2[VEC];
#pragma unroll
  for (int k = 0; k < VEC; ++k) acc[k] = acc2[k] = 0.0f;

  for (int64_t row0 = 0; row0 < t; row0 += kStage) {
    const int rows_here =
        static_cast<int>(t - row0 < kStage ? t - row0 : kStage);
    __syncthreads();  // the previous stage's indices are consumed
    for (int i = threadIdx.x; i < rows_here; i += kThreads) {
      s_idx[i] = __ldg(indices + row0 + i);
    }
    __syncthreads();
    if (!active) continue;

    P cur[kGroup], nxt[kGroup];
#pragma unroll
    for (int j = 0; j < kGroup; ++j) {
      if (j < rows_here) {
        cur[j] = *reinterpret_cast<const P*>(
            data + static_cast<int64_t>(s_idx[j]) * d + col);
      }
    }
    for (int g = 0; g < rows_here; g += kGroup) {
      // issue the next group's loads before this group's stores and sums
#pragma unroll
      for (int j = 0; j < kGroup; ++j) {
        const int r = g + kGroup + j;
        if (r < rows_here) {
          nxt[j] = *reinterpret_cast<const P*>(
              data + static_cast<int64_t>(s_idx[r]) * d + col);
        }
      }
#pragma unroll
      for (int j = 0; j < kGroup; ++j) {
        const int r = g + j;
        if (r < rows_here) {
          const int64_t row = row0 + r;
          *reinterpret_cast<P*>(gathered + row * d + col) = cur[j];
          if (row < nv) {
#pragma unroll
            for (int k = 0; k < VEC; ++k) {
              const float x = to_float(cur[j].v[k]);
              acc[k] = __fadd_rn(acc[k], x);
              acc2[k] = __fadd_rn(acc2[k], __fmul_rn(x, x));
            }
          }
        }
      }
#pragma unroll
      for (int j = 0; j < kGroup; ++j) cur[j] = nxt[j];
    }
  }

  if (active) {
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      stats[col + k] = acc[k];
      stats[d + col + k] = acc2[k];
    }
  }
}

template <typename T>
void launch(const void* data, const void* indices, const void* n_valid,
            void* gathered, void* stats, int64_t d, int64_t t, int vec,
            unsigned blocks, cudaStream_t s) {
  const T* x = static_cast<const T*>(data);
  const int32_t* idx = static_cast<const int32_t*>(indices);
  const int32_t* nv = static_cast<const int32_t*>(n_valid);
  T* out = static_cast<T*>(gathered);
  float* st = static_cast<float*>(stats);
  if (vec == 4) {
    subsample_gather_kernel<T, 4><<<blocks, kThreads, 0, s>>>(x, idx, nv, out,
                                                              st, d, t);
  } else {
    subsample_gather_kernel<T, 1><<<blocks, kThreads, 0, s>>>(x, idx, nv, out,
                                                              st, d, t);
  }
}

}  // namespace

// Launch on `stream` (PyTorch's current stream).  Pointers are device
// pointers to contiguous data [n, d] and gathered [t, d] of the type
// `dtype` (0 fp32, 1 bf16), indices [t] and n_valid [1] int32, stats [2, d]
// fp32; the caller has checked shapes, types and contiguity, and that
// every index lies in [0, n).  Returns cudaGetLastError() after the launch,
// or cudaErrorInvalidValue for an argument the kernel does not take.
extern "C" int subsample_gather_launch(const void* data, const void* indices,
                                       const void* n_valid, void* gathered,
                                       void* stats, int64_t n, int64_t d,
                                       int64_t t, int dtype, int vec,
                                       void* stream) {
  if (n < 0 || d < 0 || t < 0 || (t > 0 && n == 0) ||
      (dtype != 0 && dtype != 1) || (vec != 1 && vec != 4) ||
      (vec == 4 && d % 4 != 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (d == 0) return static_cast<int>(cudaSuccess);
  const int64_t cols = static_cast<int64_t>(kThreads) * vec;
  const int64_t blocks = (d + cols - 1) / cols;
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    launch<float>(data, indices, n_valid, gathered, stats, d, t, vec,
                  static_cast<unsigned>(blocks), s);
  } else {
    launch<__nv_bfloat16>(data, indices, n_valid, gathered, stats, d, t, vec,
                          static_cast<unsigned>(blocks), s);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* subsample_gather_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
