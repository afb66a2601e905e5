// rglru_scan.cu: the RG-LRU linear recurrence, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/rglru_scan.py:47 rglru_scan (body _rglru_kernel),
// reached from repro.kernels.ops.rglru_scan; in the model it computes what
// src/repro/models/rglru.py::rglru_apply evaluates with an associative scan.
//
// For a, b [B, S, W] fp32 and h0 [B, W] fp32 it writes out [B, S, W] fp32:
//   out[:, t] = a[:, t] * out[:, t - 1] + b[:, t],   out[:, -1] = h0.
// Each step is __fadd_rn(__fmul_rn(a, h), b): the product is rounded before
// the sum and nothing is contracted into a fused multiply-add, so the
// kernel equals the sequential plain version (kernels/ref.py
// linear_scan_ref) bit for bit.  Any S >= 1 and any W: the TPU kernel's
// chunk and width blocks (S % chunk == 0) have no counterpart here.
//
// Design (simple first).  One thread per channel (b, w) walks t from 0 to
// S - 1 with h in a register.  Neighbouring threads take neighbouring w, so
// every load of a row of a and b, and every store of out, is coalesced.
// The loads do not depend on h: each thread holds the next kUnroll steps of
// a and b in registers, issued before the current kUnroll steps are
// computed, so the loads of one group overlap the multiply-adds of the one
// before.  Blocks of 64 threads spread the B * W channels over the SMs.
//
// Bound: bytes.  a and b read once and out written once: 3 * B * S * W * 4
// bytes, at the serving shape [4, 4096, 2560] 503 MB, 0.150 ms at 3.35 TB/s
// (2 operations per element are far below any compute rate).  This kernel
// does not reach it: B * W = 10,240 threads are 320 warps, 2.4 for each of
// the 132 SMs, so the walk along S, one dependent step after another, and
// the latency of its loads set the time.
// Splitting S across CTAs with a carry pass is later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 64;
constexpr int kUnroll = 8;

__global__ void __launch_bounds__(kThreads)
rglru_scan_kernel(const float* __restrict__ a, const float* __restrict__ b,
                  const float* __restrict__ h0, float* __restrict__ out,
                  int64_t seq, int64_t width) {
  const int64_t w = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const int64_t batch = blockIdx.y;
  if (w >= width) return;
  const int64_t base = batch * seq * width + w;
  const float* pa = a + base;
  const float* pb = b + base;
  float* po = out + base;
  float h = h0[batch * width + w];

  float ra[kUnroll], rb[kUnroll];
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const bool in = u < seq;
    ra[u] = in ? __ldg(pa + u * width) : 0.f;
    rb[u] = in ? __ldg(pb + u * width) : 0.f;
  }
  for (int64_t t0 = 0; t0 < seq; t0 += kUnroll) {
    // issue the next group's loads before this group's dependent steps
    float na[kUnroll], nb[kUnroll];
    const int64_t t1 = t0 + kUnroll;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const bool in = t1 + u < seq;
      na[u] = in ? __ldg(pa + (t1 + u) * width) : 0.f;
      nb[u] = in ? __ldg(pb + (t1 + u) * width) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (t0 + u < seq) {
        h = __fadd_rn(__fmul_rn(ra[u], h), rb[u]);
        po[(t0 + u) * width] = h;
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      ra[u] = na[u];
      rb[u] = nb[u];
    }
  }
}

}  // namespace

// Launch on `stream` (PyTorch's current stream).  Pointers are device
// pointers to contiguous a, b, out [batch, seq, width] and h0 [batch,
// width], all fp32; the caller has checked shapes, types and contiguity.
// Returns cudaGetLastError() after the launch, or cudaErrorInvalidValue for
// a shape the kernel does not take.
extern "C" int rglru_scan_launch(const void* a, const void* b, const void* h0,
                                 void* out, int64_t batch, int64_t seq,
                                 int64_t width, void* stream) {
  if (batch < 0 || seq < 0 || width < 0 || batch > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (batch == 0 || seq == 0 || width == 0) {
    return static_cast<int>(cudaSuccess);
  }
  const int64_t blocks = (width + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(blocks),
                  static_cast<unsigned>(batch));
  rglru_scan_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<const float*>(h0), static_cast<float*>(out), seq, width);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* rglru_scan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
