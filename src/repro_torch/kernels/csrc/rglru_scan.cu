// rglru_scan.cu: the RG-LRU linear recurrence, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/rglru_scan.py:47 rglru_scan (body _rglru_kernel),
// reached from repro.kernels.ops.rglru_scan; in the model it computes what
// src/repro/models/rglru.py::rglru_apply evaluates with _gates and an
// associative scan.
//
// Two forms over one body, each writing out [B, S, W] fp32:
//   * Read (rglru_scan_launch, the Pallas kernel's contract): a, b [B, S, W]
//     and h0 [B, W], all fp32,
//       out[:, t] = a[:, t] * out[:, t - 1] + b[:, t],   out[:, -1] = h0.
//   * Gated (rglru_gated_scan_launch, the model's prefill): the post-conv
//     input u [B, S, W] (fp32 or bf16), the gate vectors w_a, b_a, w_x, b_x
//     [W] (fp32 or bf16, one type) and softplus(lam) [W] fp32 give a and b
//     in the kernel, one op after another as the model's _gates takes them
//     in PyTorch on the card:
//       r = sigmoid(w_a * u + b_a),  i = sigmoid(w_x * u + b_x),
//       a = exp((-8 * r) * softplus(lam)),
//       b = sqrt(max(1 - a * a, 1e-6)) * (i * u),
//     with sigmoid(x) = 1 / (1 + exp(-x)) (PyTorch's formula), and the
//     recurrence as above.  Neither a nor b exists in device memory.
// Each product, sum, quotient and root is __fmul_rn, __fadd_rn, __frcp_rn or
// __fsqrt_rn, so nvcc contracts nothing into a fused multiply-add and each
// is correctly rounded, and the exponential is the CUDA math library's
// expf, as in PyTorch's kernels (built without --use_fast_math): the read
// form equals the sequential plain version (kernels/ref.py
// linear_scan_ref) bit for bit, and the gated form equals the gates as
// PyTorch ops on the card followed by the read form.  The max keeps a NaN,
// as torch.clamp does.  Any S >= 1 and any W: the TPU kernel's chunk and
// width blocks (S % chunk == 0) have no counterpart here.
//
// Design.  The recurrence is one dependent fmul + fadd a step: 4,096 steps
// are about 33 k cycles, some 17 us, so the walk along S is not what bounds
// the kernel; keeping enough bytes in flight is.  (The first port, one
// thread a channel holding 8 steps of a and b in registers, had about
// 0.65 MB in flight over the card and moved 1.22 TB/s.)  So the walk is
// fed from shared memory by a pipeline:
//   * One CTA a (batch row, block of kBlockW = 16 channels).  At the
//     serving shape [4, 4096, 2560] that is 640 CTAs, 4.85 an SM over 132:
//     the busiest SM holds 5, 3 % above the mean (blocks of 32 channels
//     would give 320 CTAs, 3 on the busiest SM against a mean of 2.42,
//     24 % above it, and the gated form's arithmetic spreads with them).
//     At 32 KB of shared memory a CTA, all 640 are resident at once.
//   * Warp 0, the scan warp: lane c walks channel c0 + c from t = 0 to
//     S - 1 with h in a register, reading a and b from a ring of kStages
//     shared-memory stages of kChunk steps, and stores each h straight to
//     out (16 lanes, 64 consecutive bytes a step).
//   * The other warps fill the ring kStages - 1 chunks ahead, behind two
//     mbarriers a stage (full: the stage is written; empty: the scan warp
//     has read it).  Read form: one warp of 16-byte cp.async copies
//     (4-byte copies where a row is not 16-byte aligned), each lane's
//     arrival on `full` tracking its own copies
//     (cp.async.mbarrier.arrive.noinc): up to 4 stages of 8 KB in flight a
//     CTA, about 150 KB an SM.  Gated form: kGateWarps = 8 warps read u
//     with plain loads one chunk ahead of the chunk they turn into a and
//     b, write both into the stage and arrive.
//
// Bound: bytes.  Read form: a and b read and out written once, 3 * B * S *
// W * 4 bytes, 503 MB at the serving shape, 0.150 ms at 3.35 TB/s (two
// fp32 operations an element).  Gated form: u read (2 bytes an element in
// bf16) and out written once, 252 MB, 0.075 ms; its 23 operations an
// element (counting exp, the quotients and the root as one each) are
// 0.014 ms at 67 TFLOP/s, but each expf, __frcp_rn and __fsqrt_rn is a
// sequence of instructions, and each quotient and root branches to a slow
// path for inputs the fast one cannot round: some 60-90 instructions an
// element, issued in short dependent chains, set the gated form's time.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlockW = 16;   // channels a CTA
constexpr int kChunk = 64;    // steps a stage
constexpr int kStages = 4;    // stages in the ring
constexpr int kGateWarps = 8; // the gated form's producer warps
constexpr int kGateThreads = 32 * kGateWarps;
constexpr int kRowStep = kGateThreads / kBlockW;  // rows between a thread's
constexpr int kPerThread = kChunk / kRowStep;     // elements of one stage
static_assert(kGateThreads % kBlockW == 0 && kChunk % kRowStep == 0,
              "a gate thread keeps one channel");
static_assert(kBlockW <= 32, "one scan warp walks the block");

struct Ring {
  alignas(16) float a[kStages][kChunk][kBlockW];
  alignas(16) float b[kStages][kChunk][kBlockW];
  alignas(8) uint64_t full[kStages];
  alignas(8) uint64_t empty[kStages];
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  }
}

// VEC fp32 values (VEC = 4: 16 bytes, both addresses 16-byte aligned)
template <int VEC>
__device__ __forceinline__ void cp_async(float* dst, const float* src) {
  if constexpr (VEC == 4) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                     smem_addr(dst)),
                 "l"(src)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                     smem_addr(dst)),
                 "l"(src)
                 : "memory");
  }
}

// one arrival on `bar` once this thread's earlier cp.async copies landed
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(uint16_t bf16) {
  return __uint_as_float(static_cast<uint32_t>(bf16) << 16);  // exact
}

// PyTorch's sigmoid on the card, 1 / (1 + exp(-x)): the quotient correctly
// rounded, which __frcp_rn is in fewer instructions than __fdiv_rn
__device__ __forceinline__ float sigmoid(float x) {
  return __frcp_rn(__fadd_rn(1.0f, expf(-x)));
}

struct Gates {
  float wa, ba, wx, bx, sp;
};

// _gates of the model, op by op: a and b of one element from u
__device__ __forceinline__ void gate(float u, const Gates& g, float& a,
                                     float& b) {
  const float r = sigmoid(__fadd_rn(__fmul_rn(g.wa, u), g.ba));
  const float i = sigmoid(__fadd_rn(__fmul_rn(g.wx, u), g.bx));
  a = expf(__fmul_rn(__fmul_rn(-8.0f, r), g.sp));
  float keep = __fsub_rn(1.0f, __fmul_rn(a, a));
  keep = isnan(keep) ? keep : fmaxf(keep, static_cast<float>(1e-6));
  b = __fmul_rn(__fsqrt_rn(keep), __fmul_rn(i, u));
}

// The scan warp: lane c walks channel c0 + c over every chunk.
__device__ __forceinline__ void scan(Ring& ring, const float* __restrict__ h0,
                                     float* __restrict__ out, int64_t batch,
                                     int64_t seq, int64_t width, int64_t c0,
                                     int64_t chunks) {
  const int lane = threadIdx.x;
  const int64_t ch = c0 + lane;
  const bool live = lane < kBlockW && ch < width;
  float h = live ? h0[batch * width + ch] : 0.f;
  float* po = out + batch * seq * width + ch;
  for (int64_t k = 0; k < chunks; ++k) {
    const int s = static_cast<int>(k % kStages);
    mbar_wait(&ring.full[s], static_cast<uint32_t>((k / kStages) & 1));
    const int64_t left = seq - k * kChunk;
    const int rows = left < kChunk ? static_cast<int>(left) : kChunk;
    if (live) {
      const float* ra = &ring.a[s][0][lane];
      const float* rb = &ring.b[s][0][lane];
      if (rows == kChunk) {
#pragma unroll 16
        for (int t = 0; t < kChunk; ++t) {
          h = __fadd_rn(__fmul_rn(ra[t * kBlockW], h), rb[t * kBlockW]);
          po[t * width] = h;
        }
      } else {
        for (int t = 0; t < rows; ++t) {
          h = __fadd_rn(__fmul_rn(ra[t * kBlockW], h), rb[t * kBlockW]);
          po[t * width] = h;
        }
      }
      po += rows * width;
    }
    mbar_arrive(&ring.empty[s]);
  }
}

__device__ __forceinline__ void init_ring(Ring& ring, uint32_t producers) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&ring.full[s], producers);
      mbar_init(&ring.empty[s], 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
}

// Read form.  Warp 1 copies a and b into the ring.
template <int VEC>
__global__ void __launch_bounds__(64)
rglru_scan_kernel(const float* __restrict__ a, const float* __restrict__ b,
                  const float* __restrict__ h0, float* __restrict__ out,
                  int64_t seq, int64_t width) {
  __shared__ Ring ring;
  init_ring(ring, 32);
  const int64_t batch = blockIdx.y;
  const int64_t c0 = static_cast<int64_t>(blockIdx.x) * kBlockW;
  const int64_t chunks = (seq + kChunk - 1) / kChunk;
  if (threadIdx.x < 32) {
    scan(ring, h0, out, batch, seq, width, c0, chunks);
    return;
  }
  constexpr int kPieces = kBlockW / VEC;       // copies a row of a tile
  const int lane = threadIdx.x - 32;
  const int64_t base = batch * seq * width + c0;
  for (int64_t k = 0; k < chunks; ++k) {
    const int s = static_cast<int>(k % kStages);
    if (k >= kStages) {
      mbar_wait(&ring.empty[s], static_cast<uint32_t>((k / kStages - 1) & 1));
    }
    const int64_t t0 = k * kChunk;
    const int64_t left = seq - t0;
    const int rows = left < kChunk ? static_cast<int>(left) : kChunk;
    for (int q = lane; q < rows * kPieces; q += 32) {
      const int row = q / kPieces;
      const int col = (q % kPieces) * VEC;
      if (c0 + col < width) {   // W % VEC == 0 where VEC > 1
        const int64_t off = base + (t0 + row) * width + col;
        cp_async<VEC>(&ring.a[s][row][col], a + off);
        cp_async<VEC>(&ring.b[s][row][col], b + off);
      }
    }
    cp_async_arrive(&ring.full[s]);
  }
  cp_async_wait_all();
}

// Gated form.  Warps 1..kGateWarps form a and b from u into the ring:
// thread p keeps channel c0 + p % kBlockW and rows p / kBlockW + j *
// kRowStep of each chunk, loading the next chunk's u while it forms this
// one's gates.  Rows past S and channels past W are formed from u = 0 and
// never read, so no branch splits the loop over a thread's rows.  At most
// 40 registers a thread let 5 CTAs share an SM (4.85 at the serving shape).
template <typename U>
__global__ void __launch_bounds__(32 + kGateThreads, 5)
rglru_gated_scan_kernel(const U* __restrict__ u, const void* __restrict__ wa,
                        const void* __restrict__ ba,
                        const void* __restrict__ wx,
                        const void* __restrict__ bx,
                        const float* __restrict__ sp,
                        const float* __restrict__ h0, float* __restrict__ out,
                        int64_t seq, int64_t width, int params_bf16) {
  __shared__ Ring ring;
  init_ring(ring, kGateThreads);
  const int64_t batch = blockIdx.y;
  const int64_t c0 = static_cast<int64_t>(blockIdx.x) * kBlockW;
  const int64_t chunks = (seq + kChunk - 1) / kChunk;
  if (threadIdx.x < 32) {
    scan(ring, h0, out, batch, seq, width, c0, chunks);
    return;
  }
  const int p = threadIdx.x - 32;
  const int c = p % kBlockW;
  const int r0 = p / kBlockW;
  const int64_t ch = c0 + c;
  const bool live = ch < width;
  Gates g{0.f, 0.f, 0.f, 0.f, 0.f};
  if (live) {
    auto param = [&](const void* v) {
      return params_bf16 ? to_float(static_cast<const uint16_t*>(v)[ch])
                         : static_cast<const float*>(v)[ch];
    };
    g = Gates{param(wa), param(ba), param(wx), param(bx), sp[ch]};
  }
  const U* pu = u + (batch * seq + r0) * width + ch;
  auto load = [&](int64_t k, float (&v)[kPerThread]) {
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) {
      const int64_t t = k * kChunk + r0 + j * kRowStep;
      v[j] = live && t < seq
                 ? to_float(__ldg(pu + (k * kChunk + j * kRowStep) * width))
                 : 0.f;
    }
  };
  float cur[kPerThread], next[kPerThread];
  load(0, cur);
  for (int64_t k = 0; k < chunks; ++k) {
    const int s = static_cast<int>(k % kStages);
    if (k + 1 < chunks) load(k + 1, next);
    if (k >= kStages) {
      mbar_wait(&ring.empty[s], static_cast<uint32_t>((k / kStages - 1) & 1));
    }
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) {
      const int row = r0 + j * kRowStep;
      gate(cur[j], g, ring.a[s][row][c], ring.b[s][row][c]);
    }
    mbar_arrive(&ring.full[s]);
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) cur[j] = next[j];
  }
}

int check_shape(int64_t batch, int64_t seq, int64_t width) {
  if (batch < 0 || seq < 0 || width < 0 || batch > 65535 ||
      (width + kBlockW - 1) / kBlockW > 0x7fffffff) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaSuccess);
}

dim3 grid_of(int64_t batch, int64_t width) {
  return dim3(static_cast<unsigned>((width + kBlockW - 1) / kBlockW),
              static_cast<unsigned>(batch));
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

// Read form, launched on `stream` (PyTorch's current stream).  Pointers are
// device pointers to contiguous a, b, out [batch, seq, width] and h0
// [batch, width], all fp32; the caller has checked shapes, types and
// contiguity.  Rows are copied 16 bytes at a time where a and b are 16-byte
// aligned and width % 4 == 0, else 4 bytes at a time.  Returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue for a
// shape the kernel does not take.
extern "C" int rglru_scan_launch(const void* a, const void* b, const void* h0,
                                 void* out, int64_t batch, int64_t seq,
                                 int64_t width, void* stream) {
  if (const int code = check_shape(batch, seq, width)) return code;
  if (batch == 0 || seq == 0 || width == 0) {
    return static_cast<int>(cudaSuccess);
  }
  auto kernel = &rglru_scan_kernel<1>;
  if (aligned16(a) && aligned16(b) && width % 4 == 0) {
    kernel = &rglru_scan_kernel<4>;
  }
  kernel<<<grid_of(batch, width), 64, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<const float*>(h0), static_cast<float*>(out), seq, width);
  return static_cast<int>(cudaGetLastError());
}

// Gated form, on `stream`.  u [batch, seq, width] (bf16 where u_bf16, else
// fp32), w_a, b_a, w_x, b_x [width] (bf16 where params_bf16, else fp32),
// softplus(lam) [width] and h0 [batch, width] fp32, out [batch, seq, width]
// fp32, all contiguous, checked by the caller; no alignment is needed.
extern "C" int rglru_gated_scan_launch(
    const void* u, const void* wa, const void* ba, const void* wx,
    const void* bx, const void* sp, const void* h0, void* out, int64_t batch,
    int64_t seq, int64_t width, int u_bf16, int params_bf16, void* stream) {
  if (const int code = check_shape(batch, seq, width)) return code;
  if (batch == 0 || seq == 0 || width == 0) {
    return static_cast<int>(cudaSuccess);
  }
  const dim3 grid = grid_of(batch, width);
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* spf = static_cast<const float*>(sp);
  const auto* h0f = static_cast<const float*>(h0);
  auto* o = static_cast<float*>(out);
  if (u_bf16) {
    rglru_gated_scan_kernel<uint16_t><<<grid, 32 + kGateThreads, 0, st>>>(
        static_cast<const uint16_t*>(u), wa, ba, wx, bx, spf, h0f, o, seq,
        width, params_bf16);
  } else {
    rglru_gated_scan_kernel<float><<<grid, 32 + kGateThreads, 0, st>>>(
        static_cast<const float*>(u), wa, ba, wx, bx, spf, h0f, o, seq, width,
        params_bf16);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* rglru_scan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
