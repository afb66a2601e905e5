// flash_attention.cu: attention forward with an online softmax, for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/flash_attention.py:77 flash_attention
//   (body _flash_kernel), reached from repro.kernels.ops.flash_attention;
// in the model it computes what src/repro/models/layers.py::attention_apply
// evaluates with the jnp _attend_block (layers.py:112).
//
// For q [BH, Sq, HD] and k, v [BH / group, Skv, HD] it writes
//   out[bh, i] = sum_j softmax_j(q[bh, i] . k[g, j] / sqrt(HD)) v[g, j],
//   g = bh / group,
// over the keys j that query i sees: j <= i when causal, and i - j < window
// when window > 0.  With window = 0 and group = 1 that is the TPU kernel's
// function.  The two extensions are what the model needs: `window` is the
// local attention of RecurrentGemma's LOCAL layers, and `group` lets the
// query heads of one KV head (MQA, GQA) read it where it lies, with no copy
// of k and v.  A query row that sees no key at all gives zeros.
//
// Types: q, k and v fp32 or bf16 (one type); the output is in q's type.
// Scores, the softmax state (m, l) and the accumulator are fp32, and the
// probabilities stay fp32 in the product with v.  HD is 32, 64, 128 or 256
// (a template argument); Sq and Skv are any lengths: the ragged edge of a
// tile is masked here, where the TPU kernel asserts that its blocks divide
// the sequence.
//
// Design (simple first).  One CTA of 256 threads per (query head, block of
// 64 query rows); it loops over the 64-key tiles that the causal window
// leaves, from the first key the block's first row sees to the last key
// its last row sees, so fully masked tiles at both ends are never loaded.
// The q block and each k and v tile are staged in shared memory as fp32,
// rows padded to HD + 4 floats, so that the float4 reads of 8 neighbouring
// rows fall on distinct banks: at HD = 256 that is 3 x 66,560 bytes plus
// a 64 x 65 probability tile, 216,320 bytes of dynamic shared memory
// (under the 227 KB a block may take, after cudaFuncSetAttribute).  The
// 256 threads form a 16 x 16 grid: thread (r, c) computes the scores of
// rows r + 16 i and keys c + 16 j (i, j < 4), and owns the output rows
// r + 16 i over HD / 16 columns, its fp32 accumulator (64 floats at
// HD = 256) in registers.  The 16 threads of a row are one half-warp, so
// the row max and sum of the online softmax are shuffles.  Both products
// run on the CUDA cores in fp32.
//
// Bound: operations.  At the serving shape (q [40, 4096, 256] bf16, k, v
// [4, 4096, 256], window 2,048, group 10) the window leaves 251.7 M
// (query, key) pairs, 4 * 256 operations each: 257.7 GFLOP, 0.261 ms at
// the bf16 tensor-core rate of 989 TFLOP/s; the 184 MB read and written
// take 0.055 ms.  This kernel runs its products on the CUDA cores (67
// TFLOP/s fp32 at most) from shared memory, one CTA per SM: it cannot come
// near the bound.  Tensor-core tiles (mma.sync, then wgmma with TMA) are
// later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kRowsPerThread = kBlockQ / 16;  // 4
constexpr int kKeysPerThread = kBlockK / 16;  // 4
constexpr int kLdP = kBlockK + 1;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

__device__ __forceinline__ int64_t min64(int64_t a, int64_t b) {
  return a < b ? a : b;
}

template <int HD>
__host__ __device__ constexpr int ld() {
  return HD + 4;
}

template <int HD>
__host__ __device__ constexpr size_t smem_bytes() {
  return sizeof(float) *
         ((kBlockQ + 2 * kBlockK) * ld<HD>() + kBlockQ * kLdP);
}

// rows [row0, row0 + n) of a [len, HD] matrix into shared memory as fp32,
// rows past `len` as zeros
template <int HD, typename T>
__device__ __forceinline__ void stage(float* dst, const T* __restrict__ src,
                                      int64_t row0, int n, int64_t len) {
  for (int idx = threadIdx.x; idx < n * HD; idx += kThreads) {
    const int r = idx / HD;
    const int c = idx % HD;
    const int64_t row = row0 + r;
    dst[r * ld<HD>() + c] = row < len ? to_f32(src[row * HD + c]) : 0.f;
  }
}

template <int HD, typename T>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out,
                       int64_t sq, int64_t skv, int group, int causal,
                       int64_t window, float scale) {
  constexpr int LD = ld<HD>();
  // output columns of a thread: VEC adjacent ones in each of NV groups
  constexpr int VEC = HD / 16 < 4 ? HD / 16 : 4;
  constexpr int NV = HD / (16 * VEC);
  static_assert(HD == 32 || HD == 64 || HD == 128 || HD == 256, "HD");

  extern __shared__ float smem[];
  float* s_q = smem;                        // [kBlockQ][LD]
  float* s_k = s_q + kBlockQ * LD;          // [kBlockK][LD]
  float* s_v = s_k + kBlockK * LD;          // [kBlockK][LD]
  float* s_p = s_v + kBlockK * LD;          // [kBlockQ][kLdP]

  const int64_t bh = blockIdx.x;
  // the heaviest query blocks (last, under a causal mask) start first
  const int64_t q0 =
      static_cast<int64_t>(gridDim.y - 1 - blockIdx.y) * kBlockQ;
  const int tr = threadIdx.x / 16;
  const int tc = threadIdx.x % 16;

  const T* qh = q + bh * sq * HD;
  const int64_t g = bh / group;
  const T* kh = k + g * skv * HD;
  const T* vh = v + g * skv * HD;

  // keys [lo, hi) hold every key some row of this block sees
  const int64_t q_last = min64(q0 + kBlockQ, sq) - 1;
  const int64_t hi = causal ? min64(skv, q_last + 1) : skv;
  const int64_t lo = window > 0 && q0 - window + 1 > 0 ? q0 - window + 1 : 0;

  float acc[kRowsPerThread][NV][VEC];
  float m[kRowsPerThread], l[kRowsPerThread];
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NV; ++c)
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[i][c][e] = 0.f;
  }

  stage<HD>(s_q, qh, q0, kBlockQ, sq);

  for (int64_t k0 = lo; k0 < hi; k0 += kBlockK) {
    __syncthreads();  // the previous tile's products have read k, v and p
    stage<HD>(s_k, kh, k0, kBlockK, skv);
    stage<HD>(s_v, vh, k0, kBlockK, skv);
    __syncthreads();

    // scores of rows tr + 16 i against keys tc + 16 j
    float s[kRowsPerThread][kKeysPerThread];
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
      for (int j = 0; j < kKeysPerThread; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; d += 4) {
      float4 qa[kRowsPerThread], kb[kKeysPerThread];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i)
        qa[i] = *reinterpret_cast<const float4*>(
            &s_q[(tr + 16 * i) * LD + d]);
#pragma unroll
      for (int j = 0; j < kKeysPerThread; ++j)
        kb[j] = *reinterpret_cast<const float4*>(
            &s_k[(tc + 16 * j) * LD + d]);
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
        for (int j = 0; j < kKeysPerThread; ++j) {
          s[i][j] = fmaf(qa[i].x, kb[j].x, s[i][j]);
          s[i][j] = fmaf(qa[i].y, kb[j].y, s[i][j]);
          s[i][j] = fmaf(qa[i].z, kb[j].z, s[i][j]);
          s[i][j] = fmaf(qa[i].w, kb[j].w, s[i][j]);
        }
    }

    // online softmax: masked keys get probability 0
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) {
      const int64_t row = q0 + tr + 16 * i;
      float mt = -INFINITY;
#pragma unroll
      for (int j = 0; j < kKeysPerThread; ++j) {
        const int64_t key = k0 + tc + 16 * j;
        const bool seen = key < skv && (!causal || key <= row) &&
                          (window <= 0 || row - key < window);
        s[i][j] = seen ? s[i][j] * scale : -INFINITY;
        mt = fmaxf(mt, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, off));
      const float m_new = fmaxf(m[i], mt);
      const float corr = m_new == -INFINITY ? 1.f : expf(m[i] - m_new);
      float lt = 0.f;
#pragma unroll
      for (int j = 0; j < kKeysPerThread; ++j) {
        const float p = s[i][j] == -INFINITY ? 0.f : expf(s[i][j] - m_new);
        lt += p;
        s_p[(tr + 16 * i) * kLdP + tc + 16 * j] = p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        lt += __shfl_xor_sync(0xffffffffu, lt, off);
      l[i] = l[i] * corr + lt;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < NV; ++c)
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[i][c][e] *= corr;
    }
    __syncthreads();

    // acc += p v over the tile's keys
    const int nk = static_cast<int>(min64(kBlockK, hi - k0));
    for (int j = 0; j < nk; ++j) {
      float p[kRowsPerThread];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i)
        p[i] = s_p[(tr + 16 * i) * kLdP + j];
#pragma unroll
      for (int c = 0; c < NV; ++c) {
        const float* vr = &s_v[j * LD + VEC * tc + 16 * VEC * c];
        float vv[VEC];
        if constexpr (VEC == 4) {
          const float4 t = *reinterpret_cast<const float4*>(vr);
          vv[0] = t.x;
          vv[1] = t.y;
          vv[2] = t.z;
          vv[3] = t.w;
        } else {
          const float2 t = *reinterpret_cast<const float2*>(vr);
          vv[0] = t.x;
          vv[1] = t.y;
        }
#pragma unroll
        for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
          for (int e = 0; e < VEC; ++e)
            acc[i][c][e] = fmaf(p[i], vv[e], acc[i][c][e]);
      }
    }
  }

  T* oh = out + bh * sq * HD;
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    const int64_t row = q0 + tr + 16 * i;
    if (row >= sq) continue;
    const float inv = l[i] > 0.f ? 1.f / l[i] : 0.f;
#pragma unroll
    for (int c = 0; c < NV; ++c)
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        store(&oh[row * HD + VEC * tc + 16 * VEC * c + e],
              acc[i][c][e] * inv);
  }
}

template <int HD, typename T>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   int64_t bh, int64_t sq, int64_t skv, int group,
                   int causal, int64_t window, cudaStream_t stream) {
  auto kern = flash_attention_kernel<HD, T>;
  constexpr size_t bytes = smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>(bh),
                  static_cast<unsigned>((sq + kBlockQ - 1) / kBlockQ));
  kern<<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), sq, skv, group, causal,
      window, 1.0f / sqrtf(static_cast<float>(HD)));
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_hd(int64_t hd, const void* q, const void* k,
                        const void* v, void* out, int64_t bh, int64_t sq,
                        int64_t skv, int group, int causal, int64_t window,
                        cudaStream_t s) {
  switch (hd) {
    case 32:
      return launch<32, T>(q, k, v, out, bh, sq, skv, group, causal, window,
                           s);
    case 64:
      return launch<64, T>(q, k, v, out, bh, sq, skv, group, causal, window,
                           s);
    case 128:
      return launch<128, T>(q, k, v, out, bh, sq, skv, group, causal, window,
                            s);
    case 256:
      return launch<256, T>(q, k, v, out, bh, sq, skv, group, causal, window,
                            s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// Launch on `stream` (PyTorch's current stream).  Pointers are device
// pointers to contiguous q and out [bh, sq, hd] and k, v [bh / group, skv,
// hd], all of one type (bf16 when `bf16`, else fp32); the caller has
// checked shapes, types and contiguity.  Returns cudaGetLastError() after
// the launch, or cudaErrorInvalidValue for a shape the kernel does not
// take.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, int64_t bh,
                                      int64_t sq, int64_t skv, int64_t hd,
                                      int64_t group, int causal,
                                      int64_t window, int bf16,
                                      void* stream) {
  if (bh < 0 || sq < 0 || skv < 0 || window < 0 || group < 1 ||
      group > 0x7fffffff || bh % group != 0 || bh > 0x7fffffff ||
      (sq + kBlockQ - 1) / kBlockQ > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (bh == 0 || sq == 0) return static_cast<int>(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int g = static_cast<int>(group);
  cudaError_t err =
      bf16 ? dispatch_hd<__nv_bfloat16>(hd, q, k, v, out, bh, sq, skv, g,
                                        causal, window, s)
           : dispatch_hd<float>(hd, q, k, v, out, bh, sq, skv, g, causal,
                                window, s);
  return static_cast<int>(err);
}

extern "C" const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
