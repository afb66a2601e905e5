// attention_decode_int8.cu: one decode step's attention over an int8 KV
// cache, for Hopper (sm_90a).
//
// Replaces no TPU kernel.  The reference decodes with jnp ops
// (src/repro/models/layers.py::attention_decode): it quantizes the new
// token, writes it into a copy of the cache, dequantizes the whole cache to
// the model's type and attends with two einsums.  The port ran the same
// torch ops (kernels/ref.py::attention_decode_int8_ref, now its plain
// version): six elementwise passes over every layer's whole cache a step,
// about 43 launches a layer.  This kernel is those ops in one launch that
// reads the int8 values and fp32 scales where they lie.
//
// For q [B, KV, G, HD] (one token, bf16), the new token's k, v [B, KV, HD]
// (bf16) and a cache k, v [B, S, KV, HD] int8 with k_scale, v_scale
// [B, S, KV] fp32 it
//   1. quantizes the new k and v rows as quantize_kv does, bit for bit
//      (absmax over HD floored at 1e-8, scale = absmax / 127 by a true
//      division, round half to even of x / scale, clamp to +-127) and
//      writes values and scale into the cache at slot write_at;
//   2. reads slots [0, n_valid), the ones the plain version's mask keeps
//      (always a prefix: slot <= pos, or every slot once a rolling window
//      has wrapped), and dequantizes each element as the plain version
//      does: fp32(int8) * scale in fp32, rounded to bf16 and back;
//   3. scores each slot against the G query heads of its KV head in fp32,
//      times sm_scale, and writes
//        out[b, kvh, g] = sum_j softmax_j(score) v_j
//      in bf16.  The probabilities stay fp32 (the plain version rounds
//      them to bf16 before the product with v).
// The slots outside [0, n_valid) score exactly 0 after the plain version's
// softmax, so skipping them changes no sum.  It is built for what runs it:
// HD 128 in bf16, deepseek-7b's decode, the one model that keeps an int8
// cache; one instance for each count of query heads a CTA (1, 2, 4, 8).
//
// Bound: bytes.  At deepseek-7b's decode (B 8, S 4,096, KV 32, HD 128,
// G 1) the filled cache is 268 MB of values and 8.4 MB of scales a layer,
// 0.083 ms at 3.35 TB/s; the arithmetic, about 5 instructions an element
// with G = 1, is about 0.05 ms of issue, so it hides behind the loads.
//
// Layout: one CTA of 128 threads per (batch row, KV head, group of up to 8
// query heads, split of the filled length); the splits are chunks of 256
// slots, or fewer where the launch would leave SMs empty (flash-decoding).
// A slot's HD int8 values are HD / 16 lanes' 16-byte loads, so a warp
// reads whole 128-byte rows; each lane dequantizes its 16 values in
// registers (a byte permute onto 2^23 and one subtraction makes the fp32
// of an int8), and the lanes of a slot add their partial dot products by
// shuffles in a fixed order.  The CTA keeps its chunk's scores in shared
// memory, takes max and sum per query head, then reads the chunk's v rows
// the same way and accumulates p * v in registers, reduced over the
// slots' lanes by shuffles and over warps in shared memory in a fixed
// order.  With more than one split each CTA writes its (max, sum, acc) to
// scratch; the last CTA of a (batch row, KV head, group) to finish, told
// by a ticket, combines the splits in split order and resets its ticket to
// 0 for the next launch.  No atomic touches a sum, so two launches on the
// same inputs give the same bits.  The CTA whose split holds write_at
// quantizes the new rows first (with more than one group of query heads,
// one CTA each, all writing the same bytes) and reads them back after a
// barrier; no other CTA reads that slot.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxChunk = 256;   // slots a CTA reads at most
constexpr int kUnroll = 4;       // 16-byte loads a lane keeps in flight
// The head size: deepseek-7b's, the one model that keeps an int8 cache
constexpr int HD = 128;

// bf16 loads, stores and rounding
struct Bf16 {
  // 16 consecutive values from 16-byte aligned p
  static __device__ __forceinline__ void load16(const __nv_bfloat16* p,
                                                float* out) {
    const uint4* v = reinterpret_cast<const uint4*>(p);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const uint4 w = v[i];
      const uint32_t words[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        out[8 * i + 2 * j] = __uint_as_float(words[j] << 16);
        out[8 * i + 2 * j + 1] = __uint_as_float(words[j] & 0xffff0000u);
      }
    }
  }
  static __device__ __forceinline__ float load(const __nv_bfloat16* p) {
    return __bfloat162float(*p);
  }
  static __device__ __forceinline__ __nv_bfloat16 from(float x) {
    return __float2bfloat16_rn(x);
  }
  // the plain version's cast of the dequantized fp32 pair to bf16 and back
  static __device__ __forceinline__ void round_pair(float& a, float& b) {
    __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
    const uint32_t u = *reinterpret_cast<uint32_t*>(&h);
    a = __uint_as_float(u << 16);
    b = __uint_as_float(u & 0xffff0000u);
  }
};

// fp32 of 16 int8 values times scale, rounded to bf16 and back.  An int8 b,
// biased to the byte b + 128 and permuted under the exponent of 2^23, is
// the float 2^23 + 128 + b, exact, and one subtraction leaves b.
__device__ __forceinline__ void dequant16(const uint4 raw, const float scale,
                                          float* x) {
  const uint32_t words[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint32_t u = words[i] ^ 0x80808080u;
    x[4 * i] = __uint_as_float(__byte_perm(u, 0x4b000000u, 0x7540));
    x[4 * i + 1] = __uint_as_float(__byte_perm(u, 0x4b000000u, 0x7541));
    x[4 * i + 2] = __uint_as_float(__byte_perm(u, 0x4b000000u, 0x7542));
    x[4 * i + 3] = __uint_as_float(__byte_perm(u, 0x4b000000u, 0x7543));
  }
#pragma unroll
  for (int e = 0; e < 16; ++e) {
    x[e] = __fmul_rn(__fsub_rn(x[e], 8388736.0f), scale);
  }
#pragma unroll
  for (int e = 0; e < 16; e += 2) Bf16::round_pair(x[e], x[e + 1]);
}

struct Args {
  const void* q;       // [B, KV, G, HD]
  const void* k_new;   // [B, KV, HD]
  const void* v_new;
  int8_t* k;           // [B, S, KV, HD], slot write_at written here
  int8_t* v;
  float* k_scale;      // [B, S, KV]
  float* v_scale;
  void* out;           // [B, KV, G, HD]
  float* part_acc;     // [B, KV, G, nsplit, HD]
  float* part_ml;      // [B, KV, G, nsplit, 2]: max, sum
  int* tickets;        // [B, KV, gchunks], 0 between launches
  int s, kv, g, write_at, n_valid, chunk, nsplit, gchunks;
  float sm_scale;
};

// Quantize one new row of HD values into the cache: warp 0 takes k, warp
// 1 takes v, each lane HD / 32 values.
__device__ __forceinline__ void write_new_row(const Args& a, int b, int kvh,
                                              int warp, int lane) {
  if (warp >= 2) return;
  constexpr int kPer = HD / 32;
  const __nv_bfloat16* src =
      static_cast<const __nv_bfloat16*>(warp == 0 ? a.k_new : a.v_new)
      + (static_cast<size_t>(b) * a.kv + kvh) * HD + lane * kPer;
  const size_t at = (static_cast<size_t>(b) * a.s + a.write_at) * a.kv + kvh;
  int8_t* dst = (warp == 0 ? a.k : a.v) + at * HD + lane * kPer;
  float x[kPer];
  float amax = 0.0f;
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    x[i] = Bf16::load(src + i);
    amax = fmaxf(amax, fabsf(x[i]));
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  }
  const float scale = __fdiv_rn(fmaxf(amax, 1e-8f), 127.0f);
  int8_t q[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const float r = rintf(__fdiv_rn(x[i], scale));
    q[i] = static_cast<int8_t>(fminf(fmaxf(r, -127.0f), 127.0f));
  }
#pragma unroll
  for (int i = 0; i < kPer; i += 2) {
    *reinterpret_cast<char2*>(dst + i) = make_char2(q[i], q[i + 1]);
  }
  if (lane == 0) (warp == 0 ? a.k_scale : a.v_scale)[at] = scale;
}

template <int GC>
__global__ void __launch_bounds__(kThreads)
attention_decode_int8_kernel(const Args a) {
  constexpr int kLanes = HD / 16;           // lanes a slot
  constexpr int kSlotsWarp = 32 / kLanes;
  constexpr int kSlotsPass = kSlotsWarp * kWarps;
  __shared__ float s_p[GC][kMaxChunk];      // scores, then probabilities
  __shared__ float s_red[kWarps][GC][HD];
  __shared__ float s_m[GC], s_l[GC];
  __shared__ int s_last;

  const int b = blockIdx.z, split = blockIdx.y;
  const int kvh = blockIdx.x / a.gchunks;
  const int g0 = (blockIdx.x % a.gchunks) * GC;
  const int gn = min(GC, a.g - g0);
  const int start = split * a.chunk;
  const int n_here = min(a.chunk, a.n_valid - start);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int seg = lane % kLanes;
  const int sub = warp * kSlotsWarp + lane / kLanes;

  if (a.write_at >= start && a.write_at < start + n_here) {
    write_new_row(a, b, kvh, warp, lane);
    __syncthreads();
  }

  // this lane's 16 values of each query head, fp32
  float qr[GC][16];
  const __nv_bfloat16* qbase = static_cast<const __nv_bfloat16*>(a.q)
                   + ((static_cast<size_t>(b) * a.kv + kvh) * a.g + g0) * HD
                   + seg * 16;
#pragma unroll
  for (int g = 0; g < GC; ++g) {
    if (g < gn) {
      Bf16::load16(qbase + static_cast<size_t>(g) * HD, qr[g]);
    } else {
#pragma unroll
      for (int e = 0; e < 16; ++e) qr[g][e] = 0.0f;
    }
  }

  const size_t slot_stride = static_cast<size_t>(a.kv) * HD;
  const size_t row0 = (static_cast<size_t>(b) * a.s + start) * a.kv + kvh;
  const int8_t* kb = a.k + row0 * HD + seg * 16;
  const int8_t* vb = a.v + row0 * HD + seg * 16;
  const float* ksb = a.k_scale + row0;
  const float* vsb = a.v_scale + row0;

  // scores
  for (int t0 = 0; t0 < n_here; t0 += kSlotsPass * kUnroll) {
    uint4 raw[kUnroll];
    float sc[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int j = t0 + u * kSlotsPass + sub;
      if (j < n_here) {
        raw[u] = *reinterpret_cast<const uint4*>(kb + j * slot_stride);
        sc[u] = ksb[static_cast<size_t>(j) * a.kv];
      } else {
        raw[u] = make_uint4(0u, 0u, 0u, 0u);
        sc[u] = 0.0f;
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      float x[16];
      dequant16(raw[u], sc[u], x);
      float dot[GC];
#pragma unroll
      for (int g = 0; g < GC; ++g) {
        float d = 0.0f;
#pragma unroll
        for (int e = 0; e < 16; ++e) d = fmaf(qr[g][e], x[e], d);
#pragma unroll
        for (int off = kLanes / 2; off > 0; off >>= 1) {
          d += __shfl_xor_sync(0xffffffffu, d, off);
        }
        dot[g] = d;
      }
      const int j = t0 + u * kSlotsPass + sub;
      if (seg == 0 && j < n_here) {
#pragma unroll
        for (int g = 0; g < GC; ++g) {
          if (g < gn) s_p[g][j] = dot[g] * a.sm_scale;
        }
      }
    }
  }
  __syncthreads();

  // softmax over the chunk: one warp a query head
  for (int g = warp; g < gn; g += kWarps) {
    float m = -INFINITY;
    for (int j = lane; j < n_here; j += 32) m = fmaxf(m, s_p[g][j]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    }
    float l = 0.0f;
    for (int j = lane; j < n_here; j += 32) {
      const float p = expf(s_p[g][j] - m);
      s_p[g][j] = p;
      l += p;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      l += __shfl_xor_sync(0xffffffffu, l, off);
    }
    if (lane == 0) {
      s_m[g] = m;
      s_l[g] = l;
    }
  }
  __syncthreads();

  // p v
  float acc[GC][16];
#pragma unroll
  for (int g = 0; g < GC; ++g) {
#pragma unroll
    for (int e = 0; e < 16; ++e) acc[g][e] = 0.0f;
  }
  for (int t0 = 0; t0 < n_here; t0 += kSlotsPass * kUnroll) {
    uint4 raw[kUnroll];
    float sc[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int j = t0 + u * kSlotsPass + sub;
      if (j < n_here) {
        raw[u] = *reinterpret_cast<const uint4*>(vb + j * slot_stride);
        sc[u] = vsb[static_cast<size_t>(j) * a.kv];
      } else {
        raw[u] = make_uint4(0u, 0u, 0u, 0u);
        sc[u] = 0.0f;
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int j = t0 + u * kSlotsPass + sub;
      float x[16];
      dequant16(raw[u], sc[u], x);
#pragma unroll
      for (int g = 0; g < GC; ++g) {
        const float p = (g < gn && j < n_here) ? s_p[g][j] : 0.0f;
#pragma unroll
        for (int e = 0; e < 16; ++e) acc[g][e] = fmaf(p, x[e], acc[g][e]);
      }
    }
  }
  // over the slots of a warp, then over the warps in order
#pragma unroll
  for (int g = 0; g < GC; ++g) {
#pragma unroll
    for (int e = 0; e < 16; ++e) {
#pragma unroll
      for (int off = kLanes; off < 32; off <<= 1) {
        acc[g][e] += __shfl_xor_sync(0xffffffffu, acc[g][e], off);
      }
    }
  }
  if (lane < kLanes) {
#pragma unroll
    for (int g = 0; g < GC; ++g) {
#pragma unroll
      for (int e = 0; e < 16; e += 4) {
        *reinterpret_cast<float4*>(&s_red[warp][g][seg * 16 + e]) =
            make_float4(acc[g][e], acc[g][e + 1], acc[g][e + 2],
                        acc[g][e + 3]);
      }
    }
  }
  __syncthreads();

  const size_t head0 = (static_cast<size_t>(b) * a.kv + kvh) * a.g + g0;
  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(a.out);
  if (a.nsplit == 1) {
    for (int i = threadIdx.x; i < gn * HD; i += kThreads) {
      const int g = i / HD, d = i % HD;
      float sum = s_red[0][g][d];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) sum += s_red[w][g][d];
      out[(head0 + g) * HD + d] = Bf16::from(__fdiv_rn(sum, s_l[g]));
    }
    return;
  }

  for (int i = threadIdx.x; i < gn * HD; i += kThreads) {
    const int g = i / HD, d = i % HD;
    float sum = s_red[0][g][d];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) sum += s_red[w][g][d];
    a.part_acc[((head0 + g) * a.nsplit + split) * HD + d] = sum;
  }
  if (threadIdx.x < gn) {
    float* ml = a.part_ml + ((head0 + threadIdx.x) * a.nsplit + split) * 2;
    ml[0] = s_m[threadIdx.x];
    ml[1] = s_l[threadIdx.x];
  }
  __threadfence();
  __syncthreads();
  int* ticket = a.tickets + (static_cast<size_t>(b) * a.kv + kvh) * a.gchunks
                + blockIdx.x % a.gchunks;
  if (threadIdx.x == 0) s_last = atomicAdd(ticket, 1) == a.nsplit - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();

  // the last CTA: every split in split order
  for (int i = threadIdx.x; i < gn * HD; i += kThreads) {
    const int g = i / HD, d = i % HD;
    const float* ml = a.part_ml + (head0 + g) * a.nsplit * 2;
    const float* acc_g = a.part_acc + (head0 + g) * a.nsplit * HD + d;
    float m = -INFINITY;
    for (int sp = 0; sp < a.nsplit; ++sp) m = fmaxf(m, __ldcg(ml + 2 * sp));
    float l = 0.0f, sum = 0.0f;
    for (int sp = 0; sp < a.nsplit; ++sp) {
      const float w = expf(__ldcg(ml + 2 * sp) - m);
      l = fmaf(w, __ldcg(ml + 2 * sp + 1), l);
      sum = fmaf(w, __ldcg(acc_g + static_cast<size_t>(sp) * HD), sum);
    }
    out[(head0 + g) * HD + d] = Bf16::from(__fdiv_rn(sum, l));
  }
  if (threadIdx.x == 0) *ticket = 0;
}

template <int GC>
cudaError_t launch(const Args& a, int batch, cudaStream_t stream) {
  const dim3 grid(a.kv * a.gchunks, a.nsplit, batch);
  attention_decode_int8_kernel<GC><<<grid, kThreads, 0, stream>>>(a);
  return cudaGetLastError();
}

cudaError_t dispatch_group(int gc, const Args& a, int batch,
                           cudaStream_t stream) {
  switch (gc) {
    case 1: return launch<1>(a, batch, stream);
    case 2: return launch<2>(a, batch, stream);
    case 4: return launch<4>(a, batch, stream);
    case 8: return launch<8>(a, batch, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// The query heads a CTA takes: G itself up to 8 (rounded up to 1, 2, 4 or
// 8), groups of 8 beyond.
static int group_chunk(int64_t g) {
  return g <= 1 ? 1 : g <= 2 ? 2 : g <= 4 ? 4 : 8;
}

// Launch on CUDA pointers checked by the Python wrapper.  part_acc holds
// B * KV * G * nsplit * HD floats, part_ml B * KV * G * nsplit * 2 and
// tickets B * KV * ceil(G / group_chunk(G)) ints, all 0, where nsplit =
// ceil(n_valid / chunk); with nsplit 1 the three are not touched.
extern "C" int attention_decode_int8_launch(
    const void* q, const void* k_new, const void* v_new, void* k, void* v,
    void* k_scale, void* v_scale, void* out, void* part_acc, void* part_ml,
    void* tickets, int64_t batch, int64_t s, int64_t kv, int64_t g,
    int64_t hd, int64_t write_at, int64_t n_valid, int64_t chunk,
    float sm_scale, void* stream) {
  if (hd != HD || batch < 1 || batch > 65535 || kv < 1 || g < 1 || s < 1 ||
      s > 0x7fffffff || n_valid < 1 || n_valid > s || write_at < 0 ||
      write_at >= n_valid || chunk < 1 || chunk > kMaxChunk ||
      kv * g > 0x7fffffff) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int gc = group_chunk(g);
  Args a;
  a.q = q;
  a.k_new = k_new;
  a.v_new = v_new;
  a.k = static_cast<int8_t*>(k);
  a.v = static_cast<int8_t*>(v);
  a.k_scale = static_cast<float*>(k_scale);
  a.v_scale = static_cast<float*>(v_scale);
  a.out = out;
  a.part_acc = static_cast<float*>(part_acc);
  a.part_ml = static_cast<float*>(part_ml);
  a.tickets = static_cast<int*>(tickets);
  a.s = static_cast<int>(s);
  a.kv = static_cast<int>(kv);
  a.g = static_cast<int>(g);
  a.write_at = static_cast<int>(write_at);
  a.n_valid = static_cast<int>(n_valid);
  a.chunk = static_cast<int>(chunk);
  a.nsplit = static_cast<int>((n_valid + chunk - 1) / chunk);
  a.gchunks = static_cast<int>((g + gc - 1) / gc);
  a.sm_scale = sm_scale;
  if (a.nsplit > 65535) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      dispatch_group(gc, a, static_cast<int>(batch), st));
}

extern "C" const char* attention_decode_int8_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
