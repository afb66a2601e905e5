// threefry.cuh: jax's counter-based draws on the card, bit for bit.
//
// A transcription of src/repro_torch/prng.py, which reproduces
// jax.random under jax's defaults (jax_threefry_partitionable on,
// threefry2x32) and which the CPU tests hold against jax itself:
//   threefry2x32  prng.py:62-77  20 rounds, rotations (13, 15, 26, 6) and
//                                (17, 29, 16, 24), key words k0, k1 and
//                                k0 ^ k1 ^ 0x1BD11BDA injected after each
//                                four rounds with the round count (:75-76)
//   jax_key       prng.py:49-55  PRNGKey(seed) = (0, seed's two's-
//                                complement bits)
//   jax_split     prng.py:80-87  split(key) = (hash(key, 0, 0),
//                                hash(key, 0, 1)), both output words each
//   randint_at    prng.py:114-136  bits(k, n) = out0 ^ out1 of
//                                hash(k, 0, n); the draw is
//                                ((bits(k1, n) % span) * multiplier +
//                                bits(k2, n) % span) % span in uint32
//                                wrap, plus lo
// The counter's high word is 0: a caller draws at most 2^32 positions a
// key.  `multiplier` is the host's prng._randint_multiplier (:101-111);
// when it is 0 (a power-of-two span up to 2^16, or any span above), the
// k1 term is 0 and k1 need not be derived at all.  A power-of-two span
// takes its remainder as a mask, which gives the same bits as `%`.
//
// Cost: one hash is 2 adds, 20 rounds of add, rotate (__funnelshift_l)
// and xor, and 5 injections of 2 adds: about 75 32-bit integer
// operations with the xor of its output words.  A draw with a zero
// multiplier is one hash; with a non-zero one, two and three remainders.
//
// Holds no kernel: subsample_grid.cu includes it, and so can any kernel
// that draws jax's indices itself.

#pragma once

#include <stdint.h>

namespace threefry {

constexpr uint32_t kParity = 0x1BD11BDAu;

struct Key {
  uint32_t k0, k1;
};

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return __funnelshift_l(x, x, r);
}

// Four rounds of mixing with the rotations r0..r3.
__device__ __forceinline__ void mix4(uint32_t& x0, uint32_t& x1, int r0,
                                     int r1, int r2, int r3) {
  x0 += x1; x1 = rotl(x1, r0) ^ x0;
  x0 += x1; x1 = rotl(x1, r1) ^ x0;
  x0 += x1; x1 = rotl(x1, r2) ^ x0;
  x0 += x1; x1 = rotl(x1, r3) ^ x0;
}

// The Threefry-2x32 hash of the counter words (x0, x1) under `key`:
// both output words.  Unsigned adds wrap modulo 2^32, as prng.py's masks.
__device__ __forceinline__ Key threefry2x32(Key key, uint32_t x0,
                                            uint32_t x1) {
  const uint32_t k0 = key.k0, k1 = key.k1, k2 = k0 ^ k1 ^ kParity;
  x0 += k0; x1 += k1;
  mix4(x0, x1, 13, 15, 26, 6);  x0 += k1; x1 += k2 + 1u;
  mix4(x0, x1, 17, 29, 16, 24); x0 += k2; x1 += k0 + 2u;
  mix4(x0, x1, 13, 15, 26, 6);  x0 += k0; x1 += k1 + 3u;
  mix4(x0, x1, 17, 29, 16, 24); x0 += k1; x1 += k2 + 4u;
  mix4(x0, x1, 13, 15, 26, 6);  x0 += k2; x1 += k0 + 5u;
  return Key{x0, x1};
}

// jax.random.PRNGKey of an int32 seed.
__device__ __forceinline__ Key jax_key(int32_t seed) {
  return Key{0u, static_cast<uint32_t>(seed)};
}

// The first and the second key of jax.random.split(key, 2).
__device__ __forceinline__ Key jax_split_first(Key key) {
  return threefry2x32(key, 0u, 0u);
}
__device__ __forceinline__ Key jax_split_second(Key key) {
  return threefry2x32(key, 0u, 1u);
}

// 32 random bits of `key` at flat position n (jax's random_bits).
__device__ __forceinline__ uint32_t bits_at(Key key, uint32_t n) {
  const Key out = threefry2x32(key, 0u, n);
  return out.k0 ^ out.k1;
}

// What a randint draw needs besides its keys: span = hi - lo (1 for an
// empty range), the multiplier, and span - 1 when span is a power of two
// (else 0, and `%` is taken).
struct Span {
  uint32_t span, multiplier, pow2_mask;
};

__host__ __device__ inline Span make_span(uint32_t span,
                                          uint32_t multiplier) {
  const bool pow2 = span > 1u && (span & (span - 1u)) == 0u;
  return Span{span, multiplier, pow2 ? span - 1u : 0u};
}

__device__ __forceinline__ uint32_t rem(uint32_t x, Span s) {
  return s.pow2_mask ? (x & s.pow2_mask) : x % s.span;
}

// jax.random.randint(key, shape, lo, lo + span, int32) at flat position
// n, as its offset from lo, where k1, k2 = jax.random.split(key).  k1 is
// read only when the multiplier is not 0.
__device__ __forceinline__ uint32_t randint_at(Key k1, Key k2, uint32_t n,
                                               Span s) {
  const uint32_t lower = rem(bits_at(k2, n), s);
  if (s.multiplier == 0u) return lower;
  const uint32_t higher = rem(bits_at(k1, n), s);
  return rem(higher * s.multiplier + lower, s);
}

}  // namespace threefry
