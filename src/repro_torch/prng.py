"""Counter-based PRNG that reproduces ``jax.random`` bit for bit.

The reference draws every task's row indices with
``jax.random.randint(jax.random.PRNGKey(seed), (n,), 0, ns, dtype=int32)``
on int32 seeds ``spec.seed + task_id``.  Reproducing those exact integers
makes the port's end-to-end parity an ``allclose`` on statistics (same
rows, other summation order) rather than a statistical test.

What is reproduced, under jax's defaults (``jax_threefry_partitionable``
on, implementation ``threefry2x32``):

* ``PRNGKey(seed)`` for an int32 seed is the key ``[0, seed]``
  (``seed >> 32`` is 0 for a 32-bit seed; the low word is the seed's
  two's-complement bits).
* ``split(key)`` hashes the 64-bit counters 0 and 1 (as hi/lo words) and
  stacks the two output words of each counter into one new key.
* ``random_bits(key, 32, shape)`` hashes the counters
  ``0 .. prod(shape) - 1`` and XORs the two output words.
* ``randint`` splits the key into ``k1, k2``, draws two words per value and
  folds them into ``[lo, hi)`` with jax's span / multiplier remainder
  combination, whose products wrap modulo 2**32.

Everything is batched over a leading ``[B]`` axis of keys and written as
int64 tensor arithmetic masked to 32 bits, so it runs on any device.  A
``randint`` hashes twice (the split, then both draws together), each hash
some 170 elementwise torch operations.
"""

from __future__ import annotations

from typing import Sequence, Union

import torch

_MASK = 0xFFFFFFFF
_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def PRNGKey(seed: Union[int, torch.Tensor],
            device: Union[str, torch.device, None] = None) -> torch.Tensor:
    """Raw threefry keys: ``[2]`` int64 words for a scalar seed, ``[B, 2]``
    for a ``[B]`` tensor of int32 seeds (each word holds 32 bits)."""
    seeds = torch.as_tensor(seed, device=device).to(torch.int64)
    lo = seeds & _MASK                      # two's-complement bits of int32
    return torch.stack([torch.zeros_like(lo), lo], dim=-1)


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _MASK


def threefry2x32(key: torch.Tensor, x0: torch.Tensor,
                 x1: torch.Tensor) -> tuple:
    """The Threefry-2x32 hash (20 rounds) of counter words ``(x0, x1)``
    under ``key [..., 2]``; ``key``'s leading axes broadcast against the
    counters' (pass keys as ``[B, 1, 2]`` for ``[B, n]`` counters)."""
    k0, k1 = key[..., 0], key[..., 1]
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & _MASK
    x1 = (x1 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _MASK
    return x0, x1


def split(keys: torch.Tensor) -> tuple:
    """``jax.random.split(key, 2)`` for a batch of keys ``[..., 2]``: both
    new keys come from one hash of the counters 0 and 1."""
    counts = torch.arange(2, dtype=torch.int64, device=keys.device)
    b1, b2 = threefry2x32(keys[..., None, :], torch.zeros_like(counts),
                          counts)
    pair = torch.stack([b1, b2], dim=-1)            # [..., 2 keys, 2 words]
    return pair[..., 0, :], pair[..., 1, :]


def random_bits(keys: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """32 random bits per element of ``shape`` for each key of
    ``keys [B, 2]`` → ``[B, *shape]`` int64 holding uint32 values."""
    shape = tuple(int(s) for s in shape)
    size = 1
    for s in shape:
        size *= s
    lo = torch.arange(size, dtype=torch.int64, device=keys.device)
    hi = torch.zeros_like(lo)
    b1, b2 = threefry2x32(keys[:, None, :], hi, lo)
    return (b1 ^ b2).reshape((keys.shape[0],) + shape)


def randint(keys: torch.Tensor, shape: Sequence[int], lo: int,
            hi: int) -> torch.Tensor:
    """``jax.random.randint(key, shape, lo, hi, dtype=int32)`` for each key
    of ``keys [B, 2]`` (or one key ``[2]``) → int32 ``[B, *shape]``
    (``[*shape]`` for one key)."""
    single = keys.dim() == 1
    if single:
        keys = keys[None]
    lo, hi = int(lo), int(hi)
    if not (-2**31 <= lo < 2**31 and -2**31 <= hi < 2**31):
        raise ValueError(f"randint bounds [{lo}, {hi}) exceed int32")
    k1, k2 = split(keys)
    # both draws in one hash: rows [0, B) are k1's, rows [B, 2B) k2's
    bits = random_bits(torch.cat([k1, k2]), shape)
    higher, lower = bits[:keys.shape[0]], bits[keys.shape[0]:]
    span = (hi - lo) & _MASK if hi > lo else 1
    multiplier = (2 ** 16) % span
    multiplier = ((multiplier * multiplier) & _MASK) % span
    offset = (((higher % span) * multiplier) & _MASK) + (lower % span)
    offset = (offset & _MASK) % span
    out = (offset + lo) & _MASK                      # wraps like int32 add
    out = (out - ((out >> 31) << 32)).to(torch.int32)
    return out[0] if single else out
