"""The ``attention_decode_int8`` Hopper kernel: build, load and launch.

The kernel itself is CUDA C++ in ``csrc/attention_decode_int8.cu`` (its
header says why it was added, what bounds it and how it is laid out): one
decode step's attention over an int8 KV cache, the new token quantized and
written in the same launch.  ``kernels._build`` compiles it with ``nvcc``
at first use; this module declares its C interface, picks the split of the
cache over CTAs and launches it on PyTorch's current stream.
"""

from __future__ import annotations

import ctypes
import math
from pathlib import Path

import torch

from repro_torch.kernels._build import KernelLibrary
from repro_torch.kernels._tensors import aligned

SOURCE = Path(__file__).resolve().parent / "csrc" / "attention_decode_int8.cu"
HEAD_DIM = 128     # the head size the kernel is built for, in bf16
MAX_CHUNK = 256    # the most cache slots one CTA reads


def _declare(lib: ctypes.CDLL) -> None:
    lib.attention_decode_int8_launch.argtypes = (
        [ctypes.c_void_p] * 11 + [ctypes.c_int64] * 8
        + [ctypes.c_float, ctypes.c_void_p])
    lib.attention_decode_int8_launch.restype = ctypes.c_int
    lib.attention_decode_int8_error_string.argtypes = [ctypes.c_int]
    lib.attention_decode_int8_error_string.restype = ctypes.c_char_p


LIBRARY = KernelLibrary(SOURCE, _declare)
library = LIBRARY.load
build_info = LIBRARY.info

_tickets: dict = {}    # (device index, stream) -> int32 zeros


def check_supported(q: torch.Tensor) -> None:
    """Raise unless the kernel is built for ``q``'s head size and type:
    HD 128 in bf16, deepseek-7b's decode, the one model that keeps an int8
    cache."""
    if q.shape[-1] != HEAD_DIM:
        raise ValueError(f"the CUDA kernel takes HD {HEAD_DIM}, got "
                         f"{q.shape[-1]}")
    if q.dtype != torch.bfloat16:
        raise TypeError(f"the CUDA kernel takes bf16, got {q.dtype}")


def group_chunk(g: int) -> int:
    """The query heads one CTA takes (the kernel's ``group_chunk``)."""
    return 1 if g <= 1 else 2 if g <= 2 else 4 if g <= 4 else 8


def plan_chunk(ctas_per_split: int, n_valid: int, sms: int) -> int:
    """The slots a CTA reads: ``MAX_CHUNK``, halved (down to 32) while the
    launch would give the card's ``sms`` fewer than two CTAs each."""
    chunk = MAX_CHUNK
    while chunk > 32 and ctas_per_split * math.ceil(n_valid / chunk) < 2 * sms:
        chunk //= 2
    return chunk


def _ticket_buffer(device: torch.device, stream: int,
                   n: int) -> torch.Tensor:
    """A zeroed int32 buffer of at least ``n`` tickets for launches on
    ``stream``.  The kernel leaves every ticket at 0 when it ends, so one
    buffer serves every later launch on that stream."""
    key = (device.index, stream)
    buf = _tickets.get(key)
    if buf is None or buf.numel() < n:
        buf = torch.zeros(n, dtype=torch.int32, device=device)
        _tickets[key] = buf
    return buf


def attention_decode_int8(q: torch.Tensor, k_new: torch.Tensor,
                          v_new: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor, k_scale: torch.Tensor,
                          v_scale: torch.Tensor, *, write_at: int,
                          n_valid: int, chunk: int = 0) -> torch.Tensor:
    """Launch the kernel on CUDA tensors already checked by
    ``ops.attention_decode_int8``: ``q [B, 1, KV, G, HD]``, ``k_new,
    v_new [B, 1, KV, HD]`` bf16 with HD 128, the cache ``k, v [B,
    S, KV, HD]`` int8 and ``k_scale, v_scale [B, S, KV, 1]`` fp32.  Writes
    the new token's values and scales into the cache at ``write_at`` (in
    place) and attends over slots ``[0, n_valid)``.  Returns ``out [B, KV,
    G, HD]`` bf16, allocated here, on PyTorch's current stream,
    without synchronising.  ``chunk`` (at most ``MAX_CHUNK``) overrides
    the slots a CTA reads."""
    lib = library()
    q, k_new, v_new = (aligned(t) for t in (q, k_new, v_new))
    b, _, kv, g, hd = q.shape
    s = k.shape[1]
    dev = q.device
    gchunks = math.ceil(g / group_chunk(g))
    chunk = chunk or plan_chunk(
        b * kv * gchunks, n_valid,
        torch.cuda.get_device_properties(dev).multi_processor_count)
    nsplit = math.ceil(n_valid / chunk)
    out = torch.empty((b, kv, g, hd), dtype=q.dtype, device=dev)
    parts = b * kv * g * nsplit if nsplit > 1 else 0   # one split: none
    part_acc = torch.empty(parts * hd, dtype=torch.float32, device=dev)
    part_ml = torch.empty(parts * 2, dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    tickets = _ticket_buffer(dev, stream, b * kv * gchunks)
    with torch.cuda.device(dev):
        code = lib.attention_decode_int8_launch(
            q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(), k.data_ptr(),
            v.data_ptr(), k_scale.data_ptr(), v_scale.data_ptr(),
            out.data_ptr(), part_acc.data_ptr(), part_ml.data_ptr(),
            tickets.data_ptr(), b, s, kv, g, hd, write_at, n_valid, chunk,
            1.0 / math.sqrt(hd), stream)
    if code != 0:
        raise RuntimeError(
            "attention_decode_int8 launch failed: "
            f"{lib.attention_decode_int8_error_string(code).decode()} "
            f"(B={b}, S={s}, KV={kv}, G={g}, HD={hd}, write_at={write_at}, "
            f"n_valid={n_valid}, chunk={chunk})")
    return out
