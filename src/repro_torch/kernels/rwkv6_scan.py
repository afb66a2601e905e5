"""The ``rwkv6_chunked`` Hopper kernel: build, load and launch.

The kernel itself is CUDA C++ in ``csrc/rwkv6_scan.cu`` (its header says
what it replaces, what bounds it and how it is laid out).
``kernels._build`` compiles it with ``nvcc`` at first use; this module
declares its C interface and launches it on PyTorch's current stream.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels._build import KernelLibrary

SOURCE = Path(__file__).resolve().parent / "csrc" / "rwkv6_scan.cu"
MAX_CHUNK = 64                   # kMaxChunk in the source
HEAD_DIMS = (32, 64)             # the head sizes the kernel is built for


def _declare(lib: ctypes.CDLL) -> None:
    lib.rwkv6_chunked_launch.argtypes = (
        [ctypes.c_void_p] * 8 + [ctypes.c_int64] * 5
        + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    lib.rwkv6_chunked_launch.restype = ctypes.c_int
    lib.rwkv6_chunked_error_string.argtypes = [ctypes.c_int]
    lib.rwkv6_chunked_error_string.restype = ctypes.c_char_p


LIBRARY = KernelLibrary(SOURCE, _declare)
library = LIBRARY.load
build_info = LIBRARY.info


def rwkv6_chunked(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  logw: torch.Tensor, u: torch.Tensor, state: torch.Tensor,
                  chunk: int):
    """Launch the kernel on CUDA tensors already checked by
    ``ops.rwkv6_chunked``: ``r, k, v, logw [B, H, S, hd]``, ``u [H, hd]``,
    ``state [B, H, hd, hd]`` fp32, ``S`` a multiple of ``chunk``.  Returns
    ``(out [B, H, S, hd] fp32, state_out [B, H, hd, hd] fp32)`` allocated
    here, on PyTorch's current stream, without synchronising."""
    lib = library()
    b, h, s, hd = r.shape
    out = torch.empty((b, h, s, hd), dtype=torch.float32, device=r.device)
    state_out = torch.empty_like(state)
    stream = torch.cuda.current_stream(r.device).cuda_stream
    with torch.cuda.device(r.device):
        code = lib.rwkv6_chunked_launch(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), logw.data_ptr(),
            u.data_ptr(), state.data_ptr(), out.data_ptr(),
            state_out.data_ptr(), b, h, s, hd, chunk,
            int(r.dtype == torch.bfloat16), int(logw.dtype == torch.bfloat16),
            stream)
    if code != 0:
        raise RuntimeError(
            "rwkv6_chunked launch failed: "
            f"{lib.rwkv6_chunked_error_string(code).decode()} "
            f"(B={b}, H={h}, S={s}, hd={hd}, chunk={chunk})")
    return out, state_out
