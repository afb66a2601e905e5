"""The ``rwkv6_chunked`` backward Hopper kernel: build, load and launch.

The kernel is CUDA C++ in ``csrc/rwkv6_scan_bwd.cu`` (its header says
what it computes, what bounds it and how it is laid out): three passes an
op call, the reverse state pass (the gradient leaving every chunk, on the
tensor cores, a head's rows of dS split over CTAs to fill the card), the
chunk pass (every chunk's dr, dk, dv, dlogw and partial du at once, its
products on the tensor cores) and the sum of du over the batch and the
chunks.  Inputs that do not start on 16 bytes are copied first (the
kernel stages them by ``cp.async``).  ``kernels._build`` compiles
it with ``nvcc`` at first use; this module declares its C interface,
allocates the gradients and the scratch, and launches it on PyTorch's
current stream.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels._build import KernelLibrary
from repro_torch.kernels._tensors import aligned

SOURCE = Path(__file__).resolve().parent / "csrc" / "rwkv6_scan_bwd.cu"


def _declare(lib: ctypes.CDLL) -> None:
    lib.rwkv6_chunked_bwd_launch.argtypes = (
        [ctypes.c_void_p] * 18 + [ctypes.c_int64] * 5
        + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    lib.rwkv6_chunked_bwd_launch.restype = ctypes.c_int
    lib.rwkv6_chunked_bwd_error_string.argtypes = [ctypes.c_int]
    lib.rwkv6_chunked_bwd_error_string.restype = ctypes.c_char_p


LIBRARY = KernelLibrary(SOURCE, _declare)
library = LIBRARY.load
build_info = LIBRARY.info


def rwkv6_chunked_bwd(r, k, v, logw, u, state0, states, state_out, dout,
                      dstate_out, chunk: int):
    """Launch the three passes on CUDA tensors already checked by
    ``ops.rwkv6_chunked_bwd``.  Returns ``(dr, dk, dv, dlogw, du,
    dstate0)`` allocated here (dr, dk, dv, du in r's type, dlogw in
    logw's, dstate0 fp32; with the fp32 scratch: the gradient leaving
    every chunk, ``[B, H, S / chunk, hd, hd]``, and du's partial sums a
    chunk, ``[B, H, S / chunk, hd]``), on PyTorch's current stream,
    without synchronising."""
    lib = library()
    r, k, v, logw, state0, states, state_out, dout, dstate_out = (
        aligned(t) for t in (r, k, v, logw, state0, states, state_out, dout,
                             dstate_out))
    b, h, s, hd = r.shape
    n = s // chunk
    dr, dk, dv, dlogw = (torch.empty_like(t) for t in (r, k, v, logw))
    du = torch.empty_like(u)
    dstate0 = torch.empty_like(state0)
    dstates = torch.empty((b, h, n, hd, hd), dtype=torch.float32,
                          device=r.device)
    du_part = torch.empty((b, h, n, hd), dtype=torch.float32,
                          device=r.device)
    stream = torch.cuda.current_stream(r.device).cuda_stream
    with torch.cuda.device(r.device):
        code = lib.rwkv6_chunked_bwd_launch(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), logw.data_ptr(),
            u.data_ptr(), state0.data_ptr(), states.data_ptr(),
            state_out.data_ptr(), dout.data_ptr(), dstate_out.data_ptr(),
            dr.data_ptr(), dk.data_ptr(), dv.data_ptr(), dlogw.data_ptr(),
            du.data_ptr(), dstate0.data_ptr(), dstates.data_ptr(),
            du_part.data_ptr(), b, h, s, hd, chunk,
            int(r.dtype == torch.bfloat16), int(logw.dtype == torch.bfloat16),
            stream)
    if code != 0:
        raise RuntimeError(
            "rwkv6_chunked_bwd launch failed: "
            f"{lib.rwkv6_chunked_bwd_error_string(code).decode()} "
            f"(B={b}, H={h}, S={s}, hd={hd}, chunk={chunk})")
    return dr, dk, dv, dlogw, du, dstate0
