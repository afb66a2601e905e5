"""The ``rwkv6_chunked`` Hopper kernel: build, load and launch.

The kernel itself is CUDA C++ in ``csrc/rwkv6_scan.cu`` (its header says
what it replaces, what bounds it and how it is laid out): two passes in
one op call, the state pass (the states entering every chunk, and the
final state) and the output pass (every chunk at once, from the state
entering it).  ``kernels._build`` compiles it with ``nvcc`` at first use;
this module declares its C interface, allocates the outputs and the
scratch states, and launches both passes on PyTorch's current stream.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels._build import KernelLibrary
from repro_torch.kernels._tensors import aligned

SOURCE = Path(__file__).resolve().parent / "csrc" / "rwkv6_scan.cu"
MAX_CHUNK = 64                   # kMaxChunk in the source
HEAD_DIMS = (32, 64)             # the head sizes the kernel is built for
STATE_PASS, OUT_PASS = 1, 2      # the ``passes`` bits of the C launcher
BOTH_PASSES = STATE_PASS | OUT_PASS


def _declare(lib: ctypes.CDLL) -> None:
    lib.rwkv6_chunked_launch.argtypes = (
        [ctypes.c_void_p] * 9 + [ctypes.c_int64] * 5
        + [ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    lib.rwkv6_chunked_launch.restype = ctypes.c_int
    lib.rwkv6_chunked_error_string.argtypes = [ctypes.c_int]
    lib.rwkv6_chunked_error_string.restype = ctypes.c_char_p


LIBRARY = KernelLibrary(SOURCE, _declare)
library = LIBRARY.load
build_info = LIBRARY.info


def scratch_states(r: torch.Tensor, chunk: int) -> torch.Tensor:
    """The scratch the state pass fills and the output pass reads: the
    state entering every chunk but the first, ``[B, H, S / chunk − 1, hd,
    hd]`` fp32 (67 MB at ``[4, 64, 1024, 64]`` in chunks of 64)."""
    b, h, s, hd = r.shape
    return torch.empty((b, h, s // chunk - 1, hd, hd), dtype=torch.float32,
                       device=r.device)


def launch(r, k, v, logw, u, state, chunk: int, out: torch.Tensor,
           state_out: torch.Tensor, states: torch.Tensor,
           passes: int = BOTH_PASSES) -> None:
    """Launch ``passes`` of the kernel into ``out``, ``state_out`` and the
    scratch ``states`` (:func:`scratch_states`), all allocated by the
    caller, on PyTorch's current stream, without synchronising.  The output
    pass alone reads the states a state pass left in ``states``."""
    lib = library()
    b, h, s, hd = r.shape
    r, k, v, logw, state = (aligned(t) for t in (r, k, v, logw, state))
    stream = torch.cuda.current_stream(r.device).cuda_stream
    with torch.cuda.device(r.device):
        code = lib.rwkv6_chunked_launch(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), logw.data_ptr(),
            u.data_ptr(), state.data_ptr(), out.data_ptr(),
            state_out.data_ptr(), states.data_ptr(), b, h, s, hd, chunk,
            int(r.dtype == torch.bfloat16), int(logw.dtype == torch.bfloat16),
            passes, stream)
    if code != 0:
        raise RuntimeError(
            "rwkv6_chunked launch failed: "
            f"{lib.rwkv6_chunked_error_string(code).decode()} "
            f"(B={b}, H={h}, S={s}, hd={hd}, chunk={chunk})")


def rwkv6_chunked(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  logw: torch.Tensor, u: torch.Tensor, state: torch.Tensor,
                  chunk: int, *, with_states: bool = False):
    """Launch both passes on CUDA tensors already checked by
    ``ops.rwkv6_chunked``: ``r, k, v, logw [B, H, S, hd]``, ``u [H, hd]``,
    ``state [B, H, hd, hd]`` fp32, ``S`` a multiple of ``chunk``.  Returns
    ``(out [B, H, S, hd] fp32, state_out [B, H, hd, hd] fp32)`` allocated
    here, on PyTorch's current stream, without synchronising; with
    ``with_states`` also the scratch states the state pass wrote (the
    backward's input)."""
    out = torch.empty(r.shape, dtype=torch.float32, device=r.device)
    state_out = torch.empty(state.shape, dtype=torch.float32,
                            device=r.device)
    states = scratch_states(r, chunk)
    launch(r, k, v, logw, u, state, chunk, out, state_out, states)
    return (out, state_out, states) if with_states else (out, state_out)
