"""The ``rglru_scan`` Hopper kernel: build, load and launch.

The kernel itself is CUDA C++ in ``csrc/rglru_scan.cu`` (its header says
what it replaces, what bounds it and how it is laid out): two forms over
one body, the read form (``a`` and ``b`` given) and the gated form (``a``
and ``b`` formed in the kernel from the block's input ``u`` and the gate
vectors).  ``kernels._build`` compiles it with ``nvcc`` at first use; this
module declares its C interface and launches it on PyTorch's current
stream.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels._build import KernelLibrary

SOURCE = Path(__file__).resolve().parent / "csrc" / "rglru_scan.cu"


def _declare(lib: ctypes.CDLL) -> None:
    lib.rglru_scan_launch.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.c_int64] * 3 + [ctypes.c_void_p])
    lib.rglru_scan_launch.restype = ctypes.c_int
    lib.rglru_gated_scan_launch.argtypes = (
        [ctypes.c_void_p] * 8 + [ctypes.c_int64] * 3
        + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    lib.rglru_gated_scan_launch.restype = ctypes.c_int
    lib.rglru_scan_error_string.argtypes = [ctypes.c_int]
    lib.rglru_scan_error_string.restype = ctypes.c_char_p


LIBRARY = KernelLibrary(SOURCE, _declare)
library = LIBRARY.load
build_info = LIBRARY.info


def rglru_scan(a: torch.Tensor, b: torch.Tensor,
               h0: torch.Tensor) -> torch.Tensor:
    """Launch the kernel on CUDA tensors already checked by
    ``ops.rglru_scan``: ``a, b [B, S, W]`` and ``h0 [B, W]``, all fp32.
    Returns ``out [B, S, W]`` fp32 allocated here, on PyTorch's current
    stream, without synchronising."""
    lib = library()
    bsz, s, w = a.shape
    out = torch.empty((bsz, s, w), dtype=torch.float32, device=a.device)
    stream = torch.cuda.current_stream(a.device).cuda_stream
    with torch.cuda.device(a.device):
        code = lib.rglru_scan_launch(a.data_ptr(), b.data_ptr(),
                                     h0.data_ptr(), out.data_ptr(), bsz, s,
                                     w, stream)
    if code != 0:
        raise RuntimeError(
            f"rglru_scan launch failed: "
            f"{lib.rglru_scan_error_string(code).decode()} "
            f"(B={bsz}, S={s}, W={w})")
    return out


def rglru_gated_scan(u: torch.Tensor, gate_a_w: torch.Tensor,
                     gate_a_b: torch.Tensor, gate_x_w: torch.Tensor,
                     gate_x_b: torch.Tensor, softplus_lam: torch.Tensor,
                     h0: torch.Tensor) -> torch.Tensor:
    """Launch the gated form on CUDA tensors already checked by
    ``ops.rglru_gated_scan``: ``u [B, S, W]`` fp32 or bf16, the four gate
    vectors ``[W]`` in one type (fp32 or bf16), ``softplus_lam [W]`` and
    ``h0 [B, W]`` fp32.  Returns ``out [B, S, W]`` fp32 allocated here, on
    PyTorch's current stream, without synchronising."""
    lib = library()
    bsz, s, w = u.shape
    out = torch.empty((bsz, s, w), dtype=torch.float32, device=u.device)
    stream = torch.cuda.current_stream(u.device).cuda_stream
    with torch.cuda.device(u.device):
        code = lib.rglru_gated_scan_launch(
            u.data_ptr(), gate_a_w.data_ptr(), gate_a_b.data_ptr(),
            gate_x_w.data_ptr(), gate_x_b.data_ptr(), softplus_lam.data_ptr(),
            h0.data_ptr(), out.data_ptr(), bsz, s, w,
            int(u.dtype == torch.bfloat16),
            int(gate_a_w.dtype == torch.bfloat16), stream)
    if code != 0:
        raise RuntimeError(
            f"rglru_gated_scan launch failed: "
            f"{lib.rglru_scan_error_string(code).decode()} "
            f"(B={bsz}, S={s}, W={w}, u {u.dtype}, gates "
            f"{gate_a_w.dtype})")
    return out
