"""The ``flash_attention`` Hopper kernel: build, load and launch.

The kernel itself is CUDA C++ in ``csrc/flash_attention.cu`` (its header
says what it replaces, what bounds it and how it is laid out): bf16 inputs
run on the tensor cores (``wgmma``, tiles copied by TMA), fp32 inputs on
the CUDA cores.
``kernels._build`` compiles it with ``nvcc`` at first use; this module
declares its C interface and launches it on PyTorch's current stream.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels._build import KernelLibrary
from repro_torch.kernels._tensors import aligned

SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"
HEAD_DIMS = (32, 64, 128, 256)   # the head sizes the kernel is built for


def _declare(lib: ctypes.CDLL) -> None:
    lib.flash_attention_launch.argtypes = (
        [ctypes.c_void_p] * 5 + [ctypes.c_int64] * 5
        + [ctypes.c_int, ctypes.c_int64, ctypes.c_int, ctypes.c_void_p])
    lib.flash_attention_launch.restype = ctypes.c_int
    lib.flash_attention_error_string.argtypes = [ctypes.c_int]
    lib.flash_attention_error_string.restype = ctypes.c_char_p


LIBRARY = KernelLibrary(SOURCE, _declare)
library = LIBRARY.load
build_info = LIBRARY.info


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool, window: int, group: int,
                    with_lse: bool = False):
    """Launch the kernel on CUDA tensors already checked by
    ``ops.flash_attention``: ``q [BH, Sq, HD]``, ``k, v [BH / group, Skv,
    HD]``, one type (fp32 or bf16).  TMA reads bf16 tiles from addresses
    on 16 bytes, so a tensor that does not start on 16 bytes is copied
    first.  Returns ``out [BH, Sq, HD]`` in q's type, allocated here, on
    PyTorch's current stream, without synchronising; with ``with_lse``,
    ``(out, lse)``, ``lse [BH, Sq]`` fp32 each row's log-sum-exp of its
    scaled scores (−inf for a row that sees no key), which training's
    backward reads."""
    lib = library()
    q, k, v = (aligned(t) for t in (q, k, v))
    bh, sq, hd = q.shape
    skv = k.shape[1]
    out = torch.empty_like(q)
    lse = (torch.empty((bh, sq), dtype=torch.float32, device=q.device)
           if with_lse else None)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        code = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr(), bh, sq, skv, hd, group,
            int(causal), window, int(q.dtype == torch.bfloat16), stream)
    if code != 0:
        raise RuntimeError(
            "flash_attention launch failed: "
            f"{lib.flash_attention_error_string(code).decode()} "
            f"(BH={bh}, Sq={sq}, Skv={skv}, HD={hd}, group={group}, "
            f"causal={causal}, window={window})")
    if lse is None:
        return out
    if skv == 0:        # the bf16 body writes zeros and no lse then
        lse.fill_(float("-inf"))
    return out, lse
