"""The ``flash_attention`` backward Hopper kernels: build, load and launch.

The kernels are CUDA C++ in ``csrc/flash_attention_bwd.cu`` (its header
says what they compute, what bounds them and how they are laid out): the
FlashAttention-2 backward, three launches a call (the row dot products
``D``, then dK and dV, then dQ; at HD 256 on the tensor cores a fourth
adds dK's and dV's partials over splits of the query heads), no atomics.
The type picks one of two bodies (``BODY``): bf16 on the tensor cores
(``wgmma``, tiles copied by TMA, a producer warpgroup and two consumer
warpgroups), fp32 on the CUDA cores.  This is a choice by shape: a failure
of either body raises.
``kernels._build`` compiles the source with ``nvcc`` at first use; this
module declares its C interface and launches it on PyTorch's current
stream.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels._build import KernelLibrary
from repro_torch.kernels._tensors import aligned

SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_attention_bwd.cu"
HEAD_DIMS = (32, 64, 128, 256)   # the head sizes the kernels are built for
# the body each (type, HD) takes, passed to the launch: "wgmma" (the tensor
# cores) or "cuda_cores"
BODY = {(dtype, hd): ("wgmma" if dtype == torch.bfloat16 else "cuda_cores")
        for dtype in (torch.float32, torch.bfloat16) for hd in HEAD_DIMS}
# CTAs of 64 keys that the tensor cores' dK/dV launch at HD 256 aims for:
# two an SM of 132, since a window leaves the last key blocks lighter
SPLIT_CTAS = 256


def dkdv_splits(kv_heads: int, skv: int, group: int) -> int:
    """Parts into which the tensor cores' HD-256 dK/dV splits each KV
    head's query heads: the fewest (a divisor of ``group``) that launch at
    least ``SPLIT_CTAS`` CTAs of 64 keys, else ``group``.  A function of the
    shape alone, so that two launches on the same inputs add the same
    partials in the same order."""
    ctas = kv_heads * -(-skv // 64)
    return next((d for d in range(1, group + 1)
                 if group % d == 0 and ctas * d >= SPLIT_CTAS), group)


def _declare(lib: ctypes.CDLL) -> None:
    lib.flash_attention_bwd_launch.argtypes = (
        [ctypes.c_void_p] * 11 + [ctypes.c_int64] * 5
        + [ctypes.c_int, ctypes.c_int, ctypes.c_int64, ctypes.c_int,
           ctypes.c_int, ctypes.c_void_p])
    lib.flash_attention_bwd_launch.restype = ctypes.c_int
    lib.flash_attention_bwd_scratch_floats.argtypes = [ctypes.c_int64] * 2
    lib.flash_attention_bwd_scratch_floats.restype = ctypes.c_int64
    lib.flash_attention_bwd_error_string.argtypes = [ctypes.c_int]
    lib.flash_attention_bwd_error_string.restype = ctypes.c_char_p


LIBRARY = KernelLibrary(SOURCE, _declare)
library = LIBRARY.load
build_info = LIBRARY.info


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        out: torch.Tensor, lse: torch.Tensor,
                        dout: torch.Tensor, *, causal: bool, window: int,
                        group: int):
    """Launch the kernels on CUDA tensors already checked by
    ``ops.flash_attention_bwd``: ``q, out, dout [BH, Sq, HD]``, ``k, v
    [BH / group, Skv, HD]`` of one type (fp32 or bf16), ``lse [BH, Sq]``
    fp32, under the forward's mask (``causal``, ``window``).  TMA reads
    bf16 tiles from addresses on 16 bytes, so a tensor that does not start
    on 16 bytes is copied first.  Returns ``(dq, dk,
    dv)`` in the inputs' type, allocated here (with the fp32 scratch the
    library asks for: the tensor-core body's ``lse · log2 e`` and ``D``,
    Sq padded to 128 rows; at HD 256 also dK's and dV's fp32 partials over
    ``dkdv_splits`` splits of the query heads), on PyTorch's current
    stream, without synchronising."""
    lib = library()
    q, k, v, out, dout = (aligned(t) for t in (q, k, v, out, dout))
    bh, sq, hd = q.shape
    skv = k.shape[1]
    body = BODY[(q.dtype, hd)]
    dq = torch.empty_like(q)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    scratch = torch.empty(lib.flash_attention_bwd_scratch_floats(bh, sq),
                          dtype=torch.float32, device=q.device)
    # the tensor cores at HD 256: dK's and dV's fp32 partials, one a split
    splits = (dkdv_splits(bh // group, skv, group)
              if body == "wgmma" and hd == 256 else 0)
    partials = (torch.empty((2, splits, bh // group, skv, hd),
                            dtype=torch.float32, device=q.device)
                if splits else None)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        code = lib.flash_attention_bwd_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), dout.data_ptr(), scratch.data_ptr(),
            None if partials is None else partials.data_ptr(),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), bh, sq, skv, hd,
            group, splits, int(causal), window,
            int(q.dtype == torch.bfloat16), int(body == "wgmma"), stream)
    if code != 0:
        raise RuntimeError(
            "flash_attention_bwd launch failed: "
            f"{lib.flash_attention_bwd_error_string(code).decode()} "
            f"(BH={bh}, Sq={sq}, Skv={skv}, HD={hd}, group={group}, "
            f"causal={causal}, window={window}, body {body}, splits "
            f"{splits})")
    if sq == 0:         # no query: the kernels leave dk and dv unwritten
        dk.zero_()
        dv.zero_()
    return dq, dk, dv
