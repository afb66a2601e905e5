"""The ``rglru_scan`` backward Hopper kernel: build, load and launch.

The kernel is CUDA C++ in ``csrc/rglru_scan_bwd.cu`` (its header says
what it computes, what bounds it, how it is laid out and in what order it
sums): one pipelined body a CTA serves both forms of the forward.  A load
warp fills a shared-memory ring with ``dh`` and ``h_{t-1}`` by
``cp.async`` from the last chunk back, a walk warp runs the reverse scan
``g_t = dh_t + a_{t+1} g_{t+1}`` one sequential chain a channel, and math
warps, a chunk behind, turn ``g`` into the gradients: in the read form
``da`` and ``db``; in the gated form they first form the gates from ``u``
once an element (``a`` for the walk, the rest kept in each thread's own
shared memory for the chain rule), then ``du`` and the gate vectors' sums
into partials that a second launch adds over B in order.
``kernels._build`` compiles the source with ``nvcc`` at first use; this
module declares its C interface and launches it on PyTorch's current
stream.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels._build import KernelLibrary

SOURCE = Path(__file__).resolve().parent / "csrc" / "rglru_scan_bwd.cu"
N_PARTIALS = 5                   # dw_a, db_a, dw_x, db_x, dsoftplus_lam


def _declare(lib: ctypes.CDLL) -> None:
    lib.rglru_scan_bwd_launch.argtypes = (
        [ctypes.c_void_p] * 7 + [ctypes.c_int64] * 3 + [ctypes.c_void_p])
    lib.rglru_scan_bwd_launch.restype = ctypes.c_int
    lib.rglru_gated_scan_bwd_launch.argtypes = (
        [ctypes.c_void_p] * 17 + [ctypes.c_int64] * 3
        + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    lib.rglru_gated_scan_bwd_launch.restype = ctypes.c_int
    lib.rglru_scan_bwd_error_string.argtypes = [ctypes.c_int]
    lib.rglru_scan_bwd_error_string.restype = ctypes.c_char_p


LIBRARY = KernelLibrary(SOURCE, _declare)
library = LIBRARY.load
build_info = LIBRARY.info


def _raise(lib, code: int, what: str) -> None:
    if code != 0:
        raise RuntimeError(f"{what} launch failed: "
                           f"{lib.rglru_scan_bwd_error_string(code).decode()}")


def rglru_scan_bwd(a: torch.Tensor, h: torch.Tensor, h0: torch.Tensor,
                   dh: torch.Tensor):
    """The read form on CUDA tensors already checked by
    ``ops.rglru_scan_bwd``: ``a, h, dh [B, S, W]`` and ``h0 [B, W]``, all
    fp32.  Returns ``(da, db, dh0)`` fp32 allocated here, on PyTorch's
    current stream, without synchronising."""
    lib = library()
    bsz, s, w = a.shape
    da, db = torch.empty_like(a), torch.empty_like(a)
    dh0 = torch.empty_like(h0)
    stream = torch.cuda.current_stream(a.device).cuda_stream
    with torch.cuda.device(a.device):
        code = lib.rglru_scan_bwd_launch(
            a.data_ptr(), h.data_ptr(), h0.data_ptr(), dh.data_ptr(),
            da.data_ptr(), db.data_ptr(), dh0.data_ptr(), bsz, s, w, stream)
    _raise(lib, code, f"rglru_scan_bwd (B={bsz}, S={s}, W={w})")
    return da, db, dh0


def rglru_gated_scan_bwd(u, gate_a_w, gate_a_b, gate_x_w, gate_x_b,
                         softplus_lam, h0, h, dh):
    """The gated form on CUDA tensors already checked by
    ``ops.rglru_gated_scan_bwd``: ``u [B, S, W]`` fp32 or bf16, the four
    gate vectors ``[W]`` in one type, ``softplus_lam [W]``, ``h0 [B, W]``,
    ``h, dh [B, S, W]`` fp32.  Returns ``(du, dgate_a_w, dgate_a_b,
    dgate_x_w, dgate_x_b, dsoftplus_lam, dh0)`` allocated here (with the
    fp32 partials ``[B, 5, W]``), on PyTorch's current stream, without
    synchronising."""
    lib = library()
    bsz, s, w = u.shape
    du = torch.empty_like(u)
    dgates = [torch.empty_like(t)
              for t in (gate_a_w, gate_a_b, gate_x_w, gate_x_b)]
    dsp = torch.empty_like(softplus_lam)
    dh0 = torch.empty_like(h0)
    partials = torch.empty((bsz, N_PARTIALS, w), dtype=torch.float32,
                           device=u.device)
    stream = torch.cuda.current_stream(u.device).cuda_stream
    with torch.cuda.device(u.device):
        code = lib.rglru_gated_scan_bwd_launch(
            u.data_ptr(), gate_a_w.data_ptr(), gate_a_b.data_ptr(),
            gate_x_w.data_ptr(), gate_x_b.data_ptr(), softplus_lam.data_ptr(),
            h0.data_ptr(), h.data_ptr(), dh.data_ptr(), du.data_ptr(),
            *(t.data_ptr() for t in dgates), dsp.data_ptr(), dh0.data_ptr(),
            partials.data_ptr(), bsz, s, w, int(u.dtype == torch.bfloat16),
            int(gate_a_w.dtype == torch.bfloat16), stream)
    _raise(lib, code, f"rglru_gated_scan_bwd (B={bsz}, S={s}, W={w}, u "
                      f"{u.dtype}, gates {gate_a_w.dtype})")
    return (du, *dgates, dsp, dh0)
