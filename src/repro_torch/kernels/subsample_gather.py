"""The ``subsample_stats`` Hopper kernel: build, load and launch.

The kernel itself is CUDA C++ in ``csrc/subsample_stats.cu`` (its header
says what it replaces, what bounds it and how it is laid out).  This
module compiles it with ``nvcc`` for ``sm_90a`` into a shared library with
a plain C interface, at first use, into ``build/kernels/`` at the root of
the checkout, keyed by a hash of the source and the flags; it loads the
library with ``ctypes`` and launches on PyTorch's current stream.

Nothing here runs at import: the CPU tests import this module on machines
with no ``nvcc`` and no card.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Optional

import torch

SOURCE = Path(__file__).resolve().parent / "csrc" / "subsample_stats.cu"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
MAX_ROWS_PER_STEP = 256          # kStage in the source

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
build_info = {"seconds": None, "log": "", "path": None}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    if found is None and os.path.exists(os.path.join(home, "bin", "nvcc")):
        found = os.path.join(home, "bin", "nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found: the subsample_stats CUDA kernel is built from "
            f"{SOURCE} at first use and needs the CUDA toolkit (sm_90a)")
    return found


def library() -> ctypes.CDLL:
    """Build (once per source hash) and load the kernel library."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        digest = hashlib.sha256(
            SOURCE.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()
        path = BUILD_DIR / f"subsample_stats_{digest[:16]}.so"
        if not path.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = path.with_name(f"{path.stem}.{os.getpid()}.tmp.so")
            t0 = time.perf_counter()
            proc = subprocess.run(
                [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)],
                capture_output=True, text=True)
            build_info["seconds"] = time.perf_counter() - t0
            build_info["log"] = proc.stdout + proc.stderr
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed on {SOURCE} (exit {proc.returncode}):\n"
                    f"{build_info['log']}")
            os.replace(tmp, path)
        lib = ctypes.CDLL(str(path))
        lib.subsample_stats_launch.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        lib.subsample_stats_launch.restype = ctypes.c_int
        lib.subsample_stats_error_string.argtypes = [ctypes.c_int]
        lib.subsample_stats_error_string.restype = ctypes.c_char_p
        build_info["path"] = str(path)
        _lib = lib
        return lib


def subsample_stats_wave(data: torch.Tensor, indices: torch.Tensor, *,
                         rows_per_step: int = 8) -> torch.Tensor:
    """Launch the kernel on CUDA tensors ``data [B, N, D]`` fp32 and
    ``indices [B, T]`` int32 (already checked by ``ops.subsample_stats``);
    returns ``stats [B, 2, D]`` fp32 allocated here, on PyTorch's current
    stream, without synchronising."""
    lib = library()
    bsz, n, d = data.shape
    t = indices.shape[1]
    stats = torch.empty((bsz, 2, d), dtype=torch.float32, device=data.device)
    vec = 4 if d % 4 == 0 and data.data_ptr() % 16 == 0 else 1
    stream = torch.cuda.current_stream(data.device).cuda_stream
    with torch.cuda.device(data.device):
        code = lib.subsample_stats_launch(
            data.data_ptr(), indices.data_ptr(), stats.data_ptr(),
            bsz, n, d, t, int(rows_per_step), vec, stream)
    if code != 0:
        raise RuntimeError(
            "subsample_stats launch failed: "
            f"{lib.subsample_stats_error_string(code).decode()} "
            f"(B={bsz}, N={n}, D={d}, T={t}, rows_per_step={rows_per_step})")
    return stats
