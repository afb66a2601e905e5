"""Build and load the port's hand-written CUDA kernels.

Each kernel is one CUDA C++ source under ``csrc/`` with a plain C
interface.  At first use it is compiled by ``nvcc`` for ``sm_90a`` into a
shared library in ``build/kernels/`` at the root of the checkout, keyed
by a hash of the source, the local headers it includes and the flags, and
loaded with ``ctypes``.  The compiler's log (ptxas' registers and spills)
is kept beside the library and read back when a later process loads it; a
library without its log is built again.

Nothing here runs at import: the CPU tests import the kernel modules on
machines with no ``nvcc`` and no card.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Callable, Optional

BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


_LOCAL_INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)


def build_key(source: Path) -> str:
    """Hash of ``source``, of every header it includes with ``#include
    "..."`` (found beside the including file, followed transitively), and
    of the nvcc flags: a library built from other bytes is never reused."""
    digest = hashlib.sha256()
    seen, todo = set(), [source.resolve()]
    while todo:
        path = todo.pop(0)
        if path in seen or not path.is_file():
            continue
        seen.add(path)
        text = path.read_bytes()
        digest.update(path.name.encode() + b"\0" + text)
        todo += [(path.parent / name).resolve() for name in
                 _LOCAL_INCLUDE.findall(text.decode(errors="replace"))]
    digest.update(" ".join(NVCC_FLAGS).encode())
    return digest.hexdigest()


def _nvcc(source: Path) -> str:
    found = shutil.which("nvcc")
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    if found is None and os.path.exists(os.path.join(home, "bin", "nvcc")):
        found = os.path.join(home, "bin", "nvcc")
    if found is None:
        raise RuntimeError(
            f"nvcc not found: the CUDA kernel in {source} is built at first "
            "use and needs the CUDA toolkit (sm_90a)")
    return found


class KernelLibrary:
    """One kernel source, built once per source hash and loaded once per
    process.  ``declare`` sets ``argtypes`` / ``restype`` on the loaded
    library.  ``info`` holds the build's seconds (None when the library was
    already built), the compiler's log (with ptxas' registers, shared memory
    and spills; read back from beside the library when it was already
    built) and the library's path."""

    def __init__(self, source: Path, declare: Callable[[ctypes.CDLL], None]):
        self.source = source
        self._declare = declare
        self._lock = threading.Lock()
        self._lib: Optional[ctypes.CDLL] = None
        self.info = {"seconds": None, "log": "", "path": None}

    def load(self) -> ctypes.CDLL:
        with self._lock:
            if self._lib is not None:
                return self._lib
            path = (BUILD_DIR
                    / f"{self.source.stem}_{build_key(self.source)[:16]}.so")
            log = path.with_suffix(".log")
            if path.exists() and log.exists():
                self.info["log"] = log.read_text()
            else:
                BUILD_DIR.mkdir(parents=True, exist_ok=True)
                tmp = path.with_name(f"{path.stem}.{os.getpid()}.tmp.so")
                t0 = time.perf_counter()
                proc = subprocess.run(
                    [_nvcc(self.source), *NVCC_FLAGS, "-o", str(tmp),
                     str(self.source)], capture_output=True, text=True)
                self.info["seconds"] = time.perf_counter() - t0
                self.info["log"] = proc.stdout + proc.stderr
                if proc.returncode != 0:
                    raise RuntimeError(
                        f"nvcc failed on {self.source} (exit "
                        f"{proc.returncode}):\n{self.info['log']}")
                tmp_log = tmp.with_suffix(".log")
                tmp_log.write_text(self.info["log"])
                os.replace(tmp_log, log)
                os.replace(tmp, path)
            lib = ctypes.CDLL(str(path))
            self._declare(lib)
            self.info["path"] = str(path)
            self._lib = lib
            return lib
