"""Job-level checkpoint/restart (thesis §3.3 applied to training jobs).

Design points for 1000+-node deployments:

* **atomic**: state is written to ``step_XXXX.tmp`` then renamed — a crash
  mid-write never corrupts the restore point;
* **async**: saves run on a background thread (device→host copy happens on
  the caller, serialization off the critical path);
* **retention**: keep the newest ``keep`` checkpoints;
* **job-level**: there is no per-step monitoring/ack protocol — a failed
  job restarts from ``restore_latest()``, exactly the paper's recovery
  model (the f_w cost model says per-task/step monitoring doesn't pay at
  interactive scale).

Arrays are stored as flattened ``.npz`` with a JSON treedef; in a
multi-host deployment each process saves its addressable shards under
``proc_{i}`` (single-process here, path kept).

The format is the JAX package's, so either package restores the other's
checkpoints: ``proc_0.npz`` holds leaf ``i`` as ``a{i}``; ``meta.json``
holds ``step``, ``names`` (JAX key paths: ``['w']`` for a dict key,
``[0]`` for a list index, concatenated), ``dtypes`` and ``treedef``.
Leaves go in JAX's flatten order (``repro_torch.tree``).  bfloat16, which
numpy lacks, is stored as its raw ``uint16`` bits under the dtype
``"bfloat16"`` and restored as a ``torch.bfloat16`` tensor.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.tree import AttrKey, tree_leaves_with_path, tree_map

BF16 = "bfloat16"


def _keystr(path: Tuple) -> str:
    """JAX's ``keystr`` of a path: ``[repr(key)]`` a dict key, ``[i]`` a
    list index, ``.name`` a named tuple's field."""
    return "".join(f".{k.name}" if isinstance(k, AttrKey) else f"[{k!r}]"
                   for k in path)


def _treedef_str(tree: Any) -> str:
    """The structure of ``tree`` as JAX prints a ``PyTreeDef``; written to
    ``meta.json`` for a reader's eyes, never read back."""

    def walk(t):
        if t is None:
            return "None"
        if isinstance(t, dict):
            return "{" + ", ".join(f"{k!r}: {walk(t[k])}"
                                   for k in sorted(t)) + "}"
        if isinstance(t, list):
            return "[" + ", ".join(walk(x) for x in t) + "]"
        if isinstance(t, tuple):
            inner = ", ".join(walk(x) for x in t)
            return f"({inner},)" if len(t) == 1 else f"({inner})"
        return "*"

    return f"PyTreeDef({walk(tree)})"


def _to_host(leaf: Any) -> Any:
    """A leaf as numpy on the host; a bf16 tensor stays a CPU tensor (numpy
    has no bfloat16)."""
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach().cpu()
        return leaf.clone() if leaf.dtype == torch.bfloat16 else leaf.numpy()
    return np.asarray(leaf)


def _encode(leaf: Any) -> Tuple[np.ndarray, str]:
    """The array written for a host leaf and its ``dtypes`` entry."""
    if isinstance(leaf, torch.Tensor):                 # bf16 only
        return leaf.view(torch.int16).numpy().view(np.uint16), BF16
    return leaf, leaf.dtype.name


def _decode(arr: np.ndarray, dtype: str) -> Any:
    if dtype == BF16:
        bits = np.ascontiguousarray(arr).view(np.int16)
        return torch.from_numpy(bits).view(torch.bfloat16)
    return arr


def _flatten_with_names(tree) -> List:
    return [(_keystr(path), leaf)
            for path, leaf in tree_leaves_with_path(tree)]


class CheckpointManager:
    def __init__(self, directory: str, *, keep: int = 3,
                 process_index: int = 0):
        self.directory = directory
        self.keep = keep
        self.process_index = process_index
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        # background-save failures park here (under _err_lock) and are
        # re-raised on the NEXT save()/wait() — never silently dropped
        self._error: Optional[BaseException] = None
        self._err_lock = threading.Lock()
        # save() and wait() from several threads (a job's workers each
        # offer leaves) take turns: a wait must never see a save's thread
        # before it has started
        self._turn = threading.RLock()

    # -- save ------------------------------------------------------------------
    def save(self, step: int, state: Any, *, blocking: bool = False) -> None:
        with self._turn:
            self._save(step, state)
        if blocking:
            self.wait()

    def _save(self, step: int, state: Any) -> None:
        self.wait()
        # device→host copy on the caller so the state snapshot is consistent
        host_state = tree_map(_to_host, state)
        treedef = _treedef_str(state)

        def write():
            try:
                name = f"step_{step:08d}"
                tmp = os.path.join(self.directory, name + ".tmp")
                final = os.path.join(self.directory, name)
                os.makedirs(tmp, exist_ok=True)
                leaves = _flatten_with_names(host_state)
                arrays, dtypes = {}, []
                for i, (_, leaf) in enumerate(leaves):
                    arrays[f"a{i}"], dtype = _encode(leaf)
                    dtypes.append(dtype)
                with open(os.path.join(
                        tmp, f"proc_{self.process_index}.npz"), "wb") as f:
                    np.savez(f, **arrays)
                    f.flush()
                    os.fsync(f.fileno())
                meta = {
                    "step": step,
                    "treedef": treedef,
                    "names": [n for n, _ in leaves],
                    "dtypes": dtypes,
                    "time": time.time(),
                }
                with open(os.path.join(tmp, "meta.json"), "w") as f:
                    json.dump(meta, f)
                    f.flush()
                    os.fsync(f.fileno())
                if os.path.exists(final):
                    shutil.rmtree(final)
                os.rename(tmp, final)                  # atomic commit
                # fsync the parent directory so the rename itself is
                # durable — without it a crash can leave the directory
                # entry unwritten and the "atomic" claim is hollow
                dfd = os.open(self.directory, os.O_RDONLY)
                try:
                    os.fsync(dfd)
                finally:
                    os.close(dfd)
                self._gc()
            except BaseException as e:                 # noqa: BLE001
                with self._err_lock:
                    self._error = e

        thread = threading.Thread(target=write, daemon=True)
        thread.start()
        self._thread = thread

    def wait(self) -> None:
        """Join any in-flight background save and re-raise its parked
        error (also raised by the next :meth:`save`, which waits first —
        a failed async save is surfaced on the following call, never
        silently dropped)."""
        with self._turn:
            thread = self._thread
            if thread is not None:
                thread.join()
                self._thread = None
            with self._err_lock:
                err, self._error = self._error, None
        if err is not None:
            raise err

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:08d}"),
                          ignore_errors=True)

    # -- restore ---------------------------------------------------------------
    def all_steps(self) -> List[int]:
        out = []
        for name in os.listdir(self.directory):
            if name.startswith("step_") and not name.endswith(".tmp"):
                try:
                    out.append(int(name[5:]))
                except ValueError:
                    pass
        return sorted(out)

    def restore(self, step: int, example: Any = None) -> Any:
        """Restore a tree.  If ``example`` (a tree of like-structured
        values) is given, leaves adopt its structure, dtypes and, for
        tensors, devices; otherwise a flat dict name→array is returned
        (numpy arrays, bf16 leaves as ``torch.bfloat16`` tensors)."""
        path = os.path.join(self.directory, f"step_{step:08d}")
        with open(os.path.join(path, "meta.json")) as f:
            meta = json.load(f)
        data = np.load(os.path.join(path,
                                    f"proc_{self.process_index}.npz"))
        dtypes = meta.get("dtypes", ["float32"] * len(meta["names"]))
        arrays = [_decode(data[f"a{i}"], dtypes[i])
                  for i in range(len(meta["names"]))]
        if example is None:
            return dict(zip(meta["names"], arrays))
        leaves = [leaf for _, leaf in tree_leaves_with_path(example)]
        assert len(leaves) == len(arrays), "checkpoint/structure mismatch"
        it = iter(arrays)

        def cast(like):
            a = next(it)
            if isinstance(like, torch.Tensor):
                t = a if isinstance(a, torch.Tensor) else torch.from_numpy(
                    np.array(a))
                return t.to(device=like.device, dtype=like.dtype)
            if isinstance(a, torch.Tensor):
                a = a.float().numpy()
            return np.asarray(a).astype(like.dtype) if hasattr(
                like, "dtype") else np.asarray(a)

        return tree_map(cast, example)

    def restore_latest(self, example: Any = None) -> Optional[Any]:
        steps = self.all_steps()
        if not steps:
            return None
        return self.restore(steps[-1], example)
