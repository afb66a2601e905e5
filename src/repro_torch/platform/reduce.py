"""Async streaming reduce tree (thesis §3.1 reduce stage, §3.5 overlap).

The thesis overlaps data movement with task execution; the same idea
applies to the reduce stage: per-task partials are combined *while the map
phase is still running*, on a background combiner thread fed by a queue, so
workers never block on aggregation (the reduce analogue of the prefetch
pipeline's fetch/execute overlap).  At job end only the last few tree
levels remain, so reduce latency is O(log n) combines past the final map.

Determinism: partials are leaves of a **fixed binary tree keyed by task
id** — node ``(level, i)`` always combines children ``(level-1, 2i)`` and
``(level-1, 2i+1)`` in that order, whatever order results arrive in.  Both
platform backends therefore produce bit-identical job statistics for the
same seed (threads and virtual time cannot reorder float additions).
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Any, Callable, Dict, List, Optional


def tree_add(a: Dict[str, Any], b: Dict[str, Any]) -> Dict[str, Any]:
    """Default combine: element-wise sum of dict-of-array partials."""
    return {k: a[k] + b[k] for k in a}


class StreamingReduceTree:
    """Combine ``n_leaves`` partials into one, streaming and deterministic.

    ``offer(leaf, partial)`` may be called from any thread (map workers,
    the simulator's calibration pass); combining happens on a dedicated
    thread.  ``result()`` closes the stream and returns the root.

    ``estimator`` — when given — is a
    :class:`~repro_torch.core.estimator.SubsampleEstimator` fed each leaf
    by :meth:`offer` itself, on the producer's thread, before the leaf is
    queued; :meth:`estimate` then surfaces the running online-aggregation
    snapshot (value + CI + tasks_in) without disturbing the bit-identical
    full-reduce path (DESIGN.md §10).  A stopping check made after an
    ``offer`` returns therefore sees that leaf however far the combiner
    lags (the reference observes on the combiner thread, so its ε stop
    follows the combiner's timing).
    """

    def __init__(self, n_leaves: int,
                 combine: Callable[[Any, Any], Any] = tree_add,
                 estimator: Optional[Any] = None):
        assert n_leaves >= 1
        self.n_leaves = n_leaves
        self._combine = combine
        self._estimator = estimator
        # level sizes: n, ceil(n/2), ... 1
        self._sizes: List[int] = [n_leaves]
        while self._sizes[-1] > 1:
            self._sizes.append((self._sizes[-1] + 1) // 2)
        self._nodes: List[List[Optional[Any]]] = [
            [None] * s for s in self._sizes]
        self._queue: "queue.SimpleQueue" = queue.SimpleQueue()
        self.combines = 0
        self.leaves_seen = 0               # streamed-progress counter
        self.idle_wait_seconds = 0.0       # combiner starved (map-bound)
        self.max_backlog = 0               # combiner behind (reduce-bound)
        self._error: Optional[BaseException] = None
        self._node_lock = threading.Lock()   # snapshot() vs combiner
        self._leaf_cond = threading.Condition()  # wait_leaves() wakeups
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    # -- producer side -------------------------------------------------------
    def offer(self, leaf: int, partial: Any) -> None:
        if self._estimator is not None:
            # idempotent for a speculative duplicate (clones are
            # bit-identical by seed), so no dedup is needed here
            self._estimator.observe(leaf, partial)
        self._queue.put((leaf, partial))

    # -- combiner thread -----------------------------------------------------
    def _run(self) -> None:
        seen: set = set()
        try:
            while len(seen) < self.n_leaves:
                t0 = time.perf_counter()
                item = self._queue.get()
                self.idle_wait_seconds += time.perf_counter() - t0
                if item is None:               # closed early (error path)
                    return
                self.max_backlog = max(self.max_backlog, self._queue.qsize())
                leaf, partial = item
                if leaf in seen:               # speculative re-execution dup
                    continue
                seen.add(leaf)
                with self._node_lock:
                    self._insert(0, leaf, partial)
                    self.leaves_seen = len(seen)
                with self._leaf_cond:
                    self._leaf_cond.notify_all()
        except BaseException as e:             # noqa: BLE001
            # a combine raised: park the error so result() re-raises it
            # on the caller's thread instead of hanging forever
            self._error = e
        finally:
            # wake wait_leaves() callers on ANY exit (error, early close,
            # normal completion) so they time out against live state
            # instead of sleeping through a dead combiner
            with self._leaf_cond:
                self._leaf_cond.notify_all()

    def _insert(self, level: int, idx: int, value: Any) -> None:
        """Place a completed node and bubble combines up the fixed tree."""
        while level + 1 < len(self._sizes):
            sibling = idx ^ 1
            if sibling >= self._sizes[level]:
                # dangling node at an odd level edge: promote unchanged
                level, idx = level + 1, idx // 2
                continue
            other = self._nodes[level][sibling]
            if other is None:
                self._nodes[level][idx] = value
                return
            self._nodes[level][sibling] = None
            left, right = (other, value) if sibling < idx else (value, other)
            value = self._combine(left, right)
            self.combines += 1
            level, idx = level + 1, idx // 2
        self._nodes[-1][0] = value

    # -- consumer side -------------------------------------------------------
    def result(self, timeout: Optional[float] = None) -> Any:
        """Block until every offered leaf is combined; return the root.
        A combine exception propagates here (the combiner thread parks
        it); a missing leaf raises :class:`TimeoutError` after ``timeout``
        rather than deadlocking the caller."""
        self._thread.join(timeout)
        if self._error is not None:
            raise self._error
        if self._thread.is_alive():
            raise TimeoutError(
                f"reduce tree incomplete after {timeout}s "
                f"(backlog={self._queue.qsize()})")
        root = self._nodes[-1][0]
        assert root is not None, "result() before all leaves were offered"
        return root

    def snapshot(self) -> Optional[Any]:
        """Early partial estimate: combine whatever nodes are resident
        *right now*, without consuming them.  Deterministic for a given
        set of arrived leaves (nodes combine in fixed (level, index)
        order) but — unlike :meth:`result` — dependent on arrival timing;
        service callers stream it as a progress estimate while the final
        answer still comes from the fixed tree.  ``None`` until at least
        one leaf has been combined in."""
        with self._node_lock:
            resident = [node for level in self._nodes for node in level
                        if node is not None]
            if not resident:
                return None
            acc = resident[0]
            for node in resident[1:]:
                acc = self._combine(acc, node)
            return acc

    def estimate(self):
        """Online-aggregation snapshot from the attached estimator — an
        :class:`~repro_torch.core.estimator.EstimateSnapshot` (value, ci_low,
        ci_high, tasks_in) or ``None`` (no estimator attached, or no
        usable leaf yet).  Unlike :meth:`snapshot`, this is deterministic
        for a given set of arrived leaves by construction (the estimator
        reduces in sorted-task-id order)."""
        if self._estimator is None:
            return None
        return self._estimator.estimate()

    def wait_leaves(self, n: int, timeout: Optional[float] = None) -> None:
        """Block until at least ``n`` distinct leaves have been combined
        in (the DRAINING path: an early-stopped job knows exactly how
        many tasks executed and finalizes from :meth:`snapshot` once they
        all landed).  Raises the combiner's parked error, or
        :class:`TimeoutError` if the stream dies or stalls."""
        deadline = (None if timeout is None
                    else time.monotonic() + timeout)
        with self._leaf_cond:
            while self.leaves_seen < n:
                if self._error is not None:
                    raise self._error
                if not self._thread.is_alive():
                    raise TimeoutError(
                        f"reduce stream closed at {self.leaves_seen}/"
                        f"{n} awaited leaves")
                wait = (None if deadline is None
                        else deadline - time.monotonic())
                if wait is not None and wait <= 0:
                    raise TimeoutError(
                        f"only {self.leaves_seen}/{n} leaves after "
                        f"{timeout}s")
                self._leaf_cond.wait(0.05 if wait is None
                                     else min(wait, 0.05))
        if self._error is not None:
            raise self._error

    @classmethod
    def combine_subset(cls, n_leaves: int, items: Dict[int, Any],
                       combine: Callable[[Any, Any], Any] = tree_add,
                       timeout: float = 60.0) -> Optional[Any]:
        """Deterministically combine a *subset* of a job's leaves in the
        same fixed (level, index) order the live tree uses — the final
        reduce of an early-terminated job.  Result depends only on the
        set of leaf ids, not on dict order: the fixed tree guarantees
        that for any arrival order, and offering in sorted-task-id order
        makes it manifest when the items were produced by MANY shards
        (the sharded wave path) whose dict-insertion order is a race."""
        tree = cls(n_leaves, combine)
        try:
            for leaf, partial in sorted(items.items()):
                tree.offer(leaf, partial)
            if items:
                tree.wait_leaves(len(items), timeout=timeout)
            return tree.snapshot()
        finally:
            tree.close()

    def close(self) -> None:
        """Abort the combiner (error/cancellation paths only)."""
        self._queue.put(None)

    def stats(self) -> Dict[str, float]:
        return {"combines": float(self.combines),
                "idle_wait_seconds": self.idle_wait_seconds,
                "max_backlog": float(self.max_backlog)}


def finalize_stats(root: Dict[str, Any], statistic: str) -> Dict[str, Any]:
    """Turn the root partial into the job result (mirrors
    ``subsample.reduce_stats`` for the paper workloads, plus the kernel's
    ``moments`` statistic)."""
    import numpy as np

    if statistic == "alod":
        curve = np.asarray(root["sum_curve"]) / np.maximum(
            np.asarray(root["hits"]), 1.0)
        return {"alod": curve, "n": float(root["count"])}
    if statistic == "monthly_mean":
        mean = np.asarray(root["sum"]) / np.maximum(
            np.asarray(root["count"]), 1.0)
        return {"monthly_mean": mean, "count": np.asarray(root["count"])}
    if statistic == "moments":
        n = float(root["count"])
        mean = np.asarray(root["sum"]) / max(n, 1.0)
        var = np.asarray(root["sumsq"]) / max(n, 1.0) - mean * mean
        return {"mean": mean, "var": np.maximum(var, 0.0), "count": n}
    # custom map_fn partials pass through untouched
    return dict(root)
