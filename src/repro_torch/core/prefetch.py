"""Prefetch pipeline with dynamic look-ahead (thesis §1.1.4, §3.5).

While a task executes, data for the next ``k`` queued tasks is fetched in
the background; ``k`` is decided dynamically from the ratio of average
fetch time to average execution time (exactly the scheduler's
``queue_depth`` rule).  This is also the host-side input pipeline for LM
training: kneepoint-sized microbatch shards are prefetched ahead of the
device step (double/triple buffering).
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Any, Callable, Dict, Iterable, Iterator, Optional, Tuple

from repro_torch.spans import span


class PrefetchPipeline:
    """Wrap a producer iterator with a background prefetch thread whose
    buffer depth adapts to measured fetch/consume times."""

    def __init__(self, producer: Iterator[Any], *,
                 min_depth: int = 2, max_depth: int = 64):
        self._producer = producer
        self._min_depth = min_depth
        self._max_depth = max_depth
        self._buf: collections.deque = collections.deque()
        self._cv = threading.Condition()
        self._done = False
        self._fetch_ema: Optional[float] = None
        self._consume_ema: Optional[float] = None
        self._last_take: Optional[float] = None
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def depth(self) -> int:
        """k = ceil(fetch/exec) + 1, clamped (the paper's dynamic k)."""
        if not self._consume_ema or not self._fetch_ema:
            return self._min_depth
        k = int(self._fetch_ema / max(self._consume_ema, 1e-9)) + 1
        return max(self._min_depth, min(self._max_depth, k))

    def _run(self) -> None:
        try:
            for item in self._producer:
                t0 = time.perf_counter()
                with self._cv:
                    while len(self._buf) >= self.depth() and not self._done:
                        self._cv.wait(timeout=0.05)
                    if self._done:
                        return
                    self._buf.append(item)
                    self._cv.notify_all()
                took = time.perf_counter() - t0
                a = 0.3
                self._fetch_ema = (took if self._fetch_ema is None
                                   else (1 - a) * self._fetch_ema + a * took)
        finally:
            with self._cv:
                self._done = True
                self._cv.notify_all()

    def __iter__(self):
        return self

    def __next__(self):
        now = time.perf_counter()
        if self._last_take is not None:
            gap = now - self._last_take
            a = 0.3
            self._consume_ema = (gap if self._consume_ema is None
                                 else (1 - a) * self._consume_ema + a * gap)
        with span("pipeline.wait"), self._cv:
            while not self._buf and not self._done:
                self._cv.wait(timeout=0.05)
            if self._buf:
                item = self._buf.popleft()
                self._cv.notify_all()
                self._last_take = time.perf_counter()
                return item
        raise StopIteration

    def close(self) -> None:
        with self._cv:
            self._done = True
            self._cv.notify_all()


class TaskPrefetcher:
    """Dynamic-k ahead-fetch for *scheduler-driven* task queues (thesis
    §3.5 applied to the platform's data plane).

    :class:`PrefetchPipeline` wraps a linear iterator; the platform's
    execution order is decided claim-by-claim by the scheduler, so this
    variant prefetches whatever the scheduler says comes next: after
    claiming a wave, a worker hands the next ``lookahead()`` queued tasks
    to :meth:`prefetch` (their data-node fetches go in flight on a small
    background pool while the current wave executes) and calls
    :meth:`ensure` per claimed task (waits for an in-flight fetch, or
    fetches inline on a miss).  The look-ahead ``k`` adapts exactly like
    the scheduler's queue depth: ``k = ceil(fetch_ema / exec_ema) + 1``,
    clamped.

    Entries are (key, thunk) pairs so multi-tenant callers can namespace
    keys per job; the fetched value is discarded after :meth:`ensure`
    (the platform's fetch is a latency charge — compute reads blocks
    from host memory), so a prefetch is pure overlap, never a semantic
    change: results stay bit-identical with prefetching on or off.
    """

    def __init__(self, *, min_depth: int = 1, max_depth: int = 64,
                 workers: int = 4):
        from concurrent.futures import ThreadPoolExecutor

        self._min_depth = min_depth
        self._max_depth = max_depth
        self._pool = ThreadPoolExecutor(
            max_workers=workers, thread_name_prefix="task-prefetch")
        self._lock = threading.Lock()
        self._futures: Dict[Any, Any] = {}
        # keys already ensure()d: a peer may consume a task inline
        # before our peeked prefetch lands — launching it anyway would
        # be a duplicate fetch nobody waits for.  Entries are swept by
        # discard() (multi-tenant pools) and bounded by the job's task
        # count in one-shot runs.
        self._consumed: set = set()
        self._fetch_ema: Optional[float] = None
        self._exec_ema: Optional[float] = None
        self.hits = 0                      # ensure() found a prefetch
        self.misses = 0                    # ensure() fetched inline
        self.launched = 0                  # background fetches issued
        self.depth_trace: list = []
        self._closed = False
        # cache-aware skip (DESIGN.md §14): a predicate over prefetch
        # payloads (tasks) that is True when the task's blocks are
        # already resident in the worker-side block cache.  With cache-
        # aware ranking those tasks sort FIRST in the backlog, so the
        # peeked look-ahead would be exactly the tasks that need no
        # fetch — admit() filters them out instead of burning pipe
        # slots, and counts the skips.
        self.resident: Optional[Callable[[Any], bool]] = None
        self._resident_skips = 0

    # -- dynamic k -----------------------------------------------------------
    def lookahead(self) -> int:
        """k = ceil(fetch/exec) + 1, clamped — enough fetches in flight
        to cover data latency (the paper's dynamic prefetch window)."""
        if not self._exec_ema or not self._fetch_ema:
            return self._min_depth
        k = int(self._fetch_ema / max(self._exec_ema, 1e-9)) + 1
        return max(self._min_depth, min(self._max_depth, k))

    def observe_exec(self, seconds: float) -> None:
        a = 0.3
        self._exec_ema = (seconds if self._exec_ema is None
                          else (1 - a) * self._exec_ema + a * seconds)

    def _observe_fetch(self, seconds: float) -> None:
        a = 0.3
        with self._lock:
            self._fetch_ema = (seconds if self._fetch_ema is None
                               else (1 - a) * self._fetch_ema + a * seconds)

    def _timed(self, thunk: Callable[[], Any]) -> Any:
        t0 = time.perf_counter()
        value = thunk()
        self._observe_fetch(time.perf_counter() - t0)
        return value

    # -- cache-aware admission -----------------------------------------------
    def admit(self, payload: Any) -> bool:
        """Whether a peeked task is worth a background fetch: ``False``
        when the :attr:`resident` predicate says its blocks are already
        cache-resident (the claim-time :meth:`ensure` will be served
        worker-side for free).  Predicate errors admit — prefetching an
        already-resident task is waste, never a correctness problem."""
        pred = self.resident
        if pred is None:
            return True
        try:
            is_resident = bool(pred(payload))
        except Exception:          # noqa: BLE001 — best-effort hint
            return True
        if is_resident:
            with self._lock:
                self._resident_skips += 1
            return False
        return True

    def note_resident_skip(self) -> None:
        """Count a resident skip decided by the caller (the multi-job
        pool filters with per-job predicates instead of one global
        :attr:`resident`)."""
        with self._lock:
            self._resident_skips += 1

    # -- the pipeline --------------------------------------------------------
    def prefetch(self, entries: Iterable[Tuple[Any, Callable[[], Any]]],
                 ) -> int:
        """Launch background fetches for up to ``lookahead()`` not-yet-
        in-flight entries; returns how many were launched."""
        launched = 0
        budget = self.lookahead()
        with self._lock:
            if self._closed:
                return 0
            self.depth_trace.append(budget)
            for key, thunk in entries:
                if launched >= budget:
                    break
                if key in self._futures or key in self._consumed:
                    continue
                self._futures[key] = self._pool.submit(self._timed, thunk)
                launched += 1
            self.launched += launched
        return launched

    def ensure(self, key: Any, thunk: Callable[[], Any]) -> Any:
        """The fetch barrier before executing a task: wait for the
        in-flight prefetch of ``key``, or fetch inline on a miss.  The
        future is consumed — a later re-ensure (speculative clone)
        refetches."""
        with self._lock:
            future = self._futures.pop(key, None)
            self._consumed.add(key)
        if future is not None:
            self.hits += 1
            return future.result()
        self.misses += 1
        return self._timed(thunk)

    def discard(self, match: Callable[[Any], bool]) -> int:
        """Drop (and cancel, where still possible) in-flight prefetches
        whose key satisfies ``match`` — a multi-tenant pool must evict a
        cancelled job's entries, or keys that will never be ensure()d
        accumulate for the life of the service."""
        with self._lock:
            keys = [k for k in self._futures if match(k)]
            futures = [self._futures.pop(k) for k in keys]
            self._consumed = {k for k in self._consumed if not match(k)}
        for f in futures:
            f.cancel()
        return len(keys)

    def stats(self) -> Dict[str, float]:
        return {"prefetch_hits": float(self.hits),
                "prefetch_misses": float(self.misses),
                "prefetch_launched": float(self.launched),
                "prefetch_depth": float(self.depth_trace[-1]
                                        if self.depth_trace else 0),
                "resident_skips": float(self._resident_skips)}

    def close(self) -> None:
        with self._lock:
            self._closed = True
            futures = list(self._futures.values())
            self._futures.clear()
        for f in futures:
            f.cancel()
        self._pool.shutdown(wait=False)
