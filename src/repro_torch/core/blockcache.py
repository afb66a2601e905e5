"""Bounded worker-side block cache for the replicated data plane
(DESIGN.md §14).

The thesis schedules tiny tasks "based on the availability and response
times of the data nodes", but every fetch still round-trips to a data
node even when the worker pool just held the same blocks — repeat and
overlapping subsample queries re-fetch bytes the pool already has.  This
module is the standard map-reduce fix (worker/pool block caching, cf.
arXiv:2310.14951) applied between the schedulers and
:class:`~repro_torch.core.datastore.ReplicatedDataStore`:

* **byte-budgeted capacity** — ``CacheOptions.capacity_bytes`` bounds
  resident bytes; ``0`` disables the cache entirely (every path is then
  bit-identical to the pre-cache platform);
* **LRU / LFU eviction** — ``policy="lru"`` evicts the least recently
  *hit* entry, ``policy="lfu"`` the least frequently *accessed* one
  (ties broken by recency, so LFU degrades to LRU among cold entries);
* **frequency-based admission** — ``admission="frequency"`` only admits
  a block over eviction when its access frequency beats every victim it
  would displace (a TinyLFU-style filter: one burst of cold scans
  cannot flush a hot working set); ``"always"`` admits unconditionally;
* **per-entry versioning** — the datastore bumps a sample's version on
  re-placement, so a stale cached block can never serve a fetch (the
  mismatch drops the entry and counts as a miss).

The cache itself is transport-agnostic and emits no telemetry; the
owning datastore emits ``cache_hit``/``cache_miss``/``cache_evict``
events on the platform :class:`~repro_torch.platform.telemetry.TelemetryBus`.
``on_change`` fires (outside the lock) on admission, eviction and
invalidation — residency transitions only, never plain hits — which the
drivers wire to the schedulers' ``request_rerank()`` so cache locality
re-ranks ready tasks exactly like a data-node state change does.
"""

from __future__ import annotations

import dataclasses
import threading
from collections import OrderedDict
from typing import Callable, Dict, Iterable, List, Optional

# access-frequency aging: after this many recorded accesses every
# counter is halved (and zeros dropped), so the admission filter tracks
# the *current* working set instead of all history
_FREQ_AGE_WINDOW = 4096


@dataclasses.dataclass(frozen=True)
class CacheOptions:
    """Worker-side block cache policy (``PlatformSpec(cache=...)``).

    ``capacity_bytes=0`` (the default) disables the cache — the
    platform behaves bit-identically to a build without one."""

    capacity_bytes: int = 0            # 0 ⇒ disabled
    policy: str = "lru"                # "lru" | "lfu" eviction order
    admission: str = "frequency"       # "frequency" | "always"

    def __post_init__(self) -> None:
        if self.capacity_bytes < 0:
            raise ValueError(
                f"capacity_bytes must be >= 0, got {self.capacity_bytes}")
        if self.policy not in ("lru", "lfu"):
            raise ValueError(f"unknown cache policy {self.policy!r}; "
                             "choose 'lru' or 'lfu'")
        if self.admission not in ("frequency", "always"):
            raise ValueError(
                f"unknown admission policy {self.admission!r}; "
                "choose 'frequency' or 'always'")

    @property
    def enabled(self) -> bool:
        return self.capacity_bytes > 0


class _Entry:
    __slots__ = ("version", "data", "nbytes")

    def __init__(self, version: int, data) -> None:
        self.version = version
        self.data = data
        self.nbytes = int(getattr(data, "nbytes", 0))


class BlockCache:
    """Thread-safe bounded block cache keyed by sample id.

    ``get``/``put`` maintain the hit/miss/eviction counters; ``peek``/
    ``contains`` are side-effect-free (the schedulers' locality scoring
    polls residency every rank and must not distort the admission
    frequencies the way real fetch traffic does)."""

    def __init__(self, options: CacheOptions = CacheOptions(), *,
                 on_change: Optional[Callable[[], None]] = None):
        self.options = options
        # residency-transition callback (admission/eviction/invalidation,
        # never hits) — the drivers point this at request_rerank()
        self.on_change = on_change
        self._lock = threading.Lock()
        # insertion/recency order: leftmost = coldest (LRU victim)
        self._entries: "OrderedDict[int, _Entry]" = OrderedDict()
        self._bytes = 0
        # access frequencies for resident AND ghost keys — the admission
        # filter must know how hot a block was *before* it was resident
        self._freq: Dict[int, int] = {}
        self._accesses = 0
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.invalidations = 0
        self.rejections = 0                # admission filter refusals

    # -- accounting helpers (caller holds the lock) --------------------------
    def _touch_locked(self, sid: int) -> None:
        self._freq[sid] = self._freq.get(sid, 0) + 1
        self._accesses += 1
        if self._accesses >= _FREQ_AGE_WINDOW:
            self._accesses = 0
            self._freq = {k: v // 2 for k, v in self._freq.items()
                          if v // 2 > 0}

    def _drop_locked(self, sid: int) -> None:
        entry = self._entries.pop(sid, None)
        if entry is not None:
            self._bytes -= entry.nbytes

    # -- the fetch-path surface ----------------------------------------------
    def get(self, sid: int, version: int):
        """The cached block for ``(sid, version)`` or ``None``.  A
        version mismatch is a *stale* entry: it is dropped (counted as
        an invalidation) and the access is a miss."""
        changed = False
        with self._lock:
            if not self.options.enabled:
                return None
            self._touch_locked(sid)
            entry = self._entries.get(sid)
            if entry is not None and entry.version != version:
                self._drop_locked(sid)
                self.invalidations += 1
                entry = None
                changed = True
            if entry is None:
                self.misses += 1
                data = None
            else:
                self.hits += 1
                self._entries.move_to_end(sid)
                data = entry.data
        if changed:
            self._fire()
        return data

    def put(self, sid: int, version: int, data) -> List[int]:
        """Offer a fetched block; returns the sample ids evicted to make
        room (empty when admitted without eviction, or not admitted at
        all).  Admission under ``"frequency"`` requires the candidate's
        access frequency to strictly beat every victim's — a cold scan
        cannot displace a hot working set."""
        nbytes = int(getattr(data, "nbytes", 0))
        cap = self.options.capacity_bytes
        evicted: List[int] = []
        admitted = False
        with self._lock:
            if not self.options.enabled or nbytes > cap:
                if self.options.enabled:
                    self.rejections += 1
                return []
            old = self._entries.get(sid)
            if old is not None:
                # refresh in place (version bump or same bytes re-fetched)
                self._bytes += nbytes - old.nbytes
                old.version, old.data, old.nbytes = version, data, nbytes
                self._entries.move_to_end(sid)
                admitted = True
            else:
                victims = self._plan_eviction_locked(sid, nbytes)
                if victims is None:
                    self.rejections += 1
                else:
                    for vid in victims:
                        self._drop_locked(vid)
                        self.evictions += 1
                    evicted = victims
                    self._entries[sid] = _Entry(version, data)
                    self._bytes += nbytes
                    admitted = True
            # overweight refresh tail: a grown entry may now exceed cap
            while self._bytes > cap and self._entries:
                vid = self._victim_locked(exclude=sid)
                if vid is None:
                    break
                self._drop_locked(vid)
                self.evictions += 1
                evicted.append(vid)
        if admitted or evicted:
            self._fire()
        return evicted

    def _victim_locked(self, exclude: Optional[int] = None) -> Optional[int]:
        """Next eviction victim under the configured policy: the coldest
        entry (LRU order) or the least-frequently-accessed one (LFU,
        ties broken by LRU order)."""
        if self.options.policy == "lru":
            for sid in self._entries:
                if sid != exclude:
                    return sid
            return None
        best, best_freq = None, None
        for sid in self._entries:             # iteration order = recency
            if sid == exclude:
                continue
            f = self._freq.get(sid, 0)
            if best_freq is None or f < best_freq:
                best, best_freq = sid, f
        return best

    def _plan_eviction_locked(self, cand: int,
                              need_bytes: int) -> Optional[List[int]]:
        """The victim set that frees room for ``need_bytes`` more, or
        ``None`` when the admission filter refuses the trade.  Planned
        against a snapshot — nothing is dropped unless admission passes.

        Admission math (``admission="frequency"``): the candidate is
        admitted iff ``freq(cand) > freq(v)`` for EVERY victim ``v`` it
        would displace.  With the aging window this is TinyLFU's filter
        generalized to multi-victim evictions — a once-scanned block
        (freq 1) can never displace a block hit twice, so a linear scan
        leaves a hot working set resident."""
        free = self.options.capacity_bytes - self._bytes
        if free >= need_bytes:
            return []
        cand_freq = self._freq.get(cand, 0)
        victims: List[int] = []
        taken: set = set()
        while free < need_bytes:
            if self.options.policy == "lru":
                vid = next((s for s in self._entries if s not in taken),
                           None)
            else:
                vid, best = None, None
                for s in self._entries:
                    if s in taken:
                        continue
                    f = self._freq.get(s, 0)
                    if best is None or f < best:
                        vid, best = s, f
            if vid is None:
                return None                   # nothing left to evict
            if (self.options.admission == "frequency"
                    and cand_freq <= self._freq.get(vid, 0)):
                return None                   # victim is at least as hot
            victims.append(vid)
            taken.add(vid)
            free += self._entries[vid].nbytes
        return victims

    # -- side-effect-free residency probes -----------------------------------
    def contains(self, sid: int, version: int) -> bool:
        """Residency probe with NO counter/recency side effects — the
        locality scorer polls this per rank."""
        with self._lock:
            entry = self._entries.get(sid)
            return entry is not None and entry.version == version

    def peek(self, sid: int, version: int):
        """Like :meth:`get` but without touching any accounting."""
        with self._lock:
            entry = self._entries.get(sid)
            if entry is not None and entry.version == version:
                return entry.data
            return None

    # -- invalidation --------------------------------------------------------
    def invalidate(self, sids: Iterable[int]) -> List[int]:
        """Drop entries for re-placed samples; returns the ids that were
        resident."""
        dropped: List[int] = []
        with self._lock:
            for sid in sids:
                if sid in self._entries:
                    self._drop_locked(sid)
                    self.invalidations += 1
                    dropped.append(sid)
        if dropped:
            self._fire()
        return dropped

    def clear(self) -> None:
        with self._lock:
            n = len(self._entries)
            self._entries.clear()
            self._bytes = 0
            self.invalidations += n
        if n:
            self._fire()

    # -- observability -------------------------------------------------------
    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    @property
    def bytes_used(self) -> int:
        with self._lock:
            return self._bytes

    def stats(self) -> Dict[str, float]:
        with self._lock:
            accesses = self.hits + self.misses
            return {
                "entries": float(len(self._entries)),
                "bytes": float(self._bytes),
                "capacity_bytes": float(self.options.capacity_bytes),
                "hits": float(self.hits),
                "misses": float(self.misses),
                "evictions": float(self.evictions),
                "invalidations": float(self.invalidations),
                "rejections": float(self.rejections),
                "hit_rate": (self.hits / accesses) if accesses else 0.0,
            }

    def _fire(self) -> None:
        cb = self.on_change
        if cb is not None:
            try:
                cb()
            except Exception:      # rerank hints are best-effort
                pass
