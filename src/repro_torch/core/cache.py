"""Hydration cache: the 'warm instance' mechanism.

Paper §2: a cold Lambda instance pays a one-time cost to populate its
in-memory cache from S3; warm instances serve with zero store traffic —
"Lambda execution incurs no performance penalty in steady state."

``HydrationCache`` holds *hydrated assets* (packed index arrays, model
weights, embedding tables) keyed by (asset_name, version). Values are
arbitrary objects — tensors on the card, numpy arrays, searchers. Eviction
is LRU by accounted bytes, which is how a 2GB-Lambda memory ceiling is
modeled.
"""

from __future__ import annotations

import dataclasses
import threading
from collections import OrderedDict
from typing import Any, Callable


def _leaves(tree: Any):
    """The leaves ``jax.tree_util.tree_leaves`` yields for the same object:
    lists, tuples and dicts are flattened, ``None`` is an empty node, and
    anything else — a tensor, an array, a ``Searcher`` — is one leaf."""
    if tree is None:
        return
    if isinstance(tree, (list, tuple)):
        for x in tree:
            yield from _leaves(x)
    elif isinstance(tree, dict):
        for key in sorted(tree):
            yield from _leaves(tree[key])
    else:
        yield tree


def pytree_nbytes(tree: Any) -> int:
    """Accounted bytes of a cached asset, the JAX package's number for the
    same object. A leaf without ``nbytes`` counts 0 — so an eager
    ``Searcher`` (one opaque leaf) is accounted as 0 bytes, exactly as the
    reference accounts it."""
    total = 0
    for leaf in _leaves(tree):
        if hasattr(leaf, "nbytes"):
            total += int(leaf.nbytes)
        elif isinstance(leaf, (bytes, bytearray)):
            total += len(leaf)
    return total


@dataclasses.dataclass
class CacheStats:
    hits: int = 0
    misses: int = 0
    evictions: int = 0
    hydrate_seconds: float = 0.0   # simulated time spent hydrating (cold starts)
    backfill_seconds: float = 0.0  # partial → full upgrades, off the critical path

    @property
    def cold_fraction(self) -> float:
        n = self.hits + self.misses
        return self.misses / n if n else 0.0


class HydrationCache:
    """LRU cache of hydrated assets with a byte budget (the instance's RAM)."""

    def __init__(self, capacity_bytes: int) -> None:
        self.capacity_bytes = int(capacity_bytes)
        self._entries: "OrderedDict[tuple[str, str], tuple[Any, int]]" = OrderedDict()
        self._bytes = 0
        self._lock = threading.RLock()
        self.stats = CacheStats()

    def get_or_hydrate(
        self,
        name: str,
        version: str,
        hydrate: Callable[[], tuple[Any, float]],
    ) -> Any:
        """Return the cached asset, or call ``hydrate() -> (asset, sim_s)``.

        ``sim_s`` is the simulated hydration wall-time (store read cost +
        deserialize + host→device transfer estimate) accumulated into stats —
        this is the cold-start penalty of the paper.
        """
        key = (name, version)
        with self._lock:
            hit = self._entries.get(key)
            if hit is not None:
                self._entries.move_to_end(key)
                self.stats.hits += 1
                return hit[0]
        # hydrate outside the lock: concurrent cold starts may duplicate work,
        # which is exactly what concurrent cold Lambda containers do.
        asset, sim_s = hydrate()
        nbytes = pytree_nbytes(asset)
        with self._lock:
            self.stats.misses += 1
            self.stats.hydrate_seconds += float(sim_s)
            if key not in self._entries:
                self._entries[key] = (asset, nbytes)
                self._bytes += nbytes
                self._evict_to_fit()
            return self._entries.get(key, (asset, nbytes))[0]

    def note_hydration(self, sim_s: float) -> None:
        """Account extra on-critical-path hydration for an entry that was a
        HIT but needed more data (a partially-hydrated asset pulling a new
        query's term blocks)."""
        with self._lock:
            self.stats.hydrate_seconds += float(sim_s)

    def note_backfill(self, name: str, version: str,
                      sim_s: float, nbytes: int | None = None) -> None:
        """Account a partial → full upgrade: time goes to the separate
        ``backfill_seconds`` line (never hydrate_seconds — backfill is off
        the critical path by contract), and the entry's byte accounting is
        refreshed since the asset just grew."""
        with self._lock:
            self.stats.backfill_seconds += float(sim_s)
            key = (name, version)
            hit = self._entries.get(key)
            if hit is not None:
                asset, old_nb = hit
                new_nb = int(nbytes) if nbytes is not None else pytree_nbytes(asset)
                self._entries[key] = (asset, new_nb)
                self._bytes += new_nb - old_nb
                self._evict_to_fit()

    def _evict_to_fit(self) -> None:
        while self._bytes > self.capacity_bytes and len(self._entries) > 1:
            _, (old, nb) = self._entries.popitem(last=False)
            del old
            self._bytes -= nb
            self.stats.evictions += 1

    def invalidate(self, name: str, version: str | None = None) -> int:
        """Drop an asset (all versions if version is None). Paper §3 refresh."""
        dropped = 0
        with self._lock:
            for key in list(self._entries):
                if key[0] == name and (version is None or key[1] == version):
                    _, nb = self._entries.pop(key)
                    self._bytes -= nb
                    dropped += 1
        return dropped

    def __contains__(self, key: tuple[str, str]) -> bool:
        with self._lock:
            return key in self._entries

    @property
    def used_bytes(self) -> int:
        with self._lock:
            return self._bytes

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)
