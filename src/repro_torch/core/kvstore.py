"""DynamoDB-analogue key-value store for raw documents.

Paper §2: "Raw documents are stored in DynamoDB (organized as a simple
key-value store) so that they can be accessed as part of the search results."

Also used by the Crane & Lin '17 baseline (repro.baselines in the JAX package), which stored
*postings lists* in DynamoDB — the design the paper improves on.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Iterable, Mapping

from repro_torch.core import jsonutil as orjson   # orjson when installed


class KVError(Exception):
    pass


@dataclasses.dataclass
class KVModel:
    """DynamoDB-ish latency accounting (simulated, never sleeps)."""

    get_s: float = 0.004          # single GetItem ~4 ms
    batch_get_s: float = 0.010    # BatchGetItem round trip
    batch_max_items: int = 100    # DynamoDB BatchGetItem limit
    put_s: float = 0.006

    def batch_get_cost(self, n_keys: int) -> float:
        """Simulated seconds for a batch_get of n_keys — one round trip per
        batch_max_items chunk, matching KVStore.batch_get's own accounting.
        Callers that bill KV time into their latency use THIS, never a
        hand-rolled formula."""
        return -(-n_keys // self.batch_max_items) * self.batch_get_s


@dataclasses.dataclass
class KVStats:
    gets: int = 0
    puts: int = 0
    deletes: int = 0
    round_trips: int = 0
    sim_seconds: float = 0.0


class KVStore:
    """Thread-safe KV store with JSON item values and batch ops."""

    def __init__(self, model: KVModel | None = None) -> None:
        self._items: dict[str, bytes] = {}
        self._lock = threading.Lock()
        self.model = model if model is not None else KVModel()
        self.stats = KVStats()

    def put(self, key: str, item: Mapping) -> None:
        data = orjson.dumps(item)
        with self._lock:
            self._items[key] = data
        self.stats.puts += 1
        self.stats.round_trips += 1
        self.stats.sim_seconds += self.model.put_s

    def batch_put(self, items: Mapping[str, Mapping]) -> None:
        blobs = {k: orjson.dumps(v) for k, v in items.items()}
        with self._lock:
            self._items.update(blobs)
        self.stats.puts += len(items)
        self.stats.round_trips += 1
        self.stats.sim_seconds += self.model.put_s

    def delete(self, key: str) -> None:
        """DeleteItem semantics: idempotent, missing keys are a no-op.
        Without this, a search fleet's document deletes would be cosmetic —
        the index tombstones the doc but its full contents stay fetchable
        by ext id forever (the usual reason to delete IS data removal)."""
        with self._lock:
            self._items.pop(key, None)
        self.stats.deletes += 1
        self.stats.round_trips += 1
        self.stats.sim_seconds += self.model.put_s   # DeleteItem ≈ PutItem

    def get(self, key: str) -> dict:
        with self._lock:
            data = self._items.get(key)
        self.stats.gets += 1
        self.stats.round_trips += 1
        self.stats.sim_seconds += self.model.get_s
        if data is None:
            raise KVError(f"no item {key!r}")
        return orjson.loads(data)

    def batch_get_billed(self, keys: Iterable[str]) -> tuple[dict[str, dict], float]:
        """batch_get + the simulated seconds a caller bills into ITS latency.

        The single source of the 'one deduped fetch, charged per
        BatchGetItem chunk' rule used by the search handler and the
        partitioned-app coordinator. Cost is charged per key ATTEMPTED —
        missing keys still cost the round trip."""
        keys = list(keys)
        if not keys:
            return {}, 0.0
        return self.batch_get(keys), self.model.batch_get_cost(len(keys))

    def batch_get(self, keys: Iterable[str]) -> dict[str, dict]:
        """BatchGetItem semantics: missing keys silently absent; batches of
        ``batch_max_items`` each cost one round trip."""
        keys = list(keys)
        out: dict[str, dict] = {}
        bm = self.model.batch_max_items
        for i in range(0, len(keys), bm):
            chunk = keys[i : i + bm]
            with self._lock:
                for k in chunk:
                    data = self._items.get(k)
                    if data is not None:
                        out[k] = orjson.loads(data)
            self.stats.round_trips += 1
            self.stats.sim_seconds += self.model.batch_get_s
            self.stats.gets += len(chunk)
        return out

    def __contains__(self, key: str) -> bool:
        with self._lock:
            return key in self._items

    def __len__(self) -> int:
        with self._lock:
            return len(self._items)
