"""S3-analogue object store.

The paper stores Lucene index structures in Amazon S3 and reads them from
Lambda through a custom ``Directory``. This module provides the store side of
that seam: immutable, versioned blobs addressed by key, with etags,
byte-range reads, listing, and multipart upload. Two backends:

* ``MemoryBackend`` — dict-of-bytes; used by tests and the FaaS simulator.
* ``FilesystemBackend`` — one file per object under a root dir; used by the
  examples and checkpointing (survives process restarts, which is what makes
  the "stateless compute / durable state" split real).

Latency/throughput accounting is injected via ``NetworkModel`` so the FaaS
simulator can charge realistic cold-start hydration times (S3 GET latency +
bandwidth) without any real network.
"""

from __future__ import annotations

import dataclasses
import hashlib
import io
import os
import threading
import time


class ObjectStoreError(Exception):
    pass


class NoSuchKey(ObjectStoreError):
    pass


class PreconditionFailed(ObjectStoreError):
    """Conditional put failed (etag mismatch) — used for atomic publishes."""


def _etag(data: bytes) -> str:
    return hashlib.md5(data).hexdigest()


@dataclasses.dataclass(frozen=True)
class ObjectMeta:
    key: str
    size: int
    etag: str
    mtime: float


@dataclasses.dataclass
class NetworkModel:
    """Models datacenter-network reads from the store (paper §2: 'bytes are

    now streamed across the datacenter network from S3'). Pure accounting —
    never sleeps; simulated seconds are returned/accumulated so benchmarks
    can report S3-like hydration costs deterministically.
    """

    first_byte_s: float = 0.015      # S3 GET time-to-first-byte (~15 ms)
    bandwidth_Bps: float = 90e6      # ~90 MB/s per stream (S3 single-stream)
    metadata_s: float = 0.005        # HEAD / LIST round-trip

    def read_cost_s(self, nbytes: int) -> float:
        return self.first_byte_s + nbytes / self.bandwidth_Bps

    def metadata_cost_s(self) -> float:
        return self.metadata_s


class Backend:
    """Minimal blob backend interface.

    ``get`` takes the byte range: the store's ranged reads must move only
    the requested bytes through the backend (a seek on the filesystem, a
    slice in memory), so the real bytes moved always match the bytes
    ``NetworkModel.read_cost_s`` bills for. ``length=None`` reads to EOF.
    """

    def put(self, key: str, data: bytes) -> None:
        raise NotImplementedError

    def get(self, key: str, start: int = 0, length: int | None = None) -> bytes:
        raise NotImplementedError

    def delete(self, key: str) -> None:
        raise NotImplementedError

    def keys(self) -> list[str]:
        raise NotImplementedError

    def __contains__(self, key: str) -> bool:
        try:
            self.get(key)
            return True
        except NoSuchKey:
            return False


class MemoryBackend(Backend):
    def __init__(self) -> None:
        self._blobs: dict[str, bytes] = {}
        self._lock = threading.Lock()

    def put(self, key: str, data: bytes) -> None:
        with self._lock:
            self._blobs[key] = bytes(data)

    def get(self, key: str, start: int = 0, length: int | None = None) -> bytes:
        with self._lock:
            try:
                data = self._blobs[key]
            except KeyError:
                raise NoSuchKey(key) from None
        if start == 0 and length is None:
            return data
        end = len(data) if length is None else start + length
        return data[start:end]

    def delete(self, key: str) -> None:
        with self._lock:
            self._blobs.pop(key, None)

    def keys(self) -> list[str]:
        with self._lock:
            return sorted(self._blobs)


class FilesystemBackend(Backend):
    def __init__(self, root: str) -> None:
        self.root = os.path.abspath(root)
        os.makedirs(self.root, exist_ok=True)

    def _path(self, key: str) -> str:
        if ".." in key.split("/"):
            raise ObjectStoreError(f"illegal key {key!r}")
        return os.path.join(self.root, key)

    def put(self, key: str, data: bytes) -> None:
        path = self._path(key)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(data)
        os.replace(tmp, path)  # atomic publish, like S3 PUT visibility

    def get(self, key: str, start: int = 0, length: int | None = None) -> bytes:
        # seek-based ranged read: a byte-range GET moves only the requested
        # bytes off disk, matching what the network model bills for
        try:
            with open(self._path(key), "rb") as f:
                if start:
                    f.seek(start)
                return f.read() if length is None else f.read(length)
        except FileNotFoundError:
            raise NoSuchKey(key) from None

    def delete(self, key: str) -> None:
        try:
            os.remove(self._path(key))
        except FileNotFoundError:
            pass

    def keys(self) -> list[str]:
        out = []
        for dirpath, _, files in os.walk(self.root):
            for fn in files:
                if fn.endswith(".tmp"):
                    continue
                rel = os.path.relpath(os.path.join(dirpath, fn), self.root)
                out.append(rel.replace(os.sep, "/"))
        return sorted(out)


class ObjectStore:
    """Versioned, etag'd blob store with range reads and simulated latency."""

    def __init__(self, backend: Backend | None = None,
                 network: NetworkModel | None = None) -> None:
        self.backend = backend if backend is not None else MemoryBackend()
        self.network = network if network is not None else NetworkModel()
        self._meta: dict[str, ObjectMeta] = {}
        self._lock = threading.Lock()
        self.stats = StoreStats()
        # rebuild metadata for pre-existing objects (fs backend reuse)
        for key in self.backend.keys():
            data = self.backend.get(key)
            self._meta[key] = ObjectMeta(key, len(data), _etag(data), time.time())

    # -- write path ---------------------------------------------------------

    def put(self, key: str, data: bytes, *, if_etag: str | None = None) -> ObjectMeta:
        with self._lock:
            if if_etag is not None:
                cur = self._meta.get(key)
                cur_etag = cur.etag if cur else ""
                if cur_etag != if_etag:
                    raise PreconditionFailed(f"{key}: etag {cur_etag!r} != {if_etag!r}")
            self.backend.put(key, data)
            meta = ObjectMeta(key, len(data), _etag(data), time.time())
            self._meta[key] = meta
            self.stats.puts += 1
            self.stats.bytes_in += len(data)
            return meta

    def multipart(self, key: str) -> "MultipartUpload":
        return MultipartUpload(self, key)

    def delete(self, key: str) -> None:
        with self._lock:
            self.backend.delete(key)
            self._meta.pop(key, None)

    # -- read path ----------------------------------------------------------

    def head(self, key: str) -> ObjectMeta:
        with self._lock:
            meta = self._meta.get(key)
        if meta is None:
            raise NoSuchKey(key)
        self.stats.sim_seconds += self.network.metadata_cost_s()
        return meta

    def get(self, key: str, *, start: int = 0, length: int | None = None) -> bytes:
        """Byte-range GET (the Directory seam relies on ranged reads).

        The range is pushed into the backend (filesystem seek / memory
        slice), never served by fetching the whole object and slicing: the
        real bytes moved are exactly the bytes the network model charges
        ``read_cost_s`` for. Bounds come from the store's own metadata, so
        an out-of-range start still fails loudly without touching data."""
        with self._lock:
            meta = self._meta.get(key)
        if meta is None:
            raise NoSuchKey(key)
        size = meta.size
        if start < 0 or start > size:
            raise ObjectStoreError(f"{key}: bad range start={start} size={size}")
        end = size if length is None else min(start + length, size)
        chunk = self.backend.get(key, start, max(0, end - start))
        self.stats.gets += 1
        self.stats.bytes_out += len(chunk)
        self.stats.sim_seconds += self.network.read_cost_s(len(chunk))
        return chunk

    def list(self, prefix: str = "") -> list[ObjectMeta]:
        self.stats.sim_seconds += self.network.metadata_cost_s()
        with self._lock:
            return [m for k, m in sorted(self._meta.items()) if k.startswith(prefix)]

    def __contains__(self, key: str) -> bool:
        with self._lock:
            return key in self._meta


@dataclasses.dataclass
class StoreStats:
    gets: int = 0
    puts: int = 0
    bytes_in: int = 0
    bytes_out: int = 0
    sim_seconds: float = 0.0   # accumulated simulated network time


class MultipartUpload:
    """S3-style multipart upload: parts buffered, object visible on complete."""

    def __init__(self, store: ObjectStore, key: str) -> None:
        self.store = store
        self.key = key
        self._buf = io.BytesIO()
        self._done = False

    def write(self, part: bytes) -> None:
        if self._done:
            raise ObjectStoreError("upload already completed")
        self._buf.write(part)

    def complete(self) -> ObjectMeta:
        self._done = True
        return self.store.put(self.key, self._buf.getvalue())

    def abort(self) -> None:
        self._done = True
        self._buf = io.BytesIO()
