"""The Lucene ``Directory`` seam, adapted.

Lucene reads indexes through ``Directory``: open a named file, read bytes,
seek. The paper's whole trick is swapping the implementation (``S3Directory``)
under an *unchanged* query-evaluation stack. We preserve that seam:

* ``Directory`` — abstract: ``open_input(name) -> IndexInput``, ``list()``.
* ``IndexInput`` — positioned byte reader (read/seek/slice), Lucene-style.
* ``StoreDirectory`` — reads from an :class:`ObjectStore` prefix, with a
  block cache (this is the paper's §2 caching mechanism: reads populate an
  in-memory cache so warm instances never touch the store again).
* ``RamDirectory`` — fully in-memory (tests, and the "everything hydrated"
  steady state).

On the TPU side the searcher hydrates *whole segments* through this seam into
packed arrays (see DESIGN.md §2 — eager, segment-granular hydration replaces
Lucene's lazy byte faulting, which has no HBM analogue).
"""

from __future__ import annotations

import struct
import threading

from repro_torch.core.object_store import NoSuchKey, ObjectStore


class DirectoryError(Exception):
    pass


class IndexInput:
    """Positioned reader over one named index file."""

    def __init__(self, name: str, read_range, size: int):
        self._name = name
        self._read_range = read_range     # (start, length) -> bytes
        self._size = size
        self._pos = 0

    # -- Lucene-ish surface ---------------------------------------------------

    def length(self) -> int:
        return self._size

    def tell(self) -> int:
        return self._pos

    def seek(self, pos: int) -> None:
        if not (0 <= pos <= self._size):
            raise DirectoryError(f"{self._name}: seek({pos}) out of [0,{self._size}]")
        self._pos = pos

    def read_bytes(self, n: int) -> bytes:
        if self._pos + n > self._size:
            raise DirectoryError(f"{self._name}: read past EOF")
        out = self._read_range(self._pos, n)
        self._pos += n
        return out

    def read_all(self) -> bytes:
        self.seek(0)
        return self.read_bytes(self._size)

    def read_u32(self) -> int:
        return struct.unpack("<I", self.read_bytes(4))[0]

    def read_u64(self) -> int:
        return struct.unpack("<Q", self.read_bytes(8))[0]

    def read_f32(self) -> float:
        return struct.unpack("<f", self.read_bytes(4))[0]

    def slice(self, offset: int, length: int) -> "IndexInput":
        if offset + length > self._size:
            raise DirectoryError(f"{self._name}: slice past EOF")
        base = self._read_range
        return IndexInput(
            f"{self._name}[{offset}:{offset+length}]",
            lambda s, n: base(offset + s, n),
            length,
        )


class Directory:
    def open_input(self, name: str) -> IndexInput:
        raise NotImplementedError

    def list(self) -> list[str]:
        raise NotImplementedError

    def file_length(self, name: str) -> int:
        raise NotImplementedError

    def __contains__(self, name: str) -> bool:
        return name in self.list()


class RamDirectory(Directory):
    def __init__(self, files: dict[str, bytes] | None = None) -> None:
        self.files: dict[str, bytes] = dict(files or {})

    def write(self, name: str, data: bytes) -> None:
        self.files[name] = bytes(data)

    def open_input(self, name: str) -> IndexInput:
        try:
            data = self.files[name]
        except KeyError:
            raise DirectoryError(f"no such file {name!r}") from None
        return IndexInput(name, lambda s, n: data[s : s + n], len(data))

    def list(self) -> list[str]:
        return sorted(self.files)

    def file_length(self, name: str) -> int:
        return len(self.files[name])


class StoreDirectory(Directory):
    """Directory over an ObjectStore prefix, with a read-through block cache.

    Cache granularity is ``block_size`` bytes, mirroring S3Directory's
    buffered reads. ``cache_stats`` exposes hit/miss/bytes so the FaaS
    simulator can distinguish cold (cache-populating) from warm invocations.
    """

    def __init__(self, store: ObjectStore, prefix: str, *,
                 block_size: int = 1 << 20) -> None:
        if prefix and not prefix.endswith("/"):
            prefix += "/"
        self.store = store
        self.prefix = prefix
        self.block_size = block_size
        self._blocks: dict[tuple[str, int], bytes] = {}
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0
        self.bytes_fetched = 0

    # -- cache ---------------------------------------------------------------

    def _read_range(self, key: str, size: int, start: int, n: int) -> bytes:
        """Read [start, start+n) of object `key`, block-cached."""
        bs = self.block_size
        out = bytearray()
        blk = start // bs
        while blk * bs < start + n:
            ck = (key, blk)
            with self._lock:
                block = self._blocks.get(ck)
            if block is None:
                self.misses += 1
                lo = blk * bs
                block = self.store.get(key, start=lo, length=min(bs, size - lo))
                self.bytes_fetched += len(block)
                with self._lock:
                    self._blocks[ck] = block
            else:
                self.hits += 1
            lo = blk * bs
            s = max(start, lo) - lo
            e = min(start + n, lo + len(block)) - lo
            out += block[s:e]
            blk += 1
        return bytes(out)

    def drop_cache(self) -> None:
        with self._lock:
            self._blocks.clear()

    def cached_bytes(self) -> int:
        with self._lock:
            return sum(len(b) for b in self._blocks.values())

    # -- Directory surface -----------------------------------------------------

    def open_input(self, name: str) -> IndexInput:
        key = self.prefix + name
        try:
            meta = self.store.head(key)
        except NoSuchKey:
            raise DirectoryError(f"no such file {name!r} under {self.prefix!r}") from None
        return IndexInput(
            name, lambda s, n: self._read_range(key, meta.size, s, n), meta.size
        )

    def list(self) -> list[str]:
        plen = len(self.prefix)
        return [m.key[plen:] for m in self.store.list(self.prefix)]

    def file_length(self, name: str) -> int:
        return self.store.head(self.prefix + name).size


def copy_directory(src: Directory, dst_store: ObjectStore, prefix: str) -> None:
    """Upload every file in `src` under `prefix` (multipart for big files)."""
    if prefix and not prefix.endswith("/"):
        prefix += "/"
    for name in src.list():
        data = src.open_input(name).read_all()
        up = dst_store.multipart(prefix + name)
        for off in range(0, len(data), 8 << 20):
            up.write(data[off : off + (8 << 20)])
        up.complete()
