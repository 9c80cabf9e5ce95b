"""End-to-end Anlessini application assembly (Figure 1 of the paper) — the
single-function part of ``repro/search/service.py``.

``build_search_app`` wires corpus → index → object store → FaaS runtime →
gateway and returns the pieces. The partitioned fleet, its NRT writer path
and the dense/hybrid/structured request shapes are not ported yet (ROADMAP
Queue 1 items 3–5).
"""

from __future__ import annotations

import dataclasses
from typing import Iterable

from repro_torch.core.gateway import Gateway
from repro_torch.core.kvstore import KVStore
from repro_torch.core.object_store import Backend, ObjectStore
from repro_torch.core.refresh import AssetCatalog
from repro_torch.core.runtime import FaaSRuntime, RuntimeConfig
from repro_torch.index.builder import IndexWriter, write_segment
from repro_torch.kernels.backend import resolve_device
from repro_torch.search.searcher import SearchConfig, make_search_handler


def _search_body(q: "str | list[str] | None", k: int, fetch_docs: bool) -> dict:
    """The ``/search`` body: ``q`` for one query, ``queries`` for a
    micro-batch (one invocation)."""
    body = {"k": k, "fetch_docs": fetch_docs}
    if q is not None:
        if isinstance(q, str):
            body["q"] = q
        else:
            body["queries"] = list(q)
    return body


@dataclasses.dataclass
class SearchApp:
    store: ObjectStore
    catalog: AssetCatalog
    doc_store: KVStore
    runtime: FaaSRuntime
    gateway: Gateway
    asset: str

    def query(self, q: "str | list[str]", k: int = 10, *,
              t_arrival: float | None = None, fetch_docs: bool = True):
        return self.gateway.request(
            "GET", "/search", _search_body(q, k, fetch_docs),
            t_arrival=t_arrival)


def index_corpus(docs: Iterable[tuple[str, str]], store: ObjectStore,
                 doc_store: KVStore, *, asset: str = "index",
                 version: str = "v1",
                 global_stats: dict | None = None,
                 vocab: dict[str, int] | None = None) -> AssetCatalog:
    """The offline batch side: build, pack, publish (paper §3).

    Pass ``global_stats`` (index.builder.compute_global_stats over the FULL
    corpus) — and the corpus-global ``vocab`` — when these docs are one
    partition of a larger deployment."""
    writer = IndexWriter(global_stats=global_stats, vocab=vocab)
    for ext_id, text in docs:
        writer.add(ext_id, text)
        doc_store.put(ext_id, {"id": ext_id, "contents": text})
    packed = writer.pack()
    catalog = AssetCatalog(store)
    catalog.publish(asset, version, write_segment(packed))
    return catalog


def build_search_app(
    docs: Iterable[tuple[str, str]],
    *,
    runtime_config: RuntimeConfig | None = None,
    search_config: SearchConfig | None = None,
    backend: Backend | None = None,
    asset: str = "index",
    device=None,
) -> SearchApp:
    """Corpus → published index → one search function behind ``GET /search``.
    ``device`` (None → the card) is where the function's searchers live."""
    device = resolve_device(device)      # no card: raise before packing
    store = ObjectStore(backend)
    doc_store = KVStore()
    catalog = index_corpus(docs, store, doc_store, asset=asset)
    handler = make_search_handler(catalog, doc_store, asset, search_config, device)
    runtime = FaaSRuntime(runtime_config)
    runtime.register("search", handler)
    gateway = Gateway(runtime)
    gateway.route("GET", "/search", "search")
    return SearchApp(store, catalog, doc_store, runtime, gateway, asset)
