"""Document partitioning of a corpus — the host-side part of
``repro/search/distributed.py`` that the fleet needs.

The mesh search path of the reference module (``DistSearchConfig``,
``make_dist_search_fn``, ``stack_partitions``, ``build_partitioned_state``)
waits for ROADMAP Queue 1 item 6.
"""

from __future__ import annotations


def partition_corpus(docs: list[tuple[str, str]], n_parts: int,
                     weights: "list[float] | None" = None):
    """Contiguous-chunk document partitioning; returns per-partition doc
    lists plus ``per``, the uniform per-partition size (global id =
    part * per + local id — the mesh path's id map).

    ``weights`` skews the split: partition ``p`` receives a share of the
    corpus proportional to ``weights[p]`` (largest-remainder rounding, so
    sizes sum exactly to the corpus). This is how a benchmark builds the
    Zipf-skewed fleet real collections look like — a head partition with
    most of the documents, a long cold tail — while every partition still
    packs against the same global stats. Weighted splits have no uniform
    ``per``; the returned ``per`` is the LARGEST partition (the fleet app
    maps global ids through actual per-partition offsets, never ``per``,
    whenever an indexer is attached — i.e. always)."""
    if weights is None:
        per = -(-len(docs) // n_parts)
        return [docs[p * per: (p + 1) * per] for p in range(n_parts)], per
    if len(weights) != n_parts or any(w < 0 for w in weights) \
            or sum(weights) <= 0:
        raise ValueError(f"need {n_parts} nonnegative weights with a "
                         f"positive sum, got {weights!r}")
    total = float(sum(weights))
    quotas = [len(docs) * w / total for w in weights]
    sizes = [int(q) for q in quotas]
    # largest remainder: hand leftover docs to the most-shortchanged parts
    for p in sorted(range(n_parts), key=lambda p: quotas[p] - sizes[p],
                    reverse=True)[: len(docs) - sum(sizes)]:
        sizes[p] += 1
    parts, at = [], 0
    for n in sizes:
        parts.append(docs[at: at + n])
        at += n
    return parts, max(sizes)
