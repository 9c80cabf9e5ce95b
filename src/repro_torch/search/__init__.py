"""BM25 scoring core, the single-node searcher and the app assembly."""
