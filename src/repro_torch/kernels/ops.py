"""The six kernels behind one import — the port of ``repro/kernels/ops.py``.

The reference's front forwards each call to its Pallas kernel with the
backend's interpret mode. Here the tensors' device picks the route
(:mod:`repro_torch.kernels.backend`: the hand kernel on the card, the plain
twin on the CPU, the shape rule on meta), so the front is the wrappers
themselves: each name below is the wrapper's own function, with its
``launches`` counter, and a call through it is the same call.

    from repro_torch.kernels import ops as kops
    vals, ids = kops.topk(scores, k)
"""

from __future__ import annotations

from repro_torch.kernels.bm25_block import bm25_block_impacts, bm25_block_scores
from repro_torch.kernels.bm25_pruned import bm25_pruned_topk
from repro_torch.kernels.dot_topk import dot_topk, dot_topk_batch
from repro_torch.kernels.embedding_bag import embedding_bag
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.topk import topk

__all__ = ["bm25_block_scores", "bm25_block_impacts", "bm25_pruned_topk", "topk", "dot_topk",
           "dot_topk_batch", "flash_attention", "embedding_bag"]
