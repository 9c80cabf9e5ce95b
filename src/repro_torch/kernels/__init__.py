"""Hand-written CUDA kernels for Hopper and their plain PyTorch twins.

K3 ``bm25_block`` (impacts), K2 ``topk`` (chunked top-k), K1
``bm25_pruned`` (block-max pruned scoring + top-k), K4 ``dot_topk``
(dense-tier inner products + top-k), K5 ``flash_attention`` (the LM's
and the recsys encoders' attention) and K6 ``embedding_bag`` (the recsys
pooled lookups): each wrapper launches
its ``csrc/*.cu`` kernel on a CUDA tensor and takes its twin in ``ref`` on
a CPU tensor (:mod:`repro_torch.kernels.backend`). Each wrapper counts its
launches in a plain ``launches`` attribute.
"""
