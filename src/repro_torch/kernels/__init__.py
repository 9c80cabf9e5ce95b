"""Hand-written CUDA kernels for Hopper and their plain PyTorch twins.

K3 ``bm25_block`` (impacts), K2 ``topk`` (chunked top-k) and K1
``bm25_pruned`` (block-max pruned scoring + top-k): each wrapper launches
its ``csrc/*.cu`` kernel on a CUDA tensor and takes its twin in ``ref`` on
a CPU tensor (:mod:`repro_torch.kernels.backend`). Each wrapper counts its
launches in a plain ``launches`` attribute.
"""
