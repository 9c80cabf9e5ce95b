"""PyTorch + CUDA port of the serverless-Lucene prototype.

Mirrors ``src/repro`` (the JAX package, the reference) path for path. It
imports ``torch`` and ``numpy`` and nothing of JAX or of ``repro``; the
numpy-only layers it needs are copies of its own. Entry points run on the
card unless the caller passes ``device="cpu"``.
"""
