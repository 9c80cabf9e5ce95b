"""K3: BM25 impacts over gathered postings blocks — wrapper of
``csrc/bm25_block.cu``, the port of ``repro/kernels/bm25_block.py``.

    impact = idf_t · tf / (tf + k1 · (1 − b + b · dl / avgdl))

elementwise over (Q, T, M, B) with one idf per (query, term).
"""

from __future__ import annotations

import torch

from repro_torch.kernels import backend, ref


def bm25_block_scores(tf: torch.Tensor, dl: torch.Tensor, idf: torch.Tensor,
                      k1, b, avgdl) -> torch.Tensor:
    """tf (..., T, M, B) uint8, dl (..., T, M, B) f32, idf (..., T) f32 →
    (..., T, M, B) f32."""
    if not backend.use_kernel(tf, dl, idf):
        return ref.bm25_block_scores_ref(tf, dl, idf, k1, b, avgdl)
    if tf.dtype != torch.uint8 or dl.dtype != torch.float32 or idf.dtype != torch.float32:
        raise ValueError(f"bm25_block_scores takes u8/f32/f32, got {tf.dtype}/{dl.dtype}/{idf.dtype}")
    if tf.shape != dl.shape or tf.shape[:-2] != idf.shape:
        raise ValueError(f"shapes tf {tuple(tf.shape)}, dl {tuple(dl.shape)}, idf {tuple(idf.shape)}")
    M, B = tf.shape[-2:]
    tf, dl, idf = tf.contiguous(), dl.contiguous(), idf.contiguous()
    out = torch.empty(tf.shape, dtype=torch.float32, device=tf.device)
    lib = backend.library("bm25_block")
    with torch.cuda.device(tf.device):
        err = lib.bm25_block_scores_launch(
            tf.data_ptr(), dl.data_ptr(), idf.data_ptr(), out.data_ptr(), tf.numel(), B, M,
            backend.f32(k1), backend.f32(b), backend.f32(avgdl), backend.stream(tf))
    backend.check(lib, err, "bm25_block_scores_launch")
    bm25_block_scores.launches += 1
    return out


bm25_block_scores.launches = 0
