"""K3: BM25 impacts over gathered postings blocks — wrappers of
``csrc/bm25_block.cu``, the port of ``repro/kernels/bm25_block.py``.

    impact = idf_t · tf / (tf + k1 · (1 − b + b · dl / avgdl))

elementwise over (Q, T, M, B) with one idf per (query, term). Two entry
points launch the one kernel: :func:`bm25_block_scores` takes ``dl`` as
the reference's kernel does; :func:`bm25_block_impacts`, the main path's
call, reads ``dl = doc_len[doc]`` itself and writes +0.0 where the
reference's ``bm25_impacts`` masks (invalid row, pad doc, zero tf), so no
eager gather or mask runs around it.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import backend, ref

MAX_POSTINGS = 2**31 - 1     # the kernel indexes postings in 32 bits


def _launch_shape(tf: torch.Tensor, idf: torch.Tensor, name: str) -> tuple[int, int]:
    """(M, B) of a call, after checking the shapes the kernel indexes."""
    if tf.dim() < 3 or tf.shape[:-2] != idf.shape:
        raise ValueError(f"{name}: shapes tf {tuple(tf.shape)}, idf {tuple(idf.shape)}")
    if tf.numel() > MAX_POSTINGS:
        raise ValueError(f"{name}: {tf.numel()} postings, the kernel takes at most "
                         f"{MAX_POSTINGS}")
    return tf.shape[-2], tf.shape[-1]


def bm25_block_scores(tf: torch.Tensor, dl: torch.Tensor, idf: torch.Tensor,
                      k1, b, avgdl) -> torch.Tensor:
    """tf (..., T, M, B) uint8, dl (..., T, M, B) f32, idf (..., T) f32 →
    (..., T, M, B) f32."""
    if not backend.use_kernel(tf, dl, idf):
        return ref.bm25_block_scores_ref(tf, dl, idf, k1, b, avgdl)
    backend.refuse_grad("bm25_block_scores", dl, idf)
    if tf.dtype != torch.uint8 or dl.dtype != torch.float32 or idf.dtype != torch.float32:
        raise ValueError(f"bm25_block_scores takes u8/f32/f32, got {tf.dtype}/{dl.dtype}/{idf.dtype}")
    if tf.shape != dl.shape:
        raise ValueError(f"shapes tf {tuple(tf.shape)}, dl {tuple(dl.shape)}")
    M, B = _launch_shape(tf, idf, "bm25_block_scores")
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


def bm25_block_impacts(tf: torch.Tensor, docs: torch.Tensor, valid: torch.Tensor,
                       doc_len: torch.Tensor, idf: torch.Tensor, k1, b, avgdl,
                       n_docs: int) -> torch.Tensor:
    """tf (..., T, M, B) uint8, docs (..., T, M, B) int32 in [0, n_docs]
    (n_docs = pad), valid (..., T, M, 1) bool, doc_len (n_docs + 1,) f32,
    idf (..., T) f32 → (..., T, M, B) f32: the impact with
    ``dl = doc_len[min(doc, n_docs)]`` where the row is valid, the doc live
    and tf ≠ 0, else +0.0 — ``ref.bm25_block_impacts_ref``'s bits."""
    if not backend.use_kernel(tf, docs, valid, doc_len, idf):
        return ref.bm25_block_impacts_ref(tf, docs, valid, doc_len, idf, k1, b, avgdl, n_docs)
    backend.refuse_grad("bm25_block_impacts", doc_len, idf)
    want = (torch.uint8, torch.int32, torch.bool, torch.float32, torch.float32)
    got = tuple(x.dtype for x in (tf, docs, valid, doc_len, idf))
    if got != want:
        raise ValueError(f"bm25_block_impacts takes dtypes {want}, got {got}")
    M, B = _launch_shape(tf, idf, "bm25_block_impacts")
    if docs.shape != tf.shape or valid.shape != (*tf.shape[:-1], 1) \
            or doc_len.shape != (n_docs + 1,):
        raise ValueError(f"bm25_block_impacts: shapes tf {tuple(tf.shape)}, docs "
                         f"{tuple(docs.shape)}, valid {tuple(valid.shape)}, doc_len "
                         f"{tuple(doc_len.shape)} for n_docs {n_docs}")
    tf, docs, valid, doc_len, idf = (
        x.contiguous() for x in (tf, docs, valid, doc_len, idf))
    out = torch.empty(tf.shape, dtype=torch.float32, device=tf.device)
    lib = backend.library("bm25_block")
    with torch.cuda.device(tf.device):
        err = lib.bm25_block_impacts_launch(
            tf.data_ptr(), docs.data_ptr(), valid.data_ptr(), doc_len.data_ptr(),
            idf.data_ptr(), out.data_ptr(), tf.numel(), B, M, n_docs, backend.f32(k1),
            backend.f32(b), backend.f32(avgdl), backend.stream(tf))
    backend.check(lib, err, "bm25_block_impacts_launch")
    bm25_block_impacts.launches += 1
    return out


bm25_block_impacts.launches = 0
