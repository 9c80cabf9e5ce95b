"""K4: dense-tier scoring fused with each chunk's top-k — wrapper of
``csrc/dot_topk.cu`` and K2's merge, the port of ``repro/kernels/dot_topk.py``.

    chunk scores:  s = C_chunk @ q      (1024, D) × (D,), f32, fixed order
    local top-k:   k rounds of max / first argmax / mask, per chunk
    merge:         K2's kernel over the n_chunks·k survivors

One launch scores a whole micro-batch. The reference dispatches one
program per query to keep a query's bits independent of its batch
neighbours; here the per-row order depends on D alone (see the twin,
:func:`repro_torch.kernels.ref.dot_scores_f32`), so batching cannot move a
bit, and neither can the partition's size: the chunk is never shrunk to N.
Rows are float32 — int8 segments are dequantized on the host first, as the
reference does.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import backend, ref
from repro_torch.kernels import topk as k2

DEFAULT_CHUNK = ref.DOT_CHUNK
MAX_GROUP = 16          # queries per block (csrc/dot_topk.cu instantiates 1…16)


def dot_topk_batch(queries: torch.Tensor, cands: torch.Tensor, k: int):
    """queries (Q, D), cands (N, D) f32 → (vals (Q, k) f32, ids (Q, k)
    int32), descending, ties to the lowest row; slots with no live row are
    (-inf, N). ``k`` is at most one chunk's rows, on every device."""
    if k > DEFAULT_CHUNK:
        raise ValueError(f"k={k} exceeds the {DEFAULT_CHUNK} rows of one chunk")
    if not backend.use_kernel(queries, cands):
        return ref.dot_topk_batch_ref(queries, cands, k)
    if queries.dtype != torch.float32 or cands.dtype != torch.float32:
        raise ValueError(f"dot_topk_batch takes f32/f32, got {queries.dtype}/{cands.dtype}")
    if queries.dim() != 2 or cands.dim() != 2 or queries.shape[1] != cands.shape[1]:
        raise ValueError(f"shapes queries {tuple(queries.shape)}, cands {tuple(cands.shape)}")
    Q, D = queries.shape
    N = cands.shape[0]
    n_chunks = max(1, -(-N // DEFAULT_CHUNK))
    if n_chunks > 65535 or N >= 2 ** 31:
        raise ValueError(f"N={N} rows exceed one launch's grid")
    dev = cands.device
    if Q == 0:
        return (torch.zeros(0, k, dtype=torch.float32, device=dev),
                torch.zeros(0, k, dtype=torch.int32, device=dev))
    queries, cands = queries.contiguous(), cands.contiguous()
    group = min(MAX_GROUP, 1 << (Q - 1).bit_length())
    vals = torch.empty(Q, n_chunks * k, dtype=torch.float32, device=dev)
    ids = torch.empty(Q, n_chunks * k, dtype=torch.int32, device=dev)
    lib = backend.library("dot_topk")
    with torch.cuda.device(dev):
        err = lib.dot_topk_chunks_launch(
            queries.data_ptr(), cands.data_ptr(), Q, N, D, k, group,
            vals.data_ptr(), ids.data_ptr(), backend.stream(cands))
        backend.check(lib, err, "dot_topk_chunks_launch")
        dot_topk_batch.launches += 1
        return k2.merge(vals, ids, k, N)


dot_topk_batch.launches = 0


def dot_topk(query: torch.Tensor, cands: torch.Tensor, k: int):
    """query (D,), cands (N, D) → (vals (k,), ids (k,) int32)."""
    vals, ids = dot_topk_batch(query[None, :], cands, k)
    return vals[0], ids[0]
