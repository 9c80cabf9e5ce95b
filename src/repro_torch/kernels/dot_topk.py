"""K4: dense-tier scoring fused with each tile's top-k — wrapper of
``csrc/dot_topk.cu`` and K2's merge, the port of ``repro/kernels/dot_topk.py``.

    tile scores:   s = C_tile @ q       (128, D) × (D,), f32, one FMA a column in d order
    local top-k:   K2's radix select (``csrc/select.cuh``), per tile and query
    merge:         K2's kernel over the n_tiles·min(k, 128) survivors

One launch scores a whole micro-batch. The reference dispatches one
program per query to keep a query's bits independent of its batch
neighbours; here the per-row order depends on D alone (see the twin,
:func:`repro_torch.kernels.ref.dot_scores_f32`), so batching cannot move a
bit, and neither can the partition's size. The top-k set under (value
desc, row asc) does not depend on how the rows are cut, so the kernel's
128-row tile need not be the twin's (and the reference's) 1,024-row chunk.
Rows are float32 — int8 segments are dequantized on the host first, as the
reference does.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import backend, ref
from repro_torch.kernels import topk as k2

MAX_K = ref.DOT_CHUNK      # k may not exceed the reference's 1,024-row chunk
TILE_ROWS = 128            # rows a block of csrc/dot_topk.cu scores and selects
MAX_GROUP = 64             # queries a block (the kernel instantiates 1, 2, 4, … 64)


def survivors(n_rows: int, k: int) -> int:
    """Survivors a query leaves for K2's merge: min(k, 128) a tile."""
    return max(1, -(-n_rows // TILE_ROWS)) * min(k, TILE_ROWS)


def dot_topk_batch(queries: torch.Tensor, cands: torch.Tensor, k: int):
    """queries (Q, D), cands (N, D) f32 → (vals (Q, k) f32, ids (Q, k)
    int32), descending, ties to the lowest row; slots with no live row are
    (-inf, N). ``k`` is at most 1,024 (the reference's chunk), on every
    device."""
    if k > MAX_K:
        raise ValueError(f"k={k} exceeds the {MAX_K} rows of one chunk")
    where = backend.route(queries, cands)
    if where == "meta":
        return _meta(queries, cands, k)
    if where == "cpu":
        return ref.dot_topk_batch_ref(queries, cands, k)
    backend.refuse_grad("dot_topk_batch", queries, cands)
    if queries.dtype != torch.float32 or cands.dtype != torch.float32:
        raise ValueError(f"dot_topk_batch takes f32/f32, got {queries.dtype}/{cands.dtype}")
    if queries.dim() != 2 or cands.dim() != 2 or queries.shape[1] != cands.shape[1]:
        raise ValueError(f"shapes queries {tuple(queries.shape)}, cands {tuple(cands.shape)}")
    Q, D = queries.shape
    N = cands.shape[0]
    if N >= 2 ** 31:
        raise ValueError(f"N={N} rows exceed int32 ids")
    dev = cands.device
    if Q == 0:
        return (torch.zeros(0, k, dtype=torch.float32, device=dev),
                torch.zeros(0, k, dtype=torch.int32, device=dev))
    queries, cands = queries.contiguous(), cands.contiguous()
    group = min(MAX_GROUP, 1 << (Q - 1).bit_length())
    vec = D % 4 == 0 and queries.data_ptr() % 16 == 0 and cands.data_ptr() % 16 == 0
    width = survivors(N, k)
    vals = torch.empty(Q, width, dtype=torch.float32, device=dev)
    ids = torch.empty(Q, width, dtype=torch.int32, device=dev)
    lib = backend.library("dot_topk")
    with torch.cuda.device(dev):
        err = lib.dot_topk_tiles_launch(
            queries.data_ptr(), cands.data_ptr(), Q, N, D, min(k, TILE_ROWS), group, int(vec),
            vals.data_ptr(), ids.data_ptr(), backend.stream(cands))
        backend.check(lib, err, "dot_topk_tiles_launch")
        dot_topk_batch.launches += 1
        return k2.merge(vals, ids, k, N)


dot_topk_batch.launches = 0


def _meta(queries: torch.Tensor, cands: torch.Tensor, k: int):
    """Shape rule: (Q, D) × (N, D) → (Q, k) f32 vals, (Q, k) int32 ids.
    Cost: the rows and queries read once, k pairs a query written; a
    multiply and an add a (query, row, d)."""
    (Q, D), N = queries.shape, cands.shape[0]
    return backend.meta_result(
        "dot_topk_batch", (backend.meta_empty(Q, k, dtype=torch.float32),
                           backend.meta_empty(Q, k, dtype=torch.int32)),
        flops=2 * Q * N * D, nbytes=(N * D + Q * D) * 4 + Q * k * 8)


def dot_topk(query: torch.Tensor, cands: torch.Tensor, k: int):
    """query (D,), cands (N, D) → (vals (k,), ids (k,) int32)."""
    vals, ids = dot_topk_batch(query[None, :], cands, k)
    return vals[0], ids[0]
