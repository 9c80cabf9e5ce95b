"""K6: EmbeddingBag — wrapper of ``csrc/embedding_bag.cu``, the port of
``repro/kernels/embedding_bag.py``.

    table (V, D) f32 | bf16, idx (B, L) int32 (< 0: padding),
    weights (B, L) f32  →  (B, D) f32,   out[b] = Σ_l w[b,l]·table[idx[b,l]]

The recsys family's pooled lookups run here: FM's first-order term and
the FM and DCN-v2 user towers (:mod:`repro_torch.models.recsys`), and the
offsets-form ``models/embedding.py::embedding_bag``. Each bag's slots are
summed in order, one rounding a step (see the twin,
:func:`repro_torch.kernels.ref.embedding_bag_ref`). Ids ≥ V are outside the
contract, as in the reference; nothing checks them. The reference's
``block_bags`` is its tile knob and is not taken: the kernel keeps its own.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import backend, ref


def embedding_bag(table: torch.Tensor, idx: torch.Tensor,
                  weights: torch.Tensor) -> torch.Tensor:
    """table (V, D) f32 or bf16, idx (B, L) int32, weights (B, L) f32 → (B, D)
    f32. Shapes and dtypes are checked on every device, so a call the card
    refuses is refused on the CPU too."""
    if table.dim() != 2 or idx.dim() != 2 or weights.shape != idx.shape:
        raise ValueError(f"shapes table {tuple(table.shape)}, idx {tuple(idx.shape)}, "
                         f"weights {tuple(weights.shape)}")
    if (table.dtype not in (torch.float32, torch.bfloat16) or idx.dtype != torch.int32
            or weights.dtype != torch.float32):
        raise ValueError(f"embedding_bag takes a f32 or bf16 table, int32 ids and f32 "
                         f"weights, got {table.dtype}/{idx.dtype}/{weights.dtype}")
    where = backend.route(table, idx, weights)
    if where == "meta":
        return _meta(table, idx)
    if where == "cpu":
        return ref.embedding_bag_ref(table, idx, weights)
    backend.refuse_grad("embedding_bag", table, weights)
    B, L = idx.shape
    D = table.shape[1]
    if B >= 2 ** 31:
        raise ValueError(f"B={B} bags exceed one launch's grid")
    out = torch.empty(B, D, dtype=torch.float32, device=table.device)
    if B == 0 or D == 0:
        return out
    table, idx, weights = table.contiguous(), idx.contiguous(), weights.contiguous()
    lib = backend.library("embedding_bag")
    with torch.cuda.device(table.device):
        err = lib.embedding_bag_launch(
            table.data_ptr(), idx.data_ptr(), weights.data_ptr(), out.data_ptr(), B, L, D,
            int(table.dtype == torch.bfloat16), backend.stream(table))
    backend.check(lib, err, "embedding_bag_launch")
    embedding_bag.launches += 1
    return out


def _meta(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Shape rule: (V, D) table, (B, L) ids → (B, D) f32. Cost: ids and
    weights read once, each slot's row read once (at most the whole
    table), the bags written; a multiply and an add a (slot, d)."""
    (B, L), (V, D) = idx.shape, table.shape
    rows = min(B * L, V) * D * table.element_size()
    return backend.meta_result("embedding_bag", backend.meta_empty(B, D, dtype=torch.float32),
                               flops=2 * B * L * D, nbytes=B * L * 8 + rows + B * D * 4)


embedding_bag.launches = 0
