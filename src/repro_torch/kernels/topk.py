"""K2: chunked top-k over long score rows — wrapper of ``csrc/topk.cu``.

The port of ``repro/kernels/topk.py``. Phase 1 takes each chunk's local
top-k by k rounds of (max, first argmax, mask); phase 2 merges the
``n_chunks·k`` survivors with the same kernel, whose position order among
equal values is id order, so ties resolve to the lowest id exactly like
``lax.top_k``. Non-live slots come back as ``(-inf, N)``. Rows are a
leading Q dimension: one launch serves a whole micro-batch.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import backend, ref

DEFAULT_CHUNK = 16384    # f32 chunk = 64 KB of shared memory
MAX_CHUNK = 56 * 1024    # f32 elements that fit one block's shared memory


def _rounds(scores: torch.Tensor, ids_in: "torch.Tensor | None", n: int,
            chunk: int, k: int, n_live: int):
    """One launch: the per-chunk top-k of the first ``n`` entries of every
    row. Returns survivors (Q, n_chunks·k) vals and ids."""
    lib = backend.library("topk")
    Q = scores.shape[0]
    n_chunks = max(1, -(-n // chunk))
    vals = torch.empty(Q, n_chunks * k, dtype=torch.float32, device=scores.device)
    ids = torch.empty(Q, n_chunks * k, dtype=torch.int32, device=scores.device)
    err = lib.topk_rounds_launch(
        scores.data_ptr(), ids_in.data_ptr() if ids_in is not None else None,
        scores.stride(0), n, Q, chunk, k, n_live, vals.data_ptr(), ids.data_ptr(),
        backend.stream(scores))
    backend.check(lib, err, "topk_rounds_launch")
    topk.launches += 1
    return vals, ids


def topk(scores: torch.Tensor, k: int, *, chunk: int = DEFAULT_CHUNK):
    """scores (N,) or (Q, N) f32 → (vals, ids int32) of shape (k,) or (Q, k),
    descending. Slots past the live elements (k > number of finite scores)
    return (-inf, N). Rows may be strided (``acc[:, :n_docs]``) as long as
    each row is contiguous."""
    if not backend.use_kernel(scores):
        return ref.topk_ref(scores, k)
    single = scores.dim() == 1
    s = scores.unsqueeze(0) if single else scores
    if s.dim() != 2 or s.dtype != torch.float32:
        raise ValueError(f"topk takes (N,) or (Q, N) float32, got {tuple(scores.shape)} {scores.dtype}")
    if s.stride(1) != 1 and s.shape[1] > 1:
        s = s.contiguous()
    Q, N = s.shape
    if Q > 65535:
        raise ValueError(f"topk launches one grid row per query: Q={Q} > 65535")
    chunk = max(chunk, k)          # a chunk must hold at least k survivors
    merge_chunk = max(chunk, 2 * k)
    if merge_chunk > MAX_CHUNK:
        raise ValueError(f"chunk {merge_chunk} exceeds shared memory ({MAX_CHUNK} f32)")
    with torch.cuda.device(s.device):
        vals, ids = _rounds(s, None, N, chunk, k, N)
        while vals.shape[1] > k:   # merge survivors until one chunk is left
            vals, ids = _rounds(vals, ids, vals.shape[1], merge_chunk, k, N)
    if single:
        return vals[0], ids[0]
    return vals, ids


topk.launches = 0
