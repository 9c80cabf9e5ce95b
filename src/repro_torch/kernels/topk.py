"""K2: chunked top-k over long score rows — wrapper of ``csrc/topk.cu``.

The port of ``repro/kernels/topk.py``. Phase 1 takes each chunk's local
top-k: a floor that k elements reach (the k-th largest of the threads'
maxima), then the few elements above it ranked against each other or
radix-selected over order-preserving keys (``csrc/select.cuh``), the k
survivors ordered by (value desc, index asc). Phase 2 merges the
``n_chunks·k`` survivors with the same kernel, whose position order among
equal values is id order, so ties resolve to the lowest id exactly like
``lax.top_k``. Non-live slots come back as ``(-inf, N)``. Rows are a
leading Q dimension: one launch serves a whole micro-batch.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import backend, ref

DEFAULT_CHUNK = 8192      # scores a block takes: 32 per thread, held in registers
MAX_SMEM = 227 * 1024     # bytes of shared memory one block may take


def order_keys(scores: torch.Tensor) -> torch.Tensor:
    """The select's 32-bit keys (as int64, ≥ 0) of float32 ``scores``: key
    order is float order, and -0.0 keys as +0.0 so that the two zeros tie
    (``order_key`` in ``csrc/select.cuh``)."""
    bits = scores.contiguous().view(torch.int32).long() & 0xFFFFFFFF
    bits = torch.where(bits == 0x80000000, 0, bits)
    return torch.where(bits >= 0x80000000, bits ^ 0xFFFFFFFF, bits | 0x80000000)


def _select(scores: torch.Tensor, ids_in: "torch.Tensor | None", n: int,
            chunk: int, k: int, n_live: int):
    """One launch: the per-chunk top-k of the first ``n`` entries of every
    row. Returns survivors (Q, n_chunks·k) vals and ids."""
    lib = backend.library("topk")
    if lib.topk_smem_bytes(chunk, k) > MAX_SMEM:
        raise ValueError(f"chunk {chunk} and k {k} exceed one block's shared memory")
    Q = scores.shape[0]
    n_chunks = max(1, -(-n // chunk))
    vals = torch.empty(Q, n_chunks * k, dtype=torch.float32, device=scores.device)
    ids = torch.empty(Q, n_chunks * k, dtype=torch.int32, device=scores.device)
    err = lib.topk_select_launch(
        scores.data_ptr(), ids_in.data_ptr() if ids_in is not None else None,
        scores.stride(0), n, Q, chunk, k, n_live, vals.data_ptr(), ids.data_ptr(),
        backend.stream(scores))
    backend.check(lib, err, "topk_select_launch")
    topk.launches += 1
    return vals, ids


def topk(scores: torch.Tensor, k: int, *, chunk: int = DEFAULT_CHUNK):
    """scores (N,) or (Q, N) f32 → (vals, ids int32) of shape (k,) or (Q, k),
    descending. Slots past the live elements (k > number of finite scores)
    return (-inf, N). Rows may be strided (``acc[:, :n_docs]``) as long as
    each row is contiguous."""
    where = backend.route(scores)
    if where == "meta":
        return _meta(scores, k)
    if where == "cpu":
        return ref.topk_ref(scores, k)
    backend.refuse_grad("topk", scores)
    single = scores.dim() == 1
    s = scores.unsqueeze(0) if single else scores
    if s.dim() != 2 or s.dtype != torch.float32:
        raise ValueError(f"topk takes (N,) or (Q, N) float32, got {tuple(scores.shape)} {scores.dtype}")
    if s.stride(1) != 1 and s.shape[1] > 1:
        s = s.contiguous()
    Q, N = s.shape
    chunk = max(chunk, k)          # a chunk must hold at least k survivors
    with torch.cuda.device(s.device):
        vals, ids = _select(s, None, N, chunk, k, N)
        vals, ids = merge(vals, ids, k, N, chunk=chunk)
    if single:
        return vals[0], ids[0]
    return vals, ids


def _meta(scores: torch.Tensor, k: int):
    """Shape rule: (..., N) f32 → (..., k) f32 vals, (..., k) int32 ids,
    whatever N (k > N pads). Cost: the N scores of each row read and k
    (value, id) pairs written; one comparison a score."""
    N = scores.shape[-1]
    rows = scores.numel() // max(N, 1)
    lead = tuple(scores.shape[:-1])
    return backend.meta_result(
        "topk", (backend.meta_empty(*lead, k, dtype=torch.float32),
                 backend.meta_empty(*lead, k, dtype=torch.int32)),
        flops=scores.numel(), nbytes=scores.numel() * 4 + rows * k * 8)


def merge(vals: torch.Tensor, ids: torch.Tensor, k: int, n_live: int, *,
          chunk: int = DEFAULT_CHUNK):
    """Survivors (Q, S) f32 values and int32 ids on the card, each chunk's
    in descending order and chunks in id order → the (Q, k) top k, ties to
    the lowest id, -inf slots as (-inf, ``n_live``). K2's kernel over the
    survivors, again until exactly k columns are left (fewer than k are
    padded with -inf); K4 merges through it too."""
    backend.refuse_grad("topk", vals)
    chunk = max(chunk, 2 * k)
    while vals.shape[1] != k:
        vals, ids = _select(vals, ids, vals.shape[1], chunk, k, n_live)
    return vals, ids


topk.launches = 0
