"""K5: FlashAttention forward — wrapper of ``csrc/flash_attention.cu`` (f32)
and ``csrc/flash_attention_bf16.cu`` (bf16), the port of
``repro/kernels/flash_attention.py``.

    q (B,Hq,Sq,D), k (B,Hkv,Skv,D), v (B,Hkv,Skv,Dv) → (B,Hq,Sq,Dv)
    return_lse=True → (out, lse (B,Hq,Sq) f32)

Online-softmax attention with causal masking, GQA (the G = Hq/Hkv query
heads of a kv head folded into rows), a sliding window and ``kv_len``
masking, queries at the end of the kv axis; f32 running max, denominator
and accumulator; bf16 or f32 in, q's dtype out. Dv may differ from D. A
row that sees no key is 0.

``return_lse=True`` also returns each row's log-sum-exp of its visible
scaled scores, ``m + log(l)`` in the natural log from the kernel's own
running max m and denominator l, −inf for a row that sees no key: what a
caller needs to merge attention over disjoint key sets (the sequence-sharded
decode of :mod:`repro_torch.models.transformer`). Every variant writes it
from the state it already keeps, into an f32 buffer the wrapper passes; with
``return_lse=False`` the buffer is null and the kernels do what they did
before, bit for bit, in the same launches. ``"simt"``'s lse equals the
twin's bit for bit; the bf16 variants' is held to :data:`LSE_TOL`.

Three hand kernels; :func:`variant` picks one from the dtype and the
folded rows G·Sq:

* ``"simt"`` — f32, any shape: the CUDA cores, every sum in the twin's
  order, so it equals :func:`ref.flash_attention_ref` bit for bit. Two
  paths, :func:`simt_path` from the shape: ``"short"`` (all keys in one
  64-key tile, at most 256 folded rows, head dims at most 32: one thread a
  row, many (batch, kv head)s a block — bst's encoder) and ``"tiled"``
  (the rest: a 256-thread block a tile of rows, 64-key tiles by
  ``cp.async`` — bert4rec's encoder, the LM's f32 check and decode);
  ``launches_by_path`` counts them;
* ``"tc"`` — bf16 with more than ``DECODE_ROWS`` folded rows (prefill):
  ``mma.sync`` on the tensor cores, K/V tiles by ``cp.async``;
* ``"split"`` — bf16 with at most ``DECODE_ROWS`` folded rows (decode):
  the kv axis in splits of :func:`split_plan`'s keys, one block each that
  streams its split a 128-key tile at a time through ``mma.sync``, then a
  second launch merges the splits' (m, l, acc) in split order.

The bf16 kernels sum in other orders than the twin and round P to bf16, so
they are held to a tolerance; :func:`ref.flash_attention_split_ref` is the
split-KV algorithm in plain PyTorch.

``kv_len`` is a host ``int``, as it is static in the Pallas kernel: decode
passes ``min(pos + 1, slots)`` without reading anything back from the card.
Tile sizes are the kernels' own; ``block_q``/``block_k`` are the
reference's knobs and are not taken.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.kernels import backend, ref

MAX_HEAD_DIM = 256      # the kernels stage K and V rows of at most 256 in shared memory
DECODE_ROWS = 16        # folded rows a split-KV block serves
SPLIT_TILE = 128        # keys a split-KV block stages at a time
SPLIT_BLOCKS = 264      # split-KV blocks that fill an H100 once: two on each of 132 SMs
VARIANTS = ("tc", "split", "simt")
SIMT_PATHS = ("short", "tiled")
SHORT_KEYS = ref.FLASH_BK   # the short path's keys: one tile, so no online rescale
SHORT_ROWS = 256        # folded rows a short block's threads hold, one a thread
SHORT_HEAD_DIM = 32     # D and Dv a short thread keeps in registers
# |lse - twin| <= LSE_TOL * max(1, |twin|) for the bf16 variants: their l is an
# f32 sum of ex2.approx terms (2^-22 each) over scores the tensor cores sum in
# f32, so lse is an f32-grade quantity (nothing in it is rounded to bf16);
# 2^-12 leaves room for the summation over 32k keys (n * 2^-24 at worst).
LSE_TOL = 2.0 ** -12


def variant(dtype: torch.dtype, rows: int) -> str:
    """The kernel a call takes, from q's dtype and its folded rows G·Sq."""
    if dtype == torch.float32:
        return "simt"
    if dtype == torch.bfloat16:
        return "split" if rows <= DECODE_ROWS else "tc"
    raise ValueError(f"flash_attention takes f32 or bf16, got {dtype}")


def simt_path(rows: int, Skv: int, D: int, Dv: int) -> str:
    """The f32 kernel's path from the shape: ``"short"`` when every key
    lies in one tile, the folded rows G·Sq fit one thread each in a block
    and a q row and an output row fit a thread's registers; else
    ``"tiled"``."""
    if Skv <= SHORT_KEYS and rows <= SHORT_ROWS and max(D, Dv) <= SHORT_HEAD_DIM:
        return "short"
    return "tiled"


def split_plan(bh: int, Sq: int, Skv: int, *, window: "int | None",
               kv_end: int) -> tuple[int, int, int]:
    """(first key, keys a split, splits) of a split-KV call: the keys some
    row may see, [k_lo, kv_end) (the last row sits at Skv − 1, so only the
    window cuts the front), cut into splits of whole ``SPLIT_TILE`` tiles,
    as few tiles a split as keep the ``bh`` heads' splits within one wave
    of ``SPLIT_BLOCKS`` blocks (4 tiles, 512 keys, for the LM's 32 heads
    over 4,096 slots); no split when nothing is visible."""
    k_lo = max(0, Skv - Sq - window + 1) if window is not None else 0
    tiles = max(0, -(-(kv_end - k_lo) // SPLIT_TILE))
    per = max(1, -(-(tiles * bh) // SPLIT_BLOCKS))
    return k_lo, SPLIT_TILE * per, -(-tiles // per)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = False, window: "int | None" = None,
                    kv_len: "int | None" = None, sm_scale: "float | None" = None,
                    return_lse: bool = False):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}")
    B, Hq, Sq, D = q.shape
    _, Hkv, Skv, _ = k.shape
    Dv = v.shape[-1]
    if (k.shape[0] != B or k.shape[3] != D or v.shape[:3] != k.shape[:3]
            or Hkv == 0 or Hq % Hkv):
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}")
    if window is not None and window <= 0:
        raise ValueError(f"window={window} must be positive")
    if kv_len is not None:
        kv_len = int(kv_len)
    where = backend.route(q, k, v)
    if where == "meta":
        return _meta(q, k, v, causal=causal, window=window, kv_len=kv_len,
                     return_lse=return_lse)
    if where == "cpu":
        return ref.flash_attention_ref(q, k, v, causal=causal, window=window, kv_len=kv_len,
                                       sm_scale=sm_scale, return_lse=return_lse)
    backend.refuse_grad("flash_attention", q, k, v)
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"flash_attention takes f32 or bf16 alike, got "
                         f"{q.dtype}/{k.dtype}/{v.dtype}")
    if D > MAX_HEAD_DIM or Dv > MAX_HEAD_DIM:
        raise ValueError(f"D={D}, Dv={Dv}: at most {MAX_HEAD_DIM}")
    G = Hq // Hkv
    BH, rows = B * Hkv, G * Sq
    kind = variant(q.dtype, rows)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    out = torch.empty(B, Hq, Sq, Dv, dtype=q.dtype, device=q.device)
    lse = torch.empty(B, Hq, Sq, dtype=torch.float32, device=q.device) if return_lse else None
    lse_ptr = lse.data_ptr() if return_lse else None
    scale = sm_scale if sm_scale is not None else float(D) ** -0.5
    kv_end = Skv if kv_len is None else max(0, min(kv_len, Skv))
    with torch.cuda.device(q.device):
        if kind == "simt":
            path = simt_path(rows, Skv, D, Dv)
            lib = backend.library("flash_attention")
            err = lib.flash_attention_launch(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse_ptr, BH, rows, Sq,
                Skv, D, Dv, int(causal), window or 0, kv_end, SIMT_PATHS.index(path),
                backend.f32(scale), backend.stream(q))
            name = "flash_attention_launch"
        elif kind == "tc":
            lib = backend.library("flash_attention_bf16")
            err = lib.flash_attention_tc_launch(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse_ptr, BH, rows, Sq,
                Skv, D, Dv, int(causal), window or 0, kv_end,
                backend.f32(backend.f32(scale) * math.log2(math.e)), backend.stream(q))
            name = "flash_attention_tc_launch"
        else:
            k_begin, split, n_split = split_plan(BH, Sq, Skv, window=window, kv_end=kv_end)
            # the splits' partials: acc (BH, n_split, rows, Dv), then (m, l) per row
            n_part = BH * n_split * rows
            part = torch.empty(max(1, n_part * (Dv + 2)), dtype=torch.float32, device=q.device)
            lib = backend.library("flash_attention_bf16")
            err = lib.flash_attention_split_launch(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse_ptr, part.data_ptr(),
                part.data_ptr() + 4 * n_part * Dv, BH, n_split, split, rows, Sq, Skv, D, Dv,
                int(causal),
                window or 0, k_begin, kv_end,
                backend.f32(backend.f32(scale) * math.log2(math.e)), backend.stream(q))
            name = "flash_attention_split_launch"
    backend.check(lib, err, name)
    flash_attention.launches += 1
    flash_attention.launches_by[kind] += 1
    if kind == "simt":
        flash_attention.launches_by_path[path] += 1
    return (out, lse) if return_lse else out


def visible_pairs(Sq: int, Skv: int, *, causal: bool, window: "int | None",
                  kv_len: "int | None") -> int:
    """The (query, key) pairs one (batch, head) attends: the queries sit at
    the end of the kv axis; causal, the window and ``kv_len`` cut the keys."""
    kv_end = Skv if kv_len is None else max(0, min(kv_len, Skv))
    pos = np.arange(Sq, dtype=np.int64) + (Skv - Sq)
    hi = np.minimum(pos + 1, kv_end) if causal else np.full(Sq, kv_end)
    lo = np.maximum(pos - window + 1, 0) if window is not None else 0
    return int(np.maximum(hi - lo, 0).sum())


def _meta(q, k, v, *, causal, window, kv_len, return_lse=False):
    """Shape rule: (B, Hq, Sq, ·) q, (…, Dv) v → (B, Hq, Sq, Dv) in q's
    dtype, and with ``return_lse`` the (B, Hq, Sq) f32 lse. Cost: q, k, v
    read and the outputs written once; a multiply and an add a (visible
    pair, d) for QKᵀ and for PV."""
    B, Hq, Sq, D = q.shape
    Dv = v.shape[-1]
    pairs = B * Hq * visible_pairs(Sq, k.shape[2], causal=causal, window=window, kv_len=kv_len)
    size = q.element_size()
    out = backend.meta_empty(B, Hq, Sq, Dv, dtype=q.dtype)
    if return_lse:
        out = (out, backend.meta_empty(B, Hq, Sq, dtype=torch.float32))
    return backend.meta_result(
        "flash_attention", out, flops=2 * (D + Dv) * pairs,
        nbytes=size * (q.numel() + k.numel() + v.numel() + B * Hq * Sq * Dv)
        + 4 * B * Hq * Sq * return_lse)


flash_attention.launches = 0
flash_attention.launches_by = dict.fromkeys(VARIANTS, 0)
flash_attention.launches_by_path = dict.fromkeys(SIMT_PATHS, 0)
