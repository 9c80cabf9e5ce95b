"""K5: FlashAttention forward — wrapper of ``csrc/flash_attention.cu``, the
port of ``repro/kernels/flash_attention.py``.

    q (B,Hq,Sq,D), k (B,Hkv,Skv,D), v (B,Hkv,Skv,Dv) → (B,Hq,Sq,Dv)

Online-softmax attention with causal masking, GQA (the G = Hq/Hkv query
heads of a kv head folded into rows), a sliding window and ``kv_len``
masking, queries at the end of the kv axis; f32 running max, denominator
and accumulator; bf16 or f32 in, q's dtype out. Dv may differ from D. A
row that sees no key is 0.

``kv_len`` is a host ``int``, as it is static in the Pallas kernel: decode
passes ``min(pos + 1, slots)`` without reading anything back from the card.
Tile sizes are the kernel's own (64 keys; 4, 16 or 64 rows a block);
``block_q``/``block_k`` are the reference's knobs and are not taken.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import backend, ref

MAX_HEAD_DIM = 256      # shared memory holds the Q tile, a K and a V tile in f32


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = False, window: "int | None" = None,
                    kv_len: "int | None" = None,
                    sm_scale: "float | None" = None) -> torch.Tensor:
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
    if not backend.use_kernel(q, k, v):
        return ref.flash_attention_ref(q, k, v, causal=causal, window=window, kv_len=kv_len,
                                       sm_scale=sm_scale)
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"flash_attention takes f32 or bf16 alike, got "
                         f"{q.dtype}/{k.dtype}/{v.dtype}")
    if D > MAX_HEAD_DIM or Dv > MAX_HEAD_DIM or B * Hkv > 65535:
        raise ValueError(f"D={D}, Dv={Dv} (at most {MAX_HEAD_DIM}), B·Hkv={B * Hkv}")
    G = Hq // Hkv
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    out = torch.empty(B, Hq, Sq, Dv, dtype=q.dtype, device=q.device)
    scale = sm_scale if sm_scale is not None else float(D) ** -0.5
    lib = backend.library("flash_attention")
    with torch.cuda.device(q.device):
        err = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B * Hkv, G * Sq, Sq,
            Skv, D, Dv, int(causal), window or 0, Skv if kv_len is None else min(kv_len, Skv),
            backend.f32(scale), int(q.dtype == torch.bfloat16), backend.stream(q))
    backend.check(lib, err, "flash_attention_launch")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
