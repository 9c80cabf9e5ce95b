"""Attention: K5 (the default) and the chunked plain path — the port of
``repro/models/attention.py``.

Conventions as the reference's: q (B,Hq,Sq,D), k/v (B,Hkv,Skv,D|Dv), GQA
via Hq % Hkv == 0; queries occupy the LAST Sq positions of the kv axis
(prefill Sq == Skv, decode Sq == 1); ``window`` = sliding-window size;
``kv_len`` masks a partly filled cache.

One deliberate difference: the reference's default is ``impl="chunked"``,
and its Pallas kernel runs only when a caller asks for ``impl="pallas"``,
which its transformer never does; the port has no ``"pallas"``. Here ``attention()`` with no ``impl``
goes through :mod:`repro_torch.kernels.flash_attention` — K5 on a CUDA
tensor, its plain twin on a CPU tensor — so the LM path on the card runs
the hand kernel. ``impl="chunked"`` is the plain path, on request.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.ref import attention_mask


def chunked_attention(q, k, v, *, causal=False, window=None, kv_len=None,
                      sm_scale=None, block_q: int = 512, unroll: bool = False):
    """Attention one block of ``block_q`` queries at a time: O(bq·Skv)
    score memory. v may have another head dim than q/k. ``unroll`` is the
    reference's dry-run knob and changes nothing here."""
    B, Hq, Sq, D = q.shape
    _, Hkv, Skv, _ = k.shape
    Dv = v.shape[-1]
    G = Hq // Hkv
    scale = sm_scale if sm_scale is not None else float(D) ** -0.5
    qg = q.reshape(B, Hkv, G, Sq, D)
    bq = min(block_q, Sq)
    if Sq % bq:
        bq = Sq
    kpos = torch.arange(Skv, device=q.device)
    k32, v32 = k.float(), v.float()
    outs = []
    for qi in range(Sq // bq):
        qb = qg[:, :, :, qi * bq:(qi + 1) * bq]
        s = torch.einsum("bhgqd,bhkd->bhgqk", qb.float(), k32) * scale
        qpos = qi * bq + torch.arange(bq, device=q.device) + (Skv - Sq)
        m = attention_mask(qpos, kpos, causal=causal, window=window,
                           kv_len=Skv if kv_len is None else kv_len)
        s = torch.where(m, s, float("-inf"))
        mx = s.amax(dim=-1, keepdim=True)
        mx_safe = torch.where(torch.isfinite(mx), mx, 0.0)
        p = torch.where(m, torch.exp(s - mx_safe), 0.0)
        l = p.sum(dim=-1, keepdim=True)
        o = torch.einsum("bhgqk,bhkd->bhgqd", p, v32)
        outs.append(torch.where(l > 0, o / l, 0.0))
    out = torch.cat(outs, dim=3)
    return out.reshape(B, Hq, Sq, Dv).to(q.dtype)


def attention(q, k, v, *, impl: "str | None" = None, **kw):
    """``impl=None``: K5 or its twin, by the tensors' device;
    ``"chunked"``: :func:`chunked_attention` (which alone takes
    ``block_q``)."""
    if impl is None:
        return flash_attention(q, k, v, **kw)
    if impl == "chunked":
        return chunked_attention(q, k, v, **kw)
    raise ValueError(f"unknown attention impl {impl!r}")
