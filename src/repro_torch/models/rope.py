"""Rotary position embeddings (RoPE), GPT-NeoX halves — the port of
``repro/models/rope.py``."""

from __future__ import annotations

import torch


def rope_freqs(dim: int, *, theta: float = 10000.0, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim))


def apply_rope(x, positions, *, theta: float = 10000.0):
    """x (..., S, D) with D even; positions (S,) int on x's device."""
    D = x.shape[-1]
    freqs = rope_freqs(D, theta=theta, device=x.device)          # (D/2,)
    ang = positions[:, None].float() * freqs[None, :]            # (S, D/2)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., : D // 2], x[..., D // 2:]
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    return torch.cat([y1, y2], dim=-1).to(x.dtype)
