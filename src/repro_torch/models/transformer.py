"""Decoder-only LM transformer, dense GQA: serving (prefill + ring-cache
decode) — the port of ``repro/models/transformer.py``.

Covers the reference's dense architectures (starcoder2, stablelm,
h2o-danube: ``moe=None, mla=None``): GQA or MHA, full or partial RoPE,
SwiGLU or GELU FFN, optional sliding window. Entry points:

* ``lm_forward`` — full-sequence logits;
* ``lm_prefill`` — prompt → (last-token logits, kv cache);
* ``lm_decode``  — one token against the cache → (logits, the cache).

Parameters live in an :class:`LM` module: the reference's tree with the
scanned ``layers`` axis sliced into a ``ModuleList``. ``lm_param_defs``
keeps the reference's tree, so counts and shapes compare leaf by leaf.

Caches keep the reference's layout, ``{"k", "v"}`` of shape
(L, B, Hkv, slots, Dh). A sliding-window model keeps a ring of ``window``
slots: position p lives in slot ``p % slots``. Every attention goes through
K5 (:func:`repro_torch.models.attention.attention`); decode is
``causal=False`` with ``kv_len`` only, since the ring is not in position
order. Decode writes the new token's k/v into the cache IN PLACE and
returns the same dict: the PyTorch idiom, where the reference returns a
new array.

MoE (``moe=``), MLA (``mla=``) and the training entry ``lm_loss`` are not
ported yet (ROADMAP Queue 1 item 9). ``remat``, ``remat_policy`` and
``unroll`` are accepted and change nothing, as there is no backward pass;
nor does ``attn_block_q``, the reference's chunked-attention block, as K5
keeps its own tiles.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
from torch import nn

from repro_torch.kernels.backend import resolve_device
from repro_torch.models.attention import attention
from repro_torch.models.common import (ParamDef, count_params, dense, gelu_mlp,
                                       gelu_mlp_defs, rms_norm, swiglu_mlp,
                                       swiglu_mlp_defs, tree_map)
from repro_torch.models.moe import MoEConfig
from repro_torch.models.rope import apply_rope


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    """DeepSeek-V2 multi-head latent attention dims."""

    q_lora: int = 1536
    kv_lora: int = 512
    rope_dim: int = 64
    nope_dim: int = 128
    v_dim: int = 128


@dataclasses.dataclass(frozen=True)
class LMConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int | None = None          # default d_model // n_heads
    rope_theta: float = 10000.0
    rope_pct: float = 1.0                # partial rotary (stablelm: 0.25)
    ffn_act: str = "swiglu"              # "swiglu" | "gelu" (starcoder2)
    window: int | None = None            # sliding-window attention (tokens)
    moe: MoEConfig | None = None
    mla: MLAConfig | None = None
    dtype: Any = torch.bfloat16
    remat: bool = True
    attn_block_q: int = 512
    moe_impl: str = "gspmd"              # "gspmd" | "ep" (shard_map EP)
    ep_batch_axes: tuple = ("data",)     # mesh batch axes for the EP path
    aux_loss_weight: float = 0.01
    unroll: bool = False                 # unroll scans (dry-run cost analysis)
    remat_policy: str = "nothing_saveable"   # | "dots_saveable" | "none"
    shard_kv_proj: bool = True           # False: replicate k/v projections

    @property
    def dh(self) -> int:
        return self.head_dim if self.head_dim is not None else self.d_model // self.n_heads

    @property
    def qk_dim(self) -> int:
        return (self.mla.nope_dim + self.mla.rope_dim) if self.mla else self.dh

    def param_count(self) -> int:
        return count_params(lm_param_defs(self))

    def active_param_count(self) -> int:
        return self.param_count()


def _dense_only(cfg: LMConfig) -> None:
    if cfg.mla is not None:
        raise NotImplementedError("MLA attention is not ported yet (ROADMAP Queue 1 item 9)")
    if cfg.moe is not None:
        raise NotImplementedError("the MoE FFN is not ported yet (ROADMAP Queue 1 item 9)")


# -- parameters ----------------------------------------------------------------


def _attn_defs(cfg: LMConfig) -> dict:
    d, H, Hkv, Dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.dh
    dt = cfg.dtype
    kv_ax = "heads" if cfg.shard_kv_proj else None
    return {
        "wq": ParamDef((d, H * Dh), ("embed", "heads"), dtype=dt),
        "wk": ParamDef((d, Hkv * Dh), ("embed", kv_ax), dtype=dt),
        "wv": ParamDef((d, Hkv * Dh), ("embed", kv_ax), dtype=dt),
        "wo": ParamDef((H * Dh, d), ("heads", "embed"), dtype=dt),
    }


def _layer_defs(cfg: LMConfig) -> dict:
    d, dt = cfg.d_model, cfg.dtype
    ffn = gelu_mlp_defs(d, cfg.d_ff, dt) if cfg.ffn_act == "gelu" else \
        swiglu_mlp_defs(d, cfg.d_ff, dt)
    return {
        "ln1": ParamDef((d,), ("embed",), init="ones", dtype=dt),
        "attn": _attn_defs(cfg),
        "ln2": ParamDef((d,), ("embed",), init="ones", dtype=dt),
        "ffn": ffn,
    }


def _stack_defs(defs: Any, n: int) -> Any:
    """Prepend the reference's scanned 'layers' axis to every ParamDef."""
    return tree_map(lambda p: ParamDef((n,) + p.shape, ("layers",) + p.axes,
                                       init=p.init, scale=p.scale, dtype=p.dtype), defs)


def lm_param_defs(cfg: LMConfig) -> dict:
    _dense_only(cfg)
    d, dt = cfg.d_model, cfg.dtype
    return {
        "embed": ParamDef((cfg.vocab, d), ("vocab", "embed"), init="embed", dtype=dt),
        "layers": _stack_defs(_layer_defs(cfg), cfg.n_layers),
        "ln_f": ParamDef((d,), ("embed",), init="ones", dtype=dt),
        "unembed": ParamDef((d, cfg.vocab), ("embed", "vocab"), dtype=dt),
    }


class Params(nn.Module):
    """A tree of tensors held as frozen parameters (nested trees as
    sub-modules), read as ``p["name"]`` like the reference's dicts."""

    def __init__(self, tree: dict):
        super().__init__()
        for name, value in tree.items():
            if isinstance(value, dict):
                self.add_module(name, Params(value))
            else:
                self.register_parameter(name, nn.Parameter(value, requires_grad=False))

    def __getitem__(self, name: str):
        return getattr(self, name)


class LM(nn.Module):
    """The model: ``embed``, a ``ModuleList`` of ``layers`` (each ``ln1``,
    ``attn``, ``ln2``, ``ffn``), ``ln_f`` and ``unembed``."""

    def __init__(self, tree: dict, cfg: LMConfig):
        super().__init__()
        _dense_only(cfg)
        self.cfg = cfg
        self.embed = nn.Parameter(tree["embed"], requires_grad=False)
        self.layers = nn.ModuleList(
            Params(tree_map(lambda t, i=i: t[i], tree["layers"])) for i in range(cfg.n_layers))
        self.ln_f = nn.Parameter(tree["ln_f"], requires_grad=False)
        self.unembed = nn.Parameter(tree["unembed"], requires_grad=False)

    @property
    def device(self) -> torch.device:
        return self.embed.device


# -- attention sublayers -----------------------------------------------------------


def _rope(x, positions, cfg: LMConfig):
    """RoPE over the first rope_pct fraction of the head dim (partial
    rotary, stablelm-style); the tail dims pass through."""
    D = x.shape[-1]
    rd = int(D * cfg.rope_pct)
    rd -= rd % 2
    if rd == D:
        return apply_rope(x, positions, theta=cfg.rope_theta)
    head = apply_rope(x[..., :rd], positions, theta=cfg.rope_theta)
    return torch.cat([head, x[..., rd:]], dim=-1)


def _qkv(p, x, cfg: LMConfig, positions):
    """Project and rotate: q (B,H,S,Dh), k and v (B,Hkv,S,Dh)."""
    B, S, _ = x.shape
    H, Hkv, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.dh
    q = dense(x, p["wq"]).reshape(B, S, H, Dh).transpose(1, 2)
    k = dense(x, p["wk"]).reshape(B, S, Hkv, Dh).transpose(1, 2)
    v = dense(x, p["wv"]).reshape(B, S, Hkv, Dh).transpose(1, 2)
    return _rope(q, positions, cfg), _rope(k, positions, cfg), v


def _out(p, o, cfg: LMConfig):
    B, H, S, Dh = o.shape
    return dense(o.transpose(1, 2).reshape(B, S, H * Dh), p["wo"])


def _gqa_attn(p, x, cfg: LMConfig, positions):
    """Causal GQA self-attention over x. Returns (out, (k, v)) — the new
    kv for the cache."""
    q, k, v = _qkv(p, x, cfg, positions)
    o = attention(q, k, v, causal=True, window=cfg.window)
    return _out(p, o, cfg), (k, v)


def _gqa_attn_decode_write(p, x, cfg: LMConfig, positions, k_cache, v_cache, slot: int,
                           kv_len: int):
    """Project one token's q/k/v, write k/v into cache slot ``slot`` in
    place, attend over the first ``kv_len`` slots."""
    q, k, v = _qkv(p, x, cfg, positions)
    k_cache[:, :, slot] = k[:, :, 0]
    v_cache[:, :, slot] = v[:, :, 0]
    o = attention(q, k_cache, v_cache, causal=False, kv_len=kv_len)
    return _out(p, o, cfg), (k_cache, v_cache)


# -- layer body ---------------------------------------------------------------------


def _ffn(p, x, cfg: LMConfig):
    if cfg.ffn_act == "gelu":
        return gelu_mlp(p, x)
    return swiglu_mlp(p, x)


def _layer(p, x, cfg: LMConfig, positions):
    """Pre-norm block. Returns (x, cache entry (k, v))."""
    a, entry = _gqa_attn(p["attn"], rms_norm(x, p["ln1"]), cfg, positions)
    x = x + a
    return x + _ffn(p["ffn"], rms_norm(x, p["ln2"]), cfg), entry


def _resolve(params: LM, cfg: LMConfig, tokens, device) -> tuple[torch.device, torch.Tensor]:
    """The entry points' ``device=``: ``None`` means the card (and raises
    without one). The model must already live there; tokens are moved."""
    _dense_only(cfg)
    dev = resolve_device(device)
    if params.device.type != dev.type:
        raise ValueError(f"the model lives on {params.device}, the call asked for {dev}")
    return params.device, torch.as_tensor(tokens).to(params.device, torch.long)


@torch.inference_mode()
def lm_forward(params: LM, tokens, cfg: LMConfig, *, positions=None, device=None):
    """tokens (B,S) int → (logits (B,S,V), aux scalar 0)."""
    dev, tokens = _resolve(params, cfg, tokens, device)
    S = tokens.shape[1]
    x = params.embed[tokens]                              # (B,S,d)
    if positions is None:
        positions = torch.arange(S, dtype=torch.int32, device=dev)
    for lp in params.layers:
        x, _ = _layer(lp, x, cfg, positions)
    logits = dense(rms_norm(x, params.ln_f), params.unembed)
    return logits, torch.zeros((), dtype=torch.float32, device=dev)


# -- serving: prefill + decode ------------------------------------------------------


def _cache_slots(cfg: LMConfig, max_len: int) -> int:
    return min(max_len, cfg.window) if cfg.window is not None else max_len


def make_cache(cfg: LMConfig, batch: int, max_len: int, *, device=None) -> dict:
    """Zero cache: k/v (L,B,Hkv,slots,Dh) in ``cfg.dtype``."""
    _dense_only(cfg)
    shape = (cfg.n_layers, batch, cfg.n_kv_heads, _cache_slots(cfg, max_len), cfg.dh)
    dev = resolve_device(device)
    return {"k": torch.zeros(shape, dtype=cfg.dtype, device=dev),
            "v": torch.zeros(shape, dtype=cfg.dtype, device=dev)}


def _ring(x, shift: int, axis: int):
    return torch.roll(x, shift, dims=axis) if shift else x


def _fit(x, slots: int, *, axis: int):
    """Pad (or keep) x so that the cache axis has exactly ``slots`` entries."""
    cur = x.shape[axis]
    if cur == slots:
        return x
    shape = list(x.shape)
    shape[axis] = slots - cur
    return torch.cat([x, x.new_zeros(shape)], dim=axis)


@torch.inference_mode()
def lm_prefill(params: LM, tokens, cfg: LMConfig, *, max_len: int, device=None):
    """tokens (B,S) → (last-token logits (B,V), cache filled to S).

    The cache keeps the last ``slots`` positions. Ring invariant shared
    with :func:`lm_decode`: position p lives at slot p % slots, which for
    the kept positions [S − take, S) is a circular roll by
    (S − take) % slots."""
    dev, tokens = _resolve(params, cfg, tokens, device)
    B, S = tokens.shape
    slots = _cache_slots(cfg, max_len)
    take = min(S, slots)
    shift = (S - take) % slots
    positions = torch.arange(S, dtype=torch.int32, device=dev)
    cache = make_cache(cfg, B, max_len, device=dev)
    x = params.embed[tokens]
    for i, lp in enumerate(params.layers):
        x, (k, v) = _layer(lp, x, cfg, positions)
        cache["k"][i] = _ring(_fit(k[:, :, S - take:], slots, axis=2), shift, 2)
        cache["v"][i] = _ring(_fit(v[:, :, S - take:], slots, axis=2), shift, 2)
    x = rms_norm(x[:, -1:], params.ln_f)
    return dense(x, params.unembed)[:, 0], cache


@torch.inference_mode()
def lm_decode(params: LM, cache: dict, token, pos, cfg: LMConfig, *, device=None):
    """One decode step: token (B,1) int; ``pos`` the host ``int`` position
    of ``token``. Returns (logits (B,V), cache), the cache updated in place.
    A ring cache wraps writes mod its slots; attention sees the first
    min(pos + 1, slots) slots. Nothing is read back from the card."""
    dev, token = _resolve(params, cfg, token, device)
    pos = int(pos)
    slots = cache["k"].shape[3]
    slot, kv_len = pos % slots, min(pos + 1, slots)
    positions = torch.arange(pos, pos + 1, dtype=torch.int32, device=dev)
    x = params.embed[token]                               # (B,1,d)
    # each layer writes its token's k/v into the slot *before* attending,
    # so the query sees itself; kv_len includes the slot
    for i, lp in enumerate(params.layers):
        a, _ = _gqa_attn_decode_write(lp["attn"], rms_norm(x, lp["ln1"]), cfg, positions,
                                      cache["k"][i], cache["v"][i], slot, kv_len)
        x = x + a
        x = x + _ffn(lp["ffn"], rms_norm(x, lp["ln2"]), cfg)
    x = rms_norm(x, params.ln_f)
    return dense(x, params.unembed)[:, 0], cache
