"""Decoder-only LM transformer: GQA / RoPE / SWA / MoE / MLA serving
(prefill + ring-cache decode) — the port of ``repro/models/transformer.py``.

One definition covers the reference's LM architectures:

* dense GQA (starcoder2, stablelm, h2o-danube) — ``moe=None, mla=None``:
  GQA or MHA, full or partial RoPE, SwiGLU or GELU FFN, optional sliding
  window;
* MoE (olmoe: 64e top-8) — ``moe=MoEConfig(...)``, dispatched by
  ``moe_impl``: ``"gspmd"`` the global :func:`~repro_torch.models.moe.moe_ffn`,
  ``"ep"`` the expert-parallel :func:`~repro_torch.models.moe_ep.ep_moe_ffn`
  on the ambient mesh (``parallel.compat.use_mesh``);
* MLA + MoE (deepseek-v2: kv_lora 512, 160e top-6 + 2 shared) — ``mla=...``.

Entry points:

* ``lm_loss``    — causal-LM cross entropy, the train step's body;
* ``lm_forward`` — full-sequence logits and the sum of the layers' MoE aux
  losses;
* ``lm_prefill`` — prompt → (last-token logits, kv cache);
* ``lm_decode``  — one token against the cache → (logits, the cache).

Parameters live in an :class:`LM` module: the reference's tree with the
scanned ``layers`` axis sliced into a ``ModuleList``. ``lm_param_defs``
keeps the reference's tree, so counts and shapes compare leaf by leaf.

Caches keep the reference's layout: GQA ``{"k", "v"}`` of shape
(L, B, Hkv, slots, Dh); MLA the *latent*, ``{"ckv"}`` (L, B, slots,
kv_lora) and the shared rope key ``{"krope"}`` (L, B, slots, rope_dim) —
the compressed KV of DeepSeek-V2. A sliding-window model keeps a ring of
``window`` slots: position p lives in slot ``p % slots``. GQA attention and
MLA's prefill attention (qk dim 192, v dim 128) go through K5
(:func:`repro_torch.models.attention.attention`); GQA decode is
``causal=False`` with ``kv_len`` only, since the ring is not in position
order. MLA decode uses weight absorption (w_kv_b folded into the query and
output projections) so the latent is never re-expanded; it is plain torch
with f32 scores and softmax, as the reference's, which reaches no Pallas
kernel there. Decode writes the new token's k/v (or latent) into the cache
IN PLACE and returns the same dict: the PyTorch idiom, where the reference
returns a new array.

Training and serving share one layer body (``_layer``) and part at the
attention: the serving entries run under ``torch.inference_mode()`` on K5,
which has no backward; ``lm_loss`` takes the parameters as the reference's
tree (the ``layers`` axis stacked, leaves that require grad), runs the
plain ``impl="chunked"`` attention in blocks of ``attn_block_q`` queries —
the reference's training path, which never reaches its Pallas kernel — and
gathers the token embeddings with :func:`~repro_torch.models.gather.gather_rows`,
whose backward sums in a fixed order. ``remat`` and ``remat_policy``
recompute each layer in the backward pass (``_maybe_remat``). ``unroll``
is the reference's dry-run knob and changes nothing here.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch
from torch import nn

from repro_torch.kernels.backend import resolve_device
from repro_torch.models.attention import attention
from repro_torch.models.common import (ParamDef, count_params, dense, gelu_mlp,
                                       gelu_mlp_defs, remat, rms_norm, swiglu_mlp,
                                       swiglu_mlp_defs, tree_map, unstack_layers)
from repro_torch.models.gather import gather_rows
from repro_torch.models.moe import MoEConfig, moe_defs, moe_ffn
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
        """Params touched per token (MoE: top-k + shared experts only)."""
        if self.moe is None:
            return self.param_count()
        cfg = self.moe
        per_expert = 3 * cfg.d_model * cfg.d_ff
        inactive = (cfg.n_experts - cfg.top_k) * per_expert * self.n_layers
        return self.param_count() - inactive


# -- parameters ----------------------------------------------------------------


def _attn_defs(cfg: LMConfig) -> dict:
    d, H, Hkv, Dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.dh
    dt = cfg.dtype
    if cfg.mla is not None:
        m = cfg.mla
        return {
            "wq_a": ParamDef((d, m.q_lora), ("embed", None), dtype=dt),
            "q_norm": ParamDef((m.q_lora,), (None,), init="ones", dtype=dt),
            "wq_b": ParamDef((m.q_lora, H * (m.nope_dim + m.rope_dim)),
                             (None, "heads"), dtype=dt),
            "wkv_a": ParamDef((d, m.kv_lora + m.rope_dim), ("embed", None), dtype=dt),
            "kv_norm": ParamDef((m.kv_lora,), (None,), init="ones", dtype=dt),
            "wkv_b": ParamDef((m.kv_lora, H * (m.nope_dim + m.v_dim)),
                              (None, "heads"), dtype=dt),
            "wo": ParamDef((H * m.v_dim, d), ("heads", "embed"), dtype=dt),
        }
    kv_ax = "heads" if cfg.shard_kv_proj else None
    return {
        "wq": ParamDef((d, H * Dh), ("embed", "heads"), dtype=dt),
        "wk": ParamDef((d, Hkv * Dh), ("embed", kv_ax), dtype=dt),
        "wv": ParamDef((d, Hkv * Dh), ("embed", kv_ax), dtype=dt),
        "wo": ParamDef((H * Dh, d), ("heads", "embed"), dtype=dt),
    }


def _layer_defs(cfg: LMConfig) -> dict:
    d, dt = cfg.d_model, cfg.dtype
    if cfg.moe is not None:
        ffn = moe_defs(cfg.moe, dt)
    elif cfg.ffn_act == "gelu":
        ffn = gelu_mlp_defs(d, cfg.d_ff, dt)
    else:
        ffn = swiglu_mlp_defs(d, cfg.d_ff, dt)
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

    def __contains__(self, name: str) -> bool:
        return name in self._parameters or name in self._modules


class LM(nn.Module):
    """The model: ``embed``, a ``ModuleList`` of ``layers`` (each ``ln1``,
    ``attn``, ``ln2``, ``ffn``), ``ln_f`` and ``unembed``."""

    def __init__(self, tree: dict, cfg: LMConfig):
        super().__init__()
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


def _attn_kw(cfg: LMConfig, impl: "str | None") -> dict:
    """``attention``'s implementation: K5 (``None``) or the chunked plain
    path in blocks of ``cfg.attn_block_q`` queries."""
    return {} if impl is None else {"impl": impl, "block_q": cfg.attn_block_q}


def _gqa_attn(p, x, cfg: LMConfig, positions, impl=None):
    """Causal GQA self-attention over x. Returns (out, (k, v)) — the new
    kv for the cache."""
    q, k, v = _qkv(p, x, cfg, positions)
    o = attention(q, k, v, causal=True, window=cfg.window, **_attn_kw(cfg, impl))
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


def _mla_qkv(p, x, cfg: LMConfig, positions):
    """MLA projections. Returns (q_nope, q_rope, c_kv, k_rope).

    q_nope (B,H,S,nope), q_rope (B,H,S,rope), c_kv (B,S,kv_lora) latent,
    k_rope (B,S,rope) shared-across-heads rope key.
    """
    m = cfg.mla
    B, S, _ = x.shape
    H = cfg.n_heads
    cq = rms_norm(dense(x, p["wq_a"]), p["q_norm"])
    q = dense(cq, p["wq_b"]).reshape(B, S, H, m.nope_dim + m.rope_dim).transpose(1, 2)
    q_nope, q_rope = q[..., :m.nope_dim], q[..., m.nope_dim:]
    q_rope = apply_rope(q_rope, positions, theta=cfg.rope_theta)

    ckv = dense(x, p["wkv_a"])                             # (B,S,kv_lora+rope)
    c_kv = rms_norm(ckv[..., :m.kv_lora], p["kv_norm"])
    k_rope = apply_rope(ckv[..., m.kv_lora:], positions, theta=cfg.rope_theta)
    return q_nope, q_rope, c_kv, k_rope


def _mla_attn_full(p, x, cfg: LMConfig, positions, impl=None):
    """MLA self-attention (prefill): the latent expanded per head, then K5
    at qk dim nope + rope and v dim v_dim."""
    m = cfg.mla
    B, S, _ = x.shape
    H = cfg.n_heads
    q_nope, q_rope, c_kv, k_rope = _mla_qkv(p, x, cfg, positions)
    kv = dense(c_kv, p["wkv_b"]).reshape(B, S, H, m.nope_dim + m.v_dim).transpose(1, 2)
    k_nope, v = kv[..., :m.nope_dim], kv[..., m.nope_dim:]
    k = torch.cat([k_nope, k_rope[:, None].expand(B, H, S, m.rope_dim)], dim=-1)
    q = torch.cat([q_nope, q_rope], dim=-1)
    scale = 1.0 / math.sqrt(m.nope_dim + m.rope_dim)
    o = attention(q, k, v, causal=True, sm_scale=scale,
                  **_attn_kw(cfg, impl))                 # (B,H,S,v_dim)
    return _out(p, o, cfg), (c_kv, k_rope)


def _mla_attn_core(p, q_nope, q_rope, cache, kv_len: int, cfg: LMConfig):
    """MLA decode attention with weight absorption: the latent cache is
    attended *directly* — w_kv_b's k-half folds into q, its v-half into the
    output — so per-step FLOPs/bytes scale with kv_lora, not H·Dh
    (DeepSeek-V2 §2.1). f32 scores and softmax over the first ``kv_len``
    slots, a row that sees none 0. Returns the attention output
    (B,S,H·v_dim)@wo."""
    m = cfg.mla
    B, H, S, _ = q_nope.shape                              # S == 1
    c_cache, r_cache = cache                               # (B,Sc,kv_lora),(B,Sc,rope)

    wkv_b = p["wkv_b"].reshape(m.kv_lora, H, m.nope_dim + m.v_dim)
    wk = wkv_b[..., :m.nope_dim]                           # (kv_lora,H,nope)
    wv = wkv_b[..., m.nope_dim:]                           # (kv_lora,H,v)

    # absorb: q_lat = q_nope @ wk^T  → (B,H,S,kv_lora)
    q_lat = torch.einsum("bhsn,lhn->bhsl", q_nope, wk)
    scale = 1.0 / math.sqrt(m.nope_dim + m.rope_dim)
    c32 = c_cache.float()
    s_lat = torch.einsum("bhsl,bcl->bhsc", q_lat.float(), c32)
    s_rope = torch.einsum("bhsr,bcr->bhsc", q_rope.float(), r_cache.float())
    s = (s_lat + s_rope) * scale                           # (B,H,S,Sc)
    Sc = c_cache.shape[1]
    mask = torch.arange(Sc, device=s.device) < kv_len
    s = torch.where(mask, s, float("-inf"))
    pr = torch.softmax(s, dim=-1)
    pr = torch.where(torch.isnan(pr), 0.0, pr)
    o_lat = torch.einsum("bhsc,bcl->bhsl", pr, c32)
    o = torch.einsum("bhsl,lhv->bhsv", o_lat.to(q_nope.dtype), wv)
    return _out(p, o, cfg)


def _mla_attn_decode(p, x, cfg: LMConfig, positions, cache, kv_len: int):
    """Convenience: project one token then attend against the latent cache."""
    q_nope, q_rope, c_kv_new, k_rope_new = _mla_qkv(p, x, cfg, positions)
    o = _mla_attn_core(p, q_nope, q_rope, cache, kv_len, cfg)
    return o, (c_kv_new, k_rope_new)


# -- layer body ---------------------------------------------------------------------


def _ffn(p, x, cfg: LMConfig):
    """The FFN sublayer: (y, MoE aux loss; 0 for a dense FFN)."""
    if cfg.moe is not None:
        if cfg.moe_impl == "ep":
            from repro_torch.models.moe_ep import ep_moe_ffn
            return ep_moe_ffn(p, x, cfg.moe, batch_axes=tuple(cfg.ep_batch_axes))
        return moe_ffn(p, x, cfg.moe)
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    if cfg.ffn_act == "gelu":
        return gelu_mlp(p, x), zero
    return swiglu_mlp(p, x), zero


def _layer(p, x, cfg: LMConfig, positions, impl=None):
    """Pre-norm block. Returns (x, aux, cache entry: (k, v), or the MLA
    latent (c_kv, k_rope)). ``impl``: the attention's (None: K5)."""
    h = rms_norm(x, p["ln1"])
    if cfg.mla is not None:
        a, entry = _mla_attn_full(p["attn"], h, cfg, positions, impl)
    else:
        a, entry = _gqa_attn(p["attn"], h, cfg, positions, impl)
    x = x + a
    f, aux = _ffn(p["ffn"], rms_norm(x, p["ln2"]), cfg)
    return x + f, aux, entry


def _resolve(params: LM, cfg: LMConfig, tokens, device) -> tuple[torch.device, torch.Tensor]:
    """The entry points' ``device=``: ``None`` means the card (and raises
    without one). The model must already live there; tokens are moved."""
    dev = resolve_device(device)
    if params.device.type != dev.type:
        raise ValueError(f"the model lives on {params.device}, the call asked for {dev}")
    return params.device, torch.as_tensor(tokens).to(params.device, torch.long)


@torch.inference_mode()
def lm_forward(params: LM, tokens, cfg: LMConfig, *, positions=None, device=None):
    """tokens (B,S) int → (logits (B,S,V), aux: the layers' MoE aux losses
    summed, 0 without MoE)."""
    dev, tokens = _resolve(params, cfg, tokens, device)
    S = tokens.shape[1]
    x = params.embed[tokens]                              # (B,S,d)
    if positions is None:
        positions = torch.arange(S, dtype=torch.int32, device=dev)
    auxes = []
    for lp in params.layers:
        x, aux, _ = _layer(lp, x, cfg, positions)
        auxes.append(aux)
    logits = dense(rms_norm(x, params.ln_f), params.unembed)
    return logits, torch.stack(auxes).float().sum()


# -- training -------------------------------------------------------------------------


def _maybe_remat(body, cfg: LMConfig):
    """``body`` recomputed in the backward pass per ``cfg.remat_policy``
    (:func:`~repro_torch.models.common.remat`); as is without ``cfg.remat``."""
    if not cfg.remat:
        return body
    return remat(body, cfg.remat_policy)


def lm_loss(params: dict, batch, cfg: LMConfig):
    """batch = {tokens (B,S), labels (B,S) int, -1 = ignore} → (loss + aux
    weight · aux, {"loss", "aux", "ppl"}). ``params``: the reference's tree
    (``lm_param_defs``) of tensors; the batch moves to their device. No
    ``inference_mode``, the plain chunked attention, each layer remat'd."""
    embed = params["embed"]
    dev = embed.device
    tokens = torch.as_tensor(batch["tokens"]).to(dev, torch.long)
    labels = torch.as_tensor(batch["labels"]).to(dev, torch.long)
    S = tokens.shape[1]
    positions = torch.arange(S, dtype=torch.int32, device=dev)
    x = gather_rows(embed, tokens)                        # (B,S,d)

    def body(x, lp):
        y, aux, _ = _layer(lp, x, cfg, positions, impl="chunked")
        return y, aux

    body = _maybe_remat(body, cfg)
    auxes = []
    for lp in unstack_layers(params["layers"], cfg.n_layers):
        x, aux = body(x, lp)
        auxes.append(aux)
    logits = dense(rms_norm(x, params["ln_f"]), params["unembed"])
    aux = torch.stack(auxes).float().sum()
    valid = labels >= 0
    lab = torch.clamp(labels, min=0)
    logits32 = logits.float()
    lse = torch.logsumexp(logits32, dim=-1)
    gold = torch.gather(logits32, -1, lab[..., None])[..., 0]
    nll = torch.where(valid, lse - gold, 0.0)
    n = torch.clamp(valid.sum(), min=1)
    loss = nll.sum() / n
    total = loss + cfg.aux_loss_weight * aux
    return total, {"loss": loss, "aux": aux, "ppl": torch.exp(torch.clamp(loss, max=20.0))}


# -- serving: prefill + decode ------------------------------------------------------


def _cache_slots(cfg: LMConfig, max_len: int) -> int:
    return min(max_len, cfg.window) if cfg.window is not None else max_len


def _cache_shapes(cfg: LMConfig, batch: int, max_len: int) -> dict:
    L, S = cfg.n_layers, _cache_slots(cfg, max_len)
    if cfg.mla is not None:
        m = cfg.mla
        return {"ckv": (L, batch, S, m.kv_lora), "krope": (L, batch, S, m.rope_dim)}
    shape = (L, batch, cfg.n_kv_heads, S, cfg.dh)
    return {"k": shape, "v": shape}


def make_cache(cfg: LMConfig, batch: int, max_len: int, *, device=None) -> dict:
    """Zero cache in ``cfg.dtype``. GQA: k/v (L,B,Hkv,slots,Dh); MLA: the
    latent ckv (L,B,slots,kv_lora) and krope (L,B,slots,rope_dim)."""
    dev = resolve_device(device)
    return {key: torch.zeros(shape, dtype=cfg.dtype, device=dev)
            for key, shape in _cache_shapes(cfg, batch, max_len).items()}


def cache_spec(cfg: LMConfig, batch: int, max_len: int) -> dict:
    """:func:`make_cache`'s shapes and dtype, allocating nothing (tensors on
    the meta device)."""
    return {key: torch.empty(shape, dtype=cfg.dtype, device="meta")
            for key, shape in _cache_shapes(cfg, batch, max_len).items()}


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
        x, _, entry = _layer(lp, x, cfg, positions)
        if cfg.mla is not None:                           # latent (B,S,*): axis 1
            for key, e in zip(("ckv", "krope"), entry):
                cache[key][i] = _ring(_fit(e[:, S - take:], slots, axis=1), shift, 1)
        else:                                             # k/v (B,Hkv,S,Dh): axis 2
            for key, e in zip(("k", "v"), entry):
                cache[key][i] = _ring(_fit(e[:, :, S - take:], slots, axis=2), shift, 2)
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
    slots = cache["ckv"].shape[2] if cfg.mla is not None else cache["k"].shape[3]
    slot, kv_len = pos % slots, min(pos + 1, slots)
    positions = torch.arange(pos, pos + 1, dtype=torch.int32, device=dev)
    x = params.embed[token]                               # (B,1,d)
    # each layer writes its token's k/v (or latent) into the slot *before*
    # attending, so the query sees itself; kv_len includes the slot
    for i, lp in enumerate(params.layers):
        h = rms_norm(x, lp["ln1"])
        if cfg.mla is not None:
            q_nope, q_rope, c_new, r_new = _mla_qkv(lp["attn"], h, cfg, positions)
            cache["ckv"][i][:, slot] = c_new[:, 0]
            cache["krope"][i][:, slot] = r_new[:, 0]
            a = _mla_attn_core(lp["attn"], q_nope, q_rope, (cache["ckv"][i], cache["krope"][i]),
                               kv_len, cfg)
        else:
            a, _ = _gqa_attn_decode_write(lp["attn"], h, cfg, positions, cache["k"][i],
                                          cache["v"][i], slot, kv_len)
        x = x + a
        x = x + _ffn(lp["ffn"], rms_norm(x, lp["ln2"]), cfg)[0]
    x = rms_norm(x, params.ln_f)
    return dense(x, params.unembed)[:, 0], cache
