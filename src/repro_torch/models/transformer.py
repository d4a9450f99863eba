"""Decoder-only transformer family covering the five LM archs on one
device: serving and training.

The port of the JAX package's ``models/transformer.py`` (``init_params``,
``forward``, ``loss_fn``, ``init_cache``, ``decode_step``):

  * GQA attention (Mistral-Nemo, Qwen-2.5, Phi-3, Grok-1) with optional QKV
    bias (Qwen), a sliding-window ring cache and an int8 cache;
  * MLA attention (DeepSeek-V3): naive (materialized) form for training and
    prefill, *absorbed* form for decode over the latent cache;
  * dense SwiGLU or MoE FFN (``moe.moe_ep``'s single-device body);
  * the training loss (``loss_fn``): the cross-entropy, DeepSeek-V3's
    depth-1 multi-token prediction (``_mtp_loss``, 0.1 of it) and the
    routers' load-balance loss; per-block remat when ``cfg.remat`` is set
    and grad mode is on (``torch.utils.checkpoint`` around each block, the
    reference's ``jax.checkpoint`` of its scanned block).

The parameters live in an ``nn.Module`` (``Transformer``) named after the
reference's pytree keys: ``embed``, ``final_norm``, ``lm_head``,
``dense_blocks.<i>`` and ``moe_blocks.<i>`` (``nn.ModuleList``s in place
of the reference's stacked ``[L, ...]`` leaves), each with ``ln1``, ``ln2``,
``attn.<key>`` (an ``nn.ParameterDict``) and ``wg``/``wi``/``wo`` or
``moe.<key>``, and ``mtp.ln``, ``mtp.proj``, ``mtp.block.*``. Matrices keep
the reference's ``[in, out]`` layout (``x @ w``); ``convert.lm_params_from_jax``
copies them as they are. ``forward``, ``loss_fn`` and ``decode_step`` take
the config apart from the module, as the reference's take it apart from the
params: the step factory runs a module with another ``flash_q_chunk`` or
``sliding_window`` than it was built with. ``loss_fn(..., params=)`` runs
at a dict of tensors by parameter name (the train step's leaves) through
``torch.func.functional_call``.

``decode_step`` writes the new entries into ``cache`` in place and returns
it (the reference returns a new cache; its decode step donates the old
one). The mesh paths (``param_specs``, ``param_specs_zero3``,
``cache_specs``, ``ShardCtx``) are the only part not ported: ROADMAP.md
section 1, item 6c-ii.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Any

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.core.dispatch import resolve_device
from repro_torch.models.layers import (
    MASKED, _attend, _scalar, apply_rope, cross_entropy, flash_attention, rms_norm, swiglu,
)
from repro_torch.models.moe import MoEConfig, moe_ep

F32 = torch.float32


@dataclass(frozen=True)
class TransformerConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int | None = None          # default d_model // n_heads
    attn: str = "gqa"                    # "gqa" | "mla"
    qkv_bias: bool = False
    rope_theta: float = 1e6
    sliding_window: int | None = None    # decode-time window (long_500k)
    # --- MLA (DeepSeek-V3) ---
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128
    # --- MoE ---
    moe: MoEConfig | None = None
    n_dense_layers: int | None = None    # layers 0..n_dense use dense FFN
    # --- numerics / training ---
    param_dtype: Any = torch.float32
    compute_dtype: Any = torch.float32
    remat: bool = False
    microbatches: int = 1
    mtp: bool = False                    # DeepSeek multi-token prediction
    flash_q_chunk: int = 1024
    flash_k_chunk: int = 1024
    fsdp: bool = False                   # shard params over 'data' too
    kv_cache_dtype: str | None = None    # "int8": quantized GQA decode cache

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def n_moe_layers(self) -> int:
        if self.moe is None:
            return 0
        nd = self.n_dense_layers if self.n_dense_layers is not None else 0
        return self.n_layers - nd

    @property
    def n_dense(self) -> int:
        return self.n_layers - self.n_moe_layers

    def n_params(self) -> int:
        """Total parameter count (for 6ND roofline accounting), from the
        shapes alone (the module on the meta device)."""
        return sum(p.numel() for p in Transformer(self, device="meta").parameters())

    def n_active_params(self) -> int:
        """Activated params per token (MoE: top_k + shared of routed)."""
        total = self.n_params()
        if self.moe is None:
            return total
        e, k = self.moe.n_experts, self.moe.top_k
        per_expert = 3 * self.d_model * self.moe.d_ff
        routed = self.n_moe_layers * e * per_expert
        active_routed = self.n_moe_layers * k * per_expert
        return total - routed + active_routed


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------
def _attn_params(cfg: TransformerConfig, new) -> nn.ParameterDict:
    d, hd = cfg.d_model, cfg.hd
    if cfg.attn == "mla":
        qk = cfg.qk_nope_dim + cfg.qk_rope_dim
        return nn.ParameterDict({
            "wq_a": new(d, cfg.q_lora_rank),
            "q_norm": new(cfg.q_lora_rank),
            "wq_b": new(cfg.q_lora_rank, cfg.n_heads * qk),
            "wkv_a": new(d, cfg.kv_lora_rank + cfg.qk_rope_dim),
            "kv_norm": new(cfg.kv_lora_rank),
            "wkv_b": new(cfg.kv_lora_rank, cfg.n_heads * (cfg.qk_nope_dim + cfg.v_head_dim)),
            "wo": new(cfg.n_heads * cfg.v_head_dim, d),
        })
    p = {"wq": new(d, cfg.n_heads * hd), "wk": new(d, cfg.n_kv_heads * hd),
         "wv": new(d, cfg.n_kv_heads * hd), "wo": new(cfg.n_heads * hd, d)}
    if cfg.qkv_bias:
        p.update(bq=new(cfg.n_heads * hd), bk=new(cfg.n_kv_heads * hd),
                 bv=new(cfg.n_kv_heads * hd))
    return nn.ParameterDict(p)


class Block(nn.Module):
    """One layer: ``ln1``, ``attn``, ``ln2`` and a dense SwiGLU
    (``wg``/``wi``/``wo``) or a MoE (``moe``)."""

    def __init__(self, cfg: TransformerConfig, kind: str, new):
        super().__init__()
        d = cfg.d_model
        self.ln1, self.ln2 = new(d), new(d)
        self.attn = _attn_params(cfg, new)
        if kind == "dense":
            self.wg, self.wi, self.wo = new(d, cfg.d_ff), new(d, cfg.d_ff), new(cfg.d_ff, d)
            self.moe = None
            return
        m = cfg.moe
        p = {"router": new(d, m.n_experts), "wg": new(m.n_experts, d, m.d_ff),
             "wi": new(m.n_experts, d, m.d_ff), "wo": new(m.n_experts, m.d_ff, d)}
        if m.n_shared:
            fs = m.d_ff * m.n_shared
            p.update(shared_wg=new(d, fs), shared_wi=new(d, fs), shared_wo=new(fs, d))
        self.moe = nn.ParameterDict(p)


class MTP(nn.Module):
    """DeepSeek-V3's multi-token-prediction head (trained by ``loss_fn``, not
    served)."""

    def __init__(self, cfg: TransformerConfig, new):
        super().__init__()
        self.ln = new(cfg.d_model)
        self.proj = new(2 * cfg.d_model, cfg.d_model)
        self.block = Block(cfg, "dense", new)


class Transformer(nn.Module):
    """The parameters of one ``TransformerConfig``, allocated in
    ``cfg.param_dtype`` and not initialised: ``init_params`` draws them,
    ``convert.lm_params_from_jax`` copies the reference's. ``device`` None
    means the GPU, and raises without one; ``"meta"`` gives the shapes."""

    def __init__(self, cfg: TransformerConfig, *, device=None):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg

        def new(*shape):
            return nn.Parameter(torch.empty(shape, dtype=cfg.param_dtype, device=device))

        d = cfg.d_model
        self.embed = new(cfg.vocab, d)
        self.final_norm = new(d)
        self.lm_head = new(d, cfg.vocab)
        self.dense_blocks = (nn.ModuleList(Block(cfg, "dense", new) for _ in range(cfg.n_dense))
                             if cfg.n_dense else None)
        self.moe_blocks = (nn.ModuleList(Block(cfg, "moe", new) for _ in range(cfg.n_moe_layers))
                           if cfg.n_moe_layers else None)
        self.mtp = MTP(cfg, new) if cfg.mtp else None

    def blocks(self) -> list[Block]:
        """The layers in order: the dense blocks, then the MoE blocks."""
        return [*(self.dense_blocks or ()), *(self.moe_blocks or ())]


_ONES = ("ln1", "ln2", "final_norm", "q_norm", "kv_norm", "mtp.ln")
_ZEROS = ("bq", "bk", "bv")


def init_params(cfg: TransformerConfig, *, device=None,
                generator: torch.Generator | None = None) -> Transformer:
    """A ``Transformer`` with the reference's initial distributions, drawn
    from ``generator`` (on ``device``; default seeded 0): norms one, QKV
    biases zero, the embedding N(0, 0.02^2), every matrix N(0, 1) times
    fan_in^-0.5 (its second-to-last axis). It does not reproduce JAX's
    random values: parity goes through ``convert.lm_params_from_jax``.
    ``device`` None means the GPU, and raises without one."""
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    model = Transformer(cfg, device=device)
    with torch.no_grad():
        for name, p in model.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if name in _ONES or leaf in _ONES:
                p.fill_(1)
            elif leaf in _ZEROS:
                p.zero_()
            else:
                p.normal_(generator=generator)
                p.mul_(0.02 if name == "embed" else p.shape[-2] ** -0.5)
    return model


# ---------------------------------------------------------------------------
# attention forward
# ---------------------------------------------------------------------------
def _flash_or_plain(q, k, v, cfg: TransformerConfig, use_flash: bool):
    s = q.shape[1]
    if use_flash:
        return flash_attention(q, k, v, causal=True, q_chunk=min(cfg.flash_q_chunk, s),
                               k_chunk=min(cfg.flash_k_chunk, s))
    return _attend(q, k, v, causal=True)


def _gqa_attn(x, ap, cfg: TransformerConfig, use_flash: bool, collect_cache: bool = False):
    b, s, _ = x.shape
    hd, h, kv = cfg.hd, cfg.n_heads, cfg.n_kv_heads
    cd = cfg.compute_dtype
    xc = x.to(cd)
    q, k, v = xc @ ap["wq"].to(cd), xc @ ap["wk"].to(cd), xc @ ap["wv"].to(cd)
    if cfg.qkv_bias:
        q, k, v = q + ap["bq"].to(cd), k + ap["bk"].to(cd), v + ap["bv"].to(cd)
    q = q.reshape(b, s, h, hd)
    k = k.reshape(b, s, kv, hd)
    v = v.reshape(b, s, kv, hd)
    pos = torch.arange(s, device=x.device)[None, :]
    q = apply_rope(q, pos, cfg.rope_theta)
    k = apply_rope(k, pos, cfg.rope_theta)
    o = _flash_or_plain(q, k, v, cfg, use_flash).reshape(b, s, h * hd)
    out = (o.to(cd) @ ap["wo"].to(cd)).to(x.dtype)
    return out, ({"k": k, "v": v} if collect_cache else None)   # post-rope


def _mla_attn(x, ap, cfg: TransformerConfig, use_flash: bool, collect_cache: bool = False):
    """Naive (materialized) MLA for prefill."""
    b, s, _ = x.shape
    h = cfg.n_heads
    dn, dr, dv = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    cd = cfg.compute_dtype
    xc = x.to(cd)
    cq = rms_norm(xc @ ap["wq_a"].to(cd), ap["q_norm"])
    q = (cq.to(cd) @ ap["wq_b"].to(cd)).reshape(b, s, h, dn + dr)
    q_nope, q_rope = q[..., :dn], q[..., dn:]
    ckv = xc @ ap["wkv_a"].to(cd)
    c_kv = rms_norm(ckv[..., :cfg.kv_lora_rank], ap["kv_norm"])
    k_rope = ckv[..., cfg.kv_lora_rank:].reshape(b, s, 1, dr)
    pos = torch.arange(s, device=x.device)[None, :]
    q_rope = apply_rope(q_rope, pos, cfg.rope_theta)
    k_rope = apply_rope(k_rope, pos, cfg.rope_theta)
    kvm = (c_kv.to(cd) @ ap["wkv_b"].to(cd)).reshape(b, s, h, dn + dv)
    k_nope, v = kvm[..., :dn], kvm[..., dn:]
    q_full = torch.cat([q_nope, q_rope], dim=-1)
    k_full = torch.cat([k_nope, k_rope.expand(b, s, h, dr)], dim=-1)
    o = _flash_or_plain(q_full, k_full, v, cfg, use_flash).reshape(b, s, h * dv)
    out = (o.to(cd) @ ap["wo"].to(cd)).to(x.dtype)
    return out, ({"c_kv": c_kv, "k_rope": k_rope[:, :, 0]} if collect_cache else None)


# ---------------------------------------------------------------------------
# forward (training / prefill)
# ---------------------------------------------------------------------------
def _weights(lp: Block) -> dict:
    """A block's tensors as a plain dict under the reference's keys, read
    when the forward runs: the tensors a ``functional_call`` put in place,
    which a remat's recompute (after the call has returned) must see too."""
    w = {"ln1": lp.ln1, "ln2": lp.ln2, "attn": {k: lp.attn[k] for k in lp.attn}}
    if lp.moe is None:
        w.update(wg=lp.wg, wi=lp.wi, wo=lp.wo)
    else:
        w["moe"] = {k: lp.moe[k] for k in lp.moe}
    return w


def _block(h, aux, w: dict, cfg: TransformerConfig, use_flash: bool, collect_cache: bool):
    """One layer on the residual stream: (h, aux + the MoE's aux, cache)."""
    attn_fn = _mla_attn if cfg.attn == "mla" else _gqa_attn
    att, cache = attn_fn(rms_norm(h, w["ln1"]), w["attn"], cfg, use_flash, collect_cache)
    h = h + att
    y = rms_norm(h, w["ln2"])
    if "moe" not in w:
        return h + swiglu(y, w["wg"], w["wi"], w["wo"], cfg.compute_dtype), aux, cache
    ff, a = moe_ep(y, w["moe"], cfg.moe)
    return h + ff, aux + a, cache


def _trunk(model: Transformer, tokens: torch.Tensor, cfg: TransformerConfig,
           return_cache: bool):
    """The layers and the final norm: (h [B, S, D], aux, stacked cache or None).

    With ``cfg.remat`` and grad mode on, each block keeps only its inputs
    for the backward and runs again there (``torch.utils.checkpoint``,
    non-reentrant): the reference's ``jax.checkpoint`` of its scanned
    block. The values and gradients are the same bits either way."""
    s = tokens.shape[1]
    use_flash = s >= 2048
    remat = cfg.remat and torch.is_grad_enabled() and not return_cache
    h = F.embedding(tokens.long(), model.embed)
    aux = torch.zeros((), dtype=F32, device=h.device)
    caches = []
    for lp in model.blocks():
        if remat:
            h, aux, _ = checkpoint(_block, h, aux, _weights(lp), cfg, use_flash, False,
                                   use_reentrant=False, preserve_rng_state=False)
        else:
            h, aux, cache = _block(h, aux, _weights(lp), cfg, use_flash, return_cache)
            caches.append(cache)
    h = rms_norm(h, model.final_norm)
    if not return_cache:
        return h, aux, None
    return h, aux, {k: torch.stack([c[k] for c in caches]) for k in caches[0]}


def _head(model: Transformer, h: torch.Tensor, cfg: TransformerConfig) -> torch.Tensor:
    cd = cfg.compute_dtype
    return (h.to(cd) @ model.lm_head.to(cd)).to(F32)


def forward(model: Transformer, tokens: torch.Tensor, cfg: TransformerConfig,
            return_cache: bool = False):
    """tokens [B, S] -> (logits [B, S, V] f32, aux_loss scalar[, cache]).

    ``return_cache=True`` (the prefill step) also returns the stacked KV
    cache ([L, B, S, ...]; GQA: post-rope k/v, MLA: latent ``c_kv`` and
    ``k_rope``) ready for ``decode_step``."""
    h, aux, cache = _trunk(model, tokens, cfg, return_cache)
    logits = _head(model, h, cfg)
    return (logits, aux, cache) if return_cache else (logits, aux)


def prefill(model: Transformer, tokens: torch.Tensor, cfg: TransformerConfig):
    """``forward(..., return_cache=True)`` with the logits of the last
    position only: (logits [B, V] f32, cache). The head of one row is the
    same product as that row of the full head, without the [B, S, V]
    logits (20 GB at 32k tokens of a 152k vocabulary)."""
    h, _aux, cache = _trunk(model, tokens, cfg, True)
    return _head(model, h[:, -1], cfg), cache


# ---------------------------------------------------------------------------
# training loss
# ---------------------------------------------------------------------------
class _Apply(nn.Module):
    """``fn(model, *args)`` as a module's forward, so that
    ``torch.func.functional_call`` runs it at other tensors."""

    def __init__(self, model: Transformer):
        super().__init__()
        self.model = model

    def forward(self, fn, *args):
        return fn(self.model, *args)


def loss_fn(model: Transformer, tokens: torch.Tensor, labels: torch.Tensor,
            cfg: TransformerConfig, params: dict | None = None) -> torch.Tensor:
    """The training loss: the mean token cross-entropy of the logits, plus
    0.1 x the MTP loss (``cfg.mtp``), plus ``router_aux_coef`` x the MoE
    layers' summed load-balance loss. ``params`` (tensors by parameter
    name) stand in for the model's own, through ``functional_call``."""
    if params is None:
        return _loss(model, tokens, labels, cfg)
    return torch.func.functional_call(
        _Apply(model), {f"model.{k}": v for k, v in params.items()},
        (_loss, tokens, labels, cfg))


def _loss(model: Transformer, tokens, labels, cfg: TransformerConfig) -> torch.Tensor:
    logits, aux = forward(model, tokens, cfg)
    loss = cross_entropy(logits, labels)
    if cfg.mtp:
        loss = loss + 0.1 * _mtp_loss(model, tokens, labels, cfg)
    coef = cfg.moe.router_aux_coef if cfg.moe else 0.0
    return loss + coef * aux


def _mtp_loss(model: Transformer, tokens, labels, cfg: TransformerConfig) -> torch.Tensor:
    """DeepSeek-V3 MTP (depth 1): predict token t+2 from the t-th hidden
    state combined with the embedding of token t+1 (the labels rolled by
    -1); the last two positions, whose targets wrapped round, are left
    out."""
    mp = model.mtp
    cd = cfg.compute_dtype
    h = F.embedding(tokens.long(), model.embed)
    nxt = F.embedding(torch.roll(labels, -1, dims=1).long(), model.embed)
    z = torch.cat([rms_norm(h, mp.ln), nxt.to(h.dtype)], dim=-1)
    z = z.to(cd) @ mp.proj.to(cd)
    bp = _weights(mp.block)
    z = z + _gqa_mtp(rms_norm(z, bp["ln1"]), bp, cfg)
    z = z + swiglu(rms_norm(z, bp["ln2"]), bp["wg"], bp["wi"], bp["wo"], cd)
    lg = (rms_norm(z, mp.ln).to(cd) @ model.lm_head.to(cd)).to(F32)
    tgt = torch.roll(labels, -2, dims=1)
    return cross_entropy(lg[:, :-2], tgt[:, :-2])


def _gqa_mtp(x, bp: dict, cfg: TransformerConfig) -> torch.Tensor:
    """MTP block attention, never rematerialized; MLA configs reuse the MLA
    projection weights (the block's own)."""
    c = replace(cfg, remat=False)
    fn = _mla_attn if cfg.attn == "mla" else _gqa_attn
    return fn(x, bp["attn"], c, use_flash=x.shape[1] >= 2048)[0]


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------
def init_cache(cfg: TransformerConfig, batch: int, max_len: int, dtype=None, *,
               device=None) -> dict:
    """KV cache. GQA: K/V per layer; MLA: latent + rope cache. ``device``
    None means the GPU, and raises without one.

    ``kv_cache_dtype="int8"`` (GQA only): entries are stored int8 with one
    f32 scale per (layer, batch, position, kv-head)."""
    device = resolve_device(device)
    dt = dtype or cfg.param_dtype
    L = cfg.n_layers
    s = min(max_len, cfg.sliding_window) if cfg.sliding_window else max_len

    def zeros(*shape, dtype=dt):
        return torch.zeros(shape, dtype=dtype, device=device)

    if cfg.attn == "mla":
        return {"c_kv": zeros(L, batch, s, cfg.kv_lora_rank),
                "k_rope": zeros(L, batch, s, cfg.qk_rope_dim)}
    kv = (L, batch, s, cfg.n_kv_heads, cfg.hd)
    if cfg.kv_cache_dtype == "int8":
        return {"k": zeros(*kv, dtype=torch.int8), "v": zeros(*kv, dtype=torch.int8),
                "k_scale": zeros(*kv[:-1], dtype=F32), "v_scale": zeros(*kv[:-1], dtype=F32)}
    return {"k": zeros(*kv), "v": zeros(*kv)}


def decode_step(model: Transformer, cache: dict, tokens: torch.Tensor, cache_len,
                cfg: TransformerConfig) -> tuple[torch.Tensor, dict]:
    """One decode step: tokens [B] -> (logits [B, V], cache with the new
    entries written in place).

    ``cache_len`` — number of valid entries (= absolute position of the new
    token), an int or a 0-d integer tensor. With a sliding window the cache
    is a ring buffer of size W. A slot past the cache's end writes its last
    entry, as the reference's ``dynamic_update_slice`` clamps."""
    blocks = model.blocks()
    n_cached = next(iter(cache.values())).shape[0]
    if n_cached != len(blocks):
        raise ValueError(f"the cache holds {n_cached} layers; {cfg.name} has {len(blocks)}")
    dev = tokens.device
    n = (cache_len.to(device=dev, dtype=torch.int64) if torch.is_tensor(cache_len)
         else torch.full((), cache_len, dtype=torch.int64, device=dev))
    window = cfg.sliding_window
    s_cache = next(iter(cache.values())).shape[2]
    slot = torch.clamp(n % window if window else n, max=s_cache - 1).view(1)
    decode = _mla_decode if cfg.attn == "mla" else _gqa_decode
    h = F.embedding(tokens.long(), model.embed)[:, None, :]    # [B,1,D]
    for li, lp in enumerate(blocks):
        layer_cache = {k: v[li] for k, v in cache.items()}      # views, written in place
        y = rms_norm(h, lp.ln1)
        h = h + decode(y, lp.attn, layer_cache, n, slot, cfg)
        y2 = rms_norm(h, lp.ln2)
        if lp.moe is None:
            h = h + swiglu(y2, lp.wg, lp.wi, lp.wo, cfg.compute_dtype)
        else:
            h = h + moe_ep(y2, lp.moe, cfg.moe)[0]
    h = rms_norm(h, model.final_norm)
    return _head(model, h[:, 0], cfg), cache


def _positions(n: torch.Tensor, b: int) -> torch.Tensor:
    return n.view(1, 1).expand(b, 1)


def _quant(t: torch.Tensor):
    """Per-(token, kv-head) symmetric int8 quantization of the new entries."""
    tf = t.to(F32)
    amax = tf.abs().amax(-1)
    scale = torch.clamp(amax, min=1e-8) / _scalar(127.0, amax)
    q8 = torch.clamp(torch.round(tf / scale[..., None]), -127, 127).to(torch.int8)
    return q8, scale


def _gqa_decode(x, ap, layer_cache: dict, n: torch.Tensor, slot: torch.Tensor,
                cfg: TransformerConfig) -> torch.Tensor:
    b = x.shape[0]
    hd, h, kv = cfg.hd, cfg.n_heads, cfg.n_kv_heads
    cd = cfg.compute_dtype
    xc = x.to(cd)
    q, k, v = xc @ ap["wq"].to(cd), xc @ ap["wk"].to(cd), xc @ ap["wv"].to(cd)
    if cfg.qkv_bias:
        q, k, v = q + ap["bq"].to(cd), k + ap["bk"].to(cd), v + ap["bv"].to(cd)
    q = q.reshape(b, 1, h, hd)
    k = k.reshape(b, 1, kv, hd)
    v = v.reshape(b, 1, kv, hd)
    pos = _positions(n, b)
    q = apply_rope(q, pos, cfg.rope_theta)
    k = apply_rope(k, pos, cfg.rope_theta)
    c = layer_cache
    if cfg.kv_cache_dtype == "int8":
        k8, ks = _quant(k)
        v8, vs = _quant(v)
        for key, new in (("k", k8), ("v", v8), ("k_scale", ks), ("v_scale", vs)):
            c[key].index_copy_(1, slot, new)
        # fold scales in AFTER the int8 read
        ck = c["k"].to(cd) * c["k_scale"].to(cd)[..., None]
        cv = c["v"].to(cd) * c["v_scale"].to(cd)[..., None]
    else:
        c["k"].index_copy_(1, slot, k.to(c["k"].dtype))
        c["v"].index_copy_(1, slot, v.to(c["v"].dtype))
        ck, cv = c["k"].to(cd), c["v"].to(cd)
    valid = torch.clamp(n + 1, max=c["k"].shape[1])
    o = _attend(q, ck, cv, causal=False, kv_len=valid).reshape(b, 1, h * hd)
    return (o.to(cd) @ ap["wo"].to(cd)).to(x.dtype)


def _mla_decode(x, ap, layer_cache: dict, n: torch.Tensor, slot: torch.Tensor,
                cfg: TransformerConfig) -> torch.Tensor:
    """Absorbed MLA decode over the latent cache."""
    b = x.shape[0]
    h = cfg.n_heads
    dn, dr, dv, kvr = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim, cfg.kv_lora_rank
    cd = cfg.compute_dtype
    xc = x.to(cd)
    cq = rms_norm(xc @ ap["wq_a"].to(cd), ap["q_norm"])
    q = (cq.to(cd) @ ap["wq_b"].to(cd)).reshape(b, 1, h, dn + dr)
    q_nope, q_rope = q[..., :dn], q[..., dn:]
    pos = _positions(n, b)
    q_rope = apply_rope(q_rope, pos, cfg.rope_theta)

    ckv = xc @ ap["wkv_a"].to(cd)
    c_new = rms_norm(ckv[..., :kvr], ap["kv_norm"])              # [B,1,kvr]
    kr_new = apply_rope(ckv[..., None, kvr:], pos, cfg.rope_theta)[:, :, 0]
    cc, cr = layer_cache["c_kv"], layer_cache["k_rope"]
    cc.index_copy_(1, slot, c_new.to(cc.dtype))
    cr.index_copy_(1, slot, kr_new.to(cr.dtype))

    wkv_b = ap["wkv_b"].to(cd).reshape(kvr, h, dn + dv)
    w_uk, w_uv = wkv_b[..., :dn], wkv_b[..., dn:]
    # absorb: q_abs [B,h,kvr]
    q_abs = torch.einsum("bhd,khd->bhk", q_nope[:, 0].to(cd), w_uk)
    s_nope = torch.einsum("bhk,bsk->bhs", q_abs, cc.to(cd))
    s_rope = torch.einsum("bhd,bsd->bhs", q_rope[:, 0].to(cd), cr.to(cd))
    scores = (s_nope + s_rope).to(F32)
    scores = scores / torch.sqrt(_scalar(float(dn + dr), scores))
    s_cache = cc.shape[1]
    valid = torch.arange(s_cache, device=x.device)[None, None, :] < torch.clamp(n + 1, max=s_cache)
    scores = torch.where(valid, scores, _scalar(MASKED, scores))
    p = torch.softmax(scores, dim=-1)
    ctx_lat = torch.einsum("bhs,bsk->bhk", p.to(cd), cc.to(cd))
    o = torch.einsum("bhk,khv->bhv", ctx_lat, w_uv).reshape(b, 1, h * dv)
    return (o.to(cd) @ ap["wo"].to(cd)).to(x.dtype)


__all__ = ["TransformerConfig", "Transformer", "Block", "MTP", "init_params", "forward",
           "prefill", "loss_fn", "init_cache", "decode_step"]
