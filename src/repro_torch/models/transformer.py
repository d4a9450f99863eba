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
one).

Over a mesh (``ctx=ShardCtx(mesh, ...)``, ``mesh=`` a ``collective.Mesh``,
one process a rank) every rank holds the slice of each parameter that the
reference's ``PartitionSpec`` names (``param_specs``, ``param_specs_zero3``:
specs keyed by parameter name, one entry a dimension, the reference's
stacked ``[L]`` entry dropped) and computes, from its slices, what the
reference's jitted program computes on the same global arrays:

  * tp_sp (``ShardCtx(mesh, dp, sp=True)``, training and prefill): the
    residual stream ``[B / |dp|, S / |tp|, D]``; each block gathers the
    sequence over ``tp``, runs SwiGLU, and attention where the query and
    key heads both divide ``|tp|``, column- then row-parallel (the heads
    over ``tp``), and sums and splits its output over ``tp`` (Megatron's
    sequence parallelism); where the heads do not divide, attention takes
    the reference's ``act4`` layout: each rank its own sequence block of
    every head's queries and outputs (``wq`` and ``wo`` gathered whole),
    against every key and value (column-parallel, gathered); the
    embedding, ``lm_head`` and the float32 cross-entropy vocab-parallel
    where ``vocab % |tp| == 0``; weights gathered over the FSDP axes; the
    MoE layers through ``moe_ep``/``moe_tp(mesh=, sp=True)``;
  * zero3 (``ShardCtx(mesh, dp, tp=None)``): every weight gathered over the
    whole mesh, the single-device block on this rank's batch;
  * decode (``ShardCtx(mesh, dp)``, ``sp=False``): the cache in
    ``decode_cache_specs``' layout (GQA ``head_dim`` over ``tp``, the
    sequence over ``"data"`` at batch 1 with a window; MLA's latent over
    ``tp``, or the sequence over every axis at batch 1), partial scores
    summed over ``tp`` and a softmax combined over a split sequence.

Gradients follow ``core/collective.py``'s rule (every rank backpropagates
the loss of the whole step): a rank's gradient of a weight it gathered
comes out of the gather's backward summed over the gathered axes, at its
slice's size; a weight held alike over an axis that splits the tokens gets
its own tokens' share, which ``_Ranks.weight`` sums over that axis in the
backward (``grad_sum_axes``). Under remat a block gathers its weights
inside its checkpoint, so one block's gathered weights are alive at a time
and each leaves the backward as its slice's gradient.
"""
from __future__ import annotations

import functools
import math
from dataclasses import dataclass, replace
from typing import Any

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.core import collective
from repro_torch.core.dispatch import resolve_device
from repro_torch.models.layers import (
    MASKED, NO_SHARD, ShardCtx, _attend, _scalar, _weigh, apply_rope, cross_entropy,
    flash_attention, rms_norm, swiglu,
)
from repro_torch.models.moe import MoEConfig, moe_ep
from repro_torch.models.moe_tp import moe_tp
from repro_torch.models.shard import (
    gather_dim, local_shape, local_slice, norm_spec, spec_axes, split_dim,
)

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
                generator: torch.Generator | None = None, mesh=None,
                specs: dict | None = None) -> Transformer:
    """A ``Transformer`` with the reference's initial distributions, drawn
    from ``generator`` (on ``device``; default seeded 0): norms one, QKV
    biases zero, the embedding N(0, 0.02^2), every matrix N(0, 1) times
    fan_in^-0.5 (its second-to-last axis). It does not reproduce JAX's
    random values: parity goes through ``convert.lm_params_from_jax``.
    ``device`` None means the GPU, and raises without one.

    With ``mesh`` and ``specs``: this rank's slices (``sharded``) of the
    same values, each whole leaf drawn in turn on the mesh's device and cut,
    so no more than one whole leaf is held at once."""
    if mesh is not None:
        device = mesh.device
        model = sharded(cfg, mesh, specs)
        whole = Transformer(cfg, device="meta")
    else:
        device = resolve_device(device)
        model = whole = Transformer(cfg, device=device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    mine = dict(model.named_parameters())
    with torch.no_grad():
        for name, p in whole.named_parameters():
            if mesh is not None:
                p = torch.empty(p.shape, dtype=p.dtype, device=device)
            leaf = name.rsplit(".", 1)[-1]
            if name in _ONES or leaf in _ONES:
                p.fill_(1)
            elif leaf in _ZEROS:
                p.zero_()
            else:
                p.normal_(generator=generator)
                p.mul_(0.02 if name == "embed" else p.shape[-2] ** -0.5)
            if mesh is not None:
                mine[name].copy_(local_slice(p, specs[name], mesh))
                del p
    return model


# ---------------------------------------------------------------------------
# partition specs
# ---------------------------------------------------------------------------
_BLOCKS = ("dense_blocks", "moe_blocks")


def _div(n: int, size: int) -> bool:
    return size > 0 and n % size == 0


@functools.lru_cache(maxsize=64)
def param_shapes(cfg: TransformerConfig) -> dict:
    """``{name: shape}`` of every parameter of ``cfg``'s ``Transformer``
    (whole, as one device holds it)."""
    return {k: tuple(p.shape) for k, p in Transformer(cfg, device="meta").named_parameters()}


def _group(name: str) -> tuple[str, str]:
    """(the reference's group of a parameter, its key within a block):
    ``dense_blocks.3.attn.wq`` -> ("dense_blocks", "attn.wq"), ``mtp.block.wg``
    -> ("mtp.block", "wg"), ``embed`` -> ("", "embed")."""
    parts = name.split(".")
    if parts[0] in _BLOCKS:
        return parts[0], ".".join(parts[2:])
    if parts[:2] == ["mtp", "block"]:
        return "mtp.block", ".".join(parts[2:])
    return "", name


def _stacked(name: str, shape: tuple, cfg: TransformerConfig) -> tuple:
    """The shape of the reference's leaf that holds ``name``: a block's
    parameters stacked over its layers (the MTP block over one)."""
    group, _ = _group(name)
    if group == "dense_blocks":
        return (cfg.n_dense,) + shape
    if group == "moe_blocks":
        return (cfg.n_moe_layers,) + shape
    if group == "mtp.block":
        return (1,) + shape
    return shape


def param_specs_zero3(cfg: TransformerConfig, mesh) -> dict:
    """ZeRO-3 layout, ``{name: spec}``: every tensor split over the whole
    flat mesh on its largest divisible dim of the reference's stacked leaf
    (``mesh.axis_names``), no tensor parallelism; small or odd tensors
    whole. A leaf whose chosen dim is the reference's layer axis raises:
    the port keeps one tensor a layer."""
    from repro_torch.launch.mesh import n_devices

    n_total = n_devices(mesh)
    axes = tuple(mesh.axis_names)
    out = {}
    for name, shape in param_shapes(cfg).items():
        stacked = _stacked(name, shape, cfg)
        lead = len(stacked) - len(shape)
        out[name] = ()
        for i in sorted(range(len(stacked)), key=lambda i: -stacked[i]):
            if stacked[i] % n_total == 0:
                if i < lead:
                    raise ValueError(f"{name}: the reference splits its layer axis over the "
                                     f"mesh; the port holds one tensor a layer")
                parts = [None] * len(shape)
                parts[i - lead] = axes
                out[name] = tuple(parts)
                break
    return out


def param_specs(cfg: TransformerConfig, mesh) -> dict:
    """``{name: spec}`` of the reference's ``param_specs``: TP over
    'model'; with ``cfg.fsdp`` FSDP over every other axis; experts over
    'model' when they divide it (``moe_ep``), else every expert's ``d_ff``
    (``moe_tp``); the embedding and ``lm_head`` vocab-parallel when the
    vocabulary divides it."""
    from repro_torch.launch.mesh import axis_sizes

    tp = axis_sizes(mesh)["model"]
    fs = tuple(a for a in mesh.axis_names if a != "model") if cfg.fsdp else None
    attn = {"wq": (fs, "model"), "wk": (fs, "model"), "wv": (fs, "model"),
            "bq": ("model",), "bk": ("model",), "bv": ("model",), "wo": ("model", fs),
            "wq_a": (fs, None), "wkv_a": (fs, None), "wq_b": (None, "model"),
            "wkv_b": (None, "model")}
    if cfg.moe is not None and _div(cfg.moe.n_experts, tp):   # EP
        moe = {"router": (None, None), "wg": ("model", fs, None), "wi": ("model", fs, None),
               "wo": ("model", None, fs)}
    else:                                                      # TP-within-expert
        moe = {"router": (None, None), "wg": (None, fs, "model"), "wi": (None, fs, "model"),
               "wo": (None, "model", fs)}
    moe.update(shared_wg=(fs, "model"), shared_wi=(fs, "model"), shared_wo=("model", fs))
    block = {"ln1": (None,), "ln2": (None,), "wg": (fs, "model"), "wi": (fs, "model"),
             "wo": ("model", fs)}
    top = {"embed": ("model", None) if _div(cfg.vocab, tp) else (None, None),
           "final_norm": (None,),
           "lm_head": (fs, "model") if _div(cfg.vocab, tp) else (fs, None),
           "mtp.ln": (None,), "mtp.proj": (None, None)}
    out = {}
    for name in param_shapes(cfg):
        group, key = _group(name)
        if not group:
            out[name] = top[key]
        elif key.startswith("attn."):
            out[name] = attn.get(key[5:], (None,))   # norms whole
        elif key.startswith("moe."):
            out[name] = moe[key[4:]]
        else:
            out[name] = block[key]
    return out


def specs_from_jax(tree: dict, cfg: TransformerConfig) -> dict:
    """The reference's spec tree (``param_specs`` or ``param_specs_zero3``,
    each ``PartitionSpec`` as a tuple, JAX's nested keys) keyed by the
    port's parameter names, the stacked layer entry dropped: the form of the
    port's own spec functions."""
    out = {}

    def walk(node, path):
        for key, value in node.items():
            if isinstance(value, dict):
                walk(value, path + (key,))
                continue
            spec = tuple(value)
            if path and path[0] in _BLOCKS:
                n = cfg.n_dense if path[0] == "dense_blocks" else cfg.n_moe_layers
                rest = ".".join(path[1:] + (key,))
                out.update({f"{path[0]}.{i}.{rest}": spec[1:] for i in range(n)})
            elif path[:2] == ("mtp", "block"):
                out[".".join(path + (key,))] = spec[1:]
            else:
                out[".".join(path + (key,))] = spec
    walk(tree, ())
    return out


def cache_specs(cfg: TransformerConfig, dp) -> dict:
    """Prefill's cache layout (context-parallel: the sequence over
    'model'), stacked ``[L, B, S, ...]`` as ``init_cache`` makes it."""
    if cfg.attn == "mla":
        return {"c_kv": (None, dp, "model", None), "k_rope": (None, dp, "model", None)}
    return {"k": (None, dp, "model", None, None), "v": (None, dp, "model", None, None)}


def decode_cache_specs(cfg: TransformerConfig, mesh, batch: int) -> dict:
    """The reference decode step's cache layout (``launch/steps.py``'s
    ``_lm_decode``), which is not ``cache_specs``': GQA ``head_dim`` over
    'model', the sequence over 'data' at batch 1 with a sliding window, the
    int8 scales ``(None, bd, seq_ax, None)``; MLA's latent over 'model' for
    batch > 1, the sequence over every axis at batch 1."""
    from repro_torch.launch.mesh import dp_axes

    dp = dp_axes(mesh)
    bd = None if batch == 1 else dp
    if cfg.attn == "mla":
        seq_ax = tuple(mesh.axis_names) if batch == 1 else None
        lat = "model" if batch > 1 else None
        return {"c_kv": (None, bd, seq_ax, lat), "k_rope": (None, bd, seq_ax, None)}
    seq_ax = ("data",) if (batch == 1 and cfg.sliding_window) else None
    out = {"k": (None, bd, seq_ax, None, "model"), "v": (None, bd, seq_ax, None, "model")}
    if cfg.kv_cache_dtype == "int8":
        out["k_scale"] = (None, bd, seq_ax, None)
        out["v_scale"] = (None, bd, seq_ax, None)
    return out


def sharded(cfg: TransformerConfig, mesh, specs: dict) -> "Transformer":
    """A ``Transformer`` whose parameters are this rank's slices by
    ``specs`` (allocated on the mesh's device, not initialised)."""
    model = Transformer(cfg, device="meta")
    for name, p in list(model.named_parameters()):
        owner, _, leaf = name.rpartition(".")
        mod = model.get_submodule(owner) if owner else model
        new = nn.Parameter(torch.empty(local_shape(p.shape, specs[name], mesh), dtype=p.dtype,
                                       device=mesh.device))
        if isinstance(mod, nn.ParameterDict):
            mod[leaf] = new
        else:
            setattr(mod, leaf, new)
    return model


def grad_sum_axes(spec, ctx: ShardCtx, mesh) -> tuple[tuple[str, ...], tuple[str, ...], int]:
    """How a rank's gradient of a weight it used gathered becomes the
    gradient of its slice: (the axes to sum it over, the axes whose block
    to keep, the count to divide by). The weight was gathered over its
    spec's axes but ``ctx.tp`` (the gather's backward sums over them and
    keeps this rank's block); an axis that splits the tokens (``ctx.dp``,
    and ``ctx.tp`` with ``sp``) over which the weight is held alike is
    summed too; an axis the weight is split over but the tokens are not
    (ZeRO-3's trimmed batch axes) gave every rank along it the same
    gradient, so the sum is divided by its ranks."""
    named = set(spec_axes(spec))
    gathered = named - ({ctx.tp} if ctx.tp else set())
    tokens = set(ctx.dp) | ({ctx.tp} if ctx.sp and ctx.tp else set())
    summed = gathered | (tokens - named)
    repeat = math.prod(mesh.axis_size(a) for a in named - tokens)
    order = tuple(mesh.axis_names)
    return (tuple(a for a in order if a in summed), tuple(a for a in order if a in gathered),
            repeat)


# ---------------------------------------------------------------------------
# attention forward
# ---------------------------------------------------------------------------
def _flash_or_plain(q, k, v, cfg: TransformerConfig, use_flash: bool, q_offset: int = 0):
    """Causal attention of ``q`` (its first row at position ``q_offset``)
    against every key ``k`` / ``v``."""
    if use_flash:
        return flash_attention(q, k, v, causal=True, q_chunk=min(cfg.flash_q_chunk, q.shape[1]),
                               k_chunk=min(cfg.flash_k_chunk, k.shape[1]), q_offset=q_offset)
    return _attend(q, k, v, causal=True, q_offset=q_offset)


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
            ctx: ShardCtx = NO_SHARD, mesh=None, return_cache: bool = False):
    """tokens [B, S] -> (logits [B, S, V] f32, aux_loss scalar[, cache]).

    ``return_cache=True`` (the prefill step) also returns the stacked KV
    cache ([L, B, S, ...]; GQA: post-rope k/v, MLA: latent ``c_kv`` and
    ``k_rope``) ready for ``decode_step``.

    Over ``mesh`` (see the module docstring) ``model`` holds this rank's
    parameter slices, ``tokens`` is this rank's batch block (every
    position), and the logits are this rank's layout: vocab-parallel
    ``[B, S, V / |tp|]`` where the vocabulary splits over ``tp``, else
    ``[B, S / |tp|, V]`` (``[B, S, V]`` without ``sp``); the cache is in
    ``cache_specs``' layout."""
    ranks = _ranks(cfg, ctx, mesh)
    if ranks is not None:
        h, aux, cache = ranks.trunk(model, tokens, return_cache)
        logits = ranks.logits(h, ranks.weight("lm_head", model.lm_head))
    else:
        h, aux, cache = _trunk(model, tokens, cfg, return_cache)
        logits = _head(model, h, cfg)
    return (logits, aux, cache) if return_cache else (logits, aux)


def prefill(model: Transformer, tokens: torch.Tensor, cfg: TransformerConfig,
            ctx: ShardCtx = NO_SHARD, mesh=None):
    """``forward(..., return_cache=True)`` with the logits of the last
    position only: (logits [B, V] f32, cache). The head of one row is the
    same product as that row of the full head, without the [B, S, V]
    logits (20 GB at 32k tokens of a 152k vocabulary). Over ``mesh``: this
    rank's batch block's logits (every vocabulary entry) and its cache
    slices in ``cache_specs``' layout."""
    ranks = _ranks(cfg, ctx, mesh)
    if ranks is not None:
        h, _aux, cache = ranks.trunk(model, tokens, True)
        return ranks.head_last(h, ranks.weight("lm_head", model.lm_head)), cache
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
            cfg: TransformerConfig, params: dict | None = None, ctx: ShardCtx = NO_SHARD,
            mesh=None) -> torch.Tensor:
    """The training loss: the mean token cross-entropy of the logits, plus
    0.1 x the MTP loss (``cfg.mtp``), plus ``router_aux_coef`` x the MoE
    layers' summed load-balance loss. ``params`` (tensors by parameter
    name) stand in for the model's own, through ``functional_call``.

    Over ``mesh``: ``tokens`` and ``labels`` are this rank's batch block
    (every position), the parameters this rank's slices, and the loss is
    the global batch's, the same on every rank. Its gradients are the
    slices' own (``_Ranks.weight``), but for the count ``grad_sum_axes``
    divides by."""
    ranks = _ranks(cfg, ctx, mesh)
    fn = _loss if ranks is None else (lambda m, t, l, c: ranks.loss(m, t, l))
    if params is None:
        return fn(model, tokens, labels, cfg)
    return torch.func.functional_call(
        _Apply(model), {f"model.{k}": v for k, v in params.items()},
        (fn, tokens, labels, cfg))


def _loss(model: Transformer, tokens, labels, cfg: TransformerConfig) -> torch.Tensor:
    logits, aux = forward(model, tokens, cfg)
    loss = cross_entropy(logits, labels)
    if cfg.mtp:
        loss = loss + 0.1 * _mtp_loss(model, tokens, labels, cfg)
    coef = cfg.moe.router_aux_coef if cfg.moe else 0.0
    return loss + coef * aux


def _mtp_loss(model: Transformer, tokens, labels, cfg: TransformerConfig,
              ctx: ShardCtx = NO_SHARD, mesh=None) -> torch.Tensor:
    """DeepSeek-V3 MTP (depth 1): predict token t+2 from the t-th hidden
    state combined with the embedding of token t+1 (the labels rolled by
    -1); the last two positions, whose targets wrapped round, are left
    out. Over ``mesh``, in this rank's layout (``loss_fn``'s)."""
    ranks = _ranks(cfg, ctx, mesh)
    if ranks is not None:
        return ranks.mtp_loss(model, tokens, labels)
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
               device=None, mesh=None, specs: dict | None = None) -> dict:
    """KV cache. GQA: K/V per layer; MLA: latent + rope cache. ``device``
    None means the GPU, and raises without one.

    ``kv_cache_dtype="int8"`` (GQA only): entries are stored int8 with one
    f32 scale per (layer, batch, position, kv-head).

    With ``mesh`` and ``specs`` (``decode_cache_specs``, ``cache_specs``),
    this rank's slice of each, on the mesh's device."""
    if mesh is not None:
        whole = init_cache(cfg, batch, max_len, dtype, device="meta")
        dev = mesh.device
        return {k: torch.zeros(local_shape(v.shape, specs[k], mesh), dtype=v.dtype, device=dev)
                for k, v in whole.items()}
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
                cfg: TransformerConfig, ctx: ShardCtx = NO_SHARD,
                mesh=None) -> tuple[torch.Tensor, dict]:
    """One decode step: tokens [B] -> (logits [B, V], cache with the new
    entries written in place).

    ``cache_len`` — number of valid entries (= absolute position of the new
    token), an int or a 0-d integer tensor. With a sliding window the cache
    is a ring buffer of size W. A slot past the cache's end writes its last
    entry, as the reference's ``dynamic_update_slice`` clamps.

    Over ``mesh`` (``ctx = ShardCtx(mesh, dp)``, ``dp = ()`` for the
    replicated-token decode of a batch of one): this rank's tokens (its
    batch block, or every token) and cache slices in
    ``decode_cache_specs``' layout; the logits of its tokens, every
    vocabulary entry."""
    blocks = model.blocks()
    n_cached = next(iter(cache.values())).shape[0]
    if n_cached != len(blocks):
        raise ValueError(f"the cache holds {n_cached} layers; {cfg.name} has {len(blocks)}")
    dev = tokens.device
    n = (cache_len.to(device=dev, dtype=torch.int64) if torch.is_tensor(cache_len)
         else torch.full((), cache_len, dtype=torch.int64, device=dev))
    ranks = _ranks(cfg, ctx, mesh)
    if ranks is not None:
        if ctx.sp:
            raise ValueError("decode runs without sp: ShardCtx(mesh, dp)")
        # the reference decodes a batch of one with no batch axes
        layout = decode_cache_specs(cfg, mesh, 2 if ctx.dp else 1)
        return ranks.decode_step(model, cache, tokens, n, layout)
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


# ---------------------------------------------------------------------------
# over a mesh: a rank's share of the reference's sharded program
# ---------------------------------------------------------------------------
_WHOLE_KEYS = ("shared_wg", "shared_wi", "shared_wo")   # used on a rank's own tokens


class _TokenNLL(torch.autograd.Function):
    """Each position's ``logsumexp(lg) - lg[label]`` over the last dim
    (float32 logits), whose backward writes ``softmax(lg) - onehot(label)``
    into one new tensor: autograd of the two terms holds four more
    logits-sized tensors at once (2.3 GiB each for a zero3 rank's
    vocabulary-wide logits at qwen2.5-3b's train_4k)."""

    @staticmethod
    def forward(ctx, lg, lab):
        lse = torch.logsumexp(lg, dim=-1)
        ctx.save_for_backward(lg, lab, lse)
        return lse - torch.gather(lg, -1, lab[..., None])[..., 0]

    @staticmethod
    def backward(ctx, g):
        lg, lab, lse = ctx.saved_tensors
        p = (lg - lse[..., None]).exp_()
        p.scatter_add_(-1, lab[..., None], torch.full_like(lse, -1.0)[..., None])
        return p.mul_(g[..., None]), None


class _Ranks:
    """A rank's layout for one call over ``mesh`` (see the module
    docstring): its parameter specs, its place along the tensor axis, and
    the collectives of its layers."""

    def __init__(self, cfg: TransformerConfig, ctx: ShardCtx, mesh):
        if not isinstance(mesh, collective.Mesh):
            raise ValueError(f"{type(mesh).__name__} is a layout, not a mesh of ranks: run "
                             f"over a core.collective.Mesh")
        if ctx.mesh is not None and ctx.mesh != mesh:
            raise ValueError("ctx.mesh and mesh differ")
        self.cfg, self.ctx, self.mesh = cfg, ctx, mesh
        self.zero3 = ctx.tp is None
        self.specs = param_specs_zero3(cfg, mesh) if self.zero3 else param_specs(cfg, mesh)
        self.shapes = param_shapes(cfg)
        self.tp = ctx.tp
        self.n_tp = mesh.axis_size(self.tp) if self.tp else 1
        self.i_tp = mesh.axis_index(self.tp) if self.tp else 0
        self.dp = tuple(ctx.dp)
        self.sp = ctx.act3()[1] is not None          # the sequence over tp between blocks
        self.vocab_split = not self.zero3 and _div(cfg.vocab, self.n_tp)
        # a block's heads over tp where the query heads, and GQA's key heads, split
        self.heads_split = ctx.act4(
            cfg.n_heads, None if cfg.attn == "mla" else cfg.n_kv_heads)[2] is not None

    # -- weights -----------------------------------------------------------
    def weight(self, name: str, t: torch.Tensor, whole: bool = False) -> torch.Tensor:
        """``t``, this rank's slice of ``name``, gathered over every axis of
        its spec but the tensor axis (``whole``: that too; ZeRO-3 gathers
        everything). Its backward leaves the slice's gradient of this use:
        each gather's backward sums the ranks' cotangents and keeps this
        rank's block, and the axes that split the tokens but not the weight
        (``grad_sum_axes``) are summed at the slice's size. Call it once a
        slice and loss: every call sums its own share."""
        keep = () if (whole or self.zero3) else (self.tp,)
        summed, gathered, _ = grad_sum_axes(self.specs[name], self.ctx, self.mesh)
        tokens = tuple(a for a in summed if a not in gathered)
        if self.mesh.axis_size(tokens) > 1:
            t = collective.sum_grad(t, self.mesh, tokens)
        for dim, names in enumerate(norm_spec(self.specs[name], len(self.shapes[name]))):
            pick = tuple(a for a in names if a not in keep)
            if pick:
                t = gather_dim(t, dim, self.mesh, pick)
        return t

    def block(self, w: dict, prefix: str) -> dict:
        """A layer's slices (``_weights``) gathered for this rank's use."""
        out = {"ln1": self.weight(f"{prefix}.ln1", w["ln1"]),
               "ln2": self.weight(f"{prefix}.ln2", w["ln2"]),
               "attn": {k: self.weight(f"{prefix}.attn.{k}", v) for k, v in w["attn"].items()}}
        if "moe" in w:
            out["moe"] = {k: self.weight(f"{prefix}.moe.{k}", v, whole=k in _WHOLE_KEYS)
                          for k, v in w["moe"].items()}
        else:
            out.update({k: self.weight(f"{prefix}.{k}", w[k]) for k in ("wg", "wi", "wo")})
        return out

    def blocks(self, model: "Transformer") -> list[tuple[str, "Block"]]:
        out = [(f"dense_blocks.{i}", b) for i, b in enumerate(model.dense_blocks or ())]
        return out + [(f"moe_blocks.{i}", b) for i, b in enumerate(model.moe_blocks or ())]

    # -- the sequence over the tensor axis ---------------------------------
    def seq_in(self, y: torch.Tensor) -> torch.Tensor:
        """The whole sequence of this rank's batch (gathered over ``tp``
        with ``sp``)."""
        return gather_dim(y, 1, self.mesh, self.tp) if self.sp else y

    def seq_out(self, part: torch.Tensor, dtype) -> torch.Tensor:
        """A row-parallel product's partial sums over ``tp``, summed in
        float32 and (with ``sp``) split back to this rank's sequence block."""
        out = collective.all_reduce_sum(part.float(), self.mesh, self.tp)
        if self.sp:
            out = split_dim(out, 1, self.mesh, self.tp)
        return out.to(dtype)

    def cols(self, t: torch.Tensor) -> torch.Tensor:
        """Every column of a column-parallel product (gathered over ``tp``)."""
        return gather_dim(t, t.dim() - 1, self.mesh, self.tp)

    def rows(self, o: torch.Tensor) -> torch.Tensor:
        """This rank's block of ``o``'s last dim: the rows of its
        row-parallel weight (no collective: the cotangent is this rank's
        share, which the gathers before it sum)."""
        w = o.shape[-1] // self.n_tp
        return o.narrow(-1, self.i_tp * w, w)

    # -- embedding, head, loss ---------------------------------------------
    def embed(self, tokens: torch.Tensor, e: torch.Tensor) -> torch.Tensor:
        """The embeddings of ``tokens`` ([B, S], this rank's batch, every
        position) in this rank's layout, ``e`` the table from
        ``weight("embed")``: vocab-parallel lookups summed over ``tp`` (and
        split over the sequence with ``sp``)."""
        if not self.vocab_split:
            if self.sp:
                w = tokens.shape[1] // self.n_tp
                tokens = tokens.narrow(1, self.i_tp * w, w)
            return F.embedding(tokens.long(), e)
        rows = self.cfg.vocab // self.n_tp
        ids = tokens.long() - self.i_tp * rows
        ok = (ids >= 0) & (ids < rows)
        out = F.embedding(ids.clamp(0, rows - 1), e)
        out = torch.where(ok[..., None], out, _scalar(0, out, out.dtype))
        out = collective.all_reduce_sum(out, self.mesh, self.tp)
        return split_dim(out, 1, self.mesh, self.tp) if self.sp else out

    def logits(self, h: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """float32 logits of the normed ``h`` in this rank's layout, ``w``
        the head from ``weight("lm_head")``: vocab-parallel ``[B, S, V /
        |tp|]`` over the whole sequence, or ``[B, S_rank, V]``."""
        cd = self.cfg.compute_dtype
        if self.vocab_split:
            h = self.seq_in(h)
        return (h.to(cd) @ w.to(cd)).to(F32)

    def head_last(self, h: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """float32 logits [B, V] of the sequence's last position, every
        vocabulary entry on every rank (``w`` as ``logits``')."""
        cd = self.cfg.compute_dtype
        last = self.seq_in(h)[:, -1]
        lg = (last.to(cd) @ w.to(cd)).to(F32)
        return self.cols(lg) if self.vocab_split else lg

    def cross_entropy(self, h: torch.Tensor, w: torch.Tensor, labels: torch.Tensor,
                      drop: int = 0) -> torch.Tensor:
        """The mean float32 token cross-entropy over the global batch's
        positions ``[0, S - drop)``, the same on every rank: vocab-parallel
        (the max, the exponentials' sum and the label's logit over ``tp``)
        where the vocabulary splits. ``labels`` [B, S]: this rank's batch;
        ``w`` as ``logits``'."""
        b, s = labels.shape
        count = b * self.mesh.axis_size(self.dp) * (s - drop)
        lg = self.logits(h, w)
        if self.vocab_split:
            lg, lab = lg[:, :s - drop], labels[:, :s - drop].long()
            m = collective.all_reduce_max(lg.detach().amax(-1), self.mesh, self.tp)
            se = collective.all_reduce_sum(torch.exp(lg - m[..., None]).sum(-1), self.mesh,
                                           self.tp)
            rows = self.cfg.vocab // self.n_tp
            ids = lab - self.i_tp * rows
            ok = (ids >= 0) & (ids < rows)
            ll = torch.gather(lg, -1, ids.clamp(0, rows - 1)[..., None])[..., 0]
            ll = collective.all_reduce_sum(torch.where(ok, ll, _scalar(0, ll)), self.mesh,
                                           self.tp)
            per, axes = m + torch.log(se) - ll, self.dp
        else:
            w = lg.shape[1]
            start = self.i_tp * w if self.sp else 0
            lab = labels[:, start:start + w].long()
            per = _TokenNLL.apply(lg, lab)
            pos = start + torch.arange(w, device=per.device)
            per = torch.where(pos[None, :] < s - drop, per, _scalar(0, per))
            axes = self.dp + ((self.tp,) if self.sp else ())
        total = per.sum() / _scalar(count, per)
        return collective.all_reduce_sum(total, self.mesh, axes)

    # -- a layer -----------------------------------------------------------
    def layer(self, h, aux, w: dict, use_flash: bool, collect_cache: bool):
        """One layer on this rank's residual stream: (h, aux, cache)."""
        cfg = self.cfg
        if self.zero3:
            if "moe" in w:
                raise NotImplementedError("the ZeRO-3 layout runs dense configs (qwen2.5, phi3) "
                                          "only; MoE layers take the tp_sp layout")
            return _block(h, aux, w, cfg, use_flash, collect_cache)
        attn = self.mla if cfg.attn == "mla" else self.gqa
        att, cache = attn(rms_norm(h, w["ln1"]), w["attn"], cfg, use_flash, collect_cache)
        h = h + att
        y = rms_norm(h, w["ln2"])
        if "moe" not in w:
            return h + self.swiglu(y, w["wg"], w["wi"], w["wo"]), aux, cache
        ff, a = self.moe(y, w["moe"])
        return h + ff, aux + a, cache

    def swiglu(self, y, wg, wi, wo) -> torch.Tensor:
        cd = self.cfg.compute_dtype
        xc = self.seq_in(y).to(cd)
        g = F.silu(xc @ wg.to(cd)) * (xc @ wi.to(cd))
        return self.seq_out(g @ wo.to(cd), y.dtype)

    def moe(self, y, p: dict):
        cfg = self.cfg
        fn = moe_ep if _div(cfg.moe.n_experts, self.n_tp) else moe_tp
        return fn(y, p, cfg.moe, mesh=self.mesh, dp=self.dp, tp=self.tp, sp=self.sp)

    def _to_seq_blocks(self, t: torch.Tensor) -> torch.Tensor:
        """A prefill cache tensor [B, S, h_rank, ...] of this rank's heads
        as [B, S / |tp|, H, ...]: its sequence block of every head (one
        all-to-all over ``tp``; a copy of the block where the heads are
        whole, so that the layer's cache holds no more)."""
        b, s = t.shape[:2]
        w = s // self.n_tp
        if self.n_tp == 1:
            return t
        if not self.heads_split:
            return t.narrow(1, self.i_tp * w, w).clone()   # not a view of every position
        blocks = t.reshape(b, self.n_tp, w, *t.shape[2:]).movedim(1, 0)
        got = collective.all_to_all(blocks.contiguous(), self.mesh, self.tp)
        return got.movedim(0, 2).reshape(b, w, self.n_tp * t.shape[2], *t.shape[3:])

    def gqa(self, y, ap, cfg: TransformerConfig, use_flash: bool, collect_cache: bool):
        """GQA on this rank's stream. Heads split over ``tp``: this rank's
        heads over the whole sequence (column-parallel ``wq``, ``wk``,
        ``wv``; row-parallel ``wo`` summed over ``tp``). Else the
        reference's ``act4``: this rank's rows (its sequence block with
        ``sp``) of every head, its queries against ``wq`` gathered whole,
        every key and value (column-parallel, gathered), and ``wo``
        gathered whole, whose product is this rank's block of the output."""
        yf = self.seq_in(y)
        b, s, _ = yf.shape
        hd, h, kv = cfg.hd, cfg.n_heads, cfg.n_kv_heads
        cd = cfg.compute_dtype
        xc = yf.to(cd)
        k, v = xc @ ap["wk"].to(cd), xc @ ap["wv"].to(cd)
        if cfg.qkv_bias:
            k, v = k + ap["bk"].to(cd), v + ap["bv"].to(cd)
        wq, wo = ap["wq"], ap["wo"]
        bq = ap["bq"] if cfg.qkv_bias else None
        if self.heads_split:
            h, kv = h // self.n_tp, kv // self.n_tp
            xq, start = xc, 0
        else:
            k, v = self.cols(k), self.cols(v)
            xq, start = y.to(cd), (self.i_tp * y.shape[1] if self.sp else 0)
            wq, wo = self.cols(wq), gather_dim(wo, 0, self.mesh, self.tp)
            bq = None if bq is None else self.cols(bq)
        q = xq @ wq.to(cd)
        if bq is not None:
            q = q + bq.to(cd)
        sq = q.shape[1]
        q = q.reshape(b, sq, h, hd)
        k = k.reshape(b, s, kv, hd)
        v = v.reshape(b, s, kv, hd)
        q = apply_rope(q, (start + torch.arange(sq, device=y.device))[None, :], cfg.rope_theta)
        k = apply_rope(k, torch.arange(s, device=y.device)[None, :], cfg.rope_theta)
        o = _flash_or_plain(q, k, v, cfg, use_flash, q_offset=start).reshape(b, sq, h * hd)
        o = o.to(cd) @ wo.to(cd)
        out = self.seq_out(o, y.dtype) if self.heads_split else o.to(y.dtype)
        if not collect_cache:
            return out, None
        return out, {"k": self._to_seq_blocks(k), "v": self._to_seq_blocks(v)}

    def mla(self, y, ap, cfg: TransformerConfig, use_flash: bool, collect_cache: bool):
        """MLA on this rank's stream. Heads split over ``tp``: this rank's
        heads over the whole sequence (column-parallel ``wq_b`` and
        ``wkv_b``, row-parallel ``wo`` summed over ``tp``). Else the
        reference's ``act4``, as ``gqa``'s: this rank's rows (its sequence
        block with ``sp``) of every head, its queries against ``wq_b``
        gathered whole, every head's keys and values (column-parallel
        ``wkv_b`` on the whole sequence, gathered), and ``wo`` gathered
        whole, whose product is this rank's block of the output."""
        yf = self.seq_in(y)
        b, s, _ = yf.shape
        dn, dr, dv = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
        cd = cfg.compute_dtype
        xc = yf.to(cd)
        ckv = xc @ ap["wkv_a"].to(cd)
        c_kv = rms_norm(ckv[..., :cfg.kv_lora_rank], ap["kv_norm"])
        k_rope = ckv[..., cfg.kv_lora_rank:].reshape(b, s, 1, dr)
        kvm = c_kv.to(cd) @ ap["wkv_b"].to(cd)
        wq_b, wo = ap["wq_b"], ap["wo"]
        if self.heads_split:
            h, xq, start = cfg.n_heads // self.n_tp, xc, 0
        else:
            h, kvm = cfg.n_heads, self.cols(kvm)
            xq, start = y.to(cd), (self.i_tp * y.shape[1] if self.sp else 0)
            wq_b, wo = self.cols(wq_b), gather_dim(wo, 0, self.mesh, self.tp)
        cq = rms_norm(xq @ ap["wq_a"].to(cd), ap["q_norm"])
        q = cq.to(cd) @ wq_b.to(cd)
        sq = q.shape[1]
        q = q.reshape(b, sq, h, dn + dr)
        q_nope, q_rope = q[..., :dn], q[..., dn:]
        q_rope = apply_rope(q_rope, (start + torch.arange(sq, device=y.device))[None, :],
                            cfg.rope_theta)
        k_rope = apply_rope(k_rope, torch.arange(s, device=y.device)[None, :], cfg.rope_theta)
        kvm = kvm.reshape(b, s, h, dn + dv)
        k_nope, v = kvm[..., :dn], kvm[..., dn:]
        q_full = torch.cat([q_nope, q_rope], dim=-1)
        k_full = torch.cat([k_nope, k_rope.expand(b, s, h, dr)], dim=-1)
        o = _flash_or_plain(q_full, k_full, v, cfg, use_flash, q_offset=start)
        o = o.reshape(b, sq, h * dv).to(cd) @ wo.to(cd)
        out = self.seq_out(o, y.dtype) if self.heads_split else o.to(y.dtype)
        if not collect_cache:
            return out, None
        w = s // self.n_tp
        # copies of this rank's block: a view would hold every position
        return out, {"c_kv": c_kv.narrow(1, self.i_tp * w, w).clone(),
                     "k_rope": k_rope[:, :, 0].narrow(1, self.i_tp * w, w).clone()}

    # -- the trunk and the losses ------------------------------------------
    def trunk(self, model: "Transformer", tokens: torch.Tensor, return_cache: bool,
              e: torch.Tensor | None = None):
        """(h normed [B, S_rank, D], aux, cache in ``cache_specs``' layout or
        None); ``e`` the table from ``weight("embed")`` (None: gathered
        here). Under remat each block gathers its weights inside its
        checkpoint: the gathered weights live for its forward and again for
        its recompute in the backward, whose gathers leave each slice's
        gradient as the backward leaves the block."""
        cfg = self.cfg
        s = tokens.shape[1]
        if self.sp and s % self.n_tp:
            raise ValueError(f"a sequence of {s} does not split over |{self.tp}| = {self.n_tp}")
        use_flash = s >= 2048
        remat = cfg.remat and torch.is_grad_enabled() and not return_cache
        h = self.embed(tokens, self.weight("embed", model.embed) if e is None else e)
        aux = torch.zeros((), dtype=F32, device=h.device)
        caches = []
        for prefix, lp in self.blocks(model):
            if remat:
                h, aux, _ = checkpoint(self._gathered_layer, h, aux, _weights(lp), prefix,
                                       use_flash, use_reentrant=False, preserve_rng_state=False)
            else:
                h, aux, cache = self.layer(h, aux, self.block(_weights(lp), prefix), use_flash,
                                           return_cache)
                caches.append(cache)
        h = rms_norm(h, self.weight("final_norm", model.final_norm))
        if not return_cache:
            return h, aux, None
        return h, aux, {k: torch.stack([c[k] for c in caches]) for k in caches[0]}

    def _gathered_layer(self, h, aux, slices: dict, prefix: str, use_flash: bool):
        return self.layer(h, aux, self.block(slices, prefix), use_flash, False)

    def loss(self, model: "Transformer", tokens, labels) -> torch.Tensor:
        cfg = self.cfg
        e = self.weight("embed", model.embed)
        head = self.weight("lm_head", model.lm_head)
        h, aux, _ = self.trunk(model, tokens, False, e)
        loss = self.cross_entropy(h, head, labels)
        if cfg.mtp:
            loss = loss + 0.1 * self.mtp_loss(model, tokens, labels, e, head)
        coef = cfg.moe.router_aux_coef if cfg.moe else 0.0
        return loss + coef * aux

    def mtp_loss(self, model: "Transformer", tokens, labels, e: torch.Tensor | None = None,
                 head: torch.Tensor | None = None) -> torch.Tensor:
        """``_mtp_loss`` in this rank's layout (``e``, ``head``: the tables
        from ``weight``; None: gathered here)."""
        cfg = self.cfg
        mp = model.mtp
        cd = cfg.compute_dtype
        e = self.weight("embed", model.embed) if e is None else e
        head = self.weight("lm_head", model.lm_head) if head is None else head
        ln = self.weight("mtp.ln", mp.ln)
        h = self.embed(tokens, e)
        nxt = self.embed(torch.roll(labels, -1, dims=1), e)
        z = torch.cat([rms_norm(h, ln), nxt.to(h.dtype)], dim=-1)
        z = z.to(cd) @ self.weight("mtp.proj", mp.proj).to(cd)
        w = self.block(_weights(mp.block), "mtp.block")
        c = replace(cfg, remat=False)
        use_flash = tokens.shape[1] >= 2048
        if self.zero3:
            z = z + _gqa_mtp(rms_norm(z, w["ln1"]), w, cfg)
            z = z + swiglu(rms_norm(z, w["ln2"]), w["wg"], w["wi"], w["wo"], cd)
        else:
            attn = self.mla if cfg.attn == "mla" else self.gqa
            z = z + attn(rms_norm(z, w["ln1"]), w["attn"], c, use_flash, False)[0]
            z = z + self.swiglu(rms_norm(z, w["ln2"]), w["wg"], w["wi"], w["wo"])
        tgt = torch.roll(labels, -2, dims=1)
        return self.cross_entropy(rms_norm(z, ln), head, tgt, drop=2)

    # -- decode ------------------------------------------------------------
    def decode_step(self, model: "Transformer", cache: dict, tokens, n, cache_specs_: dict):
        """``decode_step`` on this rank's tokens and cache slices."""
        cfg = self.cfg
        window = cfg.sliding_window
        key = next(iter(cache))
        spec = norm_spec(cache_specs_[key], cache[key].dim())
        seq_axes = spec[2]
        s_local = cache[key].shape[2]
        s_cache = s_local * self.mesh.axis_size(seq_axes)
        slot = torch.clamp(n % window if window else n, max=s_cache - 1)
        start = self.mesh.axis_index(seq_axes) * s_local
        h = self.embed(tokens[:, None], self.weight("embed", model.embed))   # [B,1,D]
        decode = self.mla_decode if cfg.attn == "mla" else self.gqa_decode
        for li, (prefix, lp) in enumerate(self.blocks(model)):
            w = self.block(_weights(lp), prefix)
            layer_cache = {k: v[li] for k, v in cache.items()}
            y = rms_norm(h, w["ln1"])
            h = h + decode(y, w["attn"], layer_cache, n, slot, start, s_cache, seq_axes)
            y2 = rms_norm(h, w["ln2"])
            if "moe" in w:
                h = h + self.moe(y2, w["moe"])[0]
            else:
                h = h + self.swiglu(y2, w["wg"], w["wi"], w["wo"])
        h = rms_norm(h, self.weight("final_norm", model.final_norm))
        return self.head_last(h, self.weight("lm_head", model.lm_head)), cache

    def _write(self, c: torch.Tensor, new: torch.Tensor, slot, start: int) -> None:
        """Write ``new`` [B, 1, ...] at global position ``slot`` of the cache
        block ``c`` [B, S_rank, ...] that starts at ``start``: on the rank
        that holds it (a masked write elsewhere; no host read)."""
        s_local = c.shape[1]
        local = slot - start
        owner = (local >= 0) & (local < s_local)
        idx = torch.clamp(local, 0, s_local - 1).view(1)
        old = c.index_select(1, idx)
        c.index_copy_(1, idx, torch.where(owner, new.to(c.dtype), old))

    def _softmax(self, scores: torch.Tensor, seq_axes) -> torch.Tensor:
        """Softmax over the last dim, the sequence split over ``seq_axes``:
        the max, then the sum, combined over their ranks."""
        if self.mesh.axis_size(seq_axes) == 1:
            return torch.softmax(scores, dim=-1)
        m = collective.all_reduce_max(scores.amax(-1, keepdim=True), self.mesh, seq_axes)
        p = torch.exp(scores - m)
        return p / collective.all_reduce_sum(p.sum(-1, keepdim=True), self.mesh, seq_axes)

    def gqa_decode(self, x, ap, c: dict, n, slot, start: int, s_cache: int, seq_axes):
        cfg = self.cfg
        b = x.shape[0]
        hd, h, kv = cfg.hd, cfg.n_heads, cfg.n_kv_heads
        cd = cfg.compute_dtype
        xc = x.to(cd)
        q, k, v = xc @ ap["wq"].to(cd), xc @ ap["wk"].to(cd), xc @ ap["wv"].to(cd)
        if cfg.qkv_bias:
            q, k, v = q + ap["bq"].to(cd), k + ap["bk"].to(cd), v + ap["bv"].to(cd)
        q, k, v = self.cols(q), self.cols(k), self.cols(v)
        q = q.reshape(b, 1, h, hd)
        k = k.reshape(b, 1, kv, hd)
        v = v.reshape(b, 1, kv, hd)
        pos = _positions(n, b)
        q = apply_rope(q, pos, cfg.rope_theta)
        k = apply_rope(k, pos, cfg.rope_theta)
        hl = hd // self.n_tp
        cut = slice(self.i_tp * hl, (self.i_tp + 1) * hl)
        if cfg.kv_cache_dtype == "int8":
            k8, ks = _quant(k)
            v8, vs = _quant(v)
            for key, new in (("k", k8[..., cut]), ("v", v8[..., cut]), ("k_scale", ks),
                             ("v_scale", vs)):
                self._write(c[key], new, slot, start)
            ck = c["k"].to(cd) * c["k_scale"].to(cd)[..., None]
            cv = c["v"].to(cd) * c["v_scale"].to(cd)[..., None]
        else:
            self._write(c["k"], k[..., cut], slot, start)
            self._write(c["v"], v[..., cut], slot, start)
            ck, cv = c["k"].to(cd), c["v"].to(cd)
        s_local = ck.shape[1]
        qs = q[..., cut].reshape(b, 1, kv, h // kv, hl)
        scores = torch.einsum("bqgrd,bkgd->bgrqk", qs, ck).reshape(b, h, 1, s_local).to(F32)
        scores = collective.all_reduce_sum(scores, self.mesh, self.tp)
        scores = scores / torch.sqrt(_scalar(hd, scores))
        kpos = start + torch.arange(s_local, device=x.device)
        valid = torch.clamp(n + 1, max=s_cache)
        scores = torch.where(kpos < valid, scores, _scalar(MASKED, scores))
        probs = self._softmax(scores, seq_axes)
        o = _weigh(probs.to(cv.dtype), cv)                         # [B,1,H,hd/|tp|]
        if self.mesh.axis_size(seq_axes) > 1:
            o = collective.all_reduce_sum(o.float(), self.mesh, seq_axes).to(cv.dtype)
        o = self.cols(o).reshape(b, 1, h * hd)
        return self.seq_out(self.rows(o).to(cd) @ ap["wo"].to(cd), x.dtype)

    def mla_decode(self, x, ap, c: dict, n, slot, start: int, s_cache: int, seq_axes):
        """Absorbed MLA decode, this rank's heads; the latent over ``tp``
        (batch > 1) or the sequence over every axis (batch 1)."""
        cfg = self.cfg
        if not self.heads_split:
            raise NotImplementedError(f"MLA decode over a mesh needs the {cfg.n_heads} heads "
                                      f"to split over |{self.tp}| = {self.n_tp}")
        b = x.shape[0]
        h = cfg.n_heads // self.n_tp
        dn, dr, dv, kvr = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim, cfg.kv_lora_rank
        cd = cfg.compute_dtype
        xc = x.to(cd)
        cq = rms_norm(xc @ ap["wq_a"].to(cd), ap["q_norm"])
        q = (cq.to(cd) @ ap["wq_b"].to(cd)).reshape(b, 1, h, dn + dr)
        q_nope, q_rope = q[..., :dn], q[..., dn:]
        pos = _positions(n, b)
        q_rope = apply_rope(q_rope, pos, cfg.rope_theta)
        ckv = xc @ ap["wkv_a"].to(cd)
        c_new = rms_norm(ckv[..., :kvr], ap["kv_norm"])
        kr_new = apply_rope(ckv[..., None, kvr:], pos, cfg.rope_theta)[:, :, 0]
        cc, cr = c["c_kv"], c["k_rope"]
        lat = cc.shape[-1] < kvr                      # the latent over tp
        ll = cc.shape[-1]
        cut = slice(self.i_tp * ll, (self.i_tp + 1) * ll) if lat else slice(None)
        self._write(cc, c_new[..., cut], slot, start)
        self._write(cr, kr_new, slot, start)
        wkv_b = ap["wkv_b"].to(cd).reshape(kvr, h, dn + dv)
        w_uk, w_uv = wkv_b[..., :dn], wkv_b[..., dn:]
        q_abs = torch.einsum("bhd,khd->bhk", q_nope[:, 0].to(cd), w_uk)   # this rank's heads
        q_abs = gather_dim(q_abs, 1, self.mesh, self.tp)                  # every head
        q_r = gather_dim(q_rope[:, 0].to(cd).contiguous(), 1, self.mesh, self.tp)
        s_nope = torch.einsum("bhk,bsk->bhs", q_abs[..., cut], cc.to(cd)).to(F32)
        if lat:
            s_nope = collective.all_reduce_sum(s_nope, self.mesh, self.tp)
        s_rope = torch.einsum("bhd,bsd->bhs", q_r, cr.to(cd)).to(F32)
        scores = (s_nope + s_rope) / torch.sqrt(_scalar(float(dn + dr), s_nope))
        s_local = cc.shape[1]
        kpos = start + torch.arange(s_local, device=x.device)[None, None, :]
        scores = torch.where(kpos < torch.clamp(n + 1, max=s_cache), scores,
                             _scalar(MASKED, scores))
        p = self._softmax(scores, seq_axes)
        ctx_lat = torch.einsum("bhs,bsk->bhk", p.to(cd), cc.to(cd))
        if lat:
            ctx_lat = self.cols(ctx_lat)
        elif self.mesh.axis_size(seq_axes) > 1:
            ctx_lat = collective.all_reduce_sum(ctx_lat.float(), self.mesh, seq_axes).to(cd)
        mine = ctx_lat.narrow(1, self.i_tp * h, h)
        o = torch.einsum("bhk,khv->bhv", mine, w_uv).reshape(b, 1, h * dv)
        return self.seq_out(o.to(cd) @ ap["wo"].to(cd), x.dtype)


def _ranks(cfg: TransformerConfig, ctx: ShardCtx, mesh) -> _Ranks | None:
    if mesh is None:
        if ctx.mesh is not None:
            raise ValueError("ctx names a mesh: pass it as mesh= too")
        return None
    return _Ranks(cfg, ctx, mesh)


__all__ = ["TransformerConfig", "Transformer", "Block", "MTP", "init_params", "forward",
           "prefill", "loss_fn", "init_cache", "decode_step", "param_specs",
           "param_specs_zero3", "param_shapes", "specs_from_jax", "cache_specs",
           "decode_cache_specs", "sharded", "grad_sum_axes", "ShardCtx", "NO_SHARD"]
