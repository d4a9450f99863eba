"""Transformer building blocks: RMSNorm, RoPE, GQA/MLA attention, SwiGLU,
flash (chunked online-softmax) attention, and cross-entropy.

The port of the JAX package's ``models/layers.py`` for one device: plain
functions on tensors, with the reference's casts kept. Weights are in JAX's
``[in, out]`` layout (``x @ w``). Softmax, norm statistics and the loss are
float32 whatever the compute dtype. Every float32 quotient has a tensor
divisor on the operand's device (``_scalar``): CUDA multiplies by the
reciprocal of a Python-scalar (or CPU-scalar) divisor, which is not the
quotient JAX computes.

``ShardCtx`` and ``NO_SHARD`` carry the reference's fields (``mesh``,
``dp``, ``tp``, ``sp``). In the reference they are sharding constraints on
one program; in the port, where every rank runs its own share, they name the
layout a rank holds its activations in (``act3``, ``act4``), which
``models/transformer.py`` follows over a mesh.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

F32 = torch.float32
MASKED = -1e30   # the reference's fill for masked scores


# ---------------------------------------------------------------------------
# a rank's layout over a mesh
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class ShardCtx:
    """The layout of a rank's activations. ``mesh=None`` is one device.

    ``dp`` names the batch axes, ``tp`` the tensor axis (None: no tensor
    parallelism, the ZeRO-3 layout), ``sp`` splits the sequence over
    ``tp`` between blocks (training and prefill)."""

    mesh: Any = None
    dp: tuple[str, ...] = ("data",)   # batch axes (("pod","data") multi-pod)
    tp: str | None = "model"          # tensor axis
    sp: bool = False                  # shard sequence dim over tp (long prefill)

    def tp_size(self) -> int:
        if self.mesh is None or self.tp is None:
            return 1
        from repro_torch.launch.mesh import axis_sizes

        return axis_sizes(self.mesh)[self.tp]

    def act3(self) -> tuple:
        """The spec of the ``[B, S, D]`` residual stream a rank holds
        between blocks: the batch over ``dp``, the sequence over ``tp`` with
        ``sp``."""
        return (self.dp, self.tp if self.sp else None, None)

    def act4(self, n_heads: int, n_kv_heads: int | None = None) -> tuple:
        """The spec of a ``[B, S, H, hd]`` attention tensor a rank holds:
        the heads over ``tp`` where ``H`` (and the key heads ``n_kv_heads``,
        where given) divide ``|tp|``; else, with ``sp``, the sequence over
        ``tp`` (the reference's spec under ``sp``: each rank its sequence
        block of every head); else whole. Where the heads divide, the port
        splits them under ``sp`` too: a rank's share of the attention is
        the same ``1 / |tp|``."""
        tp = self.tp_size()
        heads_ok = self.tp is not None and all(
            n % tp == 0 for n in (n_heads, n_kv_heads) if n is not None)
        if heads_ok:
            return (self.dp, None, self.tp, None)
        return (self.dp, self.tp if self.sp else None, None, None)


NO_SHARD = ShardCtx()


def _scalar(value, like: torch.Tensor, dtype=F32) -> torch.Tensor:
    """A 0-d tensor on ``like``'s device: a fill, no host copy or sync."""
    return torch.full((), value, dtype=dtype, device=like.device)


# ---------------------------------------------------------------------------
# primitives
# ---------------------------------------------------------------------------
def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    xf = x.to(F32)
    var = (xf * xf).sum(-1, keepdim=True) / _scalar(x.shape[-1], x)
    out = xf * torch.rsqrt(var + eps) * scale.to(F32)
    return out.to(dt)


@functools.lru_cache(maxsize=64)
def _inverse_frequencies(head_dim: int, theta: float, device: torch.device) -> torch.Tensor:
    exponent = np.arange(0, head_dim, 2, dtype=np.float32) / np.float32(head_dim)
    inv = 1.0 / np.float64(theta) ** exponent.astype(np.float64)
    return torch.from_numpy(inv.astype(np.float32)).to(device)


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    """[head_dim/2] float32 inverse frequencies: the float32 exponents
    ``arange(0, hd, 2) / hd``, then ``1 / theta ** e`` in float64 on the
    host, rounded once. These are the bits XLA's constant folding gives the
    reference's compiled forward and decode (an eager float32 ``pow`` is an
    ulp off for some, which moves the angle at position 524,287 by up to
    0.01 rad). Made once a (head_dim, theta, device); read-only."""
    return _inverse_frequencies(head_dim, float(theta), torch.device(device or "cpu"))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: [..., S, H, hd]; positions: broadcastable to [..., S] (int)."""
    hd = x.shape[-1]
    inv = rope_freqs(hd, theta, x.device)                    # [hd/2]
    ang = positions[..., None].to(F32) * inv                 # [..., S, hd/2]
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = torch.chunk(x.to(F32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def swiglu(x: torch.Tensor, wg: torch.Tensor, wi: torch.Tensor, wo: torch.Tensor,
           compute_dtype) -> torch.Tensor:
    """SwiGLU MLP: (silu(x@wg) * (x@wi)) @ wo."""
    xc = x.to(compute_dtype)
    g = F.silu(xc @ wg.to(compute_dtype))
    h = g * (xc @ wi.to(compute_dtype))
    return (h @ wo.to(compute_dtype)).to(x.dtype)


# ---------------------------------------------------------------------------
# attention (shared masked-softmax core)
# ---------------------------------------------------------------------------
def _scores(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """[B, H, Sq, Sk] float32 scores of q [B, Sq, H, d] against k [B, Sk, KV,
    d], each query head against its group's key head (JAX's
    ``jnp.repeat(k, H // KV, axis=2)`` without the copy), over sqrt(d)."""
    b, sq, h, d = q.shape
    kv = k.shape[2]
    s = torch.einsum("bqgrd,bkgd->bgrqk", q.reshape(b, sq, kv, h // kv, d), k)
    s = s.reshape(b, h, sq, k.shape[1]).to(F32)
    return s / torch.sqrt(_scalar(d, s))


def _weigh(p: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """[B, Sq, H, dv]: probabilities [B, H, Sq, Sk] (in v's dtype) over each
    head's group of v [B, Sk, KV, dv]."""
    b, h, sq, sk = p.shape
    kv = v.shape[2]
    o = torch.einsum("bgrqk,bkgd->bqgrd", p.reshape(b, kv, h // kv, sq, sk), v)
    return o.reshape(b, sq, h, v.shape[-1])


def _attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool,
            q_offset: torch.Tensor | int = 0, kv_len: torch.Tensor | int | None = None,
            window: int | None = None) -> torch.Tensor:
    """Plain attention. q:[B,Sq,H,hd] k,v:[B,Sk,KV,hd]; GQA by head groups.

    q_offset: absolute position of q[0] (decode: cache length).
    kv_len: number of valid cache entries (decode with growing cache).
    """
    sq, sk = q.shape[1], k.shape[1]
    scores = _scores(q, k)
    kpos = torch.arange(sk, device=q.device)
    qpos = torch.arange(sq, device=q.device) + q_offset
    mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos[None, :] <= qpos[:, None]
    if window is not None:
        mask &= kpos[None, :] > qpos[:, None] - window
    if kv_len is not None:
        mask &= kpos[None, :] < kv_len
    scores = torch.where(mask, scores, _scalar(MASKED, scores))
    probs = torch.softmax(scores, dim=-1)
    return _weigh(probs.to(v.dtype), v)


def _kv_step(acc: torch.Tensor, m: torch.Tensor, l: torch.Tensor, q_blk: torch.Tensor,
             k_blk: torch.Tensor, v_blk: torch.Tensor, qpos: torch.Tensor | None,
             kpos: torch.Tensor | None):
    """One k-block of the online softmax: the running (acc, max, sum) after
    ``k_blk``/``v_blk`` (the reference's ``kv_step``). ``qpos``/``kpos``
    None: no causal mask."""
    s = _scores(q_blk, k_blk)
    if qpos is not None:
        s = torch.where(kpos[None, :] <= qpos[:, None], s, _scalar(MASKED, s))
    m_new = torch.maximum(m, s.amax(-1))
    p = torch.exp(s - m_new[..., None])
    scale = torch.exp(m - m_new)
    l = l * scale + p.sum(-1)
    pv = _weigh(p.to(v_blk.dtype), v_blk)
    acc = acc * scale.transpose(1, 2)[..., None] + pv.to(F32)
    return acc, m_new, l


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, q_chunk: int = 1024,
                    k_chunk: int = 1024, q_offset: int = 0) -> torch.Tensor:
    """Chunked online-softmax attention (never materializes [Sq, Sk]).

    ``q_offset`` is the absolute position of ``q[:, 0]`` for the causal
    mask (as ``_attend`` takes it). A block of queries that starts on a
    ``q_chunk`` boundary, against every key, gives the whole call's rows
    bit for bit at the same chunks: a rank's sequence block under ``sp``.

    The JAX reference's ``lax.map`` over q blocks and ``lax.scan`` over k
    blocks as two loops, with its float32 running max, sum and accumulator.
    Like the reference (which reshapes ``Sq`` into ``Sq // q_chunk`` blocks),
    it refuses lengths that are not a multiple of the chunks; it does not
    pad.

    Under autograd (grad mode on and an input that requires a gradient)
    each k-block is recomputed in the backward, as the reference's
    ``jax.checkpoint(kv_step)``: the graph keeps each step's inputs, not
    its ``[B, H, q_chunk, k_chunk]`` float32 scores and probabilities
    (2.1 GB a k-block for DeepSeek-V3's 128 heads at a 4,096-row q block).
    Values and gradients are the same bits with and without it."""
    b, sq, h, hd = q.shape
    dv = v.shape[-1]           # may differ from hd (MLA: qk 192, v 128)
    sk = k.shape[1]
    if sq % q_chunk or sk % k_chunk:
        raise ValueError(
            f"flash_attention: the query length {sq} and key length {sk} must be "
            f"multiples of q_chunk={q_chunk} and k_chunk={k_chunk} (the reference "
            f"reshapes them into whole blocks)")
    nq, nk = sq // q_chunk, sk // k_chunk
    remat = torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad)
    out = []
    for qi in range(nq):
        q_blk = q[:, qi * q_chunk:(qi + 1) * q_chunk]
        acc = torch.zeros((b, q_chunk, h, dv), dtype=F32, device=q.device)
        m = torch.full((b, h, q_chunk), MASKED, dtype=F32, device=q.device)
        l = torch.zeros((b, h, q_chunk), dtype=F32, device=q.device)
        qpos = (q_offset + qi * q_chunk + torch.arange(q_chunk, device=q.device)
                if causal else None)
        for kj in range(nk):
            blk = (q_blk, k[:, kj * k_chunk:(kj + 1) * k_chunk],
                   v[:, kj * k_chunk:(kj + 1) * k_chunk], qpos,
                   kj * k_chunk + torch.arange(k_chunk, device=q.device) if causal else None)
            if remat:
                acc, m, l = checkpoint(_kv_step, acc, m, l, *blk, use_reentrant=False,
                                       preserve_rng_state=False)
            else:
                acc, m, l = _kv_step(acc, m, l, *blk)
        o = acc / torch.clamp(l, min=1e-30).transpose(1, 2)[..., None]
        out.append(o.to(q.dtype))
    return out[0] if nq == 1 else torch.cat(out, dim=1)


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------
def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  z_loss: float = 0.0) -> torch.Tensor:
    """Mean token cross-entropy in f32, optional z-loss regularizer."""
    logits = logits.to(F32)
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    loss = (lse - ll).sum() / _scalar(lse.numel(), lse)
    if z_loss:
        loss = loss + z_loss * (lse * lse).sum() / _scalar(lse.numel(), lse)
    return loss


__all__ = ["ShardCtx", "NO_SHARD", "rms_norm", "apply_rope", "rope_freqs", "swiglu", "flash_attention",
           "cross_entropy"]
