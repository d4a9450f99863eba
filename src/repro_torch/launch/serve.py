"""Batched serving loop (prefill -> decode) for the LM family.

The port of the JAX package's ``launch/serve.py``: a request batch is
prefilled in one call, its cache padded to the final length, then tokens
are decoded step by step. The generated tokens stay on the device until the
final stack; the host reads nothing else in the loop, apart from each MoE
layer's group sizes (``models/moe.py``).

Two contract differences from the reference:

* sampling (``greedy=False``) draws from a ``torch.Generator`` seeded with
  ``seed``, so its tokens are not ``jax.random.categorical``'s; greedy
  tokens are the same;
* a GQA config with ``kv_cache_dtype="int8"`` raises a ``ValueError``: the
  prefill cache holds float k/v and no scales, which the int8 decode cannot
  continue (the reference fails there too, with a dtype error from
  ``dynamic_update_slice``). Decoding from ``init_cache`` serves int8.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core.dispatch import resolve_device
from repro_torch.models.transformer import (
    Transformer, TransformerConfig, decode_step, prefill,
)
from repro_torch.obs.scrape import serve_metrics


@dataclass
class ServeStats:
    prefill_tokens: int
    decoded_tokens: int
    outputs: np.ndarray


def check_servable(cfg: TransformerConfig) -> None:
    """Raise for a config whose prefill cache cannot be decoded from."""
    if cfg.kv_cache_dtype == "int8" and cfg.attn != "mla":
        raise ValueError(
            f"{cfg.name}: serve_batch cannot serve kv_cache_dtype='int8': the prefill "
            f"cache holds float k/v without scales, and the int8 decode writes int8 "
            f"entries into it (the JAX package's serve_batch fails here with a dtype "
            f"error); decode from init_cache, or serve a float cache")


def serve_batch(model: Transformer, cfg: TransformerConfig, prompts, max_new_tokens: int = 16,
                greedy: bool = True, seed: int = 0, device=None) -> ServeStats:
    """prompts [B, S0] int -> greedy continuation [B, max_new_tokens] (int32).

    Runs on ``device`` (None means the GPU, and raises without one), where
    ``model`` must be, under ``torch.inference_mode()``."""
    device = resolve_device(device)
    on = model.embed.device
    if on.type != device.type or device.index not in (None, on.index):
        raise ValueError(f"serve_batch runs on {device}; the model is on {on}")
    check_servable(cfg)
    with torch.inference_mode():
        prompts = torch.as_tensor(np.asarray(prompts), device=device)
        b, s0 = prompts.shape
        total = s0 + max_new_tokens
        last, cache = prefill(model, prompts, cfg)
        padded = {}
        for key, value in cache.items():
            full = torch.zeros((value.shape[0], b, total, *value.shape[3:]),
                               dtype=value.dtype, device=device)
            full[:, :, :s0] = value
            padded[key] = full
        cache = padded
        gen = None if greedy else torch.Generator(device=device).manual_seed(seed)
        tok = torch.argmax(last, dim=-1)
        out = [tok]
        for i in range(max_new_tokens - 1):
            lg, cache = decode_step(model, cache, tok, s0 + i, cfg)
            if greedy:
                tok = torch.argmax(lg, dim=-1)
            else:
                tok = torch.multinomial(torch.softmax(lg, dim=-1), 1, generator=gen)[:, 0]
            out.append(tok)
        outputs = torch.stack(out, dim=1).to(torch.int32).cpu().numpy()
    return ServeStats(prefill_tokens=b * s0, decoded_tokens=b * max_new_tokens,
                      outputs=outputs)


def serve_metrics_endpoint(port: int = 0, host: str = "127.0.0.1",
                           service=None, collector=None, slo=None):
    """Expose this serve process's telemetry on a scrape endpoint:
    ``/metrics`` Prometheus text, ``/snapshot`` JSON, ``/slo`` burn-rate
    alerts. With no arguments it serves the process-default obs registry:

        server = serve_metrics_endpoint(port=9100)
        ... serve traffic; curl http://host:9100/metrics ...
        server.close()

    Pass a ``StreamService`` to serve its per-tenant SLO snapshot, or a
    ``repro_torch.obs.Collector`` to serve the merged fleet view instead.
    Returns the live server (``.url``, ``.port``, ``.close()``)."""
    return serve_metrics(service=service, collector=collector, slo=slo,
                         host=host, port=port)


__all__ = ["serve_batch", "serve_metrics_endpoint", "ServeStats", "check_servable"]
