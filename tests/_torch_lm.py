"""Shared helpers of tests/test_torch_lm.py and tests/test_torch_serve.py:
the JAX package's transformer configs as the port's, and JAX's parameters
carried across."""
import dataclasses
from functools import lru_cache, partial

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.models import transformer as jt
from repro.models.moe import MoEConfig as JMoEConfig
from repro_torch.models import lm_params_from_jax
from repro_torch.models.moe import MoEConfig
from repro_torch.models.transformer import TransformerConfig

DTYPES = {jnp.dtype(jnp.float32): torch.float32, jnp.dtype(jnp.bfloat16): torch.bfloat16}


def torch_dtype(dt):
    return DTYPES[jnp.dtype(dt)]


def torch_moe(m: JMoEConfig) -> MoEConfig:
    kw = {f.name: getattr(m, f.name) for f in dataclasses.fields(m)}
    return MoEConfig(**dict(kw, compute_dtype=torch_dtype(kw["compute_dtype"])))


def torch_cfg(jcfg: jt.TransformerConfig) -> TransformerConfig:
    """The port's config with every field of the JAX one, dtypes mapped."""
    kw = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)}
    kw["param_dtype"] = torch_dtype(kw["param_dtype"])
    kw["compute_dtype"] = torch_dtype(kw["compute_dtype"])
    if kw["moe"] is not None:
        kw["moe"] = torch_moe(kw["moe"])
    return TransformerConfig(**kw)


def bf16(jcfg: jt.TransformerConfig) -> jt.TransformerConfig:
    """A bfloat16 copy of a JAX config (parameters, compute and the MoE)."""
    moe = None if jcfg.moe is None else dataclasses.replace(jcfg.moe, compute_dtype=jnp.bfloat16)
    return dataclasses.replace(jcfg, param_dtype=jnp.bfloat16, compute_dtype=jnp.bfloat16, moe=moe)


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@lru_cache(maxsize=None)
def jax_params(jcfg: jt.TransformerConfig, seed: int = 0):
    return jt.init_params(jax.random.PRNGKey(seed), jcfg)


def port_model(jcfg: jt.TransformerConfig, seed: int = 0, device: str = "cpu"):
    """The port's model holding JAX's ``init_params(PRNGKey(seed), jcfg)``."""
    return lm_params_from_jax(np_tree(jax_params(jcfg, seed)), torch_cfg(jcfg), device)


@lru_cache(maxsize=None)
def jax_forward(jcfg: jt.TransformerConfig):
    return jax.jit(partial(jt.forward, cfg=jcfg, return_cache=True))


@lru_cache(maxsize=None)
def jax_decode(jcfg: jt.TransformerConfig):
    return jax.jit(lambda p, c, t, n: jt.decode_step(p, c, t, n, jcfg))


def tokens(shape, vocab: int, seed: int = 1) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(np.int32)


def to_np(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().numpy() if t.is_floating_point() else t.numpy()


def jnp_np(a) -> np.ndarray:
    a = np.asarray(a)
    return a.astype(np.float32) if a.dtype == jnp.bfloat16 else a
