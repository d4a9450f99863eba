"""Arch registry: ``get_arch(name)`` / ``ARCH_IDS`` / ``all_archs()`` (one
module per arch), as the JAX package's ``configs/__init__.py``."""
from __future__ import annotations

from importlib import import_module

_MODULES = {
    "mistral-nemo-12b": "repro_torch.configs.mistral_nemo_12b",
    "qwen2.5-3b": "repro_torch.configs.qwen2_5_3b",
    "phi3-mini-3.8b": "repro_torch.configs.phi3_mini_3_8b",
    "grok-1-314b": "repro_torch.configs.grok1_314b",
    "deepseek-v3-671b": "repro_torch.configs.deepseek_v3_671b",
    "egnn": "repro_torch.configs.egnn",
    "mace": "repro_torch.configs.mace",
    "schnet": "repro_torch.configs.schnet",
    "gcn-cora": "repro_torch.configs.gcn_cora",
    "dcn-v2": "repro_torch.configs.dcn_v2",
}

ARCH_IDS = tuple(_MODULES)


def get_arch(name: str):
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; have {ARCH_IDS}")
    return import_module(_MODULES[name]).ARCH


def all_archs():
    return [get_arch(n) for n in ARCH_IDS]


__all__ = ["get_arch", "all_archs", "ARCH_IDS"]
