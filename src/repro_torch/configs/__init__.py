"""Arch registry: ``get_arch(name)`` / ``ARCH_IDS`` (one module per arch).

``ARCH_IDS`` names every arch of the JAX package; only the ported ones have
a module here. ``get_arch`` of an arch that is not ported yet raises
``NotImplementedError`` naming the ROADMAP item that brings it: the five
LM archs, the transformer family.
"""
from __future__ import annotations

from importlib import import_module

ARCH_IDS = ("mistral-nemo-12b", "qwen2.5-3b", "phi3-mini-3.8b", "grok-1-314b",
            "deepseek-v3-671b", "egnn", "mace", "schnet", "gcn-cora", "dcn-v2")
_PORTED = {"egnn": "repro_torch.configs.egnn",
           "mace": "repro_torch.configs.mace",
           "schnet": "repro_torch.configs.schnet",
           "gcn-cora": "repro_torch.configs.gcn_cora",
           "dcn-v2": "repro_torch.configs.dcn_v2"}


def get_arch(name: str):
    if name not in ARCH_IDS:
        raise KeyError(f"unknown arch {name!r}; have {ARCH_IDS}")
    if name not in _PORTED:
        raise NotImplementedError(
            f"arch {name!r} is not ported yet: the transformer family comes with "
            f"ROADMAP.md section 1, item 13b (6d); ported: {tuple(_PORTED)}")
    return import_module(_PORTED[name]).ARCH


__all__ = ["get_arch", "ARCH_IDS"]
