"""Arch registry plumbing: every ``configs/<id>.py`` exposes an ``ARCH``.

A copy of the JAX package's ``configs/common.py`` (stdlib only). An Arch
bundles the exact published full config, a reduced smoke config (same
family, CPU-runnable), its shape set, and scheduling knobs. Step
construction (serve/retrieval) lives in ``repro_torch.launch.steps`` —
configs stay data-only.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any


@dataclass(frozen=True)
class Shape:
    name: str
    kind: str          # 'train' | 'prefill' | 'decode' | 'serve' | 'retrieval'
    # LM: seq_len, global_batch. GNN: n_nodes, n_edges, ... Recsys: batch, ...
    dims: dict = field(default_factory=dict)
    note: str = ""


@dataclass(frozen=True)
class Arch:
    name: str
    family: str                    # 'lm' | 'gnn' | 'recsys'
    full: Any
    smoke: Any
    shapes: tuple[Shape, ...]
    optimizer: str = "adamw"       # 'adamw' | 'adafactor' | 'sgdm'
    microbatches: int = 1          # grad-accumulation chunks for train shapes
    grad_accum_dtype: str = "float32"  # giant-MoE configs accumulate in bf16
    train_layout: str = "tp_sp"    # "tp_sp" | "zero3" (pure-DP, EXPERIMENTS §Perf)
    source: str = ""
    note: str = ""

    def shape(self, name: str) -> Shape:
        for s in self.shapes:
            if s.name == name:
                return s
        raise KeyError(f"{self.name} has no shape {name!r}; "
                       f"have {[s.name for s in self.shapes]}")


# ---------------------------------------------------------------------------
# shared shape sets
# ---------------------------------------------------------------------------
def lm_shapes(long_adapted: bool) -> tuple[Shape, ...]:
    """The 4 LM cells. ``long_adapted``: pure full-attention archs serve
    long_500k through the sliding-window cache (DESIGN.md §5); MLA archs
    decode over the full latent cache."""
    return (
        Shape("train_4k", "train", dict(seq_len=4096, global_batch=256)),
        Shape("prefill_32k", "prefill", dict(seq_len=32768, global_batch=32)),
        Shape("decode_32k", "decode", dict(seq_len=32768, global_batch=128)),
        Shape("long_500k", "decode", dict(seq_len=524288, global_batch=1),
              note=("adapted: sliding-window(4096) KV cache (StreamingLLM-style)"
                    if long_adapted else "full latent (MLA) cache")),
    )


GNN_SHAPES = (
    Shape("full_graph_sm", "train", dict(n_nodes=2708, n_edges=10556, d_feat=1433)),
    Shape("minibatch_lg", "train",
          dict(n_nodes=232_965, n_edges=114_615_892, batch_nodes=1024,
               fanout=(15, 10)),
          note="step operates on the fanout-sampled subgraph (graphs/sampler.py)"),
    Shape("ogb_products", "train",
          dict(n_nodes=2_449_029, n_edges=61_859_140, d_feat=100)),
    Shape("molecule", "train", dict(n_nodes=30, n_edges=64, batch=128)),
)

RECSYS_SHAPES = (
    Shape("train_batch", "train", dict(batch=65_536)),
    Shape("serve_p99", "serve", dict(batch=512)),
    Shape("serve_bulk", "serve", dict(batch=262_144)),
    Shape("retrieval_cand", "retrieval", dict(batch=1, n_candidates=1_000_000)),
)


def sampled_subgraph_dims(batch_nodes: int, fanout: tuple[int, ...]) -> tuple[int, int]:
    """(n_nodes, n_directed_edges) of a fanout-sampled block (padded sizes)."""
    nodes = batch_nodes
    total_nodes = batch_nodes
    edges = 0
    for f in fanout:
        edges += nodes * f
        nodes = nodes * f
        total_nodes += nodes
    return total_nodes, edges


__all__ = ["Arch", "Shape", "lm_shapes", "GNN_SHAPES", "RECSYS_SHAPES",
           "sampled_subgraph_dims"]
