"""The dry run: every (architecture x input shape) cell's step on one rank of
the production meshes, on the meta device, and what it would hold and move.

The JAX package's ``launch/dryrun.py`` lowers and compiles each cell against
512 fabricated host devices and reads XLA's ``memory_analysis``,
``cost_analysis`` and the collectives of the compiled HLO. The port has no
compiler to ask. It builds ``build_step(arch, shape, mesh=dry_mesh(layout))``
for rank 0 of ``launch.mesh.make_production_mesh`` (16 x 16, or 2 x 16 x 16)
and calls its ``fn`` once on meta tensors of the rank's shards: parameters
(``step.specs``' local shapes), optimizer state, batch and cache. The dry
mesh's collectives are counted and communicate nothing
(``core/collective.py``). Nothing touches a card.

Usage:
  python -m repro_torch.launch.dryrun                     # all cells, both meshes
  python -m repro_torch.launch.dryrun --arch gcn-cora --shape full_graph_sm
  python -m repro_torch.launch.dryrun --mesh pod1 --out results/dryrun_torch.json

The output keeps the reference's keys where they have a meaning, each for
one rank (the reference's are per device too):

* ``arg_bytes``: the bytes of this rank's inputs, exact: its parameter and
  optimizer-state slices, its block of the batch (the batch's rows over the
  batch axes; a GNN's lanes and node rows over every axis; DCN-v2's
  candidates over every axis), its cache slice. XLA's
  ``argument_size_in_bytes`` counts the same buffers.
* ``out_bytes``: the bytes of what the call returns (new tensors; XLA's
  ``output_size_in_bytes``, which aliases donated inputs, counts them too).
* ``peak_bytes``: ``arg_bytes`` plus the most bytes of new storages alive at
  once during the call (a ``TorchDispatchMode`` adds each new storage's
  bytes when an operation makes it and subtracts them when it is freed).
  XLA's is ``argument + output + temp - alias`` of a scheduled, fused
  program with buffers reused; eager PyTorch keeps every input alive, frees
  a temporary when its last reference goes and fuses nothing, so the two
  differ by the fusions and the schedule. No allocator rounding is counted.
* ``flops``: ``torch.utils.flop_counter.FlopCounterMode`` over the same
  call: matrix products and attention only, forward and backward as run
  (XLA's ``cost_analysis`` also counts elementwise work, and its scan bodies
  once). ``model_flops`` is the analytic count beside it.
* ``collectives``: by kind (``all-reduce``, ``all-gather``, ``all-to-all``),
  calls over more than one rank and their output bytes on this rank
  (``collective.traffic``), the reference's convention ("the op's output
  shape per device"). ``collectives_looped`` is equal to it: an eager
  program runs every trip of its loops, so nothing is counted once for a
  loop; it is kept so that a reader of the reference's file can read this
  one.
* ``model_flops``, ``model_bytes_dev`` and ``meta``: the step's analytic
  ``meta``, the reference's formulas at the production mesh.
* ``kind``, ``devices``, ``mesh``, ``ok`` (or ``error`` and ``trace``), and
  ``kernel``: False. K1 to K5 cannot launch on the meta device, so every
  config runs its plain path (their ``kernel=None`` resolves off there), as
  the reference's dry run lowers ``impl="xla"`` for its train steps.

XLA's ``temp_bytes``, ``alias_bytes``, ``hlo_flops`` and ``hlo_bytes`` have no
counterpart and are left out.

The meta run takes a branch where a host read cannot run on meta tensors:

* ``models/moe.py:_ragged_swiglu`` reads the groups' sizes to the host. On
  the meta device it runs every row through expert 0's weights instead: the
  reference's static ``ragged_dot`` (``[rows, d_model]`` out, each row
  through one expert), its shape and its FLOPs, no values.

It changes nothing on the CPU or the card (the MoE tests hold it).

A cell the port refuses (a dimension that does not split evenly over the
16 x 16 mesh, which JAX pads; ``ROADMAP.md`` section 3) is recorded with
``ok: false`` and its error, as the reference records a failure; nothing is
padded here to hide it.

A whole sweep (the 40 cells of ``all_cells()`` over both meshes, 80 runs)
is in ``results/dryrun_torch.json``: 80 ok, run on the 8-core host of an H100
machine (torch 2.11.0+cu128) as ten processes at once, one an architecture
(``--arch``, then merged in ``all_cells()`` order). Its cells' own
``build_s`` and ``run_s`` sum to 966 s, so one process takes about 16
minutes: the meta device computes nothing, so the time is Python's dispatch
of each operation, most of it in the LM train cells (grok-1's and
deepseek-v3's 134-153 s each, their MoE layers' per-expert loops); the GNN
and DCN-v2 cells take under a second each but for the first cell a process
runs (about 6 s of imports in ``build_s``).
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback
import weakref
from dataclasses import replace

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import get_arch
from repro_torch.core import collective
from repro_torch.launch import steps as steps_mod
from repro_torch.launch.mesh import (
    MeshLayout, dp_axes, dry_mesh, make_production_mesh, n_devices,
)
from repro_torch.models import gnn as gnn_mod
from repro_torch.models import recsys as rec_mod
from repro_torch.models import transformer as lm_mod
from repro_torch.models.shard import local_shape

META = torch.device("meta")


class LiveBytes(TorchDispatchMode):
    """The bytes of storages made by operations under the mode and still
    alive: ``now``, and ``peak`` the most at once. The storages of
    ``inputs`` (alive throughout) are not counted, nor their views."""

    def __init__(self, inputs=()):
        super().__init__()
        self.now = self.peak = 0
        self._inputs = {id(t.untyped_storage()) for t in _tensors(inputs)}
        self._seen: dict = {}

    def _freed(self, key, nbytes, _ref) -> None:
        self._seen.pop(key, None)
        self.now -= nbytes

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in _tensors(out):
            st = t.untyped_storage()
            key = id(st)
            if key in self._seen or key in self._inputs:
                continue
            n = st.nbytes()
            self._seen[key] = weakref.ref(st, lambda ref, k=key, n=n: self._freed(k, n, ref))
            self.now += n
            self.peak = max(self.peak, self.now)
        return out


def _tensors(tree):
    """Every tensor in a nested structure of tuples, lists and dicts (a
    module: its parameters and buffers)."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, torch.nn.Module):
        yield from tree.parameters()
        yield from tree.buffers()
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            yield from _tensors(v)


def nbytes(tree) -> int:
    """Bytes of the distinct storages of the tensors in ``tree``."""
    seen = {}
    for t in _tensors(tree):
        st = t.untyped_storage()
        seen[id(st)] = st.nbytes()
    return sum(seen.values())


def _empty(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def _local(shape, dtype, spec, mesh) -> torch.Tensor:
    return _empty(local_shape(shape, spec, mesh), dtype)


def _lm_args(step, shape, mesh) -> tuple[tuple, dict]:
    """(``fn``'s arguments, this rank's share of them) of an LM cell."""
    gb, seq = shape.dims["global_batch"], shape.dims["seq_len"]
    model = lm_mod.sharded(step.cfg, mesh, step.specs)
    rows = step.ctx.dp or None           # decode at gb = 1: every rank the same token
    tok_spec = (rows,) if shape.kind == "decode" else (rows, None)
    if shape.kind == "prefill":
        tokens = _empty((gb, seq), torch.int32)
        return (model, tokens), {"model": model,
                                 "tokens": _local(tokens.shape, tokens.dtype, tok_spec, mesh)}
    if shape.kind == "decode":
        cache = lm_mod.init_cache(step.cfg, gb, seq, mesh=mesh, specs=step.cache_specs)
        tokens = _empty((gb,), torch.int32)
        share = {"model": model, "cache": cache,
                 "tokens": _local(tokens.shape, tokens.dtype, tok_spec, mesh),
                 "cache_len": _empty((), torch.int32)}
        return (model, cache, tokens, seq - 1), share
    params = {k: v.detach() for k, v in model.named_parameters()}
    opt_state = step.opt.init(params, (mesh, step.specs))
    batch = {k: _empty((gb, seq), torch.int32) for k in ("tokens", "labels")}
    share = {"params": params, "opt": opt_state,
             "batch": {k: _local(v.shape, v.dtype, (step.ctx.dp, None), mesh)
                       for k, v in batch.items()}}
    return (params, opt_state, batch), share


def _gnn_args(step, arch, shape, mesh) -> tuple[tuple, dict]:
    n, e, n_graphs, feat = steps_mod._gnn_dims(shape, n_devices(mesh))
    cfg = arch.full
    if isinstance(cfg, gnn_mod.GCNConfig):
        cfg = replace(cfg, d_feat=feat)
    model = steps_mod._GNN_FNS[type(cfg)][0](cfg, device=META)
    params = {k: v.detach() for k, v in model.named_parameters()}
    opt_state = step.opt.init(params)
    batch = {"src": _empty((e,), torch.int32), "dst": _empty((e,), torch.int32),
             "graph_id": _empty((n,), torch.int32), "node_mask": _empty((n,), torch.bool)}
    if isinstance(cfg, gnn_mod.GCNConfig):
        batch.update(node_feat=_empty((n, feat), torch.float32),
                     labels=_empty((n,), torch.int32), label_mask=_empty((n,), torch.bool))
    else:
        batch.update(atom_type=_empty((n,), torch.int32), pos=_empty((n, 3), torch.float32),
                     energy=_empty((n_graphs,), torch.float32))
    every = tuple(mesh.axis_names)
    share = {"params": params, "opt": opt_state,
             "batch": {k: _local(v.shape, v.dtype, () if k in steps_mod._GNN_GRAPHS else (every,),
                                 mesh) for k, v in batch.items()}}
    return (params, opt_state, batch), share


def _recsys_args(step, arch, shape, mesh) -> tuple[tuple, dict]:
    cfg = arch.full
    b = shape.dims["batch"]
    model = rec_mod.DCNv2(cfg, mesh=mesh)
    batch = {"dense": _empty((b, cfg.n_dense), torch.float32),
             "sparse_ids": _empty((b, cfg.n_sparse, cfg.multi_hot), torch.int32)}
    dp = dp_axes(mesh)
    specs = {"dense": (dp, None), "sparse_ids": (dp, None, None), "labels": (dp,)}
    if shape.kind == "retrieval":
        batch["candidates"] = _empty((step.meta["rows"], cfg.embed_dim), torch.float32)
        specs = {"candidates": (tuple(mesh.axis_names), None)}
    share_batch = {k: _local(v.shape, v.dtype, specs.get(k, ()), mesh) for k, v in batch.items()}
    if shape.kind != "train":
        return (model, batch), {"model": model, "batch": share_batch}
    batch["labels"] = _empty((b,), torch.int32)
    share_batch["labels"] = _local((b,), torch.int32, specs["labels"], mesh)
    params = {k: v.detach() for k, v in model.named_parameters()}
    opt_state = step.opt.init(params, (mesh, step.specs))
    return (params, opt_state, batch), {"params": params, "opt": opt_state, "batch": share_batch}


def cell_args(arch_name: str, shape_name: str, step, mesh) -> tuple[tuple, dict]:
    """``step.fn``'s arguments on the meta device, and this rank's share of
    them (whose bytes are ``arg_bytes``)."""
    arch = get_arch(arch_name)
    shape = arch.shape(shape_name)
    if arch.family == "lm":
        return _lm_args(step, shape, mesh)
    if arch.family == "gnn":
        return _gnn_args(step, arch, shape, mesh)
    return _recsys_args(step, arch, shape, mesh)


def traffic_stats() -> dict:
    """``collective.traffic`` in ``hlo_analysis.collective_stats``' form."""
    out = {k: dict(v) for k, v in collective.traffic.items()}
    out["total_bytes"] = sum(v["bytes"] for v in collective.traffic.values())
    return out


def run_cell(arch: str, shape: str, multi_pod: bool, verbose: bool = True,
             layout: MeshLayout | None = None) -> dict:
    """One cell's record on rank 0 of the production mesh (``layout``: of
    another layout instead)."""
    if layout is None:
        layout = make_production_mesh(multi_pod=multi_pod)
    rec = {"arch": arch, "shape": shape, "mesh": "x".join(map(str, layout.sizes)),
           "devices": n_devices(layout), "kernel": False}
    t0 = time.time()
    try:
        mesh = dry_mesh(layout)
        step = steps_mod.build_step(arch, shape, mesh=mesh)
        args, share = cell_args(arch, shape, step, mesh)
        t_build = time.time() - t0
        collective.traffic.clear()
        live = LiveBytes(args)
        with FlopCounterMode(display=False) as flops, live:
            out = step.fn(*args)
        t_run = time.time() - t0 - t_build
        colls = traffic_stats()
        arg_bytes = nbytes(share)
        rec.update(
            ok=True, kind=step.kind, build_s=round(t_build, 1), run_s=round(t_run, 1),
            arg_bytes=arg_bytes, out_bytes=nbytes(out), peak_bytes=arg_bytes + live.peak,
            flops=float(flops.get_total_flops()),
            collectives=colls, collectives_looped=traffic_stats(),
            model_flops=float(step.meta.get("model_flops", 0.0)),
            model_bytes_dev=float(step.meta.get("model_bytes_dev", 0.0)),
            meta={k: v for k, v in step.meta.items() if k != "model_flops"})
        del out, args, share
        if verbose:
            gb = 1 << 30
            print(f"[OK] {arch}:{shape} mesh={rec['mesh']} kind={step.kind} "
                  f"build={t_build:.1f}s run={t_run:.1f}s")
            print(f"     mem/rank: args={rec['arg_bytes'] / gb:.2f}GiB "
                  f"out={rec['out_bytes'] / gb:.2f}GiB peak~{rec['peak_bytes'] / gb:.2f}GiB")
            print(f"     flops/rank: {rec['flops']:.3e} (model {rec['model_flops']:.3e} all "
                  f"ranks); collectives: {colls['total_bytes'] / gb:.3f}GiB "
                  f"({ {k: v['count'] for k, v in colls.items() if isinstance(v, dict)} })")
    except Exception as e:  # noqa: BLE001 -- record the failure, keep sweeping
        rec.update(ok=False, error=f"{type(e).__name__}: {e}",
                   trace=traceback.format_exc()[-2000:])
        if verbose:
            print(f"[FAIL] {arch}:{shape} mesh={rec['mesh']}: {rec['error']}")
    return rec


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", choices=["pod1", "pod2", "both"], default="both")
    ap.add_argument("--out", default="results/dryrun_torch.json")
    args = ap.parse_args(argv)

    cells = steps_mod.all_cells()
    if args.arch:
        cells = [c for c in cells if c[0] == args.arch]
    if args.shape:
        cells = [c for c in cells if c[1] == args.shape]
    meshes = {"pod1": [False], "pod2": [True], "both": [False, True]}[args.mesh]

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    results = []
    if os.path.exists(args.out):
        with open(args.out) as f:
            results = json.load(f)

    done = {(r["arch"], r["shape"], r["mesh"]) for r in results if r.get("ok")}
    for arch, shape in cells:
        for mp in meshes:
            key = (arch, shape, "2x16x16" if mp else "16x16")
            if key in done:
                print(f"[skip] {key} already done")
                continue
            rec = run_cell(arch, shape, mp)
            results = [r for r in results if (r["arch"], r["shape"], r["mesh"]) != key]
            results.append(rec)
            with open(args.out, "w") as f:
                json.dump(results, f, indent=1)

    n_ok = sum(r["ok"] for r in results)
    print(f"\n== dry-run: {n_ok}/{len(results)} cells OK -> {args.out}")


if __name__ == "__main__":
    main()
