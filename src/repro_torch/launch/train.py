"""Fault-tolerant training runtime, and the paper's peel under worker loss.

The port of the JAX package's ``launch/train.py``. ``run_training`` is the
generic loop:
  * checkpoint every N steps (async, atomic-rename, versioned — see
    ``checkpoint/``); the data stream is a function of the step, so a
    restart resumes its exact position;
  * crash recovery: any exception in the step triggers restore-from-latest
    and replay (``max_restarts`` bounds it); the tests inject failures and
    hold the result bit for bit against an uninterrupted run;
  * straggler mitigation: a step slower than ``straggler_factor`` x the
    running median is re-dispatched once from the state it was given (the
    step is pure, so the retry is safe);
  * elastic scaling: checkpoints are device-layout-free; ``restore_elastic``
    puts them on whatever device or mesh is alive at restart.

``peel_with_restarts`` applies the same machinery to the paper's algorithm:
the peeling state is checkpointed every pass and the loop survives a
simulated worker loss mid-decomposition.

Every read of the newest checkpoint first waits for the save that may still
be on its thread, then reads ``latest_step()`` once and restores that step.
The JAX package reads the directory twice (``latest_step()``, then
``restore()`` with no step, which reads it again) with no wait, so a rename
landing between the reads pairs one step with another step's state; in
``run_training`` that replays steps on a state already past them.

The loop's one host sync a step is the loss (``float``), which also times
the step (the JAX package's ``block_until_ready``); a straggler's re-run
reads its loss once more, and a checkpoint's host snapshot is one more
every ``ckpt_every`` steps.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, Iterator

import numpy as np
import torch

from repro_torch.checkpoint import CheckpointManager, snapshot
from repro_torch.core.collective import Mesh
from repro_torch.core.dispatch import assert_exact_envelope, lane_degrees, resolve_kernel
from repro_torch.core.distributed import mesh_device, shard_edges
from repro_torch.core.pbahmani import pbahmani_pass, state_from_degrees
from repro_torch.models.shard import local_slice, norm_spec
from repro_torch.utils.tree import path_key, tree_map


@dataclass
class LoopConfig:
    total_steps: int
    ckpt_every: int = 50
    keep: int = 3
    log_every: int = 10
    max_restarts: int = 5
    straggler_factor: float = 4.0
    min_steps_for_median: int = 8


@dataclass
class LoopResult:
    losses: list = field(default_factory=list)
    restarts: int = 0
    redispatched: int = 0
    final_state: Any = None
    resumed_from: int | None = None


def _place(host, template, device: torch.device | None = None):
    """The host tree ``host`` (numpy leaves, and CPU tensors where the
    checkpoint held bfloat16) on a device: each leaf where ``device`` says,
    else where ``template``'s leaf lives, with the template tensor's dtype
    (a numpy leaf keeps its own; Python scalars stay Python)."""
    def put(h, ref):
        if not isinstance(h, (np.ndarray, torch.Tensor)):
            return h
        if isinstance(ref, torch.Tensor):
            return torch.as_tensor(h, dtype=ref.dtype,
                                   device=ref.device if device is None else device)
        return torch.as_tensor(h, device=device)
    return tree_map(put, host, template)


def _latest(ckpt: CheckpointManager) -> int | None:
    """The newest step once the save that may still be on its thread has
    landed: read once, and restored by number."""
    ckpt.wait()
    return ckpt.latest_step()


def run_training(
    step_fn: Callable,                 # (state, batch) -> (state, loss)
    init_state: Callable[[], Any],
    data_factory: Callable[[int], Iterator[dict]],  # start_step -> iterator
    ckpt: CheckpointManager | None,
    cfg: LoopConfig,
    failure_injector: Callable[[int], None] | None = None,
) -> LoopResult:
    res = LoopResult()
    start = 0
    state = init_state()
    if ckpt is not None:
        last = _latest(ckpt)
        if last is not None:
            _, host = ckpt.restore(state, step=last)
            state = _place(host, state)
            start = res.resumed_from = last
    data = data_factory(start)

    step = start
    durations: list[float] = []
    restarts = 0
    while step < cfg.total_steps:
        batch = next(data)
        try:
            if failure_injector is not None:
                failure_injector(step)
            t0 = time.perf_counter()
            prev_state = state   # re-dispatch must restart from PRE-step state
            state, metrics = step_fn(prev_state, batch)
            # repro: allow RPR101 -- the one host sync of each step: the loss, which also times it
            loss = float(metrics)
            dt = time.perf_counter() - t0
            # ---- straggler re-dispatch (deterministic step => safe retry)
            if len(durations) >= cfg.min_steps_for_median:
                med = float(np.median(durations))
                if dt > cfg.straggler_factor * med:
                    state, metrics = step_fn(prev_state, batch)
                    # repro: allow RPR101 -- the re-dispatched step's loss, once for a straggler
                    loss = float(metrics)
                    res.redispatched += 1
            durations.append(dt)
        except Exception:
            restarts += 1
            res.restarts = restarts
            if ckpt is None or restarts > cfg.max_restarts:
                raise
            last = _latest(ckpt)
            if last is None:
                state = init_state()
                step = 0
            else:
                _, host = ckpt.restore(state, step=last)
                state = _place(host, state)
                step = last
            data = data_factory(step)
            continue

        res.losses.append(loss)
        step += 1
        if ckpt is not None and step % cfg.ckpt_every == 0:
            # repro: allow RPR101 -- the checkpoint's host snapshot, once every ckpt_every steps
            ckpt.save(step, state)
    if ckpt is not None:
        ckpt.save(cfg.total_steps, state, blocking=True)
    res.final_state = state
    return res


def restore_elastic(ckpt: CheckpointManager, state_template, device=None,
                    mesh: Mesh | None = None, specs: dict | None = None):
    """Restore the newest checkpoint onto the CURRENT topology, whatever
    wrote it: every leaf on ``device`` (None means the GPU, and raises
    without one), or with ``mesh`` on the mesh's device (the state is
    replicated, so every rank holds all of it). Tensor leaves of the
    template give their dtypes. Returns (step, state).

    With ``specs`` (``{path_key: spec}`` of the template's array leaves,
    ``models.convert.lm_state_specs``; the reference's ``shardings=``) the
    template holds this rank's slices: the checkpoint's whole arrays are
    read and each rank keeps its slice of every leaf."""
    device = mesh_device(mesh, device)
    last = _latest(ckpt)
    if last is None:
        raise FileNotFoundError(f"no checkpoints under {ckpt.dir}")
    if specs is None:
        _, host = ckpt.restore(state_template, step=last)
        return last, _place(host, state_template, device)
    if mesh is None:
        raise ValueError("restore_elastic(specs=) slices over a mesh: pass mesh=")

    def whole(path, leaf):
        if not isinstance(leaf, torch.Tensor):
            return leaf
        spec = norm_spec(specs[path_key(path)], leaf.dim())
        return torch.empty([n * mesh.axis_size(axes) if axes else n
                            for n, axes in zip(leaf.shape, spec)], dtype=leaf.dtype,
                           device="meta")

    _, host = ckpt.restore(tree_map(whole, state_template, with_path=True), step=last)
    host = tree_map(lambda path, leaf: local_slice(leaf, specs[path_key(path)], mesh)
                    if path_key(path) in specs else leaf, host, with_path=True)
    return last, _place(host, state_template, device)


# ---------------------------------------------------------------------------
# the paper's pipeline under the same fault-tolerance machinery
# ---------------------------------------------------------------------------
def peel_with_restarts(graph, mesh: Mesh, eps: float, ckpt: CheckpointManager,
                       fail_at_pass: int | None = None,
                       kernel: bool | None = None) -> dict:
    """Distributed P-Bahmani with per-pass checkpointing + simulated failure.

    Every rank of ``mesh`` calls it with the same graph; the state is
    replicated, so on a world of more than one rank each rank passes a
    manager of its own directory. The degrees are ``lane_degrees`` of this
    rank's lanes (K1 with the kernel on) and one all-reduce; each pass is
    ``pbahmani_pass`` (one K2 launch, one all-reduce) and a save of the
    state, whose host snapshot gives the loop its test: one host sync a
    pass. A directory that already holds checkpoints (this package's or the
    JAX package's) resumes from its newest. At ``fail_at_pass`` the state is
    dropped once and restored from the newest checkpoint, as a lost worker's
    would be. ``kernel=None`` means on for a CUDA mesh. Returns the JAX
    package's ``{"density", "mask", "passes"}``: the triple of
    ``pbahmani``, bit for bit."""
    kernel = resolve_kernel(kernel, mesh.device)
    n = graph.n_nodes
    if kernel:
        assert_exact_envelope(graph.src.shape[0], n)
    src, dst = shard_edges(graph, mesh)
    state = state_from_degrees(lane_degrees(src, dst, n, kernel, mesh), graph.n_edges)
    start = _latest(ckpt)
    if start is None:
        host = snapshot(state)
    else:
        _, host = ckpt.restore(state, step=start)
        state = _place(host, state)
    failed_once = False
    while int(host.n_v) > 0:
        if fail_at_pass is not None and int(host.passes) == fail_at_pass \
                and not failed_once:
            failed_once = True
            last = _latest(ckpt)
            if last is not None:     # simulate losing the worker state
                _, host = ckpt.restore(state, step=last)
                state = _place(host, state)
        state = pbahmani_pass(state, src, dst, n, float(eps), kernel, mesh)
        # repro: allow RPR101 -- the one host sync of each pass: the save's snapshot, which the loop test reads
        host = ckpt.save(int(host.passes) + 1, state)
    ckpt.wait()
    return {"density": float(host.best_density),
            "mask": np.asarray(host.best_mask),
            "passes": int(host.passes)}


__all__ = ["LoopConfig", "LoopResult", "run_training", "restore_elastic",
           "peel_with_restarts"]
