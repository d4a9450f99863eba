"""Checkpoint/restore for fault-tolerant training and peeling.

The port of the JAX package's ``checkpoint/manager.py``, on the same disk
format, so a checkpoint written by either package restores in the other:

  * **atomic**: state is written to ``step_K.tmp/`` then ``os.rename``d to
    ``step_K/`` — a crash mid-save never corrupts the latest checkpoint;
  * **async**: ``save()`` snapshots the tensors to host numpy (one
    ``.detach()`` copy to the CPU a leaf, in the caller's thread) and hands
    the file IO to a background thread — the loop does not block on disk;
  * **versioned + pruned**: keeps the newest ``keep`` checkpoints;
  * **elastic**: one ``leaf_%05d.npy`` a leaf under ``manifest.json``, which
    maps each leaf's key (its path's dict keys, indices and NamedTuple
    fields joined by ``/``) to its file; nothing records a device, so a
    restore puts the leaves wherever the caller says
    (``launch/train.py:restore_elastic``).

The flatten is the JAX package's (``utils/tree.py``): a dict's keys sorted,
``None`` no leaf. State trees may hold tensors, numpy arrays and Python
ints/floats at the leaves. numpy has no bfloat16: a bfloat16 tensor is
written as the JAX package writes one, its 2-byte bits (an int16 view) in
a ``.npy`` whose header names the dtype ``<V2`` (ml_dtypes' name for
bfloat16, which numpy reads back as ``|V2``), and comes back as a
``torch.bfloat16`` CPU tensor, bit for bit, where the restore's target
leaf is bfloat16 (the manifest records no dtype). The JAX package's own
restore hands such a leaf back as the ``|V2`` array, which ``jnp.asarray``
refuses; the port does not copy that.

A ``Layout`` maps the state to the tree on disk and back: ``to_disk`` on
the host snapshot (in the writer's thread) and on the target's shapes,
``from_disk`` on what was read. ``models.convert.LM_STATE_LAYOUT`` writes
an LM train state in JAX's keys and stacked shapes.

A reader that wants the newest checkpoint while a save may still be on its
thread calls :meth:`wait` first, then reads :meth:`latest_step` once and
passes that step to :meth:`restore`: two reads of the directory around a
rename could pair one step with another step's state.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Callable, NamedTuple

import numpy as np
import torch

from repro_torch.utils.tree import leaves_with_paths, path_key, tree_map


def _flatten(state) -> dict:
    return dict(leaves_with_paths(state))


BF16_ON_DISK = np.dtype("V2")   # numpy's dtype of a bfloat16 leaf's bits, read or written


def _host(path: tuple, leaf):
    if isinstance(leaf, torch.Tensor):
        host = leaf.detach().to("cpu", copy=True)
        if host.dtype == torch.bfloat16:
            return host.view(torch.int16).numpy().view(BF16_ON_DISK)
        return host.numpy()
    return np.asarray(leaf)


def _save(path: str, arr: np.ndarray) -> None:
    """``np.save``, except that bfloat16 bits get the JAX package's header
    (``'descr': '<V2'``, where numpy would write ``'|V2'``), so the file is
    the same bytes as the JAX package's."""
    if arr.dtype != BF16_ON_DISK:
        np.save(path, arr)
        return
    with open(path, "wb") as f:
        np.lib.format.write_array_header_1_0(
            f, {"descr": "<V2", "fortran_order": False, "shape": arr.shape})
        f.write(np.ascontiguousarray(arr).tobytes())


def snapshot(state):
    """``state`` with every leaf a host numpy array (tensors copied off
    their device: a host sync for a CUDA tensor; a bfloat16 tensor's bits
    as a ``|V2`` array)."""
    return tree_map(_host, state, with_path=True)


def _shape_of(leaf):
    """A tensor leaf as a meta tensor of its shape and dtype (what a layout
    maps for a restore's target, without touching the data)."""
    if isinstance(leaf, torch.Tensor):
        return torch.empty(leaf.shape, dtype=leaf.dtype, device="meta")
    return leaf


class Layout(NamedTuple):
    """A state tree's layout on disk: ``to_disk(tree)`` gives the tree to
    write (its keys and shapes), ``from_disk(tree)`` the state's structure
    back. Both take trees of numpy arrays, tensors (``"meta"`` ones for a
    restore's target) and Python scalars."""
    to_disk: Callable
    from_disk: Callable


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3, async_save: bool = True,
                 layout: Layout | None = None):
        self.dir = directory
        self.keep = keep
        self.async_save = async_save
        self.layout = layout
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None
        os.makedirs(directory, exist_ok=True)

    # -- save ---------------------------------------------------------------
    def save(self, step: int, state, blocking: bool = False):
        """Snapshot ``state`` to host and write it as ``step`` (in the disk
        layout, if the manager has one): on a thread unless ``blocking`` or
        the manager is synchronous. Returns the host snapshot (numpy leaves,
        in ``state``'s structure), which the caller may read without another
        device sync."""
        host_state = snapshot(state)
        self.wait()  # one outstanding save at a time
        if self.async_save and not blocking:
            self._thread = threading.Thread(
                target=self._run, args=(step, host_state), daemon=True)
            self._thread.start()
        else:
            self._write(step, host_state)
        return host_state

    def _run(self, step: int, host_state) -> None:
        try:
            self._write(step, host_state)
        except Exception as exc:  # raised again by wait()
            self._error = exc

    def _write(self, step: int, host_state) -> None:
        tmp = os.path.join(self.dir, f"step_{step}.tmp")
        final = os.path.join(self.dir, f"step_{step}")
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        flat = _flatten(self.layout.to_disk(host_state) if self.layout else host_state)
        manifest = {}
        for i, (key, leaf) in enumerate(sorted(flat.items())):
            fn = f"leaf_{i:05d}.npy"
            _save(os.path.join(tmp, fn), np.asarray(leaf))
            manifest[key] = fn
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump({"step": step, "leaves": manifest, "time": time.time()}, f)
        self._publish(tmp, final)
        self._prune()

    def _publish(self, tmp: str, final: str) -> None:
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)  # atomic publish

    def _prune(self) -> None:
        steps = self.all_steps()
        for s in steps[:-self.keep] if self.keep else []:
            shutil.rmtree(os.path.join(self.dir, f"step_{s}"), ignore_errors=True)

    def wait(self) -> None:
        """Join the outstanding save, if any; a write that failed on its
        thread raises here."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            exc, self._error = self._error, None
            raise exc

    # -- restore --------------------------------------------------------------
    def all_steps(self) -> list[int]:
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and not name.endswith(".tmp"):
                if os.path.exists(os.path.join(self.dir, name, "manifest.json")):
                    out.append(int(name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, target, step: int | None = None):
        """Restore into the structure of ``target`` (its leaves give the
        shapes, and a bfloat16 tensor leaf the dtype; tensors are not read).
        Returns (step, state) with numpy leaves, ``torch.bfloat16`` CPU
        tensors for bfloat16 leaves, and Python scalars where ``target``
        holds them; the caller puts them on a device. ``step=None`` reads
        the newest step, which may race a save still on its thread: pass the
        step read after :meth:`wait`."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.dir}")
        d = os.path.join(self.dir, f"step_{step}")
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)["leaves"]
        on_disk = (self.layout.to_disk(tree_map(_shape_of, target)) if self.layout
                   else target)
        missing = set(_flatten(on_disk)) - set(manifest)
        if missing:
            raise KeyError(f"checkpoint at step {step} missing leaves {sorted(missing)[:5]}")

        def load(path, ref):
            key = path_key(path)
            arr = np.load(os.path.join(d, manifest[key]))
            if not hasattr(ref, "shape"):
                return type(ref)(arr)
            if tuple(arr.shape) != tuple(ref.shape):
                raise ValueError(f"leaf {key}: checkpoint shape {arr.shape} != "
                                 f"target {tuple(ref.shape)}")
            if isinstance(ref, torch.Tensor) and ref.dtype == torch.bfloat16:
                if arr.dtype != BF16_ON_DISK:
                    raise TypeError(f"leaf {key}: the target is bfloat16, the checkpoint "
                                    f"holds {arr.dtype}")
                return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
            if arr.dtype == BF16_ON_DISK and ref.dtype != BF16_ON_DISK:
                raise TypeError(f"leaf {key}: the checkpoint holds bfloat16 bits (|V2), the "
                                f"target is {ref.dtype}")
            return arr

        host = tree_map(load, on_disk, with_path=True)
        return step, (self.layout.from_disk(host) if self.layout else host)


__all__ = ["CheckpointManager", "Layout", "snapshot"]
