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
ints/floats at the leaves. numpy has no bfloat16, so a bfloat16 tensor
raises a ``TypeError`` that names its leaf.

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

import numpy as np
import torch

from repro_torch.utils.tree import leaves_with_paths, path_key, tree_map


def _flatten(state) -> dict:
    return dict(leaves_with_paths(state))


def _host(path: tuple, leaf):
    if isinstance(leaf, torch.Tensor):
        if leaf.dtype == torch.bfloat16:
            raise TypeError(f"leaf {path_key(path)} is bfloat16, which "
                            "numpy (the checkpoint format) cannot hold")
        return leaf.detach().to("cpu", copy=True).numpy()
    return np.asarray(leaf)


def snapshot(state):
    """``state`` with every leaf a host numpy array (tensors copied off
    their device: a host sync for a CUDA tensor)."""
    return tree_map(_host, state, with_path=True)


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3, async_save: bool = True):
        self.dir = directory
        self.keep = keep
        self.async_save = async_save
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None
        os.makedirs(directory, exist_ok=True)

    # -- save ---------------------------------------------------------------
    def save(self, step: int, state, blocking: bool = False):
        """Snapshot ``state`` to host and write it as ``step``: on a thread
        unless ``blocking`` or the manager is synchronous. Returns the host
        snapshot (numpy leaves), which the caller may read without another
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
        flat = _flatten(host_state)
        manifest = {}
        for i, (key, leaf) in enumerate(sorted(flat.items())):
            fn = f"leaf_{i:05d}.npy"
            np.save(os.path.join(tmp, fn), np.asarray(leaf))
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
        shapes; tensors are not read). Returns (step, state) with numpy
        leaves (Python scalars where ``target`` holds them); the caller puts
        them on a device. ``step=None`` reads the newest step, which may race
        a save still on its thread: pass the step read after :meth:`wait`."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.dir}")
        d = os.path.join(self.dir, f"step_{step}")
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)["leaves"]
        missing = set(_flatten(target)) - set(manifest)
        if missing:
            raise KeyError(f"checkpoint at step {step} missing leaves {sorted(missing)[:5]}")

        def load(path, ref):
            key = path_key(path)
            arr = np.load(os.path.join(d, manifest[key]))
            if hasattr(ref, "shape"):
                if tuple(arr.shape) != tuple(ref.shape):
                    raise ValueError(f"leaf {key}: checkpoint shape {arr.shape} != "
                                     f"target {tuple(ref.shape)}")
                return arr
            return type(ref)(arr)

        return step, tree_map(load, target, with_path=True)


__all__ = ["CheckpointManager", "snapshot"]
