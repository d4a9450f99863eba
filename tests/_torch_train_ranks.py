"""One rank of the port's training runtime on the CPU: the sequence that
tests/test_torch_optim.py and tests/test_torch_train.py run at world sizes 1
(in process), 2 and 4 (one process a rank over a gloo group) and hold
against the JAX package.

    python tests/_torch_train_ranks.py RANK WORLD INIT_METHOD OUT.npz CKPT_ROOT

It runs ``compressed_psum`` on each rank's numpy-seeded block,
``peel_with_restarts`` on two graphs for several failure points (each rank
in a checkpoint directory of its own under CKPT_ROOT), and
``restore_elastic`` of the checkpoint the caller left in CKPT_ROOT/elastic
onto the rank's mesh. :func:`scripted` returns a flat dict of arrays; a
rank writes it to ``OUT.npz``. It imports torch and the port only.
"""
from __future__ import annotations

import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

EPS = 0.05
PSUM_SHAPES = {"matrix": (64, 32), "stack": (3, 16, 8), "vector": (50,)}
ELASTIC_STEP = 7


def psum_block(name: str, rank: int) -> np.ndarray:
    """Rank ``rank``'s summand: a different scale on every rank, so the
    shared scale is some other rank's."""
    rng = np.random.default_rng(1000 * rank + len(name))
    return (rng.normal(size=PSUM_SHAPES[name]) * (1 + rank)).astype(np.float32)


def psum_closed_form(name: str, world: int) -> np.ndarray:
    """``compressed_psum`` in float32 numpy: the ranks' max per-row scale,
    each block quantized against it, the int sum rescaled."""
    xs = [psum_block(name, r) for r in range(world)]

    def scale(x):
        axes = tuple(range(1, x.ndim)) if x.ndim >= 2 else None
        amax = np.max(np.abs(x), axis=axes, keepdims=True)
        return (np.maximum(amax, np.float32(1e-12)) / np.float32(127.0)).astype(np.float32)

    s = np.max(np.stack([scale(x) for x in xs]), axis=0)
    total = sum(np.clip(np.round(x / s), -127, 127).astype(np.int32) for x in xs)
    return total.astype(np.float32) * s


def graphs(gen) -> dict:
    """The peel graphs, from either package's generators."""
    return {"planted": gen.planted_dense(400, 30, seed=2)[0],
            "rmat": gen.rmat(9, 8, seed=1)}


def fail_points(passes: int) -> list:
    """None, 0, 2 and the last pass (the loop's pass index before the last
    pass runs)."""
    return [None, 0, 2, passes - 1]


def bits(x) -> int:
    return int(np.float32(x).view(np.int32))


def elastic_state(torch):
    """The state the caller checkpoints for ``restore_elastic``."""
    g = np.random.default_rng(5)
    return {"w": torch.from_numpy(g.normal(size=(6, 4)).astype(np.float32)),
            "mask": torch.from_numpy(g.random(9) < 0.5),
            "step": torch.tensor(ELASTIC_STEP, dtype=torch.int32),
            "rows": [torch.arange(5, dtype=torch.int32), torch.zeros(2)]}


def scripted(mesh, ckpt_root: Path) -> dict:
    import torch

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.core import collective, pbahmani
    from repro_torch.graphs import generators
    from repro_torch.launch import peel_with_restarts, restore_elastic
    from repro_torch.optim import compressed_psum

    out: dict = {}
    for name in PSUM_SHAPES:
        before = collective.collectives
        got = compressed_psum(torch.from_numpy(psum_block(name, mesh.rank)), mesh)
        out[f"psum/{name}"] = got.numpy()
        out[f"psum/{name}/collectives"] = np.int64(collective.collectives - before)
    for gname, g in graphs(generators).items():
        _, _, passes = pbahmani(g, eps=EPS, device="cpu")
        for fail in fail_points(passes):
            d = ckpt_root / f"rank{mesh.rank}" / f"{gname}_{fail}"
            before = collective.collectives
            r = peel_with_restarts(g, mesh, EPS, CheckpointManager(str(d), keep=2),
                                   fail_at_pass=fail)
            key = f"peel/{gname}/{fail}"
            out[key] = np.array([bits(r["density"]), r["passes"],
                                 collective.collectives - before], np.int64)
            out[key + "/mask"] = r["mask"]
    template = {k: (torch.zeros_like(v) if isinstance(v, torch.Tensor)
                    else [torch.zeros_like(t) for t in v])
                for k, v in elastic_state(torch).items()}
    step, state = restore_elastic(CheckpointManager(str(ckpt_root / "elastic")), template,
                                  mesh=mesh)
    out["elastic/step"] = np.int64(step)
    out["elastic/on_mesh_device"] = np.int64(all(
        t.device == mesh.device for t in [state["w"], state["mask"], state["step"],
                                          *state["rows"]]))
    for k in ("w", "mask", "step"):
        out[f"elastic/{k}"] = state[k].numpy()
    out["elastic/rows0"] = state["rows"][0].numpy()
    return out


def spawn(world: int, tmp: Path, ckpt_root: Path, timeout_s: float) -> list[dict]:
    """Run :func:`scripted` in ``world`` processes over a gloo group (file
    rendezvous in ``tmp``); kill them all once ``timeout_s`` has passed.
    Returns each rank's dict, or raises with the failing rank's log."""
    root = Path(__file__).resolve().parent.parent
    env = dict(os.environ, PYTHONPATH=str(root / "src"), OMP_NUM_THREADS="1")
    init = f"file://{tmp / 'rendezvous'}"
    logs = [tmp / f"rank{r}.log" for r in range(world)]
    procs = []
    for r in range(world):
        with open(logs[r], "w") as out:
            procs.append(subprocess.Popen(
                [sys.executable, __file__, str(r), str(world), init,
                 str(tmp / f"rank{r}.npz"), str(ckpt_root)],
                env=env, stdout=out, stderr=subprocess.STDOUT))
    deadline = time.monotonic() + timeout_s
    try:
        for p in procs:
            p.wait(timeout=max(deadline - time.monotonic(), 0.0))
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        for p in procs:
            p.wait()
        raise TimeoutError(f"{world} ranks did not finish in {timeout_s} s")
    for r, p in enumerate(procs):
        if p.returncode != 0:
            raise RuntimeError(f"rank {r} of {world} failed:\n{logs[r].read_text()}")
    return [dict(np.load(tmp / f"rank{r}.npz")) for r in range(world)]


def main(argv: list[str]) -> int:
    rank, world, init, out_path, ckpt_root = argv
    import torch
    import torch.distributed as dist

    from repro_torch.core.distributed import make_mesh

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, world_size=int(world), rank=int(rank))
    try:
        out = scripted(make_mesh(device="cpu"), Path(ckpt_root))
    finally:
        dist.destroy_process_group()
    np.savez(out_path, **out)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
