"""The port's sharded tier over 1, 2 and 4 ranks on the CPU against the JAX
package, bit for bit.

One scripted sequence (tests/_torch_ranks.py: P-Bahmani and CBDS-P on four
graphs, a pruned and a warm sharded ``DeltaEngine`` through 6 mixed batches
with a query, a fixed-round refined query and ``cbds`` after each, and a
fused+sharded bucket of 4 tenants through 6 rounds, a refined flush and
``cbds``) runs in this process over a mesh of one, and in 2 and 4 processes,
one a rank, over a gloo group. Every rank writes its answers; the ranks must
agree, make the same collectives, one a pass, and equal the JAX package run
here on the same numpy-seeded inputs: ``pbahmani_distributed`` and
``cbds_distributed`` on its 1-device mesh, and its single-device engines,
one per stream and one per tenant. A spawn that runs past its time limit is
killed and fails its tests, so a deadlocked collective cannot hang the suite.
"""
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_ranks as ranks  # noqa: E402
from repro.core.distributed import cbds_distributed as j_cbds_dist  # noqa: E402
from repro.core.distributed import pbahmani_distributed as j_pbahmani_dist  # noqa: E402
from repro.graphs import generators as jgen  # noqa: E402
from repro.graphs.graph import Graph as JGraph  # noqa: E402
from repro.stream import DeltaEngine as JEngine  # noqa: E402
from repro.utils.compat import make_mesh_auto  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
SPAWN_TIMEOUT_S = 120  # a whole world's spawn; killed past it
_COLLECTIVES: dict[int, int] = {}  # world size -> the sequence's collectives


@pytest.fixture(scope="module")
def jax_reference() -> dict:
    """The scripted sequence's answers from the JAX package, in the keys the
    ranks write (but the collective counts)."""
    mesh = make_mesh_auto((1,), ("shard",))
    out = {}
    for name, g in ranks.graphs(JGraph, jgen).items():
        for eps in (0.0, 0.1):
            d, mask, passes = j_pbahmani_dist(g, mesh, eps=eps)
            out[f"pb/{name}/{eps}"] = np.array([ranks.bits(d), passes], np.int64)
            out[f"pb/{name}/{eps}/mask"] = mask
        c = j_cbds_dist(g, mesh, rounds=2)
        ranks.record_cbds(out, f"cbds/{name}", c)
        out[f"cbds/{name}/coreness"] = c["coreness"]
    engines = {k: JEngine(ranks.STREAM_N, kernel=False, **kw)
               for k, kw in ranks.STREAM_ENGINES.items()}
    for step, (ins, dels) in enumerate(ranks.stream_batches()):
        for k, eng in engines.items():
            eng.apply_updates(insert=ins, delete=dels)
            ranks.record_query(out, f"stream/{k}/{step}", eng.query())
            ranks.record_refined(out, f"stream/{k}/{step}/refine", eng.query(**ranks.REFINE))
            ranks.record_cbds(out, f"stream/{k}/{step}/cbds", eng.cbds())
    solo = {t: JEngine(ranks.FUSED_N, eps=0.1, refresh_every=4, pruned=t in ("a", "b"),
                       kernel=False) for t in ranks.FUSED_TENANTS}
    for step in range(6):
        for t, (ins, dels) in ranks.fused_updates(step).items():
            solo[t].apply_updates(insert=ins, delete=dels)
            ranks.record_query(out, f"fused/{t}/{step}", solo[t].query())
    for t, eng in solo.items():
        ranks.record_refined(out, f"fused/{t}/refine", eng.query(**ranks.REFINE))
        ranks.record_cbds(out, f"fused/{t}/cbds", eng.cbds())
    return out


def _spawn(world: int, tmp: Path) -> list[dict]:
    """Run the sequence in ``world`` processes over a gloo group (file
    rendezvous in ``tmp``); kill them all once ``SPAWN_TIMEOUT_S`` has passed
    since the spawn. Each rank's output goes to a file, so no rank blocks on
    a full pipe while another is waited for."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    init = f"file://{tmp / 'rendezvous'}"
    logs = [tmp / f"rank{r}.log" for r in range(world)]
    procs = []
    for r in range(world):
        with open(logs[r], "w") as out:
            procs.append(subprocess.Popen(
                [sys.executable, str(ROOT / "tests" / "_torch_ranks.py"), str(r), str(world),
                 init, str(tmp / f"rank{r}.npz")], env=env, stdout=out,
                stderr=subprocess.STDOUT))
    deadline = time.monotonic() + SPAWN_TIMEOUT_S
    try:
        for p in procs:
            p.wait(timeout=max(deadline - time.monotonic(), 0.0))
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        for p in procs:
            p.wait()
        pytest.fail(f"{world} ranks did not finish in {SPAWN_TIMEOUT_S} s (a deadlocked "
                    "collective?)")
    for r, p in enumerate(procs):
        assert p.returncode == 0, f"rank {r} of {world} failed:\n{logs[r].read_text()}"
    return [dict(np.load(tmp / f"rank{r}.npz")) for r in range(world)]


@pytest.fixture(scope="module", params=[1, 2, 4], ids=lambda w: f"world{w}")
def rank_answers(request, tmp_path_factory) -> list[dict]:
    if request.param == 1:
        from repro_torch.core.distributed import make_mesh

        n = torch.get_num_threads()
        torch.set_num_threads(1)
        try:
            return [ranks.scripted(make_mesh(device="cpu"))]
        finally:
            torch.set_num_threads(n)
    return _spawn(request.param, tmp_path_factory.mktemp(f"world{request.param}"))


def _check(got: dict, want: dict, prefix: str) -> None:
    keys = [k for k in want if k.startswith(prefix)]
    assert keys
    for k in keys:
        assert np.array_equal(got[k], want[k]), (k, got[k], want[k])


def test_ranks_agree(rank_answers):
    first = rank_answers[0]
    for r, ans in enumerate(rank_answers[1:], 1):
        assert ans.keys() == first.keys()
        for k in first:
            assert np.array_equal(ans[k], first[k]), (r, k)


def test_static_peels_equal_jax(rank_answers, jax_reference):
    for prefix in ("pb/", "cbds/"):
        _check(rank_answers[0], jax_reference, prefix)


def test_sharded_stream_equals_jax(rank_answers, jax_reference):
    _check(rank_answers[0], jax_reference, "stream/")


def test_fused_sharded_bucket_equals_jax(rank_answers, jax_reference):
    _check(rank_answers[0], jax_reference, "fused/")


def test_one_collective_a_pass(rank_answers):
    """``pbahmani_distributed`` makes one all-reduce for the degrees and one
    a pass; the whole sequence makes the same count on every world size
    (a rank's count cannot depend on its lanes, or the group deadlocks)."""
    ans = rank_answers[0]
    for k, (n, passes) in ((k, v) for k, v in ans.items() if k.startswith("coll/pb/")):
        assert n == passes + 1, k
    _COLLECTIVES[len(rank_answers)] = int(ans["collectives"][0])
    assert len(set(_COLLECTIVES.values())) == 1, _COLLECTIVES
