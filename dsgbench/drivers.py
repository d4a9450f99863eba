"""The general generator: one driver a traffic kind, each reading its mix
from a traffic file and its deployment from a configuration file.

A driver builds the inputs from the seed and hands them to the program
(``setup``), runs one cycle of the mix at a time (``cycle``), lets the
program's state go (``free``), and then holds every answer it kept against
the plain reference (``checks``). A cycle is the unit a window ends on: a
window runs whole cycles until its seconds have passed.

Kinds:
  * ``closed_loop`` — one client calls a single-graph entry point of the
    program again and again, with the keyword arguments of ``calls`` in
    turn (one cycle is one pass over ``calls``); every answer is compared
    field by field, and the masks of a seeded sample of answers.
  * ``tenant_rounds`` — rounds over one bucket of a multi-tenant service:
    each tenant's event batch through one ``ingest_many``, one
    ``submit_density`` a tenant, one ``flush``; a cycle is ``cycle_rounds``
    rounds. The answers of a seeded sample of rounds are compared with a
    cold peel of each tenant's edge set at that round.

Every call runs the port's CUDA kernels (``kernel=True``) and the tenants
run in the fused service (``fused=True``): these are what the cells
measure, so no configuration can switch them off.
"""
from __future__ import annotations

import importlib
import time

import numpy as np
import torch

from dsgbench.gen.graph500 import graph500
from dsgbench.gen.tenants import TenantStream, bucket_names, is_planted
from dsgbench.recorder import Recorder
from dsgbench.reference.cbds import cbds_ref
from dsgbench.reference.peel import pbahmani_ref
from dsgbench.reference.stream import EdgeSet
from dsgbench.roofline import k2_bytes


def f32_bits(x) -> int:
    return int(np.float32(x).view(np.int32))


def check_rng(seed: int, salt: int) -> np.random.Generator:
    """The seeded draws of which answers are compared (never the inputs')."""
    return np.random.default_rng([int(seed) % (1 << 63), salt])


class Clock:
    """Laps of the host clock, for the set-up's account on standard error."""

    def __init__(self):
        self.t, self.laps = time.perf_counter(), []

    def lap(self, what: str) -> None:
        now = time.perf_counter()
        self.laps.append((what, now - self.t))
        self.t = now


class Reservoir:
    """A uniform sample of at most ``size`` masks of a stream (Algorithm R),
    drawn from a seeded generator. A kept mask is copied into storage that
    set-up allocates and touches, so keeping one costs a copy and never
    fresh pages of host memory inside the window."""

    def __init__(self, size: int, length: int, rng: np.random.Generator):
        self.size, self.rng, self.seen = int(size), rng, 0
        self.store = np.ones((self.size, int(length)), dtype=bool)   # every page touched
        self.index: list[int] = []   # the answer each filled slot holds

    def offer(self, k: int, mask) -> None:
        if self.seen < self.size:
            slot = self.seen
            self.index.append(k)
        else:
            slot = int(self.rng.integers(0, self.seen + 1))
            if slot < self.size:
                self.index[slot] = k
        if slot < self.size:
            self.store[slot] = mask
        self.seen += 1

    @property
    def items(self) -> list[tuple[int, np.ndarray]]:
        return [(k, self.store[i]) for i, k in enumerate(self.index)]


# entry point -> (program call, fields of its answer, its mask, reference)
def _pbahmani_entry():
    mod = importlib.import_module("repro_torch.core.pbahmani")

    def call(graph, device, **kw):
        return mod.pbahmani(graph, kernel=True, device=device, **kw)

    def fields(out):
        return (f32_bits(out[0]), int(out[2])), out[1]

    def reference(lanes, eps, pruned=False):
        # the candidate-pruned peel gives the same triple as the full one
        density, mask, passes = pbahmani_ref(lanes.n_nodes, lanes.src[:lanes.n_directed],
                                             lanes.dst[:lanes.n_directed], eps)
        return (f32_bits(density), passes), mask

    return call, fields, reference


def _cbds_entry():
    mod = importlib.import_module("repro_torch.core.cbds")

    def call(graph, device, **kw):
        return mod.cbds_p(graph, kernel=True, device=device, **kw)

    def fields(out):
        return ((f32_bits(out["density"]), f32_bits(out["core_density"]), int(out["k_star"]),
                 int(out["n_legit"])), out["member_mask"])

    def reference(lanes, rounds):
        out = cbds_ref(lanes.n_nodes, lanes.src[:lanes.n_directed],
                       lanes.dst[:lanes.n_directed], rounds)
        return fields(out)

    return call, fields, reference


ENTRIES = {"pbahmani": _pbahmani_entry, "cbds_p": _cbds_entry}
FIELD_NAMES = {"pbahmani": ("density_bits", "passes"),
               "cbds_p": ("density_bits", "core_density_bits", "k_star", "n_legit")}


class ClosedLoop:
    def __init__(self, cfg: dict, traffic: dict, seed: int, device: torch.device):
        if cfg["kind"] != "graph500":
            raise ValueError(f"closed_loop drives a graph configuration, not {cfg['kind']!r}")
        self.cfg, self.traffic, self.seed, self.device = cfg, traffic, seed, device
        self.calls = [dict(c) for c in traffic["calls"]]
        self.kept: list[tuple[int, tuple]] = []   # (call index, fields) of every answer

    def setup(self) -> None:
        from repro_torch.graphs.graph import Graph

        clock = Clock()
        self.lanes = graph500(self.cfg, self.seed, self.device)
        clock.lap("graph drawn on the device and copied to the host")
        self.masks = Reservoir(self.traffic["mask_sample"], self.lanes.n_nodes,
                               check_rng(self.seed, 1))
        self.graph = Graph(n_nodes=self.lanes.n_nodes, n_edges=self.lanes.n_edges,
                           src=self.lanes.src, dst=self.lanes.dst,
                           n_directed=self.lanes.n_directed)
        self.call, self.fields, self.reference = ENTRIES[self.traffic["entry"]]()
        for kw in self.calls:  # every shape the window uses, each library built
            self.call(self.graph, self.device, **kw)
            clock.lap(f"warm {self.traffic['entry']}({kw})")
        self.setup_laps = clock.laps

    def describe(self) -> str:
        return (f"graph500 scale {self.cfg['scale']}: {self.lanes.n_nodes} vertices, "
                f"{self.lanes.n_edges} edges, {self.lanes.src.shape[0]} padded lanes")

    def counters(self) -> dict:
        from repro_torch.kernels import peel

        return {"k2_launches": peel.launches}

    def k2_bytes(self) -> int:
        return k2_bytes(self.lanes.src.shape[0], self.lanes.n_nodes)

    def cycle(self, rec) -> None:
        name = self.traffic["entry"]
        for i, kw in enumerate(self.calls):
            t0 = time.perf_counter()
            with rec.call(name):
                out = self.call(self.graph, self.device, **kw)
            rec.answer(time.perf_counter() - t0)
            fields, mask = self.fields(out)
            self.masks.offer(len(self.kept), mask)
            self.kept.append((i, fields))

    def exhausted(self) -> bool:
        return False

    def free(self) -> None:
        del self.graph

    def checks(self) -> tuple[dict, list[str]]:
        """``({"wrong_answers": n, "answers_checked": n, "masks_checked": n},
        notes)``: an answer is wrong where any field or its sampled mask
        differs from the reference's."""
        refs = [self.reference(self.lanes, **kw) for kw in self.calls]
        names = FIELD_NAMES[self.traffic["entry"]]
        wrong, notes = set(), []
        for k, (i, fields) in enumerate(self.kept):
            if fields != refs[i][0]:
                wrong.add(k)
                if len(notes) < 5:
                    notes.append(f"answer {k} ({self.calls[i]}): {dict(zip(names, fields))} "
                                 f"!= reference {dict(zip(names, refs[i][0]))}")
        for k, mask in self.masks.items:
            i = self.kept[k][0]
            if not np.array_equal(np.asarray(mask), refs[i][1]):
                wrong.add(k)
                if len(notes) < 10:
                    diff = int(np.count_nonzero(np.asarray(mask) != refs[i][1]))
                    notes.append(f"answer {k} ({self.calls[i]}): mask differs in {diff} vertices")
        return ({"wrong_answers": len(wrong), "answers_checked": len(self.kept),
                 "masks_checked": len(self.masks.items)}, notes)


class TenantRounds:
    def __init__(self, cfg: dict, traffic: dict, seed: int, device: torch.device):
        if cfg["kind"] != "tenants":
            raise ValueError(f"tenant_rounds drives a tenants configuration, not {cfg['kind']!r}")
        self.cfg, self.traffic, self.seed, self.device = cfg, traffic, seed, device
        self.bucket = traffic["bucket"]
        self.names = bucket_names(cfg, self.bucket)
        self.next_round = 0
        # (round, [(density bits, passes) or None for each tenant]) of every round
        self.kept: list[tuple[int, list]] = []
        self.measured_rounds: list[int] = []

    def setup(self) -> None:
        from repro_torch.stream import StreamService

        svc_cfg = self.cfg["service"]
        clock = Clock()
        stream = TenantStream(self.cfg, self.seed, self.device)
        self.seeds = stream.seeds()
        n_insert = round(self.traffic["events"] * self.traffic["insert_share"])
        self.inserts, self.deletes = stream.rounds(
            self.bucket, self.traffic["max_rounds"], n_insert, self.traffic["events"] - n_insert)
        clock.lap(f"seeds and {self.traffic['max_rounds']} rounds drawn on the device")
        self.svc = StreamService(
            max_tenants=len(self.seeds), fused=True, eps=svc_cfg["eps"],
            refresh_every=svc_cfg["refresh_every"], kernel=True,
            coalesce_window_ms=svc_cfg["coalesce_window_ms"], device=self.device)
        for bucket, b in self.cfg["buckets"].items():
            for i, name in enumerate(bucket_names(self.cfg, bucket)):
                r = self.svc.create_tenant(name, n_nodes=b["n"], capacity=b["capacity"],
                                           pruned=is_planted(self.cfg, bucket, i))
                if not r.ok:
                    raise RuntimeError(f"create_tenant {name}: {r.error}")
        clock.lap("service and tenants created")
        r = self.svc.ingest_many({name: (pairs, None) for name, pairs in self.seeds.items()})
        if not r.ok:
            raise RuntimeError(f"seeding ingest_many: {r.error}")
        clock.lap("seeding ingest_many")
        for _ in range(self.traffic["warm_cycles"]):
            self.cycle(None)
        clock.lap(f"{self.traffic['warm_cycles']} warm cycle(s)")
        self.setup_laps = clock.laps

    def describe(self) -> str:
        b = self.cfg["buckets"][self.bucket]
        return (f"{len(self.seeds)} tenants; {len(self.names)} driven in bucket "
                f"{self.bucket!r} at {b['n']} vertices, {self.traffic['events']} events a "
                f"tenant a round, {self.traffic['cycle_rounds']} rounds a cycle")

    def counters(self) -> dict:
        from repro_torch.kernels import peel

        return {"k2_launches": peel.launches}

    def k2_bytes(self) -> None:
        return None  # the rows entry of K2 runs here, not the one-graph K2

    def exhausted(self) -> bool:
        """No whole cycle of the drawn rounds is left: a window ends here
        early rather than fail, its rate still all its work over all its time."""
        return self.next_round + self.traffic["cycle_rounds"] > self.traffic["max_rounds"]

    def cycle(self, rec) -> None:
        for _ in range(self.traffic["cycle_rounds"]):
            self._round(rec)

    def _round(self, rec) -> None:
        r = self.next_round
        if r >= self.traffic["max_rounds"]:
            raise RuntimeError(f"the stream's {self.traffic['max_rounds']} rounds ran out")
        self.next_round += 1
        if rec is None:  # a warm-up round
            rec = Recorder(self.device)
        else:
            self.measured_rounds.append(r)
        svc = self.svc
        updates = {name: (self.inserts[r, t], self.deletes[r, t])
                   for t, name in enumerate(self.names)}
        t0 = time.perf_counter()
        with rec.call("ingest_many"):
            ingested = svc.ingest_many(updates)
        tickets = [svc.submit_density(name) for name in self.names]
        with rec.call("flush"):
            svc.flush()
        answers = [svc.poll(ticket) for ticket in tickets]
        latency = time.perf_counter() - t0
        got = []
        for resp in answers:
            ok = ingested.ok and resp is not None and resp.ok
            rec.answer(latency, ok)
            got.append((f32_bits(resp.value["density"]), int(resp.value["passes"]))
                       if ok else None)
        self.kept.append((r, got))

    def free(self) -> None:
        self.svc.shutdown()
        del self.svc

    def checks(self) -> tuple[dict, list[str]]:
        """Every answer that never came or came as an error is wrong; so is
        each answer of a seeded sample of ``check_rounds`` measured rounds
        whose density bits or passes differ from a cold peel of the tenant's
        edge set after that round."""
        sample = set(check_rng(self.seed, 2).choice(
            self.measured_rounds, min(self.traffic["check_rounds"], len(self.measured_rounds)),
            replace=False).tolist()) if self.measured_rounds else set()
        n = int(self.cfg["buckets"][self.bucket]["n"])
        eps = float(self.cfg["service"]["eps"])
        sets = [EdgeSet(n, self.seeds[name]) for name in self.names]
        by_round = dict(self.kept)
        last = max(sample, default=-1)
        wrong, checked, notes = 0, 0, []
        measured = set(self.measured_rounds)
        for r, got in self.kept:
            if r in measured:
                wrong += sum(g is None for g in got)
        for r in range(last + 1):
            for t, es in enumerate(sets):
                es.apply(self.inserts[r, t], self.deletes[r, t])
            if r not in sample:
                continue
            for t, es in enumerate(sets):
                density, _, passes = es.cold_peel(eps)
                want, g = (f32_bits(density), passes), by_round[r][t]
                checked += 1
                if g is not None and g != want:
                    wrong += 1
                    if len(notes) < 10:
                        notes.append(f"round {r} {self.names[t]}: (density bits, passes) {g} "
                                     f"!= cold peel {want}")
        return ({"wrong_answers": wrong,
                 "answers_checked": checked,
                 "rounds_checked": len(sample)}, notes)


DRIVERS = {"closed_loop": ClosedLoop, "tenant_rounds": TenantRounds}

__all__ = ["DRIVERS", "ENTRIES", "ClosedLoop", "TenantRounds", "Reservoir", "f32_bits"]
