"""Fixed-capacity, sentinel-padded edge buffer for dynamic graphs.

The static pipeline compiles one executable per padded edge-array shape
(graphs/graph.py). A dynamic graph would re-pad — and therefore recompile —
on every update batch. ``EdgeBuffer`` removes that: undirected edges live in
``capacity`` slots (capacity is always a power of two), empty slots hold the
sentinel vertex ``n_nodes``, and the device view is the same symmetric COO
layout the peeling kernels already consume (``src = [u | v]``,
``dst = [v | u]``, shape ``[2 * capacity]``). Capacity only ever *doubles*,
so a graph that grows through k batches passes through at most log2 distinct
shapes (the shape discipline the JAX package's jit caches need; this
package keeps it, so both hold the same slots, compared array for array in
tests/test_torch_stream.py).

Deletions punch holes (slot -> sentinel) instead of compacting, keeping
update cost O(batch); freed slots are recycled hole-first for later
insertions. The ``epoch_compact`` hook rebuilds a dense prefix when the
delta engine runs its staleness refresh, and with ``shrink=True`` also
*halves capacity down* to the smallest pow-2 that keeps 2x headroom, so
sliding-window/delete-heavy tenants do not keep peak-size slot arrays
forever. Hysteresis: a shrink fires only when live
edges occupy <= ``SHRINK_FRACTION`` of capacity, and lands at <= 50%
occupancy, so an oscillating graph cannot thrash grow/shrink.

Delete-heavy streams also fragment the slot space with tombstones faster
than any epoch cadence cleans them up; when the un-recycled-hole fraction
exceeds ``compact_threshold`` the buffer compacts itself mid-stream
(bumping ``generation`` so resident device state and compiled executables
re-bucket correctly).

Host-side membership is a dict keyed on the canonical pair (min, max), the
streaming analog of the paper's "super map": arbitrary update order, O(1)
dedup, O(1) delete.
"""
from __future__ import annotations

import numpy as np

from repro_torch.graphs.graph import Graph
from repro_torch.utils.num import next_pow2

MIN_CAPACITY = 256  # matches Graph.from_edges pad_multiple
SHRINK_FRACTION = 0.25  # epoch shrink only below 25% occupancy (hysteresis)
TOMBSTONE_COMPACT_FRACTION = 0.5  # default mid-stream compaction trigger


class EdgeBuffer:
    """Mutable undirected edge set with a static-shape device view."""

    def __init__(self, n_nodes: int, capacity: int = MIN_CAPACITY,
                 compact_threshold: float | None = TOMBSTONE_COMPACT_FRACTION,
                 min_capacity: int = MIN_CAPACITY):
        if n_nodes <= 0:
            raise ValueError("EdgeBuffer needs n_nodes >= 1")
        # min_capacity floors every shrink (and the initial size): sharded
        # engines raise it so the slot space never drops below one lane
        # block per mesh device
        self.min_capacity = max(next_pow2(min_capacity), MIN_CAPACITY)
        capacity = max(next_pow2(capacity), self.min_capacity)
        self.n_nodes = int(n_nodes)
        self.capacity = capacity
        self.compact_threshold = compact_threshold
        self._u = np.full(capacity, n_nodes, dtype=np.int32)
        self._v = np.full(capacity, n_nodes, dtype=np.int32)
        self._slot: dict[tuple[int, int], int] = {}
        # never-used slots, popped in ascending order; freed slots (holes)
        # live separately so fragmentation is observable and holes recycle
        # first (dense prefixes survive churn longer)
        self._fresh: list[int] = list(range(capacity - 1, -1, -1))
        self._holes: list[int] = []
        self.generation = 0  # bumped on every grow/compact (shape/layout epoch)
        self._version = 0    # bumped on every mutation (sorted-view cache key)
        self._sorted_cache: tuple | None = None

    # -- properties ---------------------------------------------------------
    @property
    def n_edges(self) -> int:
        return len(self._slot)

    @property
    def sentinel(self) -> int:
        return self.n_nodes

    @property
    def tombstone_fraction(self) -> float:
        """Fraction of the slot space holding un-recycled delete holes."""
        return len(self._holes) / self.capacity

    def __contains__(self, edge: tuple[int, int]) -> bool:
        u, v = int(edge[0]), int(edge[1])
        return (min(u, v), max(u, v)) in self._slot

    # -- mutation -----------------------------------------------------------
    def _canonicalize(self, edges: np.ndarray) -> np.ndarray:
        edges = np.asarray(edges, dtype=np.int64).reshape(-1, 2)
        if edges.size and (edges.min() < 0 or edges.max() >= self.n_nodes):
            raise ValueError(
                f"edge endpoint out of range [0, {self.n_nodes}): "
                f"min={edges.min()} max={edges.max()}"
            )
        u = np.minimum(edges[:, 0], edges[:, 1])
        v = np.maximum(edges[:, 0], edges[:, 1])
        keep = u != v  # simple-graph convention: drop self-loops
        return np.stack([u[keep], v[keep]], axis=1)

    def apply(
        self, insert: np.ndarray | None = None, delete: np.ndarray | None = None
    ) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        """Apply a batch. Returns the *effective*
        ``(inserted [k,2], ins_slots [k], deleted [m,2], del_slots [m])``:
        inserts already present and deletes of absent edges are dropped.
        Deletes are applied first (stream semantics: a batch is a set of
        retractions followed by assertions), so an insert may reuse a slot
        freed by a delete in the same batch. Slot indices let the delta
        engine patch its device-resident arrays in O(batch).

        If the batch leaves the tombstone fraction above
        ``compact_threshold`` the buffer compacts itself before returning
        (``generation`` bumps, so callers holding device state must resync —
        the returned slot indices refer to the pre-compaction layout)."""
        deleted, del_slots = [], []
        if delete is not None:
            for u, v in self._canonicalize(delete):
                slot = self._slot.pop((int(u), int(v)), None)
                if slot is None:
                    continue
                self._u[slot] = self.sentinel
                self._v[slot] = self.sentinel
                self._holes.append(slot)
                deleted.append((int(u), int(v)))
                del_slots.append(slot)
        inserted, ins_slots = [], []
        if insert is not None:
            ins = self._canonicalize(insert)
            if ins.size:
                ins = np.unique(ins, axis=0)
            new = [
                (int(u), int(v)) for u, v in ins if (int(u), int(v)) not in self._slot
            ]
            # grow once, up front, if the effective batch cannot fit
            if len(self._slot) + len(new) > self.capacity:
                self._grow(next_pow2(len(self._slot) + len(new)))
            for key in new:
                slot = self._holes.pop() if self._holes else self._fresh.pop()
                self._slot[key] = slot
                self._u[slot] = key[0]
                self._v[slot] = key[1]
                inserted.append(key)
                ins_slots.append(slot)
        self._version += 1
        if (self.compact_threshold is not None
                and len(self._holes) > self.compact_threshold * self.capacity):
            self.epoch_compact()
        return (
            np.asarray(inserted, dtype=np.int32).reshape(-1, 2),
            np.asarray(ins_slots, dtype=np.int32),
            np.asarray(deleted, dtype=np.int32).reshape(-1, 2),
            np.asarray(del_slots, dtype=np.int32),
        )

    def _grow(self, new_capacity: int) -> None:
        new_capacity = max(next_pow2(new_capacity), 2 * self.capacity)
        u = np.full(new_capacity, self.sentinel, dtype=np.int32)
        v = np.full(new_capacity, self.sentinel, dtype=np.int32)
        u[: self.capacity] = self._u
        v[: self.capacity] = self._v
        self._fresh = (list(range(new_capacity - 1, self.capacity - 1, -1))
                       + self._fresh)
        self._u, self._v = u, v
        self.capacity = new_capacity
        self.generation += 1
        self._version += 1

    def shrink_target(self) -> int | None:
        """Pow-2 capacity an epoch shrink would land on, or None.

        Hysteresis: only fires below ``SHRINK_FRACTION`` occupancy and the
        target keeps 2x headroom (next regrow needs the live set to double),
        so grow/shrink cannot oscillate on a stable graph."""
        if self.n_edges > self.capacity * SHRINK_FRACTION:
            return None
        target = max(next_pow2(2 * max(self.n_edges, 1)), self.min_capacity)
        return target if target < self.capacity else None

    def epoch_compact(self, shrink: bool = False) -> bool:
        """Rebuild a dense slot prefix (hole-free); with ``shrink=True``
        also drop to ``shrink_target()`` when the hysteresis allows. Called
        by the delta engine's epoch refresh; O(n_edges), amortized away by
        the epoch. Returns True when capacity changed."""
        new_capacity = self.capacity
        if shrink:
            target = self.shrink_target()
            if target is not None:
                new_capacity = target
        pairs = sorted(self._slot)
        if new_capacity != self.capacity:
            self._u = np.full(new_capacity, self.sentinel, dtype=np.int32)
            self._v = np.full(new_capacity, self.sentinel, dtype=np.int32)
        else:
            self._u.fill(self.sentinel)
            self._v.fill(self.sentinel)
        shrunk = new_capacity != self.capacity
        self.capacity = new_capacity
        self._slot = {}
        for i, (u, v) in enumerate(pairs):
            self._slot[(u, v)] = i
            self._u[i] = u
            self._v[i] = v
        self._fresh = list(range(self.capacity - 1, len(pairs) - 1, -1))
        self._holes = []
        self.generation += 1
        self._version += 1
        return shrunk

    # -- views --------------------------------------------------------------
    def host_view(self) -> tuple[np.ndarray, np.ndarray]:
        """(u, v) undirected slot arrays, shape [capacity], sentinel-padded
        — the zero-copy host input for candidate compaction (core/prune.py).
        Callers must treat the arrays as read-only."""
        return self._u, self._v

    def device_view(self) -> tuple[np.ndarray, np.ndarray]:
        """(src, dst) symmetric COO, shape [2 * capacity], sentinel-padded —
        drop-in for the ``Graph.src``/``Graph.dst`` convention. Holes carry
        the sentinel so every edge-masked reduction skips them for free."""
        src = np.concatenate([self._u, self._v])
        dst = np.concatenate([self._v, self._u])
        return src, dst

    def resident_state(self, node_capacity: int) -> tuple[
            np.ndarray, np.ndarray, np.ndarray]:
        """(src, dst, deg) — the exact device-resident state a full resync
        uploads: the symmetric COO view plus the int32 degree histogram over
        the (pow-2 padded) vertex space. One code path for both the
        per-tenant engine (``DeltaEngine._resync_device``) and the fused
        multi-tenant lane writes (stream/fused.py), so a fused lane's
        post-resync state is bit-identical to an unbatched engine's by
        construction. Pair it with ``generation`` to track lane staleness:
        a lane whose recorded generation trails the buffer's must re-upload
        through this view before the next fused program runs."""
        src, dst = self.device_view()
        valid = src[src < self.sentinel]
        deg = np.bincount(valid, minlength=node_capacity)
        return src, dst, deg[:node_capacity].astype(np.int32)

    def dst_sorted_state(self, node_capacity: int) -> tuple[
            np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        """(src, dst, deg, lane_perm) — ``resident_state`` with the symmetric
        COO lanes stably sorted by dst, the layout the sorted kernels K1 and
        K2 require (kernels/segsum.py, kernels/peel.py). ``lane_perm[i]`` is
        the sorted position of unsorted lane ``i`` (slot ``s`` occupies lanes
        ``s`` and ``s + capacity``), so a delta engine can translate its
        O(batch) slot patches into the sorted layout without re-uploading.

        The tuple is a *snapshot*: cached until the next mutation. A slot
        patched through ``lane_perm`` lands at the snapshot's position, where
        its new dst is generally out of order; the delta engine re-sorts its
        device copy before the next kernel pass (stream/delta.py), and the
        next resync uploads a fresh sort of the current host state. Sentinel
        (hole) lanes sort past every real vertex id."""
        key = (self._version, int(node_capacity))
        if self._sorted_cache is not None and self._sorted_cache[0] == key:
            return self._sorted_cache[1]
        src, dst, deg = self.resident_state(node_capacity)
        order = np.argsort(dst, kind="stable")
        lane_perm = np.empty(order.size, dtype=np.int32)
        lane_perm[order] = np.arange(order.size, dtype=np.int32)
        out = (np.ascontiguousarray(src[order]),
               np.ascontiguousarray(dst[order]), deg, lane_perm)
        self._sorted_cache = (key, out)
        return out

    def to_graph(self) -> Graph:
        """Materialize an immutable Graph (compacted) — the oracle view."""
        if not self._slot:
            return Graph.from_edges(np.zeros((0, 2), np.int64), n_nodes=self.n_nodes)
        pairs = np.asarray(sorted(self._slot), dtype=np.int64)
        return Graph.from_edges(pairs, n_nodes=self.n_nodes)

    def __repr__(self) -> str:  # pragma: no cover
        return (
            f"EdgeBuffer(|V|={self.n_nodes}, |E|={self.n_edges}, "
            f"capacity={self.capacity}, gen={self.generation})"
        )


__all__ = ["EdgeBuffer", "next_pow2", "MIN_CAPACITY", "SHRINK_FRACTION",
           "TOMBSTONE_COMPACT_FRACTION"]
