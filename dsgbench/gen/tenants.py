"""The multi-tenant fraud stream, drawn on the device with a ``torch.Generator``.

Seeding follows the JAX package's tenant benchmark and the fused smoke phase:
a tenant with a colluding block holds a uniform background of
``round(p_background * n * (n - 1) / 2)`` pairs plus each pair of its first
``clique`` vertices with probability ``p_planted`` (Fraudar's injected dense
block); a uniform tenant holds ``uniform_pairs`` uniform pairs. Pairs are
raw: self-loops and repeats stay in, for the service to drop.

Each round gives every tenant of the driven bucket ``n_delete`` deletes of
edges present at that point, drawn uniformly without replacement, then
``n_insert`` uniform pairs. The generator keeps the present edge set of the
whole bucket as one sorted tensor of keys ``(t * n + u) * n + v`` (``u < v``)
and moves it as the service's stream semantics do: deletes first, then the
inserts that are new.
"""
from __future__ import annotations

import numpy as np
import torch

from dsgbench.gen.graph500 import generator

SENT = torch.iinfo(torch.int64).max   # an empty slot of the present-set buffer


def bucket_names(cfg: dict, bucket: str) -> list[str]:
    return [f"{bucket}{i:02d}" for i in range(int(cfg["buckets"][bucket]["tenants"]))]


def is_planted(cfg: dict, bucket: str, i: int) -> bool:
    return i < int(cfg["buckets"][bucket].get("planted", 0))


class TenantStream:
    """Seeds and rounds of one configuration's tenants for one seed. Draws
    happen in a fixed order (every bucket's seeds, then the rounds), so the
    same seed gives the same stream."""

    def __init__(self, cfg: dict, seed: int, device):
        self.cfg = cfg
        self.device = torch.device(device)
        self.gen = generator(seed, self.device)
        self._present: dict[str, torch.Tensor] = {}

    def _randint(self, n: int, shape) -> torch.Tensor:
        return torch.randint(0, n, shape, generator=self.gen, device=self.device)

    def _seed_pairs(self, b: dict, planted: bool) -> torch.Tensor:
        n = int(b["n"])
        if not planted:
            return self._randint(n, (int(b["uniform_pairs"]), 2))
        background = self._randint(n, (round(float(b["p_background"]) * n * (n - 1) / 2), 2))
        iu = torch.triu_indices(int(b["clique"]), int(b["clique"]), 1, device=self.device)
        keep = torch.rand(iu.shape[1], generator=self.gen, device=self.device) < float(
            b["p_planted"])
        return torch.cat([background, iu[:, keep].T.to(torch.int64)])

    def seeds(self) -> dict[str, np.ndarray]:
        """Every tenant's seed pairs, int64 ``[k, 2]`` on the host, by name."""
        out, present = {}, {}
        for bucket, b in self.cfg["buckets"].items():
            n, keys = int(b["n"]), []
            for i, name in enumerate(bucket_names(self.cfg, bucket)):
                pairs = self._seed_pairs(b, is_planted(self.cfg, bucket, i))
                out[name] = pairs.cpu().numpy()
                keys.append(self._keys(i, pairs, n))
            present[bucket] = torch.unique(torch.cat(keys), sorted=True)
        self._present = present
        return out

    @staticmethod
    def _keys(t, pairs: torch.Tensor, n: int) -> torch.Tensor:
        """Keys of the pairs that are edges (self-loops dropped); ``t`` the
        tenant's index, an int or a tensor broadcast against the pairs."""
        u = torch.minimum(pairs[..., 0], pairs[..., 1])
        v = torch.maximum(pairs[..., 0], pairs[..., 1])
        keys = (t * n + u) * n + v
        return keys[u != v]

    def rounds(self, bucket: str, n_rounds: int, n_insert: int, n_delete: int):
        """``(inserts, deletes)``, int32 ``[n_rounds, T, n_insert | n_delete, 2]``
        on the host: each round's events for each tenant of ``bucket``.

        The present set lives in a fixed-size sorted buffer whose tail holds
        the sentinel ``SENT``, so a round makes no host sync; the checks
        that every tenant held ``n_delete`` edges and that the buffer never
        overflowed are read once at the end."""
        b = self.cfg["buckets"][bucket]
        n, t_count = int(b["n"]), int(b["tenants"])
        dev = self.device
        real = self._present[bucket]
        # room for one round's inserts, and for growth where inserts outnumber deletes
        cap = real.numel() + t_count * (n_insert + max(n_insert - n_delete, 0) * int(n_rounds))
        present = torch.full((cap,), SENT, dtype=torch.int64, device=dev)
        present[:real.numel()] = real
        tenant = torch.arange(t_count, device=dev)
        offsets = torch.arange(n_delete, device=dev)
        fewest = torch.full((), n_delete, dtype=torch.int64, device=dev)
        spill = torch.zeros((), dtype=torch.bool, device=dev)
        ins_all, del_all = [], []
        for _ in range(int(n_rounds)):
            owner = torch.where(present == SENT, t_count, present // (n * n))
            counts = torch.bincount(owner, minlength=t_count + 1)[:t_count]
            fewest = torch.minimum(fewest, counts.min())
            scores = torch.rand(cap, generator=self.gen, device=dev, dtype=torch.float64)
            order = torch.argsort(owner.to(torch.float64) + scores)
            pick = order[(torch.cumsum(counts, 0) - counts)[:, None] + offsets[None]]
            gone = present[pick]
            present[pick.reshape(-1)] = SENT
            present = torch.sort(present).values
            del_all.append(torch.stack([(gone // n) % n, gone % n], dim=-1).to(torch.int32))

            ins = self._randint(n, (t_count, n_insert, 2))
            u = torch.minimum(ins[..., 0], ins[..., 1])
            v = torch.maximum(ins[..., 0], ins[..., 1])
            keys = torch.where(u != v, (tenant[:, None] * n + u) * n + v, SENT)
            keys = torch.sort(keys.reshape(-1)).values
            repeat = torch.cat([torch.zeros(1, dtype=torch.bool, device=dev),
                                keys[1:] == keys[:-1]])
            at = torch.searchsorted(present, keys).clamp(max=cap - 1)
            keys = torch.where(repeat | (present[at] == keys), SENT, keys)
            merged = torch.sort(torch.cat([present, keys])).values
            spill |= merged[cap] != SENT
            present = merged[:cap]
            ins_all.append(ins.to(torch.int32))
        if int(fewest) < n_delete or bool(spill):
            raise ValueError(f"a tenant of {bucket} held fewer than {n_delete} edges, or the "
                             f"present set outgrew its buffer")
        self._present[bucket] = present[present != SENT]
        return (torch.stack(ins_all).cpu().numpy(), torch.stack(del_all).cpu().numpy())


__all__ = ["TenantStream", "bucket_names", "is_planted"]
