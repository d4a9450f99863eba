"""A run with the timed path broken underneath comes out not correct: the
harness's look for a card skipped (the CPU path), everything else as a run
does it. Faults a cell can have: an answer altered where it is produced
(every cell), a step that leaves the state unchanged and half of a batch
left out (the tenant rounds). A P-Bahmani pass that returned its state
unchanged would never end; the run's time limit is what catches it."""
import dataclasses
import importlib

import numpy as np
import pytest

from dsgbench.drivers import f32_bits

from _dsgbench_small import run_small


def nudge(x: float) -> float:
    """The next float32 above ``x``."""
    return float(np.nextafter(np.float32(x), np.float32(np.inf)))


def test_an_unbroken_run_is_correct():
    assert run_small("g500s19-peel")[0]["correct"]


@pytest.mark.parametrize("fault", ["density", "mask", "passes", "one_answer"])
def test_pbahmani_answer_altered(fault, monkeypatch):
    mod = importlib.import_module("repro_torch.core.pbahmani")

    real, calls = mod.pbahmani, []

    def broken(graph, **kw):
        d, m, p = real(graph, **kw)
        calls.append(1)
        if fault == "one_answer" and len(calls) != 5:
            return d, m, p
        if fault in ("density", "one_answer"):
            d = nudge(d)
        elif fault == "mask":
            m = m.copy()
            m[int(np.flatnonzero(m)[0])] = False
        else:
            p += 1
        return d, m, p

    monkeypatch.setattr(mod, "pbahmani", broken)
    result, lines = run_small("g500s19-peel")
    assert not result["correct"], lines


@pytest.mark.parametrize("field", ["density", "core_density", "k_star", "n_legit",
                                   "member_mask"])
def test_cbds_answer_altered(field, monkeypatch):
    mod = importlib.import_module("repro_torch.core.cbds")

    real = mod.cbds_p

    def broken(graph, **kw):
        out = dict(real(graph, **kw))
        if field in ("density", "core_density"):
            out[field] = nudge(out[field])
        elif field == "member_mask":
            out[field] = ~out[field]
        else:
            out[field] += 1
        return out

    monkeypatch.setattr(mod, "cbds_p", broken)
    result, lines = run_small("g500s19-cbds")
    assert not result["correct"], lines


@pytest.mark.parametrize("fault", ["state_unchanged", "half_the_batch"])
def test_tenant_ingest_broken(fault, monkeypatch):
    import repro_torch.stream.service as svc

    real = svc.ingest_group

    def broken(updates, engines):
        if fault == "state_unchanged":
            return {}
        kept = dict(list(updates.items())[: len(updates) // 2])
        return real(kept, {t: engines[t] for t in kept})

    monkeypatch.setattr(svc, "ingest_group", broken)
    # with no ingest every query is a cached answer: a round takes a millisecond
    result, lines = run_small("tenants-lane", seconds=0.02)
    assert not result["correct"], lines


@pytest.mark.parametrize("fault", ["density", "passes", "no_answer"])
def test_tenant_answer_altered(fault, monkeypatch):
    import repro_torch.stream.service as svc

    real = svc.StreamService.poll

    def broken(self, ticket):
        resp = real(self, ticket)
        if resp is None or ticket % 3:
            return resp
        if fault == "no_answer":
            return None
        value = dict(resp.value)
        if fault == "density":
            value["density"] = nudge(value["density"])
        else:
            value["passes"] += 1
        return dataclasses.replace(resp, value=value)

    monkeypatch.setattr(svc.StreamService, "poll", broken)
    result, lines = run_small("tenants-lane")
    assert not result["correct"], lines


def test_f32_bits_tells_one_ulp_apart():
    assert f32_bits(nudge(1.5)) == f32_bits(1.5) + 1
