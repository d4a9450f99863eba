"""The harness finds a cell's configuration, traffic and metric files by the
names in BENCHMARK.json, refuses what it cannot find, and BENCHMARK.json
keeps to the benchmark's contract as far as a file can show it."""
import json
import re

import pytest

from dsgbench import harness

import _dsgbench_small as small

BENCH = harness.load_benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]
WITH_HELD = small.bench()   # and the cell held out of BENCHMARK.json
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.mark.parametrize("cell", [w["name"] for w in WITH_HELD["workloads"]])
def test_each_cell_finds_its_files_by_name(cell):
    entry, cfg, traffic = harness.load_inputs(WITH_HELD, cell)
    assert entry["name"] == cell
    assert cfg["kind"] in ("graph500", "tenants")
    assert traffic["kind"] in harness.DRIVERS
    for kind, entries in (("e2e", WITH_HELD["end_to_end"]),
                          ("metrics", WITH_HELD["per_layer"])):
        names = [m["name"] for m in harness.metrics_of(entries, cell)]
        assert names, f"{cell} reports no {kind} metric"
        for name in names:
            assert callable(harness.load_reader(kind, name).read)


def test_every_cell_reports_setup_an_end_to_end_metric_and_a_layer():
    for cell in CELLS:
        e2e = {m["name"] for m in harness.metrics_of(BENCH["end_to_end"], cell)}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert harness.metrics_of(BENCH["per_layer"], cell)


def test_an_unknown_cell_is_refused():
    with pytest.raises(KeyError, match="no workload"):
        harness.find_cell(BENCH, "no-such-cell")


def test_an_unknown_traffic_or_metric_is_refused():
    bench = json.loads(json.dumps(BENCH))
    bench["workloads"][0]["traffic"] = "no-such-traffic"
    with pytest.raises(FileNotFoundError, match="no-such-traffic"):
        harness.load_inputs(bench, bench["workloads"][0]["name"])
    with pytest.raises(FileNotFoundError, match="no reader"):
        harness.load_reader("metrics", "no_such_metric")
    with pytest.raises(KeyError, match="has no driver"):
        harness.load_inputs(BENCH, CELLS[0], {"traffic": {"kind": "no_such_kind"}})


def test_benchmark_json_keeps_to_the_contract():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["dsgbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    used = {w["config"] for w in BENCH["workloads"]}
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["name"] in used and NAME.match(c["name"])
        assert c["file"].startswith("dsgbench/") and (harness.ROOT / c["file"]).is_file()
        assert all(NAME.match(k) for k in c["reduced"])
        assert 1 <= len(c["source"]) <= 200 and 1 <= len(c["why"]) <= 200
    pairs = set()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert (w["config"], w["traffic"]) not in pairs and len(w["why"]) <= 200
        pairs.add((w["config"], w["traffic"]))
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names)) and "setup_s" in names
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
        for cell in m.get("workloads", CELLS):
            assert m["moves"] in {e["name"] for e in harness.metrics_of(BENCH["end_to_end"],
                                                                        cell)}
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m.get("workloads", CELLS)) <= set(CELLS)
    assert len(json.dumps(BENCH)) <= 64 * 1024


def test_the_command_names_only_files_under_paths():
    assert BENCH["command"] == ["python3", "dsgbench/run.py"]
    assert (harness.ROOT / "dsgbench" / "run.py").is_file()


def test_the_drivers_run_the_ports_kernels_and_the_fused_service(monkeypatch):
    """No configuration can switch the kernels or the fused service off."""
    import importlib

    seen = []
    for module, name in (("repro_torch.core.pbahmani", "pbahmani"),
                         ("repro_torch.stream", "StreamService")):
        mod = importlib.import_module(module)
        real = getattr(mod, name)

        def spy(*args, _real=real, _name=name, **kw):
            seen.append((_name, kw.get("kernel"), kw.get("fused", True)))
            return _real(*args, **kw)

        monkeypatch.setattr(mod, name, spy)
    for cell in ("g500s19-peel", "tenants-lane"):
        assert small.run_small(cell)[0]["correct"]
    assert {name for name, _, _ in seen} == {"pbahmani", "StreamService"}
    assert all(kernel is True and fused is True for _, kernel, fused in seen)
