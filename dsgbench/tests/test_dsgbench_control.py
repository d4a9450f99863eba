"""The control — the plain reference in the program's place, computed in
bfloat16 — comes out not correct in each cell, at sizes a test run holds
(the same run at the cells' own sizes is ``dsgbench/control.py`` on the
card)."""
import copy

import pytest

from dsgbench.control import installed

import _dsgbench_small as small


@pytest.mark.parametrize("cell, patch", [
    ("g500s19-peel", {"config": {"scale": 14}}),
    ("g500s19-cbds", {"config": {"scale": 12}}),
    ("tenants-lane", {}),
])
def test_the_control_is_not_correct(cell, patch, monkeypatch):
    merged = copy.deepcopy(small.SMALL[cell])
    for key, part in patch.items():
        merged.setdefault(key, {}).update(part)
    monkeypatch.setitem(small.SMALL, cell, merged)
    with installed():
        result, lines = small.run_small(cell, seconds=0.5)
    assert not result["correct"], lines
    assert result["checks"]["wrong_answers"]["value"] > 0
