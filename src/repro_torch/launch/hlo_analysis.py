"""Parse collective traffic out of compiled (post-SPMD) HLO text.

``compiled.cost_analysis()`` has no collective accounting, so the roofline's
collective term comes from here: every all-gather / all-reduce /
reduce-scatter / all-to-all / collective-permute op's tensor bytes, summed
per kind. Bytes counted are the op's *output* shape per device (the payload
a device injects into the interconnect once per op; ring/tree factors are
schedule-dependent and deliberately excluded — documented in
EXPERIMENTS.md §Roofline methodology).

The JAX package's ``launch/hlo_analysis.py``, copied (it imports only ``re``
and ``collections``). Nothing in this package produces HLO text: the port's
dry run (``launch/dryrun.py``) counts its collectives at the collective
sites (``core.collective.traffic``), in the same kinds and by the same
convention. The parser stays so that a reader can hold the two dry runs'
files side by side on one program's HLO.
"""
from __future__ import annotations

import re
from collections import defaultdict

_DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2, "f16": 2, "bf16": 2,
    "s32": 4, "u32": 4, "f32": 4, "s64": 8, "u64": 8, "f64": 8, "c64": 8,
    "c128": 16,
}

_COLL_RE = re.compile(
    r"=\s+((?:\([^)]*\)|\S+))\s+"
    r"(all-reduce|all-gather|reduce-scatter|all-to-all|collective-permute)"
    r"(?:-start|-done)?\(")

_SHAPE_RE = re.compile(r"(pred|s8|u8|s16|u16|f16|bf16|s32|u32|f32|s64|u64|f64|c64|c128)"
                       r"\[([0-9,]*)\]")


def _shape_bytes(shape_str: str) -> int:
    total = 0
    for dtype, dims in _SHAPE_RE.findall(shape_str):
        n = 1
        if dims:
            for d in dims.split(","):
                n *= int(d)
        total += n * _DTYPE_BYTES[dtype]
    return total


def collective_stats(hlo_text: str) -> dict:
    """Returns {kind: {'count': int, 'bytes': int}, 'total_bytes': int}."""
    out: dict = defaultdict(lambda: {"count": 0, "bytes": 0})
    for m in _COLL_RE.finditer(hlo_text):
        shape_str, kind = m.group(1), m.group(2)
        # async pairs appear as -start/-done; count each op once (the -start)
        if "-done(" in m.group(0):
            continue
        b = _shape_bytes(shape_str)
        out[kind]["count"] += 1
        out[kind]["bytes"] += b
    total = sum(v["bytes"] for v in out.values())
    result = {k: dict(v) for k, v in out.items()}
    result["total_bytes"] = total
    return result


def count_op(hlo_text: str, opname: str) -> int:
    return len(re.findall(rf"\b{re.escape(opname)}\(", hlo_text))


# ---------------------------------------------------------------------------
# loop-aware accounting: XLA counts a while body ONCE; collectives inside the
# layer/microbatch scans execute trip_count times. We recover trip counts
# from the loop condition (compare against a constant) and multiply.
# ---------------------------------------------------------------------------
_COMP_RE = re.compile(r"^(%?[\w\.\-]+)\s*(?:\([^)]*\))?\s*->.*?\{", re.M)


def _split_computations(hlo_text: str) -> dict[str, str]:
    """computation name -> body text (best-effort brace matching)."""
    comps = {}
    lines = hlo_text.splitlines()
    name, buf, depth = None, [], 0
    for ln in lines:
        if name is None:
            m = re.match(r"\s*(ENTRY\s+)?%?([\w\.\-]+)\s*(?:\([^)]*\))?.*\{\s*$", ln)
            if m and ("->" in ln or "ENTRY" in ln):
                name = m.group(2)
                buf = [ln]
                depth = ln.count("{") - ln.count("}")
                continue
        else:
            buf.append(ln)
            depth += ln.count("{") - ln.count("}")
            if depth <= 0:
                comps[name] = "\n".join(buf)
                name = None
    return comps


def _trip_count(cond_text: str) -> int:
    """Scan loops compare the induction var to a constant bound. The compare
    is usually wrapped in a fusion, so take the largest scalar s32 constant
    defined in the condition computation (the loop bound; increments are 1)."""
    consts = [int(m.group(1)) for m in re.finditer(
        r"=\s*s(?:32|64)\[\]\s*constant\((\d+)\)", cond_text)]
    return max(consts) if consts else 1


def collective_stats_looped(hlo_text: str) -> dict:
    """Like collective_stats but multiplies while-body collectives by the
    loop trip count (handles one level of nesting via recursion)."""
    comps = _split_computations(hlo_text)
    # map body computation -> trip count
    body_trips: dict[str, int] = {}
    for cname, ctext in comps.items():
        for m in re.finditer(
                r"while\([^)]*\), condition=%?([\w\.\-]+), body=%?([\w\.\-]+)",
                ctext):
            cond, body = m.group(1), m.group(2)
            body_trips[body] = _trip_count(comps.get(cond, ""))

    def direct(ctext: str) -> dict:
        out = defaultdict(lambda: {"count": 0, "bytes": 0})
        for m in _COLL_RE.finditer(ctext):
            if "-done(" in m.group(0):
                continue
            b = _shape_bytes(m.group(1))
            out[m.group(2)]["count"] += 1
            out[m.group(2)]["bytes"] += b
        return out

    def total(cname: str, seen: frozenset) -> dict:
        if cname in seen:
            return {}
        ctext = comps.get(cname, "")
        agg = {k: dict(v) for k, v in direct(ctext).items()}
        # nested whiles called from this computation
        for m in re.finditer(
                r"while\([^)]*\), condition=%?[\w\.\-]+, body=%?([\w\.\-]+)",
                ctext):
            body = m.group(1)
            trips = body_trips.get(body, 1)
            sub = total(body, seen | {cname})
            for k, v in sub.items():
                cur = agg.setdefault(k, {"count": 0, "bytes": 0})
                cur["count"] += v["count"] * trips
                cur["bytes"] += v["bytes"] * trips
        return agg

    entry = next((n for n, t in comps.items() if "ENTRY" in t.split("\n")[0]),
                 None)
    if entry is None:
        return collective_stats(hlo_text)
    agg = total(entry, frozenset())
    agg["total_bytes"] = sum(v["bytes"] for k, v in agg.items()
                             if isinstance(v, dict))
    return agg


__all__ = ["collective_stats", "collective_stats_looped", "count_op"]
