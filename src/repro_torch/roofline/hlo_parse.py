"""Parse collective traffic out of (optimized, SPMD-partitioned) HLO text.

``cost_analysis()`` does not report collective bytes, so we regex the HLO:
every all-gather / all-reduce / reduce-scatter / all-to-all /
collective-permute op contributes its tensor bytes, converted to
*per-chip link traffic* with the standard ring factors:

    all-reduce:      2 (N-1)/N x bytes    (reduce-scatter + all-gather)
    all-gather:        (N-1)/N x bytes    (bytes = full output)
    reduce-scatter:    (N-1)/N x bytes    (bytes = full input ~ out x N)
    all-to-all:        (N-1)/N x bytes
    collective-permute:          bytes
"""
from __future__ import annotations

import re
from collections import defaultdict
from typing import Dict, List, Tuple

_DTYPE_BYTES = {
    "f64": 8, "f32": 4, "bf16": 2, "f16": 2, "f8e4m3": 1, "f8e5m2": 1,
    "s64": 8, "u64": 8, "s32": 4, "u32": 4, "s16": 2, "u16": 2,
    "s8": 1, "u8": 1, "pred": 1,
}

_COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
                "collective-permute")

# e.g.:  %all-reduce.7 = bf16[16,2048]{1,0} all-reduce(%x), replica_groups=
_OP_RE = re.compile(
    r"=\s*(?:\(([^)]*)\)|(\w+)\[([\d,]*)\][^ ]*)\s+"
    r"(all-reduce|all-gather|reduce-scatter|all-to-all|collective-permute)"
    r"(?:-start)?\(")
_TUPLE_ELEM_RE = re.compile(r"(\w+)\[([\d,]*)\]")
_GROUP_RE = re.compile(r"replica_groups=\{?\{([\d,]+)\}")
_GROUP_V2_RE = re.compile(r"replica_groups=\[(\d+),(\d+)\]")


def _shape_bytes(dtype: str, dims: str) -> int:
    size = _DTYPE_BYTES.get(dtype, 4)
    if dims.strip() == "":
        return size
    n = 1
    for d in dims.split(","):
        if d:
            n *= int(d)
    return n * size


def parse_collectives(hlo_text: str) -> List[Dict]:
    """Returns one record per collective op: kind, bytes, group size."""
    out: List[Dict] = []
    for line in hlo_text.splitlines():
        if not any(c in line for c in _COLLECTIVES):
            continue
        m = _OP_RE.search(line)
        if not m:
            continue
        tuple_body, dtype, dims, kind = m.groups()
        if tuple_body is not None:
            nbytes = sum(_shape_bytes(dt, dm)
                         for dt, dm in _TUPLE_ELEM_RE.findall(tuple_body))
        else:
            nbytes = _shape_bytes(dtype, dims)
        g = _GROUP_RE.search(line)
        if g:
            group = len(g.group(1).split(","))
        else:
            g2 = _GROUP_V2_RE.search(line)
            group = int(g2.group(2)) if g2 else 1
        out.append({"kind": kind, "bytes": int(nbytes),
                    "group": max(group, 1)})
    return out


def link_traffic_bytes(records: List[Dict]) -> Tuple[float, Dict[str,
                                                                  float]]:
    """Per-chip link traffic with ring factors; returns (total, by_kind)."""
    by_kind: Dict[str, float] = defaultdict(float)
    for r in records:
        n = r["group"]
        fac = (n - 1) / n if n > 1 else 0.0
        b = r["bytes"]
        if r["kind"] == "all-reduce":
            t = 2.0 * fac * b
        elif r["kind"] == "all-gather":
            t = fac * b                      # bytes = full output
        elif r["kind"] == "reduce-scatter":
            t = fac * b                      # bytes = full input
        elif r["kind"] == "all-to-all":
            t = fac * b
        else:                                # collective-permute
            t = float(b)
        by_kind[r["kind"]] += t
    return sum(by_kind.values()), dict(by_kind)
