"""What the metric readers share: the finished requests of a record, and a
kernel's share of its roofline from the trace."""
from __future__ import annotations

import re

from lpbench import yardstick


def finished(record: dict) -> list:
    return [r for r in record["requests"] if r["finite"]]


def mean(record: dict, key: str):
    done = finished(record)
    return sum(r[key] for r in done) / len(done) if done else None


def roofline(record: dict, pattern: str, bytes_of) -> float | None:
    """100 x (the least time of the launches the trace names by `pattern`,
    whose first group is the element type, over their device time), with
    `bytes_of(match, dtype)` the bytes of one launch; None where the trace
    holds none."""
    trace = record.get("trace")
    if not trace:
        return None
    least = spent = 0.0
    for name, launches, seconds in trace["kernels"]:
        hit = re.search(pattern, name)
        if hit:
            dtype = {"float": "f32", "double": "f64"}[hit.group(1)]
            least += launches * yardstick.bound_s(bytes_of(hit, dtype))
            spent += seconds
    return 100.0 * least / spent if spent > 0 else None
