"""Shared summary statistics: percentiles and medians for latency samples.

The port's copy of the JAX package's ``stats.py``: the load generator's
per-tenant TTFT/TPOT/E2E p50/p90/p99 report
(``distributed_llama_tpu_torch/loadgen``) calls these, so "p99" means the
same estimator in both packages. Pure stdlib, no numpy — loadgen's report
path must stay importable in a client-only process.

Estimator: linear interpolation between closest ranks (the numpy default,
``q/100 * (n-1)`` fractional index). For odd-length inputs the median is
exactly the middle order statistic (``sorted(xs)[n // 2]``).
"""

from __future__ import annotations

import math
from typing import Callable, Iterable, Sequence, TypeVar

T = TypeVar("T")

# the percentiles every summary() reports — the serving-latency contract
# (docs/SERVING.md): median, common-case tail, SLO tail
SUMMARY_PERCENTILES = (50.0, 90.0, 99.0)


def percentile(values: Iterable[float], q: float) -> float:
    """The ``q``-th percentile (0..100) by linear interpolation between
    closest ranks. Raises on an empty input — a missing sample set must
    surface as an error at the call site, not as a silent 0 that reads
    like a great latency."""
    xs = sorted(float(v) for v in values)
    if not xs:
        raise ValueError("percentile() of an empty sample set")
    if not 0.0 <= q <= 100.0:
        raise ValueError(f"percentile q must be in [0, 100], got {q}")
    idx = (q / 100.0) * (len(xs) - 1)
    lo = math.floor(idx)
    hi = math.ceil(idx)
    if lo == hi:
        return xs[lo]
    frac = idx - lo
    return xs[lo] * (1.0 - frac) + xs[hi] * frac


def median(values: Iterable[float]) -> float:
    """Median by :func:`percentile`; for odd N this is exactly the middle
    order statistic (``sorted(xs)[n // 2]``)."""
    return percentile(values, 50.0)


def median_by(items: Sequence[T], key: Callable[[T], float]) -> T:
    """The ITEM whose key is the lower-median order statistic — for
    median-of-N over structured results (bench round dicts) where the
    caller needs the whole record, not an interpolated scalar."""
    if not items:
        raise ValueError("median_by() of an empty sequence")
    ranked = sorted(items, key=key)
    return ranked[(len(ranked) - 1) // 2]


def summarize(values: Iterable[float], unit: str = "") -> dict:
    """p50/p90/p99 + count/mean/min/max of a sample set, as the plain dict
    shape the loadgen report embeds (``{"n": ..., "mean": ..., "p50": ...,
    "p90": ..., "p99": ..., "min": ..., "max": ...}``). Empty input returns
    ``{"n": 0}`` — an absent percentile is distinguishable from a zero one."""
    xs = sorted(float(v) for v in values)
    if not xs:
        return {"n": 0}
    out: dict = {
        "n": len(xs),
        "mean": round(sum(xs) / len(xs), 3),
        "min": round(xs[0], 3),
        "max": round(xs[-1], 3),
    }
    for q in SUMMARY_PERCENTILES:
        out[f"p{int(q)}"] = round(percentile(xs, q), 3)
    if unit:
        out["unit"] = unit
    return out
