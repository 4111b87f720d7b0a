"""The statistic the tail metrics take: a nearest-rank percentile over
every sample."""
from __future__ import annotations

import math


def percentile(values, q: float) -> float:
    """The nearest-rank q-th percentile (0 < q <= 100) of every value: the
    smallest value that at least q% of the values do not exceed."""
    xs = sorted(values)
    if not xs:
        raise ValueError("no values")
    return xs[max(math.ceil(q / 100.0 * len(xs)), 1) - 1]

