"""Order statistics over every sample: no sample is dropped, none is
averaged away."""
from __future__ import annotations

import math


def nearest_rank(values, q: float) -> float:
    """The ``q`` quantile by nearest rank: the ceil(q * n)-th smallest of
    all ``n`` values."""
    vals = sorted(values)
    if not vals:
        raise ValueError("no values")
    return float(vals[max(0, math.ceil(q * len(vals)) - 1)])
