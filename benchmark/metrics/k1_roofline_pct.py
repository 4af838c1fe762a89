"""Kernels: the least time of a request's GroupNorm(+SiLU) calls at the
card's bandwidth (``benchmark/work.py``, from the shapes K1 was called
with) over K1's device time, in %."""

from benchmark import work


def read(tr):
    calls = [c for c in tr.calls if c[0] == "K1"]
    spent = tr.groups.get("K1 GroupNorm+SiLU", 0.0)
    if not calls or not spent:
        return None
    least = sum(work.bound_s(key, shape, dtype, **kw)
                for key, shape, dtype, kw in calls)
    return 100.0 * least / spent
