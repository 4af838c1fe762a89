"""Kernels: the least time of a request's int8 convs at the card's peaks
(``benchmark/work.py``: each K5.stage and K5 GEMM call's bytes and
operations from the shapes it was called with) over the device time of
K5.gemm and K5.stage, in %."""

from benchmark import work

GROUPS = ("K5.gemm int8 GEMM", "K5.stage int8 staging")


def read(tr):
    calls = [c for c in tr.calls if c[0] in ("K5", "K5.stage")]
    spent = sum(tr.groups.get(g, 0.0) for g in GROUPS)
    if not calls or not spent:
        return None
    least = sum(work.bound_s(key, shape, dtype, **kw)
                for key, shape, dtype, kw in calls)
    return 100.0 * least / spent
