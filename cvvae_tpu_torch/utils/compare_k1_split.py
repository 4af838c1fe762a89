"""Time K1 split across ranks (K1.partial, K1.combine) of several checkouts
on one card, in turns: one process a checkout, each importing that
checkout's ``cvvae_tpu_torch`` and building its kernels.

    python -m cvvae_tpu_torch.utils.compare_k1_split \\
        --roots OLD NEW NEW OLD [--reps 20]

Each process times both entries on one H half of each of ``SHAPES`` (the
v1 encoder's level-0 norm, the encoder's mid-block per-frame norm and the
decoder tiles'), in bf16 and fp32, on that checkout's
``chip_smoke.k1_inputs``, the combination on the half's moments stacked
twice: CUDA-event ms (``chip_smoke.time_ms``: what the caller waits, the
host's work before the launch included), the device time of its kernels
by name (``torch.profiler`` over ``--reps`` calls, taken after every other
reading; ``total`` is the entry's) and the host time to enqueue a call
(wall time of ``--reps`` calls without a synchronise).  It runs on
``compare_k2_bwd.compare``.

Give the checkouts as A B B A so that a drift of the card's clock falls on
both alike.  Needs a CUDA card and nvcc.
"""

from __future__ import annotations

import sys

from cvvae_tpu_torch.utils.compare_k2_bwd import TIMING, compare

#: (shape, silu, per_frame) split over two H halves, each entry timed on
#: the first: the v1 encoder's level-0 norm and the per-frame norms of its
#: mid-block and of the decoder tiles
SHAPES = [((1, 17, 720, 1280, 128), True, False),
          ((1, 5, 90, 160, 512), False, True),
          ((1, 5, 90, 84, 512), False, True)]

_CHILD = ('LAUNCHES = ("gn_stats", "gn_partial", "gn_combine", "gn_apply")\n'
          f"SHAPES = {SHAPES!r}\n" + TIMING + r"""
from cvvae_tpu_torch.ops.kernels import groupnorm as gn


def calls(shape, silu, per_frame, dtype):
    x, w, b = chip_smoke.k1_inputs(shape, dev, dtype)
    half = x.split(shape[2] // 2, dim=2)[0].contiguous()
    moments = torch.stack([gn.partial_moments(half, 32, per_frame)] * 2)
    kw = dict(num_groups=32, eps=1e-6, silu=silu, per_frame=per_frame)
    return tuple(half.shape), {
        "partial": lambda: gn.partial_moments(half, 32, per_frame),
        "combine": lambda: gn.combine(half, w, b, moments, **kw)}


# CUDA events and host times of every case first, the profiles last, so
# that the profiler cannot slow the host's side of the other readings
rows = []
for shape, silu, per_frame in SHAPES:
    for dtype in ("bfloat16", "float32"):
        half, fns = calls(shape, silu, per_frame, getattr(torch, dtype))
        for entry, fn in fns.items():
            rows.append(dict(entry=entry, shape=list(half), dtype=dtype,
                             case=[list(shape), silu, per_frame],
                             ms=chip_smoke.time_ms(fn, reps),
                             host_ms=host_ms(fn)))
        del fns
        torch.cuda.empty_cache()
for row in rows:
    shape, silu, per_frame = row["case"]
    fn = calls(tuple(shape), silu, per_frame,
               getattr(torch, row["dtype"]))[1][row["entry"]]
    row["device_ms"] = device_ms(fn)
    print(json.dumps(dict(module=gn.__file__, **row)), flush=True)
    del fn
    torch.cuda.empty_cache()
""")


def main(argv=None) -> int:
    return compare(_CHILD, lambda row: (
        f"K1.{row['entry']} {tuple(row['shape'])} {row['dtype']}"), __doc__,
        argv)


if __name__ == "__main__":
    sys.exit(main())
