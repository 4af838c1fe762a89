"""Time K3.bwd of several checkouts on one card, in turns: one process a
checkout, each importing that checkout's ``cvvae_tpu_torch`` and building
its kernels.

    python -m cvvae_tpu_torch.utils.compare_k3_bwd \\
        --roots OLD NEW NEW OLD [--reps 20]

Each process times ``stem_conv3d_backward`` at that checkout's
``chip_smoke.K3_BWD_SHAPES`` (Cin 3, causal edge time), in fp32 and bf16,
on that checkout's ``chip_smoke.k3_inputs`` and seeded N(0, 1) ``dy``:
CUDA-event ms (``chip_smoke.time_ms``: what the caller waits, host time
included), the device time of its kernels by launch (``torch.profiler``
over ``--reps`` calls, taken after every other reading; ``stem_bwd_`` is
the partial sums, whatever the checkout names that kernel, and
``stem_bwd_merge`` the merge of the slots) and the host time to enqueue it
(wall time of ``--reps`` calls without a synchronise).  It runs on
``compare_k2_bwd.compare``.

Give the checkouts as A B B A so that a drift of the card's clock falls on
both alike.  Needs a CUDA card and nvcc.
"""

from __future__ import annotations

import sys

from cvvae_tpu_torch.utils.compare_k2_bwd import TIMING, compare

_CHILD = 'LAUNCHES = ("stem_bwd_merge", "stem_bwd_")\n' + TIMING + r"""
from cvvae_tpu_torch.ops.kernels import stem

spec = chip_smoke.k3_spec("edge")


def call(shape, dtype):
    x = chip_smoke.k3_inputs(shape, 3, dev, dtype)[0]
    dy = chip_smoke.randn(tuple(shape) + (stem.COUT,), 33, dev, dtype)
    return lambda: stem.stem_conv3d_backward(x, dy, spec)


# CUDA events and host times of every case first, the profiles last, so
# that the profiler cannot slow the host's side of the other readings
rows = []
for where, shape in chip_smoke.K3_BWD_SHAPES:
    for dtype in ("float32", "bfloat16"):
        fn = call(shape, getattr(torch, dtype))
        rows.append(dict(where=where, shape=list(shape), dtype=dtype,
                         ms=chip_smoke.time_ms(fn, reps),
                         host_ms=host_ms(fn)))
        del fn
        torch.cuda.empty_cache()
for row in rows:
    row["device_ms"] = device_ms(call(tuple(row["shape"]),
                                      getattr(torch, row["dtype"])))
    print(json.dumps(dict(module=stem.__file__, **row)), flush=True)
    torch.cuda.empty_cache()
"""


def main(argv=None) -> int:
    return compare(_CHILD, lambda row: f"{tuple(row['shape'])} {row['dtype']}",
                   __doc__, argv)


if __name__ == "__main__":
    sys.exit(main())
