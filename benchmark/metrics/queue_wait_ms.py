"""HTTP front: the mean ms a request waited in the port's ``VAEWorker``
queue, from its submit to the worker's take (the port's request records,
``cvvae_tpu_torch/utils/spans.py``).

The records read are those the worker took while the profiler recorded,
the first left out as ``benchmark/tracing.py`` leaves it out; a port that
keeps no request records gives None.
"""


def traced_records() -> list:
    """The port's request records of the traced window, the first left
    out; [] where the port keeps none."""
    try:
        from cvvae_tpu_torch.utils import spans
    except ImportError:
        return []
    log = spans.last_log()
    if log is None:
        return []
    return [r for r in log.records() if r.profiled][1:]


def read(tr):
    recs = traced_records()
    if not recs:
        return None
    return 1e3 * sum(r.queue_s for r in recs) / len(recs)
