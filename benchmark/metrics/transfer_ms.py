"""HTTP front: the mean host ms a request spent in the worker's upload
and download spans (the uint8 clip and the latent up, the latent and the
frames down), from the port's request records."""

from benchmark.metrics.queue_wait_ms import traced_records


def read(tr):
    recs = traced_records()
    if not recs:
        return None
    return 1e3 * sum(r.upload_s + r.download_s for r in recs) / len(recs)
