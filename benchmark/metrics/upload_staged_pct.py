"""HTTP front: the share of the traced requests whose upload the port's
``VAEWorker`` staged while another request held it (the request records'
``staged``), read as ``queue_wait_ms`` reads the records; a port whose
records have no such field gives None."""

from benchmark.metrics.queue_wait_ms import traced_records


def read(tr):
    recs = traced_records()
    if not recs or not all(hasattr(r, "staged") for r in recs):
        return None
    return 100.0 * sum(r.staged for r in recs) / len(recs)
