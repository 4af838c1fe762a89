"""Model API and nets: device ms a request inside the benchmark's range
around the worker's ``vae.encode``."""

from benchmark.tracing import VAE_ENCODE


def read(tr):
    s = tr.ranges.get(VAE_ENCODE)
    return None if not s else 1e3 * s / tr.requests
