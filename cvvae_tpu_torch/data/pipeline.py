"""Host-side prefetching — ``prefetched`` of ``cvvae_tpu/data/pipeline.py``
(:271-296), the one piece of the data pipeline the streaming path needs.
"""

from __future__ import annotations

from typing import Iterable, Iterator


class _PipelineError:
    def __init__(self, exn):
        self.exn = exn


def prefetched(it: Iterable, size: int = 4) -> Iterator:
    """Run the upstream pipeline in a daemon thread with a bounded
    queue, so host-side IO (reads, decode, collation) overlaps the
    consumer's device step (DataLoader prefetching semantics).  An
    exception upstream is raised in the consumer."""
    import queue
    import threading

    q: "queue.Queue" = queue.Queue(maxsize=size)
    _end = object()

    def worker():
        try:
            for item in it:
                q.put(item)
            q.put(_end)
        except BaseException as exn:  # re-raised in the consumer
            q.put(_PipelineError(exn))

    threading.Thread(target=worker, daemon=True).start()
    while True:
        item = q.get()
        if item is _end:
            return
        if isinstance(item, _PipelineError):
            raise item.exn
        yield item
