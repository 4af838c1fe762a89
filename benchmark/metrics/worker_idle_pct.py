"""HTTP front: the share of the traced window in which the port's
``VAEWorker`` held no request (its ``stats["busy_s"]`` read at the
window's ends)."""


def read(tr):
    if tr.host_window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.worker_busy_s / tr.host_window_s)
