"""Device: the share of the traced window (first to last device event
of the requests analysed) in which no kernel or copy ran on the card."""


def read(tr):
    if tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
