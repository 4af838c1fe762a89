"""Ops: device ms a request in cuDNN's convolution kernels (the group
"cuDNN convs" of ``benchmark/work.GROUPS``)."""


def read(tr):
    s = tr.groups.get("cuDNN convs")
    return None if not s else 1e3 * s / tr.requests
