"""JAX params tree -> the port's ``state_dict``.

The inverse of ``cvvae_tpu/utils/convert.py:59-78``.  The port's module
paths follow the JAX params tree, so conversion is a path join plus a
per-tensor layout change:

* a conv kernel (kT, kH, kW, I, O)       -> weight (O, I, kT, kH, kW)
  (a per-frame kernel (1, kH, kW, I, O)  -> a Conv3d weight (O, I, 1, kH, kW))
* a dense kernel (I, O)                  -> weight (O, I)
* a norm's scale / bias                  -> its weight / bias

Load the result with ``load_state_dict(..., strict=True)`` so that a key
missed on either side fails.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def _convert_leaf(leaf: str, value: np.ndarray):
    if leaf == "scale":
        return "weight", value
    if leaf == "kernel":
        if value.ndim == 5:
            return "weight", value.transpose(4, 3, 0, 1, 2)
        if value.ndim == 2:
            return "weight", value.T
        raise ValueError(f"kernel of rank {value.ndim} has no counterpart")
    if leaf == "bias":
        return "bias", value
    raise ValueError(f"unexpected leaf {leaf!r}")


def from_jax_params(params: dict) -> Dict[str, torch.Tensor]:
    """{"encoder": ..., "decoder": ...} of array-likes -> state_dict."""
    out: Dict[str, torch.Tensor] = {}

    def visit(node, path):
        if isinstance(node, dict):
            items = node.items()
        elif isinstance(node, (list, tuple)):
            items = enumerate(node)
        else:
            name, value = _convert_leaf(path[-1], np.asarray(node))
            key = ".".join(path[:-1] + [name])
            out[key] = torch.from_numpy(np.array(value, order="C"))
            return
        for k, v in items:
            visit(v, path + [str(k)])

    visit(params, [])
    return out
