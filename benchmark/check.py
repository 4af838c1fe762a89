"""The comparison that decides ``correct``: served frames against the
plain reference's, each number beside its limit.

Numbers, in uint8 levels, the worst over the responses compared:

* ``rms_u8``: the root mean square of (served - reference) over a clip;
* ``frame_rms_u8``: the same over each frame, the worst frame.

A run is correct when it sent requests, every response was well formed,
at least one was compared, and each number is at most its limit
(``benchmark/limits/<cell>.json``; a number without a limit fails).
"""

from __future__ import annotations

import io
import json
import os

import numpy as np
import torch

NUMBERS = ("rms_u8", "frame_rms_u8")


def served(body: bytes, device) -> torch.Tensor:
    """A response's .npy frames as a uint8 tensor on ``device``."""
    arr = np.load(io.BytesIO(body), allow_pickle=False)
    return torch.from_numpy(arr).to(device)


def compare(pairs) -> dict:
    """{number: worst value} over (served, reference) uint8 (T, H, W, 3)
    pairs; a pair of different shapes reads infinity."""
    out = {n: 0.0 for n in NUMBERS}
    for got, ref in pairs:
        if tuple(got.shape) != tuple(ref.shape):
            return {n: float("inf") for n in NUMBERS}
        d2 = (got.float() - ref.float()).square_()
        per_frame = d2.mean(dim=(1, 2, 3))
        out["rms_u8"] = max(out["rms_u8"], float(per_frame.mean().sqrt()))
        out["frame_rms_u8"] = max(out["frame_rms_u8"],
                                  float(per_frame.max().sqrt()))
    return out


def load_limits(path: str) -> dict:
    if not os.path.exists(path):
        return {}
    with open(path) as f:
        return json.load(f)["limits"]


def judge(numbers: dict, limits: dict, attempted: int, failed: int,
          checked: int):
    """(correct, {name: {"value", "limit"}}): the counts first, then each
    number with its limit (None where the cell has none)."""
    judged = {"attempted": {"value": attempted, "limit": 1},
              "failed": {"value": failed, "limit": 0},
              "compared": {"value": checked, "limit": 1}}
    correct = attempted >= 1 and failed == 0 and checked >= 1
    for name in NUMBERS:
        limit = limits.get(name)
        judged[name] = {"value": numbers[name], "limit": limit}
        correct = correct and limit is not None and numbers[name] <= limit
    return correct, judged


def lines(judged: dict):
    """One line a compared number: its value beside its limit (counts
    "attempted" and "compared" at least their limit, the rest at most)."""
    for name, v in judged.items():
        yield f"check {name} {v['value']!r} limit {v['limit']!r}"
