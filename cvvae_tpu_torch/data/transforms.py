"""Spatial transforms for the data pipeline (numpy/cv2, host-side).

Port of ``cvvae_tpu/data/transforms.py`` (framework-free, copied), which
mirrors lvdm/data/transform.py: CoverResize (scale-to-cover then crop,
:14-63), the webvid spatial transform (resize shorter-side-to-512 then
256 crop, :66-86), and the image transform (:112-121).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def _resize(frames: np.ndarray, height: int, width: int) -> np.ndarray:
    import cv2
    if frames.ndim == 3:
        return cv2.resize(frames, (width, height), interpolation=cv2.INTER_LINEAR)
    return np.stack([cv2.resize(f, (width, height),
                                interpolation=cv2.INTER_LINEAR)
                     for f in frames])


def cover_resize(frames: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """Scale so the target is covered, then center-crop to `size` (h, w).

    Ref: lvdm/data/transform.py:14-63.  frames: (..., H, W, C) uint8.
    """
    th, tw = size
    h, w = frames.shape[-3], frames.shape[-2]
    scale = max(th / h, tw / w)
    nh, nw = int(round(h * scale)), int(round(w * scale))
    frames = _resize(frames, nh, nw)
    top = (nh - th) // 2
    left = (nw - tw) // 2
    return frames[..., top:top + th, left:left + tw, :]


def resize_shorter_side(frames: np.ndarray, size: int) -> np.ndarray:
    h, w = frames.shape[-3], frames.shape[-2]
    if h <= w:
        nh, nw = size, int(round(w * size / h))
    else:
        nh, nw = int(round(h * size / w)), size
    return _resize(frames, nh, nw)


def crop(frames: np.ndarray, size: int, rng: Optional[np.random.Generator]
         ) -> np.ndarray:
    """Random crop when rng given, else center crop."""
    h, w = frames.shape[-3], frames.shape[-2]
    if rng is None:
        top, left = (h - size) // 2, (w - size) // 2
    else:
        top = int(rng.integers(0, h - size + 1))
        left = int(rng.integers(0, w - size + 1))
    return frames[..., top:top + size, left:left + size, :]


def webvid_spatial_transform(frames: np.ndarray, resize: int = 512,
                             crop_size: int = 256,
                             rng: Optional[np.random.Generator] = None
                             ) -> np.ndarray:
    """Resize shorter side to `resize`, then (random) crop `crop_size`.
    Ref: lvdm/data/transform.py:66-86."""
    frames = resize_shorter_side(frames, resize)
    return crop(frames, crop_size, rng)


def normalize_to_pm1(frames: np.ndarray) -> np.ndarray:
    """uint8 -> float32 in [-1, 1]  ((f/255 - 0.5) * 2, decoder.py:109)."""
    return (frames.astype(np.float32) / 255.0 - 0.5) * 2.0
