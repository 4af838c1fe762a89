"""Video read/write on the host (OpenCV backend, imported at first use).

Port of ``cvvae_tpu/data/video_io.py``.  Frames are RGB uint8;
``normalize`` maps to [-1, 1] via x/127.5 - 1.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def read_video(path: str, *, height: Optional[int] = None,
               width: Optional[int] = None,
               max_frames: Optional[int] = None) -> Tuple[np.ndarray, float]:
    """Read an mp4 -> (frames (T,H,W,3) RGB uint8, fps)."""
    import cv2
    cap = cv2.VideoCapture(path)
    if not cap.isOpened():
        raise FileNotFoundError(path)
    fps = cap.get(cv2.CAP_PROP_FPS) or 30.0
    frames = []
    try:
        while True:
            ok, frame = cap.read()
            if not ok:
                break
            if height is not None and width is not None:
                frame = cv2.resize(frame, (width, height),
                                   interpolation=cv2.INTER_LINEAR)
            frames.append(cv2.cvtColor(frame, cv2.COLOR_BGR2RGB))
            if max_frames is not None and len(frames) >= max_frames:
                break
    finally:
        cap.release()
    if not frames:
        raise ValueError(f"no frames decoded from {path}")
    return np.stack(frames), float(fps)


def write_video(path: str, frames: np.ndarray, fps: float = 30.0) -> None:
    """Write (T,H,W,3) RGB uint8 frames to an mp4."""
    import cv2
    t, h, w, _ = frames.shape
    out = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h))
    if not out.isOpened():
        raise IOError(f"cannot open video writer for {path}")
    try:
        for i in range(t):
            out.write(cv2.cvtColor(frames[i], cv2.COLOR_RGB2BGR))
    finally:
        out.release()


def truncate_to_4k1(num_frames: int) -> int:
    """The input frame contract T -> 4k+1."""
    return 1 + (num_frames - 1) // 4 * 4


def normalize(frames: np.ndarray) -> np.ndarray:
    """uint8 RGB -> float32 in [-1, 1]."""
    return frames.astype(np.float32) / 127.5 - 1.0


def denormalize(frames: np.ndarray) -> np.ndarray:
    """[-1, 1] float -> uint8 RGB."""
    return np.clip((frames + 1.0) * 127.5, 0, 255).astype(np.uint8)
