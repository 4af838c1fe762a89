"""Sample decoders: bytes/metadata -> training dicts.

Port of ``cvvae_tpu/data/decoders.py`` (framework-free, copied), which
mirrors lvdm/data/decoder.py:

* ``webvid_decoder``       — video file -> `num_frames` clip with random
  temporal stride in [1, 8], random start, [-1, 1] floats, plus the SVD
  conditioning keys (fps_id, motion_bucket_id, cond_frames w/ log-normal
  noise, ...)  [decoder.py:17-146]
* ``webdata_image_decoder`` — jpg bytes -> transformed single frame with
  a time axis [decoder.py:177-207]
* ``webdata_video_decoder`` — mp4 bytes from a tar -> clip via tempfile
  [decoder.py:210-308]

Video decode uses cv2 (decord is not in this image).  Output layout is
channels-last (T, H, W, C) — the framework's native layout; the
reference's CTHW contract is one transpose away.
"""

from __future__ import annotations

import os
import tempfile
from typing import Dict, Optional, Tuple

import numpy as np

from cvvae_tpu_torch.data.transforms import normalize_to_pm1, webvid_spatial_transform


def _decode_video_frames(path: str, num_frames: int, stride: int,
                         rng: np.random.Generator) -> Optional[np.ndarray]:
    import cv2
    cap = cv2.VideoCapture(path)
    if not cap.isOpened():
        raise IOError(f"cannot open video {path}")
    total = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
    span = (num_frames - 1) * stride + 1
    if total < span:
        stride = max(1, (total - 1) // max(1, num_frames - 1))
        span = (num_frames - 1) * stride + 1
        if total < span:
            cap.release()
            return None
    start = int(rng.integers(0, total - span + 1))
    wanted = set(start + i * stride for i in range(num_frames))
    frames = []
    idx = 0
    last = max(wanted)
    while idx <= last:
        ok, frame = cap.read()
        if not ok:
            break
        if idx in wanted:
            frames.append(cv2.cvtColor(frame, cv2.COLOR_BGR2RGB))
        idx += 1
    cap.release()
    if len(frames) != num_frames:
        return None
    return np.stack(frames)


def make_webvid_decoder(*, num_frames: int = 17,
                        stride_range: Tuple[int, int] = (1, 8),
                        resize: int = 512, crop_size: int = 256,
                        video_root: str = "", path_key: str = "path",
                        caption_key: str = "name",
                        cond_noise_std_range: Tuple[float, float] = (-3.0, 0.5),
                        seed: int = 0):
    """Decoder for csv metadata rows -> {'frames', 'caption', SVD keys}.

    Ref: lvdm/data/decoder.py:17-146 — random stride in [1,8] (:71),
    random clip start (:86-91), (f/255-0.5)*2 (:109), log-normal
    conditioning noise on cond_frames (:111-117).
    """
    rng = np.random.default_rng(seed)

    def decode(row: Dict) -> Optional[Dict]:
        path = os.path.join(video_root, row[path_key])
        stride = int(rng.integers(stride_range[0], stride_range[1] + 1))
        frames = _decode_video_frames(path, num_frames, stride, rng)
        if frames is None:
            return None
        frames = webvid_spatial_transform(frames, resize, crop_size, rng)
        frames = normalize_to_pm1(frames)
        cond_sigma = float(np.exp(rng.normal(
            loc=(cond_noise_std_range[0] + cond_noise_std_range[1]) / 2,
            scale=(cond_noise_std_range[1] - cond_noise_std_range[0]) / 4)))
        cond = frames[:1] + cond_sigma * rng.standard_normal(
            frames[:1].shape).astype(np.float32)
        return {
            "frames": frames,                      # (T, H, W, C)
            "caption": row.get(caption_key, ""),
            "fps_id": np.asarray(6, np.int64),
            "motion_bucket_id": np.asarray(127, np.int64),
            "cond_frames_without_noise": frames[:1],
            "cond_frames": cond,
            "cond_aug": np.asarray(cond_sigma, np.float32),
            "num_video_frames": num_frames,
            "image_only_indicator": np.zeros((num_frames,), np.float32),
        }

    return decode


def make_image_decoder(*, size: int = 320, image_key: str = "jpg",
                       caption_key: str = "txt", seed: int = 0):
    """Decoder for webdataset image samples -> single-frame video dict.
    Ref: lvdm/data/decoder.py:177-207 (adds the time axis at :194-196)."""
    import cv2
    rng = np.random.default_rng(seed)

    def decode(sample: Dict) -> Optional[Dict]:
        data = sample.get(image_key) or sample.get("jpeg") or sample.get("png")
        if data is None:
            return None
        buf = np.frombuffer(data, np.uint8)
        img = cv2.imdecode(buf, cv2.IMREAD_COLOR)
        if img is None:
            return None
        img = cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
        img = webvid_spatial_transform(img, size, size, rng)
        img = normalize_to_pm1(img)
        caption = sample.get(caption_key, b"")
        if isinstance(caption, bytes):
            caption = caption.decode("utf-8", "replace")
        return {"frames": img[None], "caption": caption}  # (1, H, W, C)

    return decode


def make_tar_video_decoder(*, num_frames: int = 17,
                           stride_range: Tuple[int, int] = (1, 8),
                           resize: int = 512, crop_size: int = 256,
                           video_key: str = "mp4", seed: int = 0):
    """Decoder for mp4 bytes inside tars — write to a tempfile then use
    the regular reader (decoder.py:210-308 uses the same trick)."""
    rng = np.random.default_rng(seed)

    def decode(sample: Dict) -> Optional[Dict]:
        data = sample.get(video_key)
        if data is None:
            return None
        with tempfile.NamedTemporaryFile(suffix=".mp4", delete=False) as f:
            f.write(data)
            path = f.name
        try:
            stride = int(rng.integers(stride_range[0], stride_range[1] + 1))
            frames = _decode_video_frames(path, num_frames, stride, rng)
        finally:
            os.unlink(path)
        if frames is None:
            return None
        frames = webvid_spatial_transform(frames, resize, crop_size, rng)
        return {"frames": normalize_to_pm1(frames),
                "caption": (sample.get("txt", b"") or b"").decode(
                    "utf-8", "replace")}

    return decode
