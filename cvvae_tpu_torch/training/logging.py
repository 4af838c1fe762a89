"""Metrics + image logging.

Port of ``cvvae_tpu/training/logging.py`` (framework-free), replacing
the reference's WandB(offline)/CSVLogger (main.py:673-714),
LearningRateMonitor (main.py:778-784) and ImageLogger (main.py:310-478):

* ``MetricsLogger`` — per-step scalars to CSV (one row per step, union
  of keys) and stdout; wandb used when importable (never required).
* ``ImageLogger``   — inputs / reconstructions / diff / diff_boost
  panels, with the reference's log-scale early cadence (main.py:330:
  also log at powers of two below the interval) and diff_boost_factor 3
  (lvdm/models/autoencoder.py diff panels, :1157-1219).
"""

from __future__ import annotations

import csv
import os
import time
from typing import Dict, Optional

import numpy as np


class MetricsLogger:
    def __init__(self, logdir: str, name: str = "metrics",
                 print_every: int = 50):
        os.makedirs(logdir, exist_ok=True)
        self.path = os.path.join(logdir, f"{name}.csv")
        self.print_every = print_every
        self._fieldnames = None
        self._file = None
        self._writer = None
        self._t0 = time.time()
        try:
            import wandb  # optional
            self._wandb = wandb if wandb.run is not None else None
        except ImportError:
            self._wandb = None

    def log(self, step: int, metrics: Dict[str, float],
            lr: Optional[float] = None) -> None:
        row = {"step": step, "wall_s": round(time.time() - self._t0, 2)}
        if lr is not None:
            row["lr"] = float(lr)
        row.update({k: float(v) for k, v in metrics.items()})
        if self._writer is None or set(row) - set(self._fieldnames):
            self._reopen(row)
        self._writer.writerow(row)
        self._file.flush()
        if self._wandb is not None:
            self._wandb.log(row, step=step)
        if self.print_every and step % self.print_every == 0:
            keys = [k for k in ("loss/total", "loss/rec", "loss/disc") if k in row]
            msg = " ".join(f"{k}={row[k]:.4f}" for k in keys)
            print(f"[step {step}] {msg}")

    def _reopen(self, row):
        old_rows = []
        if self._file is not None:
            self._file.close()
            with open(self.path) as f:
                old_rows = list(csv.DictReader(f))
        self._fieldnames = sorted(set(row) | set(self._fieldnames or []),
                                  key=lambda k: (k != "step", k))
        self._file = open(self.path, "w", newline="")
        self._writer = csv.DictWriter(self._file, fieldnames=self._fieldnames,
                                      restval="")
        self._writer.writeheader()
        for r in old_rows:
            self._writer.writerow(r)

    def close(self):
        if self._file is not None:
            self._file.close()


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def _diverging_colormap(x: np.ndarray) -> np.ndarray:
    """PiYG-style diverging map on [-1, 1] -> RGB in [0, 1]
    (negative = magenta, zero = near-white, positive = green)."""
    white = np.array([0.97, 0.97, 0.97])
    magenta = np.array([0.77, 0.11, 0.49])
    green = np.array([0.10, 0.47, 0.22])
    neg = np.clip(-x, 0.0, 1.0)[..., None]
    pos = np.clip(x, 0.0, 1.0)[..., None]
    return white + neg * (magenta - white) + pos * (green - white)


def should_log_images(step: int, every: int = 250) -> bool:
    """Reference cadence: every N steps, plus powers of two early on
    (ImageLogger.check_frequency, main.py:440-455)."""
    if every and step % every == 0:
        return True
    return step in {1, 2, 4, 8, 16, 32, 64, 128}


class ImageLogger:
    def __init__(self, logdir: str, every: int = 250,
                 diff_boost_factor: float = 3.0, max_images: int = 4):
        self.dir = os.path.join(logdir, "images")
        os.makedirs(self.dir, exist_ok=True)
        self.every = every
        self.diff_boost_factor = diff_boost_factor
        self.max_images = max_images

    def maybe_log(self, step: int, inputs: np.ndarray,
                  recons: np.ndarray, split: str = "train") -> Optional[str]:
        """inputs/recons: (B, T, H, W, C) in [-1, 1]."""
        if not should_log_images(step, self.every):
            return None
        return self.log(step, inputs, recons, split)

    def log(self, step: int, inputs, recons, split: str = "train",
            logits_real=None, logits_fake=None) -> str:
        """inputs/recons (B,T,H,W,C) in [-1,1]; optional patch-disc
        logit maps (B,T',H',W',1) add heatmap-overlay rows (the
        reference's log_images, discriminator_loss.py:98-209)."""
        import cv2
        x = np.asarray(inputs, np.float32)[:self.max_images]
        r = np.asarray(recons, np.float32)[:x.shape[0], :x.shape[1]]
        b, t = x.shape[:2]
        x = x.reshape((-1,) + x.shape[2:])
        r = r.reshape((-1,) + r.shape[2:])
        # panels per reference: inputs | recon | 0.5*diff | diff_boost
        diff = 0.5 * np.clip(np.abs(x - r), 0, 2)          # in [0,1]
        boost = np.clip(self.diff_boost_factor * diff, 0, 1)
        frame_rows = [0.5 * (x + 1), 0.5 * (r + 1), diff, boost]
        if logits_real is not None and logits_fake is not None:
            lr_ = np.asarray(logits_real, np.float32)[:b]
            lf_ = np.asarray(logits_fake, np.float32)[:b]
            high = max(np.abs(lr_).max(), np.abs(lf_).max(), 1e-6)
            for img, lg in ((0.5 * (x + 1), lr_), (0.5 * (r + 1), lf_)):
                lg = lg.reshape((-1,) + lg.shape[2:])[..., 0] / high
                # nearest-upsample the patch map to image resolution
                lg = np.repeat(np.repeat(
                    lg, _ceil_div(img.shape[1], lg.shape[1]), axis=1),
                    _ceil_div(img.shape[2], lg.shape[2]), axis=2)
                # logit frames may be fewer than image frames (temporal
                # downsampling in the 3D disc): tile to match
                reps = _ceil_div(img.shape[0], lg.shape[0])
                lg = np.repeat(lg, reps, axis=0)[:img.shape[0],
                                                 :img.shape[1],
                                                 :img.shape[2]]
                alpha = (0.8 * np.abs(lg))[..., None]
                frame_rows.append((1 - alpha) * img
                                  + alpha * _diverging_colormap(lg))
        rows = [np.concatenate(list(frames), axis=1)
                for frames in frame_rows]
        panel = np.clip(np.concatenate(rows, axis=0) * 255, 0, 255).astype(
            np.uint8)
        path = os.path.join(self.dir, f"{split}_step{step:08d}.png")
        cv2.imwrite(path, cv2.cvtColor(panel, cv2.COLOR_RGB2BGR))
        return path
