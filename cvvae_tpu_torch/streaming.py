"""Streaming long-video encode/decode with bounded memory — port of
``cvvae_tpu/streaming.py``.

The host reads 16+1-frame windows while the device encodes the previous
one (PyTorch launches asynchronously on the card, so compute overlaps
video IO), and only one window of pixels plus the latents not yet decoded
are resident on the device.  Chunk semantics are exactly the reference's:
consecutive windows share one frame, later windows drop their first
latent, and decode windows of ``decode_n_frames_a_time``+1 latents share
one latent and drop their first frame, so the stream gives the frames of
``VideoVAE.encode`` -> ``decode`` byte for byte.

Frames cross the host link as uint8 in both directions (1 B/px):
normalised on the device after the upload (``video_io.to_unit``) and
cast back to uint8 there before the fetch (``video_io.to_uint8``).  On
the card both copies use pinned host memory: the upload is a
non-blocking copy on the compute stream; the fetch is a copy on a side
stream into a pinned buffer, which waits on an event recorded after the
cast, and is read only after its own event completed.

Entry points: ``streaming_encode``, ``streaming_decode``,
``reconstruct_stream`` (frames in, uint8 blocks to a sink, optionally
pipelined) and ``reconstruct_video_streaming`` (the same on video files,
through OpenCV).
"""

from __future__ import annotations

import collections
from typing import Callable, Iterator, Optional, Tuple

import numpy as np
import torch

from cvvae_tpu_torch.data.video_io import to_uint8, to_unit


def _chunk_frames(frame_iter: Iterator[np.ndarray], window: int
                  ) -> Iterator[np.ndarray]:
    """Group frames into window+1-sized chunks with one-frame overlap."""
    chunk = []
    prev_last: Optional[np.ndarray] = None
    for frame in frame_iter:
        chunk.append(frame)
        if len(chunk) == (window + 1 if prev_last is None else window):
            yield np.stack(chunk if prev_last is None
                           else [prev_last] + chunk)
            prev_last = chunk[-1]
            chunk = []
    if chunk:
        yield np.stack(chunk if prev_last is None else [prev_last] + chunk)


def read_video_frames(path: str, *, height: Optional[int] = None,
                      width: Optional[int] = None,
                      max_frames: Optional[int] = None
                      ) -> Tuple[Iterator[np.ndarray], float]:
    """Lazily decode frames (RGB uint8) one at a time."""
    import cv2
    cap = cv2.VideoCapture(path)
    if not cap.isOpened():
        raise FileNotFoundError(path)
    fps = cap.get(cv2.CAP_PROP_FPS) or 30.0

    def gen():
        n = 0
        try:
            while max_frames is None or n < max_frames:
                ok, frame = cap.read()
                if not ok:
                    break
                if height is not None and width is not None:
                    frame = cv2.resize(frame, (width, height),
                                       interpolation=cv2.INTER_LINEAR)
                yield cv2.cvtColor(frame, cv2.COLOR_BGR2RGB)
                n += 1
        finally:
            cap.release()

    return gen(), fps


def _upload(chunks, device: torch.device) -> torch.Tensor:
    """Stack uint8 chunks into one (B, T, H, W, 3) tensor on ``device``:
    on the card through a pinned buffer and a non-blocking copy (the
    caching host allocator keeps the buffer until the copy is done)."""
    if device.type != "cuda":
        return torch.from_numpy(np.stack(chunks)).to(device)
    host = torch.empty((len(chunks),) + chunks[0].shape, dtype=torch.uint8,
                       pin_memory=True)
    np.stack(chunks, out=host.numpy())
    return host.to(device, non_blocking=True)


@torch.inference_mode()
def _encode_windows(vae, chunks, dtype, sample, generator) -> torch.Tensor:
    posterior = vae.encode(to_unit(_upload(chunks, vae.device), dtype))
    return posterior.sample(generator) if sample else posterior.mode()


def streaming_encode(vae, frame_iter: Iterator[np.ndarray], *,
                     dtype: torch.dtype = torch.bfloat16,
                     sample: bool = False,
                     generator: Optional[torch.Generator] = None,
                     chunk_batch: int = 1) -> Iterator[torch.Tensor]:
    """frames (H,W,3) uint8 -> latent chunks (1, t', h', w', z), each left
    on the device for the consumer.

    ``sample`` draws from the posterior with ``generator`` (on the
    model's device), else the mode.  ``chunk_batch > 1`` stacks
    consecutive temporal windows along the batch axis before encoding
    (the same per-sample function: nothing in the encoder mixes samples);
    a ragged last window flushes alone."""
    window = vae.config.en_de_n_frames_a_time
    if window is None:
        raise ValueError("streaming needs en_de_n_frames_a_time")
    if sample and generator is None:
        raise ValueError("sample=True needs a generator")
    first = True
    pending = []

    def flush():
        nonlocal first
        z = _encode_windows(vae, pending, dtype, sample, generator)
        for i in range(z.shape[0]):
            zi = z[i:i + 1]
            yield zi if first else zi[:, 1:]
            first = False

    for chunk_np in _chunk_frames(frame_iter, window):
        # full windows batch together; ragged tails flush alone
        if pending and pending[0].shape != chunk_np.shape:
            yield from flush()
            pending = []
        pending.append(chunk_np)
        if len(pending) == chunk_batch:
            yield from flush()
            pending = []
    if pending:
        yield from flush()


class _Fetcher:
    """Device -> host copies of uint8 frame blocks.  On the card each copy
    runs on a side stream into a pinned buffer, after an event recorded
    on the compute stream once the block is computed; ``result`` waits
    for the copy's own event before the bytes are read.  A buffer lives
    as long as the array handed out (its base), so it is not reused while
    a reader holds it."""

    def __init__(self, device: torch.device):
        self.side = (torch.cuda.Stream(device) if device.type == "cuda"
                     else None)

    def start(self, u8: torch.Tensor):
        if self.side is None:
            return u8, None
        ready = torch.cuda.Event()
        ready.record()                       # after the cast to uint8
        host = torch.empty(u8.shape, dtype=torch.uint8, pin_memory=True)
        with torch.cuda.stream(self.side):
            self.side.wait_event(ready)
            host.copy_(u8, non_blocking=True)
            done = torch.cuda.Event()
            done.record(self.side)
        u8.record_stream(self.side)          # no reuse before the copy
        return host, done

    @staticmethod
    def result(host: torch.Tensor, done) -> np.ndarray:
        if done is not None:
            done.synchronize()
        return host.numpy()


@torch.inference_mode()
def _decode_window(vae, z: torch.Tensor) -> torch.Tensor:
    return to_uint8(vae.spatial_tiled_decode(z.contiguous())[0])


def streaming_decode(vae, latent_iter: Iterator[torch.Tensor], *,
                     prefetch: int = 0) -> Iterator[np.ndarray]:
    """latent chunks -> uint8 frame blocks (T, H, W, 3) on the host.

    Windows of ``decode_n_frames_a_time``+1 latents with one-latent
    overlap; every window after the first drops its first output frame —
    byte-identical to the reference's tiled_decode over the full latent
    sequence (modeling_vae.py:279-296).

    ``prefetch > 0`` keeps that many decoded windows in flight: the
    fetch of window k starts on a side stream right after its decode is
    launched and is read only once k+prefetch has been launched, so it
    rides the link while the device decodes the next windows.  Output is
    bit-identical to prefetch=0."""
    window = vae.config.decode_n_frames_a_time
    if window is None:
        raise ValueError("streaming needs en_de_n_frames_a_time")
    fetcher = _Fetcher(vae.device)
    pending = collections.deque()

    def submit(z, drop_first):
        pending.append((fetcher.start(_decode_window(vae, z)), drop_first))

    def materialize():
        copy, drop_first = pending.popleft()
        frames = fetcher.result(*copy)
        return frames[1:] if drop_first else frames

    buf = None
    first = True
    for z in latent_iter:
        buf = z if buf is None else torch.cat([buf, z], dim=1)
        while buf.shape[1] >= window + 1:
            piece = buf[:, :window + 1]
            buf = buf[:, window:]          # keep the overlap latent
            submit(piece, drop_first=not first)
            first = False
            while len(pending) > prefetch:
                yield materialize()
    # tail: a partial window (first latent is the overlap unless nothing
    # was emitted yet)
    if buf is not None and (buf.shape[1] > 1 or (first and buf.shape[1] == 1)):
        submit(buf, drop_first=not first)
    while pending:
        yield materialize()


def reconstruct_stream(vae, frames: Iterator[np.ndarray],
                       sink: Callable[[np.ndarray], None], *,
                       dtype: torch.dtype = torch.bfloat16,
                       pipelined: bool = False) -> int:
    """Encode and decode a frame iterator of any length in bounded memory,
    handing each uint8 block (T, H, W, 3) to ``sink``.  Returns the number
    of frames out.

    ``pipelined=True`` overlaps the host stages with device compute: a
    thread pulls frames (``prefetched``), each decoded window's fetch
    starts one window early (``streaming_decode(prefetch=1)``), and
    ``sink`` runs on a writer thread behind a bounded queue.  Output bytes
    are identical to the serial loop.  An exception in ``sink`` stops the
    stream and is raised here."""
    fetch_prefetch = 0
    if pipelined:
        from cvvae_tpu_torch.data.pipeline import prefetched
        window = vae.config.en_de_n_frames_a_time or 16
        frames = prefetched(frames, size=2 * (window + 1))
        fetch_prefetch = 1
    blocks = streaming_decode(vae, streaming_encode(vae, frames, dtype=dtype),
                              prefetch=fetch_prefetch)
    n_out = 0

    def write_block(block):
        nonlocal n_out
        sink(block)
        n_out += len(block)

    if not pipelined:
        for block in blocks:
            write_block(block)
        return n_out

    import queue
    import threading
    q: "queue.Queue" = queue.Queue(maxsize=4)
    err = []

    def writer_loop():
        while True:
            block = q.get()
            if block is None:
                return
            try:
                write_block(block)
            except BaseException as e:  # surfaced in the calling thread
                err.append(e)
                # keep draining so the producer's put() never blocks on a
                # full queue after the death
                while q.get() is not None:
                    pass
                return

    th = threading.Thread(target=writer_loop, daemon=True)
    th.start()
    try:
        for block in blocks:
            if err:
                break
            # bounded wait: if the writer died between the err check and a
            # full queue, do not block forever
            while True:
                try:
                    q.put(block, timeout=1.0)
                    break
                except queue.Full:
                    if err:
                        break
            if err:
                break
    finally:
        q.put(None)
        th.join()
    if err:
        raise err[0]
    return n_out


def reconstruct_video_streaming(vae, in_path: str, out_path: str, *,
                                height: Optional[int] = None,
                                width: Optional[int] = None,
                                max_frames: Optional[int] = None,
                                dtype: torch.dtype = torch.bfloat16,
                                pipelined: bool = False) -> dict:
    """End-to-end bounded-memory reconstruction of an arbitrarily long
    video file: ``reconstruct_stream`` between OpenCV's reader and an mp4
    writer.  Returns stats."""
    import cv2
    frames, fps = read_video_frames(in_path, height=height, width=width,
                                    max_frames=max_frames)
    writer = None

    def write_block(block):
        nonlocal writer
        if writer is None:
            h, w = block.shape[1:3]
            writer = cv2.VideoWriter(
                out_path, cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h))
        for f in block:
            writer.write(cv2.cvtColor(f, cv2.COLOR_RGB2BGR))

    try:
        n_out = reconstruct_stream(vae, frames, write_block, dtype=dtype,
                                   pipelined=pipelined)
    finally:
        # always finalise the container, also on a writer error: partial
        # output stays playable and the handle is not leaked
        if writer is not None:
            writer.release()
    return {"frames_out": n_out, "fps": fps, "out_path": out_path}
