"""The port's streaming path (``cvvae_tpu_torch/streaming.py``) on the CPU,
in fp32, against the port's own batch path byte for byte in uint8 and
against the JAX package's batch ``VideoVAE.encode`` / ``tiled_decode``
(latents and frames within 3e-4 abs, uint8 within +-1).

The eight cases of ``tests/test_streaming.py``, then a writer that dies
mid-stream, a sampled stream made twice from one seed and the in-memory
loop (``reconstruct_stream``) for v1 and SD3.  Both packages run the same
weights (JAX ``from_config`` -> ``from_jax_params``).
"""

import functools
import threading

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cvvae_tpu import streaming as jstreaming
from cvvae_tpu.models.vae_sd3 import VAESD3Config as JSD3
from cvvae_tpu.models.vae_v1 import VAE1Config as JNet
from cvvae_tpu.models.video_vae import VideoVAE as JVAE
from cvvae_tpu.models.video_vae import VideoVAEConfig as JConfig

from cvvae_tpu_torch.data import video_io
from cvvae_tpu_torch.data.video_io import to_uint8, to_unit
from cvvae_tpu_torch.models.vae_sd3 import VAESD3Config
from cvvae_tpu_torch.models.vae_v1 import VAE1Config
from cvvae_tpu_torch.models.video_vae import VideoVAE, VideoVAEConfig
from cvvae_tpu_torch.streaming import (_chunk_frames, reconstruct_stream,
                                       reconstruct_video_streaming,
                                       streaming_decode, streaming_encode)
from cvvae_tpu_torch.utils.convert import from_jax_params

torch.set_num_threads(2)

ATOL = 3e-4
NETS = {"v1": (JNet, VAE1Config,
               dict(ch=8, ch_mult=(1, 2, 4, 4), num_res_blocks=1,
                    z_channels=4, norm_num_groups=4)),
        "sd3": (JSD3, VAESD3Config,
                dict(block_out_channels=(8, 8, 16, 16), layers_per_block=1,
                     norm_num_groups=4, latent_channels=4))}
BASE = dict(en_de_n_frames_a_time=8, tile_spatial_size=None)


@functools.lru_cache(maxsize=None)
def _pair(family):
    jnet, tnet, net = NETS[family]
    jvae = JVAE.from_config(JConfig(family=family, net=jnet(**net), **BASE),
                            seed=0)
    tvae = VideoVAE(VideoVAEConfig(family=family, net=tnet(**net),
                                   **BASE)).eval().requires_grad_(False)
    tvae.load_state_dict(from_jax_params(jax.tree.map(np.asarray,
                                                      jvae.params)),
                         strict=True)
    return jvae, tvae


@pytest.fixture(scope="module")
def vaes():
    return _pair("v1")


def _u8(x: np.ndarray) -> np.ndarray:
    return np.clip((x + 1.0) * 127.5, 0, 255).astype(np.uint8)


def _frames(n, seed):
    return np.random.RandomState(seed).randint(0, 255, (n, 16, 16, 3),
                                               np.uint8)


def _batch(tvae, frames_u8):
    """The port's batch path on uint8 frames: (latents, float frames,
    uint8 frames)."""
    x = to_unit(torch.from_numpy(frames_u8)[None], torch.float32)
    z = tvae.encode(x).mode()
    rec = tvae.decode(z)
    return z, rec, to_uint8(rec[0]).numpy()


def _jax_batch(jvae, frames_u8):
    """The JAX package's batch path: (latents, float frames, uint8)."""
    x = jnp.asarray(frames_u8, jnp.float32)[None] / 127.5 - 1.0
    z = jvae.encode(x).mode()
    rec = np.asarray(jvae.tiled_decode(z))
    return np.asarray(z), rec, _u8(rec[0])


def _close(got, ref, atol=ATOL):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == np.asarray(ref).shape
    np.testing.assert_allclose(got, np.asarray(ref), atol=atol, rtol=0)


def _within_one(got, ref):
    assert got.shape == ref.shape and got.dtype == ref.dtype == np.uint8
    assert np.abs(got.astype(np.int16) - ref.astype(np.int16)).max() <= 1


def _stream_latents(tvae, frames_u8, **kw):
    return torch.cat(list(streaming_encode(tvae, iter(frames_u8),
                                           dtype=torch.float32, **kw)), dim=1)


def test_chunk_frames_overlap():
    frames = [np.full((2, 2, 3), i, np.uint8) for i in range(21)]
    chunks = list(_chunk_frames(iter(frames), 8))
    # first chunk 9 frames (0..8); then overlap: 8..16; 16..20
    assert [c.shape[0] for c in chunks] == [9, 9, 5]
    assert chunks[1][0, 0, 0, 0] == 8 and chunks[2][0, 0, 0, 0] == 16
    for n in (1, 8, 9, 16, 17, 21):
        ref = list(jstreaming._chunk_frames(iter(frames[:n]), 8))
        got = list(_chunk_frames(iter(frames[:n]), 8))
        assert len(got) == len(ref)
        for a, b in zip(got, ref):
            np.testing.assert_array_equal(a, b)


def test_streaming_encode_matches_batch(vaes):
    jvae, tvae = vaes
    frames_u8 = _frames(21, 0)
    z_stream = _stream_latents(tvae, frames_u8)
    z_batch, _, _ = _batch(tvae, frames_u8)
    assert tuple(z_stream.shape) == tuple(z_batch.shape) == (1, 6, 2, 2, 4)
    assert torch.equal(z_stream, z_batch)
    z_jax, _, _ = _jax_batch(jvae, frames_u8)
    _close(z_stream, z_jax)


def test_streaming_decode_matches_batch(vaes):
    jvae, tvae = vaes
    z = np.random.RandomState(1).randn(1, 6, 2, 2, 4).astype(np.float32)
    zt = torch.from_numpy(z)
    x_batch = tvae.decode(zt)
    # feed latents in awkward chunk sizes to exercise the buffering
    blocks = list(streaming_decode(tvae, iter([zt[:, :1], zt[:, 1:4],
                                               zt[:, 4:]])))
    x_stream = np.concatenate(blocks, axis=0)
    assert x_stream.shape == (21, 16, 16, 3)
    np.testing.assert_array_equal(x_stream, to_uint8(x_batch[0]).numpy())
    x_jax = np.asarray(jvae.tiled_decode(jnp.asarray(z)))
    _close(x_batch, x_jax)
    _within_one(x_stream, _u8(x_jax[0]))


def _write_mp4(path, frames, fps=10):
    video_io.write_video(str(path), frames, fps)
    return video_io.read_video(str(path))[0]   # what a reader decodes


def _read_all(path):
    return video_io.read_video(str(path))[0]


def test_streaming_roundtrip_file(vaes, tmp_path):
    """A file through ``reconstruct_video_streaming`` is the file the
    batch path writes from the same decoded frames."""
    jvae, tvae = vaes
    frames = np.stack([np.full((16, 16, 3), f * 15, np.uint8)
                       for f in range(13)])
    decoded = _write_mp4(tmp_path / "in.mp4", frames)
    out = tmp_path / "out.mp4"
    stats = reconstruct_video_streaming(tvae, str(tmp_path / "in.mp4"),
                                        str(out), dtype=torch.float32)
    assert stats["frames_out"] == 13
    _, _, u8 = _batch(tvae, decoded)
    video_io.write_video(str(tmp_path / "batch.mp4"), u8, stats["fps"])
    np.testing.assert_array_equal(_read_all(out),
                                  _read_all(tmp_path / "batch.mp4"))
    _within_one(u8, _jax_batch(jvae, decoded)[2])


@pytest.mark.parametrize("chunk_batch", [2, 3])
def test_streaming_encode_chunk_batched(vaes, chunk_batch):
    """chunk_batch>1 stacks windows on the batch axis: the same latents
    (4 windows: 2+2 and 3+1)."""
    jvae, tvae = vaes
    frames_u8 = _frames(33, 2)
    z1 = _stream_latents(tvae, frames_u8)
    z2 = _stream_latents(tvae, frames_u8, chunk_batch=chunk_batch)
    assert tuple(z1.shape) == tuple(z2.shape) == (1, 9, 2, 2, 4)
    _close(z2, z1, atol=1e-5)
    assert torch.equal(z1, _batch(tvae, frames_u8)[0])


def test_streaming_encode_chunk_batched_ragged_tail(vaes):
    """A short final window (another shape) flushes on its own."""
    jvae, tvae = vaes
    frames_u8 = _frames(21, 3)                      # 9, 9, 5
    z1 = _stream_latents(tvae, frames_u8)
    z2 = _stream_latents(tvae, frames_u8, chunk_batch=2)
    assert tuple(z1.shape) == tuple(z2.shape) == (1, 6, 2, 2, 4)
    _close(z2, z1, atol=1e-5)
    _close(z2, _jax_batch(jvae, frames_u8)[0])


def test_streaming_decode_prefetch_bit_identical(vaes):
    """prefetch>0 emits the exact bytes of the serial loop, the ragged
    tail window included, and those of the batch path."""
    jvae, tvae = vaes
    z = torch.from_numpy(
        np.random.RandomState(2).randn(1, 6, 2, 2, 4).astype(np.float32))
    ser = list(streaming_decode(tvae, iter([z[:, :3], z[:, 3:]])))
    for prefetch in (1, 3):
        pipe = list(streaming_decode(tvae, iter([z[:, :3], z[:, 3:]]),
                                     prefetch=prefetch))
        assert len(pipe) == len(ser) == 3
        for a, b in zip(pipe, ser):
            np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(np.concatenate(ser),
                                  to_uint8(tvae.decode(z)[0]).numpy())


def test_streaming_roundtrip_pipelined_matches_serial(vaes, tmp_path):
    """The pipelined host loop (frame thread + early fetch + writer
    thread) writes the same video as the serial loop and the batch
    path."""
    jvae, tvae = vaes
    decoded = _write_mp4(tmp_path / "in.mp4", _frames(21, 3))
    out_s, out_p = tmp_path / "serial.mp4", tmp_path / "pipe.mp4"
    st_s = reconstruct_video_streaming(tvae, str(tmp_path / "in.mp4"),
                                       str(out_s), dtype=torch.float32)
    st_p = reconstruct_video_streaming(tvae, str(tmp_path / "in.mp4"),
                                       str(out_p), dtype=torch.float32,
                                       pipelined=True)
    assert st_s["frames_out"] == st_p["frames_out"] == 21
    np.testing.assert_array_equal(_read_all(out_s), _read_all(out_p))
    _, _, u8 = _batch(tvae, decoded)
    video_io.write_video(str(tmp_path / "batch.mp4"), u8, st_s["fps"])
    np.testing.assert_array_equal(_read_all(out_s),
                                  _read_all(tmp_path / "batch.mp4"))
    _within_one(u8, _jax_batch(jvae, decoded)[2])


@pytest.mark.parametrize("family", ["v1", "sd3"])
def test_reconstruct_stream_matches_batch(family):
    """The in-memory loop, serial and pipelined, gives the batch path's
    bytes (ragged tails: 9, 9, 5 frames in; 3, 3, 2 latents out) and JAX's
    within +-1."""
    jvae, tvae = _pair(family)
    frames_u8 = _frames(21, 4)
    _, rec, u8 = _batch(tvae, frames_u8)
    for pipelined in (False, True):
        blocks = []
        n = reconstruct_stream(tvae, iter(frames_u8), blocks.append,
                               dtype=torch.float32, pipelined=pipelined)
        assert n == 21 and [len(b) for b in blocks] == [9, 8, 4]
        np.testing.assert_array_equal(np.concatenate(blocks), u8)
    _, rec_jax, u8_jax = _jax_batch(jvae, frames_u8)
    _close(rec, rec_jax)
    _within_one(u8, u8_jax)


def test_pipelined_writer_death_surfaces(vaes):
    """A sink that raises mid-stream stops the pipelined loop: the error
    reaches the caller and no thread is left blocked."""
    _, tvae = vaes
    calls = []

    def sink(block):
        calls.append(len(block))
        if len(calls) == 2:
            raise OSError("disk full")

    box = {}

    def run():
        try:
            reconstruct_stream(tvae, iter(_frames(41, 5)), sink,
                               dtype=torch.float32, pipelined=True)
        except OSError as e:
            box["err"] = e

    th = threading.Thread(target=run, daemon=True)
    th.start()
    th.join(120)
    assert not th.is_alive(), "the pipelined loop hung after the sink died"
    assert str(box.get("err")) == "disk full"
    assert calls == [9, 8]


def test_sampled_stream_repeats_from_one_seed(vaes):
    """sample=True draws with the generator: one seed gives one stream,
    and it is not the mode."""
    _, tvae = vaes
    frames_u8 = _frames(21, 6)
    runs = [_stream_latents(tvae, frames_u8, sample=True,
                            generator=torch.Generator().manual_seed(7))
            for _ in range(2)]
    assert torch.equal(runs[0], runs[1])
    assert not torch.equal(runs[0], _stream_latents(tvae, frames_u8))
    with pytest.raises(ValueError, match="generator"):
        next(streaming_encode(tvae, iter(frames_u8), sample=True))


@pytest.mark.parametrize("n", [17, 18, 45, 901])
def test_bench_window_plan_is_the_streams(n):
    """``bench_streaming --device_resident`` replays the stream's own
    encode windows (45 frames: 17, 17, 13), and refuses to run off the
    card."""
    from cvvae_tpu_torch.utils import bench_streaming
    frames = [np.zeros((1, 1, 3), np.uint8)] * n
    assert bench_streaming.window_plan(n, 16) == \
        [c.shape[0] for c in _chunk_frames(iter(frames), 16)]
    if n == 45:
        assert bench_streaming.window_plan(n, 16) == [17, 17, 13]
        if not torch.cuda.is_available():
            with pytest.raises(SystemExit, match="CUDA"):
                bench_streaming.main([])
