"""The port's sharded server (``serve --spatial_shards``, ``build_server``
on a ``with_mesh`` VAE) and streaming over a mesh, on two CPU ranks over
gloo, against the unsharded port: latents within ``tests/test_parallel.py``'s
2e-5 and uint8 frames within ±1 count (a GroupNorm combined across ranks
rounds in another order, which can flip a rounding), as the JAX package's
``test_sharded_server_matches_unsharded`` and
``test_streaming_over_mesh_matches_single_device`` hold its own.

``serve.prepare`` with ``--spatial_shards 2`` makes and closes a mesh of
its own, so it runs first; the file's mesh serves the rest.
"""

import http.client
import io
import os
import threading

import numpy as np
import pytest
import torch

import torch_parallel_cases as cases
from cvvae_tpu_torch import serve
from cvvae_tpu_torch.streaming import streaming_decode, streaming_encode

torch.set_num_threads(2)

N = 2


def _post(port, path, arr):
    buf = io.BytesIO()
    np.save(buf, arr, allow_pickle=False)
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    conn.request("POST", path, body=buf.getvalue())
    resp = conn.getresponse()
    data = resp.read()
    conn.close()
    return resp.status, data


def _get(port, path):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    conn.request("GET", path)
    resp = conn.getresponse()
    data = resp.read()
    conn.close()
    return resp.status, data


def _start(server):
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return server.server_address[1]


def test_prepare_serves_with_spatial_shards():
    """``serve --device cpu --spatial_shards 2`` (the default v1 at a
    small size): the model is split over a mesh of two CPU processes, is
    warmed and serves; its /reconstruct equals /decode of its /encode."""
    args = serve.build_argparser().parse_args(
        ["--device", "cpu", "--dtype", "fp32", "--spatial_shards", "2",
         "--height", "16", "--width", "16", "--warm_frames", "5",
         "--port", "0"])
    server = serve.prepare(args)
    try:
        assert server.mesh is not None and server.mesh.world == 2
        assert server.worker.vae.mesh is server.mesh
        port = _start(server)
        assert _get(port, "/healthz") == (200, b'{"ok": true}')
        frames = np.random.RandomState(4).randint(0, 255, (5, 16, 16, 3),
                                                  np.uint8)
        s1, z = _post(port, "/encode", frames)
        s2, rec = _post(port, "/reconstruct", frames)
        s3, dec = _post(port, "/decode", np.load(io.BytesIO(z)))
        assert (s1, s2, s3) == (200, 200, 200)
        assert rec == dec
    finally:
        server.shutdown()
        server.server_close()
        server.mesh.close()


def test_prepare_refuses_more_shards_than_devices():
    """The refusal JAX keeps: more shards than visible devices."""
    n = os.cpu_count() + 1
    args = serve.build_argparser().parse_args(
        ["--device", "cpu", "--spatial_shards", str(n)])
    with pytest.raises(SystemExit, match="visible devices"):
        serve.prepare(args)


@pytest.fixture(scope="module")
def mesh(tmp_path_factory):
    m = cases.port_mesh(N, tmp_path_factory)
    yield m
    m.close()


@pytest.mark.parametrize("kind", ["fp", "int8", "tiled"])
def test_sharded_server_matches_unsharded(mesh, kind):
    """build_server on a with_mesh VAE against the same VAE unsharded: fp,
    quantized (min_cin 8, calibrated on the request's frames) and tiled
    (16-px tiles on a 32-px clip force the multi-tile path, every tile a
    net call over the mesh)."""
    tiles = (dict(tile_spatial_size=16, tile_overlap_ratio=0.5)
             if kind == "tiled" else {})
    _, vae = cases.pair("v1", **tiles)
    rs = np.random.RandomState(3)
    frames = rs.randint(0, 255, (5, 32, 32, 3), np.uint8)
    if kind == "int8":
        vae = vae.quantize(min_cin=8, calibration=torch.from_numpy(
            frames[None].astype(np.float32) / 127.5 - 1.0))
    servers = [serve.build_server(v, port=0, device="cpu",
                                  act_dtype=torch.float32)
               for v in (vae, vae.with_mesh(mesh))]
    ports = [_start(s) for s in servers]
    try:
        for path in ("/encode", "/reconstruct"):
            (s_ref, b_ref), (s_sh, b_sh) = (_post(p, path, frames)
                                            for p in ports)
            assert (s_ref, s_sh) == (200, 200)
            a = np.load(io.BytesIO(b_ref))
            b = np.load(io.BytesIO(b_sh))
            if a.dtype == np.uint8:
                assert np.abs(a.astype(int) - b.astype(int)).max() <= 1
            else:
                np.testing.assert_allclose(b, a, **cases.LATENT_TOL)
    finally:
        for s in servers:
            s.shutdown()
            s.server_close()


def test_streaming_over_mesh_matches_unsharded(mesh):
    """The bounded-memory streaming pipeline composes with with_mesh: a
    21-frame clip streamed in 8-frame windows through the split model
    gives the unsharded stream's latents and frames."""
    _, vae = cases.pair("v1", en_de_n_frames_a_time=8)
    frames = np.random.RandomState(0).randint(0, 255, (21, 64, 32, 3),
                                              np.uint8)

    def run(v):
        zs = list(streaming_encode(v, iter(frames), dtype=torch.float32))
        outs = list(streaming_decode(v, iter(zs)))
        return (torch.cat(zs, dim=1).numpy(), np.concatenate(outs, axis=0))

    z_ref, f_ref = run(vae)
    z_mesh, f_mesh = run(vae.with_mesh(mesh))
    np.testing.assert_allclose(z_mesh, z_ref, **cases.LATENT_TOL)
    assert f_mesh.shape == f_ref.shape
    assert np.abs(f_mesh.astype(np.int16) - f_ref.astype(np.int16)).max() <= 1


def test_sharded_server_fails_loudly_when_a_rank_dies(mesh):
    """A follower that dies fails the server loudly: the request answers
    500 with the mesh's error, /healthz answers 503, and so does every
    later request; nothing falls back to one device.  (It kills one of
    the file's ranks, so it runs last.)"""
    _, vae = cases.pair("v1")
    server = serve.build_server(vae.with_mesh(mesh), port=0, device="cpu",
                                act_dtype=torch.float32)
    port = _start(server)
    frames = np.zeros((5, 32, 32, 3), np.uint8)
    try:
        assert _post(port, "/reconstruct", frames)[0] == 200
        mesh._procs[-1].kill()
        mesh._procs[-1].join(10)
        status, body = _post(port, "/reconstruct", frames)
        assert status == 500 and b"died" in body
        status, body = _get(port, "/healthz")
        assert status == 503 and b"closed" in body
        assert _post(port, "/encode", frames)[0] == 500
    finally:
        server.shutdown()
        server.server_close()
