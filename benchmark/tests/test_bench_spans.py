"""The per-layer metrics read from the port's own request records
(``queue_wait_ms``, ``transfer_ms``, ``tile_overlap_pct``) on the CPU:
after a tiny traced rehearsal, after an untraced one, on a port without
the records, and on the tile plans of the two 720p cells.

    python -m pytest benchmark/tests -q
"""

import re
import sys

import pytest
import torch

from benchmark import harness, program
from benchmark.metrics import queue_wait_ms, tile_overlap_pct, transfer_ms
from benchmark.tests.test_bench_harness import (CELLS, REPO, TINY,  # noqa: F401
                                                tiny_int8, tiny_run)

READERS = (queue_wait_ms, transfer_ms, tile_overlap_pct)


def _plan_overlap(cell):
    """``tile_overlap_pct`` from the cell's serving tile plan alone, as
    ``cli.serving_decode_tiles`` gives it: each net's tiles' positions
    along H and W over the frame's, averaged over the two nets, less
    one, in %."""
    from cvvae_tpu_torch.cli import serving_decode_tiles

    mix, cfg = cell.mix, cell.cfg
    tile, ratio = serving_decode_tiles(mix.height, mix.width)
    s = cfg.video["spatial_n_compress"]

    def axis(size, t, r):
        if t is None or size <= t:
            return size
        stride, total, i = round(t * (1 - r)), 0, 0
        while True:
            total += min(t, size - i)
            if i + t >= size:
                return total
            i += stride

    def net(h, w, t):
        if t is None or (h <= t[0] and w <= t[1]):
            return 1.0
        return axis(h, t[0], ratio[0]) * axis(w, t[1], ratio[1]) / (h * w)

    dec_tile = None if tile is None else (tile[0] // s, tile[1] // s)
    enc = net(mix.height, mix.width, None if cfg.family == "v1" else tile)
    dec = net(mix.height // s, mix.width // s, dec_tile)
    return 100.0 * ((enc + dec) / 2 - 1.0)


@pytest.mark.parametrize("name", CELLS)
def test_traced_rehearsal_reads_the_records(name, tiny_int8, capsys):
    """A tiny traced run: each reader returns a number, the queue wait
    lies within the window, and the tile overlap is the plan's."""
    result = tiny_run(name, trace=True)
    assert result["correct"], result["check"]
    window_s = float(re.search(r"window ([0-9.]+) s",
                               capsys.readouterr().err).group(1))
    values = {r.__name__.rsplit(".", 1)[1]: r.read(None) for r in READERS}
    assert all(v is not None for v in values.values()), values
    assert 0 <= values["queue_wait_ms"] <= 1e3 * window_s
    assert values["transfer_ms"] > 0
    cell = harness.Cell(harness.load_spec(TINY), name, TINY)
    assert values["tile_overlap_pct"] == _plan_overlap(cell)


def test_untraced_rehearsal_leaves_the_readers_none(tiny_int8):
    result = tiny_run(CELLS[0])
    assert result["correct"], result["check"]
    assert [r.read(None) for r in READERS] == [None] * 3


def test_a_port_without_records_reads_none(monkeypatch):
    """The parent port has no ``utils/spans``: the readers give None and
    raise nothing."""
    monkeypatch.setitem(sys.modules, "cvvae_tpu_torch.utils.spans", None)
    assert [r.read(None) for r in READERS] == [None] * 3


@pytest.mark.parametrize("name,want", [("v1-int8-clip720", 2.5),
                                       ("sd3-bf16-clip720", 5.0)])
def test_tile_overlap_of_the_720p_plans(name, want, monkeypatch):
    """The port's tiling on a one-frame 720p clip, its nets replaced by
    stand-ins of the right output shape: the counters give the cell's
    plan (v1: encoder untiled, decoder 2 x 672 of 1280 px; SD3: both
    nets so), and the reader 2.5 / 5.0."""
    from cvvae_tpu_torch.cli import apply_serving_preset
    from cvvae_tpu_torch.models.video_vae import VideoVAE
    from cvvae_tpu_torch.utils import spans

    cell = harness.Cell(harness.load_spec(REPO), name, REPO)
    with torch.device("meta"):
        vae = VideoVAE(program.port_config(cell.cfg))
    apply_serving_preset(vae, cell.mix.height, cell.mix.width)
    z = 2 * vae.config.latent_channels
    s = vae.config.spatial_n_compress
    vae._encoder = lambda x: torch.zeros(
        x.shape[:2] + (x.shape[2] // s, x.shape[3] // s, z))
    vae._decoder = lambda v: torch.zeros(
        v.shape[:2] + (v.shape[2] * s, v.shape[3] * s, 3))
    x = torch.zeros(1, 1, cell.mix.height, cell.mix.width, 3)
    vae.decode(vae.encode(x).mode())
    rec = spans.RequestRecord(0, "reconstruct", 1, 0.0, profiled=True,
                              tiles=dict(vae.tile_counts))
    log = spans.RequestLog()
    log.add(rec)
    log.add(rec)                 # the first traced record is left out
    assert tile_overlap_pct.read(None) == pytest.approx(want, abs=1e-9)
    assert tile_overlap_pct.read(None) == pytest.approx(
        _plan_overlap(cell), abs=1e-9)
