"""The benchmark's plain reference against the port, on the CPU at tiny
widths: the same parameters, the same float frames, the same int8 convs
given the same scales, the same tile plan; and the operations it counts
against torch's own counter.

    python -m pytest benchmark/tests -q
"""

import dataclasses
import json
import os

import pytest
import torch

from benchmark.reference import cvvae as R

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(os.path.dirname(HERE))


def load(name, root=REPO):
    with open(os.path.join(root, "benchmark", "configs", f"{name}.json")) as f:
        return R.Config(json.load(f))


def tiny(family):
    return load(f"tiny-{family}", os.path.join(HERE, "tiny"))


def port_model(cfg, weights):
    from benchmark.program import port_config
    from cvvae_tpu_torch.models.video_vae import VideoVAE

    with torch.device("meta"):
        vae = VideoVAE(port_config(cfg))
    vae.load_state_dict(weights, strict=True, assign=True)
    return vae.eval().requires_grad_(False)


def weights(cfg, seed, affine_noise=0.0):
    """fp32 weights on the CPU: torch's default ranges, and norm affines
    perturbed by ``affine_noise`` so that a swapped scale or shift shows."""
    specs = R.parameter_specs(cfg)
    g = torch.Generator().manual_seed(seed)
    out = {}
    for k, (shape, kind) in specs.items():
        if kind in ("ones", "zeros"):
            base = torch.ones(shape) if kind == "ones" else torch.zeros(shape)
            out[k] = base + affine_noise * torch.randn(shape, generator=g)
        else:
            out[k] = (torch.rand(shape, generator=g) * 2 - 1) \
                * R.init_bound(specs, k)
    return out


def to_u8(x):
    return ((x.float() + 1.0) * 127.5).clamp(0, 255).to(torch.uint8)


def rms(a, b):
    return float((a.float() - b.float()).square().mean().sqrt())


@pytest.mark.parametrize("name", ["cvvae-v1", "cvvae-sd3"])
def test_parameters_are_the_ports(name):
    from benchmark.program import port_config
    from cvvae_tpu_torch.models.video_vae import VideoVAE

    cfg = load(name)
    with torch.device("meta"):
        sd = VideoVAE(port_config(cfg)).state_dict()
    specs = R.parameter_specs(cfg)
    assert list(specs) == list(sd)
    assert all(tuple(sd[k].shape) == specs[k][0] for k in sd)


@pytest.mark.parametrize("family", ["v1", "sd3"])
@pytest.mark.parametrize("tiles", [False, True])
def test_float_frames_match_the_port(family, tiles):
    """fp32 on both sides: the uint8 frames differ only where a value sits
    on a truncation step (a level at most, a tenth of a level RMS)."""
    cfg = tiny(family)
    w = weights(cfg, 1, affine_noise=0.1)
    vae = port_model(cfg, w)
    ref = R.Reference(cfg, w, "cpu")
    plan = None
    if tiles:
        vae.config = dataclasses.replace(
            vae.config, tile_spatial_size=(48, 64),
            tile_overlap_ratio=(0.25, 0.25), encode_tile_spatial_size="inherit")
        plan = R.Plan((48, 64), (48, 64), (0.25, 0.25))
    g = torch.Generator().manual_seed(2)
    clip = torch.randint(0, 256, (9, 64, 96, 3), dtype=torch.uint8,
                         generator=g)
    got = to_u8(vae.decode(vae.encode(clip.float()[None] / 127.5 - 1.0)
                           .mode())[0])
    want = ref.reconstruct(clip, plan)
    # tiles that do not divide the frame lose rows, in both alike
    assert got.shape == want.shape
    assert tiles or got.shape == clip.shape
    assert rms(got, want) < 0.1
    assert (got.int() - want.int()).abs().max() <= 1


@pytest.fixture
def tiny_int8(monkeypatch):
    """The port's int8 threshold at the tiny configurations' own."""
    from cvvae_tpu_torch.ops import quant
    monkeypatch.setattr(quant, "INT8_MIN_POSITIONS",
                        tiny("v1").int8["min_positions"])


def _int8_pair(family):
    from cvvae_tpu_torch.ops import quant

    cfg = tiny(family)
    w = weights(cfg, 3)
    g = torch.Generator().manual_seed(4)
    calib = torch.randint(0, 256, (9, 128, 128, 3), dtype=torch.uint8,
                          generator=g)
    q = port_model(cfg, w).quantize(
        calibration=calib.float()[None] / 127.5 - 1.0,
        min_cin=cfg.int8["min_cin"], margin=cfg.int8["margin"])
    ref = R.Reference(cfg, w, "cpu", bits=8)
    ref.calibrate(calib)
    assert quant.INT8_MIN_POSITIONS == cfg.int8["min_positions"]
    return cfg, q, ref, g


@pytest.mark.parametrize("family", ["v1", "sd3"])
def test_int8_scheme_matches_the_port(family, tiny_int8):
    """The same convs quantized and calibrated, to the scale (the first
    quantized conv's to fp32 order; later ones move with the int8 rounding
    of the convs before them); each int8 conv, downsample and upsample
    equal to the port's given the same scale."""
    from cvvae_tpu_torch.ops.conv import conv3d
    from cvvae_tpu_torch.ops.upsample_conv import \
        upsample2x_conv3x3_interleave

    cfg, q, ref, g = _int8_pair(family)
    port = {n[:-len(".scale_x")]: float(v) for n, v in q.state_dict().items()
            if n.endswith(".scale_x")}
    mine = {n: float(v) for n, v in ref.quant.scales.items()}
    assert set(port) == set(mine) and port
    first = next(k[:-len(".weight")] for k in R.parameter_specs(cfg)
                 if k[:-len(".weight")] in port)
    assert port[first] == pytest.approx(mine[first], rel=1e-4)
    assert max(abs(port[k] / mine[k] - 1) for k in port) < 0.05
    ref.quant.scales = {k: torch.tensor(v) for k, v in port.items()}
    hw = "zero" if family == "v1" else "edge"
    up_spec = R.Spec((3, 3, 3), (1, 1, 1), ((1, 1), (1, 1), (1, 1)),
                     ("edge", hw, hw))
    checked = 0
    for name, mod in q.named_modules():
        if name not in port:
            continue
        # 9 x 48 x 48 positions: past min_positions, so both run int8
        x = torch.randn((1, 9, 48, 48, mod.weight_q.shape[1]), generator=g)
        xr = x.permute(0, 4, 1, 2, 3).contiguous()
        if hasattr(mod, "spec"):
            got = conv3d(x, mod, mod.spec)
            want = ref.net.conv(name, xr, R.Spec(
                mod.spec.kernel, mod.spec.stride, mod.spec.pads,
                mod.spec.modes))
        else:   # an upsample
            got = upsample2x_conv3x3_interleave(
                x, mod, n=mod.n, t_pad=(1, 1), t_mode="edge", hw_mode=hw)
            want = ref.net.upsample(name, xr, mod.n, up_spec)
        want = want.permute(0, 2, 3, 4, 1)
        assert got.shape == want.shape, name
        assert (got - want).abs().max() <= 1e-4 * max(1.0, got.abs().max()), \
            name
        checked += 1
    assert checked == len(port)


@pytest.mark.parametrize("family", ["v1", "sd3"])
def test_int8_frames_near_the_port(family, tiny_int8):
    """The whole int8 path at tiny widths, the port's scales given to the
    reference: within a few levels of the port, and a third or less of
    the reference's int4 frames' distance.  (A narrow random net carries
    on each int8 rounding that the order of fp32 sums moves, so the frames
    do not match closer.)"""
    cfg, q, ref, g = _int8_pair(family)
    clip = torch.randint(0, 256, (9, 128, 128, 3), dtype=torch.uint8,
                         generator=g)
    got = to_u8(q.decode(q.encode(clip.float()[None] / 127.5 - 1.0)
                         .mode())[0])
    int4 = R.Reference(cfg, weights(cfg, 3), "cpu", bits=4)
    int4.calibrate(torch.randint(0, 256, (9, 128, 128, 3),
                                 dtype=torch.uint8, generator=g))
    ref.quant.scales = {n[:-len(".scale_x")]: v.float() for n, v in
                        q.state_dict().items() if n.endswith(".scale_x")}
    int8 = rms(got, ref.reconstruct(clip))
    assert int8 < 5.0
    assert int8 < rms(got, int4.reconstruct(clip)) / 3


@pytest.mark.parametrize("height,width", [(720, 1280), (720, 720),
                                          (1080, 1920), (576, 1024),
                                          (480, 854), (1440, 2560)])
def test_tile_plan_is_the_ports(height, width):
    from cvvae_tpu_torch.cli import serving_decode_tiles

    for family in ("v1", "sd3"):
        plan = R.serving_plan(tiny(family), height, width)
        tile, ratio = serving_decode_tiles(height, width)
        assert plan.decode_tile == (None if tile is None else tuple(tile))
        if tile is not None:
            assert plan.ratio == tuple(ratio)
        assert plan.encode_tile == (None if family == "v1"
                                    else plan.decode_tile)


@pytest.mark.parametrize("family", ["v1", "sd3"])
def test_operations_match_torchs_counter(family):
    """The counted operations equal torch's FlopCounterMode over the float
    reference, which counts the upsample's conv on the upsampled tensor:
    9/4 of its four phase convs."""
    from torch.utils.flop_counter import FlopCounterMode

    cfg = tiny(family)
    cfg.precision = "bf16"
    w = weights(cfg, 5)
    counter, ups = [], []
    net = R.Net(cfg, {k: torch.empty(v.shape, device="meta")
                      for k, v in w.items()}, None, counter)
    conv = net.conv

    def tagged(name, x, spec, upsample=False):
        before = len(counter)
        out = conv(name, x, spec, upsample)
        if upsample:
            ups.append(counter[before][0])
        return out

    net.conv = tagged
    m = net.encoder(torch.empty((1, 3, 9, 32, 48), device="meta"))
    net.decoder(m[:, :cfg.latent_channels])
    total = sum(ops for ops, _ in counter)
    assert total == sum(ops for ops, _ in R.operations(cfg, (9, 32, 48)))
    assert len(ups) >= 2
    real = R.Net(cfg, w)
    with torch.no_grad(), FlopCounterMode(display=False) as fc:
        m = real.encoder(torch.rand((1, 3, 9, 32, 48)) * 2 - 1)
        real.decoder(m[:, :cfg.latent_channels])
    assert fc.get_total_flops() == total - sum(ups) + sum(ups) * 9 // 4


@pytest.mark.parametrize("name", ["cvvae-v1", "cvvae-sd3"])
def test_full_size_operations(name):
    """2.7e14 operations a 17x720x1280 clip in either family; in v1 int8
    all but the stem, the heads and the attention's are int8."""
    cfg = load(name)
    ops = R.operations(cfg, (17, 720, 1280))
    total = sum(o for o, _ in ops)
    assert 2.6e14 < total < 2.8e14
    int8 = sum(o for o, q in ops if q)
    assert (int8 > 0.95 * total) == (cfg.precision == "int8")
