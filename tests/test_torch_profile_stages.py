"""The port's per-stage profilers (``cvvae_tpu_torch/utils/profile_stages.py``
and ``profile_stages_sd3.py``) against the JAX package's tools
(``tools/profile_stages.py``, ``tools/profile_stages_sd3.py``), on the
CPU in fp32.

JAX params come from ``VideoVAE.from_config(cfg, seed)`` and load into
the port through ``from_jax_params`` with ``strict=True``.  Tolerances:

* each prefix of the port's stages against the same prefix of the JAX
  tool's stage functions: |d| <= 1e-5 * (1 + |ref|) (fp32 convs and norms
  summing the same terms in another order);
* the stages composed against the port's own Encoder/Decoder forward:
  bit-equal (the same calls in the same order), float and int8.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cvvae_tpu.models import vae_sd3 as jsd3
from cvvae_tpu.models import vae_v1 as jv1
from cvvae_tpu.models.video_vae import VideoVAE as JVAE
from cvvae_tpu.models.video_vae import VideoVAEConfig as JConfig

from cvvae_tpu_torch.models import vae_sd3, vae_v1
from cvvae_tpu_torch.models.video_vae import VideoVAE, VideoVAEConfig
from cvvae_tpu_torch.ops import quant
from cvvae_tpu_torch.utils import profile_stages as ps
from cvvae_tpu_torch.utils import profile_stages_sd3 as ps3
from cvvae_tpu_torch.utils.convert import from_jax_params

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-5

#: family -> (JAX net config, port net config, kwargs, latent channels,
#: the port's stage module)
FAMILIES = {
    "v1": (jv1.VAE1Config, vae_v1.VAE1Config,
           dict(ch=8, ch_mult=(1, 2, 4, 4), num_res_blocks=1, z_channels=4,
                norm_num_groups=4), 4, ps),
    "sd3": (jsd3.VAESD3Config, vae_sd3.VAESD3Config,
            dict(block_out_channels=(8, 16, 16, 16), layers_per_block=1,
                 latent_channels=8, norm_num_groups=4), 8, ps3),
}
#: narrow nets whose deeper levels reach the 64 input channels that
#: quantize by default
QUANT_NETS = {"v1": dict(ch=32, ch_mult=(1, 2, 4), num_res_blocks=1,
                         z_channels=4, norm_num_groups=8),
              "sd3": dict(block_out_channels=(32, 64, 128),
                          layers_per_block=1, latent_channels=16,
                          norm_num_groups=8)}


def jax_tool(family, monkeypatch):
    """The JAX tool module, imported with ``tools/`` and the root on the
    path (``tools/profile_stages_sd3.py`` imports ``tools.profile_stages``)."""
    monkeypatch.syspath_prepend(ROOT)
    monkeypatch.syspath_prepend(os.path.join(ROOT, "tools"))
    import importlib
    return importlib.import_module(
        "profile_stages" if family == "v1" else "profile_stages_sd3")


def pair(family):
    jnet, tnet, kw, _, _ = FAMILIES[family]
    base = dict(en_de_n_frames_a_time=None, tile_spatial_size=None)
    jvae = JVAE.from_config(JConfig(family=family, net=jnet(**kw), **base),
                            seed=0)
    tvae = VideoVAE(VideoVAEConfig(family=family, net=tnet(**kw),
                                   **base)).eval()
    tvae.load_state_dict(from_jax_params(jax.tree.map(np.asarray,
                                                      jvae.params)),
                         strict=True)
    return jvae, tvae


def net_inputs(family):
    zc = FAMILIES[family][3]
    x = np.random.RandomState(0).uniform(-1, 1, (1, 5, 32, 32, 3)) \
        .astype(np.float32)
    z = np.random.RandomState(1).randn(1, 2, 4, 4, zc).astype(np.float32)
    return {"encoder": x, "decoder": z}


def stages_of(family, side, tvae):
    mod = FAMILIES[family][4]
    net = getattr(tvae, side)
    fn = mod.encoder_stages if side == "encoder" else mod.decoder_stages
    return fn(net, tvae.config.net)


CASES = [(f, s) for f in FAMILIES for s in ("encoder", "decoder")]


@pytest.mark.parametrize("family,side", CASES)
def test_stage_names_and_prefixes_match_jax(family, side, monkeypatch):
    tool = jax_tool(family, monkeypatch)
    jvae, tvae = pair(family)
    jstages = (tool.encoder_stages if side == "encoder"
               else tool.decoder_stages)(jvae.params[side],
                                         jvae.config.net)
    stages = stages_of(family, side, tvae)
    assert [n for n, _ in stages] == [n for n, _ in jstages]
    a = net_inputs(family)[side]
    h, jh = torch.from_numpy(a), jnp.asarray(a)
    with torch.inference_mode():
        for (name, fn), (_, jfn) in zip(stages, jstages):
            h, jh = fn(h), jfn(jh)
            ref = np.asarray(jh)
            assert tuple(h.shape) == ref.shape, name
            excess = np.abs(h.numpy() - ref) - TOL * (1 + np.abs(ref))
            assert excess.max() <= 0, (name, excess.max())


@pytest.mark.parametrize("family,side", CASES)
def test_composed_stages_equal_forward(family, side):
    _, tvae = pair(family)
    x = torch.from_numpy(net_inputs(family)[side])
    with torch.inference_mode():
        got = ps.compose(stages_of(family, side, tvae), x)
        ref = getattr(tvae, side)(x)
    assert torch.equal(got, ref)


@pytest.fixture
def low_threshold(monkeypatch):
    """int8 at every conv of a small input."""
    monkeypatch.setattr(quant, "INT8_MIN_POSITIONS", 1)


@pytest.mark.parametrize("family", FAMILIES)
def test_quantized_calibrated_stages_equal_forward(family, low_threshold):
    """``--quantize --calibrate``: the nets the tool builds hold int8
    weights and static activation scales, and their stages composed equal
    their forward bit for bit."""
    _, tnet, _, _, mod = FAMILIES[family]
    nets = vae_v1 if family == "v1" else vae_sd3
    cfg = tnet(**QUANT_NETS[family])
    zc = cfg.z_channels if family == "v1" else cfg.latent_channels
    enc, dec, tag = ps.build_nets(nets, cfg, torch.float32, "cpu",
                                  quantize=True, calibrate=True, frames=5,
                                  calib_size=32)
    assert tag == "fp32+int8+calib"
    quantized = [m for m in list(enc.modules()) + list(dec.modules())
                 if quant.is_quantized(m)]
    assert quantized and all(hasattr(m, "scale_x") for m in quantized)
    x, z = ps.inputs(zc, 5, 32, torch.float32, "cpu")
    with torch.inference_mode():
        for stages, net, v in ((mod.encoder_stages(enc, cfg), enc, x),
                               (mod.decoder_stages(dec, cfg), dec, z)):
            assert torch.equal(ps.compose(stages, v), net(v))


def test_time_stages_on_the_cpu():
    """Every stage and cumulative interval is reported, non-negative, the
    cumulative intervals rise, and the forward is one interval."""
    _, tvae = pair("v1")
    x = torch.from_numpy(net_inputs("v1")["encoder"])
    lines = []
    times, forward = ps.time_stages(stages_of("v1", "encoder", tvae), x, 2,
                                    lines.append)
    names = [n for n, _ in stages_of("v1", "encoder", tvae)]
    assert list(times) == [k for n in names for k in (n, f"cum/{n}")]
    cum = [times[f"cum/{n}"] for n in names]
    assert all(times[n] >= 0 for n in names) and cum == sorted(cum)
    assert forward > 0 and len(lines) == len(names) + 1


@pytest.mark.parametrize("tool", [ps, ps3])
def test_cli_refuses_cuda_without_a_card(tool):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(SystemExit, match="no CUDA device"):
        tool.main(["--tile", "16", "--frames", "1"])


def test_cli_prints_the_json_last_on_the_cpu(monkeypatch, capsys):
    """The tool's CLI on ``--device cpu`` at a small tile, with a narrow
    net in place of the full-width one: the JSON line is last and holds
    every stage of both nets."""
    import json

    monkeypatch.setattr(vae_v1, "VAE1Config",
                        lambda: FAMILIES["v1"][1](**FAMILIES["v1"][2]))
    out = ps.main(["--device", "cpu", "--dtype", "fp32", "--tile", "32",
                   "--frames", "5", "--iters", "1"])
    last = capsys.readouterr().out.strip().splitlines()[-1]
    got = json.loads(last)
    assert got == {"encoder": out["encoder"], "decoder": out["decoder"]}
    assert "enc_level3" in got["encoder"] and "dec_upsample1" in \
        got["decoder"] and set(out["forward"]) == {"encoder", "decoder"}
