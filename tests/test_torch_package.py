"""Package-level contracts of the PyTorch port.

* importing it pulls in no JAX (checked in a subprocess: this process has
  JAX loaded by conftest), nor ``transformers``, which the demo's script
  needs only with a text encoder;
* ``from_jax_params`` yields exactly the modules' state_dict keys and
  shapes;
* on a CPU tensor every kernel wrapper takes its plain version and its
  launch counter stays 0; any other non-CUDA device is refused.
"""

import os
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

import jax

from cvvae_tpu.models.vae_v1 import VAE1Config as JNet
from cvvae_tpu.models.video_vae import VideoVAE as JVAE
from cvvae_tpu.models.video_vae import VideoVAEConfig as JConfig

from cvvae_tpu_torch.models.vae_v1 import VAE1Config
from cvvae_tpu_torch.models.video_vae import VideoVAE, VideoVAEConfig
from cvvae_tpu_torch.ops.conv import Conv3DSpec
from cvvae_tpu_torch.ops.kernels import (_build, attention, conv_int8,
                                         groupnorm, shuffle, stem)
from cvvae_tpu_torch.utils.convert import from_jax_params

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(ch=8, ch_mult=(1, 2, 4, 4), num_res_blocks=1, z_channels=4,
            norm_num_groups=4)


def test_import_pulls_in_no_jax():
    code = ("import sys\n"
            "import cvvae_tpu_torch, cvvae_tpu_torch.serve, cvvae_tpu_torch.cli\n"
            "import cvvae_tpu_torch.data.video_io, cvvae_tpu_torch.utils.convert\n"
            "import cvvae_tpu_torch.models.video_vae, "
            "cvvae_tpu_torch.utils.profiling\n"
            "import cvvae_tpu_torch.streaming, cvvae_tpu_torch.data.pipeline\n"
            "import cvvae_tpu_torch.utils.metrics, "
            "cvvae_tpu_torch.utils.verify_checkpoints, "
            "cvvae_tpu_torch.utils.bench_streaming\n"
            "import cvvae_tpu_torch.pipelines.diffusion, "
            "cvvae_tpu_torch.models.unet2d, cvvae_tpu_torch.models.clip_text\n"
            "import cvvae_tpu_torch.scripts.sd21_vae3d_inference\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'cvvae_tpu' or "
            "m.startswith('cvvae_tpu.'))\n"
            "assert not bad, bad\n"
            "assert 'transformers' not in sys.modules\n"
            "print('clean')\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "clean"


@pytest.mark.parametrize("net", [
    TINY,
    dict(TINY, use_3d_conv=False, attn_resolutions=(256, 128)),
    dict(TINY, num_res_blocks=2, z_channels=8, double_z=False),
])
def test_from_jax_params_matches_state_dict(net):
    jvae = JVAE.from_config(JConfig(family="v1", net=JNet(**net),
                                    tile_spatial_size=None), seed=0)
    state = from_jax_params(jax.tree.map(np.asarray, jvae.params))
    module = VideoVAE(VideoVAEConfig(family="v1", net=VAE1Config(**net),
                                     tile_spatial_size=None))
    expected = {k: tuple(v.shape) for k, v in module.state_dict().items()}
    assert {k: tuple(v.shape) for k, v in state.items()} == expected
    module.load_state_dict(state, strict=True)


def test_from_jax_params_layouts():
    conv = np.arange(3 * 3 * 3 * 2 * 5, dtype=np.float32).reshape(3, 3, 3, 2, 5)
    frame = np.arange(3 * 3 * 2 * 5, dtype=np.float32).reshape(1, 3, 3, 2, 5)
    dense = np.arange(6, dtype=np.float32).reshape(2, 3)
    out = from_jax_params({"a": {"kernel": conv, "bias": np.zeros(5)},
                           "b": [{"kernel": frame}],
                           "c": {"kernel": dense},
                           "n": {"scale": np.ones(4), "bias": np.zeros(4)}})
    assert torch.equal(out["a.weight"],
                       torch.from_numpy(conv.transpose(4, 3, 0, 1, 2).copy()))
    assert tuple(out["b.0.weight"].shape) == (5, 2, 1, 3, 3)
    assert torch.equal(out["c.weight"], torch.from_numpy(dense.T.copy()))
    assert set(out) == {"a.weight", "a.bias", "b.0.weight", "c.weight",
                        "n.weight", "n.bias"}
    q = from_jax_params({"x": {"kernel_q": conv.astype(np.int8),
                               "scale_w": np.ones(5, np.float32),
                               "scale_x": np.float32(0.5)}})
    assert torch.equal(q["x.weight_q"], torch.from_numpy(
        conv.astype(np.int8).transpose(4, 3, 0, 1, 2).copy()))
    assert set(q) == {"x.weight_q", "x.scale_w", "x.scale_x"}
    with pytest.raises(ValueError, match="unexpected leaf"):
        from_jax_params({"x": {"kernel_x": conv}})
    with pytest.raises(ValueError, match="rank"):
        from_jax_params({"x": {"kernel": np.zeros((2, 2, 2))}})


def _randn(shape, seed):
    return torch.from_numpy(np.random.RandomState(seed).randn(*shape)
                            .astype(np.float32))


def _calls():
    x = _randn((1, 3, 4, 5, 16), 0)
    w, b = _randn((16,), 1), _randn((16,), 2)
    phases = [_randn((1, 2, 3, 4, 16), 3 + i) for i in range(4)]
    spec = Conv3DSpec.v1_causal()
    pix = _randn((1, 3, 6, 7, 3), 8)
    sw, sb = _randn((128, 3, 3, 3, 3), 9), _randn((128,), 10)
    q, k, v = (_randn((2, 1100, 64), 11 + i) for i in range(3))
    xq = _randn((1, 3, 5, 7, 32), 14)
    wq = torch.from_numpy(np.random.RandomState(15).randint(
        -127, 128, (16, 32, 3, 3, 3)).astype(np.int8))
    qsw, qsx = _randn((16,), 16).abs() / 127, torch.tensor(0.02)
    pads, modes = ((2, 0), (1, 1), (1, 1)), ("edge", "zero", "zero")
    return [
        (groupnorm, lambda t: groupnorm.group_norm_silu(
            t(x), w, b, num_groups=4, eps=1e-5, silu=True),
         lambda: groupnorm.group_norm_silu_plain(
             x, w, b, num_groups=4, eps=1e-5, silu=True)),
        (groupnorm, lambda t: groupnorm.group_norm_silu(
            t(x), w, b, num_groups=4, eps=1e-5, per_frame=True),
         lambda: groupnorm.group_norm_silu_plain(
             x, w, b, num_groups=4, eps=1e-5, per_frame=True)),
        (shuffle, lambda t: shuffle.subpixel_interleave(
            [t(p) for p in phases], w, n=2),
         lambda: shuffle.subpixel_interleave_plain(phases, w, n=2)),
        (stem, lambda t: stem.stem_conv3d(t(pix), sw, sb, spec),
         lambda: stem.stem_conv3d_plain(pix, sw, sb, spec)),
        (attention, lambda t: attention.flash_attention(t(q), t(k), t(v),
                                                        0.125),
         lambda: attention.flash_attention_plain(q, k, v, 0.125)),
        (conv_int8, lambda t: conv_int8.conv3d_int8(
            t(xq), wq, qsw, qsx, w, (1, 1, 1), pads, modes),
         lambda: conv_int8.conv3d_int8_plain(xq, wq, qsw, qsx, w, (1, 1, 1),
                                             pads, modes)),
    ]


@pytest.mark.parametrize("case", range(6))
def test_cpu_tensor_takes_plain_version(case):
    mod, wrapped, plain = _calls()[case]
    before = mod.launches
    got = wrapped(lambda v: v)
    assert mod.launches == before == 0
    assert torch.equal(got, plain())


@pytest.mark.parametrize("case", range(6))
def test_other_devices_are_refused(case):
    """Neither CPU nor CUDA: the wrapper raises before any launch."""
    mod, wrapped, _ = _calls()[case]
    with pytest.raises(ValueError, match="CUDA tensor"):
        wrapped(lambda v: v.to("meta"))
    assert mod.launches == 0


def test_nothing_is_built_at_import():
    assert _build._current is None
    assert _build._load.cache_info().currsize == 0
    assert _build.BUILD_ROOT.parent.name == "build"
    assert {p.name for p in _build._sources()} == {
        "attention.cu", "attention_bwd.cu", "common.cuh", "conv_int8.cu", "groupnorm.cu",
        "groupnorm_bwd.cu", "hopper.cuh", "qflow.cu", "shuffle.cu",
        "shuffle_bwd.cu", "stem.cu", "stem_bwd.cu"}
    assert set(_build._SIGNATURES) == {
        "cvvae_group_norm", "cvvae_group_norm_partial",
        "cvvae_group_norm_combine", "cvvae_group_norm_partial_pair",
        "cvvae_group_norm_combine_pair", "cvvae_subpixel_interleave",
        "cvvae_stem_conv3d",
        "cvvae_flash_attention", "cvvae_int8_stage", "cvvae_int8_gemm",
        "cvvae_group_norm_bwd", "cvvae_subpixel_interleave_bwd",
        "cvvae_stem_conv3d_bwd", "cvvae_flash_attention_bwd",
        "cvvae_group_norm_int8", "cvvae_qflow_requant", "cvvae_qflow_add"}


def test_layout_check_names_the_fix():
    x = types.SimpleNamespace(device=torch.device("cuda"), dtype=torch.float16,
                              ndim=5)
    with pytest.raises(ValueError, match="dtype"):
        _build.require_cuda_layout("k", x, 5)


def test_training_modules_pull_in_no_jax():
    code = ("import sys\n"
            "import cvvae_tpu_torch.train, cvvae_tpu_torch.training.engine\n"
            "import cvvae_tpu_torch.training.trainer, "
            "cvvae_tpu_torch.training.checkpoint\n"
            "import cvvae_tpu_torch.losses.regularizers, "
            "cvvae_tpu_torch.models.vae2d\n"
            "import cvvae_tpu_torch.models.discriminator, "
            "cvvae_tpu_torch.models.lpips\n"
            "import cvvae_tpu_torch.data.decoders, "
            "cvvae_tpu_torch.utils.config\n"
            "import cvvae_tpu_torch.parallel.data\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'cvvae_tpu' or "
            "m.startswith('cvvae_tpu.') or m == 'optax')\n"
            "assert not bad, bad\n"
            "assert 'transformers' not in sys.modules\n"
            "print('clean')\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "clean"


def _targets(node):
    if isinstance(node, dict):
        for k, v in node.items():
            if k == "target":
                yield v
            else:
                yield from _targets(v)
    elif isinstance(node, list):
        for v in node:
            yield from _targets(v)


def test_shipped_config_targets_resolve_to_the_port():
    from cvvae_tpu_torch.utils.config import (get_obj_from_str,
                                              instantiate_from_config,
                                              load_configs, resolve_target)
    cfg = load_configs([os.path.join(ROOT, "configs",
                                     "sd3_latent_constraint.yaml")])
    targets = sorted(set(_targets(cfg)))
    assert len(targets) >= 8
    for t in targets:
        assert t.startswith("cvvae_tpu."), t
        obj = get_obj_from_str(t)
        assert obj.__module__.startswith("cvvae_tpu_torch."), (t, obj)
        assert resolve_target(t) == "cvvae_tpu_torch." + t[len("cvvae_tpu."):]
    engine = instantiate_from_config(cfg["model"]["engine"])
    assert type(engine).__module__ == "cvvae_tpu_torch.training.engine"
    assert engine.net.block_out_channels == (128, 256, 512, 512)


def test_engine_runs_on_the_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    from cvvae_tpu_torch.training.engine import EngineConfig, TrainingEngine
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TrainingEngine(EngineConfig(constraint="none"))
