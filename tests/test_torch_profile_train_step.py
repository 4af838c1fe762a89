"""The port's training-step profiler
(``cvvae_tpu_torch/utils/profile_train_step.py``) against the JAX
package's tool (``tools/profile_train_step.py``), on the CPU.

The JAX tool's ``EngineConfig`` is captured by replacing
``cvvae_tpu.training.engine.TrainingEngine`` with a stub that records its
arguments and stops, so no JAX engine is compiled; the port's must equal
it field by field (``donate_state`` has no torch counterpart).  Then one
G + D pair of the tool's procedure runs on ``--device cpu`` at a narrow
config and tiny batches.
"""

import dataclasses
import os
import sys

import pytest
import torch

from cvvae_tpu_torch.models.discriminator import Disc3DConfig
from cvvae_tpu_torch.models.vae2d import VAE2DConfig
from cvvae_tpu_torch.models.vae_sd3 import VAESD3Config
from cvvae_tpu_torch.utils import profile_train_step as pts

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

ARGVS = [[], ["--no-remat"], ["--perceptual"], ["--compute", "bfloat16"],
         ["--perceptual", "--no-remat", "--compute", "bfloat16"]]


class _Stop(Exception):
    pass


def jax_engine_config(argv, monkeypatch):
    """The (EngineConfig, kwargs) the JAX tool builds its engine from."""
    import cvvae_tpu.training.engine as jengine
    import cvvae_tpu.utils.profiling as jprof

    monkeypatch.syspath_prepend(os.path.join(ROOT, "tools"))
    import importlib
    tool = importlib.import_module("profile_train_step")
    seen = {}

    def stub(cfg, **kw):
        seen.update(cfg=cfg, kw=kw)
        raise _Stop

    monkeypatch.setattr(jengine, "TrainingEngine", stub)
    monkeypatch.setattr(jprof, "enable_compilation_cache", lambda: None)
    monkeypatch.setattr(sys, "argv", ["profile_train_step.py"] + argv)
    with pytest.raises(_Stop):
        tool.main()
    return seen["cfg"], seen["kw"]


def as_dict(cfg):
    return {f.name: (as_dict(getattr(cfg, f.name))
                     if dataclasses.is_dataclass(getattr(cfg, f.name))
                     else getattr(cfg, f.name))
            for f in dataclasses.fields(cfg)}


@pytest.mark.parametrize("argv", ARGVS, ids=[" ".join(a) or "defaults"
                                             for a in ARGVS])
def test_engine_config_equals_the_jax_tools(argv, monkeypatch):
    jcfg, jkw = jax_engine_config(argv, monkeypatch)
    seen = {}

    def record(cfg, batches, **kw):
        seen.update(cfg=cfg, batches=batches, kw=kw)
        return {}

    monkeypatch.setattr(pts, "profile_steps", record)
    pts.main(argv + ["--device", "cpu", "--image_size", "16",
                     "--video_size", "16", "--video_frames", "5"])
    got, want = as_dict(seen["cfg"]), as_dict(jcfg)
    assert want.pop("donate_state") is True
    assert got == want
    assert seen["kw"]["allow_random_lpips"] == jkw["allow_random_lpips"] \
        == ("--perceptual" in argv)
    assert {k: tuple(v.shape) for k, v in seen["batches"].items()} == {
        "image_bs8_16px": (8, 1, 16, 16, 3),
        "video_1x5f_16px": (1, 5, 16, 16, 3)}


def test_batches_are_the_jax_tools_shapes_and_scale():
    b = pts.make_batches(device="cpu")
    assert {k: tuple(v.shape) for k, v in b.items()} == {
        "image_bs8_320px": (8, 1, 320, 320, 3),
        "video_1x17f_256px": (1, 17, 256, 256, 3)}
    for v in b.values():
        assert abs(v.std().item() - 0.3) < 0.01 and v.dtype == torch.float32
    again = pts.make_batches(device="cpu")
    assert all(torch.equal(b[k], again[k]) for k in b)


def test_one_pair_of_steps_on_the_cpu():
    """The tool's procedure, narrow: each batch kind's first G and D step,
    a steady pair, a profiled G and D step (without Python stacks, which
    take minutes on the CPU); the lines it prints."""
    tiny2d = VAE2DConfig(naming="sd3", latent_channels=4,
                         block_out_channels=(8, 8, 8, 8), layers_per_block=1,
                         norm_num_groups=4)
    cfg = dataclasses.replace(
        pts.engine_config(remat=True, perceptual=True),
        net=VAESD3Config(block_out_channels=(8, 8, 8, 8), layers_per_block=1,
                         latent_channels=4, norm_num_groups=4),
        disc=Disc3DConfig(ndf=8, n_layers=2, norm_groups=4),
        constraint_decoder=tiny2d)
    batches = pts.make_batches(2, 16, 5, 16, "cpu")
    lines = []
    out = pts.profile_steps(cfg, batches, iters=1, allow_random_lpips=True,
                            device="cpu", stacks=False, log=lines.append)
    assert list(out) == list(batches)
    for name, r in out.items():
        for k in ("g_first_s", "d_first_s", "pair_s", "steps_per_s", "g_s",
                  "d_s", "g_host_s", "d_host_s"):
            assert r[k] > 0, (name, k)
        assert r["memory"] == {}
        for kind in ("G", "D"):
            p = r[kind]
            assert p["wall_s"] > 0 and p["kernel_s"] == 0.0
            assert set(p["counts"]) == set(pts.profiling.COUNTERS)
            assert not any(p["counts"].values())
        assert any(line.startswith(f"{name}: steady G+D pair")
                   for line in lines)
    assert sum("G first step" in line for line in lines) == 2


def test_cli_refuses_cuda_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(SystemExit, match="no CUDA device"):
        pts.main([])
