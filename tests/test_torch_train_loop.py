"""The port's training loop on the CPU at a tiny size: the behaviour the
JAX package's ``test_training.py`` and ``test_trainer.py`` hold it to
(G/D alternation in every constraint mode, the discriminator warm-up,
frozen modules, EMA, learned logvars, schedules and the optimizer against
optax's semantics, fit's logs / checkpoints / image panels, resume
equivalence, best-k, validation), and ``train.main`` on the shipped YAML
with tiny overrides and seeded local data.
"""

import glob
import os

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from cvvae_tpu.training import optim as joptim

from cvvae_tpu_torch.losses.vae_loss import LossConfig
from cvvae_tpu_torch.models.discriminator import Disc3DConfig
from cvvae_tpu_torch.models.vae2d import VAE2DConfig
from cvvae_tpu_torch.models.vae_sd3 import VAESD3Config
from cvvae_tpu_torch.training import optim
from cvvae_tpu_torch.training.checkpoint import CheckpointManager
from cvvae_tpu_torch.training.engine import (EngineConfig, TrainingEngine,
                                             named_params)
from cvvae_tpu_torch.training.logging import ImageLogger
from cvvae_tpu_torch.training.trainer import Trainer

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY2D = VAE2DConfig(naming="sd3", latent_channels=4,
                     block_out_channels=(8, 8, 8, 8), layers_per_block=1,
                     norm_num_groups=4)


def tiny_engine(constraint="latent", **kw):
    loss = kw.pop("loss", {})
    cfg = EngineConfig(
        family="sd3",
        net=VAESD3Config(block_out_channels=(8, 8, 8, 8), layers_per_block=1,
                         latent_channels=4, norm_num_groups=4),
        disc=Disc3DConfig(ndf=8, n_layers=2, norm_groups=4),
        loss=LossConfig(perceptual_weight=0.0, **loss),
        optim=optim.OptimConfig(base_lr=1e-3, num_warmup_steps=0,
                                num_training_steps=100),
        constraint=constraint, constraint_decoder=TINY2D,
        constraint_encoder=TINY2D, remat=False, **kw)
    return TrainingEngine(cfg, device="cpu")


def batch(seed=1, shape=(1, 5, 16, 16, 3)):
    g = torch.Generator().manual_seed(seed)
    return {"frames": torch.randn(shape, generator=g) * 0.5}


def snapshot(module):
    return {k: v.detach().clone() for k, v in module.state_dict().items()}


def same(a, b):
    return all(torch.equal(a[k], b[k]) for k in a)


@pytest.mark.parametrize("constraint", ["none", "latent", "encoder", "all"])
def test_gd_alternation(constraint):
    eng = tiny_engine(constraint)
    st = eng.init_state(0)
    p0, d0 = snapshot(st.params), snapshot(st.disc_params)
    g = torch.Generator().manual_seed(2)
    st, m1 = eng.train_step(st, batch(), g)
    assert st.step == 1
    p1, d1 = snapshot(st.params), snapshot(st.disc_params)
    assert not same({k: v for k, v in p1.items() if k.startswith("encoder")},
                    p0)
    assert not same({k: v for k, v in p1.items() if k.startswith("decoder")},
                    p0)
    assert same(d1, d0)
    assert np.isfinite(float(m1["loss/total"])) and float(m1["loss/rec"]) > 0
    st, m2 = eng.train_step(st, batch(), g)
    assert st.step == 2
    assert same(snapshot(st.params), p1)
    assert not same(snapshot(st.disc_params), d1)
    assert float(m2["loss/disc"]) > 0


def test_logvar_learned_and_loss_decreases():
    eng = tiny_engine("latent", loss=dict(disc_start=100))
    st = eng.init_state(0)
    lv0 = float(st.params.logvar)
    losses = []
    for i in range(6):
        st, m = eng.train_step(st, batch(), torch.Generator().manual_seed(i))
        losses.append(float(m["loss/rec"]))
    assert float(st.params.logvar) != lv0 and hasattr(st.params, "logvar_2d")
    assert losses[-1] < losses[0]


def test_disc_warmup_forces_g_updates():
    """Before disc_start every step is a G step and the discriminator is
    bit-frozen (AdamW's decay would otherwise move it)."""
    eng = tiny_engine("none", loss=dict(disc_start=3))
    st = eng.init_state(0)
    d0 = snapshot(st.disc_params)
    for i in range(3):
        assert eng.is_g_step(st.step)
        st, m = eng.train_step(st, batch(), torch.Generator().manual_seed(i))
        assert float(m["loss/g"]) == 0.0 and float(m["scalars/d_weight"]) == 0
    assert same(snapshot(st.disc_params), d0)
    assert not eng.is_g_step(3)


def test_frozen_modules_not_updated():
    eng = tiny_engine("none", frozen_modules=("encoder", "logvar"))
    st = eng.init_state(0)
    p0 = snapshot(st.params)
    st, _ = eng.train_step(st, batch(), torch.Generator().manual_seed(0))
    p1 = snapshot(st.params)
    for k in p0:
        frozen = k.startswith("encoder.") or k == "logvar"
        assert torch.equal(p0[k], p1[k]) == frozen, k


def test_ema_updates():
    eng = tiny_engine("none", ema_decay=0.9)
    st = eng.init_state(0)
    s0 = {k: v.clone() for k, v in st.ema.shadow.items()}
    st, _ = eng.train_step(st, batch(), torch.Generator().manual_seed(0))
    assert st.ema.num_updates == 1
    # warm-up decay min(0.9, 2/11): the shadow moves 9/11 of the way
    named = named_params(st.params)
    for k, s in st.ema.shadow.items():
        torch.testing.assert_close(s, s0[k] + (named[k] - s0[k]) * (9 / 11),
                                   rtol=1e-5, atol=1e-6)


def test_single_frame_image_batch():
    eng = tiny_engine("latent")
    st = eng.init_state(0)
    st, m = eng.train_step(st, batch(shape=(2, 1, 16, 16, 3)),
                           torch.Generator().manual_seed(0))
    assert np.isfinite(float(m["loss/total"]))


def test_bf16_compute_is_refused():
    with pytest.raises(NotImplementedError, match="K4.bwd"):
        tiny_engine("none", compute_dtype="bfloat16")


@pytest.mark.parametrize("name", ["cosine", "linear", "polynomial",
                                  "constant", "constant_with_warmup"])
def test_schedules_match_jax(name):
    kw = dict(num_warmup_steps=10, num_training_steps=100, min_lr_ratio=0.005)
    if name in ("linear", "polynomial", "constant", "constant_with_warmup"):
        kw.pop("min_lr_ratio")
    ref = joptim.get_schedule(name, 2e-4, **kw)
    got = optim.get_schedule(name, 2e-4, **kw)
    for step in (0, 1, 5, 10, 11, 50, 99, 100, 150):
        r = float(ref(step))
        assert abs(got(step) - r) <= 1e-7 * max(abs(r), 1e-12), (step, r)


def test_lr_follows_the_global_step():
    """Both optimizers take the schedule at the global step: at step 0 of
    a warm-up the LR is 0, so a parity check there would compare nothing."""
    eng = tiny_engine("none")
    cfg = optim.OptimConfig(num_warmup_steps=4)
    sched = optim.make_schedule(cfg, 2.0)
    assert sched(0) == 0.0 and sched(2) == pytest.approx(2 * cfg.base_lr / 2)
    assert eng.lr_schedule_g(3) == pytest.approx(2 * eng.lr_schedule_d(3))


@pytest.mark.parametrize("clip", [1e-3, 1e3])
def test_adamw_matches_optax(clip):
    """The optimizer against optax's clip_by_global_norm + adamw (the JAX
    engine's make_optimizer), three steps, a 0-d parameter included, the
    clip active and not."""
    r = np.random.RandomState(0)
    params = {"w": r.randn(4, 3).astype(np.float32),
              "b": r.randn(3).astype(np.float32),
              "logvar": np.asarray(0.2, np.float32)}
    cfg = dict(base_lr=1e-2, grad_clip=clip)
    jcfg = joptim.OptimConfig(**cfg)
    jtx = joptim.make_optimizer(jcfg)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jstate = jtx.init(jp)
    opt = optim.AdamW(optim.OptimConfig(**cfg))
    tp = {k: torch.tensor(v) for k, v in params.items()}
    tstate = opt.init(tp)
    for i in range(3):
        grads = {k: np.asarray(r.randn(*np.shape(v)), np.float32)
                 for k, v in params.items()}
        lr = 1e-2 * (i + 1)
        upd, jstate = jtx.update({k: jnp.asarray(v) for k, v in grads.items()},
                                 joptim.set_learning_rate(jstate, lr), jp)
        jp = optax.apply_updates(jp, upd)
        opt.step(tp, {k: torch.tensor(v) for k, v in grads.items()}, tstate,
                 lr)
        for k in params:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                       rtol=1e-6, atol=1e-7)
    assert tstate.count == 3


def test_clip_is_optax_not_torch():
    g = {"a": torch.tensor([3.0, 4.0])}
    norm = optim.clip_by_global_norm(g, 1.0)
    assert float(norm) == 5.0
    torch.testing.assert_close(g["a"], torch.tensor([3.0, 4.0]) / 5.0,
                               rtol=0, atol=0)


def data_iter(seed=0):
    rng = np.random.RandomState(seed)
    while True:
        yield {"frames": rng.randn(1, 5, 16, 16, 3).astype(np.float32) * 0.3}


def test_fit_logs_checkpoints_and_panels(tmp_path):
    logdir = str(tmp_path / "run")
    trainer = Trainer(tiny_engine("none"), logdir, max_steps=6, ckpt_every=2,
                      permanent_every=4, image_every=4, log_every=1)
    st = trainer.fit(data_iter())
    assert st.step == 6
    rows = open(os.path.join(logdir, "metrics.csv")).read().splitlines()
    assert len(rows) >= 7 and "train/loss/total" in rows[0] \
        and "lr" in rows[0]
    assert len(glob.glob(os.path.join(logdir, "rolling", "*.pt"))) == 3
    assert glob.glob(os.path.join(logdir, "permanent", "*.pt"))
    # the early power-of-two cadence and every 4 steps
    panels = sorted(os.path.basename(p) for p in
                    glob.glob(os.path.join(logdir, "images", "*.png")))
    assert panels == [f"train_step{s:08d}.png" for s in (1, 2, 4)]
    assert [e["kind"] for e in trainer.step_log] == list("gdgdgd")


def test_resume_equivalence(tmp_path):
    """Six steps straight equal three steps, a checkpoint, and three more
    from it: the draws are keyed by the step."""
    straight = Trainer(tiny_engine("latent"), str(tmp_path / "a"),
                       max_steps=6, ckpt_every=3, image_every=0).fit(
        data_iter())
    Trainer(tiny_engine("latent"), str(tmp_path / "b"), max_steps=3,
            ckpt_every=3, image_every=0).fit(data_iter())
    it = data_iter()
    for _ in range(3):
        next(it)
    resumed = Trainer(tiny_engine("latent"), str(tmp_path / "b"), max_steps=6,
                      ckpt_every=3, image_every=0).fit(it, resume=True)
    assert resumed.step == 6
    for a, b in ((straight.params, resumed.params),
                 (straight.disc_params, resumed.disc_params)):
        assert same(snapshot(a), snapshot(b))
    assert straight.opt_g.count == resumed.opt_g.count == 3


def test_best_k_checkpointing(tmp_path):
    eng = tiny_engine("none")
    st = eng.init_state(0)
    ckpt = CheckpointManager(str(tmp_path), rolling_every=1, best_k=2)
    for step, rec in ((1, 0.5), (2, 0.3), (3, 0.9), (4, 0.1)):
        st.step = step
        ckpt.maybe_save(step, st, metrics={"train/loss/rec": rec})
    kept = sorted(int(os.path.basename(p)[5:13]) for p in
                  glob.glob(str(tmp_path / "best" / "*.pt")))
    assert kept == [2, 4] and ckpt.best_step() == 4
    fresh = eng.init_state(1)
    ckpt.restore(fresh, which="best")
    assert fresh.step == 4


def test_validate_full_metric_dict(tmp_path):
    eng = tiny_engine("latent", ema_decay=0.99)
    trainer = Trainer(eng, str(tmp_path), max_steps=2, image_every=0)
    st = trainer.fit(data_iter())
    out = trainer.validate(st, data_iter(1), st.step)
    for split in ("val", "val_ema"):
        for k in ("loss/total", "loss/rec", "loss/rec2d", "loss/disc",
                  "scalars/d_weight", "psnr_db", "ssim", "logits/real"):
            assert np.isfinite(out[f"{split}/{k}"]), (split, k)
    assert glob.glob(os.path.join(str(tmp_path), "images", "val_*.png"))


def test_image_logger_panels(tmp_path):
    import cv2
    logger = ImageLogger(str(tmp_path), every=1)
    x = np.random.RandomState(0).uniform(-1, 1, (2, 3, 8, 8, 3))
    path = logger.log(5, x, x * 0.5, logits_real=np.ones((2, 2, 2, 2, 1)),
                      logits_fake=-np.ones((2, 2, 2, 2, 1)))
    img = cv2.imread(path)
    # inputs | recon | diff | boost | two logit overlays; 6 frames wide
    assert img.shape == (6 * 8, 6 * 8, 3)


def test_scale_lr_uses_the_global_batch():
    from cvvae_tpu_torch import train
    cfg = {"data": {"train": {"datasets": {"a": {"batch_size": 4},
                                           "b": {"batch_size": 4}}}},
           "model": {"engine": {"params": {"optim": {"params": {
               "base_lr": 1e-5}}}}}}
    assert train.apply_lr_scaling(cfg, world_size=1) == pytest.approx(4e-5)
    cfg["data"]["train"]["datasets"]["b"]["batch_size"] = 2
    with pytest.raises(SystemExit, match="uniform"):
        train.apply_lr_scaling(cfg)


def test_train_main_on_the_shipped_yaml(tmp_path):
    """``python -m cvvae_tpu_torch.train`` on the shipped config with a
    narrow net and small frames, on seeded local data (a JPEG tar and cv2
    mp4 clips, as chip_smoke.py phase 8 writes them); the CPU by request."""
    import chip_smoke
    from cvvae_tpu_torch import train
    tar_dir, csv_dir, video_root = chip_smoke.write_train_data(
        str(tmp_path / "data"), seed=3, n_images=6, image_hw=(40, 48),
        n_videos=2, video_frames=12, video_hw=(40, 48))
    e = "model.engine.params."
    argv = ["--base", os.path.join(ROOT, "configs",
                                   "sd3_latent_constraint.yaml"),
            "--train", "--max_steps", "4", "--device", "cpu",
            "--logdir", str(tmp_path / "run"),
            f"{e}net.params.block_out_channels=[8,8,8,8]",
            f"{e}net.params.layers_per_block=1",
            f"{e}net.params.norm_num_groups=4",
            f"{e}disc.params.ndf=8", f"{e}disc.params.n_layers=2",
            f"{e}disc.params.norm_groups=4",
            f"{e}constraint_decoder.params.block_out_channels=[8,8,8,8]",
            f"{e}constraint_decoder.params.layers_per_block=1",
            f"{e}constraint_decoder.params.norm_num_groups=4",
            f"{e}loss.params.perceptual_weight=0.0", f"{e}remat=false",
            f"data.train.datasets.image_webdata.urls_or_dir={tar_dir}",
            "data.train.datasets.image_webdata.batch_size=2",
            "data.train.datasets.image_webdata.decoder.params.size=32",
            f"data.train.datasets.webvid.urls_or_dir={csv_dir}",
            "data.train.datasets.webvid.decoder.params.num_frames=5",
            "data.train.datasets.webvid.decoder.params.resize=40",
            "data.train.datasets.webvid.decoder.params.crop_size=32",
            f"data.train.datasets.webvid.decoder.params.video_root="
            f"{video_root}",
            "trainer.ckpt_every=2", "trainer.image_every=0"]
    trainer, state = train.main(argv)
    assert state.step == 4
    shapes = {e["shape"] for e in trainer.step_log}
    assert shapes <= {(2, 1, 32, 32, 3), (1, 5, 32, 32, 3)}
    assert all(np.isfinite(v) for e in trainer.step_log
               for v in e["metrics"].values())
    fresh = trainer.engine.init_state(9)
    CheckpointManager(str(tmp_path / "run")).restore(fresh)
    assert fresh.step == 4 and same(snapshot(fresh.params),
                                    snapshot(state.params))


def test_loading_a_state_copies_it():
    """A step after ``load_state_dict`` leaves the loaded dict as it was
    (on the CPU, ``Tensor.to`` would otherwise hand back the same
    tensors and the optimizer's in-place update would write into it)."""
    eng = tiny_engine("none")
    st = eng.init_state(0)
    st, _ = eng.train_step(st, batch(), torch.Generator().manual_seed(0))
    blob = st.state_dict()
    saved = {k: v.clone() for k, v in blob["opt_g"]["mu"].items()}
    other = eng.init_state(1).load_state_dict(
        {**blob, "opt_g": {**blob["opt_g"],
                           "mu": dict(blob["opt_g"]["mu"])}})
    other.step = 2
    eng.train_step(other, batch(), torch.Generator().manual_seed(1))
    assert all(torch.equal(blob["opt_g"]["mu"][k], v)
               for k, v in saved.items())


def test_v1_trains_on_the_cpu():
    """The v1 family with the SD2.1-named constraint decoder: a G and a D
    step on the CPU (on the card it stops at K3's refusal until K3.bwd)."""
    from cvvae_tpu_torch.models.vae_v1 import VAE1Config
    cfg = EngineConfig(
        family="v1",
        net=VAE1Config(ch=8, ch_mult=(1, 2, 4, 4), num_res_blocks=1,
                       z_channels=4, norm_num_groups=4, dropout=0.1),
        disc=Disc3DConfig(ndf=8, n_layers=2, norm_groups=4),
        loss=LossConfig(perceptual_weight=0.0),
        optim=optim.OptimConfig(num_warmup_steps=0, num_training_steps=10),
        constraint="latent",
        constraint_decoder=VAE2DConfig(naming="sd21", latent_channels=4,
                                       block_out_channels=(8, 8, 8, 8),
                                       layers_per_block=1, norm_num_groups=4,
                                       legacy_quant_conv=True))
    eng = TrainingEngine(cfg, device="cpu")
    st = eng.init_state(0)
    p0 = snapshot(st.params)
    for i in range(2):
        st, m = eng.train_step(st, batch(), torch.Generator().manual_seed(i))
        assert all(np.isfinite(float(v)) for v in m.values())
    assert not same(snapshot(st.params), p0)


def test_validate_tiled_full_res(tmp_path):
    eng = tiny_engine("none")
    trainer = Trainer(eng, str(tmp_path), max_steps=1, image_every=0)
    st = eng.init_state(0)

    def clips():
        rng = np.random.RandomState(1)
        while True:
            yield {"frames": rng.randn(1, 5, 56, 56, 3).astype(np.float32)
                   * 0.3}

    # 56 px, 32-px tiles, overlap 0.25: an exact two-tile grid on both the
    # pixel (24 + 32) and the latent (3 + 4) sides, as the JAX test's
    out = trainer.validate_tiled(st, clips(), 0, tile_spatial_size=32,
                                 tile_overlap_ratio=0.25)
    assert {"val_tiled/psnr_db", "val_tiled/ssim", "val_tiled/l1"} <= set(out)
    assert all(np.isfinite(v) for v in out.values())


def test_sigusr1_writes_a_checkpoint(tmp_path):
    """SIGUSR1 during fit checkpoints at the next step's end ("melk")."""
    import signal

    def on_step(entry):
        if entry["step"] == 1:
            os.kill(os.getpid(), signal.SIGUSR1)

    trainer = Trainer(tiny_engine("none"), str(tmp_path), max_steps=3,
                      ckpt_every=1000, permanent_every=0, image_every=0,
                      step_callback=on_step)
    trainer.fit(data_iter())
    assert trainer.ckpt.latest_step() == 2
