"""``train.py``'s frozen checkpoints and warm start, the port's against the
JAX package's, on checkpoints written here in the reference's layout
(``chip_smoke.reference_layout``) and an LPIPS blob written by
``utils/convert_lpips.py`` from seeded random VGG16 and lin weights.

Where the two packages agree, the port computes JAX's function: the frozen
2D decoder (with and without ``legacy_quant_conv``) and the encoder-only
constraint encoder give JAX's frozen nets' outputs on the same inputs
(within FROZEN_RTOL x max|ref|: fp32 convs summed in other orders), and
one ``train.main --max_steps 1`` with ``frozen_ckpts`` (LPIPS, the
constraint decoder) and ``ckpt_path`` warm-starts the same parameters
(bit-equal) and takes a first step whose metrics are JAX's within the
engine parity tests' bounds (``torch_train_parity.check_metrics``: relative
1e-4, atol 1e-6).  The rest of the state (the discriminator, the
optimizers, the parameters the checkpoint lacks) is handed over from JAX
as ``tests/torch_train_parity.py`` does, with JAX's draws; JAX's
``Trainer.fit`` is patched here to hand back the state its ``main`` built.

Where the JAX package departs, the port keeps its own decision, and each
is shown: a whole-VAE checkpoint as the constraint encoder (JAX installs
the decoder's tree and raises at the first forward; the port loads
``encoder.*`` and trains); a warm-start subtree with a missing or an extra
key and a checkpoint sharing no subtree with the params (refused with a
ValueError naming the keys; JAX fails at the first forward on the first,
trains from init on the second).
"""

import functools
import os
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cvvae_tpu import train as jtrain
from cvvae_tpu.models import vae2d as jvae2d
from cvvae_tpu.models.vae2d import VAE2DConfig as J2D
from cvvae_tpu.training import trainer as jtrainer
from cvvae_tpu.utils import profiling as jprofiling

import chip_smoke
import torch_train_parity as tp
from cvvae_tpu_torch import train
from cvvae_tpu_torch.models import lpips as tlpips
from cvvae_tpu_torch.models.vae2d import Decoder2D, Encoder2D, VAE2DConfig
from cvvae_tpu_torch.training import trainer as ttrainer
from cvvae_tpu_torch.training.engine import EngineConfig, VAEParams
from cvvae_tpu_torch.utils import convert_lpips
from cvvae_tpu_torch.utils.config import instantiate_from_config, load_configs
from cvvae_tpu_torch.utils.convert import (from_jax_params,
                                           from_jax_train_state,
                                           load_torch_checkpoint_file)

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHIPPED = os.path.join(ROOT, "configs", "sd3_latent_constraint.yaml")
#: a frozen net's output against JAX's: max|d| <= FROZEN_RTOL * max|ref|
FROZEN_RTOL = 1e-5
#: the tiny SD2.1-named 2D VAE of the frozen-net cases
NET2D = dict(naming="sd21", latent_channels=4,
             block_out_channels=(8, 8, 8, 8), layers_per_block=1,
             norm_num_groups=4)
E = "model.engine.params."
#: the shipped YAML cut to the engine parity tests' tiny nets
TINY = [f"{E}net.params.block_out_channels=[8,8,8,8]",
        f"{E}net.params.layers_per_block=1",
        f"{E}net.params.norm_num_groups=4",
        f"{E}net.params.latent_channels=4",
        f"{E}disc.params.ndf=8", f"{E}disc.params.n_layers=2",
        f"{E}disc.params.norm_groups=4",
        f"{E}constraint_decoder.params.block_out_channels=[8,8,8,8]",
        f"{E}constraint_decoder.params.layers_per_block=1",
        f"{E}constraint_decoder.params.norm_num_groups=4",
        f"{E}constraint_decoder.params.latent_channels=4",
        f"{E}optim.params.base_lr=1.0e-3",
        f"{E}optim.params.num_warmup_steps=0",
        f"{E}optim.params.num_training_steps=100",
        f"{E}remat=false"]


def _save(path, state):
    torch.save({"state_dict": state}, path)
    return str(path)


def write_2d_vae(path, legacy, seed=7):
    """A whole SD2.1-named 2D VAE checkpoint in the reference's layout:
    ``encoder.*``, ``decoder.*`` and, with ``legacy``, the top-level
    ``quant_conv`` / ``post_quant_conv`` that AutoencoderKL keeps outside
    both prefixes.  Returns (path, the port's decoder, its encoder)."""
    cfg = VAE2DConfig(legacy_quant_conv=legacy, **NET2D)
    g = torch.Generator().manual_seed(seed)
    dec, enc = Decoder2D(cfg, g), Encoder2D(cfg, g)
    state = {}
    for prefix, net, conv in (("decoder", dec, "post_quant_conv"),
                              ("encoder", enc, "quant_conv")):
        for k, v in net.state_dict().items():
            state[k if k.startswith(conv + ".") else f"{prefix}.{k}"] = v
    return _save(path, chip_smoke.reference_layout(state)), dec, enc


def model_cfg(constraint, legacy, **frozen):
    """The ``model`` section of a config: the shipped engine cut to the
    tiny nets, the 2D nets SD2.1-named, ``frozen_ckpts`` as given."""
    net2d = {"target": "cvvae_tpu.models.vae2d.VAE2DConfig",
             "params": dict(NET2D, block_out_channels=[8, 8, 8, 8],
                            legacy_quant_conv=legacy)}
    cfg = load_configs([SHIPPED], TINY)["model"]
    params = cfg["engine"]["params"]
    params.update(constraint=constraint, constraint_decoder=net2d,
                  constraint_encoder=net2d)
    params["loss"]["params"]["perceptual_weight"] = 0.0
    params["net"]["params"]["latent_channels"] = 4
    cfg["frozen_ckpts"] = frozen
    return cfg


def _held(got, ref):
    ref = np.asarray(ref, np.float32)
    err = float(np.abs(got.detach().numpy() - ref).max())
    assert err <= FROZEN_RTOL * float(np.abs(ref).max()), err


def _inputs(shape, seed):
    return np.random.RandomState(seed).uniform(-1, 1, shape).astype(
        np.float32)


@pytest.mark.parametrize("legacy", [True, False],
                         ids=["legacy_quant_conv", "plain"])
def test_frozen_decoder_matches_jax(tmp_path, capsys, legacy):
    """The frozen decoder of a whole-VAE checkpoint: with
    ``legacy_quant_conv`` the checkpoint's top-level ``post_quant_conv``
    lies outside ``decoder.``, so JAX's frozen tree lacks it and its
    decoder runs without it; the port builds the net without it and says
    so, and both give the same frames."""
    path, _, _ = write_2d_vae(tmp_path / "vae2d.ckpt", legacy)
    cfg = model_cfg("latent", legacy, constraint_decoder=path)
    engine, _ = train.build_engine(cfg, device="cpu")
    out = capsys.readouterr().out
    net = engine.frozen["constraint_decoder"]
    assert hasattr(net, "post_quant_conv") is False
    assert ("has no post_quant_conv" in out) is legacy
    assert engine.left_out == ({"constraint_decoder": "post_quant_conv"}
                               if legacy else {})
    jeng, _ = jtrain.build_engine(cfg)
    tree = jeng.frozen["constraint_decoder"]
    assert "post_quant_conv" not in tree
    z = _inputs((1, 2, 4, 4, 4), 3)
    with torch.no_grad():
        got = net(torch.from_numpy(z))
    _held(got, jvae2d.apply_decoder2d(tree, jnp.asarray(z),
                                      J2D(legacy_quant_conv=legacy,
                                          **NET2D)))


@pytest.mark.parametrize("whole", [False, True],
                         ids=["encoder_only", "whole_vae"])
def test_constraint_encoder(tmp_path, whole):
    """The frozen constraint encoder.  From an encoder-only checkpoint
    both packages install the encoder and give the same moments.  From a
    whole 2D VAE, JAX installs ``tree.get("decoder") or
    tree.get("encoder")``, the decoder's tree, and raises at the first
    forward; the port loads ``encoder.*``, gives the moments of the
    checkpoint's encoder and trains."""
    path, _, _ = write_2d_vae(tmp_path / "vae2d.ckpt", True)
    if not whole:
        state = torch.load(path, weights_only=False)["state_dict"]
        path = _save(tmp_path / "enc.ckpt", {
            k: v for k, v in state.items()
            if k.startswith(("encoder.", "quant_conv."))})
    cfg = model_cfg("encoder", True, constraint_encoder=path)
    engine, _ = train.build_engine(cfg, device="cpu")
    net = engine.frozen["constraint_encoder"]
    assert not hasattr(net, "quant_conv")   # top-level, outside encoder.
    x = _inputs((1, 2, 16, 16, 3), 4)
    with torch.no_grad():
        got = net(torch.from_numpy(x))
    j2d = J2D(legacy_quant_conv=True, **NET2D)
    jeng, _ = jtrain.build_engine(cfg)
    installed = jeng.frozen["constraint_encoder"]
    encoder_tree = load_torch_checkpoint_file_jax(path)["encoder"]
    _held(got, jvae2d.apply_encoder2d(encoder_tree, jnp.asarray(x), j2d))
    if whole:
        # the decoder's conv_in (4 -> 8 channels) meets the frames
        with pytest.raises(ValueError, match="feature dimension"):
            jvae2d.apply_encoder2d(installed, jnp.asarray(x), j2d)
        st = engine.init_state(0)
        clip = torch.from_numpy(_inputs(tp.CLIP, 5))
        st, m = engine.train_step(st, {"frames": clip},
                                  torch.Generator().manual_seed(0))
        assert st.step == 1 and m["loss/rec"].item() > 0
        assert all(np.isfinite(float(v)) for v in m.values())
    else:
        _held(got, jvae2d.apply_encoder2d(installed, jnp.asarray(x), j2d))


def load_torch_checkpoint_file_jax(path):
    from cvvae_tpu.utils.convert import load_torch_checkpoint_file as jload
    return jload(path, prefixes=("decoder", "encoder"))[0]


def _engine_cfg():
    return instantiate_from_config(load_configs([SHIPPED], TINY)["model"]
                                   ["engine"])


def write_warm_start(path, seed=11, edit=None):
    """A 3D VAE checkpoint in the reference's layout, from the port's
    generator params at the tiny shipped config (``encoder.*``,
    ``decoder.*``; no logvars), ``edit`` applied to its state dict first.
    Returns (path, the params it came from)."""
    cfg = _engine_cfg()
    assert isinstance(cfg, EngineConfig)
    src = VAEParams(cfg, torch.Generator().manual_seed(seed))
    state = {k: v for k, v in src.state_dict().items()
             if k.startswith(("encoder.", "decoder."))}
    if edit is not None:
        state = edit(state)
    return _save(path, chip_smoke.reference_layout(state)), src


def test_warm_start_loads_the_checkpoints_subtrees_exactly(tmp_path, capsys):
    path, src = write_warm_start(tmp_path / "warm.ckpt")
    params = VAEParams(_engine_cfg(), torch.Generator().manual_seed(0))
    init = {k: v.clone() for k, v in params.state_dict().items()}
    tree, _ = load_torch_checkpoint_file(path)
    assert train.warm_start(params, tree, path) == ["decoder", "encoder"]
    want = src.state_dict()
    for k, v in params.state_dict().items():
        ref = want[k] if k.startswith(("encoder.", "decoder.")) else init[k]
        assert torch.equal(v, ref), k


def _drop_one(state):
    state = dict(state)
    del state["decoder.conv_in.bias"]
    return state


def _add_one(state):
    return dict(state, **{"decoder.conv_extra.weight": torch.zeros(2, 2)})


def _rename(state):
    return {f"first_stage_model.{k}": v for k, v in state.items()}


@pytest.mark.parametrize("edit,names", [
    (_drop_one, ["subtree 'decoder'", "missing ['decoder.conv_in.bias']",
                 "extra []"]),
    (_add_one, ["subtree 'decoder'", "missing []",
                "extra ['decoder.conv_extra.weight']"]),
    (_rename, ["shares no top-level subtree", "it has []",
               "the params ['decoder', 'encoder', 'logvar', 'logvar_2d']"]),
], ids=["missing_key", "extra_key", "no_shared_subtree"])
def test_warm_start_refuses_what_jax_cannot_run(tmp_path, edit, names):
    path, _ = write_warm_start(tmp_path / "warm.ckpt", edit=edit)
    params = VAEParams(_engine_cfg(), torch.Generator().manual_seed(0))
    before = {k: v.clone() for k, v in params.state_dict().items()}
    tree, _ = load_torch_checkpoint_file(path)
    with pytest.raises(ValueError) as err:
        train.warm_start(params, tree, path)
    for name in names:
        assert name in str(err.value), (name, str(err.value))
    after = params.state_dict()
    assert all(torch.equal(after[k], v) for k, v in before.items())


def _lpips_blob(tmp_path):
    """The LPIPS blob ``convert_lpips`` writes from seeded random VGG16 and
    lin-head checkpoints."""
    net = tlpips.init_lpips(torch.Generator().manual_seed(5))
    vgg = {f"features.{i}.{p}": getattr(conv, p).detach().clone()
           for conv, i in zip(net.vgg, tlpips.VGG_CONV_INDICES)
           for p in ("weight", "bias")}
    lins = {f"lin{k}.model.1.weight": lin.weight.detach().clone()
            for k, lin in enumerate(net.lins)}
    paths = [str(tmp_path / n) for n in ("vgg16.pth", "vgg.pth", "blob.pth")]
    torch.save(vgg, paths[0])
    torch.save(lins, paths[1])
    convert_lpips.convert(*paths, check_md5=False)
    return paths[2]


@pytest.fixture(scope="module")
def mains(tmp_path_factory):
    """``train.main`` of each package on the shipped YAML cut to the tiny
    nets, with frozen LPIPS (``convert_lpips``'s blob, perceptual weight
    0.5), a frozen SD3-named constraint decoder and a warm start, the
    data one fixed clip.  JAX's ``Trainer.fit`` hands back the state its
    main built; JAX's first step runs on it.  The port's main runs one
    step from that state with its warm-started subtrees checked against
    JAX's first and JAX's draws handed in."""
    tmp = tmp_path_factory.mktemp("mains")
    mp = pytest.MonkeyPatch()
    try:
        cfg = _engine_cfg()
        g = torch.Generator().manual_seed(13)
        dec = Decoder2D(cfg.constraint_decoder, g)
        dec_path = str(tmp / "decoder.safetensors")
        from safetensors.torch import save_file
        save_file(chip_smoke.reference_layout(
            {f"decoder.{k}": v for k, v in dec.state_dict().items()}),
            dec_path)
        warm, src = write_warm_start(tmp / "warm.ckpt")
        argv = ["--base", SHIPPED, "--train", "--max_steps", "1",
                f"model.frozen_ckpts.lpips={_lpips_blob(tmp)}",
                f"model.frozen_ckpts.constraint_decoder={dec_path}",
                f"model.ckpt_path={warm}"] + TINY
        x = _inputs(tp.CLIP, 1)
        for mod in (jtrain, train):
            mp.setattr(mod, "build_data",
                       lambda *a, **k: iter([{"frames": x.copy()}]))
        mp.setattr(jprofiling, "enable_compilation_cache", lambda: None)
        got = {}

        def jfit(self, data, state=None, **kw):
            got["jeng"], got["jstate"] = self.engine, state
            return state
        mp.setattr(jtrainer.Trainer, "fit", jfit)
        jtrain.main(argv + ["--logdir", str(tmp / "jax")])
        jeng, jstate = got["jeng"], got["jstate"]
        jbefore = jax.tree.map(np.asarray, jstate)
        ns = types.SimpleNamespace(jeng=jeng, compute_dtype="float32",
                                   clip=tp.CLIP, key=tp.Pair.key)
        _, jm = jeng.train_step(jstate, {"frames": jnp.asarray(x)},
                                tp.Pair.key(0))
        got["jmetrics"] = {k: float(v) for k, v in jm.items()}
        fit = ttrainer.Trainer.fit

        def tfit(self, data, state=None, **kw):
            got["warm"] = {k: v.clone()
                           for k, v in state.params.state_dict().items()}
            state.load_state_dict(from_jax_train_state(jbefore))
            self._step_fn = functools.partial(
                self.engine.train_step, draws=tp.Pair.draws(ns, 0))
            return fit(self, data, state=state, **kw)
        mp.setattr(ttrainer.Trainer, "fit", tfit)
        trainer, state = train.main(argv + ["--logdir", str(tmp / "port"),
                                            "--device", "cpu"])
        got.update(trainer=trainer, state=state, jbefore=jbefore, src=src)
        return got
    finally:
        mp.undo()


def test_main_warm_starts_jaxs_parameters(mains):
    jparams = from_jax_params(mains["jbefore"].params)
    src = mains["src"].state_dict()
    warm = mains["warm"]
    assert set(warm) == set(jparams)
    for k, v in warm.items():
        assert torch.equal(v, jparams[k]), k
        if k.startswith(("encoder.", "decoder.")):
            assert torch.equal(v, src[k]), k


def test_main_loads_jaxs_frozen_nets(mains):
    eng = mains["trainer"].engine
    for name in ("lpips", "constraint_decoder"):
        ref = from_jax_params(jax.tree.map(np.asarray,
                                           mains["jeng"].frozen[name]))
        got = eng.frozen[name].state_dict()
        assert set(got) == set(ref), name
        for k, v in ref.items():
            assert torch.equal(got[k], v), (name, k)


def test_main_first_step_matches_jax(mains):
    log = mains["trainer"].step_log
    assert len(log) == 1 and log[0]["kind"] == "g"
    assert mains["state"].step == 1
    tp.check_metrics(log[0]["metrics"], mains["jmetrics"])
