"""Shared set-up of the engine parity tests (``test_torch_train_engine_*``):
one G step and one D step of the port's ``TrainingEngine`` against the JAX
package's, from the same carried-over state and with the same draws.

The JAX engine runs steps 0 (G) and 1 (D) from its init, so its optimizer
states hold real moments; ``from_jax_train_state`` carries that state to
the port.  Step 2 is a G step with the discriminator's gate open (the
adaptive weight runs), step 3 a D step; each is compared from the JAX
state before it.  The JAX package draws with ``jax.random`` inside its
step; the same draws (the posterior's noise, the constraint frames'
offsets) are made here from the step's key as the JAX step splits it, and
handed to the port.  The schedules have no warm-up, so lr > 0 at every
step.

Tolerances: losses and metrics relative 1e-4 (LOSS_RTOL, atol 1e-6);
parameter updates |Δport − Δjax| <= 1e-2 * lr elementwise (UPDATE_TOL):
both run fp32 with sums in other orders, and an Adam update divides by
sqrt(v) + eps, which scales a gradient's relative error into its update.
"""

import numpy as np
import torch

import jax
import jax.numpy as jnp

from cvvae_tpu.losses.vae_loss import LossConfig as JLoss
from cvvae_tpu.models.discriminator import Disc3DConfig as JDisc
from cvvae_tpu.models.vae2d import VAE2DConfig as J2D
from cvvae_tpu.models.vae_sd3 import VAESD3Config as JNet
from cvvae_tpu.training.engine import EngineConfig as JEngineConfig
from cvvae_tpu.training.engine import TrainingEngine as JEngine
from cvvae_tpu.training.optim import OptimConfig as JOptim

from cvvae_tpu_torch.losses.vae_loss import LossConfig
from cvvae_tpu_torch.models.discriminator import Disc3DConfig
from cvvae_tpu_torch.models.vae2d import VAE2DConfig
from cvvae_tpu_torch.models.vae_sd3 import VAESD3Config
from cvvae_tpu_torch.training.engine import EngineConfig, TrainingEngine
from cvvae_tpu_torch.training.optim import OptimConfig
from cvvae_tpu_torch.utils.convert import (from_jax_params,
                                           from_jax_train_state)

LOSS_RTOL = 1e-4
UPDATE_TOL = 1e-2
CLIP = (1, 5, 16, 16, 3)
BASE_LR = 1e-3
NET = dict(block_out_channels=(8, 8, 8, 8), layers_per_block=1,
           latent_channels=4, norm_num_groups=4)
NET2D = dict(naming="sd3", latent_channels=4, block_out_channels=(8, 8, 8, 8),
             layers_per_block=1, norm_num_groups=4)
DISC = dict(ndf=8, n_layers=2, norm_groups=4)
OPTIM = dict(base_lr=BASE_LR, num_warmup_steps=0, num_training_steps=100)


def _cfg(pkg, constraint, perceptual, remat):
    Net, Disc, Loss, Optim, V2, E = pkg
    v2 = V2(**NET2D)
    return E(family="sd3", net=Net(**NET), disc=Disc(**DISC),
             loss=Loss(perceptual_weight=perceptual, time_n_compress=4),
             optim=Optim(**OPTIM), constraint=constraint,
             constraint_decoder=v2, constraint_encoder=v2, remat=remat)


class Pair:
    """The JAX engine with its states at steps 2 and 3, and the port's
    engine on the same frozen nets."""

    def __init__(self, constraint, perceptual=0.0, port_remat=True):
        self.constraint = constraint
        jcfg = _cfg((JNet, JDisc, JLoss, JOptim, J2D, JEngineConfig),
                    constraint, perceptual, False)
        self.jeng = JEngine(jcfg, seed=0, allow_random_lpips=True)
        frozen = {k: None if v is None else from_jax_params(
            jax.tree.map(np.asarray, v)) for k, v in self.jeng.frozen.items()}
        tcfg = _cfg((VAESD3Config, Disc3DConfig, LossConfig, OptimConfig,
                     VAE2DConfig, EngineConfig), constraint, perceptual,
                    port_remat)
        self.teng = TrainingEngine(
            tcfg, device="cpu", allow_random_lpips=True,
            lpips_params=frozen["lpips"],
            constraint_decoder_params=frozen.get("constraint_decoder"),
            constraint_encoder_params=frozen.get("constraint_encoder"))
        self.x = np.random.RandomState(1).uniform(-1, 1, CLIP).astype(
            np.float32)
        batch = {"frames": jnp.asarray(self.x)}
        self.states = [self.jeng.init_state(jax.random.PRNGKey(0))]
        self.metrics = [None]
        for i in range(4):
            s, m = self.jeng.train_step(self.states[-1], batch, self.key(i))
            self.states.append(s)
            self.metrics.append({k: float(v) for k, v in m.items()})

    @staticmethod
    def key(step):
        return jax.random.PRNGKey(100 + step)

    def draws(self, step):
        """What the JAX step draws from its key: the G step splits it into
        the posterior's and the constraint targets' keys, the D step uses
        it for the posterior."""
        cfg = self.jeng.cfg
        b, t, h, w, _ = CLIP
        lat = (b * (2 if cfg.constraint in ("encoder", "all") else 1),
               (t - 1) // 4 + 1, h // 8, w // 8, cfg.latent_channels)
        key = self.key(step)
        if step % 2 == 0:
            k_s, k_t = jax.random.split(key)
            offs = jax.random.randint(k_t, ((t - 1) // 4,), 1, 5)
            return {"noise": torch.from_numpy(np.array(
                        jax.random.normal(k_s, lat, jnp.float32))),
                    "offsets": torch.from_numpy(np.array(offs))}
        return {"noise": torch.from_numpy(np.array(
            jax.random.normal(key, lat, jnp.float32)))}

    def port_step(self, step):
        """The port's step ``step`` from the JAX state before it: (its
        metrics, its state after, the JAX state before and after)."""
        jbefore, jafter = self.states[step], self.states[step + 1]
        st = self.teng.init_state(0)
        st.load_state_dict(from_jax_train_state(
            jax.tree.map(np.asarray, jbefore)))
        assert st.step == step
        st, m = self.teng.train_step(st, {"frames": torch.from_numpy(self.x)},
                                     draws=self.draws(step))
        return ({k: float(v) for k, v in m.items()}, st, jbefore, jafter)


def check_metrics(got, ref):
    assert set(got) == set(ref), (set(got) ^ set(ref))
    for k, r in ref.items():
        assert abs(got[k] - r) <= LOSS_RTOL * abs(r) + 1e-6, (k, got[k], r)


def check_updates(state, jbefore, jafter, which, lr):
    """|Δport − Δjax| <= UPDATE_TOL * lr for every leaf of ``which``
    ("params" or "disc_params"); returns the largest |Δjax| / lr seen, so
    a caller can tell that the step moved the parameters."""
    before = from_jax_params(jax.tree.map(np.asarray,
                                          getattr(jbefore, which)))
    after = from_jax_params(jax.tree.map(np.asarray, getattr(jafter, which)))
    module = state.params if which == "params" else state.disc_params
    got = dict(module.state_dict())
    moved = 0.0
    for k, b in before.items():
        d_port = got[k].double() - b.double()
        d_jax = after[k].double() - b.double()
        err = (d_port - d_jax).abs().max().item()
        assert err <= UPDATE_TOL * lr, (k, err / lr)
        moved = max(moved, d_jax.abs().max().item() / lr)
    return moved
