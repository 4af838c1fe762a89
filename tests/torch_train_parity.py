"""Shared set-up of the engine parity tests (``test_torch_train_engine_*``):
one G step and one D step of the port's ``TrainingEngine`` against the JAX
package's, from the same carried-over state and with the same draws, for
the SD3 family (``NETS["sd3"]``) or v1 (``NETS["v1"]``, with the
SD2.1-named constraint decoder).

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
With ``compute_dtype="bfloat16"`` both engines run the JAX package's
mixed precision, the posterior's noise is drawn in bf16 as the JAX step
draws it, and the two round to bf16 at other places.  This narrow random
net carries a change at bf16's rounding level through to several percent
of its outputs: JAX's own decoder moves 4.9% (rms) when a fifth of z moves
by one bf16 ulp, and the port's decoder on JAX's z is 5.4% from JAX's; a
G step's update moves 14-17% (L2) from JAX's own under a 2^-9 change of
the input.  So the port is held to JAX's own spread (``Pair.spread``: the
JAX step again from the same state and key on BF16_SPREAD_SEEDS inputs
x·(1 + 2^-9·N(0, 1))): each metric within BF16_LOSS_RTOL relative + atol
BF16_LOSS_ATOL, or within BF16_SPREAD_FACTOR times JAX's largest distance
from itself, whichever is larger; the updates of all parameters together
within BF16_SPREAD_FACTOR times JAX's largest L2 distance from itself
(``check_updates_bf16``).
"""

import numpy as np
import torch

import jax
import jax.numpy as jnp

from cvvae_tpu.losses.vae_loss import LossConfig as JLoss
from cvvae_tpu.models.discriminator import Disc3DConfig as JDisc
from cvvae_tpu.models.vae2d import VAE2DConfig as J2D
from cvvae_tpu.models.vae_sd3 import VAESD3Config as JNet
from cvvae_tpu.models.vae_v1 import VAE1Config as JNet1
from cvvae_tpu.training.engine import EngineConfig as JEngineConfig
from cvvae_tpu.training.engine import TrainingEngine as JEngine
from cvvae_tpu.training.optim import OptimConfig as JOptim

from cvvae_tpu_torch.losses.vae_loss import LossConfig
from cvvae_tpu_torch.models.discriminator import Disc3DConfig
from cvvae_tpu_torch.models.vae2d import VAE2DConfig
from cvvae_tpu_torch.models.vae_sd3 import VAESD3Config
from cvvae_tpu_torch.models.vae_v1 import VAE1Config
from cvvae_tpu_torch.training.engine import EngineConfig, TrainingEngine
from cvvae_tpu_torch.training.optim import OptimConfig
from cvvae_tpu_torch.utils.convert import (from_jax_params,
                                           from_jax_train_state)

LOSS_RTOL = 1e-4
UPDATE_TOL = 1e-2
CLIP = (1, 5, 16, 16, 3)
BASE_LR = 1e-3
#: each family's tiny nets: (JAX net config, port net config, net kwargs,
#: 2D constraint nets' kwargs)
NETS = {
    "sd3": (JNet, VAESD3Config,
            dict(block_out_channels=(8, 8, 8, 8), layers_per_block=1,
                 latent_channels=4, norm_num_groups=4),
            dict(naming="sd3", latent_channels=4,
                 block_out_channels=(8, 8, 8, 8), layers_per_block=1,
                 norm_num_groups=4)),
    "v1": (JNet1, VAE1Config,
           dict(ch=8, ch_mult=(1, 2, 4, 4), num_res_blocks=1, z_channels=4,
                norm_num_groups=4),
           dict(naming="sd21", latent_channels=4,
                block_out_channels=(8, 8, 8, 8), layers_per_block=1,
                norm_num_groups=4)),
}
DISC = dict(ndf=8, n_layers=2, norm_groups=4)
OPTIM = dict(base_lr=BASE_LR, num_warmup_steps=0, num_training_steps=100)
BF16_LOSS_RTOL = 2e-2
BF16_LOSS_ATOL = 1e-3
BF16_SPREAD_SEEDS = (10, 11, 12, 13, 14)
BF16_SPREAD_FACTOR = 2.0


def _cfg(pkg, constraint, perceptual, remat, compute_dtype, family):
    Net, Disc, Loss, Optim, V2, E = pkg
    net_kw, net2d_kw = NETS[family][2:]
    v2 = V2(**net2d_kw)
    return E(family=family, net=Net(**net_kw), disc=Disc(**DISC),
             loss=Loss(perceptual_weight=perceptual, time_n_compress=4),
             optim=Optim(**OPTIM), constraint=constraint,
             constraint_decoder=v2, constraint_encoder=v2, remat=remat,
             compute_dtype=compute_dtype)


class Pair:
    """The JAX engine with its states at steps 2 and 3, and the port's
    engine on the same frozen nets."""

    def __init__(self, constraint, perceptual=0.0, port_remat=True,
                 compute_dtype="float32", family="sd3", clip=CLIP):
        self.constraint = constraint
        self.clip = clip
        self.compute_dtype = compute_dtype
        jnet, tnet = NETS[family][:2]
        jcfg = _cfg((jnet, JDisc, JLoss, JOptim, J2D, JEngineConfig),
                    constraint, perceptual, False, compute_dtype, family)
        self.jeng = JEngine(jcfg, seed=0, allow_random_lpips=True)
        # the frozen nets as fp32 numpy (bf16 widens exactly); the port
        # casts them to its compute dtype as the JAX engine did
        frozen = {k: None if v is None else from_jax_params(
            jax.tree.map(lambda a: np.asarray(a, np.float32), v))
            for k, v in self.jeng.frozen.items()}
        tcfg = _cfg((tnet, Disc3DConfig, LossConfig, OptimConfig,
                     VAE2DConfig, EngineConfig), constraint, perceptual,
                    port_remat, compute_dtype, family)
        self.teng = TrainingEngine(
            tcfg, device="cpu", allow_random_lpips=True,
            lpips_params=frozen["lpips"],
            constraint_decoder_params=frozen.get("constraint_decoder"),
            constraint_encoder_params=frozen.get("constraint_encoder"))
        self.x = np.random.RandomState(1).uniform(-1, 1, clip).astype(
            np.float32)
        batch = {"frames": jnp.asarray(self.x)}
        self._spread = {}
        self.states = [self.jeng.init_state(jax.random.PRNGKey(0))]
        self.metrics = [None]
        for i in range(4):
            s, m = self.jeng.train_step(self.states[-1], batch, self.key(i))
            self.states.append(s)
            self.metrics.append({k: float(v) for k, v in m.items()})

    def spread(self, step):
        """JAX's step ``step`` again from the same state and key on the
        inputs x·(1 + 2^-9·N(0, 1)) of BF16_SPREAD_SEEDS: [(metrics,
        state after), ...]."""
        if step not in self._spread:
            out = []
            for seed in BF16_SPREAD_SEEDS:
                x = self.x * (1 + 2.0 ** -9 * np.random.RandomState(seed)
                              .standard_normal(self.x.shape)).astype(
                                  np.float32)
                s, m = self.jeng.train_step(self.states[step],
                                            {"frames": jnp.asarray(x)},
                                            self.key(step))
                out.append(({k: float(v) for k, v in m.items()}, s))
            self._spread[step] = out
        return self._spread[step]

    @staticmethod
    def key(step):
        return jax.random.PRNGKey(100 + step)

    def draws(self, step):
        """What the JAX step draws from its key: the G step splits it into
        the posterior's and the constraint targets' keys, the D step uses
        it for the posterior, whose noise is drawn in the compute dtype."""
        cfg = self.jeng.cfg
        dtype = jnp.dtype(self.compute_dtype)

        def normal(k):
            return torch.from_numpy(np.asarray(
                jax.random.normal(k, lat, dtype), np.float32))
        b, t, h, w, _ = self.clip
        lat = (b * (2 if cfg.constraint in ("encoder", "all") else 1),
               (t - 1) // 4 + 1, h // 8, w // 8, cfg.latent_channels)
        key = self.key(step)
        if step % 2 == 0:
            k_s, k_t = jax.random.split(key)
            offs = jax.random.randint(k_t, ((t - 1) // 4,), 1, 5)
            return {"noise": normal(k_s),
                    "offsets": torch.from_numpy(np.array(offs))}
        return {"noise": normal(key)}

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



def check_metrics_bf16(got, ref, spread):
    """Each metric within BF16_LOSS_RTOL * |ref| + BF16_LOSS_ATOL of JAX's,
    or within BF16_SPREAD_FACTOR times JAX's largest distance from itself
    over ``spread`` (``Pair.spread``)."""
    assert set(got) == set(ref), (set(got) ^ set(ref))
    for k, r in ref.items():
        own = max(abs(m[k] - r) for m, _ in spread)
        tol = max(BF16_LOSS_RTOL * abs(r) + BF16_LOSS_ATOL,
                  BF16_SPREAD_FACTOR * own)
        assert abs(got[k] - r) <= tol, (k, got[k], r, own)


def _deltas(before, after, keys):
    return torch.cat([(after[k].double() - before[k].double()).reshape(-1)
                      for k in keys])


def check_updates_bf16(state, jbefore, jafter, which, spread):
    """The updates of every leaf of ``which`` together within
    BF16_SPREAD_FACTOR times JAX's largest L2 distance from itself over
    ``spread``; a leaf JAX leaves unchanged is unchanged.  Returns the
    number of leaves that moved."""
    tree = lambda st: from_jax_params(  # noqa: E731
        jax.tree.map(np.asarray, getattr(st, which)))
    before, after = tree(jbefore), tree(jafter)
    module = state.params if which == "params" else state.disc_params
    got = dict(module.state_dict())
    moved = [k for k in before if not torch.equal(after[k], before[k])]
    for k in before:
        if k not in moved:
            assert torch.equal(got[k], before[k]), k
    if not moved:
        return 0
    d_jax = _deltas(before, after, moved)
    dist = float((_deltas(before, got, moved) - d_jax).norm() / d_jax.norm())
    own = max(float((_deltas(before, tree(s), moved) - d_jax).norm()
                    / d_jax.norm()) for _, s in spread)
    assert dist <= BF16_SPREAD_FACTOR * own, (dist, own)
    return len(moved)
