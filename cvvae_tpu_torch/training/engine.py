"""VAE-GAN training engine.

Port of ``cvvae_tpu/training/engine.py``:

* per-batch G/D alternation (a G step at even steps and at every step
  before ``disc_start``, when the discriminator stays bit-frozen);
* the sampled posterior and its KL;
* the GAN hinge loss with the adaptive discriminator weight
  ||grad_W nll|| / ||grad_W g|| at the decoder's last conv weight W, taken
  with ``torch.autograd.grad`` of the two scalars w.r.t. W alone, on the
  decoder's features detached (the JAX package's trunk + head split): the
  same quantity, a constant for the main backward pass;
* the frozen 2D constraint decoder on the latents and/or the frozen 2D
  constraint encoder on time-sliced frames (constraint ``none``,
  ``latent``, ``encoder`` or ``all``);
* learned logvars, the global-norm clip, AdamW with both LRs set every
  step from the global step, gradients and updates of ``frozen_modules``
  masked, and an optional parameter EMA.

The JAX package is functional; here the state's modules and optimizer
moments are updated in place.  Random draws (the posterior's noise, the
random constraint frames' offsets) come from a ``torch.Generator``, or are
passed in as ``draws`` so a test can hand in the JAX package's.  On the
card the engine runs K1/K1.bwd (every GroupNorm, forward and backward),
K2/K2.bwd (the decoders' upsamplers) and, for v1 at full width, K3/K3.bwd
(the encoder's ``conv_in`` on the pixels; SD3's edge-pads W and Disc3D's
stem has 64 outputs); it reaches no K5.  In fp32 it reaches no K4
either (fp32 attention takes the exact path).

``compute_dtype="bfloat16"`` is the JAX package's mixed precision: the
parameters, AdamW's moments and the EMA stay fp32; the frozen nets are
cast to bf16 once; the 3D VAE's parameters are cast inside each forward
(``_cast_view``), so the fp32 masters take the gradient through the
casts; x is cast; 0-d leaves (the learned logvars) stay fp32; the KL is
taken on fp32 moments.  The discriminator's parameters stay fp32, its
convs run in the dtype that reaches them (bf16).  On the card the SD3
mid-blocks and the 2D constraint decoder's reach K4 at S >= 1024, and its
gradient K4.bwd.

``train_step(..., sync=)`` makes a step one rank's part of a data-parallel
step (``parallel/data.py``, ``shard_parallel_step``): the posterior noise
is this rank's rows of the global batch's draw, the adaptive weight's two
gradients and then the step's gradients are their means over the ranks,
and so are the metrics; every collective comes before the update.
Without it the step is the one process's, unchanged.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import warnings
from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn

from cvvae_tpu_torch.losses.gan import (generator_loss, hinge_d_loss,
                                        vanilla_d_loss)
from cvvae_tpu_torch.losses.vae_loss import (
    LossConfig, adaptive_disc_weight, constraint_targets,
    elementwise_rec_loss, global_norm, nll_from_rec, rec_with_perceptual)
from cvvae_tpu_torch.models import vae_sd3, vae_v1
from cvvae_tpu_torch.models.discriminator import Disc3D, Disc3DConfig
from cvvae_tpu_torch.models.lpips import LPIPS, init_lpips
from cvvae_tpu_torch.models.vae2d import Decoder2D, Encoder2D, VAE2DConfig
from cvvae_tpu_torch.ops.distributions import DiagonalGaussian
from cvvae_tpu_torch.training.ema import EMAState, ema_init, ema_update
from cvvae_tpu_torch.training.optim import (AdamW, AdamWState, OptimConfig,
                                            make_schedule)


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    family: str = "sd3"                       # "v1" | "sd3"
    net: Any = None                           # VAE1Config | VAESD3Config
    disc: Disc3DConfig = Disc3DConfig()
    loss: LossConfig = LossConfig()
    optim: OptimConfig = OptimConfig()
    #: "none" | "latent" | "encoder" | "all"
    constraint: str = "latent"
    constraint_decoder: Optional[VAE2DConfig] = None
    constraint_encoder: Optional[VAE2DConfig] = None
    ema_decay: Optional[float] = None
    remat: bool = True
    #: "float32" (the reference trains fp32) or "bfloat16": parameters,
    #: optimizer and EMA stay fp32, the nets compute in bf16
    compute_dtype: str = "float32"
    frozen_modules: Tuple[str, ...] = ()

    def __post_init__(self):
        if self.net is None:
            net = (vae_v1.VAE1Config() if self.family == "v1"
                   else vae_sd3.VAESD3Config())
            object.__setattr__(self, "net", net)
        naming = "sd3" if self.family == "sd3" else "sd21"
        if self.constraint in ("latent", "all") and \
                self.constraint_decoder is None:
            object.__setattr__(self, "constraint_decoder", VAE2DConfig(
                naming=naming, latent_channels=self.latent_channels))
        if self.constraint in ("encoder", "all") and \
                self.constraint_encoder is None:
            object.__setattr__(self, "constraint_encoder", VAE2DConfig(
                naming=naming, latent_channels=self.latent_channels))

    @property
    def latent_channels(self) -> int:
        return (self.net.z_channels if self.family == "v1"
                else self.net.latent_channels)

    @property
    def nets(self):
        return vae_v1 if self.family == "v1" else vae_sd3


class VAEParams(nn.Module):
    """The generator's parameters, the JAX params tree: ``encoder``,
    ``decoder`` and the learned 0-d ``logvar`` (and ``logvar_2d`` with a
    latent constraint)."""

    def __init__(self, cfg: EngineConfig,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.encoder = cfg.nets.Encoder(cfg.net, generator)
        self.decoder = cfg.nets.Decoder(cfg.net, generator)
        if cfg.loss.learn_logvar:
            self.logvar = nn.Parameter(torch.tensor(float(cfg.loss.logvar_init)))
            if cfg.constraint in ("latent", "all"):
                self.logvar_2d = nn.Parameter(
                    torch.tensor(float(cfg.loss.logvar_init)))


@dataclasses.dataclass
class TrainState:
    step: int
    params: VAEParams
    disc_params: Disc3D
    opt_g: AdamWState
    opt_d: AdamWState
    ema: Optional[EMAState]

    def state_dict(self) -> dict:
        return {"step": self.step,
                "params": self.params.state_dict(),
                "disc_params": self.disc_params.state_dict(),
                "opt_g": self.opt_g.state_dict(),
                "opt_d": self.opt_d.state_dict(),
                "ema": None if self.ema is None else self.ema.state_dict()}

    def load_state_dict(self, d: dict) -> "TrainState":
        """Load ``d`` in place (strictly; tensors copied to the state's
        device, so a later step does not write into ``d``)."""
        dev = next(self.params.parameters()).device
        to = lambda t: {k: v.to(dev, copy=True)  # noqa: E731
                        for k, v in t.items()}
        self.step = int(d["step"])
        self.params.load_state_dict(d["params"], strict=True)
        self.disc_params.load_state_dict(d["disc_params"], strict=True)
        for name in ("opt_g", "opt_d"):
            o = d[name]
            setattr(self, name, AdamWState(int(o["count"]), to(o["mu"]),
                                           to(o["nu"])))
        if (d["ema"] is None) != (self.ema is None):
            raise ValueError("checkpoint and state disagree on the EMA")
        if d["ema"] is not None:
            self.ema = EMAState(to(d["ema"]["shadow"]),
                                int(d["ema"]["num_updates"]))
        return self


def named_params(module: nn.Module) -> Dict[str, torch.Tensor]:
    return dict(module.named_parameters())


@contextlib.contextmanager
def ema_scope(params: nn.Module, ema: EMAState):
    """Swap the EMA's shadow into ``params`` for the block, then back."""
    named = named_params(params)
    saved = {k: p.detach().clone() for k, p in named.items()}
    with torch.no_grad():
        for k, p in named.items():
            p.copy_(ema.shadow[k])
    try:
        yield params
    finally:
        with torch.no_grad():
            for k, p in named.items():
                p.copy_(saved[k])


_ZERO_METRICS = ("loss/total", "loss/nll", "loss/rec", "loss/g",
                 "scalars/logvar", "scalars/d_weight", "kl_loss", "loss/disc",
                 "logits/real", "logits/fake")


class TrainingEngine:
    """Holds the configs and the frozen nets; runs G and D steps on a
    ``TrainState``."""

    def __init__(self, cfg: EngineConfig, *,
                 lpips_params: Optional[dict] = None,
                 constraint_decoder_params: Optional[dict] = None,
                 constraint_encoder_params: Optional[dict] = None,
                 allow_random_lpips: bool = False, seed: int = 0,
                 device: Any = "cuda"):
        if cfg.compute_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"compute_dtype={cfg.compute_dtype!r}: float32 "
                             f"or bfloat16")
        self.compute_dtype = getattr(torch, cfg.compute_dtype)
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("TrainingEngine: no CUDA device; pass "
                               "device='cpu' to train on the CPU")
        self.cfg = cfg
        g = torch.Generator().manual_seed(seed)
        lpips = None
        if lpips_params is not None:
            lpips = LPIPS()
            lpips.load_state_dict(lpips_params, strict=True)
        elif cfg.loss.perceptual_weight > 0:
            # the reference downloads and checks pretrained LPIPS weights;
            # it never optimises against an uncalibrated metric
            if not allow_random_lpips:
                raise ValueError(
                    "perceptual_weight > 0 but no pretrained LPIPS params "
                    "were given: training would optimise a random-init VGG "
                    "metric. Pass lpips_params=load_lpips_params(...) or "
                    "explicitly opt in with allow_random_lpips=True "
                    "(smoke tests only).")
            warnings.warn(
                "LPIPS is RANDOM-INIT (allow_random_lpips=True): the "
                "perceptual term is uncalibrated; smoke-test use only.",
                stacklevel=2)
            lpips = init_lpips(g)
        self.frozen: Dict[str, Optional[nn.Module]] = {"lpips": lpips}
        if cfg.constraint in ("latent", "all"):
            net = Decoder2D(cfg.constraint_decoder, g)
            if constraint_decoder_params is not None:
                net.load_state_dict(constraint_decoder_params, strict=True)
            self.frozen["constraint_decoder"] = net
        if cfg.constraint in ("encoder", "all"):
            net = Encoder2D(cfg.constraint_encoder, g)
            if constraint_encoder_params is not None:
                net.load_state_dict(constraint_encoder_params, strict=True)
            self.frozen["constraint_encoder"] = net
        for net in self.frozen.values():
            if net is not None:
                net.to(self.device).eval().requires_grad_(False)
                # inference only: stored in the compute dtype once
                _cast_params_(net, self.compute_dtype)
        self.opt_g = AdamW(cfg.optim)
        self.opt_d = AdamW(cfg.optim)
        self.lr_schedule_g = make_schedule(cfg.optim, cfg.optim.lr_g_factor)
        self.lr_schedule_d = make_schedule(cfg.optim, 1.0)
        #: the last step's global gradient norm before the clip
        self.last_grad_norm: Optional[torch.Tensor] = None
        #: with ``keep_grads``, the last step's (clipped) gradients by name
        self.keep_grads = False
        self.last_grads: Optional[Dict[str, torch.Tensor]] = None

    # ------------------------------------------------------------------
    # state
    # ------------------------------------------------------------------

    def init_state(self, seed: int = 0,
                   params: Optional[VAEParams] = None) -> TrainState:
        cfg = self.cfg
        g = torch.Generator().manual_seed(seed)
        if params is None:
            params = VAEParams(cfg, g)
        disc = Disc3D(cfg.disc, g)
        params.to(self.device).train()
        disc.to(self.device).train()
        named = named_params(params)
        return TrainState(
            step=0, params=params, disc_params=disc,
            opt_g=self.opt_g.init(named),
            opt_d=self.opt_d.init(named_params(disc)),
            ema=ema_init(named) if cfg.ema_decay is not None else None)

    # ------------------------------------------------------------------
    # forward pieces
    # ------------------------------------------------------------------

    def _logvar(self, params: VAEParams, name: str) -> torch.Tensor:
        if self.cfg.loss.learn_logvar:
            return getattr(params, name)
        return torch.tensor(float(self.cfg.loss.logvar_init),
                            device=self.device)

    def _forward(self, params: VAEParams, x: torch.Tensor, *,
                 noise: Optional[torch.Tensor] = None,
                 generator: Optional[torch.Generator] = None,
                 sync=None):
        """Encode -> sample -> decode (features, then head).  With an
        encoder constraint the frozen 2D encoder's moments of the
        time-sliced frames join the batch, against the input twice.  A
        data-parallel ``sync`` gives this rank's rows of the global
        batch's noise.  Returns (posterior, z, h, xrec, x_target)."""
        cfg = self.cfg
        if self.compute_dtype != torch.float32:
            params = _cast_view(params, self.compute_dtype)
            x = x.to(self.compute_dtype)
        moments = params.encoder(x, remat=cfg.remat)
        x_target = x
        if cfg.constraint in ("encoder", "all"):
            with torch.no_grad():
                moments_2d = self.frozen["constraint_encoder"](
                    x[:, ::cfg.loss.time_n_compress].contiguous())
            moments = torch.cat([moments, moments_2d], dim=0)
            x_target = torch.cat([x, x], dim=0)
        posterior = DiagonalGaussian.from_moments(moments)
        if noise is None and sync is not None:
            noise = sync.noise(generator, posterior.mean, blocks=(
                2 if cfg.constraint in ("encoder", "all") else 1))
        z = posterior.sample(generator, noise=noise)
        h = params.decoder(z, remat=cfg.remat, features_only=True)
        xrec = cfg.nets.apply_decoder_head(params.decoder.conv_out, h,
                                           cfg.net)
        return posterior, z, h, xrec, x_target

    def _gate(self, step: int) -> float:
        """The discriminator warm-up gate."""
        return float(step >= self.cfg.loss.disc_start)

    def _adaptive_weight(self, params: VAEParams, disc: Disc3D,
                         h: torch.Tensor, x_target: torch.Tensor,
                         logvar: torch.Tensor, sync=None) -> torch.Tensor:
        """||grad_W nll|| / (||grad_W g|| + 1e-4) (clipped, times
        disc_weight) at the decoder's conv_out weight W, on h detached.  A
        data-parallel ``sync`` takes both gradients' means over ranks
        first: the gradients of the global losses."""
        cfg, loss_cfg = self.cfg, self.cfg.loss
        conv_out = params.decoder.conv_out
        with torch.enable_grad():
            w0 = conv_out.weight.detach().requires_grad_()
            head = cfg.nets.apply_decoder_head(
                _Weights(w0, conv_out.bias.detach()), h.detach(), cfg.net)
            rec = rec_with_perceptual(loss_cfg, self.frozen["lpips"],
                                      x_target.detach(), head)
            nll = nll_from_rec(rec, logvar.detach())
            (g_nll,) = torch.autograd.grad(nll, [w0], retain_graph=True)
            (g_g,) = torch.autograd.grad(generator_loss(disc(head)), [w0])
        if sync is not None:
            g_nll, g_g = sync.mean([g_nll, g_g])
        return adaptive_disc_weight(loss_cfg, global_norm([g_nll]),
                                    global_norm([g_g]))

    def _g_loss(self, params: VAEParams, disc: Disc3D, x: torch.Tensor,
                step: int, draws: Optional[dict] = None,
                generator: Optional[torch.Generator] = None,
                with_aux: bool = False, sync=None):
        cfg, loss_cfg = self.cfg, self.cfg.loss
        draws = draws or {}
        posterior, z, h, xrec, x_target = self._forward(
            params, x, noise=draws.get("noise"), generator=generator,
            sync=sync)
        kl_loss = DiagonalGaussian(posterior.mean.float(),
                                   posterior.logvar.float()).kl().mean()
        logvar = self._logvar(params, "logvar")
        rec = rec_with_perceptual(loss_cfg, self.frozen["lpips"], x_target,
                                  xrec)
        nll = nll_from_rec(rec, logvar)
        log = {"loss/rec": rec.mean(), "scalars/logvar": logvar,
               "kl_loss": kl_loss}
        if cfg.constraint in ("latent", "all"):
            logvar_2d = self._logvar(params, "logvar_2d")
            # "all": only the 3D encoder's half of z feeds the 2D decoder
            z_3d = z[:x.shape[0]] if cfg.constraint == "all" else z
            xrec_2d = self.frozen["constraint_decoder"](z_3d)
            targets_2d = constraint_targets(loss_cfg, x, generator,
                                            offsets=draws.get("offsets"))
            rec2d = elementwise_rec_loss(targets_2d, xrec_2d,
                                         loss_cfg.rec_loss)
            rec2d = rec2d.reshape((-1,) + tuple(rec2d.shape[2:]))
            nll = nll + loss_cfg.rec2d_weight * nll_from_rec(rec2d, logvar_2d)
            log["loss/rec2d"] = rec2d.mean()
            log["scalars/logvar_2d"] = logvar_2d
        gate = self._gate(step)
        logits_fake = disc(xrec)
        g_loss = generator_loss(logits_fake)
        if not loss_cfg.adaptive_disc_weight:
            d_weight = torch.tensor(loss_cfg.disc_weight, device=x.device)
        elif gate:
            d_weight = self._adaptive_weight(params, disc, h, x_target,
                                             logvar, sync)
        else:  # the weight is multiplied by the closed gate
            d_weight = torch.zeros((), device=x.device)
        d_weight = d_weight * gate
        total = (nll + d_weight * loss_cfg.disc_factor * g_loss * gate
                 + loss_cfg.kl_weight * kl_loss)
        log.update({"loss/total": total, "loss/nll": nll,
                    "loss/g": g_loss * gate, "scalars/d_weight": d_weight})
        if with_aux:
            log["_aux"] = {"xrec": xrec, "x_target": x_target,
                           "logits_fake": logits_fake}
        return total, log

    def _d_loss(self, disc: Disc3D, params: VAEParams, x: torch.Tensor,
                step: int, draws: Optional[dict] = None,
                generator: Optional[torch.Generator] = None, sync=None):
        loss_cfg = self.cfg.loss
        with torch.no_grad():
            _, _, _, xrec, x_target = self._forward(
                params, x, noise=(draws or {}).get("noise"),
                generator=generator, sync=sync)
        logits_real = disc(x_target)
        logits_fake = disc(xrec)
        fn = hinge_d_loss if loss_cfg.disc_loss == "hinge" else vanilla_d_loss
        d = loss_cfg.disc_factor * fn(logits_real, logits_fake) \
            * self._gate(step)
        return d, {"loss/disc": d, "logits/real": logits_real.mean(),
                   "logits/fake": logits_fake.mean()}

    @torch.no_grad()
    def val_step(self, params: VAEParams, disc: Disc3D,
                 batch: Dict[str, torch.Tensor], step: int,
                 draws: Optional[dict] = None,
                 generator: Optional[torch.Generator] = None):
        """The full validation dict (the G loss dict, the D pass on the
        same reconstruction, PSNR and SSIM) and the reconstruction; no
        parameter changes."""
        from cvvae_tpu_torch.utils.metrics import psnr, ssim
        _, log = self._g_loss(params, disc, batch["frames"], step, draws,
                              generator, with_aux=True)
        aux = log.pop("_aux")
        xrec, x_target = aux["xrec"], aux["x_target"]
        loss_cfg = self.cfg.loss
        logits_real = disc(x_target)
        fn = hinge_d_loss if loss_cfg.disc_loss == "hinge" else vanilla_d_loss
        log.update({
            "loss/disc": (loss_cfg.disc_factor
                          * fn(logits_real, aux["logits_fake"])
                          * self._gate(step)),
            "logits/real": logits_real.mean(),
            "logits/fake": aux["logits_fake"].mean()})
        log["psnr_db"] = psnr(x_target, xrec).mean()
        log["ssim"] = ssim(x_target, xrec).mean()
        return {k: torch.as_tensor(v).float() for k, v in log.items()}, xrec

    # ------------------------------------------------------------------
    # steps
    # ------------------------------------------------------------------

    def _frozen_names(self, named: Dict[str, torch.Tensor]):
        return [k for k in named for m in self.cfg.frozen_modules
                if k == m or k.startswith(m + ".")]

    def _grads(self, loss: torch.Tensor, named: Dict[str, torch.Tensor]):
        grads = torch.autograd.grad(loss, list(named.values()),
                                    allow_unused=True)
        return {k: torch.zeros_like(p) if g is None else g
                for (k, p), g in zip(named.items(), grads)}

    def is_g_step(self, step: int) -> bool:
        """optimizer_idx = step % 2, but every step before disc_start is a
        G step (the discriminator bit-frozen meanwhile)."""
        return step % 2 == 0 or step < self.cfg.loss.disc_start

    def train_step(self, state: TrainState, batch: Dict[str, torch.Tensor],
                   generator: Optional[torch.Generator] = None,
                   draws: Optional[dict] = None, *, sync=None
                   ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        """One G or D step on ``batch["frames"]`` (B, T, H, W, 3) in [-1, 1],
        in place.  ``draws``: {"noise": the posterior's N(0, 1) draw,
        "offsets": the random constraint frames' offsets}, each drawn from
        ``generator`` where not given.  ``sync`` (``parallel/data.py``'s
        ``ReplicaSync``) makes it one rank's part of a data-parallel step:
        the draws, the adaptive weight's gradients, the gradients and the
        metrics are taken over the ranks, every collective before the
        update.  Returns (state, metrics: 0-d fp32 tensors)."""
        cfg = self.cfg
        x = batch["frames"]
        step = state.step
        if sync is not None:
            generator = sync.begin(x, generator)
        if self.is_g_step(step):
            named = named_params(state.params)
            total, log = self._g_loss(state.params, state.disc_params, x,
                                      step, draws, generator, sync=sync)
            grads = self._grads(total, named)
            log = _snapshot(log)  # before the update moves the logvars
            frozen = self._frozen_names(named)
            if sync is not None:  # frozen gradients are zeroed anyway
                sync.mean_grads(grads, skip=frozen)
                log = sync.mean_scalars(log)
            self.last_grad_norm = self.opt_g.step(
                named, grads, state.opt_g, self.lr_schedule_g(step),
                frozen=frozen)
            if state.ema is not None:
                ema_update(state.ema, named, cfg.ema_decay)
        else:
            named = named_params(state.disc_params)
            d, log = self._d_loss(state.disc_params, state.params, x, step,
                                  draws, generator, sync=sync)
            grads = self._grads(d, named)
            log = _snapshot(log)
            if sync is not None:
                sync.mean_grads(grads)
                log = sync.mean_scalars(log)
            self.last_grad_norm = self.opt_d.step(
                named, grads, state.opt_d, self.lr_schedule_d(step))
        self.last_grads = grads if self.keep_grads else None
        state.step = step + 1
        metrics = {k: torch.zeros((), device=x.device) for k in _ZERO_METRICS}
        if cfg.constraint in ("latent", "all"):
            metrics.update({k: torch.zeros((), device=x.device)
                            for k in ("loss/rec2d", "scalars/logvar_2d")})
        metrics.update(log)
        return state, metrics


def _cast_view(module: nn.Module, dtype: torch.dtype) -> nn.Module:
    """A copy of ``module``'s tree that shares all but its float parameters
    of rank > 0, which it holds cast to ``dtype``: graph nodes of the
    masters, so a gradient reaches the masters through the casts (the JAX
    package casts its params tree inside the loss the same way).  The
    copy lives as long as the graph does, so a checkpointed block's
    recompute reads the same cast tensors.  0-d parameters stay as they
    are."""
    view = copy.copy(module)
    view.__dict__["_parameters"] = {
        k: (p.to(dtype) if p is not None and p.is_floating_point()
            and p.ndim > 0 else p)
        for k, p in module._parameters.items()}
    view.__dict__["_modules"] = {
        k: None if m is None else _cast_view(m, dtype)
        for k, m in module._modules.items()}
    return view


def _cast_params_(module: nn.Module, dtype: torch.dtype) -> None:
    """Cast ``module``'s float parameters of rank > 0 to ``dtype`` in
    place (0-d ones stay)."""
    for p in module.parameters():
        if p.is_floating_point() and p.ndim > 0:
            p.data = p.data.to(dtype)


def _snapshot(log: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: v.detach().float().clone() for k, v in log.items()}


class _Weights:
    """A conv's parameters held apart from its module."""

    def __init__(self, weight, bias):
        self.weight, self.bias = weight, bias
