"""Latent-diffusion sampling with the 3D video VAE: the latent-compat demo.

Port of ``cvvae_tpu/pipelines/diffusion.py``.  The pipeline exists to show
the *latent compatibility contract*: latents of an image diffusion model
decode through the video VAE as ``vae.decode(latents / scaling_factor,
num_frames=1)``, with ``vae_scale_factor = spatial_n_compress``.

The denoiser is any ``(latents (B,H',W',C), t, cond) -> eps or v``
callable (``models/unet2d.make_denoiser``).  The schedulers keep the JAX
package's schedule exactly: DDIM without a ``steps_offset``, ending on
alpha 1.0, with epsilon or v prediction; Euler-discrete as it is there.
The sampling loop is a Python loop where the JAX package has a
``lax.scan``, with classifier-free guidance on a batch doubled as
[uncond, cond].  A scheduler step computes in fp32 whatever its inputs'
dtype, as JAX's promotion against the fp32 alphas makes it, so the
latents stay fp32 as the scan's carry does.

The JAX pipeline drives only DDIM: it calls ``init_noise_sigma()`` with no
argument and ``step`` with five, and the Euler scheduler takes
``num_inference_steps`` and four.  So ``LatentDiffusionPipeline`` refuses
an ``EulerDiscreteScheduler`` with a ``ValueError`` before any work, and
adds no sigma loop.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch


def _betas(num_train_timesteps: int = 1000, beta_start: float = 0.00085,
           beta_end: float = 0.012, schedule: str = "scaled_linear"
           ) -> torch.Tensor:
    """The DDPM betas in fp32 (the "scaled_linear" SD convention or
    "linear")."""
    if schedule == "scaled_linear":
        return torch.linspace(beta_start ** 0.5, beta_end ** 0.5,
                              num_train_timesteps) ** 2
    if schedule == "linear":
        return torch.linspace(beta_start, beta_end, num_train_timesteps)
    raise ValueError(schedule)


def _alphas_cumprod(n: int, beta_start: float, beta_end: float
                    ) -> torch.Tensor:
    return torch.cumprod(1.0 - _betas(n, beta_start, beta_end), 0)


def _sqrt(v) -> torch.Tensor:
    return torch.sqrt(torch.as_tensor(v, dtype=torch.float32))


@dataclasses.dataclass(frozen=True)
class DDIMScheduler:
    num_train_timesteps: int = 1000
    beta_start: float = 0.00085
    beta_end: float = 0.012
    eta: float = 0.0
    prediction_type: str = "epsilon"      # "epsilon" | "v_prediction"

    def timesteps(self, num_inference_steps: int) -> torch.Tensor:
        step = self.num_train_timesteps // num_inference_steps
        return (torch.arange(num_inference_steps) * step).flip(0)

    def alphas_cumprod(self) -> torch.Tensor:
        return _alphas_cumprod(self.num_train_timesteps, self.beta_start,
                               self.beta_end)

    def init_noise_sigma(self) -> float:
        return 1.0

    def scale_model_input(self, sample, t):
        return sample

    def step(self, model_out, t: int, t_prev: int, sample,
             alphas_cumprod: torch.Tensor) -> torch.Tensor:
        """One deterministic DDIM step from ``t`` to ``t_prev`` (-1: the
        end, alpha 1.0), in fp32."""
        model_out, sample = model_out.float(), sample.float()
        a_t = alphas_cumprod[t]
        a_prev = (alphas_cumprod[t_prev] if t_prev >= 0
                  else torch.ones((), device=a_t.device))
        if self.prediction_type == "v_prediction":
            eps = a_t.sqrt() * model_out + (1 - a_t).sqrt() * sample
            x0 = a_t.sqrt() * sample - (1 - a_t).sqrt() * model_out
        else:
            eps = model_out
            x0 = (sample - (1 - a_t).sqrt() * eps) / a_t.sqrt()
        return a_prev.sqrt() * x0 + (1 - a_prev).sqrt() * eps


@dataclasses.dataclass(frozen=True)
class EulerDiscreteScheduler:
    num_train_timesteps: int = 1000
    beta_start: float = 0.00085
    beta_end: float = 0.012
    prediction_type: str = "epsilon"

    def _index(self, num_inference_steps: int) -> torch.Tensor:
        return torch.linspace(0, self.num_train_timesteps - 1,
                              num_inference_steps).round().long()

    def sigmas(self, num_inference_steps: int) -> torch.Tensor:
        ac = _alphas_cumprod(self.num_train_timesteps, self.beta_start,
                             self.beta_end)
        all_sigmas = ((1 - ac) / ac).sqrt()
        return torch.cat([all_sigmas[self._index(num_inference_steps)].flip(0),
                          torch.zeros(1)])

    def timesteps(self, num_inference_steps: int) -> torch.Tensor:
        return self._index(num_inference_steps).flip(0)

    def init_noise_sigma(self, num_inference_steps: int) -> torch.Tensor:
        s = self.sigmas(num_inference_steps)
        return _sqrt(s[0] ** 2 + 1)

    def scale_model_input(self, sample, sigma):
        return sample / _sqrt(sigma ** 2 + 1)

    def step(self, model_out, sigma, sigma_next, sample) -> torch.Tensor:
        if self.prediction_type == "epsilon":
            x0 = sample - sigma * model_out
        else:
            scaled = sample / _sqrt(sigma ** 2 + 1)
            x0 = scaled / _sqrt(sigma ** 2 + 1) - \
                sigma * model_out / _sqrt(sigma ** 2 + 1)
        d = (sample - x0) / sigma
        return sample + d * (sigma_next - sigma)


def _stack(uncond, cond):
    """The CFG batch: [uncond, cond] along the batch axis, leaf by leaf of
    a tensor or a dict / list / tuple of them (the JAX pipeline's
    ``jax.tree.map``)."""
    if isinstance(uncond, dict):
        return {k: _stack(uncond[k], cond[k]) for k in uncond}
    if isinstance(uncond, (list, tuple)):
        return type(uncond)(_stack(u, c) for u, c in zip(uncond, cond))
    return torch.cat([uncond, cond], dim=0)


class LatentDiffusionPipeline:
    """Denoise in the image-VAE latent space, decode with the video VAE.

    denoiser: (latents (B,H',W',C), t: int, cond) -> model output.
    ``cond`` is whatever the denoiser needs (text embeddings etc.); with
    guidance_scale > 1 and an ``uncond``, the denoiser is called on a
    doubled batch with (uncond, cond) stacked, diffusers-style."""

    def __init__(self, vae, denoiser: Callable,
                 scheduler: Optional[DDIMScheduler] = None):
        if isinstance(scheduler, EulerDiscreteScheduler):
            raise ValueError(
                "LatentDiffusionPipeline drives DDIMScheduler only: as in "
                "the JAX pipeline, it calls init_noise_sigma() with no "
                "argument and step(out, t, t_prev, sample, alphas_cumprod), "
                "and EulerDiscreteScheduler takes num_inference_steps and "
                "step(out, sigma, sigma_next, sample)")
        self.vae = vae
        self.denoiser = denoiser
        self.scheduler = scheduler or DDIMScheduler()
        self.vae_scale_factor = vae.config.spatial_n_compress

    def prepare_latents(self, generator: torch.Generator, batch: int,
                        height: int, width: int) -> torch.Tensor:
        """N(0, 1) fp32 latents drawn by ``generator`` on its own device,
        moved to the VAE's device, times the scheduler's init sigma."""
        shape = (batch, height // self.vae_scale_factor,
                 width // self.vae_scale_factor,
                 self.vae.config.latent_channels)
        z = torch.randn(shape, generator=generator, device=generator.device,
                        dtype=torch.float32)
        return z.to(self.vae.device) * self.scheduler.init_noise_sigma()

    @torch.inference_mode()
    def __call__(self, generator: Optional[torch.Generator] = None, *,
                 cond=None, uncond=None, batch: int = 1, height: int = 512,
                 width: int = 512, num_inference_steps: int = 50,
                 guidance_scale: float = 7.5,
                 latents: Optional[torch.Tensor] = None,
                 output_type: str = "image") -> torch.Tensor:
        sched = self.scheduler
        if latents is None:
            if generator is None:
                raise ValueError("give a generator or the latents")
            latents = self.prepare_latents(generator, batch, height, width)
        latents = latents.to(self.vae.device, torch.float32)
        ts = sched.timesteps(num_inference_steps).tolist()
        alphas = sched.alphas_cumprod().to(latents.device)
        use_cfg = guidance_scale > 1.0 and uncond is not None
        if use_cfg:
            cond = _stack(uncond, cond)
        for t, t_prev in zip(ts, ts[1:] + [-1]):
            model_in = sched.scale_model_input(latents, t)
            if use_cfg:
                out = self.denoiser(torch.cat([model_in, model_in]), t, cond)
                out_u, out_c = out.chunk(2)
                out = out_u + guidance_scale * (out_c - out_u)
            else:
                out = self.denoiser(model_in, t, cond)
            latents = sched.step(out, t, t_prev, latents, alphas)
        if output_type == "latent":
            return latents
        return self.decode_latents(latents)

    def decode_latents(self, latents: torch.Tensor) -> torch.Tensor:
        """The compatibility contract: 4D image latents -> one video frame
        each, (B, H, W, 3).  The decode runs in the latents' dtype, as the
        JAX package's does (the VAE's weights are cast to it)."""
        z = latents.to(self.vae.device) / self.vae.config.scaling_factor
        return self.vae.decode(z, num_frames=1)[:, 0]
