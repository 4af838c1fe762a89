"""The port's diffusion pipeline (``pipelines/diffusion.py``) against the
JAX package's, on the CPU.

The schedules (betas, alphas_cumprod, DDIM timesteps, Euler sigmas,
timesteps and init sigma) and each scheduler step against JAX's; the
Euler scheduler's ``ValueError`` in the pipeline, where the JAX pipeline
fails on it; the whole sampling loop with a dummy denoiser from the same
latents, CFG on and off, with a tensor and a tree of conditions; then
the decode contract through a tiny v1 VAE, in fp32 and with bf16 weights.
Tolerances: the betas are one fp32 linspace and square on both sides:
2e-6 relative; what derives from alphas_cumprod is a product of 1000
fp32 terms taken in another order (XLA's cumprod against torch's), whose
rounding can reach 1000 x 2^-24 = 6e-5 relative and is about 2e-6 in a
random walk: 1e-5 relative; a step is a few fp32 operations: 1e-5 of (1
+ |ref|); the loop carries them over its steps and through the VAE: 3e-4
abs, the golden suites' bound.
"""

import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cvvae_tpu.models.vae_v1 import VAE1Config as JNet
from cvvae_tpu.models.video_vae import VideoVAE as JVAE
from cvvae_tpu.models.video_vae import VideoVAEConfig as JConfig
from cvvae_tpu.pipelines import diffusion as jdiff

from cvvae_tpu_torch.models.vae_v1 import VAE1Config
from cvvae_tpu_torch.models.video_vae import VideoVAE, VideoVAEConfig
from cvvae_tpu_torch.pipelines import diffusion as tdiff
from cvvae_tpu_torch.utils.convert import from_jax_params

torch.set_num_threads(2)

NET = dict(ch=8, ch_mult=(1, 2, 4, 4), num_res_blocks=1, z_channels=4,
           norm_num_groups=4)


@pytest.fixture(scope="module")
def vaes():
    cfg = dict(family="v1", tile_spatial_size=None)
    jvae = JVAE.from_config(JConfig(net=JNet(**NET), **cfg), seed=0)
    tvae = VideoVAE(VideoVAEConfig(net=VAE1Config(**NET), **cfg)).eval()
    tvae.load_state_dict(from_jax_params(jax.tree.map(np.asarray,
                                                      jvae.params)),
                         strict=True)
    return jvae, tvae


def _np(shape, seed):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


@pytest.mark.parametrize("schedule", ["scaled_linear", "linear"])
def test_betas_match_jax(schedule):
    got = tdiff._betas(schedule=schedule).numpy()
    ref = np.asarray(jdiff._betas(schedule=schedule))
    np.testing.assert_allclose(got, ref, rtol=2e-6)
    with pytest.raises(ValueError):
        tdiff._betas(schedule="cosine")


@pytest.mark.parametrize("steps", [1, 4, 50, 999])
def test_ddim_schedule_matches_jax(steps):
    t, j = tdiff.DDIMScheduler(), jdiff.DDIMScheduler()
    assert t.timesteps(steps).tolist() == \
        np.asarray(j.timesteps(steps)).tolist()
    np.testing.assert_allclose(t.alphas_cumprod().numpy(),
                               np.asarray(j.alphas_cumprod()), rtol=1e-5)
    assert t.init_noise_sigma() == j.init_noise_sigma() == 1.0


@pytest.mark.parametrize("steps", [1, 4, 30, 50])
def test_euler_schedule_matches_jax(steps):
    t, j = tdiff.EulerDiscreteScheduler(), jdiff.EulerDiscreteScheduler()
    assert t.timesteps(steps).tolist() == \
        np.asarray(j.timesteps(steps)).tolist()
    np.testing.assert_allclose(t.sigmas(steps).numpy(),
                               np.asarray(j.sigmas(steps)), rtol=1e-5)
    np.testing.assert_allclose(float(t.init_noise_sigma(steps)),
                               float(j.init_noise_sigma(steps)), rtol=1e-5)


@pytest.mark.parametrize("prediction_type", ["epsilon", "v_prediction"])
@pytest.mark.parametrize("t,t_prev", [(981, 961), (500, 480), (20, -1)])
def test_ddim_step_matches_jax(prediction_type, t, t_prev):
    ts = tdiff.DDIMScheduler(prediction_type=prediction_type)
    js = jdiff.DDIMScheduler(prediction_type=prediction_type)
    out, sample = _np((2, 4, 5, 4), 1), _np((2, 4, 5, 4), 2)
    got = ts.step(torch.from_numpy(out), t, t_prev, torch.from_numpy(sample),
                  ts.alphas_cumprod())
    ref = js.step(jnp.asarray(out), jnp.int32(t), jnp.int32(t_prev),
                  jnp.asarray(sample), js.alphas_cumprod())
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5,
                               rtol=1e-5)


def test_ddim_recovers_x0_when_eps_known():
    """One step to -1 from a sample noised with the model's eps gives x0."""
    sched = tdiff.DDIMScheduler()
    alphas = sched.alphas_cumprod()
    x0, eps = torch.from_numpy(_np((1, 4, 4, 4), 3)), \
        torch.from_numpy(_np((1, 4, 4, 4), 4))
    x_t = alphas[500].sqrt() * x0 + (1 - alphas[500]).sqrt() * eps
    torch.testing.assert_close(sched.step(eps, 500, -1, x_t, alphas), x0,
                               atol=1e-5, rtol=0)


@pytest.mark.parametrize("prediction_type", ["epsilon", "v_prediction"])
def test_euler_step_matches_jax(prediction_type):
    ts = tdiff.EulerDiscreteScheduler(prediction_type=prediction_type)
    js = jdiff.EulerDiscreteScheduler(prediction_type=prediction_type)
    sig_t, sig_j = ts.sigmas(10), js.sigmas(10)
    out, sample = _np((1, 4, 6, 4), 5), _np((1, 4, 6, 4), 6)
    for i in (0, 4, 9):
        got = ts.step(torch.from_numpy(out), sig_t[i], sig_t[i + 1],
                      ts.scale_model_input(torch.from_numpy(sample), sig_t[i]))
        ref = js.step(jnp.asarray(out), sig_j[i], sig_j[i + 1],
                      js.scale_model_input(jnp.asarray(sample), sig_j[i]))
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5,
                                   rtol=1e-5)


def test_ddim_step_computes_in_fp32():
    """A bf16 model output steps in fp32, as JAX promotes it against the
    fp32 alphas: the result is the fp32 step of its fp32 value."""
    sched = tdiff.DDIMScheduler()
    alphas = sched.alphas_cumprod()
    out = torch.from_numpy(_np((1, 4, 4, 4), 12)).bfloat16()
    sample = torch.from_numpy(_np((1, 4, 4, 4), 13))
    got = sched.step(out, 500, 480, sample, alphas)
    assert got.dtype == torch.float32
    assert torch.equal(got, sched.step(out.float(), 500, 480, sample, alphas))


def test_pipeline_refuses_euler_as_the_jax_pipeline_fails_on_it(vaes):
    """The JAX pipeline cannot drive Euler (it calls init_noise_sigma()
    with no argument and step with five); the port says so at once."""
    jvae, tvae = vaes
    with pytest.raises(ValueError, match="DDIMScheduler only"):
        tdiff.LatentDiffusionPipeline(tvae, lambda l, t, c: l,
                                      tdiff.EulerDiscreteScheduler())
    jp = jdiff.LatentDiffusionPipeline(jvae, lambda l, t, c: l,
                                       jdiff.EulerDiscreteScheduler())
    with pytest.raises(TypeError):
        jp(jax.random.PRNGKey(0), cond=jnp.zeros((1, 3, 4)), height=64,
           width=64, num_inference_steps=2, output_type="latent")


def _denoisers():
    """The same dummy eps model on both sides: it reads the latents, the
    timestep and the conditioning."""
    def torch_fn(lat, t, cond):
        return 0.1 * lat + 1e-3 * t + cond.mean(dim=(1, 2))[:, None, None,
                                                             None]

    def jax_fn(lat, t, cond):
        return 0.1 * lat + 1e-3 * t + cond.mean(axis=(1, 2))[:, None, None,
                                                             None]
    return torch_fn, jax_fn


@pytest.mark.parametrize("prediction_type", ["epsilon", "v_prediction"])
@pytest.mark.parametrize("guidance", [1.0, 7.5])
def test_pipeline_latents_match_jax(vaes, prediction_type, guidance):
    jvae, tvae = vaes
    tfn, jfn = _denoisers()
    lat = _np((1, 8, 8, 4), 7)
    cond, uncond = _np((1, 5, 6), 8), _np((1, 5, 6), 9)
    tp = tdiff.LatentDiffusionPipeline(
        tvae, tfn, tdiff.DDIMScheduler(prediction_type=prediction_type))
    jp = jdiff.LatentDiffusionPipeline(
        jvae, jfn, jdiff.DDIMScheduler(prediction_type=prediction_type))
    got = tp(cond=torch.from_numpy(cond), uncond=torch.from_numpy(uncond),
             latents=torch.from_numpy(lat), num_inference_steps=6,
             guidance_scale=guidance, output_type="latent")
    ref = jp(jax.random.PRNGKey(0), cond=jnp.asarray(cond),
             uncond=jnp.asarray(uncond), latents=jnp.asarray(lat),
             num_inference_steps=6, guidance_scale=guidance,
             output_type="latent")
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=3e-4)


def test_pipeline_cfg_stacks_a_tree_of_conditions(vaes):
    """cond / uncond may be a dict (any tree of tensors, as JAX's
    ``jax.tree.map``): each leaf is stacked [uncond, cond]."""
    jvae, tvae = vaes
    lat = _np((1, 8, 8, 4), 14)
    cond = {"a": _np((1, 5, 6), 15), "b": _np((1, 3), 16)}
    uncond = {"a": _np((1, 5, 6), 17), "b": _np((1, 3), 18)}

    def tfn(l, t, c):
        return 0.1 * l + c["a"].mean(dim=(1, 2))[:, None, None, None] + \
            c["b"][:, :1, None, None]

    def jfn(l, t, c):
        return 0.1 * l + c["a"].mean(axis=(1, 2))[:, None, None, None] + \
            c["b"][:, :1, None, None]

    got = tdiff.LatentDiffusionPipeline(tvae, tfn)(
        cond={k: torch.from_numpy(v) for k, v in cond.items()},
        uncond={k: torch.from_numpy(v) for k, v in uncond.items()},
        latents=torch.from_numpy(lat), num_inference_steps=3,
        output_type="latent")
    ref = jdiff.LatentDiffusionPipeline(jvae, jfn)(
        jax.random.PRNGKey(0), cond=jax.tree.map(jnp.asarray, cond),
        uncond=jax.tree.map(jnp.asarray, uncond), latents=jnp.asarray(lat),
        num_inference_steps=3, output_type="latent")
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=3e-4)


def test_pipeline_cfg_doubles_batch(vaes):
    seen = []

    def denoiser(lat, t, cond):
        seen.append((lat.shape[0], cond.shape[0]))
        return 0.1 * lat

    pipe = tdiff.LatentDiffusionPipeline(vaes[1], denoiser)
    pipe(torch.Generator().manual_seed(0), cond=torch.ones(1, 3, 4),
         uncond=torch.zeros(1, 3, 4), height=64, width=64,
         num_inference_steps=2, output_type="latent")
    pipe(torch.Generator().manual_seed(0), cond=torch.ones(1, 3, 4),
         height=64, width=64, num_inference_steps=2, output_type="latent")
    assert seen == [(2, 2), (2, 2), (1, 1), (1, 1)]


def test_prepare_latents_from_the_generator(vaes):
    pipe = tdiff.LatentDiffusionPipeline(vaes[1], lambda l, t, c: l)
    a = pipe.prepare_latents(torch.Generator().manual_seed(3), 2, 64, 48)
    b = pipe.prepare_latents(torch.Generator().manual_seed(3), 2, 64, 48)
    assert a.shape == (2, 8, 6, 4) and a.dtype == torch.float32
    assert torch.equal(a, b)
    with pytest.raises(ValueError, match="generator"):
        pipe(cond=torch.ones(1, 3, 4))


def test_decoded_image_matches_jax(vaes):
    """The contract: decode(latents / scaling_factor, num_frames=1),
    squeezed to (B, H, W, 3), in the latents' dtype."""
    jvae, tvae = vaes
    tfn, jfn = _denoisers()
    lat, cond = _np((2, 8, 8, 4), 10), _np((2, 5, 6), 11)
    got = tdiff.LatentDiffusionPipeline(tvae, tfn)(
        cond=torch.from_numpy(cond), latents=torch.from_numpy(lat),
        num_inference_steps=3, guidance_scale=1.0)
    ref = jdiff.LatentDiffusionPipeline(jvae, jfn)(
        jax.random.PRNGKey(0), cond=jnp.asarray(cond),
        latents=jnp.asarray(lat), num_inference_steps=3, guidance_scale=1.0)
    assert got.shape == (2, 64, 64, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=3e-4)


def test_decode_runs_in_the_latents_dtype(vaes):
    """A bf16 VAE decodes fp32 latents in fp32 (its weights cast up), as
    the JAX package's does, and bf16 latents in bf16."""
    jvae, tvae = vaes
    half = copy.deepcopy(tvae).to(torch.bfloat16)
    pipe = tdiff.LatentDiffusionPipeline(half, None)
    lat = _np((1, 8, 8, 4), 19)
    got = pipe.decode_latents(torch.from_numpy(lat))
    ref = jdiff.LatentDiffusionPipeline(jvae.astype(jnp.bfloat16), None) \
        .decode_latents(jnp.asarray(lat))
    assert got.dtype == torch.float32 and ref.dtype == jnp.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=3e-4)
    assert pipe.decode_latents(
        torch.from_numpy(lat).bfloat16()).dtype == torch.bfloat16
