"""Shared cases of the port's mesh tests (``tests/test_torch_parallel*.py``):
tiny v1 and SD3 VideoVAEs with the same weights in both packages, the
shapes and tolerances of ``tests/test_parallel.py``, and a CPU mesh of the
port over gloo (a ``file://`` rendezvous under the test's temporary
directory, so concurrent test processes do not collide)."""

import functools

import numpy as np
import torch

import jax
import jax.numpy as jnp

from cvvae_tpu.models import vae_sd3 as jvae_sd3
from cvvae_tpu.models import vae_v1 as jvae_v1
from cvvae_tpu.models.vae_sd3 import VAESD3Config as JSD3
from cvvae_tpu.models.vae_v1 import VAE1Config as JV1
from cvvae_tpu.models.video_vae import VideoVAE as JVAE
from cvvae_tpu.models.video_vae import VideoVAEConfig as JConfig
from cvvae_tpu.parallel.mesh import make_mesh as jmake_mesh

from cvvae_tpu_torch.models.vae_sd3 import VAESD3Config
from cvvae_tpu_torch.models.vae_v1 import VAE1Config
from cvvae_tpu_torch.models.video_vae import VideoVAE, VideoVAEConfig
from cvvae_tpu_torch.parallel import make_mesh
from cvvae_tpu_torch.utils.convert import from_jax_params

V1_NET = dict(ch=8, ch_mult=(1, 2, 4, 4), num_res_blocks=1, z_channels=4,
              norm_num_groups=4)
SD3_NET = dict(block_out_channels=(8, 8, 8, 8), layers_per_block=1,
               latent_channels=4, norm_num_groups=4)
NETS = {"v1": (V1_NET, JV1, VAE1Config), "sd3": (SD3_NET, JSD3, VAESD3Config)}
BASE = dict(tile_spatial_size=None, en_de_n_frames_a_time=None)

#: tests/test_parallel.py's inputs: H-sharded (1, 5, 64, W, 3) clips (v1
#: W 32, SD3 W 16) and T-sharded 16-frame clips (T divisible by the mesh)
SHAPES = {("v1", "height"): (1, 5, 64, 32, 3),
          ("v1", "time"): (1, 16, 32, 32, 3),
          ("sd3", "height"): (1, 5, 64, 16, 3),
          ("sd3", "time"): (1, 16, 32, 16, 3)}
#: and its tolerances: latents, then frames (5e-5 H-sharded, 3e-5 T)
LATENT_TOL = dict(atol=2e-5, rtol=1e-4)
FRAME_TOL = {"height": dict(atol=5e-5, rtol=1e-4),
             "time": dict(atol=3e-5, rtol=1e-4)}


def port_mesh(n, tmp_path_factory):
    """The port's CPU mesh of ``n`` ranks over gloo."""
    init = tmp_path_factory.mktemp("mesh") / "rendezvous"
    return make_mesh(n, devices=["cpu"] * n, backend="gloo",
                     init_method=f"file://{init}")


@functools.lru_cache(maxsize=None)
def _weights(family):
    """Params of a tiny ``family`` net in JAX's tree (its structure from
    ``jax.eval_shape`` of the package's init, its values drawn with numpy
    from seed 0: kernels U(±1/sqrt(fan_in)) as torch's default, biases
    U(±0.1), norm scales 1 + U(±0.1)) and the port's state converted from
    them.  JAX's own init compiles for tens of seconds on the CPU."""
    kw, jnet, _ = NETS[family]
    net = jnet(**kw)
    mod = jvae_v1 if family == "v1" else jvae_sd3
    shapes = jax.eval_shape(lambda k: {
        "encoder": mod.init_encoder(k, net, jnp.float32),
        "decoder": mod.init_decoder(k, net, jnp.float32)},
        jax.random.PRNGKey(0))
    rs = np.random.RandomState(0)

    def leaf(path, s):
        name = str(getattr(path[-1], "key", path[-1]))
        if name == "kernel":
            bound = 1.0 / np.sqrt(np.prod(s.shape[:-1]))
        elif name == "scale":
            return jnp.asarray(1 + rs.uniform(-0.1, 0.1, s.shape)
                               .astype(np.float32))
        else:
            bound = 0.1
        return jnp.asarray(rs.uniform(-bound, bound, s.shape)
                           .astype(np.float32))

    params = jax.tree_util.tree_map_with_path(leaf, shapes)
    return params, from_jax_params(jax.tree.map(np.asarray, params))


def pair(family, **overrides):
    """(JAX VideoVAE, the port's VideoVAE on the CPU) of a tiny ``family``
    net with the same weights."""
    kw, jnet, tnet = NETS[family]
    cfg = dict(BASE, **overrides)
    if family == "sd3":
        cfg.setdefault("scaling_factor", 1.5305)
    params, state = _weights(family)
    jvae = JVAE(JConfig(family=family, net=jnet(**kw), **cfg), params)
    tvae = VideoVAE(VideoVAEConfig(family=family, net=tnet(**kw), **cfg))
    tvae.load_state_dict(state, strict=True)
    return jvae, tvae.eval().requires_grad_(False)


def clip(shape, seed=1):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def roundtrip_port(vae, x):
    """(latents, frames) of the port's ``vae`` on numpy ``x``."""
    z = vae.encode(torch.from_numpy(x)).mode()
    return z.numpy(), vae.decode(z).numpy()


def roundtrip_jax(vae, x):
    z = vae.encode(jax.numpy.asarray(x)).mode()
    return np.asarray(z), np.asarray(vae.decode(z))


def jax_mesh(n):
    return jmake_mesh(n)
