"""The port's encoder and decoder gradients against ``jax.grad`` of the
JAX package's, at a narrow width, for both families, with the port's
remat (``torch.utils.checkpoint`` per resblock) on and off.

The convs run the reference's edge-pad decompositions
(``_conv3d_edge_time_fast`` for v1's causal convs, ``_conv3d_edge_fast``
for SD3's replicate pads), whose in-place adds into the output's boundary
slices autograd differentiates; the upsamplers run K2's plain version and
every GroupNorm K1's, through their autograd Functions.  The loss is
sum(decoder(encoder(x)[..., :z] + mean) * r) for a fixed random r.
Tolerance: |g - ref| <= 1e-4 * max|ref| per tensor, plus 1e-6 of the
largest gradient of the nets (fp32 sums in other orders through two nets;
the floor is for the attention key biases, whose gradient is zero but for
rounding noise).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cvvae_tpu.models import vae_sd3 as jsd3
from cvvae_tpu.models import vae_v1 as jv1

from cvvae_tpu_torch.models import vae_sd3 as tsd3
from cvvae_tpu_torch.models import vae_v1 as tv1
from cvvae_tpu_torch.utils.convert import from_jax_params

torch.set_num_threads(2)

TOL = 1e-4
FLOOR = 1e-6
FAMILIES = {
    "v1": (jv1, tv1, "VAE1Config",
           dict(ch=8, ch_mult=(1, 2, 4, 4), num_res_blocks=1, z_channels=4,
                norm_num_groups=4), 4),
    "sd3": (jsd3, tsd3, "VAESD3Config",
            dict(block_out_channels=(8, 16, 16, 16), layers_per_block=1,
                 latent_channels=4, norm_num_groups=4), 4),
}
CLIP = (1, 5, 16, 16, 3)


def _loss_inputs():
    r = np.random.RandomState(0)
    x = r.uniform(-1, 1, CLIP).astype(np.float32)
    w = r.randn(*CLIP).astype(np.float32)
    return x, w


@pytest.fixture(scope="module", params=list(FAMILIES))
def family(request):
    jmod, tmod, cfg_name, kw, z = FAMILIES[request.param]
    jcfg = getattr(jmod, cfg_name)(**kw)
    keys = jax.random.split(jax.random.PRNGKey(0))
    params = {"encoder": jmod.init_encoder(keys[0], jcfg),
              "decoder": jmod.init_decoder(keys[1], jcfg)}
    x, w = _loss_inputs()

    def loss(p):
        m = jmod.apply_encoder(p["encoder"], jnp.asarray(x), jcfg)
        y = jmod.apply_decoder(p["decoder"], m[..., :z] + m[..., z:].mean(),
                               jcfg)
        return jnp.sum(y * jnp.asarray(w))

    grads = jax.jit(jax.grad(loss))(params)
    ref = from_jax_params(jax.tree.map(np.asarray, grads))
    tcfg = getattr(tmod, cfg_name)(**kw)
    return tmod, tcfg, from_jax_params(jax.tree.map(np.asarray, params)), \
        ref, z


@pytest.mark.parametrize("remat", [False, True])
def test_gradients_match_jax_grad(family, remat):
    tmod, tcfg, state, ref, z = family
    enc, dec = tmod.Encoder(tcfg), tmod.Decoder(tcfg)
    enc.load_state_dict({k[8:]: v for k, v in state.items()
                         if k.startswith("encoder.")}, strict=True)
    dec.load_state_dict({k[8:]: v for k, v in state.items()
                         if k.startswith("decoder.")}, strict=True)
    x, w = (torch.from_numpy(a) for a in _loss_inputs())
    m = enc(x, remat=remat)
    y = dec(m[..., :z] + m[..., z:].mean(), remat=remat)
    (y * w).sum().backward()
    got = {**{"encoder." + k: p.grad for k, p in enc.named_parameters()},
           **{"decoder." + k: p.grad for k, p in dec.named_parameters()}}
    assert set(got) == set(ref)
    floor = FLOOR * max(r.abs().max().item() for r in ref.values())
    for k, r in ref.items():
        g = got[k]
        assert g is not None, k
        bound = TOL * r.abs().max().item() + floor
        assert (g - r).abs().max().item() <= bound, k


def test_decoder_head_split_matches_full_decoder(family):
    """``features_only`` + ``apply_decoder_head`` is the decoder."""
    tmod, tcfg, state, _, z = family
    dec = tmod.Decoder(tcfg)
    dec.load_state_dict({k[8:]: v for k, v in state.items()
                         if k.startswith("decoder.")}, strict=True)
    lat = torch.randn(1, 2, 2, 2, z)
    with torch.no_grad():
        full = dec(lat)
        h = dec(lat, features_only=True)
        torch.testing.assert_close(
            tmod.apply_decoder_head(dec.conv_out, h, tcfg), full, rtol=0,
            atol=0)
