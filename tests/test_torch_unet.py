"""The port's UNet (``models/unet2d.py``) and its converters, on the CPU.

The tiny UNet of tests/test_unet.py (the diffusers-named torch stub,
``tests/torch_ref/unet_stub.py``) is held in fp32:

* against the jitted JAX ``apply_unet`` at JAX_TOL relative to max|ref|:
  both compute the same function in the same dtypes (tanh GEGLU,
  two-pass fp32 GroupNorm, matmul attention with an fp32 softmax), and
  only the order of fp32 sums differs (1.4e-6 relative measured);
* against the stub at STUB_TOL abs, a bound that states the GELU gap: the
  stub takes diffusers' exact (erf) GELU, the JAX package and the port
  the tanh form (the JAX output is 4.4e-5 off the stub, and so is the
  port's).

The UNet's ``_group_norm`` is held to JAX's on its own at the SD 2.1
UNet's widths (C = 320, 960, 2560; G = 32; eps 1e-5 and 1e-6): in fp32
within GN_F32_TOL of max|ref|, in bf16 within one bf16 ulp beyond that
fp32 spread elementwise and bit-equal on at least GN_BF16_EQUAL of the
elements.  K1's plain version (E[x²] − mean², the affine folded in the
input dtype) fails that bf16 bound, so routing the UNet's norms there
shows here.

The converters: ``convert_unet_state_dict`` (a diffusers checkpoint) and
``from_jax_params(..., conv2d=True)`` (the JAX tree) give the same state
dict, which loads strictly; ``load_unet_checkpoint`` reads a dir written
here; the SD 2.1 manifest (tests/data/unet_sd21_keys.json) loads strictly
into a full-width module on the meta device.
"""

import json
import os
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cvvae_tpu.models import unet2d as junet2d
from cvvae_tpu.models.unet2d import UNet2DConfig as JConfig
from cvvae_tpu.models.unet2d import apply_unet
from cvvae_tpu.utils.convert import convert_unet_state_dict as jconvert
from tests.torch_ref.unet_stub import UNet2DConditionModel

import chip_smoke
from cvvae_tpu_torch.models import unet2d
from cvvae_tpu_torch.models.unet2d import UNet2D, UNet2DConfig, make_denoiser
from cvvae_tpu_torch.ops.kernels.groupnorm import group_norm_silu_plain
from cvvae_tpu_torch.utils.convert import (convert_unet_state_dict,
                                           from_jax_params,
                                           load_unet_checkpoint,
                                           unet_config_from_json)

torch.set_num_threads(2)

TINY = dict(in_channels=4, out_channels=4, block_out_channels=(32, 64),
            layers_per_block=1, cross_attention_dim=32, attention_head_dim=8,
            norm_num_groups=8)
JAX_TOL = 1e-5
STUB_TOL = 1e-4
GN_F32_TOL = 4e-6
GN_BF16_EQUAL = 0.999
_DATA = os.path.join(os.path.dirname(__file__), "data")


@pytest.fixture(scope="module")
def tiny():
    torch.manual_seed(0)
    stub = UNet2DConditionModel(**TINY).eval()
    params = jconvert(stub.state_dict())
    port = UNet2D(UNet2DConfig(**TINY)).eval()
    port.load_state_dict(from_jax_params(jax.tree.map(np.asarray, params),
                                         conv2d=True), strict=True)
    return stub, params, port


def _inputs(seed=1):
    rng = np.random.RandomState(seed)
    return (rng.randn(2, 16, 16, 4).astype(np.float32),
            np.asarray([3.0, 500.0], np.float32),
            rng.randn(2, 7, 32).astype(np.float32))


def _port(port, x, t, ctx):
    with torch.no_grad():
        return port(torch.from_numpy(x), torch.from_numpy(t),
                    torch.from_numpy(ctx)).numpy()


def test_unet_matches_jax(tiny):
    _, params, port = tiny
    x, t, ctx = _inputs()
    ref = np.asarray(jax.jit(lambda p, *a: apply_unet(p, *a, JConfig(**TINY)))(
        params, jnp.asarray(x), jnp.asarray(t), jnp.asarray(ctx)))
    got = _port(port, x, t, ctx)
    assert got.shape == (2, 16, 16, 4) and got.dtype == np.float32
    np.testing.assert_allclose(got, ref, atol=JAX_TOL * np.abs(ref).max(),
                               rtol=0)


def test_unet_matches_exact_gelu_stub_within_the_gelu_gap(tiny):
    stub, _, port = tiny
    x, t, ctx = _inputs(2)
    with torch.no_grad():
        ref = stub(torch.from_numpy(x.transpose(0, 3, 1, 2).copy()),
                   torch.from_numpy(t), torch.from_numpy(ctx)).numpy()
    gap = np.abs(_port(port, x, t, ctx) - ref.transpose(0, 2, 3, 1)).max()
    assert 0.0 < gap <= STUB_TOL


@pytest.mark.parametrize("t", [7, 250.0, np.float32(999.0)])
def test_scalar_timestep_broadcasts(tiny, t):
    """A number or 0-d timestep applies to every batch row, as a (B,) one."""
    _, _, port = tiny
    x, _, ctx = _inputs(3)
    full = _port(port, x, np.full(2, float(t), np.float32), ctx)
    with torch.no_grad():
        got = port(torch.from_numpy(x), torch.as_tensor(t),
                   torch.from_numpy(ctx)).numpy()
    np.testing.assert_array_equal(got, full)


def test_denoiser_runs_in_the_dtype_asked(tiny):
    """None: the latents' dtype, as JAX's denoiser; bf16: the UNet in bf16
    (the weights cast to it), the output back in the latents' dtype."""
    _, _, port = tiny
    x, _, ctx = _inputs(4)
    lat, cond = torch.from_numpy(x), torch.from_numpy(ctx)
    out = make_denoiser(port)(lat, 10, cond)
    assert out.dtype == torch.float32 and not out.requires_grad
    with torch.no_grad():
        assert torch.equal(out, port(lat, 10, cond))
        ref = port(lat.bfloat16(), 10, cond.bfloat16()).float()
    half = make_denoiser(port, torch.bfloat16)(lat, 10, cond)
    assert half.dtype == torch.float32 and torch.equal(half, ref)


def _gn_case(c, seed):
    """(2, 16, 16, C) activations whose channels each have their own mean
    and spread, and a random affine."""
    rng = np.random.RandomState(seed)
    x = (rng.randn(2, 16, 16, c) * rng.uniform(0.5, 3.0, c)
         + rng.uniform(-4.0, 4.0, c)).astype(np.float32)
    return x, rng.uniform(0.5, 1.5, c).astype(np.float32), \
        rng.randn(c).astype(np.float32)


def _bf16_ulp(a: np.ndarray) -> np.ndarray:
    """The spacing of bf16 values at |a| (its 8-bit significand)."""
    a = np.maximum(np.abs(a), np.finfo(np.float32).tiny)
    return np.exp2(np.floor(np.log2(a)) - 7)


def _gn_pair(c, eps, norm):
    x, w, b = _gn_case(c, c)
    p = types.SimpleNamespace(weight=torch.from_numpy(w),
                              bias=torch.from_numpy(b))
    jp = {"scale": jnp.asarray(w), "bias": jnp.asarray(b)}
    out = {}
    for dt, jdt in ((torch.float32, jnp.float32),
                    (torch.bfloat16, jnp.bfloat16)):
        got = norm(torch.from_numpy(x).to(dt), p, eps).float().numpy()
        ref = jax.jit(lambda v: junet2d._group_norm(v, jp, 32, eps))(
            jnp.asarray(x, jdt))
        out[dt] = got, np.asarray(ref.astype(jnp.float32))
    return out


def _gn_within_bounds(out):
    """(fp32 within GN_F32_TOL, bf16 within one ulp beyond the fp32 spread,
    bf16's bit-equal share)."""
    got32, ref32 = out[torch.float32]
    spread = GN_F32_TOL * np.abs(ref32).max()
    got16, ref16 = out[torch.bfloat16]
    return (np.abs(got32 - ref32).max() <= spread,
            bool((np.abs(got16 - ref16) <= _bf16_ulp(ref16) + spread).all()),
            float((got16 == ref16).mean()))


@pytest.mark.parametrize("eps", [1e-5, 1e-6])
@pytest.mark.parametrize("c", [320, 960, 2560])
def test_group_norm_matches_jax(c, eps):
    f32, bf16, equal = _gn_within_bounds(_gn_pair(
        c, eps, lambda x, p, e: unet2d._group_norm(x, p, 32, e)))
    assert f32 and bf16 and equal >= GN_BF16_EQUAL, (f32, bf16, equal)


def test_group_norm_bound_catches_k1s_plain_arithmetic():
    """K1's plain version at the same inputs leaves the bf16 bound: the
    test above would fail if the UNet's norms computed as it does."""
    def k1(x, p, eps):
        return group_norm_silu_plain(x, p.weight, p.bias, num_groups=32,
                                     eps=eps)
    f32, bf16, equal = _gn_within_bounds(_gn_pair(960, 1e-5, k1))
    assert not bf16 and equal < GN_BF16_EQUAL


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layer_norm_and_attention_match_jax(dtype):
    """``_layer_norm`` and one transformer's attention (its q/k/v products
    in the input dtype, the fp32 softmax, the weights cast back) against
    the JAX package's, fp32 at 1e-5 of max|ref|, bf16 within one bf16 ulp
    of |ref| plus that."""
    rng = np.random.RandomState(7)
    x = (rng.randn(2, 40, 64) * 2 + 1).astype(np.float32)
    ctx = rng.randn(2, 9, 48).astype(np.float32)
    torch.manual_seed(1)
    attn = unet2d.Attention(64, 48, 16).eval()
    norm = types.SimpleNamespace(weight=torch.rand(64) + 0.5,
                                 bias=torch.randn(64))
    jp = {k: {"kernel": jnp.asarray(getattr(attn, k).weight.detach().numpy().T)}
          for k in ("to_q", "to_k", "to_v")}
    jp["to_out"] = {"kernel": jnp.asarray(attn.to_out.weight.detach().numpy().T),
                    "bias": jnp.asarray(attn.to_out.bias.detach().numpy())}
    jnorm = {"scale": jnp.asarray(norm.weight.numpy()),
             "bias": jnp.asarray(norm.bias.numpy())}
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    with torch.no_grad():
        got = [unet2d._layer_norm(torch.from_numpy(x).to(tdt), norm),
               attn(torch.from_numpy(x).to(tdt), torch.from_numpy(ctx).to(tdt))]
    ref = [junet2d._layer_norm(jnp.asarray(x, jdt), jnorm),
           junet2d._attention(jp, jnp.asarray(x, jdt), jnp.asarray(ctx, jdt),
                              16)]
    for g, r in zip(got, ref):
        g, r = g.float().numpy(), np.asarray(r.astype(jnp.float32))
        tol = 1e-5 * np.abs(r).max()
        if dtype == "bfloat16":
            tol = tol + _bf16_ulp(r)
        assert (np.abs(g - r) <= tol).all(), np.abs(g - r).max()


def test_converters_agree_and_load_strictly(tiny):
    stub, params, _ = tiny
    from_jax = from_jax_params(jax.tree.map(np.asarray, params), conv2d=True)
    from_torch = convert_unet_state_dict(stub.state_dict())
    assert from_jax.keys() == from_torch.keys()
    for k, v in from_torch.items():
        assert torch.equal(v, from_jax[k]), k
    expected = {k: tuple(v.shape)
                for k, v in UNet2D(UNet2DConfig(**TINY)).state_dict().items()}
    assert {k: tuple(v.shape) for k, v in from_torch.items()} == expected
    assert from_torch["down_blocks.0.downsamplers.0.weight"].shape == \
        (32, 32, 3, 3)
    assert "down_blocks.0.attentions.0.transformer_blocks.0.ff_proj.weight" \
        in from_torch
    # without conv2d a (1, kH, kW, I, O) kernel stays a per-frame Conv3d's
    assert from_jax_params(jax.tree.map(np.asarray, params))[
        "conv_in.weight"].shape == (32, 4, 1, 3, 3)


def test_load_unet_checkpoint(tiny, tmp_path):
    from safetensors.torch import save_file

    stub, _, port = tiny
    with open(tmp_path / "config.json", "w") as f:
        json.dump(dict(TINY, block_out_channels=[32, 64],
                       _class_name="UNet2DConditionModel"), f)
    state = {k: v.contiguous() for k, v in stub.state_dict().items()}
    keys = sorted(state)
    save_file({k: state[k] for k in keys[:40]},
              str(tmp_path / "part-1.safetensors"))
    save_file({k: state[k] for k in keys[40:]},
              str(tmp_path / "part-2.safetensors"))
    loaded = load_unet_checkpoint(str(tmp_path), device="cpu")
    assert loaded.config == UNet2DConfig(**TINY)
    assert loaded.conv_in.weight.is_contiguous(
        memory_format=torch.channels_last)
    x, t, ctx = _inputs(5)
    np.testing.assert_array_equal(_port(loaded, x, t, ctx),
                                  _port(port, x, t, ctx))


@pytest.mark.parametrize("cfg_json,head", [
    ({"attention_head_dim": [5, 10, 20, 20],
      "block_out_channels": [320, 640, 1280, 1280]}, 64),
    ({"attention_head_dim": 8, "block_out_channels": [32, 64]}, 8),
    ({"block_out_channels": [32, 64]}, 64)])
def test_unet_config_head_dim(cfg_json, head):
    """A list-valued head dim gives block_out_channels[0] // its first
    entry, as the JAX package's loader has it."""
    assert unet_config_from_json(cfg_json).attention_head_dim == head


def test_sd21_manifest_loads_strictly_at_full_width():
    with open(os.path.join(_DATA, "unet_sd21_keys.json")) as f:
        manifest = json.load(f)
    cfg = unet_config_from_json(manifest["config"])
    assert cfg == UNet2DConfig()
    state = {k: torch.empty(s, device="meta")
             for k, s in manifest["keys"].items()}
    converted = convert_unet_state_dict(state)
    with torch.device("meta"):
        net = UNet2D(cfg)
    net.load_state_dict(converted, strict=True, assign=True)
    n = sum(p.numel() for p in net.parameters())
    assert n == manifest["n_params"] == chip_smoke.SD21_UNET_PARAMS
    assert net.up_blocks[1].resnets[0].conv1.weight.shape == \
        (1280, 2560, 3, 3)
    assert not hasattr(net.up_blocks[0], "attentions")


def test_entry_points_run_on_the_card_unless_asked_for_the_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        UNet2D.from_config(UNet2DConfig(**TINY))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        load_unet_checkpoint(str(tmp_path))
    net = UNet2D.from_config(UNet2DConfig(**TINY), seed=3, device="cpu")
    again = UNet2D.from_config(UNet2DConfig(**TINY), seed=3, device="cpu")
    assert all(torch.equal(a, b) for a, b in
               zip(net.state_dict().values(), again.state_dict().values()))
    assert not net.conv_in.weight.requires_grad


def test_written_diffusers_dir_round_trips(tiny, tmp_path):
    """chip_smoke's writer (phase 9) lays the port's UNet out as diffusers
    names it, with SD 2.1's per-block head counts in config.json, and
    ``load_unet_checkpoint`` reads it back bit-equal."""
    stub, _, port = tiny
    layout = chip_smoke.unet_reference_layout(
        convert_unet_state_dict(stub.state_dict()))
    assert layout.keys() == stub.state_dict().keys()
    assert all(torch.equal(v, stub.state_dict()[k]) for k, v in layout.items())
    chip_smoke.write_unet_checkpoint(str(tmp_path), port)
    with open(tmp_path / "config.json") as f:
        assert json.load(f)["attention_head_dim"] == [4, 8]
    loaded = load_unet_checkpoint(str(tmp_path), device="cpu")
    assert loaded.config == port.config
    assert all(torch.equal(v, loaded.state_dict()[k])
               for k, v in port.state_dict().items())


@pytest.mark.parametrize("kernel,group", [
    ("sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x128x64",
     "GEMMs (dense, attention)"),
    ("nvjet_tst_256x128_64x4_1x2_h_bz_coopA_NNT", "GEMMs (dense, attention)"),
    ("sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc",
     "cuDNN convs"),
    ("void at::native::(anonymous namespace)::cunn_SoftMaxForwardReg<float>",
     "softmax"),
    ("void at::native::reduce_kernel<512, 1, at::native::ReduceOp<float, "
     "at::native::MeanOps<float>>>", "reductions (norm moments)")])
def test_profile_groups_the_unet_steps_kernels(kernel, group):
    """``utils/profiling``'s groups name a UNet step's kernels: cuBLAS's
    products apart from cuDNN's convs (both sm90_xmma_*), the softmax
    whatever its case, the norms' mean reductions."""
    import re

    from cvvae_tpu_torch.utils import profiling

    assert next(g for g, pat in profiling.GROUPS
                if re.search(pat, kernel)) == group
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="needs a CUDA card"):
            profiling.main(["--unet_step"])
