"""The port's int8 serving mode (``cvvae_tpu_torch/ops/quant.py``, K5's
plain version, ``VideoVAE.quantize``) against the JAX package's, on the
CPU.

Inputs are made with numpy from a seed and handed to both.  To run int8
at small shapes, ``INT8_MIN_POSITIONS`` is lowered in both packages
(each reads it when a conv is called).  Tolerances, each with its reason:

* the quantizers are elementwise fp32 divisions, roundings and clips:
  bit-equal;
* the int8 convs' accumulators are exact integers on both sides, so in
  fp32 only the epilogue's rounding order may differ: max|d| <= 1e-6 *
  max|ref|; in bf16 one rounding of that: at most one bf16 ulp (2^-7 of
  the larger magnitude);
* a whole net compounds roundings through GroupNorm and attention, and a
  value one rounding apart may quantize to the next int8 step: PSNR >= 40
  dB between the two packages' int8 outputs.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cvvae_tpu.models.vae_sd3 import VAESD3Config as JSD3
from cvvae_tpu.models.vae_v1 import VAE1Config as JNet
from cvvae_tpu.models.video_vae import VideoVAE as JVAE
from cvvae_tpu.models.video_vae import VideoVAEConfig as JConfig
from cvvae_tpu.ops import conv as jconv
from cvvae_tpu.ops import quant as jquant
from cvvae_tpu.ops.upsample_conv import \
    upsample2x_conv3x3_interleave as jupsample

from cvvae_tpu_torch.models.vae_sd3 import VAESD3Config
from cvvae_tpu_torch.models.vae_v1 import VAE1Config
from cvvae_tpu_torch.models.video_vae import VideoVAE, VideoVAEConfig
from cvvae_tpu_torch.ops import conv as tconv
from cvvae_tpu_torch.ops import quant
from cvvae_tpu_torch.ops.kernels import conv_int8 as k5
from cvvae_tpu_torch.ops.upsample_conv import upsample2x_conv3x3_interleave
from cvvae_tpu_torch.utils.convert import from_jax_params

torch.set_num_threads(2)

DTYPES = {"fp32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
#: narrow nets whose deeper levels reach the 64 input channels that
#: quantize by default
NETS = {
    "v1": (JNet, VAE1Config, dict(ch=32, ch_mult=(1, 2, 4), num_res_blocks=1,
                                  z_channels=4, norm_num_groups=8)),
    "sd3": (JSD3, VAESD3Config, dict(block_out_channels=(32, 64, 128),
                                     layers_per_block=1, latent_channels=16,
                                     norm_num_groups=8)),
}
BASE = dict(en_de_n_frames_a_time=None, tile_spatial_size=None)


def _np(shape, seed, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(
        np.float32)


def _pair(a, jdt, tdt):
    """One numpy array as a JAX and a torch tensor of the same dtype."""
    return jnp.asarray(a).astype(jdt), torch.from_numpy(a).to(tdt)


def _f32(v):
    if isinstance(v, torch.Tensor):
        return v.detach().float().numpy()
    return np.asarray(jnp.asarray(v).astype(jnp.float32))


@pytest.fixture
def low_threshold(monkeypatch):
    """int8 at every conv of a small input, in both packages."""
    monkeypatch.setattr(jquant, "INT8_MIN_POSITIONS", 1)
    monkeypatch.setattr(quant, "INT8_MIN_POSITIONS", 1)


def _ulp_close(got, ref):
    """At most one bf16 ulp apart (2^-7 of the larger magnitude)."""
    g, r = _f32(got), _f32(ref)
    assert g.shape == r.shape
    bound = 2.0 ** -7 * np.maximum(np.abs(g), np.abs(r))
    assert (np.abs(g - r) <= bound).all(), np.abs(g - r).max()


def _rel_close(got, ref, rel=1e-6):
    g, r = _f32(got), _f32(ref)
    assert g.shape == r.shape
    assert np.abs(g - r).max() <= rel * np.abs(r).max(), np.abs(g - r).max()


# ---------------------------------------------------------------------------
# the quantizers: bit-equal
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dt", DTYPES)
def test_quantize_kernel_bit_equal(dt):
    jdt, tdt = DTYPES[dt]
    k = _np((3, 3, 3, 48, 24), 0, 0.05)
    k[..., 3] = 0.0                                  # an all-zero channel
    jk, tk = _pair(k, jdt, tdt)
    jq, js = jquant.quantize_kernel(jk)
    tq, ts = quant.quantize_kernel(tk.permute(4, 3, 0, 1, 2))
    np.testing.assert_array_equal(tq.numpy(),
                                  np.asarray(jq).transpose(4, 3, 0, 1, 2))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    back = quant.dequantize_kernel(type("P", (), dict(weight_q=tq,
                                                      scale_w=ts)))
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(jquant.dequantize_kernel(
            {"kernel_q": jq, "scale_w": js})).transpose(4, 3, 0, 1, 2))


@pytest.mark.parametrize("dt", DTYPES)
def test_quantize_act_bit_equal(dt):
    jdt, tdt = DTYPES[dt]
    x = _np((2, 3, 8, 8, 16), 1)
    jx, tx = _pair(x, jdt, tdt)
    jq, js = jquant.quantize_act(jx)
    tq, ts = quant.quantize_act(tx)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    assert ts.dtype == torch.float32 and float(ts) == float(js)


@pytest.mark.parametrize("dt", DTYPES)
def test_quantize_act_static_bit_equal(dt):
    """A scale of 2^-6 makes x / scale exact, so the values placed on
    half steps test the rounding half to even; 0.0123 tests the division;
    values past 127 steps test the clip."""
    jdt, tdt = DTYPES[dt]
    halves = (np.arange(-140, 140) + 0.5) * 2.0 ** -6
    x = np.concatenate([halves, _np((500,), 2, 2.0)]).astype(np.float32)
    jx, tx = _pair(x, jdt, tdt)
    for s in (2.0 ** -6, 0.0123):
        jq = jquant.quantize_act_static(jx, jnp.float32(s))
        tq = quant.quantize_act_static(tx, torch.tensor(s, dtype=torch.float32))
        np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))


# ---------------------------------------------------------------------------
# which convs quantize
# ---------------------------------------------------------------------------

def _nets(family, seed=0):
    jnet, tnet, kw = NETS[family]
    jvae = JVAE.from_config(JConfig(family=family, net=jnet(**kw), **BASE),
                            seed=seed)
    tvae = VideoVAE(VideoVAEConfig(family=family, net=tnet(**kw),
                                   **BASE)).eval()
    tvae.load_state_dict(from_jax_params(jax.tree.map(np.asarray,
                                                      jvae.params)),
                         strict=True)
    return jvae, tvae


@pytest.mark.parametrize("skip", [(), ("mid",)])
@pytest.mark.parametrize("family", ["v1", "sd3"])
def test_quantize_selects_the_same_convs(family, skip):
    jvae, tvae = _nets(family)
    jq = JVAE(jvae.config, jquant.quantize_conv_params(jvae.params,
                                                       skip_paths=skip))
    tq = tvae.quantize(skip_paths=skip)
    want = from_jax_params(jax.tree.map(np.asarray, jq.params))
    got = tq.state_dict()
    assert set(got) == set(want)
    assert any(k.endswith("weight_q") for k in got)
    for k in got:
        np.testing.assert_array_equal(got[k].numpy(), want[k].numpy(), k)
    # the caller's model is left as it was
    assert not tvae._is_quantized() and tq._is_quantized()


# ---------------------------------------------------------------------------
# the quantized conv and upsample against JAX's
# ---------------------------------------------------------------------------

SPECS = ["v1_causal", "v1_plain", "sd3_causal", "sd3_plain", "spatial2d",
         "v1_downsample_t", "v1_downsample_s"]


def _spec(pkg, name):
    if name.startswith("v1_downsample"):
        return pkg.Conv3DSpec.v1_downsample(down_time=name.endswith("_t"))
    return getattr(pkg.Conv3DSpec, name)()


def _conv_pair(name, jdt, tdt, cin=64, cout=32):
    jspec, tspec = _spec(jconv, name), _spec(tconv, name)
    p = jconv.conv_init(jax.random.PRNGKey(3), jspec, cin, cout)
    tmod = tconv.Conv(tspec, cin, cout).requires_grad_(False)
    tmod.load_state_dict(from_jax_params(jax.tree.map(np.asarray, p)))
    p, tmod = jax.tree.map(lambda a: a.astype(jdt), p), tmod.to(tdt)
    return (jquant.quantize_conv_params(p, min_cin=1), jspec,
            quant.quantize_conv_params(tmod, min_cin=1), tspec)


@pytest.mark.parametrize("int8", [True, False], ids=["int8", "dequantized"])
@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("name", SPECS)
def test_quantized_conv3d_matches_jax(monkeypatch, name, dt, int8):
    """Above the threshold the int8 conv, below it the float conv on the
    dequantized kernel, each against JAX's ``conv3d``."""
    threshold = 1 if int8 else 10 ** 9
    monkeypatch.setattr(jquant, "INT8_MIN_POSITIONS", threshold)
    monkeypatch.setattr(quant, "INT8_MIN_POSITIONS", threshold)
    jdt, tdt = DTYPES[dt]
    jp, jspec, tmod, tspec = _conv_pair(name, jdt, tdt)
    jx, tx = _pair(_np((1, 5, 9, 11, 64), 4), jdt, tdt)
    ref = jconv.conv3d(jx, jp, jspec)
    got = tmod(tx)
    if dt == "fp32":
        _rel_close(got, ref)
    elif int8:
        _ulp_close(got, ref)
    else:
        # below the threshold the port's float bf16 conv runs, whose edge
        # decompositions round the main conv, each fix and each add apart
        # (ops/conv.py): up to 0.0053 past one ulp here, so 2e-2 * max|ref|
        _rel_close(got, ref, 2e-2)


@pytest.mark.parametrize("dt", DTYPES)
def test_static_scale_equals_dynamic(low_threshold, dt):
    """With scale_x set to the dynamic max-scale the static path is
    bit-identical to dynamic quantization (as tests/test_quant.py holds
    the reference)."""
    _, tdt = DTYPES[dt]
    _, _, tmod, _ = _conv_pair("v1_plain", DTYPES[dt][0], tdt, 64, 64)
    x = torch.from_numpy(_np((1, 6, 16, 16, 64), 5)).to(tdt)
    y_dyn = tmod(x)
    tmod.register_buffer("scale_x", quant.act_scale(x))
    assert torch.equal(tmod(x), y_dyn)


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("hw_mode", ["zero", "edge"])
@pytest.mark.parametrize("n", [1, 2])
def test_int8_upsample_matches_jax(low_threshold, n, hw_mode, dt):
    jdt, tdt = DTYPES[dt]
    k = _np((3, 3, 3, 64, 64 * n), 6, 0.05)
    b = _np((64 * n,), 7, 0.1)
    jp = jquant.quantize_conv_params(
        {"kernel": jnp.asarray(k).astype(jdt), "bias": jnp.asarray(b).astype(jdt)},
        min_cin=1)
    tmod = torch.nn.Module()
    tmod.weight = torch.nn.Parameter(torch.from_numpy(
        k.transpose(4, 3, 0, 1, 2).copy()).to(tdt))
    tmod.bias = torch.nn.Parameter(torch.from_numpy(b).to(tdt))
    quant.quantize_conv_params(tmod, min_cin=1)
    np.testing.assert_array_equal(tmod.weight_q.numpy(), np.asarray(
        jp["kernel_q"]).transpose(4, 3, 0, 1, 2))
    jx, tx = _pair(_np((1, 3, 6, 7, 64), 8), jdt, tdt)
    kw = dict(n=n, t_pad=(1, 1), t_mode="edge", hw_mode=hw_mode)
    ref = jupsample(jx, jp, **kw)
    got = upsample2x_conv3x3_interleave(tx, tmod, **kw)
    if dt == "fp32":
        _rel_close(got, ref)
    else:
        _ulp_close(got, ref)


# ---------------------------------------------------------------------------
# K5's plain version against an independent float64 reference
# ---------------------------------------------------------------------------

#: (x (B,T,H,W,Cin), Cout, kernel, stride, pads, modes): ragged W against
#: the kernel's 128-pixel tiles, Cout off its 128-channel tiles, Cin 32, 40
#: and 48 (not a multiple of the 32-channel slab), stride 2, every pad mode
#: and the upsample phases' windows
K5_CASES = [
    ((1, 5, 7, 37, 32), 16, (3, 3, 3), (1, 1, 1), ((2, 0), (1, 1), (1, 1)),
     ("edge", "zero", "zero")),
    ((2, 4, 5, 9, 48), 24, (3, 3, 3), (1, 1, 1), ((1, 1), (1, 1), (1, 1)),
     ("edge", "edge", "edge")),
    ((1, 5, 9, 11, 40), 24, (3, 3, 3), (2, 2, 2), ((2, 0), (0, 1), (0, 1)),
     ("edge", "zero", "zero")),
    ((1, 3, 4, 7, 32), 16, (3, 2, 2), (1, 1, 1), ((1, 1), (0, 1), (1, 0)),
     ("edge", "edge", "edge")),
    ((1, 2, 5, 6, 96), 136, (1, 3, 3), (1, 1, 1), ((0, 0), (1, 1), (1, 1)),
     ("zero", "zero", "zero")),
]


def _reference_int8_conv(xq, wq, stride, pads, modes):
    """int64 sums by explicit taps over numpy pads (edge then zero)."""
    a = xq.astype(np.int64)
    for axis, ((lo, hi), m) in enumerate(zip(pads, modes)):
        width = [(0, 0)] * 5
        width[1 + axis] = (lo, hi)
        a = np.pad(a, width, mode="edge" if m == "edge" else "constant")
    kt, kh, kw = wq.shape[2:]
    out = [(a.shape[1 + i] - k) // s + 1
           for i, (k, s) in enumerate(zip((kt, kh, kw), stride))]
    acc = 0
    for dt in range(kt):
        for dh in range(kh):
            for dw in range(kw):
                v = a[:, dt:dt + stride[0] * (out[0] - 1) + 1:stride[0],
                      dh:dh + stride[1] * (out[1] - 1) + 1:stride[1],
                      dw:dw + stride[2] * (out[2] - 1) + 1:stride[2]]
                acc = acc + v @ wq[:, :, dt, dh, dw].astype(np.int64).T
    return acc


@pytest.mark.parametrize("bias", [True, False])
@pytest.mark.parametrize("case", range(len(K5_CASES)))
def test_k5_plain_exact(case, bias):
    """Bit-equal to int64 sums and the fp32 epilogue.  Output channel 0
    sums +127 * +127 over the whole window on an input of +3 in frames 0
    and 1,
    which at Cin 48 passes 2^24, where fp32 stops holding integers."""
    shape, cout, kernel, stride, pads, modes = K5_CASES[case]
    rng = np.random.RandomState(case)
    x = _np(shape, 10 + case)
    x[:, :2] = 3.0
    x = torch.from_numpy(x)
    wq = rng.randint(-127, 128, (cout, shape[-1]) + kernel).astype(np.int8)
    wq[0] = 127
    wq = torch.from_numpy(wq)
    sw = torch.from_numpy(rng.uniform(0.5, 1.5, cout).astype(np.float32)
                          / 127)
    sx = torch.tensor(2.5 / 127, dtype=torch.float32)   # clips |x| > 2.5
    b = torch.from_numpy(_np((cout,), 11, 0.1)) if bias else None
    got = k5.conv3d_int8(x, wq, sw, sx, b, stride, pads, modes)
    acc = _reference_int8_conv(quant.quantize_act_static(x, sx).numpy(),
                               wq.numpy(), stride, pads, modes)
    assert np.abs(acc).max() > 2 ** 24 or shape[-1] * np.prod(kernel) * \
        127 ** 2 <= 2 ** 24
    want = acc.astype(np.float32) * (np.float32(sx) * sw.numpy())
    if bias:
        want = want + b.numpy()
    np.testing.assert_array_equal(got.numpy(), want)


# ---------------------------------------------------------------------------
# calibration, conversion and the whole slice
# ---------------------------------------------------------------------------

def _clip(shape, seed):
    return np.random.RandomState(seed).uniform(-1, 1, shape).astype(
        np.float32)


@pytest.fixture(scope="module", params=["v1", "sd3"])
def calibrated(request):
    """Both packages' nets quantized and calibrated on the same clip.  The
    calibration pass runs at the default threshold, where this clip's
    convs all run in float, so the recorded maxima differ only by the two
    packages' fp32 arithmetic."""
    family = request.param
    jvae, tvae = _nets(family)
    calib = _clip((1, 5, 32, 32, 3), 20)
    jq = jvae.quantize(calibration=jnp.asarray(calib))
    tq = tvae.quantize(calibration=torch.from_numpy(calib))
    return family, jvae, tvae, jq, tq


@pytest.fixture
def int8_levels(monkeypatch):
    """int8 at the convs of at least 256 positions: the nets' two finest
    levels on a 5x32x32 clip.  Below that (the latent-resolution convs,
    2x8x8) these narrow random nets are chaotic at int8: adding 1e-6 noise
    to the input alone moves the v1 latent to 47.6 dB of itself."""
    monkeypatch.setattr(jquant, "INT8_MIN_POSITIONS", 256)
    monkeypatch.setattr(quant, "INT8_MIN_POSITIONS", 256)


def test_calibrated_scales_match_jax(calibrated):
    _, _, _, jq, tq = calibrated
    want = {k: float(v) for k, v in from_jax_params(
        jax.tree.map(np.asarray, jq.params)).items() if k.endswith("scale_x")}
    got = {k: float(v) for k, v in tq.state_dict().items()
           if k.endswith("scale_x")}
    assert set(got) == set(want) and got
    for k in got:
        assert abs(got[k] - want[k]) <= 1e-5 * abs(want[k]), k


def test_quantized_jax_tree_loads_strict(calibrated, int8_levels):
    """A quantized, calibrated JAX tree loads into a quantized port model
    with strict=True, every tensor as it was, and encodes as JAX does."""
    _, _, tvae, jq, _ = calibrated
    state = from_jax_params(jax.tree.map(np.asarray, jq.params))
    loaded = quant.load_quantized_state(tvae.quantize(), state)
    for k, v in loaded.state_dict().items():
        assert v.dtype == state[k].dtype and torch.equal(v, state[k]), k
    x = _clip((1, 5, 32, 32, 3), 21)
    assert _psnr(loaded.encode(torch.from_numpy(x)).mean,
                 jq.encode(jnp.asarray(x)).mean) >= 40.0


def _psnr(got, ref):
    """PSNR with the reference's data range, 2 max|ref| (as
    tests/test_quant.py takes it)."""
    a, b = _f32(got), _f32(ref)
    mse = float(np.mean((a - b) ** 2))
    peak = 2 * float(np.abs(b).max())
    return 10 * np.log10(peak ** 2 / mse) if mse > 0 else float("inf")


def test_int8_slice_matches_jax_int8(calibrated, int8_levels):
    """The port's int8 encode/decode against JAX's: >= 40 dB."""
    _, _, _, jq, tq = calibrated
    x = _clip((1, 5, 32, 32, 3), 20)
    ref = jq.decode(jq.encode(jnp.asarray(x)).mode())
    got = tq.decode(tq.encode(torch.from_numpy(x)).mode())
    assert _psnr(got, ref) >= 40.0


@pytest.mark.parametrize("seed,limit", [(20, 30.0), (22, 28.0)],
                         ids=["calibration_clip", "unseen_clip"])
def test_int8_slice_quality_gate(calibrated, int8_levels, seed, limit):
    """int8 against the port's own float path: >= 30 dB on the
    calibration clip and >= 28 dB on an unseen one, the bounds
    tests/test_quant.py holds the reference to."""
    _, _, tvae, _, tq = calibrated
    x = torch.from_numpy(_clip((1, 5, 32, 32, 3), seed))
    ref = tvae.decode(tvae.encode(x).mode())
    got = tq.decode(tq.encode(x).mode())
    assert _psnr(got, ref) >= limit
