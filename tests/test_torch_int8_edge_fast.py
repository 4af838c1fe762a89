"""The JAX package's int8 edge-fast branch as ``utils/int8_ab.py`` runs it
on the card for its A/B (``int8_ab.conv3d_int8_edge_fast``, installed in
the port's ``ops/quant.py`` by ``int8_ab.edge_fast()``), against the JAX
package's (``cvvae_tpu/ops/quant.py:217-255``, ``EDGE_FAST_SPACE``
monkeypatched on), on the CPU.  The port does not serve the branch; these
tests hold the function whose times and PSNR the A/B reports.

Tolerances are ``tests/test_torch_quant.py``'s, for the same reasons: the
quantizers are bit-equal, the int8 sums exact integers on both sides, so
a conv agrees within 1e-6 * max|ref| in fp32 and one bf16 ulp in bf16; a
whole net within 40 dB.  The fixes' int8 tap-sum kernels and scales, and
the main call's, are bit-equal to JAX's ``quantize_kernel``.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cvvae_tpu.ops import conv as jconv
from cvvae_tpu.ops import quant as jquant
from test_torch_quant import (DTYPES, SPECS, _clip, _conv_pair, _nets, _np,
                              _pair, _psnr, _rel_close, _ulp_close)

from cvvae_tpu_torch.ops import conv as tconv
from cvvae_tpu_torch.ops import quant
from cvvae_tpu_torch.ops.kernels import conv_int8 as k5
from cvvae_tpu_torch.utils import int8_ab

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: the specs of SPECS with an edge pad, which take the branch
EDGE_SPECS = ["v1_causal", "sd3_causal", "sd3_plain", "v1_downsample_t",
              "v1_downsample_s"]


@pytest.fixture
def edge_fast(monkeypatch):
    """The branch on in both packages, int8 at every conv."""
    monkeypatch.setattr(jconv, "EDGE_FAST_SPACE", True)
    monkeypatch.setattr(jquant, "INT8_MIN_POSITIONS", 1)
    monkeypatch.setattr(quant, "INT8_MIN_POSITIONS", 1)
    with int8_ab.edge_fast():
        yield


def _calibrate(jp, tmod, x):
    """Give both convs the same static scale, max|x| * 1.1 / 127 in
    Python floats, as ``attach_activation_scales`` rounds it."""
    s = max(float(np.abs(x).max()) * 1.1 / 127.0, 1e-12)
    tmod.register_buffer("scale_x", torch.tensor(s, dtype=torch.float32))
    return dict(jp, scale_x=jnp.float32(s))


@pytest.mark.parametrize("scale", ["calibrated", "dynamic"])
@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("name", SPECS)
def test_edge_fast_conv3d_matches_jax(edge_fast, name, dt, scale):
    """Every spec of test_torch_quant.py: those with an edge pad take the
    branch in both packages, the others K5's materialised path."""
    jdt, tdt = DTYPES[dt]
    jp, jspec, tmod, tspec = _conv_pair(name, jdt, tdt)
    x = _np((1, 5, 9, 11, 64), 4)
    if scale == "calibrated":
        jp = _calibrate(jp, tmod, x)
    jx, tx = _pair(x, jdt, tdt)
    ref = jconv.conv3d(jx, jp, jspec)
    got = tmod(tx)
    if dt == "fp32":
        _rel_close(got, ref)
    else:
        _ulp_close(got, ref)


def _recording(monkeypatch, module, name):
    """What every call of ``module.name`` returns, in order."""
    seen = []
    fn = getattr(module, name)

    def recording(*args):
        out = fn(*args)
        seen.append(out)
        return out

    monkeypatch.setattr(module, name, recording)
    return seen


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("name", EDGE_SPECS)
def test_fix_kernels_bit_equal_jax(monkeypatch, edge_fast, name, dt):
    """The main call's int8 kernel and scale (the module's own), then each
    slab fix's (the missing taps summed in fp32 from the dequantized
    kernel, quantized per channel), in the order both packages run them:
    bit-equal to JAX's ``quantize_kernel`` of JAX's tap sums.  One K5 call
    a kernel."""
    jdt, tdt = DTYPES[dt]
    jp, jspec, tmod, _ = _conv_pair(name, jdt, tdt)
    jx, tx = _pair(_np((1, 5, 9, 11, 64), 4), jdt, tdt)
    fixes = _recording(monkeypatch, quant, "quantize_kernel")
    calls = _recording(monkeypatch, k5, "conv3d_int8")
    ref = _recording(monkeypatch, jquant, "quantize_kernel")
    jconv.conv3d(jx, jp, jspec)
    tmod(tx)
    port = [(tmod.weight_q, tmod.scale_w)] + fixes
    assert len(port) == len(ref) == len(calls) > 1
    for (tq, ts), (jq, js) in zip(port, ref):
        np.testing.assert_array_equal(
            tq.numpy(), np.asarray(jq).transpose(4, 3, 0, 1, 2))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_requantized_kernel_round_trip(seed):
    """``quantize_kernel(dequantize_kernel(m))`` gives ``weight_q`` and
    ``scale_w`` back bit for bit, and equals JAX's for the same kernel, so
    the branch's main call reads the module's own: a scale s = fl(M / 127)
    has fl(fl(127 s) / 127) = s, here at every M of one binade (the
    identity is the same in every binade of normal numbers), though fl(127
    s) is not M for about 0.8% of them."""
    k = _np((3, 3, 3, 64, 512), seed, 0.05)
    m = torch.nn.Module()
    m.weight = torch.nn.Parameter(torch.from_numpy(
        k.transpose(4, 3, 0, 1, 2).copy()))
    quant.quantize_conv_params(m, min_cin=1)
    wq, sw = quant.quantize_kernel(quant.dequantize_kernel(m))
    assert torch.equal(wq, m.weight_q) and torch.equal(sw, m.scale_w)
    jq, js = jquant.quantize_kernel(jquant.dequantize_kernel(
        {"kernel_q": jnp.asarray(m.weight_q.numpy().transpose(2, 3, 4, 1, 0)),
         "scale_w": jnp.asarray(m.scale_w.numpy())}))
    np.testing.assert_array_equal(sw.numpy(), np.asarray(js))
    np.testing.assert_array_equal(
        wq.numpy(), np.asarray(jq).transpose(4, 3, 0, 1, 2))
    big = np.arange(2 ** 23, 2 ** 24, dtype=np.int64)[seed::3]
    big = big.astype(np.float32)
    s = torch.from_numpy(big) / torch.tensor(127.0)
    assert torch.equal(quant._over_127(s * 127), s)
    assert not torch.equal(s * 127, torch.from_numpy(big))


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("name", EDGE_SPECS)
def test_branch_is_not_the_materialised_pad(edge_fast, name, dt):
    """The branch computes another function than the materialised pad (its
    fixes quantize summed taps), close to it, and only at the boundary
    slices: away from them the two are bit-equal.  Outside
    ``edge_fast()`` the port's conv is the materialised pad again."""
    _, tdt = DTYPES[dt]
    _, _, tmod, spec = _conv_pair(name, DTYPES[dt][0], tdt)
    x = torch.from_numpy(_np((1, 5, 9, 11, 64), 4)).to(tdt)
    got = tmod(x)
    with int8_ab.edge_fast(False):
        ref = tmod(x)
    assert quant.conv3d_int8 is int8_ab._MATERIALISED
    assert got.shape == ref.shape and not torch.equal(got, ref)
    fixed = torch.zeros(got.shape[1:4], dtype=torch.bool)
    for a, ((lo, _), mode) in enumerate(zip(spec.pads, spec.modes)):
        if mode == "edge":
            for o, *_ in tconv._missing_taps(lo, spec.kernel[a],
                                             spec.stride[a], x.shape[1 + a],
                                             got.shape[1 + a]):
                tconv._axis(fixed[None, ..., None], a, slice(o, o + 1))[:] = 1
    assert 0 < int(fixed.sum()) < fixed.numel()
    assert torch.equal(got[:, ~fixed], ref[:, ~fixed])
    rel = (got.float() - ref.float()).norm() / ref.float().norm()
    assert rel < 0.05


@pytest.fixture(scope="module", params=["v1", "sd3"])
def calibrated(request):
    """Both packages' nets quantized and calibrated on the same clip at the
    default threshold (as tests/test_torch_quant.py does)."""
    family = request.param
    jvae, tvae = _nets(family)
    calib = _clip((1, 5, 32, 32, 3), 20)
    jq = jvae.quantize(calibration=jnp.asarray(calib))
    tq = tvae.quantize(calibration=torch.from_numpy(calib))
    return family, jq, tq


def test_edge_fast_slice_matches_jax_int8(monkeypatch, calibrated):
    """The narrow v1 and SD3 int8 VideoVAEs with the branch on in both
    packages: >= 40 dB, as test_int8_slice_matches_jax_int8 holds the
    default path (int8 at the convs of at least 256 positions)."""
    monkeypatch.setattr(jconv, "EDGE_FAST_SPACE", True)
    monkeypatch.setattr(jquant, "INT8_MIN_POSITIONS", 256)
    monkeypatch.setattr(quant, "INT8_MIN_POSITIONS", 256)
    _, jq, tq = calibrated
    fixes = _recording(monkeypatch, quant, "quantize_kernel")
    x = _clip((1, 5, 32, 32, 3), 20)
    ref = jq.decode(jq.encode(jnp.asarray(x)).mode())
    with int8_ab.edge_fast():
        got = tq.decode(tq.encode(torch.from_numpy(x)).mode())
    assert fixes, "the branch did not run"
    assert _psnr(got, ref) >= 40.0


@pytest.mark.parametrize("stride", [(1, 1, 1), (2, 2, 1)])
@pytest.mark.parametrize("hpad", [(1, 1), (0, 1)])
def test_w_slab_conv_swapped_is_the_same_conv(monkeypatch, stride, hpad):
    """``int8_ab._k5_zero`` runs a W slab's conv (one column in, a
    one-column kernel, no W pad) with H and W swapped: one K5 call on the
    (B, T, 1, H, C) view of a copy of the strided slab, seen back as
    (B, T', H', 1, O), is the conv bit for bit (here on K5's plain
    version)."""
    rng = np.random.RandomState(9)
    x = torch.from_numpy(_np((2, 5, 11, 6, 40), 9))[:, :, :, -1:]
    wq = torch.from_numpy(rng.randint(-127, 128, (24, 40, 3, 3, 1))
                          .astype(np.int8))
    sw = torch.from_numpy(rng.uniform(0.5, 1.5, 24).astype(np.float32) / 127)
    sx, b = torch.tensor(0.02), torch.from_numpy(_np((24,), 10, 0.1))
    pads = ((2, 0), hpad, (0, 0))
    calls = _recording(monkeypatch, k5, "conv3d_int8")
    y = int8_ab._k5_zero(x, wq, sw, sx, b, stride, pads)
    ref = k5.conv3d_int8_plain(x, wq, sw, sx, b, stride, pads,
                               ("zero",) * 3)
    assert len(calls) == 1 and calls[0].shape[2] == 1
    assert torch.equal(y, ref)


def test_int8_ab_imports_no_jax_and_needs_the_card():
    """``utils/int8_ab.py`` (the card's A/B) imports nothing of JAX, and
    with no card it refuses rather than measure the CPU."""
    code = ("import sys\n"
            "import cvvae_tpu_torch.utils.int8_ab as ab\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'cvvae_tpu' or "
            "m.startswith('cvvae_tpu.'))\n"
            "assert not bad, bad\n"
            "print('clean', flush=True)\n"
            "ab.main([])\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env=dict(os.environ, PYTHONPATH=ROOT),
                         capture_output=True, text=True, timeout=120)
    assert out.stdout.strip() == "clean", out.stderr
    assert out.returncode != 0 and "needs a CUDA card" in out.stderr
