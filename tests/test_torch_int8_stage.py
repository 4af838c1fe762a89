"""K5's two steps on the CPU: the staging pass's plain version against
the JAX package's quantize-then-pad, the GEMM over a staged tensor
against the plain int8 conv, the upsample's four phases from one staged
tensor, and the kernels derived from a module's int8 kernel (built once,
never in the state dict, built again when that kernel changes).

Inputs are made with numpy from a seed.  Every comparison is bit-equal:
the quantizer is an elementwise fp32 division, rounding and clip on both
sides, the pads copy int8 values, and the int8 sums are exact integers.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import chip_smoke
from cvvae_tpu.ops import conv as jconv
from cvvae_tpu.ops import quant as jquant

from cvvae_tpu_torch.ops import quant
from cvvae_tpu_torch.ops.kernels import conv_int8 as k5
from cvvae_tpu_torch.ops.upsample_conv import (_CORNERS, _int8_phases,
                                               _phase_kernels,
                                               upsample2x_conv3x3_interleave)

torch.set_num_threads(2)

DTYPES = {"fp32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
CASES = list(chip_smoke.k5_check_cases())


def _inputs(case, half_steps, seed):
    """x (numpy fp32) of a K5 check case and its scale: N(0, 1) with
    scale_x 3/127, or on half steps of scale_x = 1/32 (k5_inputs' two
    kinds), and an int8 kernel."""
    shape, cout, kernel = case[:3]
    rng = np.random.RandomState(seed)
    if half_steps:
        x = ((rng.randint(-130, 130, shape) + 0.5) / 32).astype(np.float32)
        sx = np.float32(1 / 32)
    else:
        x = rng.randn(*shape).astype(np.float32)
        sx = np.float32(3 / 127)
    wq = rng.randint(-127, 128, (cout, shape[-1]) + tuple(kernel)).astype(
        np.int8)
    return x, sx, wq


def _ids(c):
    return f"{c[0]}{'-half' if c[1] else ''}"


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_stage_plain_matches_jax_quantize_and_pad(case, dt):
    """K5.stage's plain version is the JAX package's quantize_act_static,
    then its _edge_pad, then the zero pads, then zeros to the staged
    W' (a multiple of the W stride) and Cp (the K chunk)."""
    i, half, (shape, cout, kernel, stride, pads, modes, _) = case
    jdt, tdt = DTYPES[dt]
    x, sx, _ = _inputs(case[2], half, 70 + i)
    jq = jquant.quantize_act_static(jnp.asarray(x).astype(jdt), sx)
    jq = jconv._edge_pad(jq, pads, modes)
    zero = [(0, 0)] + [tuple(p) if m == "zero" else (0, 0)
                       for p, m in zip(pads, modes)] + [(0, 0)]
    want = np.pad(np.asarray(jq), zero)
    b, t, h, w, c = k5.staged_shape(shape, pads, stride[2])
    want = np.pad(want, [(0, 0)] * 3 + [(0, w - want.shape[3]),
                                        (0, c - want.shape[4])])
    got = k5.stage_plain(torch.from_numpy(x).to(tdt), torch.tensor(sx),
                         pads, modes, stride[2])
    assert got.dtype == torch.int8 and tuple(got.shape) == (b, t, h, w, c)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_staged_gemm_equals_plain_conv(case, dt):
    """Stage, then the zero-window GEMM over it (the CPU routes of
    ``stage`` and ``gemm``), bit-equal to ``conv3d_int8_plain``."""
    i, half, (shape, cout, kernel, stride, pads, modes, bias) = case
    tdt = DTYPES[dt][1]
    x, sx, wq = _inputs(case[2], half, 80 + i)
    rng = np.random.RandomState(90 + i)
    x, sx, wq = torch.from_numpy(x).to(tdt), torch.tensor(sx), \
        torch.from_numpy(wq)
    sw = torch.from_numpy(rng.uniform(0.5, 1.5, cout).astype(np.float32)
                          / 127)
    b = (torch.from_numpy(rng.randn(cout).astype(np.float32) * 0.1)
         if bias else None)
    staged = k5.stage(x, sx, pads, modes, stride[2])
    got = k5.gemm(staged, wq, sw, sx, b, stride, pads)
    ref = k5.conv3d_int8_plain(x, wq, sw, sx, b, stride, pads, modes)
    assert got.dtype == tdt
    assert chip_smoke.k2_exact(got, ref)


def _upsample_params(cin, cout, seed, dtype=torch.float32):
    """A quantized upsample conv: weight (cout, cin, 3, 3, 3), bias."""
    rng = np.random.RandomState(seed)
    m = torch.nn.Module()
    m.weight = torch.nn.Parameter(torch.from_numpy(
        rng.randn(cout, cin, 3, 3, 3).astype(np.float32) * 0.05).to(dtype))
    m.bias = torch.nn.Parameter(torch.from_numpy(
        rng.randn(cout).astype(np.float32) * 0.1).to(dtype))
    return quant.quantize_conv_params(m, min_cin=1)


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("hw_mode", ["zero", "edge"])
@pytest.mark.parametrize("t_pad,t_mode", [((1, 1), "edge"), ((2, 0), "edge"),
                                          ((1, 1), "zero")])
def test_upsample_phases_from_one_staged_tensor(t_pad, t_mode, hw_mode, dt):
    """The four phases over one tensor staged with (1, 1) H/W pads, each
    bit-equal to its own ``quant.conv_int8`` call on x (which stages x
    with that phase's pads)."""
    tdt = DTYPES[dt][1]
    m = _upsample_params(48, 40, 3, tdt)
    m.register_buffer("scale_x", torch.tensor(2.5 / 127))
    x = torch.from_numpy(np.random.RandomState(4).randn(1, 3, 5, 7, 48)
                         .astype(np.float32)).to(tdt)
    got = _int8_phases(x, m, t_pad, t_mode, hw_mode)
    pads = {"even": (1, 0), "odd": (0, 1)}
    kernels = _phase_kernels(quant.dequantize_kernel(m))
    for g, k, (hp, wp) in zip(got, kernels, _CORNERS):
        want = quant.conv_int8(x, m.scale_x, k, (t_pad, pads[hp], pads[wp]),
                               (t_mode, hw_mode, hw_mode))
        assert chip_smoke.k2_exact(g, want)


def test_derived_kernels_are_buffers_outside_the_state_dict():
    """The phase kernels are built at the first call as non-persistent
    buffers: the state dict and a strict load do not see them."""
    m = _upsample_params(32, 24, 5)
    keys = set(m.state_dict())
    x = torch.from_numpy(np.random.RandomState(6).randn(1, 2, 4, 5, 32)
                         .astype(np.float32))
    quant_threshold = quant.INT8_MIN_POSITIONS
    try:
        quant.INT8_MIN_POSITIONS = 1
        upsample2x_conv3x3_interleave(x, m, n=1, t_pad=(1, 1), t_mode="edge")
    finally:
        quant.INT8_MIN_POSITIONS = quant_threshold
    assert {"k5_phase_wq", "k5_phase_sw"} <= set(dict(m.named_buffers()))
    assert set(m.state_dict()) == keys
    m.load_state_dict(_upsample_params(32, 24, 7).state_dict(), strict=True)


def test_loading_a_new_state_changes_the_output(monkeypatch):
    """After ``quant.load_quantized_state`` the kernels derived from the
    old int8 kernel are built again: the output after the load is the new
    model's, not the old one's."""
    monkeypatch.setattr(quant, "INT8_MIN_POSITIONS", 1)
    x = torch.from_numpy(np.random.RandomState(8).randn(1, 3, 4, 5, 32)
                         .astype(np.float32))
    kw = dict(n=2, t_pad=(2, 0), t_mode="edge")
    m = _upsample_params(32, 48, 9)
    before = upsample2x_conv3x3_interleave(x, m, **kw)
    new = _upsample_params(32, 48, 10)
    quant.load_quantized_state(m, new.state_dict())
    after = upsample2x_conv3x3_interleave(x, m, **kw)
    assert not torch.equal(after, before)
    assert torch.equal(after, upsample2x_conv3x3_interleave(x, new, **kw))


def test_plain_load_state_dict_changes_the_output(monkeypatch):
    """A plain ``load_state_dict`` into a module that has run (it copies
    into ``weight_q`` and ``scale_w``) makes the next call derive its
    phase kernels from the new ones."""
    monkeypatch.setattr(quant, "INT8_MIN_POSITIONS", 1)
    x = torch.from_numpy(np.random.RandomState(11).randn(1, 3, 4, 5, 32)
                         .astype(np.float32))
    kw = dict(n=2, t_pad=(2, 0), t_mode="edge")
    m = _upsample_params(32, 48, 12)
    before = upsample2x_conv3x3_interleave(x, m, **kw)
    new = _upsample_params(32, 48, 13)
    m.load_state_dict(new.state_dict(), strict=True)
    after = upsample2x_conv3x3_interleave(x, m, **kw)
    assert not torch.equal(after, before)
    assert torch.equal(after, upsample2x_conv3x3_interleave(x, new, **kw))


@pytest.mark.parametrize("change", ["copy weight_q", "edit scale_w",
                                    "assign weight_q"])
def test_derived_buffer_follows_its_kernel(change):
    """``quant.derived`` builds once while ``weight_q`` and ``scale_w``
    stay as they are, and again after an in-place edit of either or a new
    tensor in their place."""
    m = _upsample_params(32, 24, 14)
    calls = []

    def build():
        calls.append(1)
        return m.weight_q.float() * m.scale_w[:, None, None, None, None]

    first = quant.derived(m, "k5_test", build)
    assert quant.derived(m, "k5_test", build) is first and len(calls) == 1
    if change == "copy weight_q":
        m.weight_q.copy_(_upsample_params(32, 24, 15).weight_q)
    elif change == "edit scale_w":
        m.scale_w.mul_(2)
    else:
        m.weight_q = _upsample_params(32, 24, 15).weight_q.clone()
    again = quant.derived(m, "k5_test", build)
    assert len(calls) == 2
    assert torch.equal(again, build())
    assert "k5_test" not in m.state_dict()


def test_pack_weight_pads_to_the_gemm_tiles():
    """The packed B: (O padded to BN, taps, Cin padded to the K chunk),
    zeros in the padding, read back to the kernel."""
    wq = torch.randint(-127, 128, (136, 40, 3, 3, 3), dtype=torch.int8)
    packed = k5.pack_weight(wq)
    assert packed.shape == (2 * k5.BN, 27, k5.KC)
    back = packed[:136, :, :40].reshape(136, 3, 3, 3, 40)
    assert torch.equal(back.permute(0, 4, 1, 2, 3), wq)
    assert not packed[136:].any() and not packed[:, :, 40:].any()
