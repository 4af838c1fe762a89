"""The int8-resident modes on the card against their plain versions, at
small shapes: K5 from an int8 input (int8 out at per-channel scales, bf16
and fp32 out, and int8 out through the staged epilogue on
``K5_INT8_CASES``; bit-equal), K1's int8 mode (``chip_smoke.k1_int8_check``:
codes within 1 and at most ``QFLOW_K1_FLIPS`` of them off, float outputs
by ``QFLOW_K1_TOL``; its table and every output bit-equal to the plain
table built from its own affine; its affine bit-equal to the plain one in
the kernel's order of moments), K6 (bit-equal, the add on both of its
paths), quant8 through K6.requant
on every fp32 value of |v / s| <= 128 at ``QUANT8_SCALES`` (bit-equal to
``torch.round(v / s).clamp(-127, 127)``), the residency chain against the
same chain run on the CPU in K1.int8's order of moments, and
``qconv3d``'s refusal of a per-channel input scale.

Needs a CUDA device (and nvcc to build the kernels); skips without one.
Run on a GPU machine with:
    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_qflow_cuda.py
(``--noconftest``: the suite's conftest configures JAX, which the GPU
machine need not have; this file imports no JAX.)
"""

import pytest
import torch

import chip_smoke
from cvvae_tpu_torch.ops import qflow
from cvvae_tpu_torch.ops.conv import Conv3DSpec
from cvvae_tpu_torch.ops.kernels import conv_int8, groupnorm
from cvvae_tpu_torch.ops.kernels import qflow as k6

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("out_dtype", [torch.int8, torch.bfloat16,
                                       torch.float32])
@pytest.mark.parametrize("case", range(len(chip_smoke.K5_CHECK_CASES)))
def test_k5_from_int8(dev, case, out_dtype):
    shape, cout, kernel, stride, pads, modes, with_bias = \
        chip_smoke.K5_CHECK_CASES[case]
    xq, wq, sw, sx, b, so = chip_smoke.k5_int8_inputs(shape, cout, kernel,
                                                      dev, with_bias)
    before = (conv_int8.launches, conv_int8.int8_out_launches)
    exact, err = chip_smoke.k5_int8_check(xq, wq, sw, sx, b, kernel, stride,
                                          pads, modes, so, out_dtype)
    assert exact, err
    assert conv_int8.launches == before[0] + 1
    assert conv_int8.int8_out_launches == before[1] + (out_dtype == torch.int8)


@pytest.mark.parametrize("out", ["int8", "bfloat16", "float32"])
@pytest.mark.parametrize("per_channel", [False, True])
@pytest.mark.parametrize("shape,groups", chip_smoke.QFLOW_K1_CASES)
def test_k1_int8_mode(dev, shape, groups, per_channel, out):
    q, s, w, b = chip_smoke.k1_int8_inputs(shape, dev, per_channel)
    out_scale = torch.tensor(0.03, device=dev) if out == "int8" else None
    out_dtype = getattr(torch, out)
    before = groupnorm.int8_launches
    got = groupnorm.group_norm_silu_int8(
        q, s, w, b, num_groups=groups, eps=chip_smoke.QFLOW_EPS,
        out_scale=out_scale, out_dtype=out_dtype)
    assert groupnorm.int8_launches == before + 1
    assert got.dtype == out_dtype and got.shape == q.shape
    _, excess, text = chip_smoke.k1_int8_check(got, q, s, w, b, groups,
                                               out_scale, out_dtype)
    assert excess <= 0.0, text


@pytest.mark.parametrize("shape", chip_smoke.QFLOW_K6_CASES)
def test_k6_bit_equal(dev, shape):
    before = (k6.requant_launches, k6.qadd_launches)
    checks = chip_smoke.k6_checks(shape, dev)
    assert all(same for _, same in checks), checks
    assert (k6.requant_launches, k6.qadd_launches) == (before[0] + 4,
                                                       before[1] + 4)


def test_qconv3d_refuses_a_per_channel_scale_on_the_card(dev):
    spec = Conv3DSpec.v1_plain()
    x = chip_smoke.qflow_codes((1, 2, 8, 8, 64), dev, 1)
    params = {"weight_q": torch.ones((64, 64, 3, 3, 3), dtype=torch.int8,
                                     device=dev),
              "scale_w": torch.full((64,), 0.01, device=dev)}
    before = conv_int8.launches
    with pytest.raises(ValueError, match="per-tensor scale"):
        qflow.qconv3d(qflow.QTensor(x, chip_smoke.qflow_scale(64, dev, True)),
                      params, spec)
    assert conv_int8.launches == before


def test_residency_chain_card_against_cpu(dev):
    """The 3-resblock chain at width 128 on a (1, 3, 32, 32) clip, card
    against the same chain on the CPU (plain versions) with K1.int8's own
    order of moments (``chip_smoke.qflow_chain_card_vs_cpu``): PSNR-style
    agreement >= QFLOW_CHAIN_DB (K5 and K6 are bit-equal; K1's int8 mode
    may flip a code through its SiLU's exp, which the next convs spread).
    Against the CPU chain in XLA's order the card reads what the CPU's two
    orders read against each other (~34 dB): a reading, printed."""
    with torch.no_grad():
        db, db_xla, got = chip_smoke.qflow_chain_card_vs_cpu(dev)
    print(f"card against the CPU: kernel order {db!r} dB, XLA order "
          f"{db_xla!r} dB")
    assert got.dtype == torch.bfloat16
    assert tuple(got.shape) == chip_smoke.QFLOW_CHAIN_CLIP
    assert db >= chip_smoke.QFLOW_CHAIN_DB


@pytest.mark.parametrize("per_channel", [False, True])
@pytest.mark.parametrize("shape,groups", chip_smoke.QFLOW_K1_CASES)
def test_k1_int8_affine_is_the_kernel_order_plain(dev, shape, groups,
                                                  per_channel):
    q, s, w, b = chip_smoke.k1_int8_inputs(shape, dev, per_channel)
    same, text = chip_smoke.k1_int8_coef_check(q, s, w, b, groups)
    assert same, text


@pytest.mark.parametrize("case", range(len(chip_smoke.K5_INT8_CASES)))
def test_k5_int8_staged_epilogue(dev, case):
    shape, cout, kernel, stride, pads, modes, with_bias = \
        chip_smoke.K5_INT8_CASES[case]
    xq, wq, sw, sx, b, so = chip_smoke.k5_int8_inputs(shape, cout, kernel,
                                                      dev, with_bias)
    before = conv_int8.int8_out_launches
    exact, err = chip_smoke.k5_int8_check(xq, wq, sw, sx, b, kernel, stride,
                                          pads, modes, so, torch.int8)
    assert exact, err
    assert conv_int8.int8_out_launches == before + 1


@pytest.mark.parametrize("out", ["int8", "bfloat16", "float32"])
@pytest.mark.parametrize("shape,groups", chip_smoke.QFLOW_K1_CASES)
def test_k1_int8_table_is_the_plain_table(dev, shape, groups, out):
    q, s, w, b = chip_smoke.k1_int8_inputs(shape, dev, True)
    out_scale = torch.tensor(0.03, device=dev) if out == "int8" else None
    same, text = chip_smoke.k1_int8_table_check(q, s, w, b, groups,
                                                out_scale, getattr(torch, out))
    assert same, text


def test_quant8_is_exact_on_every_value(dev):
    held, seconds = chip_smoke.quant8_exhaustive(dev)
    assert [off for _, _, off in held] == [0] * len(held), held
    assert all(n > 2 ** 30 for _, n, _ in held)
    assert seconds < 30.0
