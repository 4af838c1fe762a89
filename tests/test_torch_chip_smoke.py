"""``chip_smoke.py``'s byte and FLOP counts: the least time the card could
take for each kernel at its largest main-path shape (H100: 3.35 TB/s,
989 TFLOP/s bf16), against the counts worked out by hand; and its checks'
inputs and bounds, on the CPU."""

import pytest
import torch

import chip_smoke
import planted_faults
from cvvae_tpu_torch.ops.kernels.groupnorm import group_norm_silu_plain
from cvvae_tpu_torch.utils import kernel_variants

CPU = torch.device("cpu")


@pytest.mark.parametrize("rising,least,most", [(False, 0.0, 0.0),
                                               (True, 1.0, None)])
def test_k4_inputs_rescale_the_kernels_softmax(rising, least, most):
    """N(0, 1) logits never raise a row's max past the kernel's slack
    after the first tile; the rising inputs do, more than once a row."""
    q, k, _ = chip_smoke.k4_inputs((1, 1100, 64), CPU, torch.bfloat16,
                                   rising)
    raises = chip_smoke.k4_max_raises(q, k, 64 ** -0.5)
    assert raises >= least
    assert most is None or raises <= most


@pytest.mark.parametrize("offset", [chip_smoke.K1_OFFSET,
                                    chip_smoke.K1_WIDE_OFFSET])
@pytest.mark.parametrize("silu,per_frame", [(True, False), (False, True)])
def test_k1_check_takes_one_rounding_of_fp32(offset, silu, per_frame):
    """One bf16 rounding of the plain version's fp32 arithmetic (what the
    kernel computes) passes ``k1_check``; the plain version's bf16
    arithmetic does not pass its fp32 bound, nor does a channel shift."""
    x, w, b = chip_smoke.k1_inputs((1, 5, 6, 7, 128), CPU, torch.bfloat16,
                                   offset)
    kw = dict(num_groups=32, eps=1e-5, silu=silu, per_frame=per_frame)
    hold = offset == chip_smoke.K1_OFFSET
    one_rounding = group_norm_silu_plain(x.float(), w, b, **kw).bfloat16()
    assert chip_smoke.k1_check(one_rounding, x, w, b, hold, **kw)[1] <= 0.0
    plain_bf16 = group_norm_silu_plain(x, w, b, **kw)
    assert chip_smoke.k1_check(plain_bf16, x, w, b, hold, **kw)[1] > 0.0
    shifted = group_norm_silu_plain(x.roll(1, -1).float(), w, b, **kw)
    assert chip_smoke.k1_check(shifted.bfloat16(), x, w, b, hold,
                               **kw)[1] > 0.0


@pytest.mark.parametrize("key,shape,kw,gb,tflop,ms,by", [
    ("K1", (1, 17, 720, 1280, 128), {}, 8.02, None, 2.39, "bytes"),
    ("K2", (1, 9, 360, 336, 512), dict(n=2), 8.67, None, 2.59, "bytes"),
    ("K2", (1, 5, 90, 84, 1024), dict(n=2), 0.59, None, 0.18, "bytes"),
    ("K2", (1, 9, 180, 168, 512), dict(n=1), 2.23, None, 0.67, "bytes"),
    ("K3", (1, 17, 720, 1280, 3), {}, 4.10, None, 1.23, "bytes"),
    ("K4", (5, 14400, 512), {}, None, 2.12, 2.15, "operations"),
    ("K4", (5, 7560, 512), {}, None, 0.585, 0.59, "operations"),
    # K4.bwd, 10 B S^2 C FLOP: the shipped clip's mid-blocks (41.98 MB,
    # 0.0271 ms) and the shipped images' (104.96 MB, 0.106 ms)
    ("K4.bwd", (5, 1024, 512), {}, 0.04, 0.027, 0.03, "operations"),
    ("K4.bwd", (8, 1600, 512), {}, 0.1, 0.105, 0.11, "operations"),
    # K5 at 1,979 TOP/s int8: the v1 level-0 causal conv (13.86 TOP) and
    # the v1 downsample at stride 2, which its bytes bound
    ("K5", (1, 17, 720, 1280, 128),
     dict(cout=128, kernel=(3, 3, 3), stride=(1, 1, 1),
          pads=((2, 0), (1, 1), (1, 1))), 8.02, 13.861, 7.0, "operations"),
    ("K5", (1, 17, 720, 1280, 128),
     dict(cout=128, kernel=(3, 3, 3), stride=(2, 2, 2),
          pads=((2, 0), (0, 1), (0, 1))), 4.54, 1.835, 1.36, "bytes"),
    # K5.stage: 4.01 GB of bf16 in, (19, 722, 1282, 128) int8 out
    ("K5.stage", (1, 17, 720, 1280, 128),
     dict(stride=(1, 1, 1), pads=((2, 0), (1, 1), (1, 1))), 6.26, None, 1.87,
     "bytes"),
    # at W stride 2 the staged W (1281) is rounded up to 1282
    ("K5.stage", (1, 17, 720, 1280, 128),
     dict(stride=(2, 2, 2), pads=((2, 0), (0, 1), (0, 1))), 6.26, None,
     1.87, "bytes"),
])
def test_bounds_of_the_main_path_shapes(key, shape, kw, gb, tflop, ms, by):
    nbytes, flop = chip_smoke.work(key, shape, torch.bfloat16, **kw)
    if gb is not None:
        assert round(nbytes / 1e9, 2) == gb
    if tflop is not None:
        assert round(flop / 1e12, 3) == pytest.approx(tflop, abs=6e-3)
    got_ms, got_by = chip_smoke.bound(key, shape, torch.bfloat16, **kw)
    assert (round(got_ms, 2), got_by) == (ms, by)


def test_k3_fp32_is_bound_by_its_fmas():
    """fp32 K3 on FMAs: 2 * 81 FLOP an output element over 67 TFLOP/s,
    above its 8.2 GB of traffic over 3.35 TB/s."""
    shape = (1, 17, 720, 1280, 3)
    ms, by = chip_smoke.bound("K3", shape, torch.float32)
    assert by == "operations"
    assert ms == pytest.approx(17 * 720 * 1280 * 128 * 2 * 81 / 67e12 * 1e3)


@pytest.mark.parametrize("pad", ["edge", "zero"])
@pytest.mark.parametrize("cin", [3, 4])
def test_k3_check_takes_one_rounding_of_fp32(pad, cin):
    """One bf16 rounding of the plain version's fp32 arithmetic (what the
    kernel computes) passes ``k3_check``; the other time padding (the
    edge clamp dropped, or added), or a dropped bias, does not."""
    from cvvae_tpu_torch.ops.kernels.stem import stem_conv3d_plain

    spec = chip_smoke.k3_spec(pad)
    x, w, b = chip_smoke.k3_inputs((2, 3, 5, 9), cin, CPU, torch.bfloat16)
    one_rounding = stem_conv3d_plain(x.float(), w.float(), b.float(), spec)
    assert chip_smoke.k3_check(one_rounding.bfloat16(), x, w, b,
                               spec)[1] <= 0.0
    other = chip_smoke.k3_spec("zero" if pad == "edge" else "edge")
    wrong = stem_conv3d_plain(x.float(), w.float(), b.float(), other)
    assert chip_smoke.k3_check(wrong.bfloat16(), x, w, b, spec)[1] > 0.0
    no_bias = stem_conv3d_plain(x.float(), w.float(), None, spec)
    assert chip_smoke.k3_check(no_bias.bfloat16(), x, w, b, spec)[1] > 0.0


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_k2_exact_tells_minus_zero_apart(dtype):
    phases, _ = chip_smoke.k2_inputs(1, 2, 4, False, CPU, dtype)
    flipped = phases[0].clone()
    flipped.view(-1)[0] = 0.0
    assert torch.equal(flipped, phases[0])           # == says they agree
    assert chip_smoke.k2_exact(phases[0], phases[0].clone())
    assert not chip_smoke.k2_exact(flipped, phases[0])


@pytest.mark.parametrize("device,dtype,s,k4", [
    ("cuda", torch.bfloat16, 1024, True),
    ("cuda", torch.bfloat16, 14400, True),
    ("cuda", torch.float32, 7560, False),
    ("cpu", torch.bfloat16, 7560, False),
    ("cuda", torch.bfloat16, 1023, False),
])
def test_flash_usable_routes_only_bf16_on_the_card(device, dtype, s, k4):
    """K4 takes only what the reference's ``_flash_usable`` sends to flash:
    bf16 on the card at S >= 1024.  fp32 on the card, the CPU and shorter
    sequences take the exact path, so no fp32 attention is held to an
    fp32 bound of K4."""
    from cvvae_tpu_torch.ops.attention import flash_usable

    assert flash_usable(device, dtype, s) is k4


EDGE_SMALL = [("v1_causal", (1, 5, 6, 7, 16), "v1_causal", 16),
              ("sd3_causal", (1, 5, 6, 7, 16), "sd3_causal", 16),
              ("sd3_causal", (1, 1, 4, 5, 16), "sd3_causal", 16),
              ("head", (1, 5, 6, 7, 32), "v1_causal", 3)]


@pytest.mark.parametrize("case", EDGE_SMALL, ids=lambda c: f"{c[0]}{c[1]}")
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_edge_check_holds_the_decompositions(case, dtype):
    """``edge_check`` passes each decomposition of ``edge_paths`` against
    the materialised pad, and fails the conv with the time pad zeroed
    instead of repeated."""
    from cvvae_tpu_torch.ops import conv

    name, shape, ctor, cout = case
    spec = getattr(conv.Conv3DSpec, ctor)()
    x, w, b = chip_smoke.edge_inputs(shape, cout, CPU, dtype)
    paths = chip_smoke.edge_paths(spec)
    assert ("time_fast" in paths) == (ctor == "v1_causal")
    ref = paths["materialised"](x, w, b)
    mag = paths["materialised"](x.abs(), w.abs(), b.abs())
    for path, fn in paths.items():
        assert chip_smoke.edge_check(fn(x, w, b), ref, mag)[1] <= 0.0, path
    zero_time = conv.Conv3DSpec(spec.kernel, spec.stride, spec.pads,
                                ("zero",) + spec.modes[1:])
    wrong = chip_smoke.edge_paths(zero_time)["materialised"](x, w, b)
    assert chip_smoke.edge_check(wrong, ref, mag)[1] > 0.0


@pytest.mark.parametrize("fault", [None] + sorted(planted_faults.EDGE_FAULTS))
def test_planted_edge_faults_fail_the_edge_check(tmp_path, fault):
    """Each of ``planted_faults.EDGE_FAULTS`` loads, runs and fails
    ``edge_check`` on an SD3 causal conv in fp32 and bf16; the committed
    decompositions pass every case."""
    module = (None if fault is None else planted_faults.planted_conv(
        tmp_path, 0, planted_faults.EDGE_FAULTS[fault]))
    cases = EDGE_SMALL[1:2] + [("sd3", (1, 5, 9, 11, 16), "sd3_causal", 16)]
    fails = [f for _, f in planted_faults.edge_cases(
        module, CPU, cases, (torch.float32, torch.bfloat16))]
    assert len(fails) == 4
    assert all(fails) if fault else not any(fails)


@pytest.mark.parametrize("fault", sorted(planted_faults.FAULTS))
def test_planted_kernel_faults_apply_once(fault):
    """Each fault of ``planted_faults.FAULTS`` names text that its source
    holds once (else the planted build would fail or plant nothing), and
    changes it."""
    name = planted_faults.FAULTS[fault][1]
    text = (planted_faults._build.CSRC / name).read_text()
    pairs = planted_faults.replacements(planted_faults.FAULTS[fault])
    for old, new in pairs:
        assert text.count(old) == 1 and old != new
        text = text.replace(old, new)


@pytest.mark.parametrize("case", range(len(chip_smoke.K5_CHECK_CASES)))
def test_k5_frames_give_the_output_frames(case):
    """``k5_frames`` picks the input frames (edge repeats gathered, zero
    pads kept) from which K5's plain version gives the chosen output
    frames, as phase 3 compares the 720p path shapes."""
    from cvvae_tpu_torch.ops.kernels.conv_int8 import conv3d_int8_plain

    shape, cout, kernel, stride, pads, modes, bias = \
        chip_smoke.K5_CHECK_CASES[case]
    x, wq, sw, sx, b = chip_smoke.k5_inputs(shape, cout, kernel, "cpu",
                                            torch.float32, bias)
    full = conv3d_int8_plain(x, wq, sw, sx, b, stride, pads, modes)
    t_out = full.shape[1]
    for first, last in ((0, min(2, t_out)), (max(t_out - 2, 0), t_out)):
        xs, t_pads = chip_smoke.k5_frames(x, kernel, stride, pads, modes,
                                          first, last)
        part = conv3d_int8_plain(xs, wq, sw, sx, b, stride,
                                 (t_pads,) + tuple(pads[1:]), modes)
        assert torch.equal(part, full[:, first:last])


def test_k5_pack_weight_layout():
    """The GEMM's B: (O padded to the 128-channel N tile, taps, Cin padded
    to the 128-channel K chunk), taps in (dt, dh, dw) order, zeros in the
    padding."""
    from cvvae_tpu_torch.ops.kernels import conv_int8

    assert (conv_int8.BN, conv_int8.KC) == (128, 128)
    wq = torch.randint(-127, 128, (24, 40, 3, 2, 2), dtype=torch.int8)
    packed = conv_int8.pack_weight(wq)
    assert packed.shape == (128, 12, 128) and packed.dtype == torch.int8
    assert torch.equal(packed[5, (2 * 2 + 1) * 2 + 0, :40], wq[5, :, 2, 1, 0])
    assert not packed[24:].any() and not packed[:, :, 40:].any()


@pytest.mark.parametrize("variant", sorted(kernel_variants.VARIANTS))
def test_kernel_variants_apply_once(variant):
    """Each variant of ``utils/kernel_variants.py`` replaces text that
    csrc/conv_int8.cu holds once."""
    text = (planted_faults._build.CSRC / "conv_int8.cu").read_text()
    for old, new in kernel_variants.VARIANTS[variant]:
        assert text.count(old) == 1 and old != new


def test_k4_lse_check_holds_the_logsumexp():
    """The plain logsumexp passes ``k4_lse_check``; one off by the
    kernel's slack (a stale running max), or a NaN, does not."""
    q, k, _ = chip_smoke.k4_inputs((2, 300, 64), CPU, torch.bfloat16, True)
    ref = chip_smoke.attention_module().flash_attention_lse_plain(
        q, k, 0.125)
    assert chip_smoke.k4_lse_check(ref.clone(), ref)[1] <= 0.0
    stale = ref.clone()
    stale[0, 5] -= chip_smoke.K4_SLACK_LOG2 * 0.6931471805599453
    assert chip_smoke.k4_lse_check(stale, ref)[1] > 0.0
    nan = ref.clone()
    nan[1, 7] = float("nan")
    assert chip_smoke.k4_lse_check(nan, ref)[1] == float("inf")


@pytest.mark.parametrize("fault", [None, "scale", "nan", "dtype"])
def test_k4_bwd_check_holds_the_gradients(monkeypatch, fault):
    """``k4_bwd_check`` passes the plain version against itself (the CPU
    route), and fails dq off by the scale, a NaN and a wrong dtype."""
    att = chip_smoke.attention_module()
    args = chip_smoke.k4_bwd_inputs((1, 200, 64), CPU, rising=True)
    plain = att.flash_attention_backward_plain

    def faulty(*a):
        dq, dk, dv = plain(*a)
        if fault == "scale":
            dq = dq * 0.125
        elif fault == "nan":
            dk = dk.clone()
            dk[0, 3, 1] = float("nan")
        elif fault == "dtype":
            dv = dv.float()
        return dq, dk, dv

    monkeypatch.setattr(att, "flash_attention_backward", faulty)
    _, excess, text, got = chip_smoke.k4_bwd_check(*args)
    assert len(got) == 3
    assert (excess <= 0.0) == (fault is None), text
