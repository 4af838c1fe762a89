"""The port's int8 activation residency (``cvvae_tpu_torch/ops/qflow.py``)
against the JAX package's (``cvvae_tpu/ops/qflow.py``) on the CPU, where
each port function runs its plain version, on seeded numpy inputs and JAX
params converted by ``utils/convert.from_jax_params``.  The six cases of
``tests/test_qflow.py``, each held to JAX's output and to the JAX test's
own bound against the float reference:

* int8 outputs: codes within ±1 of JAX's (CODE_STEP) and at least
  CODE_EQUAL of them equal (the same fp32 value may round to the other
  side of a .5 quotient when the two compute it in other orders);
* float outputs: max|port − JAX| <= FLOAT_RTOL · max|JAX| (fp32 sums in
  other orders);
* the 2-resblock residency chain: the port's dequantized output against
  JAX's at >= CHAIN_DB, and against the fp32 chain at > 28 dB, as
  ``tests/test_qflow.py:173`` holds JAX's.

K5, K1's int8 mode and K6 on the card: ``tests/test_torch_qflow_cuda.py``
and ``chip_smoke.py`` phase 13.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cvvae_tpu.ops import qflow as jq
from cvvae_tpu.ops.activations import silu as jsilu
from cvvae_tpu.ops.conv import Conv3DSpec as JSpec
from cvvae_tpu.ops.conv import conv3d as jconv3d
from cvvae_tpu.ops.conv import conv_init
from cvvae_tpu.ops.norm import group_norm, norm_init
from cvvae_tpu.ops.quant import (attach_activation_scales, calibration_scope,
                                 quantize_conv_params)

from cvvae_tpu_torch.ops import qflow
from cvvae_tpu_torch.ops.conv import Conv3DSpec
from cvvae_tpu_torch.ops.kernels import conv_int8, groupnorm
from cvvae_tpu_torch.ops.kernels import qflow as k6
from cvvae_tpu_torch.utils.convert import from_jax_params

torch.set_num_threads(2)

GROUPS, EPS = 8, 1e-5
CODE_STEP = 1
CODE_EQUAL = 0.999
FLOAT_RTOL = 1e-5
CHAIN_DB = 50.0
JSPEC, JSPEC2 = JSpec.v1_plain(), JSpec.spatial2d()
SPEC, SPEC2 = Conv3DSpec.v1_plain(), Conv3DSpec.spatial2d()


def agreement_db(a, b):
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    mse = float(np.mean((a - b) ** 2))
    return 10 * np.log10(float(np.mean(b ** 2)) / max(mse, 1e-12))


def normal(shape, seed, scale=1.0):
    return (np.random.RandomState(seed).standard_normal(shape)
            * scale).astype(np.float32)


def t(a):
    return torch.from_numpy(np.array(a, np.float32))


def nest(flat):
    """A flat state dict -> {first path part: its sub-dict, leaf: value}."""
    out = {}
    for k, v in flat.items():
        head, _, rest = k.partition(".")
        if rest:
            out.setdefault(head, {})[rest] = v
        else:
            out[head] = v
    return out


def port_params(jparams):
    return nest(from_jax_params(jax.tree.map(np.asarray, jparams)))


def check_codes(got, ref):
    got = got.numpy().astype(np.int32)
    ref = np.asarray(ref).astype(np.int32)
    assert got.shape == ref.shape
    diff = np.abs(got - ref)
    assert diff.max() <= CODE_STEP, diff.max()
    assert (diff == 0).mean() >= CODE_EQUAL, (diff == 0).mean()


def check_float(got, ref):
    ref = np.asarray(ref, np.float32)
    err = float(np.abs(got.float().numpy() - ref).max())
    assert err <= FLOAT_RTOL * float(np.abs(ref).max()), err


def scale_of(x):
    return np.float32(float(np.abs(x).max()) / 127.0)


def channel_scales(x):
    return (np.abs(x).max(axis=(0, 1, 2, 3)) / 127.0).astype(np.float32)


def both_qtensors(x, scale):
    """(JAX's, the port's) requant of x at scale."""
    jx = jq.requant(jnp.asarray(x), jnp.asarray(scale))
    px = qflow.requant(t(x), t(scale))
    check_codes(px.q, jx.q)
    return jx, px


def quantized_conv(cin, cout, seed, spec=JSPEC):
    params = conv_init(jax.random.PRNGKey(seed), spec, cin, cout,
                       jnp.float32)
    qp = quantize_conv_params({"c": params}, min_cin=64, min_cout=16)["c"]
    return params, qp, port_params(qp)


def test_requant_matches_jax_bit_for_bit():
    x = normal((2, 3, 5, 7, 48), 0, 3.0)
    for scale in (scale_of(x), channel_scales(x)):
        jx, px = both_qtensors(x, scale)
        assert np.array_equal(px.q.numpy(), np.asarray(jx.q))
        assert px.q.dtype == torch.int8
        check_float(qflow.dequant(px), jq.dequant(jx))


def test_qconv3d_matches_jax_to_float():
    x = normal((1, 3, 16, 16, 64), 1)
    params, qp, pp = quantized_conv(64, 64, 1)
    ref = jconv3d(jnp.asarray(x), params, JSPEC)
    jx, px = both_qtensors(x, scale_of(x))
    jout = jq.qconv3d(jx, qp, JSPEC, out_dtype=jnp.float32)
    out = qflow.qconv3d(px, pp, SPEC, out_dtype=torch.float32)
    assert out.dtype == torch.float32
    check_float(out, jout)
    assert agreement_db(out.numpy(), ref) > 35.0


def test_qconv3d_requantized_matches_jax():
    x = normal((1, 3, 16, 16, 64), 2)
    params, qp, pp = quantized_conv(64, 32, 3)
    ref = np.asarray(jconv3d(jnp.asarray(x), params, JSPEC))
    out_scale = channel_scales(ref)
    jx, px = both_qtensors(x, scale_of(x))
    jy = jq.qconv3d(jx, qp, JSPEC, out_scale=jnp.asarray(out_scale))
    y = qflow.qconv3d(px, pp, SPEC, out_scale=t(out_scale))
    assert isinstance(y, qflow.QTensor) and y.q.dtype == torch.int8
    check_codes(y.q, jy.q)
    assert agreement_db(qflow.dequant(y).numpy(), ref) > 30.0


def test_qconv3d_refuses_a_per_channel_input_scale():
    x = normal((1, 2, 8, 8, 64), 4)
    _, _, pp = quantized_conv(64, 64, 5)
    px = qflow.requant(t(x), t(channel_scales(x)))
    with pytest.raises(ValueError, match="per-tensor scale"):
        qflow.qconv3d(px, pp, SPEC)


@pytest.mark.parametrize("out", ["float32", "int8"])
def test_qconv3d_fold_per_channel_input_scale(out):
    x = normal((1, 3, 16, 16, 64), 4)
    x = x * (0.1 + np.arange(64, dtype=np.float32) / 16.0)
    params = conv_init(jax.random.PRNGKey(5), JSPEC, 64, 64, jnp.float32)
    ref = np.asarray(jconv3d(jnp.asarray(x), params, JSPEC))
    jx, px = both_qtensors(x, channel_scales(x))
    pp = port_params(params)
    kw_j, kw_p = (({"out_dtype": jnp.float32}, {"out_dtype": torch.float32})
                  if out == "float32" else
                  ({"out_scale": jnp.asarray(channel_scales(ref))},
                   {"out_scale": t(channel_scales(ref))}))
    jout = jq.qconv3d_fold(jx, params["kernel"], params.get("bias"), JSPEC,
                           **kw_j)
    got = qflow.qconv3d_fold(px, pp["weight"], pp.get("bias"), SPEC, **kw_p)
    if out == "float32":
        check_float(got, jout)
        assert agreement_db(got.numpy(), ref) > 35.0
    else:
        check_codes(got.q, jout.q)
        assert agreement_db(qflow.dequant(got).numpy(), ref) > 30.0


@pytest.mark.parametrize("per_channel", [False, True],
                         ids=["scalar_scale", "per_channel_scale"])
def test_qgroup_norm_silu_matches_jax(per_channel):
    x = normal((1, 3, 16, 16, 64), 6, 2.0)
    if per_channel:   # the channels' ranges differ, as a residual's do
        x = x * (0.25 + np.arange(64, dtype=np.float32) / 32.0)
    p = norm_init(64, jnp.float32)
    p = {"scale": p["scale"] + 0.3, "bias": p["bias"] - 0.1}
    pp = port_params(p)
    ref = np.asarray(jsilu(group_norm(jnp.asarray(x), p, num_groups=GROUPS,
                                      eps=EPS)))
    jx, px = both_qtensors(x, channel_scales(x) if per_channel
                           else scale_of(x))
    kw = dict(num_groups=GROUPS, eps=EPS)
    jout = jq.qgroup_norm_silu(jx, p, out_dtype=jnp.float32, **kw)
    out = qflow.qgroup_norm_silu(px, pp, out_dtype=torch.float32, **kw)
    check_float(out, jout)
    assert agreement_db(out.numpy(), ref) > 35.0
    out_scale = scale_of(ref)
    jy = jq.qgroup_norm_silu(jx, p, out_scale=jnp.asarray(out_scale), **kw)
    y = qflow.qgroup_norm_silu(px, pp, out_scale=t(out_scale), **kw)
    assert y.q.dtype == torch.int8
    check_codes(y.q, jy.q)
    assert agreement_db(qflow.dequant(y).numpy(), ref) > 30.0
    bf = qflow.qgroup_norm_silu(px, pp, **kw)
    assert bf.dtype == torch.bfloat16
    assert torch.equal(bf, out.to(torch.bfloat16))


def test_qadd_matches_jax_bit_for_bit():
    a = normal((1, 2, 8, 8, 16), 7)
    b = normal((1, 2, 8, 8, 16), 8)
    out_scale = channel_scales(a + b)
    ja, pa = both_qtensors(a, scale_of(a))
    jb, pb = both_qtensors(b, channel_scales(b))
    jy = jq.qadd(ja, jb, jnp.asarray(out_scale))
    y = qflow.qadd(pa, pb, t(out_scale))
    assert np.array_equal(y.q.numpy(), np.asarray(jy.q))
    assert agreement_db(qflow.dequant(y).numpy(), a + b) > 30.0


def test_plain_versions_are_the_wrappers_on_the_cpu():
    """On a CPU tensor each wrapper is its plain version and launches
    nothing."""
    x = normal((1, 2, 6, 6, 32), 9)
    q = k6.requant_plain(t(x), t(scale_of(x)))
    counts = (conv_int8.launches, groupnorm.int8_launches,
              k6.requant_launches, k6.qadd_launches)
    assert torch.equal(k6.requant(t(x), t(scale_of(x))), q)
    s = torch.tensor(0.02)
    assert torch.equal(k6.qadd(q, s, q, s, s), k6.qadd_plain(q, s, q, s, s))
    w = torch.linspace(0.5, 1.5, 32)
    kw = dict(num_groups=4, eps=EPS, out_scale=s)
    assert torch.equal(groupnorm.group_norm_silu_int8(q, s, w, -w, **kw),
                       groupnorm.group_norm_silu_int8_plain(q, s, w, -w,
                                                            **kw))
    assert counts == (conv_int8.launches, groupnorm.int8_launches,
                      k6.requant_launches, k6.qadd_launches)


def _chain_blocks(c, key):
    ks = jax.random.split(key, 4)
    return [{
        "norm1": norm_init(c, jnp.float32),
        "conv1": conv_init(ks[2 * i], JSPEC, c, c, jnp.float32),
        "norm2": norm_init(c, jnp.float32),
        "conv2": conv_init(ks[2 * i + 1], JSPEC2, c, c, jnp.float32),
    } for i in range(2)]


def _run_fp(blocks, h):
    for blk in blocks:
        r = jsilu(group_norm(h, blk["norm1"], num_groups=GROUPS, eps=EPS))
        r = jconv3d(r, blk["conv1"], JSPEC)
        r = jsilu(group_norm(r, blk["norm2"], num_groups=GROUPS, eps=EPS))
        r = jconv3d(r, blk["conv2"], JSPEC2)
        h = h + r
    return h


def _calibrate(qb, x):
    """The residency scales of ``tests/test_qflow.py``'s chain, recorded
    on an eager fp pass."""
    h, out = x, []
    for blk in qb:
        blk = dict(blk)
        blk["scale_entry"] = jnp.float32(float(jnp.max(jnp.abs(h))) / 127.0)
        r = jsilu(group_norm(h, blk["norm1"], num_groups=GROUPS, eps=EPS))
        r = jconv3d(r, blk["conv1"], JSPEC)
        blk["conv1"] = dict(blk["conv1"], scale_y=jnp.asarray(
            jnp.max(jnp.abs(r), axis=(0, 1, 2, 3)) / 127.0, jnp.float32))
        r = jsilu(group_norm(r, blk["norm2"], num_groups=GROUPS, eps=EPS))
        r = jconv3d(r, blk["conv2"], JSPEC2)
        blk["conv2"] = dict(blk["conv2"], scale_y=jnp.asarray(
            jnp.max(jnp.abs(r), axis=(0, 1, 2, 3)) / 127.0, jnp.float32))
        h = h + r
        blk["scale_res"] = jnp.asarray(
            jnp.max(jnp.abs(h), axis=(0, 1, 2, 3)) / 127.0, jnp.float32)
        out.append(blk)
    return out


def run_residency(mod, blocks, x, spec, spec2):
    """The residency chain of ``tests/test_qflow.py`` through ``mod`` (the
    JAX package's qflow or the port's), from the converted ``blocks``."""
    hq = mod.requant(x, blocks[0]["scale_entry"])
    for blk in blocks:
        r = mod.qgroup_norm_silu(hq, blk["norm1"], num_groups=GROUPS,
                                 eps=EPS, out_scale=blk["conv1"]["scale_x"])
        r = mod.qconv3d(r, blk["conv1"], spec,
                        out_scale=blk["conv1"]["scale_y"])
        r = mod.qgroup_norm_silu(r, blk["norm2"], num_groups=GROUPS,
                                 eps=EPS, out_scale=blk["conv2"]["scale_x"])
        r = mod.qconv3d(r, blk["conv2"], spec2,
                        out_scale=blk["conv2"]["scale_y"])
        hq = mod.qadd(hq, r, blk["scale_res"])
    return hq


def test_residency_chain_matches_jax():
    """The 2-resblock residency chain: the port's output against JAX's
    (>= CHAIN_DB) and against the fp32 chain (> 28 dB, JAX's own bound)."""
    key = jax.random.PRNGKey(9)
    c = 64
    x = normal((1, 3, 24, 24, c), 10)
    blocks = _chain_blocks(c, key)
    ref = np.asarray(_run_fp(blocks, jnp.asarray(x)))
    qb = quantize_conv_params(blocks, min_cin=64)
    with calibration_scope() as rec:
        _run_fp(qb, jnp.asarray(x).astype(jnp.bfloat16))
    rb = _calibrate(attach_activation_scales(qb, rec), jnp.asarray(x))
    jout = np.asarray(jq.dequant(run_residency(jq, rb, jnp.asarray(x),
                                               JSPEC, JSPEC2)))
    pblocks = [port_params(b) for b in rb]
    hq = run_residency(qflow, pblocks, t(x), SPEC, SPEC2)
    assert hq.q.dtype == torch.int8 and tuple(hq.shape) == x.shape
    out = qflow.dequant(hq).numpy()
    assert agreement_db(out, jout) >= CHAIN_DB
    assert agreement_db(out, ref) > 28.0


def test_residency_scales_convert():
    """``from_jax_params`` carries qflow's leaves across as they are."""
    tree = {"conv1": {"kernel_q": np.zeros((1, 3, 3, 4, 2), np.int8),
                      "scale_w": np.ones(2, np.float32),
                      "scale_x": np.float32(0.5),
                      "scale_y": np.full(2, 0.25, np.float32)},
            "scale_res": np.full(4, 0.125, np.float32),
            "scale_entry": np.float32(0.0625),
            "scale_up": np.full(4, 2.0, np.float32)}
    got = from_jax_params(tree)
    assert set(got) == {"conv1.weight_q", "conv1.scale_w", "conv1.scale_x",
                        "conv1.scale_y", "scale_res", "scale_entry",
                        "scale_up"}
    assert got["conv1.weight_q"].shape == (2, 4, 1, 3, 3)
    for k in ("conv1.scale_y", "scale_res", "scale_entry", "scale_up"):
        leaf = tree
        for part in k.split("."):
            leaf = leaf[part]
        assert np.array_equal(got[k].numpy(), leaf), k


#: the chain's first shape, the v1 decoder's (1,17,720,672,128)
CHAIN0 = (1, 17, 720, 672, 128)


@pytest.mark.parametrize("key,dtype,kw,gb,ms,by", [
    # int8 in, int8 out: 2 bytes an element
    ("K1.int8", torch.int8, {}, 2.106, 0.629, "bytes"),
    # two int8 tensors in, one out
    ("K6", torch.int8, {}, 3.159, 0.943, "bytes"),
    # bf16 in, int8 out
    ("K6.requant", torch.bfloat16, {}, 3.159, 0.943, "bytes"),
    # int8 in and out; 7.28 int8 TOP at 1,979 TOP/s
    ("K5.int8", torch.int8, dict(cout=128, kernel=(3, 3, 3),
                                 stride=(1, 1, 1),
                                 pads=((1, 1), (1, 1), (1, 1))),
     2.106, 3.677, "operations"),
], ids=["K1.int8", "K6", "K6.requant", "K5.int8"])
def test_bounds_of_the_residency_modes(key, dtype, kw, gb, ms, by):
    """``chip_smoke.work``'s bytes and bound at the chain's first shape."""
    import chip_smoke
    nbytes, _ = chip_smoke.work(key, CHAIN0, dtype, **kw)
    assert round(nbytes / 1e9, 3) == gb
    got_ms, got_by = chip_smoke.bound(key, CHAIN0, dtype, **kw)
    assert (round(got_ms, 3), got_by) == (ms, by)
