"""The port's edge-pad conv decompositions against the JAX package's.

``cvvae_tpu_torch/ops/conv.py`` ports ``_conv3d_edge_time_fast`` (the
causal convs' zero time window plus per-frame fixes) and
``_conv3d_edge_fast`` (zero windows plus thin-slab fixes on every edge
axis, for every other edge pad).  Each is held on the CPU, in fp32, at
the six padding families and five shapes of ``tests/test_edge_fast_conv.py``
(single frame, minimal extent, stride 2 included), against the JAX
package's counterpart and its materialised-pad lowering, at that file's
tolerance (atol 2e-5, rtol 1e-5: the two sum in other orders).  Inputs and
JAX params are made with numpy from a seed; the port gets the params
through ``from_jax_params``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax import lax

from cvvae_tpu.ops import conv as jconv

from cvvae_tpu_torch.ops import conv as tconv
from cvvae_tpu_torch.utils.convert import from_jax_params

torch.set_num_threads(2)

ATOL, RTOL = 2e-5, 1e-5
COUT = 24

SPECS = {
    "sd3_plain": jconv.Conv3DSpec.sd3_plain(),
    "sd3_causal": jconv.Conv3DSpec.sd3_causal(),
    "sd3_down_time": jconv.Conv3DSpec.sd3_causal(stride=(2, 2, 2)),
    "sd3_down_space": jconv.Conv3DSpec.sd3_plain(stride=(1, 2, 2)),
    "v1_causal": jconv.Conv3DSpec.v1_causal(),
    "v1_downsample": jconv.Conv3DSpec.v1_downsample(True),
}
#: the convs the time-axis decomposition takes: edge time, zero space
TIME_SPECS = {
    "v1_causal": SPECS["v1_causal"],
    "v1_downsample": SPECS["v1_downsample"],
    "v1_downsample_space": jconv.Conv3DSpec.v1_downsample(False),
}
SHAPES = [
    (1, 5, 12, 10, 16),
    (1, 1, 12, 10, 16),   # single frame: T window off both ends
    (1, 5, 3, 3, 16),     # minimal spatial extent
    (1, 2, 4, 4, 16),
    (2, 3, 8, 8, 16),
]


def _case(spec, shape, seed):
    """x (numpy), JAX params, and the port's spec and conv params."""
    rs = np.random.RandomState(seed)
    x = rs.randn(*shape).astype(np.float32)
    bound = 1.0 / np.sqrt(spec.fan_in(shape[-1]))
    params = {
        "kernel": rs.uniform(-bound, bound, spec.kernel + (shape[-1], COUT))
        .astype(np.float32),
        "bias": rs.uniform(-bound, bound, (COUT,)).astype(np.float32)}
    port_spec = tconv.Conv3DSpec(spec.kernel, spec.stride, spec.pads,
                                 spec.modes, spec.use_bias)
    conv = tconv.Conv(port_spec, shape[-1], COUT)
    conv.load_state_dict(from_jax_params(params), strict=True)
    return x, params, port_spec, conv


def _materialized(x, params, spec):
    """The JAX package's straightforward lowering: edge pads materialised,
    zero pads in the window (as tests/test_edge_fast_conv.py)."""
    xp = jconv._edge_pad(jnp.asarray(x), spec.pads, spec.modes)
    zero = [tuple(p) if m == "zero" else (0, 0)
            for p, m in zip(spec.pads, spec.modes)]
    y = lax.conv_general_dilated(
        xp, params["kernel"], window_strides=spec.stride, padding=zero,
        dimension_numbers=jconv._DIMENSION_NUMBERS)
    return y + params["bias"]


def _close(got, ref, what):
    got = got.detach().numpy()
    assert got.shape == np.asarray(ref).shape, what
    np.testing.assert_allclose(got, np.asarray(ref), atol=ATOL, rtol=RTOL,
                               err_msg=what)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("name", sorted(SPECS))
def test_edge_fast_matches_jax(name, shape):
    """The all-axes decomposition against JAX's ``_conv3d_edge_fast`` and
    against the materialised pad."""
    spec = SPECS[name]
    x, params, port_spec, conv = _case(spec, shape, 1)
    with torch.no_grad():
        got = tconv._conv3d_edge_fast(torch.from_numpy(x), conv.weight,
                                      port_spec, bias=conv.bias)
    ref = jconv._conv3d_edge_fast(jnp.asarray(x), params["kernel"], spec,
                                  None) + params["bias"]
    _close(got, ref, f"{name} {shape} vs JAX _conv3d_edge_fast")
    _close(got, _materialized(x, params, spec),
           f"{name} {shape} vs the materialised pad")


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("name", sorted(TIME_SPECS))
def test_edge_time_fast_matches_jax_dispatch(name, shape):
    """The time-axis decomposition against JAX's ``conv3d`` (its own
    time-fast path where T > 1, the materialised pad at T = 1)."""
    spec = TIME_SPECS[name]
    x, params, port_spec, conv = _case(spec, shape, 2)
    with torch.no_grad():
        got = tconv._conv3d_edge_time_fast(torch.from_numpy(x), conv.weight,
                                           port_spec, bias=conv.bias)
    _close(got, jconv.conv3d(jnp.asarray(x), params, spec),
           f"{name} {shape} vs JAX conv3d")


@pytest.mark.parametrize("edge_fast", [False, True])
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("name", sorted(SPECS))
def test_conv3d_dispatch_matches_jax(monkeypatch, name, shape, edge_fast):
    """The port's ``conv3d`` against JAX's with the JAX package's
    ``EDGE_FAST_SPACE`` off and on (flipped as tests/test_edge_fast_conv.py
    flips it): its two dispatches compute one function, and the port,
    which always decomposes, is held against each."""
    monkeypatch.setattr(jconv, "EDGE_FAST_SPACE", edge_fast)
    spec = SPECS[name]
    x, params, port_spec, conv = _case(spec, shape, 3)
    with torch.no_grad():
        got = conv(torch.from_numpy(x))
    assert got.is_contiguous()
    _close(got, jconv.conv3d(jnp.asarray(x), params, spec),
           f"{name} {shape} vs JAX with EDGE_FAST_SPACE={edge_fast}")


@pytest.mark.parametrize("name", ["sd3_causal", "sd3_down_time",
                                  "v1_downsample"])
def test_raw_conv_is_the_conv_that_runs(name):
    """A ``raw_conv`` passed in runs the main conv (the weight itself, the
    spec's window pads and strides) and every slab fix: one that doubles
    the default conv doubles the output (the fixes are linear in it)."""
    spec = SPECS[name]
    x, params, port_spec, conv = _case(spec, SHAPES[0], 4)
    calls = []

    def raw_conv(v, k, pads, strides):
        calls.append((k is conv.weight, tuple(map(tuple, pads)),
                      tuple(strides)))
        return 2.0 * tconv._window_conv(v, k, pads, strides)

    with torch.no_grad():
        got = tconv._conv3d_edge_fast(torch.from_numpy(x), conv.weight,
                                      port_spec, raw_conv=raw_conv)
    ref = jconv._conv3d_edge_fast(jnp.asarray(x), params["kernel"], spec,
                                  None)
    _close(got, 2.0 * np.asarray(ref), f"{name}: doubled by raw_conv")
    assert calls[0] == (True, tuple(map(tuple, spec.pads)),
                        tuple(spec.stride))
    assert len(calls) > 1 and not any(c[0] for c in calls[1:])
