"""The port's multi-device inference on a mesh of four CPU ranks over gloo:
H- and T-split encode and decode of v1 and SD3 against the JAX package's
``with_mesh`` on ``make_mesh(4)`` and the port unsharded (the tolerances
of ``tests/test_parallel.py``); int8 (``quantize`` before ``with_mesh``,
``INT8_MIN_POSITIONS`` lowered in both packages); every shape-based
dispatch on the global extent; the followers' copies of the state; and a
follower that dies.  One mesh serves the file; the last test kills one of
its ranks.

int8 on these narrow random nets is chaotic below ~256 positions a conv
(``tests/test_torch_quant.py``): a value one rounding apart may quantize
to the next int8 step, and the sharded GroupNorm rounds in another order,
so a whole int8 net is held, as there, by PSNR >= 40 dB over 2 max|ref|;
each int8 conv alone is bit-equal rank by rank
(``tests/test_torch_parallel.py``).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import torch_parallel_cases as cases
from cvvae_tpu.ops import quant as jquant
from cvvae_tpu_torch.ops import quant
from cvvae_tpu_torch.parallel import mesh as pmesh
from cvvae_tpu_torch.utils.convert import from_jax_params

torch.set_num_threads(2)

N = 4
INT8_PSNR = 40.0


@pytest.fixture(scope="module")
def mesh(tmp_path_factory):
    m = cases.port_mesh(N, tmp_path_factory)
    yield m
    m.close()


@pytest.fixture(scope="module")
def jmesh():
    return cases.jax_mesh(N)


def _psnr(got, ref):
    mse = float(np.mean((got - ref) ** 2))
    peak = 2 * float(np.abs(ref).max())
    return 10 * np.log10(peak ** 2 / mse) if mse > 0 else float("inf")


@pytest.mark.parametrize("family,shard_dim", list(cases.SHAPES))
def test_with_mesh_matches_jax_and_unsharded(mesh, jmesh, family,
                                             shard_dim):
    """As on two ranks; on four, a T-split encoder's runs are one frame
    long at its coarsest level, so the causal convs read two halo frames
    from two ranks back."""
    jvae, tvae = cases.pair(family)
    x = cases.clip(cases.SHAPES[family, shard_dim], seed=2)
    z_ref, x_ref = cases.roundtrip_port(tvae, x)
    z_mesh, x_mesh = cases.roundtrip_port(
        tvae.with_mesh(mesh, shard_dim=shard_dim), x)
    jz, jx = cases.roundtrip_jax(jvae.with_mesh(jmesh, shard_dim=shard_dim),
                                 x)
    for ref in (z_ref, jz):
        np.testing.assert_allclose(z_mesh, ref, **cases.LATENT_TOL)
    for ref in (x_ref, jx):
        np.testing.assert_allclose(x_mesh, ref, **cases.FRAME_TOL[shard_dim])


def _int8_pair(family, monkeypatch, threshold):
    """JAX's quantized model (dynamic activation scales, so each conv's
    scale is an all-reduce MAX over the ranks) and the port's built from
    its tree, with int8 at convs of >= ``threshold`` positions in both."""
    jvae, tvae = cases.pair(family)
    jq = jvae.quantize(min_cin=8)
    tq = quant.load_quantized_state(
        tvae.quantize(min_cin=8),
        from_jax_params(jax.tree.map(np.asarray, jq.params)))
    monkeypatch.setattr(jquant, "INT8_MIN_POSITIONS", threshold)
    monkeypatch.setattr(quant, "INT8_MIN_POSITIONS", threshold)
    return jq, tq


@pytest.mark.parametrize("family,shard_dim", [("v1", "height"),
                                              ("sd3", "time")])
def test_int8_with_mesh(mesh, jmesh, monkeypatch, family, shard_dim):
    """quantize composes with the mesh: the int8 model split over four
    ranks against the port's unsharded int8 model and JAX's int8
    with_mesh, both >= 40 dB.  The scales are dynamic: each is the max
    over every rank's part of the activation."""
    shape = cases.SHAPES[family, shard_dim]
    jq, tq = _int8_pair(family, monkeypatch, 256)
    x = cases.clip(shape, seed=1)
    _, x_ref = cases.roundtrip_port(tq, x)
    _, x_mesh = cases.roundtrip_port(tq.with_mesh(mesh, shard_dim=shard_dim),
                                     x)
    _, jx = cases.roundtrip_jax(jq.with_mesh(jmesh, shard_dim=shard_dim), x)
    assert _psnr(x_mesh, x_ref) >= INT8_PSNR
    assert _psnr(x_mesh, jx) >= INT8_PSNR


def test_dispatch_takes_the_global_extent(mesh, monkeypatch):
    """Every shape-based choice is made on the global shape.  SD3's last
    time-upsample conv of the decoder is quantized and holds 3x32x8 = 768
    positions, 192 on each of the four H runs; at a threshold of 256 it
    runs int8 unsharded, and a dispatch on a run's shape would run it in
    float.  Here int8 moves the frames by far more than the tolerance, and
    the split model stays within it of the unsharded int8 model."""
    shape = cases.SHAPES["sd3", "height"]
    _, tq = _int8_pair("sd3", monkeypatch, 256)
    x = cases.clip(shape, seed=1)
    _, x_ref = cases.roundtrip_port(tq, x)
    _, x_mesh = cases.roundtrip_port(tq.with_mesh(mesh), x)
    monkeypatch.setattr(quant, "INT8_MIN_POSITIONS", 769)
    _, x_float = cases.roundtrip_port(tq, x)
    tol = cases.FRAME_TOL["height"]
    assert np.abs(x_float - x_ref).max() > 20 * tol["atol"]
    np.testing.assert_allclose(x_mesh, x_ref, **tol)


def test_followers_hold_the_controllers_state(mesh):
    """with_mesh sends the whole state: every follower's copy of a
    quantized, calibrated model (int8 weights, per-channel and activation
    scales) is bit-equal to the controller's."""
    _, tvae = cases.pair("v1")
    tq = tvae.quantize(min_cin=8, calibration=torch.from_numpy(
        cases.clip(cases.SHAPES["v1", "height"], seed=11)))
    mv = tq.with_mesh(mesh)
    digests = mesh.call("cvvae_tpu_torch.parallel.mesh:state_digest",
                        mv.model_id)
    assert len(digests) == N
    keys = [k for k, _, _ in digests[0]]
    assert any(k.endswith("scale_x") for k in keys)
    assert any(k.endswith("weight_q") for k in keys)
    for d in digests[1:]:
        assert d == digests[0]


def test_follower_death_fails_loudly(mesh):
    """A follower that dies closes the mesh and raises on the controller;
    nothing falls back to one device."""
    _, tvae = cases.pair("v1")
    mv = tvae.with_mesh(mesh)
    x = torch.from_numpy(cases.clip(cases.SHAPES["v1", "height"]))
    mesh._procs[-1].kill()
    mesh._procs[-1].join(10)
    with pytest.raises(RuntimeError, match="died"):
        mv.encode(x)
    assert mesh.closed
    with pytest.raises(RuntimeError, match="closed"):
        mv.encode(x)
    assert pmesh.rank_model(mv.model_id) is tvae
