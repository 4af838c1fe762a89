"""The port's multi-device inference (``cvvae_tpu_torch/parallel``,
``VideoVAE.with_mesh``) on a mesh of two CPU ranks over gloo, against the
JAX package's ``with_mesh`` on ``make_mesh(2)`` (conftest's 8 CPU devices)
and against the port unsharded; and the pure parts of the shard plan: the
runs, the conv windows and halo widths, K1's split statistics, and the
time split of an fp32 conv past cuDNN's 32-bit index range.

Tolerances are ``tests/test_parallel.py``'s: 2e-5 (rtol 1e-4) on
latents, 5e-5 on H-sharded frames and 3e-5 on T-sharded ones.  The
sharded GroupNorm sums per rank and then across ranks, in another order
than the unsharded sum, so the two agree to the last few ulps, not
bitwise.  One mesh serves the file (its ranks are processes started
once).
"""

import dataclasses

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import torch_parallel_cases as cases
from cvvae_tpu_torch.ops import conv as tconv
from cvvae_tpu_torch.ops.kernels import groupnorm
from cvvae_tpu_torch.parallel import shard

torch.set_num_threads(2)

N = 2


@pytest.fixture(scope="module")
def mesh(tmp_path_factory):
    m = cases.port_mesh(N, tmp_path_factory)
    yield m
    m.close()


@pytest.fixture(scope="module")
def jmesh():
    return cases.jax_mesh(N)


@pytest.mark.parametrize("family,shard_dim", list(cases.SHAPES))
def test_with_mesh_matches_jax_and_unsharded(mesh, jmesh, family,
                                             shard_dim):
    """Encode and decode split over two ranks, H or T, v1 or SD3: equal
    to JAX's with_mesh and to the port unsharded within the tolerances of
    tests/test_parallel.py (v1's T-split decode keeps 4T'-3 frames)."""
    jvae, tvae = cases.pair(family)
    x = cases.clip(cases.SHAPES[family, shard_dim])
    z_ref, x_ref = cases.roundtrip_port(tvae, x)
    z_mesh, x_mesh = cases.roundtrip_port(
        tvae.with_mesh(mesh, shard_dim=shard_dim), x)
    jz, jx = cases.roundtrip_jax(jvae.with_mesh(jmesh, shard_dim=shard_dim),
                                 x)
    assert x_mesh.shape == x_ref.shape == jx.shape
    if shard_dim == "time":
        assert x_mesh.shape[1] == 4 * z_mesh.shape[1] - 3
    for ref in (z_ref, jz):
        np.testing.assert_allclose(z_mesh, ref, **cases.LATENT_TOL)
    for ref in (x_ref, jx):
        np.testing.assert_allclose(x_mesh, ref, **cases.FRAME_TOL[shard_dim])


def test_tiled_with_mesh_matches_jax_and_unsharded(mesh, jmesh):
    """The tiled paths (every tile a net call over the mesh, blended on
    the controller): a 64x32 clip in 32-px tiles with half overlap."""
    jvae, tvae = cases.pair("v1", tile_spatial_size=32,
                            tile_overlap_ratio=0.5)
    x = cases.clip((1, 5, 64, 32, 3), seed=3)
    z_ref, x_ref = cases.roundtrip_port(tvae, x)
    z_mesh, x_mesh = cases.roundtrip_port(tvae.with_mesh(mesh), x)
    jz, jx = cases.roundtrip_jax(jvae.with_mesh(jmesh), x)
    for ref in (z_ref, jz):
        np.testing.assert_allclose(z_mesh, ref, **cases.LATENT_TOL)
    for ref in (x_ref, jx):
        np.testing.assert_allclose(x_mesh, ref, **cases.FRAME_TOL["height"])


def test_time_split_needs_divisible_frames(mesh):
    """The refusal JAX keeps: T not divisible by the mesh raises its
    ValueError, and the mesh serves the next call."""
    _, tvae = cases.pair("v1")
    tv = tvae.with_mesh(mesh, shard_dim="time")
    with pytest.raises(ValueError, match="divisible"):
        tv.encode(torch.from_numpy(cases.clip((1, 17, 32, 32, 3))))
    z = tv.encode(torch.from_numpy(cases.clip((1, 16, 32, 32, 3)))).mode()
    assert z.shape == (1, 4, 4, 4, 4)


# ---------------------------------------------------------------------------
# the shard plan as pure functions
# ---------------------------------------------------------------------------

def test_row_split_runs_of_whole_blocks():
    assert shard.row_split(720, 2, 8) == (360, 360)
    assert shard.row_split(64, 4, 8) == (16, 16, 16, 16)
    assert shard.row_split(45, 2, 1) == (23, 22)
    assert shard.row_split(100, 2, 8) == (56, 44)    # 13 blocks, the last 4
    with pytest.raises(ValueError, match="no rows"):
        shard.row_split(16, 3, 8)


def test_time_split_is_jax_s():
    assert shard.time_split(16, 4) == (4, 4, 4, 4)
    with pytest.raises(ValueError, match="divisible by 4"):
        shard.time_split(17, 4)


@pytest.mark.parametrize("sizes,spec,widths", [
    ((8, 8), (3, 1, 1, 1), [(0, 1), (1, 0)]),        # zero/edge (1, 1)
    ((8, 8), (3, 1, 2, 0), [(0, 0), (2, 0)]),        # causal time (2, 0)
    ((8, 8), (3, 2, 0, 1), [(0, 1), (0, 0)]),        # v1 downsample
    ((8, 8), (3, 2, 1, 1), [(0, 0), (1, 0)]),        # SD3 downsample
    ((4, 4, 4, 4), (3, 2, 2, 0), [(0, 0), (2, 0), (2, 0), (2, 0)]),
    ((1, 1, 1, 1), (3, 1, 2, 0), [(0, 0), (1, 0), (2, 0), (2, 0)]),
    ((8, 8), (1, 1, 0, 0), [(0, 0), (0, 0)]),        # pointwise
])
def test_halo_widths(sizes, spec, widths):
    """The rows a rank reads beyond its run: a causal conv's 2 frames may
    come from two ranks back where the runs are one frame long."""
    assert shard.halo_widths(sizes, *spec) == widths


SPECS = [tconv.Conv3DSpec.v1_causal(), tconv.Conv3DSpec.v1_plain(),
         tconv.Conv3DSpec.v1_downsample(True),
         tconv.Conv3DSpec.sd3_causal(stride=(2, 2, 2)),
         tconv.Conv3DSpec.sd3_plain(), tconv.Conv3DSpec.spatial2d()]


@pytest.mark.parametrize("spec", SPECS, ids=lambda s: f"{s.kernel}{s.stride}"
                         f"{s.pads}{s.modes[0]}{s.modes[1]}")
@pytest.mark.parametrize("dim,sizes", [(1, (3, 5)), (1, (2, 2, 2, 2)),
                                       (2, (6, 4)), (2, (2, 4, 2, 4))])
def test_window_plan_slabs_give_the_conv(spec, dim, sizes):
    """Each rank's slab (its rows, the halo rows it needs) convolved with
    its pads (global ones only at the global ends) gives exactly its run
    of the unsplit conv's output, at every kernel, stride and pad of the
    two families, along T and H, on even and uneven runs."""
    shape = [1, 8, 10, 6, 4]
    shape[dim] = sum(sizes)
    x = torch.from_numpy(cases.clip(tuple(shape), seed=5))
    params = tconv.Conv(spec, 4, 6, torch.Generator().manual_seed(0))
    ref = tconv.conv3d(x, params, spec)
    a = dim - 1
    need, pads, out = shard.window_plan(sizes, spec.kernel[a],
                                        spec.stride[a], *spec.pads[a])
    assert sum(out) == ref.shape[dim]
    pieces = []
    for (i0, i1), pad in zip(need, pads):
        local = list(spec.pads)
        local[a] = pad
        pieces.append(tconv.conv3d(x.narrow(dim, i0, i1 - i0), params,
                                   dataclasses.replace(spec,
                                                       pads=tuple(local))))
    assert [p.shape[dim] for p in pieces] == list(out)
    torch.testing.assert_close(torch.cat(pieces, dim), ref, atol=1e-6,
                               rtol=1e-5)


@pytest.mark.parametrize("per_frame,dim,sizes", [
    (False, 1, (2, 3)), (False, 2, (5, 3, 4)), (True, 2, (5, 3, 4))])
def test_k1_plain_split_equals_unsharded(per_frame, dim, sizes):
    """K1's plain split (per-rank (count, Σx, Σx²), summed in rank order)
    gives the unsharded plain GroupNorm, with and without SiLU (a T split
    leaves the per-frame norm local)."""
    shape = [2, 5, 12, 6, 16]
    shape[dim] = sum(sizes)
    rs = np.random.RandomState(7)
    x = torch.from_numpy((rs.randn(*shape) * 3 + 1).astype(np.float32))
    w = torch.from_numpy(rs.randn(16).astype(np.float32))
    b = torch.from_numpy(rs.randn(16).astype(np.float32))
    for silu in (False, True):
        kw = dict(num_groups=4, eps=1e-6, silu=silu, per_frame=per_frame)
        ref = groupnorm.group_norm_silu_plain(x, w, b, **kw)
        parts = torch.split(x, list(sizes), dim)
        moments = torch.stack([groupnorm.partial_moments_plain(
            p, 4, per_frame) for p in parts])
        got = torch.cat([groupnorm.combine_plain(p, w, b, moments, **kw)
                         for p in parts], dim)
        torch.testing.assert_close(got, ref, atol=2e-6, rtol=1e-5)


# ---------------------------------------------------------------------------
# an fp32 conv past cuDNN's 32-bit index range, split in time
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("spec", [
    tconv.Conv3DSpec.v1_causal(), tconv.Conv3DSpec.v1_downsample(True),
    tconv.Conv3DSpec.v1_downsample(False), tconv.Conv3DSpec.v1_plain()],
    ids=["causal", "downsample_t2", "downsample_hw_only", "zero_1_1"])
def test_fp32_conv_split_in_time_equals_unsplit(monkeypatch, spec):
    """With TF32 off and the threshold lowered so the conv splits into
    chunks of a few output frames, the split conv equals the unsplit one:
    a causal spec, the stride-2 downsample with its (0, 1) H/W hi pad,
    and zero pads in time."""
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    x = torch.from_numpy(cases.clip((1, 9, 12, 10, 8), seed=9))
    params = tconv.Conv(spec, 8, 16, torch.Generator().manual_seed(0))
    ref = tconv.conv3d(x, params, spec)
    splits = []
    real = tconv._time_split_conv

    def spy(*a):
        splits.append(1)
        return real(*a)

    monkeypatch.setattr(tconv, "_time_split_conv", spy)
    monkeypatch.setattr(tconv, "TIME_SPLIT_ELEMENTS", 3000)
    got = tconv.conv3d(x, params, spec)
    assert splits, "the conv did not split"
    torch.testing.assert_close(got, ref, atol=0, rtol=0)
    # past the threshold only with TF32 off
    splits.clear()
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    tconv.conv3d(x, params, spec)
    assert not splits


def test_time_split_input_chunks_reach_the_threshold(monkeypatch):
    """Each chunk's zero-padded input stays within the threshold (five
    padded frames here: chunks of three output frames), and the chunks
    joined are the conv of the whole clip."""
    x = torch.from_numpy(cases.clip((1, 17, 12, 10, 8), seed=10))
    w = torch.from_numpy(cases.clip((16, 8, 3, 3, 3), seed=11))
    pads, strides = ((2, 0), (1, 1), (1, 1)), (1, 1, 1)
    limit = 5 * 8 * 14 * 12
    monkeypatch.setattr(tconv, "TIME_SPLIT_ELEMENTS", limit)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    seen, real = [], tconv._window_conv

    def record(v, k, p, s, b=None):
        seen.append(v.shape[0] * v.shape[4] * np.prod(
            [n + lo + hi for n, (lo, hi) in zip(v.shape[1:4], p)]))
        return real(v, k, p, s, b)

    monkeypatch.setattr(tconv, "_window_conv", record)
    out = tconv._time_split_conv(x, w, pads, strides, None)
    assert len(seen) == 6 and max(seen) <= limit
    ref = F.conv3d(F.pad(x.permute(0, 4, 1, 2, 3), (1, 1, 1, 1, 2, 0)), w)
    torch.testing.assert_close(out.permute(0, 4, 1, 2, 3), ref, atol=1e-5,
                               rtol=1e-5)


# ---------------------------------------------------------------------------
# the int8 conv and the fused upsample on a split axis, rank by rank
# ---------------------------------------------------------------------------

def _quantized(spec, cin, cout, scale_x):
    """A conv of ``spec`` quantized with a static activation scale."""
    from cvvae_tpu_torch.ops import quant
    params = tconv.Conv(spec, cin, cout, torch.Generator().manual_seed(1))
    quant.quantize_conv_params(params, min_cin=1, min_cout=1)
    params.register_buffer("scale_x", torch.tensor(scale_x))
    return params


@pytest.mark.parametrize("spec", SPECS[:5], ids=lambda s: f"{s.kernel}"
                         f"{s.stride}{s.pads}{s.modes[0]}{s.modes[1]}")
@pytest.mark.parametrize("dim,sizes", [(1, (2, 2, 2, 2)), (2, (6, 4))])
def test_window_plan_slabs_give_the_int8_conv(monkeypatch, spec, dim,
                                              sizes):
    """The same for a quantized conv on K5's plain version: its s8 sums
    are exact integers and its epilogue elementwise, so each rank's run
    is bit-equal to the unsplit int8 conv's."""
    from cvvae_tpu_torch.ops import quant
    monkeypatch.setattr(quant, "INT8_MIN_POSITIONS", 1)
    shape = [1, 8, 10, 6, 8]
    shape[dim] = sum(sizes)
    x = torch.from_numpy(cases.clip(tuple(shape), seed=6))
    params = _quantized(spec, 8, 16, 0.03)
    ref = tconv.conv3d(x, params, spec)
    a = dim - 1
    need, pads, _ = shard.window_plan(sizes, spec.kernel[a],
                                      spec.stride[a], *spec.pads[a])
    pieces = []
    for (i0, i1), pad in zip(need, pads):
        local = list(spec.pads)
        local[a] = pad
        pieces.append(tconv._conv3d(
            x.narrow(dim, i0, i1 - i0), params,
            dataclasses.replace(spec, pads=tuple(local)), x.shape[1:4]))
    assert torch.equal(torch.cat(pieces, dim), ref)


@pytest.mark.parametrize("int8", [False, True], ids=["float", "int8"])
@pytest.mark.parametrize("hw_mode,t_pad", [("zero", (1, 1)),
                                           ("edge", (2, 0))],
                         ids=["v1", "sd3_causal"])
@pytest.mark.parametrize("dim,sizes", [(1, (2, 1, 3)), (2, (3, 2, 3))])
def test_upsample_split_gives_the_unsplit(monkeypatch, int8, hw_mode, t_pad,
                                          dim, sizes):
    """The fused upsample rank by rank: the slab with one halo row (H) or
    the time window's halo frames (T), pads only at the global ends, the
    first output frame dropped only on the rank holding frame 0; joined,
    the runs equal the unsplit op (int8 bit-equal)."""
    from cvvae_tpu_torch.ops import quant, upsample_conv
    monkeypatch.setattr(quant, "INT8_MIN_POSITIONS", 1)
    shape = [1, 4, 6, 5, 8]
    shape[dim] = sum(sizes)
    x = torch.from_numpy(cases.clip(tuple(shape), seed=8))
    spec = tconv.Conv3DSpec((3, 3, 3))
    params = (_quantized(spec, 8, 16, 0.03) if int8 else
              tconv.Conv(spec, 8, 16, torch.Generator().manual_seed(1)))
    kw = dict(n=2, t_mode="edge", hw_mode=hw_mode, drop_first=True)
    ref = upsample_conv.upsample2x_conv3x3_interleave(x, params,
                                                      t_pad=t_pad, **kw)
    pieces = []
    lo, hi = (t_pad if dim == 1 else (1, 1))
    need, pads, _ = shard.window_plan(sizes, 3, 1, lo, hi)
    for r, ((i0, i1), pad) in enumerate(zip(need, pads)):
        slab = x.narrow(dim, i0, i1 - i0)
        if dim == 1:
            got = upsample_conv._upsample(
                slab, params, 2, pad, "edge", hw_mode, r == 0,
                x.shape[1:4], None)
        else:
            got = upsample_conv._upsample(
                slab, params, 2, t_pad, "edge", hw_mode, True,
                x.shape[1:4], pad)
        pieces.append(got)
    got = torch.cat(pieces, dim)
    if int8:
        assert torch.equal(got, ref)
    else:
        torch.testing.assert_close(got, ref, atol=1e-6, rtol=1e-5)


def test_parallel_pulls_in_no_jax():
    """The mesh, its followers' entry and the collective probe import
    nothing of JAX or of the JAX package (checked in a subprocess: this
    process has JAX loaded by conftest)."""
    import os
    import subprocess
    import sys
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = ("import sys\n"
            "import cvvae_tpu_torch.parallel, cvvae_tpu_torch.parallel.shard\n"
            "import cvvae_tpu_torch.utils.probe_collectives\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'cvvae_tpu' or "
            "m.startswith('cvvae_tpu.'))\n"
            "assert not bad, bad\n"
            "print('clean')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=root,
                         env=dict(os.environ, PYTHONPATH=root),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "clean"
