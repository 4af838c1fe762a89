"""K4.bwd's host side on the CPU: its plan, the index arithmetic of its
exchange, and an emulation of the kernel's schedule.

The CUDA kernel (``csrc/attention_bwd.cu``) runs only on the card; what is
checked here:

* ``backward_plan`` (``ops/kernels/attention.py``, constants read from the
  source with ``_build.constants``): the slice width and cluster size of
  dkv at each width in ``WIDTHS``, dkv's and dq's grids covering every
  (batch row, 64-row tile, head-dim slice) exactly once, shared memory
  within the 232,448 bytes a block may have (a cluster of 2 at C = 512
  does not fit), and the scratch holding D and dSᵀ;
* the exchange: the accumulator layout the partials are written in and
  read back from, each (row, column) of a 64x64 tile formed by exactly one
  rank (reduce-scatter) or by every rank for itself (all-gather), and the
  128-byte-swizzled bf16 stores landing on distinct bytes of the operand
  tile in the layout the wgmma descriptor reads;
* the kernel's schedule emulated here (dkv's per-slice partials summed in
  rank order, P and dS rounded to bf16 as product operands, per-tile
  accumulation, keys and queries >= S masked, the scale applied once; dq
  the product of the rounded dSᵀ that dkv leaves with k, key tile by key
  tile)
  equals ``flash_attention_backward_plain`` in float64 without the
  roundings (1e-10), and is within ``chip_smoke.K4_BWD_MAX`` and
  ``K4_BWD_RMS`` of it in the card's arithmetic at the widths and S of
  ``chip_smoke.K4_BWD_CHECK_SHAPES`` (what the card is held to);
* the source: wgmma, TMA and clusters, no mma.sync, no atomics; each
  K4.bwd variant of ``utils/kernel_variants.py`` and the stamps of
  ``utils/trace_k4_bwd.py`` apply to it once, and the trace's readings
  are computed as stated.
"""

import math
import re

import numpy as np
import pytest
import torch

import chip_smoke
from cvvae_tpu_torch.ops.kernels import _build
from cvvae_tpu_torch.ops.kernels import attention
from cvvae_tpu_torch.utils import kernel_variants, trace_k4_bwd

torch.set_num_threads(2)

LOG2E = 1.4426950408889634
T = attention.BWD_TILE

#: width -> (slice, cluster) the plan must give
WANT = {64: (64, 1), 128: (128, 1), 256: (128, 2), 512: (128, 4)}

#: (B, S, C) of the plan tests: the check and path shapes, S below a tile,
#: S one past a tile, the largest batch
PLAN_SHAPES = ([s for s, _ in chip_smoke.K4_BWD_CHECK_SHAPES]
               + [s for s, _ in chip_smoke.K4_BWD_SHAPES]
               + [(3, 1, 512), (2, 65, 256), (65535, 3, 64)])


def test_plan_constants_are_the_kernels():
    """The plan reads the kernel's own schedule from its source."""
    assert (T, attention.BWD_SLICE, attention.BWD_STAGES,
            attention.BWD_DQ_COLS, attention.BWD_DQ_STAGES,
            attention.BWD_THREADS) == _build.constants(
                "attention_bwd.cu", "kTile", "kSliceCols", "kStages",
                "kDqCols", "kDqStages", "kThreads")
    assert T == 64 and attention.BWD_THREADS == 256  # wgmma's M, 2 WGs


@pytest.mark.parametrize("c", attention.WIDTHS)
def test_plan_slice_and_cluster_per_width(c):
    """D = slice · cluster; a slice is whole 64-column TMA groups; the
    cluster is portable (<= 8) and splits a tile's 4 accumulator warps'
    rows evenly (reduce-scatter); shared memory fits one block."""
    p = attention.backward_plan(1, 1024, c)
    assert (p["slice"], p["cluster"]) == WANT[c]
    assert p["slice"] * p["cluster"] == c and p["slice"] % 64 == 0
    assert p["cluster"] <= 8 and 4 % p["cluster"] == 0
    assert p["smem"] <= attention.SMEM_LIMIT
    assert p["threads"] == attention.BWD_THREADS
    # dq: whole 64-column groups, each warpgroup half of them (wgmma's N
    # of 32, 64 or 128)
    assert c % p["dq_cols"] == 0 and p["dq_cols"] % 64 == 0
    assert p["dq_cols"] // 2 in (32, 64, 128)
    assert p["dq_smem"] <= attention.SMEM_LIMIT


@pytest.mark.parametrize("shape", PLAN_SHAPES)
def test_grid_covers_every_batch_tile_and_slice_once(shape):
    """Block (x, y) takes batch row y, tile x // cluster, slice x %
    cluster (its cluster rank); every (row, tile, slice) exactly once; the
    tiles cover rows [0, S) and the slices columns [0, C), each once."""
    b, s, c = shape
    p = attention.backward_plan(b, s, c)
    gx, gy = p["grid"]
    assert gy == b and gx % p["cluster"] == 0 and gy <= 65535
    xs = np.arange(gx)
    tiles, ranks = xs // p["cluster"], xs % p["cluster"]
    seen = np.zeros((p["tiles"], p["cluster"]), np.int64)
    np.add.at(seen, (tiles, ranks), 1)
    assert (seen == 1).all()
    rows = np.zeros(p["tiles"] * T, np.int64)
    for t in range(p["tiles"]):
        rows[t * T:(t + 1) * T] += 1
    assert (rows[:s] == 1).all() and p["tiles"] == math.ceil(s / T)
    cols = np.zeros(c, np.int64)
    for r in range(p["cluster"]):
        cols[r * p["slice"]:(r + 1) * p["slice"]] += 1
    assert (cols == 1).all()
    # dq: block x takes query tile x // parts and columns of part x % parts
    parts = c // p["dq_cols"]
    qx, qy = p["dq_grid"]
    assert qy == b and qx == parts * p["tiles"]
    seen = np.zeros((p["tiles"], parts), np.int64)
    np.add.at(seen, (np.arange(qx) // parts, np.arange(qx) % parts), 1)
    assert (seen == 1).all()


@pytest.mark.parametrize("shape", PLAN_SHAPES)
def test_scratch_holds_d_then_the_padded_ds(shape):
    """The scratch: D's B·S fp32 rounded up to 1 KB (so dSᵀ starts
    1024-aligned for its tensor map), then dSᵀ's B·S'·S' bf16 with S' the
    tiles' rows; a row of S' bf16 is a multiple of 128 bytes."""
    b, s, c = shape
    p = attention.backward_plan(b, s, c)
    sp = p["tiles"] * T
    d_bytes = p["scratch_bytes"] - b * sp * sp * 2
    assert d_bytes % 1024 == 0 and 0 <= d_bytes - 4 * b * s < 1024
    assert (sp * 2) % 128 == 0 and sp >= s


@pytest.mark.parametrize("c", attention.WIDTHS)
def test_walk_ring_depth_is_forced(c):
    """The ring holds the three walk tiles the pipeline has in use at once
    (the source asserts at least three), and a fourth stage of 2 x 16 KB
    would pass the limit wherever a slice is 128 columns."""
    assert attention.BWD_STAGES == 3
    assert "static_assert(kStages >= 3," in _source()
    p3 = attention.backward_plan(8, 1600, c, stages=3)
    p4 = attention.backward_plan(8, 1600, c, stages=4)
    assert p3["smem"] <= attention.SMEM_LIMIT
    assert p4["smem"] - p3["smem"] == 2 * T * p3["slice"] * 2
    assert (p4["smem"] > attention.SMEM_LIMIT) == (p3["slice"] == 128)


def test_a_cluster_of_two_at_512_does_not_fit():
    """Slices of 256 columns (a cluster of 2 at C = 512) would need more
    shared memory than a block may have, whatever the ring depth: the
    choice of 4 is forced."""
    for stages in (2, 3):
        p = attention.backward_plan(8, 1600, 512, slice_cols=256,
                                    stages=stages)
        assert p["cluster"] == 2 and p["smem"] > attention.SMEM_LIMIT


# ---------------------------------------------------------------------------
# the exchange's index arithmetic (attention_bwd.cu: item, exchange)
# ---------------------------------------------------------------------------

def _accumulator(w, lane, j, e):
    """(row, column) of register 4j + e of lane ``lane`` of warp ``w`` in a
    warpgroup's m64nN accumulator."""
    return (16 * w + lane // 4 + 8 * (e >> 1),
            8 * j + 2 * (lane % 4) + (e & 1))


def _items(cluster, rank, reduce_scatter):
    """The kernel's ``item``: [(w, i, lane)] of every (u, thread) of rank
    ``rank``'s exchange."""
    w_count = 4 // cluster if reduce_scatter else 4
    first = rank * w_count if reduce_scatter else 0
    out = []
    for u in range(w_count):
        for t in range(attention.BWD_THREADS):
            l_ = u * attention.BWD_THREADS + t
            out.append((first + (l_ // 32) % w_count, l_ // (32 * w_count),
                        l_ % 32))
    return out


def _xoff(tensor, w, j, lane):
    """The kernel's ``xoff``: byte offset of a float4 of the partials."""
    return (((tensor * 4 + w) * 8 + j) * 32 + lane) * 16


def test_accumulator_layout_is_a_bijection_and_the_exchange_buffer():
    """The 128 threads' 32 registers cover the 64x64 tile once; the
    float4s of both partials fill the 32 KB exchange buffer once, and a
    warp's 32 stores of one register group are consecutive (no bank
    conflict)."""
    seen = np.zeros((64, 64), np.int64)
    slots = np.zeros(2 * 64 * 64 * 4 // 16, np.int64)
    for t in range(128):
        w, lane = divmod(t, 32)
        for j in range(8):
            for e in range(4):
                seen[_accumulator(w, lane, j, e)] += 1
            for tensor in (0, 1):
                slots[_xoff(tensor, w, j, lane) // 16] += 1
                assert (_xoff(tensor, w, j, lane) - _xoff(tensor, w, j, 0)
                        == 16 * lane)
    assert (seen == 1).all() and (slots == 1).all()


@pytest.mark.parametrize("cluster", [1, 2, 4])
@pytest.mark.parametrize("reduce_scatter", [True, False])
def test_exchange_forms_each_element_once(cluster, reduce_scatter):
    """Reduce-scatter: across the cluster's ranks each (row, column) of the
    tile is formed exactly once, and each rank's rows are whole
    accumulator warps; all-gather: each rank forms every element once for
    itself."""
    total = np.zeros((64, 64), np.int64)
    for rank in range(cluster):
        mine = np.zeros((64, 64), np.int64)
        for w, i, lane in _items(cluster, rank, reduce_scatter):
            for e in range(4):
                mine[_accumulator(w, lane, i, e)] += 1
        if reduce_scatter:
            rows = np.nonzero(mine.any(axis=1))[0]
            assert len(rows) == 64 // cluster and rows[0] % 16 == 0
            assert (mine[rows] == 1).all()
        else:
            assert (mine == 1).all()
        total += mine
    assert (total == (1 if reduce_scatter else cluster)).all()


def _swizzled(row, col):
    """Byte offset of bf16 element (row, col) of a 64x64 K-major tile in
    128-byte-swizzled rows: 16-byte chunk k of row r at k ^ (r % 8)."""
    return row * 128 + (((col * 2) // 16) ^ (row % 8)) * 16 + (col * 2) % 16


def test_exchange_stores_land_on_the_swizzled_layout():
    """The kernel's store offset row·128 + ((i ^ (row & 7)) << 4) +
    4·(lane % 4) (+ 1024 for row + 8) is the swizzled address of the pair
    (row, 8i + 2·(lane % 4)); over a rank's items the 4-byte stores cover
    the 8 KB tile exactly once, and a warp's 32 stores hit 32 banks."""
    hits = np.zeros(64 * 64 * 2, np.int64)
    for w, i, lane in _items(1, 0, True):
        row, col = 16 * w + lane // 4, 8 * i + 2 * (lane % 4)
        off = row * 128 + ((i ^ (row & 7)) << 4) + 4 * (lane % 4)
        assert off == _swizzled(row, col)
        assert off + 1024 == _swizzled(row + 8, col)
        assert _swizzled(row, col + 1) == off + 2
        for o in (off, off + 1024):
            hits[o:o + 4] += 1
    assert (hits == 1).all()
    for w in range(4):
        for i in range(8):
            banks = {(_swizzled(16 * w + lane // 4, 8 * i + 2 * (lane % 4))
                      // 4) % 32 for lane in range(32)}
            assert len(banks) == 32


# ---------------------------------------------------------------------------
# an emulation of the kernel's schedule
# ---------------------------------------------------------------------------

def _emulate(q, k, v, o, do, lse, scale, exact=False):
    """(dq, dk, dv) by K4.bwd's schedule.  ``exact``: float64 and no bf16
    rounding (the algebra alone); else fp32 sums, P and dS rounded to bf16
    as product operands, outputs in bf16."""
    acc = torch.float64 if exact else torch.float32
    b, s, c = q.shape
    p = attention.backward_plan(b, s, c)
    sl, cl = p["slice"], p["cluster"]
    qf, kf, vf, dof = (x.to(acc) for x in (q, k, v, do))
    dvec = (do.to(acc) * o.to(acc)).sum(-1)          # rowdot
    lse2 = lse.to(acc) * LOG2E
    scale_log2 = scale * LOG2E
    rnd = (lambda x: x) if exact else (lambda x: x.bfloat16().to(acc))
    tiles = [(t * T, min(s, t * T + T)) for t in range(p["tiles"])]

    def partial_sum(own, walk, o0, o1, w0, w1, bi):
        """own[o0:o1] · walk[w0:w1]ᵀ, each rank's slice apart, summed in
        rank order."""
        total = None
        for r in range(cl):
            cols = slice(r * sl, (r + 1) * sl)
            part = own[bi, o0:o1, cols] @ walk[bi, w0:w1, cols].T
            total = part if total is None else total + part
        return total

    dq, dk, dv = (torch.zeros(b, s, c, dtype=acc) for _ in range(3))
    for bi in range(b):
        ds_t = torch.zeros(s, s, dtype=acc)           # the scratch's dSᵀ
        for k0, k1 in tiles:                          # dkv: a key tile
            dk_acc = torch.zeros(k1 - k0, c, dtype=acc)
            dv_acc = torch.zeros(k1 - k0, c, dtype=acc)
            for q0, q1 in tiles:                      # walks the queries
                st = partial_sum(kf, qf, k0, k1, q0, q1, bi)
                dpt = partial_sum(vf, dof, k0, k1, q0, q1, bi)
                pt = torch.exp2(st * scale_log2 - lse2[bi, None, q0:q1])
                dst = rnd(pt * (dpt - dvec[bi, None, q0:q1]))
                dv_acc = dv_acc + rnd(pt) @ dof[bi, q0:q1]
                dk_acc = dk_acc + dst @ qf[bi, q0:q1]
                ds_t[k0:k1, q0:q1] = dst
            dk[bi, k0:k1], dv[bi, k0:k1] = dk_acc * scale, dv_acc
        for q0, q1 in tiles:                          # dq: a query tile
            dq_acc = torch.zeros(q1 - q0, c, dtype=acc)
            for k0, k1 in tiles:                      # walks the keys
                dq_acc = dq_acc + ds_t[k0:k1, q0:q1].T @ kf[bi, k0:k1]
            dq[bi, q0:q1] = dq_acc * scale
    out = torch.float64 if exact else torch.bfloat16
    return dq.to(out), dk.to(out), dv.to(out)


def _inputs(shape, rising):
    return chip_smoke.k4_bwd_inputs(shape, torch.device("cpu"), rising)


@pytest.mark.parametrize("shape,rising", chip_smoke.K4_BWD_CHECK_SHAPES)
def test_emulated_schedule_is_the_plain_algebra(shape, rising):
    """In float64 without the roundings the tiles, slices, masks and scale
    give the plain version's gradients (1e-10 relative to each max)."""
    q, k, v, o, do, lse, scale = _inputs(shape, rising)
    args = [x.double() for x in (q, k, v, o, do, lse)]
    got = _emulate(*args, scale, exact=True)
    ref = attention.flash_attention_backward_plain(*args, scale)
    for name, g, r in zip(("dq", "dk", "dv"), got, ref):
        assert (g - r).abs().max() <= 1e-10 * r.abs().max(), name


@pytest.mark.parametrize("shape,rising", chip_smoke.K4_BWD_CHECK_SHAPES)
def test_emulated_schedule_within_the_card_bounds(shape, rising):
    """In the card's arithmetic, within K4_BWD_MAX · max|ref| and
    K4_BWD_RMS of the plain version, as the kernel is held on the card."""
    q, k, v, o, do, lse, scale = _inputs(shape, rising)
    got = _emulate(q, k, v, o, do, lse, scale)
    ref = attention.flash_attention_backward_plain(q, k, v, o, do, lse,
                                                   scale)
    for name, g, r in zip(("dq", "dk", "dv"), got, ref):
        assert g.dtype == torch.bfloat16 and g.shape == r.shape
        err, _, ref_max, rms = chip_smoke.compare(g, r)
        assert err <= chip_smoke.K4_BWD_MAX * ref_max, (name, err, ref_max)
        assert rms <= chip_smoke.K4_BWD_RMS, (name, rms)


def test_emulated_rank_order_fixes_the_bits():
    """Summing the slices' partials in rank order gives one answer; another
    order gives other bits in fp32 (so the order is what makes every CTA
    and every call agree)."""
    g = torch.Generator().manual_seed(3)
    parts = [torch.randn(64, 64, generator=g) * 10 ** (i - 2)
             for i in range(4)]
    ordered = ((parts[0] + parts[1]) + parts[2]) + parts[3]
    again = ((parts[0] + parts[1]) + parts[2]) + parts[3]
    other = ((parts[3] + parts[2]) + parts[1]) + parts[0]
    assert torch.equal(ordered, again)
    assert not torch.equal(ordered, other)


# ---------------------------------------------------------------------------
# the source
# ---------------------------------------------------------------------------

def _source():
    return (_build.CSRC / "attention_bwd.cu").read_text()


def test_source_is_wgmma_tma_and_clusters_without_atomics():
    text = _source()
    assert "mma.sync" not in text and "cp.async.cg" not in text
    assert "wgmma.mma_async" in text
    assert "cp.async.bulk.tensor.4d" in text
    assert "__cluster_dims__(C, 1, 1)" in text
    assert "cp.async.bulk.tensor.3d" in text      # dq's dSᵀ tiles
    assert "ld.shared::cluster" in text and "st.shared::cluster" in text
    assert not re.search(r"\batomic[A-Z]\w*\(|\batom\.|\bred\.", text)


def test_cluster_helpers_live_in_hopper_cuh():
    """K4's forward and K4.bwd share the cluster helpers."""
    hopper = (_build.CSRC / "hopper.cuh").read_text()
    for name in ("cluster_rank", "cluster_sync", "mbar_arrive_cluster"):
        assert f"void {name}(" in hopper or f"uint32_t {name}(" in hopper
        for src in ("attention.cu", "attention_bwd.cu"):
            text = (_build.CSRC / src).read_text()
            assert not re.search(rf"\b\w+ {name}\(", text), (src, name)


def test_c_abi_is_unchanged():
    """The exported function and its ctypes signature."""
    assert "CVVAE_EXPORT int cvvae_flash_attention_bwd(" in _source()
    P, I, F = _build._P, _build._I, _build._F
    assert _build._SIGNATURES["cvvae_flash_attention_bwd"] == (
        [P] * 10 + [I, I, I, F, I, I, P])


@pytest.mark.parametrize("variant",
                         sorted(kernel_variants.K4_BWD_VARIANTS))
def test_k4_bwd_variants_apply_once(variant):
    """Each K4.bwd variant of ``utils/kernel_variants.py`` replaces text
    that its source holds exactly once."""
    text = _source()
    for old, new in kernel_variants.K4_BWD_VARIANTS[variant]:
        assert text.count(old) == 1, (variant, old)
        text = text.replace(old, new)


def test_trace_stamps_apply_once():
    """``utils/trace_k4_bwd.py`` instruments text that the source holds
    exactly once, the loop it stamps included."""
    text = _source()
    for old, new in trace_k4_bwd.STAMPS:
        assert text.count(old) == 1, old
        text = text.replace(old, new)
    assert text.count("stamp();") == len(trace_k4_bwd.PHASES)


def test_trace_readings():
    """The trace's phases from a tile's stamps, and residency from the
    CTAs' intervals."""
    per = len(trace_k4_bwd.PHASES)
    gaps = np.arange(1, per + 1) * 10
    stamps = np.concatenate([[0], np.cumsum(np.tile(gaps, 4))])[:4 * per]
    split = trace_k4_bwd.phases_ns(stamps)
    assert list(split.values()) == gaps.tolist()
    ctas = np.array([[0, 100, 0], [50, 150, 1], [120, 200, 0],
                     [200, 300, 2]])
    r = trace_k4_bwd.residency(ctas)
    assert r["resident"] == 2 and r["sms"] == 3
    assert r["span_us"] == 0.3 and r["cta_median_us"] == 0.1
