"""K1 split across ranks (K1.partial, K1.combine) on the CPU: the plan its
wrappers launch it with, its fold order, and an emulation of its
arithmetic against the JAX package.

The CUDA kernels (``csrc/groupnorm.cu``: ``gn_partial``, ``gn_combine``)
run only on the card; what they are launched with is made in Python
(``ops/kernels/groupnorm.py::split_plan``), from constants read from the
source:

* the plan covers every row of every batch row exactly once, no block
  empty, at least ``kSplitMinRows`` rows a block where the rows allow it,
  no more blocks than it aims at; with 8 blocks an SM and 1 row it is
  K1's own ``launch_plan`` (the partition, so the moments, of the earlier
  two-launch entries);
* the partial's fold adds the blocks' moments in block-index order
  whichever block takes its row's last ticket, in the order of the
  two-launch fold (``block_moments``), its loads batched by
  ``kFoldLoads``: an emulation of both, bit for bit;
* the ticket counters sit at the head of the scratch, one a batch row,
  and every launch leaves them at zero;
* the ctypes plan matches the kernel's ``SplitPlan`` field for field;
* an emulation of the two entries' arithmetic (each rank's moments about
  its own first element, in double; Chan's formula in rank order; the
  folded affine in fp32) on unequal runs of rows equals the JAX package's
  ``group_norm`` / ``group_norm_per_frame`` on the whole tensor within
  2e-5 * (1 + |ref|) in fp32.
"""

import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cvvae_tpu.ops.norm import group_norm as j_group_norm
from cvvae_tpu.ops.norm import group_norm_per_frame as j_group_norm_per_frame

from cvvae_tpu_torch.ops.kernels import _build
from cvvae_tpu_torch.ops.kernels import groupnorm as gn

SOURCE = (_build.CSRC / "groupnorm.cu").read_text()
FOLD_LOADS, = _build.constants("groupnorm.cu", "kFoldLoads")

#: (b, s, c, elem_size): one rank's half of the split path's norms (the
#: per-frame halves of the encoder's mid-block and the decoder tiles, the
#: level-0 half in bf16 and fp32), then ragged and narrow ones
SHAPES = [(5, 45 * 160, 512, 2), (5, 45 * 160, 512, 4),
          (5, 45 * 84, 512, 2), (5, 45 * 84, 512, 4),
          (1, 17 * 360 * 1280, 128, 2), (1, 17 * 360 * 1280, 128, 4),
          (1, 17 * 360 * 672, 256, 2), (17, 180 * 160, 256, 2),
          (2, 3 * 10 * 14, 64, 4), (1, 7 * 11 * 13, 512, 2),
          (2, 3 * 5 * 7, 96, 4), (1, 3, 128, 2), (1, 1, 128, 4),
          (85, 1, 512, 2), (3, 53, 128, 2)]


def test_split_constants_are_read_from_the_kernel_source():
    assert (gn.SPLIT_BLOCKS_PER_SM, gn.SPLIT_MIN_ROWS, gn.SPLIT_TICKETS) == \
        _build.constants("groupnorm.cu", "kSplitBlocksPerSm",
                         "kSplitMinRows", "kTickets")
    assert gn.SPLIT_TICKETS >= 65535  # one counter a batch row, B <= 65535
    assert FOLD_LOADS >= 1


@pytest.mark.parametrize("b,s,c,elem", SHAPES)
def test_split_plan_covers_every_row_once(b, s, c, elem):
    """Block k of a batch row reads rows [k r, min(s, (k + 1) r)): the
    runs tile [0, s) with no gap, overlap or empty block; a block has at
    least min(s, SPLIT_MIN_ROWS) rows and K1's own threads; the plan aims
    at no more than SPLIT_BLOCKS_PER_SM blocks an SM of 132 over all batch
    rows."""
    plan = gn.split_plan(b, s, c, 32, elem)
    base = gn.launch_plan(b, s, c, 32, elem)
    r, n = plan["rows_per_block"], plan["n_blocks"]
    runs = [(k * r, min(s, (k + 1) * r)) for k in range(n)]
    assert runs[0][0] == 0 and runs[-1][1] == s
    assert all(a < e for a, e in runs)
    assert all(runs[k][1] == runs[k + 1][0] for k in range(n - 1))
    assert r >= min(s, gn.SPLIT_MIN_ROWS) and r >= plan["rows_per_iter"]
    assert b * n <= max(b, 132 * gn.SPLIT_BLOCKS_PER_SM)
    for key in ("v", "ns", "threads", "rows_per_iter"):
        assert plan[key] == base[key]
    assert b <= gn.SPLIT_TICKETS


@pytest.mark.parametrize("b,s,c,elem", SHAPES)
def test_split_plan_at_eight_blocks_an_sm_is_k1s(b, s, c, elem):
    """With 8 blocks an SM and 1 row a block, the split plan is K1's
    ``launch_plan``: the two-launch entries' partition."""
    assert gn.split_plan(b, s, c, 32, elem, blocks_per_sm=8,
                         min_rows=1) == gn.launch_plan(b, s, c, 32, elem)


def _tree(lanes):
    """The warp's xor-shuffle tree over 32 lanes' sums (a row each):
    lane l adds lane l ^ o's, o = 16, 8, 4, 2, 1; lane 0's result."""
    a = lanes.copy()
    for o in (16, 8, 4, 2, 1):
        a = a + a[np.arange(32) ^ o]
    return a[0]


def _fold_two_launch(part):
    """``block_moments``: lane l adds blocks l, l + 32, ... one at a time,
    then the tree."""
    lanes = np.zeros((32, 2))
    for k in range(part.shape[0]):
        lanes[k % 32] = lanes[k % 32] + part[k]
    return _tree(lanes)


def _fold_blocks(part, loads):
    """``fold_row``: lane l loads ``loads`` of its blocks at a time and
    adds them in turn, then the tree."""
    n = part.shape[0]
    lanes = np.zeros((32, 2))
    for lane in range(32):
        for k0 in range(lane, n, 32 * loads):
            batch = [part[k] for k in range(k0, min(n, k0 + 32 * loads), 32)]
            for v in batch:
                lanes[lane] = lanes[lane] + v
    return _tree(lanes)


@pytest.mark.parametrize("n_blocks", [1, 2, 31, 33, 206, 210, 257, 1056])
def test_fold_is_fixed_by_block_index(n_blocks):
    """The one-launch fold equals the two-launch fold bit for bit, and the
    ticket protocol makes it independent of the order the blocks finish:
    whichever block takes the last ticket folds the same array."""
    rs = np.random.RandomState(n_blocks)
    part = rs.randn(n_blocks, 2) * 10.0 ** rs.uniform(-3, 6, (n_blocks, 1))
    want = _fold_two_launch(part)
    assert np.array_equal(_fold_blocks(part, FOLD_LOADS), want)
    for seed in range(3):
        order = np.random.RandomState(seed).permutation(n_blocks)
        written = np.full_like(part, np.nan)
        ticket = 0
        for k in order:
            written[k] = part[k]
            last = ticket == n_blocks - 1
            ticket += 1
        assert last and ticket == n_blocks
        assert np.array_equal(_fold_blocks(written, FOLD_LOADS), want)


def test_the_partial_takes_tickets_at_the_head_of_its_scratch():
    """One uint32 counter a batch row at the scratch's head, the block
    moments after them 16-byte aligned; the last ticket is n_blocks - 1
    and the block that takes it sets the counter back to zero."""
    assert "atomicAdd(tickets + b, 1u) == (unsigned)(p.n_blocks - 1)" in \
        SOURCE
    assert "if (threadIdx.x == 0) tickets[b] = 0u;" in SOURCE
    assert "reinterpret_cast<double*>(tickets + kTickets)" in SOURCE
    assert gn.SPLIT_TICKETS * 4 % 16 == 0


def test_split_plan_struct_matches_the_kernels():
    body = re.search(r"struct SplitPlan \{(.*?)\};", SOURCE, re.S).group(1)
    fields = []
    for ctype, names in re.findall(r"(int64_t|int) ([^;]+);", body):
        for name in names.split(","):
            fields.append((name.strip(), ctype))
    ctypes_fields = [(n, "int64_t" if t is _build._L else "int")
                     for n, t in _build.GroupNormSplitPlan._fields_]
    assert ctypes_fields == fields


def test_split_entries_refuse_what_they_do_not_take():
    """A shape the kernels do not take raises before a plan is made; the
    two-launch forms take CUDA tensors only; on a CPU tensor the entries
    take their plain versions."""
    with pytest.raises(ValueError):
        gn._split_plan_of("p", (1, 2, 3, 4, 30), torch.float32, 4, False, 0)
    with pytest.raises(ValueError):
        gn._split_plan_of("p", (1, 2, 3, 4, 2048), torch.float32, 32, False,
                          0)
    x = torch.zeros((1, 2, 3, 4, 64))
    with pytest.raises(ValueError):
        gn.partial_moments_pair(x, 32, False)
    assert torch.equal(gn.partial_moments(x, 32, False),
                       gn.partial_moments_plain(x, 32, False))


def _emulated_partial(x, groups):
    """The partial's (count, mean, M2) of fp32 x (B', S, C) in double:
    the sums of x - K over the rows, K the group's first element on this
    rank, as the kernel's shift."""
    b, s, c = x.shape
    xg = x.reshape(b, s, groups, c // groups).astype(np.float64)
    k = xg[:, 0, :, 0]
    d = xg - k[:, None, :, None]
    a1 = d.sum(axis=(1, 3))
    a2 = np.square(d).sum(axis=(1, 3))
    n = float(s * (c // groups))
    m = a1 / n
    return np.stack([np.full_like(m, n), k + m,
                     np.maximum(a2 - a1 * m, 0.0)], -1)


def _emulated_combine(x, moments, w, bias, groups, eps):
    """Chan's formula over the ranks in rank order in double, mean and
    1/std in fp32, the affine a = inv w, b = bias - mean a in fp32, y =
    fma(x, a, b)."""
    n = np.zeros(moments.shape[1:3])
    mean = np.zeros_like(n)
    m2 = np.zeros_like(n)
    for q in moments:
        nab = n + q[..., 0]
        d = q[..., 1] - mean
        mean = mean + d * (q[..., 0] / nab)
        m2 = m2 + q[..., 2] + d * d * (n * q[..., 0] / nab)
        n = nab
    meanf = mean.astype(np.float32)
    inv = (1.0 / np.sqrt(np.maximum(m2 / n, 0.0).astype(np.float32)
                         + np.float32(eps))).astype(np.float32)
    cg = x.shape[-1] // groups
    a = np.repeat(inv, cg, axis=1) * w[None]
    bb = bias[None] - np.repeat(meanf, cg, axis=1) * a
    return (x.astype(np.float64) * a[:, None] + bb[:, None]).astype(
        np.float32)


@pytest.mark.parametrize("shape,per_frame,runs", [
    ((1, 5, 9, 7, 128), True, (4, 5)),
    ((2, 3, 10, 14, 64), False, (6, 4)),
    ((1, 7, 11, 13, 512), False, (2, 5, 4)),
    ((1, 4, 6, 5, 96), False, (1, 5)),
])
def test_emulated_split_matches_jax_group_norm(shape, per_frame, runs):
    """The two entries' arithmetic on unequal runs of H rows, one a rank,
    against the JAX package's GroupNorm on the whole tensor: 2e-5 *
    (1 + |ref|) in fp32, on K1's check inputs (channel means within
    +-0.75: JAX's one-pass fp32 variance loses digits at larger means,
    which the moments about K do not)."""
    rs = np.random.RandomState(11)
    c = shape[-1]
    x = (rs.randn(*shape) * np.linspace(1, 3, c)
         + np.linspace(-0.75, 0.75, c)).astype(np.float32)
    w = (rs.randn(c) * 0.5 + 1).astype(np.float32)
    bias = (rs.randn(c) * 0.5).astype(np.float32)
    eps = 1e-6
    params = {"scale": jnp.asarray(w), "bias": jnp.asarray(bias)}
    fn = j_group_norm_per_frame if per_frame else j_group_norm
    ref = np.asarray(fn(jnp.asarray(x), params, num_groups=32, eps=eps))
    parts = np.split(x, np.cumsum(runs)[:-1], axis=2)
    rows = shape[0] * shape[1] if per_frame else shape[0]
    flat = [p.reshape(rows, -1, c) for p in parts]
    moments = np.stack([_emulated_partial(p, 32) for p in flat])
    got = np.concatenate([
        _emulated_combine(f, moments, w, bias, 32, eps).reshape(p.shape)
        for f, p in zip(flat, parts)], axis=2)
    assert np.all(np.abs(got - ref) <= 2e-5 * (1 + np.abs(ref)))


def test_kernel_variants_undo_each_split_choice_once():
    """``utils/kernel_variants.py --kernel K1.split``: the entries as
    committed, the two-launch pair on K1's plan, then each choice undone
    alone (the combination's launch, the plan, the fold's launch), every
    one a form of each entry and a plan the wrapper takes."""
    from cvvae_tpu_torch.utils import kernel_variants as kv

    variants = kv.K1_SPLIT_VARIANTS
    committed = ("one", "one", None)
    assert list(variants.values())[0] == committed
    assert ("pair", "pair", (8, 1)) in variants.values()
    undone = []
    for partial, combine, plan in variants.values():
        assert partial in ("one", "pair") and combine in ("one", "pair")
        assert plan is None or gn.split_plan(5, 7200, 512, 32, 2, *plan)
        undone.append(sum((partial != "one", combine != "one",
                           plan is not None)))
    assert sorted(undone) == [0, 1, 1, 1, 3]


@pytest.mark.parametrize("shape,per_frame,rows", [
    ((1, 5, 45, 160, 512), True, 5), ((1, 5, 45, 84, 512), True, 5),
    ((1, 17, 360, 1280, 128), False, 1), ((2, 3, 10, 14, 64), False, 2)])
def test_split_bounds_count_a_batch_row_a_frame(shape, per_frame, rows):
    """``chip_smoke.work``: K1.partial writes (count, mean, M2) in double
    for each of its batch rows' 32 groups, a row a frame where per_frame;
    K1.combine reads the two ranks' moments beside x, y and the fp32
    parameters."""
    import chip_smoke

    numel = int(np.prod(shape))
    for dtype, e in ((torch.bfloat16, 2), (torch.float32, 4)):
        nbytes, flop = chip_smoke.work("K1.partial", shape, dtype,
                                       per_frame=per_frame)
        assert nbytes == numel * e + rows * 32 * 3 * 8 and flop == 3 * numel
        nbytes, _ = chip_smoke.work("K1.combine", shape, dtype,
                                    per_frame=per_frame)
        assert nbytes == (2 * numel * e + 2 * rows * 32 * 3 * 8
                          + 2 * shape[-1] * 4)


def test_compare_tool_child_compiles_and_names_both_forms():
    """``utils/compare_k1_split.py``'s child program (run in each
    checkout) compiles, and its launch names cover the kernels of both the
    one-launch entries and their two-launch forms."""
    import chip_smoke
    from cvvae_tpu_torch.utils import compare_k1_split as c
    from cvvae_tpu_torch.utils import profiling

    compile(c._CHILD, "child", "exec")
    kernels = set(profiling.global_names(SOURCE))
    for name in ("gn_partial", "gn_combine", "gn_stats", "gn_apply"):
        assert name in kernels and f'"{name}"' in c._CHILD
    assert c.SHAPES == chip_smoke.K1_SPLIT_CASES
