"""K2.bwd's plan on the CPU (``shuffle.bwd_plan``): the copy's partition
of the rows, the d(bias) merge's partition of the slots, and an emulation
in numpy of the kernel's fixed-order sums (a row's sum, its channel
group's sum, the block's tree over its pixel threads, the merge's slot
ranges in double and their tree) held to the bound ``bwd_plan`` states,
which ``chip_smoke.k2_bwd_check`` holds the card to.  The phases
themselves are held to ``jax.vjp`` in ``tests/test_torch_train_kernels.py``.
"""

import numpy as np
import pytest
import torch

from cvvae_tpu_torch.ops.kernels import _build, shuffle
from cvvae_tpu_torch.utils import kernel_variants

#: (B, T, H, W, c, n, element bytes, SMs): the three training-path shapes
#: on an H100, and small ones with every kind of block (one pixel thread,
#: several, a tree over a non-power of two, chunks of c wider than a block)
CASES = [(1, 9, 128, 128, 256, 2, 4, 132), (1, 9, 128, 128, 256, 2, 2, 132),
         (1, 9, 64, 64, 512, 1, 4, 132), (1, 5, 32, 32, 512, 2, 2, 132),
         (2, 3, 5, 7, 16, 2, 4, 1), (1, 3, 5, 7, 24, 2, 2, 3),
         (1, 2, 4, 6, 20, 1, 4, 2), (1, 3, 2, 3, 2048, 2, 4, 1),
         (2, 2, 3, 5, 8, 2, 2, 132)]


def test_merge_constants_are_read_from_the_kernel_source():
    assert (shuffle.MERGE_CH, shuffle.MERGE_SPLIT) == _build.constants(
        "shuffle_bwd.cu", "kMergeCh", "kMergeSplit")


@pytest.mark.parametrize("b,t,h,w,c,n,elem,sms", CASES)
def test_bwd_plan_covers_each_row_and_slot_once(b, t, h, w, c, n, elem, sms):
    p = shuffle.bwd_plan(b, t, h, w, c, n, elem, sms)
    assert p["bx"] * p["by"] <= shuffle.THREADS and c % p["vec"] == 0
    assert p["rows"] == b * n * t * 2 * h
    rows = np.zeros(p["rows"], np.int64)
    for k in range(p["grid"]):
        mine = np.arange(k, p["rows"], p["grid"])
        assert 1 <= len(mine) <= p["rows_per_block"]
        rows[mine] += 1
    assert (rows == 1).all()
    # each thread's pixels of a row: x = ty, ty + by, ..., at most px
    pixels = np.zeros(2 * w, np.int64)
    for ty in range(p["by"]):
        mine = np.arange(ty, 2 * w, p["by"])
        assert len(mine) <= p["px"]
        pixels[mine] += 1
    assert (pixels == 1).all()
    # the merge: MERGE_SPLIT contiguous ranges of at most merge_per slots
    slots = np.zeros(p["grid"], np.int64)
    for y in range(shuffle.MERGE_SPLIT):
        slots[y * p["merge_per"]:min((y + 1) * p["merge_per"],
                                     p["grid"])] += 1
    assert (slots == 1).all()
    assert p["merge_blocks"] * shuffle.MERGE_CH >= n * c
    assert p["bias_adds"] == (p["px"] - 1 + p["rows_per_block"] - 1
                              + p["block_levels"] + 1)


def test_bwd_plan_merges_on_many_blocks_with_short_walks():
    """At the largest training shape no thread walks more than 29 slots
    (a merge of one thread a channel would walk 3,688 in fp32, 7,376 in
    bf16, on two blocks)."""
    for elem in (4, 2):
        p = shuffle.bwd_plan(1, 9, 128, 128, 256, 2, elem, 132)
        assert p["merge_blocks"] == 16 and p["merge_per"] <= 29


def _tree(vals, add):
    """The kernels' tree over a list: level h adds entry i + h into entry
    i for i < h, h from the power of two below len(vals) down to 1."""
    vals = list(vals)
    h = 1
    while h < len(vals):
        h <<= 1
    h >>= 1
    while h:
        for i in range(h):
            if i + h < len(vals):
                vals[i] = add(vals[i], vals[i + h])
        h >>= 1
    return vals[0]


def emulate_bias(dy, n, t, drop, plan):
    """d(bias) as csrc/shuffle_bwd.cu sums it on ``plan``: float32 for
    the threads' and blocks' sums, float64 for the merge."""
    b, _, h2, w2, c = dy.shape
    by = plan["by"]
    slots = np.zeros((plan["grid"], n, c), np.float32)
    for k in range(plan["grid"]):
        acc = np.zeros((by, 2, c), np.float32)
        for r in range(k, plan["rows"], plan["grid"]):
            bt, y = divmod(r, h2)
            bb, tau = divmod(bt, n * t)
            if tau < drop:
                continue
            row = dy[bb, tau - drop, y]
            for ty in range(by):
                s = np.zeros(c, np.float32)
                for x in range(ty, w2, by):
                    s = s + row[x]
                acc[ty, tau % n] = acc[ty, tau % n] + s
        slots[k] = _tree(acc, lambda a, b: (a + b).astype(np.float32))[:n]
    flat = slots.reshape(plan["grid"], n * c).astype(np.float64)
    per = plan["merge_per"]
    parts = []
    for y in range(shuffle.MERGE_SPLIT):
        s = np.zeros(n * c)
        for i in range(y * per, min((y + 1) * per, plan["grid"])):
            s = s + flat[i]
        parts.append(s)
    return _tree(parts, lambda a, b: a + b).astype(np.float32)


@pytest.mark.parametrize("b,t,h,w,c,n,drop,elem,sms", [
    (1, 3, 5, 7, 16, 2, 1, 4, 1), (2, 2, 4, 6, 24, 2, 0, 2, 3),
    (1, 3, 3, 9, 20, 1, 0, 4, 2), (1, 2, 2, 8, 512, 2, 1, 4, 132),
    (1, 2, 3, 5, 8, 2, 1, 2, 132)])
def test_emulated_bias_sum_stays_within_the_plans_bound(b, t, h, w, c, n,
                                                        drop, elem, sms):
    rng = np.random.RandomState(0)
    # an offset, so the partial sums grow and round
    dy = (rng.standard_normal((b, n * t - drop, 2 * h, 2 * w, c)) + 2.0
          ).astype(np.float32)
    plan = shuffle.bwd_plan(b, t, h, w, c, n, elem, sms)
    got = emulate_bias(dy, n, t, drop, plan).astype(np.float64)
    full = dy.astype(np.float64)
    if drop:
        full = np.concatenate([np.zeros_like(full[:, :1]), full], 1)
    full = full.reshape(b, t, n, 2 * h, 2 * w, c)
    want = full.sum(axis=(0, 1, 3, 4)).reshape(-1)
    mag = np.abs(full).sum(axis=(0, 1, 3, 4)).reshape(-1)
    tol = plan["bias_adds"] * 2.0 ** -24 * mag + 2.0 ** -24 * np.abs(want)
    assert (np.abs(got - want) <= tol).all()
    # the plain version's d(bias), a float32 sum in another order, agrees
    _, db = shuffle.subpixel_interleave_backward_plain(
        torch.from_numpy(dy), n=n, t=t, drop_first=bool(drop))
    assert np.abs(db.double().numpy() - want).max() <= tol.max()
    # the bound is far below one term (|dy| is about 2), so a slot or a
    # row left out of the sums breaks it
    assert tol.max() < 0.05



@pytest.mark.parametrize("variant", sorted(kernel_variants.K2_BWD_VARIANTS))
def test_k2_bwd_variants_apply_once(variant):
    """Each K2.bwd variant of ``utils/kernel_variants.py`` replaces text
    that ``csrc/shuffle_bwd.cu`` holds once."""
    text = (_build.CSRC / "shuffle_bwd.cu").read_text()
    for old, new in kernel_variants.K2_BWD_VARIANTS[variant]:
        assert text.count(old) == 1 and old != new
        text = text.replace(old, new)
