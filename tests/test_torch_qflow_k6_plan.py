"""K6's residual add on the CPU (no card, no JAX): the host's choice of
path (``ops/kernels/qflow.add_plan``), the sliced path's fixed channel
slices, its int8-to-float conversion and its packing of codes, each
replayed in numpy as ``csrc/qflow.cu`` computes them.

* Where C is a multiple of 16, the sliced path, on a grid whose stride of
  16 values a thread is a multiple of C: a thread's channel base is the
  same on every grid-stride pass, for every thread, at C 16, 48, 128,
  256 and 512; channels off 16 take the general path.
* The byte permute that makes a float of an int8 value (the biased byte
  into the mantissa of 2^23, less 2^23 + 128) gives every one of the 256
  codes exactly, from each of the four bytes of a word.
* The codes' packing puts each value's code in its own byte.
"""

import numpy as np
import pytest

from cvvae_tpu_torch.ops.kernels import _build
from cvvae_tpu_torch.ops.kernels import qflow as k6

SOURCE = (_build.CSRC / "qflow.cu").read_text()

#: (N values, C): the chain's two shapes, small and ragged tensors
SLICED = [(17 * 720 * 672 * 128, 128), (17 * 360 * 336 * 256, 256),
          (17 * 180 * 168 * 512, 512), (2 * 3 * 5 * 7 * 16, 16),
          (3 * 5 * 48, 48), (5 * 60 * 61 * 128, 128), (2 * 5 * 30 * 31 * 256,
                                                      256),
          (5 * 30 * 31 * 512, 512), (2 * 3 * 512, 512), (4099 * 16 * 3, 4099
                                                         * 16)]
GENERAL = [(2 * 3 * 5 * 7 * 24, 24), (3 * 5 * 7, 7), (17 * 720 * 3584 * 24,
                                                     24), (6 * 40, 40),
           (9 * 8, 8)]


@pytest.mark.parametrize("n,c", SLICED)
def test_sliced_path_keeps_each_threads_channels(n, c):
    """The stride is a multiple of C, so thread t's groups t + k stride
    all start at channel 16 t mod C (replayed for every thread of a small
    grid, and the first and last 4096 of a large one)."""
    plan = k6.add_plan(n, c)
    assert plan["path"] == "sliced"
    blocks, threads = plan["blocks"], k6.ADD_THREADS
    stride = blocks * threads
    assert (16 * stride) % c == 0
    assert blocks * threads <= 2 ** 31 - 1
    groups = n // 16
    # about ADD_BLOCKS an SM, no more than the groups fill, rounded up
    step = c // np.gcd(c, 16 * threads)
    assert blocks % step == 0
    assert blocks < max(k6.SMS * k6.ADD_BLOCKS, -(-groups // threads)) + step
    t = np.arange(stride, dtype=np.int64)
    if stride > 8192:
        t = np.concatenate([t[:4096], t[-4096:]])
    base = (16 * t) % c
    passes = -(-groups // stride)
    for k in range(passes):
        g = t + k * stride
        live = g < groups
        assert np.array_equal(((16 * g) % c)[live], base[live])
    # the entry refuses a sliced launch whose stride is not a multiple of C
    assert "(16 * (int64_t)kThreads * blocks) % C" in SOURCE


@pytest.mark.parametrize("n,c", GENERAL)
def test_channels_off_16_take_the_general_path(n, c):
    assert k6.add_plan(n, c) == dict(path="general", blocks=0)


def byte_perm(x: int, y: int, s: int) -> int:
    """CUDA's ``__byte_perm(x, y, s)``: byte n of the result is byte
    (nibble n of s) of the 8 bytes y:x (x bytes 0-3, y bytes 4-7)."""
    src = [(x >> (8 * i)) & 0xFF for i in range(4)] + [
        (y >> (8 * i)) & 0xFF for i in range(4)]
    return sum(src[(s >> (4 * n)) & 0x7] << (8 * n) for n in range(4))


def test_byte_to_float_is_exact_for_every_code():
    """``biased_to_f32``: for each int8 code q at byte j of a word, the
    float of byte_perm(w ^ 0x80808080, 0x4B000000, 0x7540 + j), less 2^23
    + 128, is q, whatever the word's other bytes."""
    for text in ("0x80808080u", "0x4B000000u", "0x7540 + j", "8388736.f"):
        assert text in SOURCE, text
    assert 8388736 == 2 ** 23 + 128
    rng = np.random.RandomState(0)
    for q in range(-128, 128):
        for j in range(4):
            other = int(rng.randint(0, 2 ** 32, dtype=np.uint64))
            w = (other & ~(0xFF << (8 * j))) | ((q & 0xFF) << (8 * j))
            bits = byte_perm(w ^ 0x80808080, 0x4B000000, 0x7540 + j)
            f = np.array([bits], np.uint32).view(np.float32)[0]
            got = np.float32(f) - np.float32(8388736.0)
            assert got == np.float32(q), (q, j, got)


def test_codes_pack_in_channel_order():
    """``pack4``: the low bytes of four words, in order, as one word."""
    rng = np.random.RandomState(1)
    for _ in range(64):
        m = [int(v) for v in rng.randint(0, 2 ** 32, 4, dtype=np.uint64)]
        got = byte_perm(byte_perm(m[0], m[1], 0x0040),
                        byte_perm(m[2], m[3], 0x0040), 0x5410)
        assert got == sum((m[i] & 0xFF) << (8 * i) for i in range(4))
    assert "__byte_perm(m[0], m[1], 0x0040)" in SOURCE
    assert "__byte_perm(m[2], m[3], 0x0040), 0x5410)" in SOURCE
