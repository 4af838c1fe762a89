"""K5: int8 3-D conv with its dequantising epilogue — hand-written CUDA
kernel and its plain PyTorch version.

Replaces the int8 conv that ``cvvae_tpu/ops/quant.py`` leaves to XLA
(``conv3d_int8`` :256-269 and ``conv_int8`` :148-159; no Pallas kernel):
x quantized with ``scale_x`` (round half to even of x / scale_x, clipped
to ±127), edge pads taken on the int8 values, zero pads in the window,
s8·s8 summed in s32, then ``float(acc) * (scale_x * scale_w[o])`` (the
product in fp32), ``+ float(bias)``, cast to x's dtype.

What bounds it on an H100: at the v1 encoder's level-0 causal conv
(17×720×1280, 128 → 128, 27 taps) the 13.9 TOP over the 1,979 TOP/s int8
peak, 7.0 ms, against 2.4 ms of bytes.  The design (``csrc/conv_int8.cu``)
is simple first: an implicit GEMM on ``mma.sync`` m16n8k32 s8 tiles, a
block of 128 output pixels along one output row × 128 channels, the input
row segment that a slab's kW taps share quantized once into shared memory
as it is loaded (the bf16 tensor is never written back as int8), the edge
pads clamped and the zero pads masked in the addressing, 64-bit offsets,
and an epilogue that rounds the product and the bias add apart (no FMA),
so it is bit-equal to the plain version.
"""

from __future__ import annotations

from typing import Optional

import torch

from cvvae_tpu_torch.ops.kernels import _build

#: launches of the CUDA kernel (the CPU path does not count)
launches = 0

#: from csrc/conv_int8.cu: output pixels and channels a block, input
#: channels a slab, the A slab's most rows, the widest kW
BM, BN, BK, MAX_SLAB_ROWS, MAX_KW = _build.constants(
    "conv_int8.cu", "kBM", "kBN", "kBK", "kMaxSlabRows", "kMaxKW")


def out_extents(shape, kernel, stride, pads):
    """(T', H', W') of a conv of (B, T, H, W, C) ``shape``."""
    return tuple((n + lo + hi - k) // s + 1 for n, k, s, (lo, hi)
                 in zip(shape[1:4], kernel, stride, pads))


def conv3d_int8_plain(x: torch.Tensor, weight_q: torch.Tensor,
                      scale_w: torch.Tensor, scale_x: torch.Tensor,
                      bias: Optional[torch.Tensor], stride, pads,
                      modes) -> torch.Tensor:
    """The int8 conv in plain PyTorch, its int32 accumulator exact.

    x is quantized as ``quant.quantize_act_static`` does; the edge pads
    are a replicate pad of the quantized values and the zero pads a zero
    pad, both in float64; the sum over (taps, channels) is one float64
    matmul a tap, added in float64 (every partial sum is an integer below
    2^53, so exact).  ``F.conv3d`` in float64 would give the same, but on
    a CUDA tensor it lowers to an im2col whose buffer at the 720p shapes
    is tens of GB.  Then the fp32 epilogue: float(acc) * (scale_x *
    scale_w), + float(bias), cast to x's dtype.  x (B,T,H,W,C) ->
    (B,T',H',W',O)."""
    import torch.nn.functional as F

    sx = scale_x.to(device=x.device, dtype=torch.float32)
    xq = torch.clamp(torch.round(x.float() / sx), -127, 127).double()
    xn = xq.permute(0, 4, 1, 2, 3)
    for mode in ("edge", "zero"):
        sel = [p if m == mode else (0, 0) for p, m in zip(pads, modes)]
        if any(lo or hi for lo, hi in sel):
            (t0, t1), (h0, h1), (w0, w1) = sel
            xn = F.pad(xn, (w0, w1, h0, h1, t0, t1),
                       mode="replicate" if mode == "edge" else "constant")
    xp = xn.permute(0, 2, 3, 4, 1)
    kt, kh, kw = weight_q.shape[2:]
    to, ho, wo = out_extents(x.shape, (kt, kh, kw), stride, pads)
    st, sh, sw = stride
    wd = weight_q.to(device=x.device, dtype=torch.float64)
    acc = None
    for dt in range(kt):
        for dh in range(kh):
            for dw in range(kw):
                v = xp[:, dt:dt + st * (to - 1) + 1:st,
                       dh:dh + sh * (ho - 1) + 1:sh,
                       dw:dw + sw * (wo - 1) + 1:sw]
                part = torch.matmul(v, wd[:, :, dt, dh, dw].t())
                acc = part if acc is None else acc.add_(part)
    y = acc.float() * (sx * scale_w.to(device=x.device, dtype=torch.float32))
    if bias is not None:
        y = y + bias.to(device=x.device, dtype=torch.float32)
    return y.to(x.dtype).contiguous()


def pack_weight(weight_q: torch.Tensor) -> torch.Tensor:
    """(O, I, kT, kH, kW) int8 -> the kernel's B, (O padded to BN, taps,
    I padded to BK) int8, zeros in the padding."""
    o, i = weight_q.shape[:2]
    taps = weight_q.shape[2] * weight_q.shape[3] * weight_q.shape[4]
    out = torch.zeros((-(-o // BN) * BN, taps, -(-i // BK) * BK),
                      dtype=torch.int8, device=weight_q.device)
    out[:o, :, :i] = weight_q.permute(0, 2, 3, 4, 1).reshape(o, taps, i)
    return out


def conv3d_int8(x: torch.Tensor, weight_q: torch.Tensor,
                scale_w: torch.Tensor, scale_x: torch.Tensor,
                bias: Optional[torch.Tensor], stride, pads,
                modes) -> torch.Tensor:
    """The int8 conv of a contiguous (B, T, H, W, C) bf16 or fp32 tensor:
    ``weight_q`` (O, C, kT, kH, kW) int8, ``scale_w`` (O,) fp32,
    ``scale_x`` an fp32 scalar tensor, ``bias`` (O,) or None, per-axis
    ``stride``, ``pads`` ((lo, hi) each, >= 0) and ``modes`` ("zero" or
    "edge").  Returns (B, T', H', W', O) in x's dtype.

    A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel or raises."""
    global launches
    if x.device.type == "cpu":
        return conv3d_int8_plain(x, weight_q, scale_w, scale_x, bias, stride,
                                 pads, modes)
    _build.require_cuda_layout("conv3d_int8", x, 5)
    b, t, h, w, cin = x.shape
    o = weight_q.shape[0]
    kt, kh, kw = weight_q.shape[2:]
    if (weight_q.dtype != torch.int8 or weight_q.ndim != 5
            or weight_q.shape[1] != cin or tuple(scale_w.shape) != (o,)
            or (bias is not None and tuple(bias.shape) != (o,))
            or scale_x.numel() != 1
            or any(p < 0 for pad in pads for p in pad)
            or any(m not in ("zero", "edge") for m in modes)
            or min(stride) < 1 or kw > MAX_KW
            or (BM - 1) * stride[2] + kw > MAX_SLAB_ROWS):
        raise ValueError(f"conv3d_int8: unsupported conv (x {tuple(x.shape)}, "
                         f"weight {tuple(weight_q.shape)} {weight_q.dtype}, "
                         f"stride {stride}, pads {pads}, modes {modes})")
    to, ho, wo = out_extents(x.shape, (kt, kh, kw), stride, pads)
    if min(to, ho, wo) < 1:
        raise ValueError(f"conv3d_int8: bad output extent for {tuple(x.shape)}")
    if b * to * ho * -(-wo // BM) >= 2 ** 31:
        raise ValueError("conv3d_int8: too many blocks for a 32-bit grid")
    dev = x.device
    wpk = pack_weight(weight_q.to(dev))
    sw32 = scale_w.to(device=dev, dtype=torch.float32).contiguous()
    sx32 = scale_x.to(device=dev, dtype=torch.float32).reshape(1).contiguous()
    b32 = (None if bias is None
           else bias.to(device=dev, dtype=torch.float32).contiguous())
    y = torch.empty((b, to, ho, wo, o), device=dev, dtype=x.dtype)
    vec = int((cin * x.element_size()) % 16 == 0 and x.data_ptr() % 16 == 0)
    edge = [int(m == "edge") for m in modes]
    rc = _build.library().cvvae_conv3d_int8(
        x.data_ptr(), wpk.data_ptr(), sx32.data_ptr(), sw32.data_ptr(),
        None if b32 is None else b32.data_ptr(), y.data_ptr(), b, t, h, w,
        cin, wpk.shape[2], o, kt, kh, kw, *stride, *(lo for lo, _ in pads),
        *edge, to, ho, wo, vec, _build.DTYPE_CODES[x.dtype],
        dev.index or 0, _build.stream_of(x))
    _build.check(rc, "conv3d_int8")
    launches += 1
    return y
