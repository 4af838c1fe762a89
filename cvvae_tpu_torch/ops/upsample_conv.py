"""Fused nearest-2x-upsample + 3x3 conv via subpixel phase decomposition.

Port of ``cvvae_tpu/ops/upsample_conv.py`` (float path).  Nearest 2x
duplicates pixels, so each output phase (parity of the output row and
column) sees only two distinct source pixels per axis:

    y[2i]   = w0 * x[i-1] + (w1 + w2) * x[i]
    y[2i+1] = (w0 + w1) * x[i] + w2 * x[i+1]

The op is four (kT, 2, 2) convs on the original tensor, interleaved
subpixel-style; the interleave, the bias add and the (n c) channel->time
split are one pass, which on a CUDA tensor is the hand-written kernel K2
(``ops/kernels/shuffle.py``).

Quantized params (``weight_q``, ``scale_w``) take the reference's int8
branch: the phase kernels are summed from the dequantized kernel in fp32,
quantized again per channel (once per module, kept as non-persistent
buffers), and run as four int8 convs (K5 on a CUDA tensor) over one
staged tensor: x quantized once with its H and W padded by one on each
side, each phase reading its window of it.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F

from cvvae_tpu_torch.ops import quant
from cvvae_tpu_torch.ops.kernels import conv_int8 as k5
from cvvae_tpu_torch.ops.kernels.shuffle import subpixel_interleave
from cvvae_tpu_torch.parallel import shard
from cvvae_tpu_torch.utils import spans

_CORNERS = (("even", "even"), ("even", "odd"), ("odd", "even"), ("odd", "odd"))


def _phase_kernels(w: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """w: (O, I, kT, 3, 3) -> four (O, I, kT, 2, 2) phase kernels, ordered
    (h_even, w_even), (h_even, w_odd), (h_odd, w_even), (h_odd, w_odd)."""
    h_even = torch.cat([w[:, :, :, 0:1], w[:, :, :, 1:2] + w[:, :, :, 2:3]], 3)
    h_odd = torch.cat([w[:, :, :, 0:1] + w[:, :, :, 1:2], w[:, :, :, 2:3]], 3)
    out = []
    for wh in (h_even, h_odd):
        w_even = torch.cat([wh[..., 0:1], wh[..., 1:2] + wh[..., 2:3]], 4)
        w_odd = torch.cat([wh[..., 0:1] + wh[..., 1:2], wh[..., 2:3]], 4)
        out.extend([w_even, w_odd])
    return tuple(out)


def upsample2x_conv3x3_interleave(x: torch.Tensor, params, *, n: int,
                                  t_pad: Tuple[int, int], t_mode: str,
                                  hw_mode: str = "zero",
                                  drop_first: bool = True) -> torch.Tensor:
    """``temporal_interleave(conv3d(nearest_2x_hw(x)), n)`` in one pass.

    x: (B,T,H,W,C) -> (B, n*T' - drop_first, 2H, 2W, C_out/n); ``params``
    holds ``weight`` (n*c, C, kT, 3, 3), or ``weight_q`` and ``scale_w``,
    and ``bias`` (n*c,) or None.

    In a net call split over a mesh (``parallel/shard.py``): along H, the
    phase convs read one halo row from each neighbour and pad (zeros, or
    SD3's replicate) only at the global ends; along T, the time window
    reads its halo frames and pads at the global ends, and only the rank
    that holds frame 0 drops the first output frame, so v1's decode keeps
    its 4T'-3 frames.  K2 stays local: each input row and frame maps to
    its own output rows and frames."""
    with spans.span("cvvae.op.upsample_conv"):
        ctx = shard.current()
        kt = (params.weight_q if quant.is_quantized(params)
              else params.weight).shape[2]
        extents = x.shape[1:4]
        h_ends = None      # the H rows to pad at the global ends, when split
        if ctx is not None:
            extents, sizes = ctx.extents(x), ctx.sizes(x)
            if ctx.dim == 1:
                first = ctx.first(x)
                x, t_pad, out = ctx.window(x, kt, 1, *t_pad)
                out_sizes = [n * o - (n > 1 and drop_first and r == 0)
                             for r, o in enumerate(out)]
                drop_first = drop_first and first
            else:
                x, h_ends, _ = ctx.window(x, 3, 1, 1, 1)
                out_sizes = [2 * o for o in sizes]
        y = _upsample(x, params, n, tuple(t_pad), t_mode, hw_mode,
                      drop_first, extents, h_ends)
        if ctx is not None:
            ctx.register(y, out_sizes)
        return y


def _upsample(x, params, n, t_pad, t_mode, hw_mode, drop_first, extents,
              h_ends):
    """The op on ``x`` (a haloed slab where split, its H pads ``h_ends``
    at the global ends), the int8 dispatch on the global ``extents``."""
    if quant.is_quantized(params):
        quant.maybe_record_act(params, x)
        if math.prod(extents) >= quant.INT8_MIN_POSITIONS:
            phases = _int8_phases(x, params, t_pad, t_mode, hw_mode, h_ends)
            return subpixel_interleave(phases, params.bias, n=n,
                                       drop_first=drop_first)
        kernel = quant.dequantize_kernel(params).to(x.dtype)
    else:
        kernel = params.weight.to(x.dtype)
    xn = x.permute(0, 4, 1, 2, 3)
    if t_mode == "edge" and (t_pad[0] or t_pad[1]):
        xn = F.pad(xn, (0, 0, 0, 0) + tuple(t_pad), mode="replicate")
        t_zero = (0, 0)
    else:
        t_zero = tuple(t_pad)
    # an axis whose one-row pads are materialised (edge mode, or H split
    # over a mesh: the halo rows, and the pads at the global ends) reads
    # through cropping windows; a zero-mode axis pads in the window
    crop = {"even": (0, -1), "odd": (-1, 0)}
    window = {"even": (1, 0), "odd": (0, 1)}
    edge = hw_mode == "edge"
    h_mat = (1, 1) if edge and h_ends is None else (h_ends or (0, 0))
    w_mat = (1, 1) if edge else (0, 0)
    if any(h_mat + w_mat):
        xn = F.pad(xn, w_mat + tuple(h_mat) + (0, 0),
                   mode="replicate" if edge else "constant")
    hpads = crop if (edge or h_ends is not None) else window
    wpads = crop if edge else window

    ks = _phase_kernels(kernel)
    phases = []
    for k, (hp, wp) in zip(ks, _CORNERS):
        xp = F.pad(xn, wpads[wp] + hpads[hp] + t_zero)
        xp = xp.contiguous(memory_format=torch.channels_last_3d)
        y = F.conv3d(xp, k)
        phases.append(y.permute(0, 2, 3, 4, 1).contiguous())
    return subpixel_interleave(phases, params.bias, n=n, drop_first=drop_first)


def _phase_weights(params):
    """The four phase kernels of quantized ``params`` as K5 takes them:
    (int8 kernels (4, O, I, kT, 2, 2), their scales (4, O), and on the card
    their packed form, else None).  The phase sums are taken in fp32 from
    the dequantized kernel, as the reference takes them, then quantized
    per channel; kept as non-persistent buffers while the int8 kernel
    stays the same (``quant.derived``)."""
    def quantized(i):
        return torch.stack([quant.quantize_kernel(k)[i] for k in
                            _phase_kernels(quant.dequantize_kernel(params))])

    wq = quant.derived(params, "k5_phase_wq", lambda: quantized(0))
    sw = quant.derived(params, "k5_phase_sw", lambda: quantized(1))
    wpk = None
    if wq.device.type != "cpu":
        wpk = quant.derived(params, "k5_phase_wpk", lambda: torch.stack(
            [k5.pack_weight(k) for k in wq]))
    return wq, sw, wpk


def _int8_phases(x: torch.Tensor, params, t_pad: Tuple[int, int],
                 t_mode: str, hw_mode: str, h_ends=None):
    """The four phases of the int8 branch, (B,T',H,W,n*c) each in x's
    dtype, without the bias.  The reference materialises the edge pads
    (time ``t_pad``; H/W by one, read through (0,-1)/(-1,0) windows) and
    runs each phase with its (1,0)/(0,1) H/W pads; here x is quantized
    and padded once, time by ``t_pad`` and H/W by (1,1) in ``hw_mode``
    (K5.stage), and each phase reads its window of that.  Where H is
    split over a mesh, ``x`` is this rank's slab with one halo row on each
    interior side and ``h_ends`` its pads at the global ends: staged, it
    holds the same rows as a (1,1)-padded run, and is read as one."""
    scale_x = getattr(params, "scale_x", None)
    if scale_x is None:
        scale_x = quant.act_scale(x)
    wq, sw, wpk = _phase_weights(params)
    h_pad = (1, 1) if h_ends is None else tuple(h_ends)
    staged = k5.stage(x, scale_x, (tuple(t_pad), h_pad, (1, 1)),
                      (t_mode, hw_mode, hw_mode))
    if h_ends is not None:
        b, t, h, w, c = staged.shape
        halo = 2 - h_pad[0] - h_pad[1]
        staged = staged._replace(shape=(b, t, h - halo, w, c),
                                 pads=(staged.pads[0], (1, 1),
                                       staged.pads[2]))
    pads = {"even": (1, 0), "odd": (0, 1)}
    return [k5.gemm(staged, wq[i], sw[i], scale_x, None, (1, 1, 1),
                    (tuple(t_pad), pads[hp], pads[wp]),
                    None if wpk is None else wpk[i])
            for i, (hp, wp) in enumerate(_CORNERS)]
