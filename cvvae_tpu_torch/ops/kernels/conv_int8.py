"""K5: int8 3-D conv with its dequantising epilogue — two hand-written CUDA
kernels, a staging pass and an s8 implicit GEMM, and their plain PyTorch
versions.

Replaces the int8 conv that ``cvvae_tpu/ops/quant.py`` leaves to XLA
(``conv3d_int8`` :256-269 and ``conv_int8`` :148-159; no Pallas kernel):
x quantized with ``scale_x`` (round half to even of x / scale_x, clipped
to ±127), edge pads taken on the int8 values, zero pads in the window,
s8·s8 summed in s32, then ``float(acc) * (scale_x * scale_w[o])`` (the
product in fp32), ``+ float(bias)``, cast to x's dtype.

The two steps follow the reference's (``csrc/conv_int8.cu``):

* :func:`stage` (K5.stage) quantizes x once and materialises every pad on
  the int8 tensor: a :class:`Staged` (B, T+pT, H+pH, W', Cp) tensor, Cp
  the channels rounded up to the 128-channel K chunk (zeros past Cin), W'
  rounded up to a multiple of the W stride (zeros past W + pW).  An int8
  x (an int8-resident activation, ``ops/qflow.py``) is padded only;
* :func:`gemm` (K5.gemm) is a zero-window int8 conv over a window of it:
  wgmma s8 on tiles that TMA loads, B (the kernel) packed once per module
  by :func:`pack_weight`.  It writes the staged activation's dtype, or
  the ``out_dtype`` the caller names, or, given ``out_scale`` (O,), int8
  requantized per output channel from the same fp32 value (the
  int8-resident mode of ``cvvae_tpu/ops/qflow.py:97-103``).

:func:`conv3d_int8` is the two in turn.  One staged tensor serves several
convs that read x with the same scale and pads of at most its own (the
four upsample phases, ``ops/upsample_conv.py``).

What bounds it on an H100: at the v1 encoder's level-0 causal conv
(17×720×1280, 128 → 128, 27 taps) the 13.9 TOP over the 1,979 TOP/s int8
peak, 7.0 ms; the staging pass alone is bytes-bound (4.0 GB read, 2.25 GB
written, 1.9 ms).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from cvvae_tpu_torch.ops.kernels import _build

#: launches of the GEMM kernel (the CPU path does not count)
launches = 0
#: launches of the staging kernel
stage_launches = 0
#: launches of the GEMM with an int8 output (also counted in ``launches``)
int8_out_launches = 0

#: from csrc/conv_int8.cu: output channels a tile, input channels a K
#: chunk, the widest kW and the largest W stride
BN, KC, MAX_KW, MAX_SW = _build.constants(
    "conv_int8.cu", "kBN", "kKC", "kMaxKW", "kMaxSW")


class Staged(NamedTuple):
    """An activation quantized and padded by :func:`stage`."""
    #: (B, T + pT, H + pH, W', Cp) int8
    xq: torch.Tensor
    #: the activation's (B, T, H, W, C)
    shape: tuple
    #: its pads ((lo, hi) for T, H, W) and their modes
    pads: tuple
    modes: tuple
    #: the activation's dtype, the convs' output dtype unless they name
    #: another (int8 for an int8 activation, whose convs must)
    dtype: torch.dtype


def out_extents(shape, kernel, stride, pads):
    """(T', H', W') of a conv of (B, T, H, W, C) ``shape``."""
    return tuple((n + lo + hi - k) // s + 1 for n, k, s, (lo, hi)
                 in zip(shape[1:4], kernel, stride, pads))


def channels_padded(cin: int) -> int:
    """Cin rounded up to the GEMM's K chunk."""
    return -(-cin // KC) * KC


def staged_shape(shape, pads, sw: int = 1) -> tuple:
    """The staged tensor's (B, T + pT, H + pH, W', Cp) for an activation
    of ``shape``, W' = W + pW rounded up to a multiple of ``sw``."""
    b, t, h, w, c = shape
    (t0, t1), (h0, h1), (w0, w1) = pads
    return (b, t + t0 + t1, h + h0 + h1, -(-(w + w0 + w1) // sw) * sw,
            channels_padded(c))


def _pad_axis(v, dim, lo, hi, mode):
    """``v`` padded along ``dim``: edge mode repeats the end values, zero
    mode adds zeros."""
    n = v.shape[dim]
    idx = torch.arange(-lo, n + hi, device=v.device)
    out = v.index_select(dim, idx.clamp(0, n - 1))
    if mode == "zero" and (lo or hi):
        keep = [1] * v.ndim
        keep[dim] = -1
        out = out * ((idx >= 0) & (idx < n)).view(keep).to(out.dtype)
    return out


def stage_plain(x: torch.Tensor, scale_x: torch.Tensor, pads, modes,
                sw: int = 1) -> torch.Tensor:
    """K5.stage in plain PyTorch: x quantized as
    ``quant.quantize_act_static`` does (an int8 x as it is), each axis
    padded in its mode on the int8 values, then zeros to the staged
    tensor's W' and Cp."""
    if x.dtype == torch.int8:
        xq = x
    else:
        sx = scale_x.to(device=x.device, dtype=torch.float32)
        xq = torch.clamp(torch.round(x.float() / sx), -127,
                         127).to(torch.int8)
    for axis, ((lo, hi), mode) in enumerate(zip(pads, modes)):
        xq = _pad_axis(xq, 1 + axis, lo, hi, mode)
    b, t, h, w, c = staged_shape(x.shape, pads, sw)
    out = torch.zeros((b, t, h, w, c), dtype=torch.int8, device=x.device)
    out[:, :, :, :xq.shape[3], :xq.shape[4]] = xq
    return out


def _valid_conv_plain(xp, weight_q, scale_w, scale_x, bias, stride,
                      dtype, out_scale=None) -> torch.Tensor:
    """The zero-window conv of a padded float (B, T, H, W, C) tensor of
    int8 values, and the fp32 epilogue.  The sum over (taps, channels) is
    one matmul a tap, added in float64.  Every partial sum of a tap's
    matmul is an integer of at most C * 127^2, so the matmul is exact in
    fp32 (on any order of summation) while that is below 2^24, i.e. up to
    1,040 channels, and is taken in float64 past that; the sum of the taps
    stays below 2^53.  ``F.conv3d`` in float64 would give the same, but on
    a CUDA tensor it lowers to an im2col whose buffer at the 720p shapes
    is tens of GB.  With ``out_scale`` (O,) the fp32 result is requantized
    per output channel (round half to even of y / out_scale[o], clipped to
    ±127) to int8."""
    kt, kh, kw = weight_q.shape[2:]
    to, ho, wo = out_extents(xp.shape, (kt, kh, kw), stride,
                             ((0, 0),) * 3)
    st, sh, sw = stride
    dev = xp.device
    exact = (torch.float32 if xp.shape[4] * 127 * 127 < 2 ** 24
             else torch.float64)
    xp = xp.to(exact)
    wd = weight_q.to(device=dev, dtype=exact)
    acc = None
    for dt in range(kt):
        for dh in range(kh):
            for dw in range(kw):
                v = xp[:, dt:dt + st * (to - 1) + 1:st,
                       dh:dh + sh * (ho - 1) + 1:sh,
                       dw:dw + sw * (wo - 1) + 1:sw]
                part = torch.matmul(v, wd[:, :, dt, dh, dw].t())
                acc = (part.double() if acc is None else acc.add_(part))
    sx = scale_x.to(device=dev, dtype=torch.float32)
    y = acc.float() * (sx * scale_w.to(device=dev, dtype=torch.float32))
    if bias is not None:
        y = y + bias.to(device=dev, dtype=torch.float32)
    if out_scale is not None:
        so = out_scale.to(device=dev, dtype=torch.float32)
        return torch.clamp(torch.round(y / so), -127, 127).to(
            torch.int8).contiguous()
    return y.to(dtype).contiguous()


def conv3d_int8_plain(x: torch.Tensor, weight_q: torch.Tensor,
                      scale_w: torch.Tensor, scale_x: torch.Tensor,
                      bias: Optional[torch.Tensor], stride, pads,
                      modes) -> torch.Tensor:
    """The int8 conv in plain PyTorch, its int32 accumulator exact.

    x is quantized as ``quant.quantize_act_static`` does; the edge pads
    are a replicate pad of the quantized values and the zero pads a zero
    pad, both in fp32 (``F.pad``); then the zero-window conv and the fp32
    epilogue of :func:`_valid_conv_plain`.  x (B,T,H,W,C) ->
    (B,T',H',W',O)."""
    import torch.nn.functional as F

    sx = scale_x.to(device=x.device, dtype=torch.float32)
    xq = torch.clamp(torch.round(x.float() / sx), -127, 127)
    xn = xq.permute(0, 4, 1, 2, 3)
    for mode in ("edge", "zero"):
        sel = [p if m == mode else (0, 0) for p, m in zip(pads, modes)]
        if any(lo or hi for lo, hi in sel):
            (t0, t1), (h0, h1), (w0, w1) = sel
            xn = F.pad(xn, (w0, w1, h0, h1, t0, t1),
                       mode="replicate" if mode == "edge" else "constant")
    return _valid_conv_plain(xn.permute(0, 2, 3, 4, 1), weight_q, scale_w,
                             scale_x, bias, stride, x.dtype)


def _window(staged: Staged, pads):
    """The origin in ``staged`` of a conv with ``pads`` (each side at most
    the staged pad, in its mode) and the padded extents it reads."""
    origin, extent = [], []
    for n, (lo, hi), (slo, shi) in zip(staged.shape[1:4], pads,
                                       staged.pads):
        if not (0 <= lo <= slo and 0 <= hi <= shi):
            raise ValueError(f"conv pads {pads} do not lie inside the "
                             f"staged pads {staged.pads}")
        origin.append(slo - lo)
        extent.append(n + lo + hi)
    return origin, extent


def gemm_plain(staged: Staged, weight_q: torch.Tensor, scale_w: torch.Tensor,
               scale_x: torch.Tensor, bias: Optional[torch.Tensor], stride,
               pads, out_dtype: Optional[torch.dtype] = None,
               out_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K5.gemm in plain PyTorch: the zero-window conv of the window of
    ``staged`` that a conv with ``pads`` reads, then the fp32 epilogue
    (``out_dtype`` and ``out_scale`` as :func:`gemm` takes them)."""
    dtype = _out_dtype(staged, out_dtype, out_scale)
    (t0, h0, w0), (nt, nh, nw) = _window(staged, pads)
    cin = staged.shape[4]
    xw = staged.xq[:, t0:t0 + nt, h0:h0 + nh, w0:w0 + nw, :cin]
    return _valid_conv_plain(xw, weight_q, scale_w, scale_x, bias, stride,
                             dtype, out_scale)


def _out_dtype(staged: Staged, out_dtype, out_scale) -> torch.dtype:
    """The GEMM's output dtype: int8 with ``out_scale``, else
    ``out_dtype``, else the staged activation's float dtype."""
    if out_scale is not None:
        if out_dtype not in (None, torch.int8):
            raise ValueError(f"int8_gemm: out_scale gives an int8 output, "
                             f"not {out_dtype}")
        return torch.int8
    dtype = out_dtype or staged.dtype
    if dtype not in _build.DTYPE_CODES:
        raise ValueError(f"int8_gemm: an output of {dtype} needs out_scale;"
                         f" name out_dtype (bfloat16 or float32) for a "
                         f"float output")
    return dtype


def pack_weight(weight_q: torch.Tensor) -> torch.Tensor:
    """(O, I, kT, kH, kW) int8 -> the GEMM's B, (O padded to BN, taps, I
    padded to KC) int8, taps in (dt, dh, dw) order, zeros in the
    padding."""
    o, i = weight_q.shape[:2]
    taps = weight_q.shape[2] * weight_q.shape[3] * weight_q.shape[4]
    out = torch.zeros((-(-o // BN) * BN, taps, channels_padded(i)),
                      dtype=torch.int8, device=weight_q.device)
    out[:o, :, :i] = weight_q.permute(0, 2, 3, 4, 1).reshape(o, taps, i)
    return out


def _check_conv(x_shape, weight_q, scale_w, scale_x, bias, stride, pads,
                modes):
    """Raise ValueError unless the kernels take this conv."""
    o = weight_q.shape[0]
    if (weight_q.dtype != torch.int8 or weight_q.ndim != 5
            or weight_q.shape[1] != x_shape[4] or tuple(scale_w.shape) != (o,)
            or (bias is not None and tuple(bias.shape) != (o,))
            or scale_x.numel() != 1
            or any(p < 0 for pad in pads for p in pad)
            or any(m not in ("zero", "edge") for m in modes)
            or min(stride) < 1 or weight_q.shape[4] > MAX_KW
            or stride[2] > MAX_SW):
        raise ValueError(f"conv3d_int8: unsupported conv (x {tuple(x_shape)}, "
                         f"weight {tuple(weight_q.shape)} {weight_q.dtype}, "
                         f"stride {stride}, pads {pads}, modes {modes})")
    if min(out_extents(x_shape, weight_q.shape[2:], stride, pads)) < 1:
        raise ValueError(f"conv3d_int8: bad output extent for "
                         f"{tuple(x_shape)}")


def stage(x: torch.Tensor, scale_x: Optional[torch.Tensor], pads, modes,
          sw: int = 1) -> Staged:
    """x (B, T, H, W, C) bf16 or fp32 quantized with ``scale_x``, or int8
    as it is (``scale_x`` unused, may be None), and padded by ``pads`` in
    ``modes``, W' rounded up to a multiple of ``sw`` (the W stride of the
    convs that read it).  A CPU tensor takes the plain version; a CUDA
    tensor launches K5.stage or raises."""
    global stage_launches
    pads = tuple(tuple(p) for p in pads)
    modes = tuple(modes)
    if x.device.type == "cpu":
        return Staged(stage_plain(x, scale_x, pads, modes, sw),
                      tuple(x.shape), pads, modes, x.dtype)
    resident = x.dtype == torch.int8
    _build.refuse_gradient("int8_stage (K5.stage)", "none: int8 is "
                           "inference-only", x, scale_x)
    if resident:
        if not (x.is_cuda and x.ndim == 5 and x.is_contiguous()):
            raise ValueError(f"int8_stage: expected a contiguous 5-D CUDA "
                             f"tensor, got {tuple(x.shape)} on {x.device}")
    else:
        _build.require_cuda_layout("int8_stage", x, 5)
    if (any(p < 0 for pad in pads for p in pad) or sw < 1
            or any(m not in ("zero", "edge") for m in modes)
            or (not resident and scale_x.numel() != 1)):
        raise ValueError(f"int8_stage: unsupported pads {pads} {modes}, "
                         f"sw {sw}")
    b, t, h, w, cin = x.shape
    shape = staged_shape(x.shape, pads, sw)
    xq = torch.empty(shape, dtype=torch.int8, device=x.device)
    sx32 = (None if resident else scale_x.to(
        device=x.device, dtype=torch.float32).reshape(1))
    vec = int((cin * x.element_size()) % 16 == 0 and x.data_ptr() % 16 == 0)
    (t0, _), (h0, _), (w0, w1) = pads
    rc = _build.library().cvvae_int8_stage(
        x.data_ptr(), None if sx32 is None else sx32.data_ptr(),
        xq.data_ptr(), b, t, h, w, cin, shape[4], shape[1], shape[2],
        shape[3], w + w0 + w1, t0, h0, w0,
        *(int(m == "edge") for m in modes), vec,
        _build.INT8_CODE if resident else _build.DTYPE_CODES[x.dtype],
        x.device.index or 0, _build.stream_of(x))
    _build.check(rc, "int8_stage")
    stage_launches += 1
    return Staged(xq, tuple(x.shape), pads, modes, x.dtype)


def gemm(staged: Staged, weight_q: torch.Tensor, scale_w: torch.Tensor,
         scale_x: torch.Tensor, bias: Optional[torch.Tensor], stride, pads,
         wpk: Optional[torch.Tensor] = None, *,
         out_dtype: Optional[torch.dtype] = None,
         out_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The int8 conv with ``pads`` (each side at most the staged pad, in
    its mode) over ``staged``: (B, T', H', W', O) in ``out_dtype`` (by
    default the staged activation's dtype, which an int8 activation's
    convs must name), or, given ``out_scale`` (O,) fp32 (or a scalar),
    int8 requantized per output channel.  ``wpk`` is
    ``pack_weight(weight_q)`` where the caller keeps it.  A CPU tensor
    takes the plain version; a CUDA tensor launches K5.gemm or raises."""
    global launches, int8_out_launches
    if staged.xq.device.type == "cpu":
        return gemm_plain(staged, weight_q, scale_w, scale_x, bias, stride,
                          pads, out_dtype, out_scale)
    _build.refuse_gradient("int8_gemm (K5)", "none: int8 is inference-only",
                           scale_w, scale_x, bias)
    dtype = _out_dtype(staged, out_dtype, out_scale)
    _check_conv(staged.shape, weight_q, scale_w, scale_x, bias, stride, pads,
                staged.modes)
    (t0, h0, w0), _ = _window(staged, pads)
    xq = staged.xq
    if xq.shape[3] % stride[2]:
        raise ValueError(f"int8_gemm: staged W {xq.shape[3]} is not a "
                         f"multiple of the W stride {stride[2]}")
    b = staged.shape[0]
    o = weight_q.shape[0]
    kt, kh, kw = weight_q.shape[2:]
    to, ho, wo = out_extents(staged.shape, (kt, kh, kw), stride, pads)
    dev = xq.device
    if wpk is None:
        wpk = pack_weight(weight_q.to(dev))
    if tuple(wpk.shape) != (-(-o // BN) * BN, kt * kh * kw, xq.shape[4]):
        raise ValueError(f"int8_gemm: packed weight {tuple(wpk.shape)} does "
                         f"not fit {tuple(weight_q.shape)}")
    sw32 = scale_w.to(device=dev, dtype=torch.float32).contiguous()
    sx32 = scale_x.to(device=dev, dtype=torch.float32).reshape(1).contiguous()
    b32 = (None if bias is None
           else bias.to(device=dev, dtype=torch.float32).contiguous())
    so32 = None
    if out_scale is not None:
        if out_scale.numel() not in (1, o):
            raise ValueError(f"int8_gemm: out_scale {tuple(out_scale.shape)}"
                             f" for {o} output channels")
        so32 = out_scale.to(device=dev, dtype=torch.float32).reshape(
            -1).expand(o).contiguous()
    y = torch.empty((b, to, ho, wo, o), device=dev, dtype=dtype)
    rc = _build.library().cvvae_int8_gemm(
        xq.data_ptr(), wpk.data_ptr(), sx32.data_ptr(), sw32.data_ptr(),
        None if b32 is None else b32.data_ptr(),
        None if so32 is None else so32.data_ptr(), y.data_ptr(), b,
        *xq.shape[1:], o, wpk.shape[0], kt, kh, kw, *stride, t0, h0, w0, to,
        ho, wo, _build.INT8_CODE if so32 is not None
        else _build.DTYPE_CODES[dtype], dev.index or 0,
        _build.stream_of(xq))
    _build.check(rc, "int8_gemm")
    launches += 1
    int8_out_launches += so32 is not None
    return y


def conv3d_int8(x: torch.Tensor, weight_q: torch.Tensor,
                scale_w: torch.Tensor, scale_x: torch.Tensor,
                bias: Optional[torch.Tensor], stride, pads, modes,
                wpk: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The int8 conv of a contiguous (B, T, H, W, C) bf16 or fp32 tensor:
    ``weight_q`` (O, C, kT, kH, kW) int8, ``scale_w`` (O,) fp32,
    ``scale_x`` an fp32 scalar tensor, ``bias`` (O,) or None, per-axis
    ``stride``, ``pads`` ((lo, hi) each, >= 0) and ``modes`` ("zero" or
    "edge"); ``wpk`` the packed weight where the caller keeps it.
    Returns (B, T', H', W', O) in x's dtype.

    A CPU tensor takes the plain version; a CUDA tensor launches K5.stage
    then K5.gemm, or raises."""
    if x.device.type == "cpu":
        return conv3d_int8_plain(x, weight_q, scale_w, scale_x, bias, stride,
                                 pads, modes)
    _build.refuse_gradient("conv3d_int8 (K5)", "none: int8 is "
                           "inference-only", x, scale_w, scale_x, bias)
    _build.require_cuda_layout("conv3d_int8", x, 5)
    _check_conv(x.shape, weight_q, scale_w, scale_x, bias, stride, pads,
                modes)
    staged = stage(x, scale_x, pads, modes, stride[2])
    return gemm(staged, weight_q, scale_w, scale_x, bias, stride, pads, wpk)


def conv3d_int8_resident_plain(xq: torch.Tensor, weight_q: torch.Tensor,
                               scale_w: torch.Tensor, scale_x: torch.Tensor,
                               bias: Optional[torch.Tensor], stride, pads,
                               modes, out_dtype: Optional[torch.dtype] = None,
                               out_scale: Optional[torch.Tensor] = None
                               ) -> torch.Tensor:
    """The int8-resident conv in plain PyTorch: ``xq``'s pads taken on its
    int8 values (:func:`stage_plain`), then :func:`gemm_plain`'s
    zero-window conv and epilogue, to ``out_dtype`` or int8 at
    ``out_scale``."""
    pads = tuple(tuple(p) for p in pads)
    staged = Staged(stage_plain(xq, None, pads, modes, stride[2]),
                    tuple(xq.shape), pads, tuple(modes), torch.int8)
    return gemm_plain(staged, weight_q, scale_w, scale_x, bias, stride, pads,
                      out_dtype, out_scale)


def conv3d_int8_resident(xq: torch.Tensor, weight_q: torch.Tensor,
                         scale_w: torch.Tensor, scale_x: torch.Tensor,
                         bias: Optional[torch.Tensor], stride, pads, modes,
                         wpk: Optional[torch.Tensor] = None, *,
                         out_dtype: Optional[torch.dtype] = None,
                         out_scale: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """The int8 conv of an int8-resident (B, T, H, W, C) ``xq`` at the
    scalar ``scale_x`` (``cvvae_tpu/ops/qflow.py:79-103``): K5.stage pads
    the int8 values, K5.gemm writes ``out_dtype`` (bf16 or fp32) or, given
    ``out_scale`` (O,), int8 requantized per output channel.  A CPU
    tensor takes the plain version; a CUDA tensor launches both kernels or
    raises."""
    if xq.device.type == "cpu":
        return conv3d_int8_resident_plain(xq, weight_q, scale_w, scale_x,
                                          bias, stride, pads, modes,
                                          out_dtype, out_scale)
    staged = stage(xq, None, pads, modes, stride[2])
    return gemm(staged, weight_q, scale_w, scale_x, bias, stride, pads, wpk,
                out_dtype=out_dtype, out_scale=out_scale)
