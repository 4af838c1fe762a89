"""3D convolution with the exact padding semantics of CV-VAE.

Port of ``cvvae_tpu/ops/conv.py``.  Public tensors are channels-last
(B, T, H, W, C); weights are torch's (O, I, kT, kH, kW).  A conv sees the
same bytes as a logical NCDHW tensor in ``torch.channels_last_3d``
memory, so the permutes around ``F.conv3d`` are free.  On a CUDA tensor a
3×3×3 stride-1 conv from 3 channels (the encoder's ``conv_in``) runs the
hand-written kernel K3 (``ops/kernels/stem.py``).

Edge ("replicate") pads are never materialised on the input.  A causal
conv (edge time, zero space, T > 1) runs a zero time window plus
per-frame boundary fixes (``_conv3d_edge_time_fast``), as the reference
dispatches it; every other edge pad runs zero windows plus thin-slab
fixes on all its edge axes (``_conv3d_edge_fast``).  Zero pads go to
cuDNN's window (``_window_conv``).  ``_edge_pad``, the materialised pad,
pads only the thin slabs, and is the reference ``chip_smoke.py`` holds
the decompositions against.

The reference gates the all-axes decomposition behind ``CVVAE_EDGE_FAST``
(off) because on a TPU v5e XLA overlapped the pad copy with neighbouring
work and the decomposition lost in-chain.  Eager PyTorch on the H100
overlaps nothing: a materialised pad is a replicate-pad kernel that
returns NCDHW and a layout copy of the whole tensor back, one after the
other.  On an H100 (700 W) one served 17x720x1280 bf16 SD3
``/reconstruct`` took 1.61 s of device time with the pads materialised
and 0.92 s with the decomposition (PERF.md §5), so the port has no
switch.  The reference's other two lowerings, ``_conv3d_stacked_stem``
(Cin <= 8) and ``_conv3d_small_cout`` (Cout <= 8 heads), work around
the TPU MXU's 128 lanes and are not ported: those convs take cuDNN
through the dispatch above.

The decompositions add their fixes in place into the output's boundary
slices.  In fp32 they equal the materialised pad up to the order of the
sums.  In bf16 the main conv, each fix's summed taps, the fix and each
add are rounded, where the materialised pad rounds once, so they are not
bit-equal: each rounding moves a value by at most 2^-8 (half a bf16 ulp)
of what it rounds.  Away from the boundary slices a value is rounded
once in both, so the two differ by at most one ulp
(``chip_smoke.edge_check`` holds this on the card).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from cvvae_tpu_torch.ops import quant
from cvvae_tpu_torch.ops.kernels import stem
from cvvae_tpu_torch.parallel import shard
from cvvae_tpu_torch.utils import spans

Pad = Tuple[int, int]


@dataclasses.dataclass(frozen=True)
class Conv3DSpec:
    """Static description of a conv layer: kernel/stride/padding policy."""

    kernel: Tuple[int, int, int]
    stride: Tuple[int, int, int] = (1, 1, 1)
    #: ((t_lo, t_hi), (h_lo, h_hi), (w_lo, w_hi))
    pads: Tuple[Pad, Pad, Pad] = ((0, 0), (0, 0), (0, 0))
    #: per-axis mode: "zero" | "edge"
    modes: Tuple[str, str, str] = ("zero", "zero", "zero")
    use_bias: bool = True

    @staticmethod
    def v1_causal(k: int = 3, p: int = 1, stride=(1, 1, 1)) -> "Conv3DSpec":
        """CausalConv3d: zeros space / replicate past time."""
        return Conv3DSpec((k, k, k), tuple(stride), ((2 * p, 0), (p, p), (p, p)),
                          ("edge", "zero", "zero"))

    @staticmethod
    def v1_plain(k: int = 3, p: int = 1, stride=(1, 1, 1)) -> "Conv3DSpec":
        """nn.Conv3d(padding=p), zero padding everywhere."""
        return Conv3DSpec((k, k, k), tuple(stride), ((p, p), (p, p), (p, p)),
                          ("zero", "zero", "zero"))

    @staticmethod
    def sd3_causal(k: int = 3, p: int = 1, stride=(1, 1, 1)) -> "Conv3DSpec":
        """SD3 CausalConv3d: replicate space and past time."""
        return Conv3DSpec((k, k, k), tuple(stride), ((2 * p, 0), (p, p), (p, p)),
                          ("edge", "edge", "edge"))

    @staticmethod
    def sd3_plain(k: int = 3, p: int = 1, stride=(1, 1, 1)) -> "Conv3DSpec":
        """Conv3d(padding=p, padding_mode="replicate"): edge pad all axes."""
        return Conv3DSpec((k, k, k), tuple(stride), ((p, p), (p, p), (p, p)),
                          ("edge", "edge", "edge"))

    @staticmethod
    def spatial2d(k: int = 3, p: int = 1, stride_hw=(1, 1)) -> "Conv3DSpec":
        """Conv2dWithExtraDim: per-frame 2D conv == (1,k,k) 3D conv."""
        return Conv3DSpec((1, k, k), (1,) + tuple(stride_hw),
                          ((0, 0), (p, p), (p, p)), ("zero", "zero", "zero"))

    @staticmethod
    def pointwise() -> "Conv3DSpec":
        """1x1x1 conv (nin_shortcut)."""
        return Conv3DSpec((1, 1, 1))

    @staticmethod
    def v1_downsample(down_time: bool) -> "Conv3DSpec":
        """v1 Downsample3D: asym zero pad (0,1) space, replicate (2,0)
        time, stride 2 (or (1,2,2))."""
        return Conv3DSpec((3, 3, 3), (2 if down_time else 1, 2, 2),
                          ((2, 0), (0, 1), (0, 1)), ("edge", "zero", "zero"))

    def fan_in(self, c_in: int) -> int:
        kt, kh, kw = self.kernel
        return c_in * kt * kh * kw


def uniform_(t: torch.Tensor, bound: float,
             generator: Optional[torch.Generator]) -> torch.Tensor:
    with torch.no_grad():
        return t.uniform_(-bound, bound, generator=generator)


class Conv(nn.Module):
    """A conv's parameters: ``weight`` (O, I, kT, kH, kW) and ``bias``
    (O,), initialised as torch's Conv default (U(±1/sqrt(fan_in)))."""

    def __init__(self, spec: Conv3DSpec, c_in: int, c_out: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.spec = spec
        bound = 1.0 / math.sqrt(spec.fan_in(c_in))
        self.weight = nn.Parameter(uniform_(
            torch.empty((c_out, c_in) + tuple(spec.kernel)), bound, generator))
        self.bias = (nn.Parameter(uniform_(torch.empty(c_out), bound, generator))
                     if spec.use_bias else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv3d(x, self, self.spec)


def conv3d(x: torch.Tensor, params, spec: Conv3DSpec) -> torch.Tensor:
    """Run the conv described by ``spec`` on ``x`` (B,T,H,W,C); ``params``
    has ``weight`` (O,I,kT,kH,kW), or ``weight_q`` and ``scale_w`` where
    ``quant.quantize_conv_params`` quantized it, and ``bias`` (O,) or
    None.  Returns a contiguous (B,T',H',W',O) tensor.

    As ``cvvae_tpu/ops/conv.py::conv3d``: a quantized conv records its
    activation when calibrating, then runs int8 (K5) at T·H·W >=
    ``quant.INT8_MIN_POSITIONS`` and otherwise in float on the dequantized
    kernel.  In float, K3 first; then the causal convs (edge time, zero
    space, T > 1) to the time-axis decomposition, every other edge pad to
    the all-axes one, and zero pads to the window.

    In a net call split over a mesh (``parallel/shard.py``), ``x`` is this
    rank's run of the split axis: the conv exchanges the halo rows its
    windows read from the neighbours' runs, and convolves that slab with
    the global pads only where it holds a global end (0 on interior
    sides); the dispatch above takes the global extents."""
    with spans.span("cvvae.op.conv3d"):
        ctx = shard.current()
        if ctx is None:
            return _conv3d(x, params, spec, x.shape[1:4])
        extents = ctx.extents(x)
        a = ctx.dim - 1
        slab, pad, out_sizes = ctx.window(x, spec.kernel[a], spec.stride[a],
                                          *spec.pads[a])
        pads = list(spec.pads)
        pads[a] = pad
        y = _conv3d(slab, params,
                    dataclasses.replace(spec, pads=tuple(pads)), extents)
        ctx.register(y, out_sizes)
        return y


def _conv3d(x: torch.Tensor, params, spec: Conv3DSpec,
            extents) -> torch.Tensor:
    """``conv3d`` on ``x`` whose (T, H, W) is ``extents`` where the
    dispatch is concerned (the global extents in a sharded net call)."""
    bias = params.bias
    if quant.is_quantized(params):
        quant.maybe_record_act(params, x)
        if math.prod(extents) >= quant.INT8_MIN_POSITIONS:
            return quant.conv3d_int8(x, params, spec)
        weight = quant.dequantize_kernel(params)
    else:
        weight = params.weight
    if stem.stem_usable(weight, spec):
        return stem.stem_conv3d(x, weight, bias, spec)
    weight = weight.to(x.dtype)
    bias = None if bias is None else bias.to(x.dtype)
    edge = [m == "edge" and (p[0] or p[1])
            for m, p in zip(spec.modes, spec.pads)]
    if edge[0] and spec.modes[1] == spec.modes[2] == "zero" and extents[0] > 1:
        y = _conv3d_edge_time_fast(x, weight, spec, bias=bias)
    elif any(edge):
        y = _conv3d_edge_fast(x, weight, spec, bias=bias)
    else:  # an edge-mode axis here pads (0, 0)
        y = _window_conv(x, weight, spec.pads, spec.stride, bias)
    return y.contiguous()


def _torch_pad(pads) -> Tuple[int, ...]:
    """((t_lo,t_hi),(h_lo,h_hi),(w_lo,w_hi)) -> F.pad order (last dim
    first)."""
    (t0, t1), (h0, h1), (w0, w1) = pads
    return (w0, w1, h0, h1, t0, t1)


def _edge_pad(x: torch.Tensor, pads, modes) -> torch.Tensor:
    """Materialise the edge-mode pads of (B,T,H,W,C) ``x``: a replicate
    ``F.pad``, which returns NCDHW, then a copy back to (B,T,H,W,C)."""
    edge = [p if m == "edge" else (0, 0) for p, m in zip(pads, modes)]
    if not any(lo or hi for lo, hi in edge):
        return x
    xn = F.pad(x.permute(0, 4, 1, 2, 3), _torch_pad(edge), mode="replicate")
    return xn.permute(0, 2, 3, 4, 1).contiguous()


#: elements of an fp32 conv's zero-padded input past which, with TF32 off,
#: ``_window_conv`` splits the conv in time: cuDNN 9 runs such a conv in
#: its int64-indexed direct kernel (``conv2d_grouped_direct_kernel_int64``),
#: 55.6 s for v1's 720p level-0 causal conv at 17 frames on an H100, where
#: 9 frames take 0.3 s (PERF.md §6, ``utils/profiling.py --edge_conv``)
TIME_SPLIT_ELEMENTS = 2 ** 31 - 1


def _split_in_time(x: torch.Tensor, weight: torch.Tensor, pads,
                   strides) -> bool:
    """Whether ``_window_conv`` splits this conv in time: fp32 with cuDNN's
    TF32 off, its zero-padded input past ``TIME_SPLIT_ELEMENTS``, more
    than one output frame."""
    if x.dtype != torch.float32 or torch.backends.cudnn.allow_tf32:
        return False
    b, c = x.shape[0], x.shape[4]
    padded = b * c * math.prod(n + lo + hi for n, (lo, hi)
                               in zip(x.shape[1:4], pads))
    t_out = (x.shape[1] + sum(pads[0]) - weight.shape[2]) // strides[0] + 1
    return padded > TIME_SPLIT_ELEMENTS and t_out > 1


def _time_split_conv(x: torch.Tensor, weight: torch.Tensor, pads, strides,
                     bias: Optional[torch.Tensor]) -> torch.Tensor:
    """``_window_conv`` in chunks of output frames, each from its own
    input frames (kT − stride frames shared with the next chunk, the time
    pads only where a chunk reaches past the clip), each chunk's padded
    input within ``TIME_SPLIT_ELEMENTS`` where one frame allows it; the
    chunks are written into one contiguous (B,T',H',W',O) output."""
    b, t = x.shape[:2]
    (lo, hi), k, s = pads[0], weight.shape[2], strides[0]
    t_out = (t + lo + hi - k) // s + 1
    frame = b * x.shape[4] * math.prod(n + p0 + p1 for n, (p0, p1)
                                       in zip(x.shape[2:4], pads[1:]))
    per = max(1, ((TIME_SPLIT_ELEMENTS // frame) - k) // s + 1)
    out = None
    for o0 in range(0, t_out, per):
        o1 = min(t_out, o0 + per)
        i0, i1 = o0 * s - lo, (o1 - 1) * s - lo + k
        chunk = x[:, max(i0, 0):min(i1, t)]
        y = _window_conv(chunk, weight,
                         ((max(0, -i0), max(0, i1 - t)),) + tuple(pads[1:]),
                         strides, bias)
        if out is None:
            out = y.new_empty((b, t_out) + tuple(y.shape[2:]))
        out[:, o0:o1] = y
    return out


def _window_conv(x: torch.Tensor, weight: torch.Tensor, pads, strides,
                 bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Conv of (B,T,H,W,C) ``x`` with zero window pads ``pads`` (per axis
    (lo, hi), the two ends may differ) -> a (B,T',H',W',O) view.

    cuDNN pads both ends of an axis alike.  Where lo >= hi the conv pads
    lo at both ends and the trailing outputs past the true extent are
    dropped: the windows start where the asymmetric pad starts them, at
    any stride, and nothing is copied (the view of a causal conv's first
    T' frames is already contiguous for B = 1).  Where hi > lo (the v1
    downsample's (0, 1) at stride 2, which no symmetric pad and slice
    reproduces) the missing hi - lo zeros are materialised with ``F.pad``
    on the (B,T,H,W,C) tensor, one copy of it.  On the CPU a one-frame
    bf16 input's time pad is materialised too: there oneDNN's bf16 conv3d
    returns garbage for T = 1 with a time pad (torch 2.13's CPU build).
    An fp32 conv with TF32 off past ``TIME_SPLIT_ELEMENTS`` runs in time
    chunks (``_time_split_conv``) and returns a contiguous tensor."""
    if _split_in_time(x, weight, pads, strides):
        return _time_split_conv(x, weight, pads, strides, bias)
    if (x.device.type == "cpu" and x.dtype == torch.bfloat16
            and x.shape[1] == 1 and any(pads[0])):
        x = F.pad(x, (0, 0, 0, 0, 0, 0) + tuple(pads[0]))
        pads = ((0, 0),) + tuple(pads[1:])
    keep = [(n + lo + hi - k) // s + 1 for n, (lo, hi), k, s in
            zip(x.shape[1:4], pads, weight.shape[2:], strides)]
    extra = [(0, max(hi - lo, 0)) for lo, hi in pads]
    if any(hi for _, hi in extra):
        x = F.pad(x, (0, 0) + _torch_pad(extra))
    y = F.conv3d(x.permute(0, 4, 1, 2, 3), weight, bias, stride=tuple(strides),
                 padding=tuple(lo for lo, _ in pads))
    return y[:, :, :keep[0], :keep[1], :keep[2]].permute(0, 2, 3, 4, 1)


def _axis(t: torch.Tensor, axis: int, sl: slice) -> torch.Tensor:
    """The view of (B,T,H,W,C) ``t`` at ``sl`` along T (0), H (1) or W
    (2)."""
    idx = [slice(None)] * 5
    idx[1 + axis] = sl
    return t[tuple(idx)]


def _missing_taps(lo: int, k: int, stride: int, size: int, out_size: int):
    """(output index, first tap, last tap + 1, side) of each output of an
    axis whose window reaches past the input: on the lo side its first
    taps read the first slice's replicas, on the hi side its last taps the
    last slice's."""
    o = 0
    while o * stride < lo and o < out_size:
        yield o, 0, lo - o * stride, "lo"
        o += 1
    o = out_size - 1
    while o >= 0 and o * stride - lo + k - 1 > size - 1:
        yield o, k - (o * stride - lo + k - size), k, "hi"
        o -= 1


def _conv3d_edge_time_fast(x: torch.Tensor, weight: torch.Tensor,
                           spec: Conv3DSpec,
                           bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Edge ("replicate") time padding without copying the whole tensor.

    Port of ``cvvae_tpu/ops/conv.py::_conv3d_edge_time_fast``.  A
    replicate-padded T then a conv equals the conv with a zero time window
    plus a boundary fix: for the few output frames whose window reaches
    past the clip, the missing taps all read the first (or last) frame, so
    the fix is a per-frame 2D conv of ``x[:, :1]`` (``x[:, -1:]``) with
    those taps summed.  The fixes are added in place into their frames of
    the output.  Space stays zero-padded in the conv's window.  Returns a
    (B,T',H',W',O) view; ``bias`` goes into the main conv only."""
    y = _window_conv(x, weight, spec.pads, spec.stride, bias)
    space = ((0, 0),) + tuple(spec.pads[1:])
    frame_stride = (1,) + tuple(spec.stride[1:])
    for o, a, b, side in _missing_taps(spec.pads[0][0], spec.kernel[0],
                                       spec.stride[0], x.shape[1], y.shape[1]):
        frame = x[:, :1] if side == "lo" else x[:, -1:]
        taps = weight[:, :, a:b].sum(2, keepdim=True)
        y[:, o:o + 1].add_(_window_conv(frame, taps, space, frame_stride))
    return y


def _conv3d_edge_fast(x: torch.Tensor, weight: torch.Tensor,
                      spec: Conv3DSpec, raw_conv=None,
                      bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Edge ("replicate") padding on any axes without copying the tensor.

    Port of ``cvvae_tpu/ops/conv.py::_conv3d_edge_fast``: the conv with
    zero windows on every axis, then per edge axis a boundary fix, a conv
    of the 1-wide slab ``x[.., :1, ..]`` (or ``x[.., -1:, ..]``) with the
    missing kernel taps summed along that axis, added in place into the
    output's boundary slice.  The edge axes are fixed in order T, H, W
    (inclusion-exclusion): a slab conv pads later edge axes by repeating
    the edge (materialised on the thin slab) and earlier edge axes and
    zero-mode axes with zeros (their off-tensor terms are already
    counted), so each tap term that reads off the tensor is counted once,
    by its first out-of-range axis.

    ``raw_conv(x, weight, window_pads, strides)`` is the conv every step
    runs, (B,T,H,W,C) -> (B,T',H',W',O) with zero window pads, so another
    arithmetic (int8) can reuse the decomposition; by default
    ``_window_conv``, with ``bias`` in the main conv only (a ``raw_conv``
    passed in adds its own).

    The slabs along W are strided views in (B,T,H,W,C) memory, which
    ``F.conv3d`` copies (1/W of the tensor).  Returns a (B,T',H',W',O)
    view."""
    if raw_conv is None:
        def raw_conv(v, k, pads, strides):
            return _window_conv(v, k, pads, strides,
                                bias if k is weight else None)

    y = raw_conv(x, weight, spec.pads, spec.stride)
    edge_axes = [a for a in range(3) if spec.modes[a] == "edge"
                 and (spec.pads[a][0] or spec.pads[a][1])]
    for pos, axis in enumerate(edge_axes):
        later = edge_axes[pos + 1:]
        slab_edge = [spec.pads[a] if a in later else (0, 0) for a in range(3)]
        slab_zero = [(0, 0) if a == axis or a in later else spec.pads[a]
                     for a in range(3)]
        strides = list(spec.stride)
        strides[axis] = 1
        size = x.shape[1 + axis]
        slabs = {}
        for o, a, b, side in _missing_taps(
                spec.pads[axis][0], spec.kernel[axis], spec.stride[axis],
                size, y.shape[1 + axis]):
            if side not in slabs:
                sl = slice(0, 1) if side == "lo" else slice(size - 1, size)
                slabs[side] = _edge_pad(_axis(x, axis, sl), slab_edge,
                                        ("edge",) * 3)
            idx = [slice(None)] * 5
            idx[2 + axis] = slice(a, b)
            taps = weight[tuple(idx)].sum(2 + axis, keepdim=True)
            _axis(y, axis, slice(o, o + 1)).add_(
                raw_conv(slabs[side], taps, slab_zero, strides))
    return y
