"""CV-VAE v1 and SD3 in plain PyTorch: the benchmark's reference for a
served ``/reconstruct``.

Written from the published model (AILab-CVC/CV-VAE, ``models/
modeling_vae.py``: ``vae3d`` and ``vae3d_sd3``) and the serving scheme
the configuration file states, with no code of the program under test.
It takes a configuration (``benchmark/configs/<name>.json``), the
weights as a state dict keyed by the module paths the program also uses
(``parameter_specs`` lists them), and uint8 clips, and works out by
itself everything the program derives from them: the int8 weights and
their scales, the calibrated activation scales, the phase kernels of the
int8 upsample, and the spatial tile plan with its blended seams.

Arithmetic: float32 in (B, C, T, H, W) layout with TF32 off (the caller
runs it under ``exact_float32``).  An int8 conv is computed on the
dequantized values, ``q_x * s_x`` and ``q_w * s_w``; ``bits`` 4 makes
every int8 quantizer an int4 one (the control one precision below).
Large convs run in blocks of output frames, so that no cuDNN call sees
more than ``CHUNK_ELEMENTS`` input elements (past 2^31 cuDNN takes a
slow int64 path) and memory stays within the card after the program's
state is freed.

``counting`` mode runs the nets on the meta device and adds up the
operations of each conv, dense layer and attention product, with the
precision it runs in: the yardstick ``mfu_pct`` reads.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

#: most input elements one cuDNN conv call of the reference reads
CHUNK_ELEMENTS = 2 ** 30

Pad = Tuple[int, int]


@contextlib.contextmanager
def exact_float32():
    """TF32 off for cuDNN convs and matmuls inside the block, restored
    after."""
    prev = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = prev


@dataclasses.dataclass(frozen=True)
class Spec:
    kernel: Tuple[int, int, int]
    stride: Tuple[int, int, int] = (1, 1, 1)
    pads: Tuple[Pad, Pad, Pad] = ((0, 0), (0, 0), (0, 0))
    #: per axis "zero" or "edge" (replicate)
    modes: Tuple[str, str, str] = ("zero", "zero", "zero")


def _spec(k, pads, modes, stride=(1, 1, 1)):
    return Spec((k, k, k) if isinstance(k, int) else tuple(k),
                tuple(stride), pads, modes)


ZERO3 = ("zero", "zero", "zero")
EDGE3 = ("edge", "edge", "edge")
#: v1's CausalConv3d: replicate the past in time, zeros in space
V1_CAUSAL = _spec(3, ((2, 0), (1, 1), (1, 1)), ("edge", "zero", "zero"))
V1_PLAIN = _spec(3, ((1, 1), (1, 1), (1, 1)), ZERO3)
SD3_CAUSAL = _spec(3, ((2, 0), (1, 1), (1, 1)), EDGE3)
SD3_PLAIN = _spec(3, ((1, 1), (1, 1), (1, 1)), EDGE3)
#: half_3d: the resblock's second conv is a per-frame 2D conv
SPATIAL2D = _spec((1, 3, 3), ((0, 0), (1, 1), (1, 1)), ZERO3)
POINTWISE = _spec(1, ((0, 0), (0, 0), (0, 0)), ZERO3)


def v1_downsample(down_time: bool) -> Spec:
    """v1's Downsample3D: zeros (0, 1) in space, replicate (2, 0) in
    time, stride 2 (1 in time where it keeps the frames)."""
    return _spec(3, ((2, 0), (0, 1), (0, 1)), ("edge", "zero", "zero"),
                 (2 if down_time else 1, 2, 2))


# ---------------------------------------------------------------------------
# the configuration
# ---------------------------------------------------------------------------

class Config:
    """A configuration file's model: family, net widths, the video
    wrapper's chunking and the serving precision with its int8 scheme."""

    def __init__(self, data: dict):
        self.family = data["family"]
        self.net = data["net"]
        self.video = data["video"]
        self.eps = float(data["norm_eps"])
        self.precision = data["precision"]
        self.int8 = data.get("int8", {})
        if self.family not in ("v1", "sd3"):
            raise ValueError(f"unknown family {self.family!r}")
        n = self.net
        if self.family == "v1":
            unsupported = {"use_3d_conv": True, "half_3d": True,
                           "attn_resolutions": [], "double_z": True,
                           "dropout": 0.0}
        else:
            unsupported = {"half_3d": True, "double_z": True,
                           "dropout": 0.0}
        for key, want in unsupported.items():
            if key in n and n[key] != want:
                raise ValueError(f"the reference implements {key}={want!r} "
                                 f"only, not {n[key]!r}")

    @property
    def latent_channels(self) -> int:
        return (self.net["z_channels"] if self.family == "v1"
                else self.net["latent_channels"])

    @property
    def groups(self) -> int:
        return self.net["norm_num_groups"]


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

def _conv_p(out: Dict, name: str, cin: int, cout: int, kernel) -> None:
    out[f"{name}.weight"] = ((cout, cin) + tuple(kernel), "conv")
    out[f"{name}.bias"] = ((cout,), "bias")


def _norm_p(out: Dict, name: str, c: int) -> None:
    out[f"{name}.weight"] = ((c,), "ones")
    out[f"{name}.bias"] = ((c,), "zeros")


def _dense_p(out: Dict, name: str, cin: int, cout: int) -> None:
    out[f"{name}.weight"] = ((cout, cin), "dense")
    out[f"{name}.bias"] = ((cout,), "bias")


def _resblock_p(out, name, cin, cout, family):
    _norm_p(out, f"{name}.norm1", cin)
    _conv_p(out, f"{name}.conv1", cin, cout, (3, 3, 3))
    _norm_p(out, f"{name}.norm2", cout)
    _conv_p(out, f"{name}.conv2", cout, cout, (1, 3, 3))
    if cin != cout:
        short = "nin_shortcut" if family == "v1" else "conv_shortcut"
        _conv_p(out, f"{name}.{short}", cin, cout, (1, 1, 1))


def parameter_specs(cfg: Config) -> Dict[str, Tuple[tuple, str]]:
    """{state-dict key: (shape, kind)} of the whole model, in a fixed
    order.  kind: "conv" and "dense" weights and their "bias" are drawn
    uniform in +-1/sqrt(fan_in) (torch's default init), norm affines are
    "ones" and "zeros"."""
    out: Dict[str, Tuple[tuple, str]] = {}
    n = cfg.net
    if cfg.family == "v1":
        ch, mult = n["ch"], list(n["ch_mult"])
        z = n["z_channels"]
        levels = len(mult)
        e = "encoder"
        _conv_p(out, f"{e}.conv_in", n["in_channels"], ch, (3, 3, 3))
        in_mult = [1] + mult
        for lv in range(levels):
            cin, cout = ch * in_mult[lv], ch * mult[lv]
            for j in range(n["num_res_blocks"]):
                _resblock_p(out, f"{e}.down.{lv}.block.{j}",
                            cin if j == 0 else cout, cout, "v1")
            if lv != levels - 1:
                _conv_p(out, f"{e}.down.{lv}.downsample", cout, cout,
                        (3, 3, 3))
        mid = ch * mult[-1]
        _v1_mid_p(out, f"{e}.mid", mid, temporal=n["encoder_attn"] ==
                  "spatial-temporal")
        _norm_p(out, f"{e}.norm_out", mid)
        _conv_p(out, f"{e}.conv_out", mid, 2 * z, (3, 3, 3))
        d = "decoder"
        _conv_p(out, f"{d}.conv_in", z, mid, (3, 3, 3))
        _v1_mid_p(out, f"{d}.mid", mid, temporal=n["decoder_attn"] ==
                  "spatial-temporal")
        block_in = mid
        ups = {}
        for lv in reversed(range(levels)):
            cout = ch * mult[lv]
            blocks = {}
            for j in range(n["num_res_blocks"] + 1):
                _resblock_p(blocks, f"{d}.up.{lv}.block.{j}",
                            block_in if j == 0 else cout, cout, "v1")
            block_in = cout
            if lv != 0:
                up_time = (lv % 2 == 1) if n.get("half_t_mult", True) \
                    else True
                _conv_p(blocks, f"{d}.up.{lv}.upsample", cout,
                        cout * (2 if up_time else 1), (3, 3, 3))
            ups[lv] = blocks
        for lv in range(levels):   # the module list's order
            out.update(ups[lv])
        _norm_p(out, f"{d}.norm_out", block_in)
        _conv_p(out, f"{d}.conv_out", block_in, n["out_ch"], (3, 3, 3))
        return out
    chans = list(n["block_out_channels"])
    lat = n["latent_channels"]
    levels = len(chans)
    e = "encoder"
    _conv_p(out, f"{e}.conv_in", n["in_channels"], chans[0], (3, 3, 3))
    prev = chans[0]
    for i, cout in enumerate(chans):
        for j in range(n["layers_per_block"]):
            _resblock_p(out, f"{e}.down_blocks.{i}.resnets.{j}",
                        prev if j == 0 else cout, cout, "sd3")
        if i != levels - 1:
            _conv_p(out, f"{e}.down_blocks.{i}.downsamplers.0", cout, cout,
                    (3, 3, 3))
        prev = cout
    _sd3_mid_p(out, f"{e}.mid_block", chans[-1], n)
    _norm_p(out, f"{e}.conv_norm_out", chans[-1])
    _conv_p(out, f"{e}.conv_out", chans[-1], 2 * lat, (3, 3, 3))
    d = "decoder"
    rev = list(reversed(chans))
    _conv_p(out, f"{d}.conv_in", lat, rev[0], (3, 3, 3))
    _sd3_mid_p(out, f"{d}.mid_block", rev[0], n)
    prev = rev[0]
    for i, cout in enumerate(rev):
        for j in range(n["layers_per_block"] + 1):
            _resblock_p(out, f"{d}.up_blocks.{i}.resnets.{j}",
                        prev if j == 0 else cout, cout, "sd3")
        if i != levels - 1:
            n_up = 2 if _sd3_up_time(i, levels) else 1
            _conv_p(out, f"{d}.up_blocks.{i}.upsamplers.0", cout,
                    cout * n_up, (3, 3, 3))
        prev = cout
    _norm_p(out, f"{d}.conv_norm_out", rev[-1])
    _conv_p(out, f"{d}.conv_out", rev[-1], n["in_channels"], (3, 3, 3))
    return out


def _v1_mid_p(out, name, c, temporal):
    _resblock_p(out, f"{name}.block_1", c, c, "v1")
    a = f"{name}.attn_1"
    _norm_p(out, f"{a}.norm", c)
    for k in ("q", "k", "v", "proj_out"):
        _dense_p(out, f"{a}.{k}", c, c)
    if temporal:
        _norm_p(out, f"{a}.norm_t", c)
        for k in ("q_t", "k_t", "v_t", "proj_out_t"):
            _dense_p(out, f"{a}.{k}", c, c)
    _resblock_p(out, f"{name}.block_2", c, c, "v1")


def _sd3_mid_p(out, name, c, n):
    _resblock_p(out, f"{name}.resnets.0", c, c, "sd3")
    _resblock_p(out, f"{name}.resnets.1", c, c, "sd3")
    if n.get("mid_block_add_attention", True):
        a = f"{name}.attentions.0"
        _norm_p(out, f"{a}.group_norm", c)
        for k in ("to_q", "to_k", "to_v", "to_out"):
            _dense_p(out, f"{a}.{k}", c, c)


def _sd3_down_time(i: int, levels: int) -> bool:
    return i % 2 == 0 and i != levels - 1


def _sd3_up_time(i: int, levels: int) -> bool:
    return i % 2 == 0 and i != levels - 1


def init_bound(specs, key: str) -> float:
    """The uniform bound of a "conv", "dense" or "bias" entry: 1/sqrt of
    its layer's fan-in."""
    wkey = key[:-len("bias")] + "weight" if key.endswith(".bias") else key
    shape = specs[wkey][0]
    return 1.0 / math.sqrt(math.prod(shape[1:]))


# ---------------------------------------------------------------------------
# int8 (or int4) quantization, as the configuration states it
# ---------------------------------------------------------------------------

class Quant:
    """The serving scheme's quantizers: weights per output channel,
    activations per tensor with a scale calibrated on a clip (or taken
    from the tensor itself where none is), symmetric, round half to
    even, clipped to +-qmax; ``bits`` 8 (qmax 127) or 4 (qmax 7)."""

    def __init__(self, scheme: dict, bits: int = 8):
        self.qmax = float(2 ** (bits - 1) - 1)
        self.min_cin = scheme["min_cin"]
        self.min_cout = scheme["min_cout"]
        self.min_positions = scheme["min_positions"]
        self.margin = scheme["margin"]
        self.scales: Dict[str, torch.Tensor] = {}
        self.recorded: Optional[Dict[str, float]] = None
        self._weights: Dict[str, torch.Tensor] = {}

    def eligible(self, w: torch.Tensor) -> bool:
        return (w.ndim == 5 and w.shape[1] >= self.min_cin
                and w.shape[0] >= self.min_cout
                and w.shape[2] * w.shape[3] * w.shape[4] > 1)

    def quantize_weight(self, w: torch.Tensor) -> torch.Tensor:
        """The dequantized per-channel quantization of a float kernel."""
        w = w.float()
        scale = w.abs().amax(dim=(1, 2, 3, 4)) / w.new_tensor(self.qmax)
        scale = scale.clamp_min(1e-12)[:, None, None, None, None]
        return torch.clamp(torch.round(w / scale), -self.qmax,
                           self.qmax) * scale

    def weight(self, name: str, w: torch.Tensor) -> torch.Tensor:
        if name not in self._weights:
            self._weights[name] = self.quantize_weight(w)
        return self._weights[name]

    def phase_weights(self, name: str, w: torch.Tensor) -> List[torch.Tensor]:
        """The upsample's four phase kernels: summed in fp32 from the
        dequantized kernel, then each quantized per channel again."""
        key = name + "#phases"
        if key not in self._weights:
            self._weights[key] = torch.stack(
                [self.quantize_weight(k) for k in
                 _phase_kernels(self.weight(name, w))])
        return list(self._weights[key])

    def record(self, name: str, x: torch.Tensor) -> None:
        if self.recorded is not None:
            m = float(x.abs().amax())
            self.recorded[name] = max(self.recorded.get(name, 0.0), m)

    def act_scale(self, name: str, x: torch.Tensor) -> torch.Tensor:
        """The calibrated scale, else max|x| / qmax (at least 1e-12)."""
        s = self.scales.get(name)
        if s is not None:
            return s
        return (x.abs().amax() / x.new_tensor(self.qmax)).clamp_min(1e-12)

    def fake(self, x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
        return torch.clamp(torch.round(x / scale), -self.qmax,
                           self.qmax) * scale

    def attach(self, device) -> None:
        """The calibrated scales, max|x| * margin / qmax in Python floats,
        stored as fp32."""
        for name, m in self.recorded.items():
            self.scales[name] = torch.tensor(
                max(m * self.margin / self.qmax, 1e-12), dtype=torch.float32,
                device=device)
        self.recorded = None


def _phase_kernels(w: torch.Tensor) -> List[torch.Tensor]:
    """(O, I, kT, 3, 3) -> the (O, I, kT, 2, 2) kernels of the four output
    phases of nearest-2x-then-conv, in (h even, w even), (h even, w odd),
    (h odd, w even), (h odd, w odd) order: an even output row reads rows
    i-1, i with taps (w0, w1 + w2), an odd one rows i, i+1 with (w0 + w1,
    w2)."""
    h_even = torch.cat([w[:, :, :, 0:1], w[:, :, :, 1:2] + w[:, :, :, 2:3]], 3)
    h_odd = torch.cat([w[:, :, :, 0:1] + w[:, :, :, 1:2], w[:, :, :, 2:3]], 3)
    out = []
    for wh in (h_even, h_odd):
        out.append(torch.cat([wh[..., 0:1], wh[..., 1:2] + wh[..., 2:3]], 4))
        out.append(torch.cat([wh[..., 0:1] + wh[..., 1:2], wh[..., 2:3]], 4))
    return out


# ---------------------------------------------------------------------------
# layers (B, C, T, H, W) float32
# ---------------------------------------------------------------------------

def _gather_time(x: torch.Tensor, lo: int, n: int, mode: str) -> torch.Tensor:
    """Frames lo .. lo + n - 1 of x (negative or past the end: the edge
    frame in "edge" mode, zeros in "zero" mode)."""
    t = x.shape[2]
    idx = torch.arange(lo, lo + n, device=x.device)
    xs = x.index_select(2, idx.clamp(0, t - 1))
    if mode == "zero" and (lo < 0 or lo + n > t):
        keep = ((idx >= 0) & (idx < t)).to(xs.dtype).view(1, 1, -1, 1, 1)
        xs = xs * keep
    return xs


def _pad_space(x: torch.Tensor, hp: Pad, wp: Pad, modes) -> torch.Tensor:
    if not any(hp + wp):
        return x
    if modes[1] != modes[2]:
        raise ValueError(f"mixed spatial pad modes {modes}")
    mode = "replicate" if modes[1] == "edge" else "constant"
    return F.pad(x, (wp[0], wp[1], hp[0], hp[1], 0, 0), mode=mode)


def _upsample_hw(x: torch.Tensor) -> torch.Tensor:
    return x.repeat_interleave(2, dim=3).repeat_interleave(2, dim=4)


class Net:
    """The encoder and decoder of one configuration over a state dict of
    float32 tensors; ``quant`` None runs every conv in float."""

    def __init__(self, cfg: Config, params: Dict[str, torch.Tensor],
                 quant: Optional[Quant] = None, counter=None):
        self.cfg = cfg
        self.p = params
        self.quant = quant
        #: counting mode: a list that each conv, dense and attention
        #: product appends (operations, int8) to
        self.counter = counter

    # -- primitives --

    def conv(self, name: str, x: torch.Tensor, spec: Spec,
             upsample: bool = False) -> torch.Tensor:
        """The conv ``name`` with ``spec`` on x, nearest-2x upsampled in
        space first where ``upsample`` (the upsample's conv); int8 where
        the scheme quantizes it and x has at least ``min_positions``
        positions."""
        w, b = self.p[f"{name}.weight"], self.p.get(f"{name}.bias")
        q = self.quant
        fq = None
        int8 = False
        if q is not None and q.eligible(w):
            q.record(name, x)
            if math.prod(x.shape[2:5]) >= q.min_positions:
                scale = q.act_scale(name, x)
                int8 = True
                if upsample:
                    return self._upsample_int8(name, x, w, b, scale, spec)

                def fq(v, scale=scale):
                    return q.fake(v, scale)
            w = q.weight(name, w)
        if self.counter is not None:
            self._count_conv(x, w, spec, upsample, int8)
        return _conv3d(x, w, b, spec, pre=fq, upsample=upsample)

    def _count_conv(self, x, w, spec, upsample, int8):
        """Operations of a conv: 2 a tap an input channel an output value;
        the upsample's conv as its four phase convs of (kT, 2, 2) taps on
        the tensor before the upsample, which nearest-2x makes equal to
        the conv on the upsampled one."""
        b, c, t, h, wd = x.shape
        kt, kh, kw = w.shape[2:]
        t_out = (t + sum(spec.pads[0]) - kt) // spec.stride[0] + 1
        if upsample:
            ops = 4 * 2 * b * w.shape[0] * t_out * h * wd * c * kt * 4
        else:
            ho = (h + sum(spec.pads[1]) - kh) // spec.stride[1] + 1
            wo = (wd + sum(spec.pads[2]) - kw) // spec.stride[2] + 1
            ops = 2 * b * w.shape[0] * t_out * ho * wo * c * kt * kh * kw
        self.counter.append((ops, int8))

    def _upsample_int8(self, name, x, w, b, scale, spec):
        """The int8 upsample as the scheme defines it: x quantized once,
        padded by one in space, and four convs of the phase kernels over
        their windows, interleaved into the 2x output."""
        q = self.quant
        phases = q.phase_weights(name, w)
        if self.counter is not None:
            self._count_conv(x, w, spec, True, True)
        bsz, _, t, h, wd = x.shape
        kt = w.shape[2]
        (tlo, thi), _, _ = spec.pads
        t_out = t + tlo + thi - kt + 1
        out = None
        frame = bsz * x.shape[1] * (h + 2) * (wd + 2)
        per = max(1, CHUNK_ELEMENTS // frame - kt + 1)
        for o0 in range(0, t_out, per):
            o1 = min(t_out, o0 + per)
            xs = q.fake(_gather_time(x, o0 - tlo, o1 - o0 + kt - 1,
                                     spec.modes[0]), scale)
            xs = _pad_space(xs, (1, 1), (1, 1), spec.modes)
            for i, k in enumerate(phases):
                ph, pw = divmod(i, 2)
                y = F.conv3d(xs[:, :, :, ph:ph + h + 1, pw:pw + wd + 1], k)
                if out is None:
                    out = y.new_empty((bsz, y.shape[1], t_out, 2 * h,
                                       2 * wd))
                out[:, :, o0:o1, ph::2, pw::2] = y
        if b is not None:
            out += b.view(1, -1, 1, 1, 1)
        return out

    def group_norm(self, name: str, x: torch.Tensor, silu: bool,
                   per_frame: bool = False) -> torch.Tensor:
        """GroupNorm over (C/G, T, H, W), or per frame over (C/G, H, W),
        moments in fp32, then SiLU where ``silu``."""
        g = self.cfg.groups
        gamma, beta = self.p[f"{name}.weight"], self.p[f"{name}.bias"]
        if per_frame:
            b, c, t, h, w = x.shape
            xf = x.transpose(1, 2).reshape(b * t, c, h, w)
            y = F.group_norm(xf, g, gamma, beta, self.cfg.eps)
            y = y.reshape(b, t, c, h, w).transpose(1, 2).contiguous()
        else:
            b, c = x.shape[:2]
            xg = x.reshape(b, g, -1)
            mean = torch.empty((b, g), device=x.device)
            var = torch.empty((b, g), device=x.device)
            for i in range(g):   # one group a call: < 2^31 elements each
                var[:, i], mean[:, i] = torch.var_mean(xg[:, i], dim=1,
                                                       unbiased=False)
            inv = torch.rsqrt(var + self.cfg.eps)
            a = (gamma.view(g, c // g) * inv[..., None]).reshape(b, c)
            shift = beta.view(1, c) - mean.repeat_interleave(c // g, 1) * a
            y = x * a.view(b, c, 1, 1, 1)
            y += shift.view(b, c, 1, 1, 1)
        if silu:
            F.silu(y, inplace=True)
        return y

    def dense(self, name: str, x: torch.Tensor) -> torch.Tensor:
        w = self.p[f"{name}.weight"]
        if self.counter is not None:
            self.counter.append((2 * x.numel() // x.shape[-1] * w.numel(),
                                 False))
        return F.linear(x, w, self.p.get(f"{name}.bias"))

    def attention(self, q, k, v) -> torch.Tensor:
        """Single-head softmax attention over (N, S, C), a row of N at a
        time where the logits are large."""
        if self.counter is not None:
            n, s, c = q.shape
            self.counter.append((4 * n * s * s * c, False))
            return q
        scale = 1.0 / math.sqrt(q.shape[-1])
        out = torch.empty_like(q)
        step = max(1, 2 ** 28 // (q.shape[1] * k.shape[1]))
        for i in range(0, q.shape[0], step):
            logits = torch.bmm(q[i:i + step], k[i:i + step].transpose(1, 2))
            out[i:i + step] = torch.bmm(torch.softmax(logits * scale, -1),
                                        v[i:i + step])
        return out

    def spatial_attention(self, prefix: str, names, x):
        b, c, t, h, w = x.shape
        tok = x.permute(0, 2, 3, 4, 1).reshape(b * t, h * w, c)
        q, k, v = (self.dense(f"{prefix}.{n}", tok) for n in names)
        out = self.attention(q, k, v)
        return out.reshape(b, t, h, w, c).permute(0, 4, 1, 2, 3)

    def temporal_attention(self, prefix: str, names, x):
        b, c, t, h, w = x.shape
        tok = x.permute(0, 3, 4, 2, 1).reshape(b * h * w, t, c)
        q, k, v = (self.dense(f"{prefix}.{n}", tok) for n in names)
        out = self.attention(q, k, v)
        return out.reshape(b, h, w, t, c).permute(0, 4, 3, 1, 2)

    def dense_cf(self, name: str, x: torch.Tensor) -> torch.Tensor:
        """A dense layer over the channels of (B, C, T, H, W)."""
        return self.dense(name, x.permute(0, 2, 3, 4, 1)).permute(
            0, 4, 1, 2, 3)

    # -- blocks --

    def resblock(self, name: str, x: torch.Tensor, spec1: Spec):
        h = self.group_norm(f"{name}.norm1", x, True)
        h = self.conv(f"{name}.conv1", h, spec1)
        h = self.group_norm(f"{name}.norm2", h, True)
        h = self.conv(f"{name}.conv2", h, SPATIAL2D)
        short = "nin_shortcut" if self.cfg.family == "v1" else "conv_shortcut"
        if f"{name}.{short}.weight" in self.p:
            x = self.conv(f"{name}.{short}", x, POINTWISE)
        h += x
        return h

    def upsample(self, name: str, x: torch.Tensor, n: int, spec: Spec):
        """Nearest 2x in space, the conv, then the (n c) channels split
        into n frames each, the first output frame dropped where n > 1."""
        y = self.conv(name, x, spec, upsample=True)
        if n == 1:
            return y
        b, nc, t, h, w = y.shape
        y = y.view(b, n, nc // n, t, h, w).permute(0, 2, 3, 1, 4, 5)
        return y.reshape(b, nc // n, t * n, h, w)[:, :, 1:].contiguous()

    def v1_attn(self, name: str, x: torch.Tensor, kind: str):
        h = self.group_norm(f"{name}.norm", x, False, per_frame=True)
        h = self.spatial_attention(name, ("q", "k", "v"), h)
        h = self.dense_cf(f"{name}.proj_out", h)
        if kind == "spatial-temporal":
            hl = F.layer_norm(h.permute(0, 2, 3, 4, 1), (h.shape[1],),
                              self.p[f"{name}.norm_t.weight"],
                              self.p[f"{name}.norm_t.bias"], 1e-5)
            h = self.temporal_attention(name, ("q_t", "k_t", "v_t"),
                                        hl.permute(0, 4, 1, 2, 3))
            h = self.dense_cf(f"{name}.proj_out_t", h)
        return x + h

    def sd3_attn(self, name: str, x: torch.Tensor):
        h = self.group_norm(f"{name}.group_norm", x, False, per_frame=True)
        h = self.spatial_attention(name, ("to_q", "to_k", "to_v"), h)
        return x + self.dense_cf(f"{name}.to_out", h)

    # -- nets --

    def encoder(self, x: torch.Tensor) -> torch.Tensor:
        """(B, 3, T, H, W) in [-1, 1] -> moments (B, 2z, T', H/8, W/8)."""
        if self.cfg.family == "v1":
            return self._v1_encoder(x)
        return self._sd3_encoder(x)

    def decoder(self, z: torch.Tensor) -> torch.Tensor:
        if self.cfg.family == "v1":
            return self._v1_decoder(z)
        return self._sd3_decoder(z)

    def _v1_encoder(self, x):
        n = self.cfg.net
        spec = V1_CAUSAL if n["causal_encoder"] else V1_PLAIN
        h = self.conv("encoder.conv_in", x, spec)
        levels = len(n["ch_mult"])
        for lv in range(levels):
            for j in range(n["num_res_blocks"]):
                h = self.resblock(f"encoder.down.{lv}.block.{j}", h, spec)
            if lv != levels - 1:
                down_time = (lv % 2 == 0) if n.get("half_t_mult", True) \
                    else True
                h = self.conv(f"encoder.down.{lv}.downsample", h,
                              v1_downsample(down_time))
        h = self.resblock("encoder.mid.block_1", h, spec)
        h = self.v1_attn("encoder.mid.attn_1", h, n["encoder_attn"])
        h = self.resblock("encoder.mid.block_2", h, spec)
        h = self.group_norm("encoder.norm_out", h, True)
        return self.conv("encoder.conv_out", h, spec)

    def _v1_decoder(self, z):
        n = self.cfg.net
        causal = n["causal_decoder"]
        spec = V1_CAUSAL if causal else V1_PLAIN
        up_spec = _spec(3, ((2, 0) if causal else (1, 1), (1, 1), (1, 1)),
                        ("edge", "zero", "zero"))
        h = self.conv("decoder.conv_in", z, spec)
        h = self.resblock("decoder.mid.block_1", h, spec)
        h = self.v1_attn("decoder.mid.attn_1", h, n["decoder_attn"])
        h = self.resblock("decoder.mid.block_2", h, spec)
        for lv in reversed(range(len(n["ch_mult"]))):
            for j in range(n["num_res_blocks"] + 1):
                h = self.resblock(f"decoder.up.{lv}.block.{j}", h, spec)
            if lv != 0:
                up_time = (lv % 2 == 1) if n.get("half_t_mult", True) \
                    else True
                h = self.upsample(f"decoder.up.{lv}.upsample", h,
                                  2 if up_time else 1, up_spec)
        h = self.group_norm("decoder.norm_out", h, True)
        return self.conv("decoder.conv_out", h, spec)

    def _sd3_encoder(self, x):
        n = self.cfg.net
        spec = SD3_CAUSAL if n["causal_encoder"] else SD3_PLAIN
        h = self.conv("encoder.conv_in", x, spec)
        levels = len(n["block_out_channels"])
        for i in range(levels):
            for j in range(n["layers_per_block"]):
                h = self.resblock(f"encoder.down_blocks.{i}.resnets.{j}", h,
                                  spec)
            if i != levels - 1:
                stride = (2, 2, 2) if _sd3_down_time(i, levels) else (1, 2, 2)
                h = self.conv(f"encoder.down_blocks.{i}.downsamplers.0", h,
                              dataclasses.replace(spec, stride=stride))
        h = self._sd3_mid("encoder.mid_block", h, spec)
        h = self.group_norm("encoder.conv_norm_out", h, True)
        return self.conv("encoder.conv_out", h, spec)

    def _sd3_mid(self, name, h, spec):
        h = self.resblock(f"{name}.resnets.0", h, spec)
        if f"{name}.attentions.0.to_q.weight" in self.p:
            h = self.sd3_attn(f"{name}.attentions.0", h)
        return self.resblock(f"{name}.resnets.1", h, spec)

    def _sd3_decoder(self, z):
        n = self.cfg.net
        causal = n["causal_decoder"]
        spec = SD3_CAUSAL if causal else SD3_PLAIN
        h = self.conv("decoder.conv_in", z, spec)
        h = self._sd3_mid("decoder.mid_block", h, spec)
        levels = len(n["block_out_channels"])
        for i in range(levels):
            for j in range(n["layers_per_block"] + 1):
                h = self.resblock(f"decoder.up_blocks.{i}.resnets.{j}", h,
                                  spec)
            if i != levels - 1:
                h = self.upsample(f"decoder.up_blocks.{i}.upsamplers.0", h,
                                  2 if _sd3_up_time(i, levels) else 1, spec)
        h = self.group_norm("decoder.conv_norm_out", h, True)
        return self.conv("decoder.conv_out", h, spec)


def _conv3d(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor],
            spec: Spec, pre=None, upsample: bool = False) -> torch.Tensor:
    """The conv of ``spec`` on (B, C, T, H, W) x, in blocks of output
    frames: each block gathers its input frames (the time pads by
    repeating the edge frame or by zeros), applies ``pre`` (the int8
    quantizer), upsamples 2x in space where ``upsample``, pads space in
    its mode and runs one ``F.conv3d``."""
    bsz, c, t, h, wd = x.shape
    kt = w.shape[2]
    (tlo, thi), hp, wp = spec.pads
    st = spec.stride[0]
    t_out = (t + tlo + thi - kt) // st + 1
    up = 2 if upsample else 1
    frame = bsz * c * (up * h + sum(hp)) * (up * wd + sum(wp))
    per = max(1, (CHUNK_ELEMENTS // frame - kt) // st + 1)
    out = None
    for o0 in range(0, t_out, per):
        o1 = min(t_out, o0 + per)
        xs = _gather_time(x, o0 * st - tlo, (o1 - 1 - o0) * st + kt,
                          spec.modes[0])
        if pre is not None:
            xs = pre(xs)
        if upsample:
            xs = _upsample_hw(xs)
        xs = _pad_space(xs, hp, wp, spec.modes)
        y = F.conv3d(xs, w, b, stride=spec.stride)
        if out is None:
            if o1 == t_out:
                return y
            out = y.new_empty((bsz, y.shape[1], t_out) + tuple(y.shape[3:]))
        out[:, :, o0:o1] = y
    return out


# ---------------------------------------------------------------------------
# the video wrapper: temporal chunks, spatial tiles, the serving plan
# ---------------------------------------------------------------------------

def serving_axis_plan(size: int, max_tile: int = 720,
                      overlap_latents: int = 8, compress: int = 8):
    """One axis of the serving tile plan: the fewest tiles of at most
    ``max_tile`` pixels that overlap by ``overlap_latents`` latents.
    Returns (tile pixels, overlap ratio) with ratio = overlap / tile in
    latents."""
    lat = size // compress
    n = max(1, -(-size // max_tile))
    while True:
        stride = -(-(lat - overlap_latents) // n)
        tile = stride + overlap_latents
        if tile * compress <= max_tile or stride <= 1:
            return tile * compress, overlap_latents / tile
        n += 1


@dataclasses.dataclass(frozen=True)
class Plan:
    """Spatial tiles in pixels (None: untiled) with per-axis overlap
    ratios, for the decoder and for the encoder."""
    decode_tile: Optional[Tuple[int, int]]
    encode_tile: Optional[Tuple[int, int]]
    ratio: Tuple[float, float]


def serving_plan(cfg: Config, height: int, width: int) -> Plan:
    """The serving plan for (height, width) frames: frames of at most 720
    pixels a side run untiled; larger ones in tiles of at most 720 pixels
    overlapping by 8 latents (64 pixels), blended.  v1's encoder, zero
    padded in space, runs the whole frame; SD3's, replicate padded, runs
    in the decoder's tiles."""
    if height <= 720 and width <= 720:
        return Plan(None, None, (0.2222, 0.2222))
    (th, rh), (tw, rw) = serving_axis_plan(height), serving_axis_plan(width)
    tile = (th, tw)
    return Plan(tile, None if cfg.family == "v1" else tile, (rh, rw))


def _blend(a: torch.Tensor, b: torch.Tensor, overlap: int, dim: int):
    """b with its first ``overlap`` rows (dim 3) or columns (dim 4)
    blended linearly from a's last ones."""
    shape = [1] * 5
    shape[dim] = overlap
    r = (torch.arange(overlap, dtype=torch.float32, device=b.device)
         / overlap).view(shape)
    head = (1 - r) * a.narrow(dim, a.shape[dim] - overlap, overlap) \
        + r * b.narrow(dim, 0, overlap)
    return torch.cat([head, b.narrow(dim, overlap, b.shape[dim] - overlap)],
                     dim)


def tiled(x: torch.Tensor, net, tile, out_tile, ratio) -> torch.Tensor:
    """``net`` over overlapping spatial tiles of (B, C, T, H, W) x, each
    tile blended into its already blended upper and left neighbours, then
    the tiles cropped to their strides and joined."""
    if tile is None or (x.shape[3] <= tile[0] and x.shape[4] <= tile[1]):
        return net(x)
    (th, tw), (oh, ow), (rh, rw) = tile, out_tile, ratio
    sh, sw = round(th * (1 - rh)), round(tw * (1 - rw))
    ovh, ovw = round(oh * rh), round(ow * rw)
    rows = []
    for i in range(0, x.shape[3], sh):
        row = []
        for j in range(0, x.shape[4], sw):
            row.append(net(x[:, :, :, i:i + th, j:j + tw].contiguous()))
            if j + tw >= x.shape[4]:
                break
        rows.append(row)
        if i + th >= x.shape[3]:
            break
    for i, row in enumerate(rows):
        for j in range(len(row)):
            t = row[j]
            if i > 0:
                t = _blend(rows[i - 1][j], t, ovh, 3)
            if j > 0:
                t = _blend(row[j - 1], t, ovw, 4)
            row[j] = t
    out_rows = []
    for i, row in enumerate(rows):
        parts = []
        for j, t in enumerate(row):
            if i < len(rows) - 1:
                t = t[:, :, :, :oh - ovh]
            if j < len(row) - 1:
                t = t[:, :, :, :, :ow - ovw]
            parts.append(t)
        out_rows.append(torch.cat(parts, 4))
    return torch.cat(out_rows, 3)


def chunked(v: torch.Tensor, stride: Optional[int], fn) -> torch.Tensor:
    """``fn`` over windows of stride + 1 frames sharing one frame, the
    first output frame of each later window dropped."""
    if stride is None:
        return fn(v)
    rounds = max(1, math.ceil((v.shape[2] - 1) / stride))
    outs = []
    for r in range(rounds):
        out = fn(v[:, :, r * stride:(r + 1) * stride + 1].contiguous())
        outs.append(out if r == 0 else out[:, :, 1:])
    return torch.cat(outs, 2)


class Reference:
    """A served ``/reconstruct`` of one configuration: uint8 (T, H, W, 3)
    in, uint8 (T', H, W, 3) out, the posterior's mode in between."""

    def __init__(self, cfg: Config, weights: Dict[str, torch.Tensor],
                 device, bits: Optional[int] = None):
        """``weights`` the served weights (any dtype, taken to fp32 on
        ``device``); ``bits`` 8 or 4 quantizes as the configuration's int8
        scheme with that many bits, None runs in float."""
        self.cfg = cfg
        self.device = torch.device(device)
        params = {k: v.to(device=self.device, dtype=torch.float32)
                  for k, v in weights.items()}
        self.quant = (Quant(cfg.int8, bits) if bits is not None else None)
        self.net = Net(cfg, params, self.quant)

    def calibrate(self, clip_u8: torch.Tensor) -> None:
        """The activation scales from one untiled encoder and decoder pass
        on a (T, H, W, 3) uint8 clip: each quantized conv's max|x| over
        the pass (the convs before it quantized by their own tensors)."""
        x = _unit(clip_u8.to(self.device))
        self.quant.recorded = {}
        with torch.no_grad(), exact_float32():
            moments = self.net.encoder(x)
            self.net.decoder(moments[:, :self.cfg.latent_channels])
        self.quant.attach(self.device)

    def reconstruct(self, clip_u8: torch.Tensor,
                    plan: Optional[Plan] = None) -> torch.Tensor:
        """The served frames of a clip, under the serving plan of its
        frame size unless ``plan`` is given."""
        _, h, w, _ = clip_u8.shape
        plan = plan or serving_plan(self.cfg, h, w)
        x = _unit(clip_u8.to(self.device))
        v = self.cfg.video
        s = v["spatial_n_compress"]
        enc_stride = v["en_de_n_frames_a_time"]
        dec_stride = (None if enc_stride is None
                      else enc_stride // v["time_n_compress"])

        def lat(t):
            return None if t is None else (t[0] // s, t[1] // s)

        with torch.no_grad(), exact_float32():
            moments = chunked(x, enc_stride, lambda c: tiled(
                c, self.net.encoder, plan.encode_tile,
                lat(plan.encode_tile), plan.ratio))
            z = moments[:, :self.cfg.latent_channels].contiguous()
            del moments
            y = chunked(z, dec_stride, lambda c: tiled(
                c, self.net.decoder, lat(plan.decode_tile),
                plan.decode_tile, plan.ratio))
        u8 = ((y[0] + 1.0) * 127.5).clamp(0, 255).to(torch.uint8)
        return u8.permute(1, 2, 3, 0).contiguous()


def _unit(clip_u8: torch.Tensor) -> torch.Tensor:
    """(T, H, W, 3) uint8 -> (1, 3, T, H, W) float32 in [-1, 1]."""
    return (clip_u8.float() / 127.5 - 1.0).permute(3, 0, 1, 2)[None] \
        .contiguous()


def operations(cfg: Config, clip: Tuple[int, int, int]) -> List[tuple]:
    """(operations, int8) of every conv, dense layer and attention product
    of one clip of (T, H, W) frames: the encoder on the whole clip and the
    decoder on its whole latent, untiled, on the meta device.  int8 is
    whether the configuration's scheme runs it in int8 (always False in a
    float configuration)."""
    counter: List[tuple] = []
    specs = parameter_specs(cfg)
    params = {k: torch.empty(shape, device="meta")
              for k, (shape, _) in specs.items()}
    quant = Quant(cfg.int8) if cfg.precision == "int8" else None
    if quant is not None:
        quant.act_scale = lambda name, x: torch.ones((), device="meta")
        quant.record = lambda name, x: None
    net = Net(cfg, params, quant, counter)
    t, h, w = clip
    with torch.no_grad():
        moments = net.encoder(torch.empty((1, 3, t, h, w), device="meta"))
        net.decoder(moments[:, :cfg.latent_channels])
    return counter
