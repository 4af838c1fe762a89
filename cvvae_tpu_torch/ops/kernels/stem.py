"""K3: 3×3×3 stride-1 conv with few input channels (the encoder's
``conv_in`` on RGB pixels) — hand-written CUDA kernel and its plain
PyTorch version.

Replaces ``cvvae_tpu/ops/pallas/stem.py::stem_conv3d``, which contracts on
the TPU's matrix unit: one 27-deep dot a row, operands in the input dtype,
fp32 accumulation.  What bounds it on an H100: the 128-channel output
write (4.0 GB in bf16 for a 17-frame 720p clip, 1.2 ms at 3.35 TB/s).  The
contraction runs over (dt, dh, dw, ci), 27·Cin terms, so in bf16 it is an
implicit GEMM on the tensor cores, whose 325 GFLOP take a third of the
write's time; in fp32 it runs on exact FMAs (67 TFLOP/s: 4.9 ms at that
shape), which bound it there.

The design (``csrc/stem.cu``): persistent blocks, one an SM, whose
warpgroups each walk their own tiles of one output row segment (``TILE_W``
pixels × 128 channels, contiguous in the output) on the schedule of
``tile_plan`` / ``tile_origin``; weights loaded once a block; each tile's
input patch copied with cp.async two tiles ahead, the padding folded into
its layout (time clamped in edge mode, H/W and zero-mode time masked), so
no padded copy of the input is made.  bf16: wgmma m64n128k16 with the
patch as A in registers and the weights that ``pack_weight`` lays out as
B (K over (dt, dh, dw, ci) with the pixel padded to 4 channels, see
``k_order``; columns in the order of ``column_channels``; the bias as a
28th tap, so it is added in the fp32 accumulation and each value rounded
once), the tile staged in shared memory for one ``cp.async.bulk`` store.
fp32: 16 pixels a warp, 4 channels a lane, broadcast float4 inputs, one
float4 of weights a tap, 16-byte coalesced stores.

K3.bwd (``csrc/stem_bwd.cu``), the gradient in the weights and the bias,
which the TPU package leaves to XLA's autodiff of
``cvvae_tpu/ops/conv.py::_conv3d_stacked_stem``: ``stem_conv3d`` is a
``torch.autograd.Function`` (``_Stem``) whose backward launches K3.bwd on
the card (``stem_conv3d_backward_plain`` on a CPU tensor).  There is no
dx on the card: the stem's input is the pixels, and a CUDA ``x`` that
needs a gradient is refused.  The kernel: a persistent grid, each block
owning a contiguous range of output row tiles (``bwd_plan``).  bf16 is
one GEMM over the pixels on the tensor cores, dWᵀ = dyᵀ · im2col(x) with
a column of ones for dbias: mma.sync with fp32 accumulators, dy's tile by
TMA (128-byte swizzle) as A, the im2col that producer warps build in
shared memory as B while the multiplying warps run, a tile's products
added to fp32 totals.  fp32 runs exact FMAs, a thread owning three patch
rows × 2 channels, dy through a cp.async ring.  Each block's sums go to
slots of a scratch that a second launch adds in double.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from cvvae_tpu_torch.ops.kernels import _build

#: launches of the CUDA kernel K3 and of its backward K3.bwd (the CPU path
#: does not count)
launches = 0
bwd_launches = 0

MAX_CIN = 4
#: from csrc/stem.cu: output channels (kCout), output pixels a tile (kTW),
#: the bf16 kernel's K, 27 taps + the bias tap, 4 channels each (kK), and
#: its workers (warpgroups, each walking its own tiles) a block, one block
#: an SM, in bf16 and fp32 (kMmaWorkers, kFmaWorkers)
COUT, TILE_W, K_PACKED, _MMA_WORKERS, _FMA_WORKERS = _build.constants(
    "stem.cu", "kCout", "kTW", "kK", "kMmaWorkers", "kFmaWorkers")
WORKERS_PER_BLOCK = {torch.bfloat16: _MMA_WORKERS,
                     torch.float32: _FMA_WORKERS}


def use_bwd_source(text: Optional[str] = None) -> None:
    """Read K3.bwd's schedule from ``csrc/stem_bwd.cu`` (or ``text``, a
    variant of it that is about to run), by dtype: BWD_TILE_W output pixels
    a tile and BWD_BLOCKS_PER_SM blocks an SM (fp32's run in two waves);
    BWD_KSTEP pixels a k-step of the bf16 kernel's mma; the fp32 kernel's
    BWD_PX dy rows a stage and BWD_RUNS runs of pixels a tile (a slot
    each)."""
    global BWD_TILE_W, BWD_KSTEP, BWD_BLOCKS_PER_SM, BWD_PX, BWD_RUNS
    tw, fma_tw, BWD_KSTEP, mma, fma, BWD_PX, BWD_RUNS = _build.constants(
        "stem_bwd.cu", "kTW", "kFmaTW", "kK", "kBlocksPerSm",
        "kFmaBlocksPerSm", "kPX", "kPhases", text=text)
    BWD_TILE_W = {torch.bfloat16: tw, torch.float32: fma_tw}
    BWD_BLOCKS_PER_SM = {torch.bfloat16: mma, torch.float32: fma}


use_bwd_source()


def stem_usable(weight: torch.Tensor, spec) -> bool:
    """The convs K3 takes: 3×3×3, stride 1, 3 input channels (the pixel
    stem), 128 outputs, zero H/W padding, no negative pads.  The decoder's
    Cin=4 latent stem stays on cuDNN, as it stays on XLA in the JAX
    package."""
    return (tuple(spec.kernel) == (3, 3, 3) and tuple(spec.stride) == (1, 1, 1)
            and weight.shape[1] == 3 and weight.shape[0] == COUT
            and spec.modes[1] == "zero" and spec.modes[2] == "zero"
            and all(p >= 0 for pad in spec.pads for p in pad))


def stem_conv3d_plain(x: torch.Tensor, weight: torch.Tensor,
                      bias: Optional[torch.Tensor], spec) -> torch.Tensor:
    """x (B,T,H,W,Cin), weight (O,Cin,3,3,3) -> (B,T',H',W',O)."""
    xn = _padded(x, spec).permute(0, 4, 1, 2, 3)
    b = None if bias is None else bias.to(x.dtype)
    y = F.conv3d(xn, weight.to(x.dtype), b)
    return y.permute(0, 2, 3, 4, 1).contiguous()


def _padded(x: torch.Tensor, spec) -> torch.Tensor:
    """x (B,T,H,W,Cin) with the stem's pads materialised: time by
    repeating the edge frame (edge mode) or zeros, H/W zeros."""
    (t0, t1), (h0, h1), (w0, w1) = spec.pads
    xn = x.permute(0, 4, 1, 2, 3)
    if spec.modes[0] == "edge":
        xn = F.pad(xn, (0, 0, 0, 0, t0, t1), mode="replicate")
        t0 = t1 = 0
    return F.pad(xn, (w0, w1, h0, h1, t0, t1)).permute(0, 2, 3, 4, 1)


def stem_conv3d_backward_plain(x: torch.Tensor, dy: torch.Tensor, spec,
                               with_bias: bool = True):
    """K3.bwd's plain version: dW (O, Cin, 3, 3, 3) and dbias (O,) (None
    without ``with_bias``) of the stem conv of x (B,T,H,W,Cin) for dy
    (B,T',H',W',O), in x's and dy's promoted dtype with at least fp32
    (float64 in, float64 out): each tap's window of the padded input
    contracted with dy by one matrix product."""
    dt = torch.promote_types(torch.promote_types(x.dtype, dy.dtype),
                             torch.float32)
    xp = _padded(x.to(dt), spec)
    b, to, ho, wo, o = dy.shape
    d = dy.to(dt).reshape(-1, o)
    cin = x.shape[-1]
    dw = torch.empty((o, cin, 3, 3, 3), dtype=dt, device=x.device)
    for kt in range(3):
        for kh in range(3):
            for kw in range(3):
                win = xp[:, kt:kt + to, kh:kh + ho, kw:kw + wo].reshape(-1, cin)
                dw[:, :, kt, kh, kw] = (win.t() @ d).t()
    return dw, (d.sum(0) if with_bias else None)


def bwd_plan(b: int, t_out: int, h_out: int, w_out: int, sms: int,
             dtype: torch.dtype = torch.float32) -> dict:
    """K3.bwd's schedule for x and dy of ``dtype``: ``n_wt`` tiles of
    ``tile_w`` (BWD_TILE_W[dtype]) pixels an output row, ``n_tiles`` over
    the rows (b, t, h) in order, ``grid`` blocks (at most
    BWD_BLOCKS_PER_SM[dtype] an SM), block k taking the ``per`` tiles
    [k·per, (k + 1)·per); ``slots`` of the scratch that the merge adds in
    double (a block's in bf16; a block's runs of BWD_PX / BWD_RUNS pixels a
    tile in fp32).

    ``terms`` bounds the rounding: |dW − exact| <= terms · 2^-24 · Σ|x·dy|
    + 2^-24 · |exact|, and dbias the same with Σ|dy|; the last term and
    one of ``terms`` are the merge's (double, then one fp32 rounding).
    fp32: a slot adds each of its values' terms in order, one
    round-to-nearest FMA a term, per · BWD_PX / BWD_RUNS of them at most.
    bf16: the tensor core sums a k-step's BWD_KSTEP exact products and the
    carried sum by aligning them to the largest and truncating (round
    toward zero, no guard bits assumed), then truncates the result: each of
    those BWD_KSTEP + 2 truncations loses under 2^-23 of the step's
    Σ|products| + |carried sum|.  A tile's products start from zero, so
    over its tile_w / BWD_KSTEP k-steps that is 2·(BWD_KSTEP + 2)·steps ·
    2^-24 of the tile's Σ|x·dy|; then one round-to-nearest fp32 add a tile
    into the block's totals, per of them."""
    tile_w = BWD_TILE_W[dtype]
    n_wt = -(-w_out // tile_w)
    n_tiles = b * t_out * h_out * n_wt
    per = -(-n_tiles // min(n_tiles, sms * BWD_BLOCKS_PER_SM[dtype]))
    grid = -(-n_tiles // per)
    if dtype == torch.bfloat16:
        steps = tile_w // BWD_KSTEP
        slots, terms = grid, 2 * (BWD_KSTEP + 2) * steps + per + 1
    else:
        slots, terms = grid * BWD_RUNS, per * (BWD_PX // BWD_RUNS) + 1
    return dict(tile_w=tile_w, n_wt=n_wt, n_tiles=n_tiles, per=per,
                grid=grid, slots=slots, terms=terms)


def k_order():
    """(tap, ci) of each of the bf16 kernel's K_PACKED columns: k-step s
    (16 columns) holds taps 4s .. 4s + 3; within it column 8h + 2q + c is
    tap 4s + q, channel 2h + c, so lane q of an mma fragment holds all 4
    channels of one tap.  Tap t = (dt·3 + dh)·3 + dw; tap 27 is the zero
    padding."""
    kk = torch.arange(K_PACKED)
    s, r = kk // 16, kk % 16
    return 4 * s + (r % 8) // 2, 2 * (r // 8) + r % 2


def column_channels():
    """The output channel of each of the bf16 kernel's 128 GEMM columns:
    column 32w + 8j + 2q + c is channel 32w + 8q + 2j + c, so an mma
    lane's accumulators of one pixel are 8 consecutive channels."""
    n = torch.arange(COUT)
    w, l = n // 32, n % 32
    return 32 * w + 8 * ((l % 8) // 2) + 2 * (l // 8) + l % 2


def pack_weight(weight: torch.Tensor,
                bias: Optional[torch.Tensor]) -> torch.Tensor:
    """(O, Cin, 3, 3, 3) and (O,) -> (O, K_PACKED), the bf16 kernel's B
    matrix in the weight's dtype: row n is channel ``column_channels()[n]``,
    column k tap and channel ``k_order()``; channels >= Cin are zero, and
    tap 27, whose A row is (1, 0, 0, 0) at every pixel, holds the bias in
    channel 0 (added in the fp32 accumulation)."""
    o, cin = weight.shape[:2]
    w = weight.permute(0, 2, 3, 4, 1).reshape(o, 27, cin)
    w = F.pad(w, (0, 4 - cin, 0, 1))                   # (O, 28 taps, 4)
    if bias is not None:
        w[:, 27, 0] = bias.to(w.dtype)
    tap, ci = k_order()
    return w[column_channels()][:, tap, ci]


def pack_weight_fp32(weight: torch.Tensor) -> torch.Tensor:
    """(O, Cin, 3, 3, 3) -> (27·Cin, O), the fp32 kernel's rows: (kT, kH,
    kW, Cin) x O."""
    return weight.permute(2, 3, 4, 1, 0).reshape(-1, weight.shape[0])


def tile_plan(b: int, t_out: int, h_out: int, w_out: int, sms: int,
              workers_per_block: int) -> dict:
    """The kernel's schedule: ``n_wt`` tiles of TILE_W columns an output
    row, ``n_tiles`` over (b, t, h), ``grid`` persistent blocks (one an
    SM) of ``workers_per_block`` workers; worker k (warpgroup k % wpb of
    block k // wpb) takes tiles k, k + workers, k + 2·workers, ..."""
    n_wt = -(-w_out // TILE_W)
    n_tiles = b * t_out * h_out * n_wt
    grid = max(1, min(-(-n_tiles // workers_per_block), sms))
    return dict(n_wt=n_wt, n_tiles=n_tiles, grid=grid,
                workers=grid * workers_per_block)


def tile_origin(idx: int, n_wt: int, t_out: int, h_out: int,
                w_out: int) -> tuple:
    """Tile ``idx`` -> (b, t_out, h_out, first column, pixels): the
    kernel's ``decode``.  Frames run inside rows, so the tiles in flight
    at once read the same input rows (each is read by 3 frames × 3 rows of
    output) while they are in L2."""
    wt, rest = idx % n_wt, idx // n_wt
    to, rest = rest % t_out, rest // t_out
    ho, b = rest % h_out, rest // h_out
    w0 = wt * TILE_W
    return b, to, ho, w0, min(TILE_W, w_out - w0)


def stem_conv3d(x: torch.Tensor, weight: torch.Tensor,
                bias: Optional[torch.Tensor], spec) -> torch.Tensor:
    """The stem conv of a contiguous (B, T, H, W, Cin) tensor,
    differentiable in the weight and the bias (and in x on the CPU).

    A CPU tensor takes the plain versions forward and backward; a CUDA
    tensor launches K3 forward and K3.bwd backward, or raises; a CUDA x
    that needs a gradient is refused (there is no dx kernel: the stem's
    input is the pixels)."""
    if x.device.type != "cpu":
        _build.refuse_gradient("stem_conv3d (K3)", "a dx of the pixel stem",
                               x)
    return _Stem.apply(spec, x, weight, bias)


class _Stem(torch.autograd.Function):
    """K3 and K3.bwd, or their plain versions on a CPU tensor."""

    @staticmethod
    def forward(ctx, spec, x, weight, bias):
        ctx.spec = spec
        ctx.dtypes = (weight.dtype, None if bias is None else bias.dtype)
        ctx.save_for_backward(x, weight)
        if x.device.type == "cpu":
            return stem_conv3d_plain(x, weight, bias, spec)
        return _launch(x, weight, bias, spec)

    @staticmethod
    def backward(ctx, dy):
        x, weight = ctx.saved_tensors
        need_x, need_w, need_b = ctx.needs_input_grad[1:4]
        dx = dw = db = None
        if need_w or need_b:
            dw, db = stem_conv3d_backward(x, dy, ctx.spec, with_bias=need_b)
            dw = dw.to(ctx.dtypes[0]) if need_w else None
            db = db.to(ctx.dtypes[1]) if need_b else None
        if need_x:  # the CPU only: forward refuses it on the card
            with torch.enable_grad():
                xr = x.detach().requires_grad_()
                y = stem_conv3d_plain(xr, weight.detach(), None, ctx.spec)
                dx, = torch.autograd.grad(y, xr, dy)
        return None, dx, dw, db


def _extents(x: torch.Tensor, spec) -> tuple:
    """(t_out, h_out, w_out) of the stem conv ``spec`` of ``x``; raises
    where K3 and K3.bwd do not take the conv."""
    if (tuple(spec.kernel) != (3, 3, 3) or tuple(spec.stride) != (1, 1, 1)
            or x.shape[-1] > MAX_CIN or spec.modes[1] != "zero"
            or spec.modes[2] != "zero"
            or any(p < 0 for pad in spec.pads for p in pad)):
        raise ValueError(f"stem_conv3d: unsupported conv (input "
                         f"{tuple(x.shape)}, spec {spec})")
    _, t, h, w, _ = x.shape
    (pt0, pt1), (ph0, ph1), (pw0, pw1) = spec.pads
    out = (t + pt0 + pt1 - 2, h + ph0 + ph1 - 2, w + pw0 + pw1 - 2)
    if min(out) < 1:
        raise ValueError(f"stem_conv3d: bad output extent for "
                         f"{tuple(x.shape)}")
    return out


def _launch(x, weight, bias, spec):
    global launches
    _build.require_cuda_layout("stem_conv3d", x, 5)
    b, t, h, w, cin = x.shape
    if weight.shape != (COUT, cin, 3, 3, 3):
        raise ValueError(f"stem_conv3d: unsupported weight "
                         f"{tuple(weight.shape)} for input {tuple(x.shape)}")
    t_out, h_out, w_out = _extents(x, spec)
    (pt0, _), (ph0, _), (pw0, _) = spec.pads
    # the weights in the kernel's layout, cast once a call (81·Cin values);
    # the bf16 kernel takes the bias in them, the fp32 kernel apart
    wd = weight.detach().to(device=x.device)
    bd = None if bias is None else bias.detach().to(device=x.device)
    if x.dtype == torch.bfloat16:
        wk, b32 = pack_weight(wd.to(torch.bfloat16), bd), None
    else:
        wk = pack_weight_fp32(wd.to(torch.float32)).contiguous()
        b32 = (torch.zeros(COUT, device=x.device) if bd is None
               else bd.to(torch.float32).contiguous())
    plan = tile_plan(b, t_out, h_out, w_out, torch.cuda.get_device_properties(
        x.device).multi_processor_count, WORKERS_PER_BLOCK[x.dtype])
    if plan["n_tiles"] + plan["workers"] >= 2 ** 31:
        raise ValueError(f"stem_conv3d: {plan['n_tiles']} tiles overflow the "
                         f"kernel's 32-bit tile index")
    y = torch.empty((b, t_out, h_out, w_out, COUT), device=x.device,
                    dtype=x.dtype)
    rc = _build.library().cvvae_stem_conv3d(
        x.data_ptr(), wk.data_ptr(), None if b32 is None else b32.data_ptr(),
        y.data_ptr(), b, t, h,
        w, cin, t_out, h_out, w_out, pt0, ph0, pw0,
        int(spec.modes[0] == "edge"), TILE_W, plan["grid"],
        _build.DTYPE_CODES[x.dtype], x.device.index or 0, _build.stream_of(x))
    _build.check(rc, "stem_conv3d")
    launches += 1
    return y


def stem_conv3d_backward(x: torch.Tensor, dy: torch.Tensor, spec,
                         with_bias: bool = True):
    """K3.bwd (``csrc/stem_bwd.cu``): dW (O, Cin, 3, 3, 3) and dbias (O,)
    (None without ``with_bias``) in fp32 for a contiguous CUDA ``x`` and
    ``dy`` of one dtype; a CPU tensor takes the plain version."""
    global bwd_launches
    if x.device.type == "cpu":
        return stem_conv3d_backward_plain(x, dy, spec, with_bias)
    _build.require_cuda_layout("stem_conv3d_backward", x, 5)
    dy = dy.contiguous()
    _build.require_cuda_layout("stem_conv3d_backward", dy, 5)
    b, t, h, w, cin = x.shape
    t_out, h_out, w_out = _extents(x, spec)
    if dy.shape != (b, t_out, h_out, w_out, COUT) or dy.dtype != x.dtype:
        raise ValueError(f"stem_conv3d_backward: dy {tuple(dy.shape)} "
                         f"{dy.dtype} is no output of x {tuple(x.shape)} "
                         f"{x.dtype}")
    if dy.data_ptr() % 16:  # the kernel reads dy in 16-byte units
        dy = dy.clone()
    plan = bwd_plan(b, t_out, h_out, w_out, torch.cuda.get_device_properties(
        x.device).multi_processor_count, x.dtype)
    if plan["n_tiles"] + plan["per"] >= 2 ** 31:
        raise ValueError(f"stem_conv3d_backward: {plan['n_tiles']} tiles "
                         f"overflow the kernel's 32-bit tile index")
    (pt0, _), (ph0, _), (pw0, _) = spec.pads
    part = torch.empty((plan["slots"], 27 * cin + 1, COUT), device=x.device,
                       dtype=torch.float32)
    dw = torch.empty((COUT, cin, 3, 3, 3), device=x.device,
                     dtype=torch.float32)
    db = torch.empty(COUT, device=x.device, dtype=torch.float32)
    rc = _build.library().cvvae_stem_conv3d_bwd(
        x.data_ptr(), dy.data_ptr(), part.data_ptr(), dw.data_ptr(),
        db.data_ptr(), b, t, h, w, cin, t_out, h_out, w_out, pt0, ph0, pw0,
        int(spec.modes[0] == "edge"), plan["tile_w"], plan["grid"],
        plan["per"],
        _build.DTYPE_CODES[x.dtype], x.device.index or 0, _build.stream_of(x))
    _build.check(rc, "stem_conv3d_backward")
    bwd_launches += 1
    return dw, (db if with_bias else None)
