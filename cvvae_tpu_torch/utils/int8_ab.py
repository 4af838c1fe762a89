"""The two choices of int8 serving that the JAX package keeps for A/B runs,
each against the port's path on one card, in turns: the JAX package's int8
edge-fast branch (``cvvae_tpu/ops/quant.py:217-255``, selected there by
``CVVAE_EDGE_FAST=1``) against K5's materialised pad, and
``no_flash_attention()`` in a quantized model, the JAX package's flash-off
wrapper for quantized programs (``cvvae_tpu/models/video_vae.py:144-157``),
against K4.  The port serves neither (ROADMAP "Not to port"): the branch
lives here only, as :func:`conv3d_int8_edge_fast`, installed in
``ops/quant.py`` for the span of :func:`edge_fast`.

    python -m cvvae_tpu_torch.utils.int8_ab [--turns 3] [--parts convs serve]

``convs``: K5 at ``CONV_CASES`` (bf16, a calibrated scale, as
``chip_smoke.k5_inputs`` makes them), the branch and the materialised path
in turns (branch, materialised, materialised, branch, ``--turns`` times):
the median and spread (max - min) of the CUDA-event readings
(``chip_smoke.time_ms``, each the median of 5 calls), the device ms of
one call (``chip_smoke.device_ms_by_group``: a trace that lost a launch
the wrappers counted is taken again, and the launches it held are shown
beside the counted ones), K5's GEMM and stage launches a call, and the
bound (``chip_smoke.bound``) and share.

``serve``: for v1 then SD3, the int8 server that ``serve.prepare`` builds
for 17x720x1280 clips (calibrated on the reference's synthetic clip), one
``/reconstruct`` (the worker's encode and decode of chip_smoke's clip,
synchronised) under each of ``VARIANTS``: wall s in turns (A B C C B A,
``--turns`` times); then each variant's device ms by kernel group and its
launches (``chip_smoke.device_ms_by_group``); its frames against the bf16
server's (PSNR over 2 max|bf16 frames|, as ``chip_smoke.py`` phase 5
takes it) and against the default variant's.  For v1 also the JAX
package's own flash case: the calibrated int8 encoder net on a
(1,17,576,576,3) tile, with K4 and inside ``no_flash_attention()``, event
ms in turns.

Needs a CUDA card and nvcc; run from the repository's root (it imports
``chip_smoke``).  Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import statistics
import sys
import time

import numpy as np
import torch

import chip_smoke
from cvvae_tpu_torch.ops import conv, quant
from cvvae_tpu_torch.ops.kernels import conv_int8 as k5

#: K5's A/B cases: (name, x (B, T, H, W, C), Cout, spec constructor,
#: stride): the v1 encoder's level-0 causal conv, an SD3 720x672 encoder
#: tile's causal conv (edge pads on every axis), the SD3 decoder's plain
#: conv at the same tile (both-sided edge pads on every axis) and the v1
#: encoder's first downsample (stride 2)
CONV_CASES = [
    ("v1_causal", (1, 17, 720, 1280, 128), 128, "v1_causal", None),
    ("sd3_causal", (1, 17, 720, 672, 128), 128, "sd3_causal", None),
    ("sd3_plain", (1, 17, 720, 672, 128), 128, "sd3_plain", None),
    ("v1_downsample", (1, 17, 720, 1280, 128), 128, "v1_downsample", True),
]
#: the served variants: name -> (edge-fast branch on, K4 allowed)
VARIANTS = {"default": (False, True), "edge_fast": (True, True),
            "no_flash": (False, False)}
#: the JAX package's own flash A/B case: the int8 v1 encoder on this tile
FLASH_TILE = (1, 17, 576, 576, 3)
#: ``ops/quant.py``'s int8 conv, the materialised pad
_MATERIALISED = quant.conv3d_int8


def _k5_zero(v, wq, sw, scale_x, bias, strides, pads, wpk=None):
    """One K5 conv with zero windows on every axis.  A W slab's conv (one
    column in, a one-column kernel, no W pad) runs with H and W swapped,
    as (B, T, 1, H, C) with the kernel's kH and kW trading places, its
    output seen back as (B, T', H', 1, O): K5 tiles its pixels along an
    output row, which a W slab holds one of.  The sums and the epilogue
    are the same, term for term.  A strided slab is copied (1/W of x)."""
    zero = ("zero",) * 3
    b, t, h, w, c = v.shape
    if (w == 1 and wq.shape[4] == 1 and not any(pads[2]) and wpk is None
            and h > 1 and wq.shape[3] <= k5.MAX_KW
            and strides[1] <= k5.MAX_SW):
        y = k5.conv3d_int8(v.contiguous().view(b, t, 1, h, c),
                           wq.transpose(3, 4), sw, scale_x, bias,
                           (strides[0], strides[2], strides[1]),
                           (pads[0], pads[2], pads[1]), zero)
        return y.view(y.shape[0], y.shape[1], y.shape[3], 1, y.shape[4])
    return k5.conv3d_int8(v.contiguous(), wq, sw, scale_x, bias, strides,
                          pads, zero, wpk)


def conv3d_int8_edge_fast(x: torch.Tensor, params, spec) -> torch.Tensor:
    """``quant.conv3d_int8`` with the JAX package's int8 edge-fast branch
    where the conv has an edge pad: ``conv._conv3d_edge_fast`` on the
    dequantized fp32 kernel with K5 (:func:`_k5_zero`) as each conv, at
    one ``scale_x`` (the calibrated one, else one ``act_scale(x)``).  The
    main conv takes the module's ``weight_q``, ``scale_w``, packed weight
    and bias (the reference quantizes the dequantized kernel again, which
    gives them back bit for bit); each slab fix quantizes its fp32 tap
    sums per channel (``quant.quantize_kernel``), has no bias, and is
    added in x's dtype into the output's boundary slice.  The slabs are
    slices of the float x, which K5.stage quantizes with the same scale:
    the reference's slices of its int8 x."""
    if not any(m == "edge" and any(p) for m, p in zip(spec.modes,
                                                      spec.pads)):
        return _MATERIALISED(x, params, spec)
    scale_x = getattr(params, "scale_x", None)
    if scale_x is None:
        scale_x = quant.act_scale(x)
    k_fp = quant.dequantize_kernel(params)

    def raw_conv(v, k, pads, strides):
        if k is k_fp:
            return _k5_zero(v, params.weight_q, params.scale_w, scale_x,
                            params.bias, strides, pads,
                            quant.packed_weight(params))
        wq, sw = quant.quantize_kernel(k)
        return _k5_zero(v, wq, sw, scale_x, None, strides, pads)

    return conv._conv3d_edge_fast(x, k_fp, spec, raw_conv=raw_conv)


@contextlib.contextmanager
def edge_fast(on: bool = True):
    """Every int8 conv of the port through :func:`conv3d_int8_edge_fast`
    while the block runs (where ``on``)."""
    quant.conv3d_int8 = conv3d_int8_edge_fast if on else _MATERIALISED
    try:
        yield
    finally:
        quant.conv3d_int8 = _MATERIALISED


def int8_conv_module(wq, sw, b, sx=None):
    """A quantized conv's parameters as ``ops/quant.py`` reads them: the
    buffers ``weight_q``, ``scale_w``, ``bias`` and, where ``sx`` is
    given, the calibrated ``scale_x``."""
    m = torch.nn.Module()
    m.register_buffer("weight_q", wq)
    m.register_buffer("scale_w", sw)
    m.register_buffer("bias", b)
    if sx is not None:
        m.register_buffer("scale_x", sx)
    return m


def _spread(readings):
    return dict(median=statistics.median(readings),
                spread=max(readings) - min(readings), readings=readings)


@contextlib.contextmanager
def setting(on: bool, flash: bool = True):
    """The edge-fast branch installed where ``on`` (:func:`edge_fast`), and
    K4 allowed or not (``no_flash_attention``)."""
    from cvvae_tpu_torch.ops import attention

    with edge_fast(on), (contextlib.nullcontext() if flash
                         else attention.no_flash_attention()):
        yield


def in_turns(fns, turns: int, timer):
    """{name: readings} of ``fns`` timed by ``timer`` in turns, forward
    then back, ``turns`` times."""
    out = {n: [] for n in fns}
    for _ in range(turns):
        for n in list(fns) + list(fns)[::-1]:
            out[n].append(timer(fns[n]))
    return out


def profiled(fn):
    """(device ms by kernel group, the largest first, their sum, {kernel
    key: (launches the trace held, launches counted)}) of one call of
    ``fn``, by ``chip_smoke.device_ms_by_group``."""
    groups, held = chip_smoke.device_ms_by_group(fn)
    if not groups:
        raise SystemExit("int8_ab: the profiler recorded no device event")
    return groups, sum(groups.values()), held


def convs(dev, turns: int, smi: str):
    rows = []
    for name, shape, cout, ctor, down in CONV_CASES:
        spec = (conv.Conv3DSpec.v1_downsample(down) if down is not None
                else getattr(conv.Conv3DSpec, ctor)())
        x, wq, sw, sx, b = chip_smoke.k5_inputs(shape, cout, spec.kernel, dev,
                                                torch.bfloat16)
        module = int8_conv_module(wq, sw, b, sx)
        fns = {}
        for label, on in (("edge_fast", True), ("materialised", False)):
            def fn(on=on):
                with edge_fast(on):
                    return quant.conv3d_int8(x, module, spec)
            fns[label] = fn
        launches = {}
        for label, fn in fns.items():
            fn()
            torch.cuda.synchronize()
            before = k5.launches, k5.stage_launches
            fn()
            launches[label] = (k5.launches - before[0],
                               k5.stage_launches - before[1])
        ms = in_turns(fns, turns, chip_smoke.time_ms)
        b_ms, by = chip_smoke.bound("K5", shape, torch.bfloat16, cout=cout,
                                    kernel=spec.kernel, stride=spec.stride,
                                    pads=spec.pads)
        row = dict(name=name, shape=list(shape), cout=cout, bound_ms=b_ms,
                   bound_by=by, card=smi)
        for label, fn in fns.items():
            groups, total, held = profiled(fn)
            row[label] = dict(event_ms=_spread(ms[label]), device_ms=total,
                              device_ms_by_group=groups, held=held,
                              launches=list(launches[label]),
                              share=b_ms / statistics.median(ms[label]))
        print(f"[int8_ab] conv {name} {shape}->{cout} bf16: " + "; ".join(
            f"{label} event ms {r['event_ms']['median']!r} +- "
            f"{r['event_ms']['spread']!r} (device {r['device_ms']!r}, by "
            f"group {json.dumps(r['device_ms_by_group'])}, launches held, "
            f"counted {json.dumps(r['held'])}; K5 GEMMs, stages "
            f"{tuple(r['launches'])}, share {r['share']!r})"
            for label, r in ((k, row[k]) for k in fns))
            + f"; bound {b_ms!r} ms ({by}); card {smi}", flush=True)
        rows.append(row)
        del x, module, fns
        torch.cuda.empty_cache()
    return rows


def _psnr(got, ref, peak):
    mse = float(((got.double() - ref.double()) ** 2).mean())
    return 10 * np.log10(peak ** 2 / mse) if mse > 0 else float("inf")


def _server(variant: str, dtype: str):
    from cvvae_tpu_torch import serve
    t, h, w = chip_smoke.SERVE_CLIP
    return serve.prepare(serve.build_argparser().parse_args(
        ["--variant", variant, "--dtype", dtype, "--height", str(h),
         "--width", str(w), "--warm_frames", str(t), "--device", "cuda",
         "--port", "0"]))


def _frames(worker, clip):
    """The /reconstruct's frames before the worker's uint8 cast."""
    with torch.inference_mode():
        x = torch.from_numpy(clip).to(worker.device)[None]
        x = x.to(worker.dtype) / 127.5 - 1.0
        return worker.vae.decode(worker.vae.encode(x).mode())[0].float().cpu()


def serve_variants(family: str, turns: int, smi: str):
    t, h, w = chip_smoke.SERVE_CLIP
    clip = np.random.RandomState(0).randint(0, 256, (t, h, w, 3),
                                            dtype=np.uint8)
    bf16 = _server(family, "bf16")
    ref = _frames(bf16.worker, clip)
    bf16.server_close()
    bf16.worker.vae = None
    del bf16
    torch.cuda.empty_cache()
    peak = 2 * ref.abs().max().item()

    server = _server(family, "int8")
    worker = server.worker
    fns = {}
    for name, (on, flash) in VARIANTS.items():
        def request(on=on, flash=flash):
            with setting(on, flash):
                out = worker.run("reconstruct", clip)
            torch.cuda.synchronize()
            return out
        fns[name] = request

    def wall(fn):
        t0 = time.perf_counter()
        fn()
        return time.perf_counter() - t0

    for fn in fns.values():
        fn()
    walls = in_turns(fns, turns, wall)
    out = dict(family=family, card=smi, variants={})
    default = None
    for name, (on, flash) in VARIANTS.items():
        groups, total, held = profiled(fns[name])
        with setting(on, flash):
            frames = _frames(worker, clip)
        if default is None:
            default = frames
        row = dict(request_s=_spread(walls[name]), device_ms=total,
                   device_ms_by_group=groups, held=held,
                   psnr_vs_bf16=_psnr(frames, ref, peak),
                   psnr_vs_default=_psnr(frames, default, peak))
        out["variants"][name] = row
        print(f"[int8_ab] serve {family} int8 {name}: request s "
              f"{row['request_s']['median']!r} +- "
              f"{row['request_s']['spread']!r}; device {total!r} ms, by "
              f"group {json.dumps(groups)}; launches held, counted "
              f"{json.dumps(held)}; PSNR vs bf16 {row['psnr_vs_bf16']!r} "
              f"dB, vs default {row['psnr_vs_default']!r} dB; card {smi}",
              flush=True)
    if family == "v1":
        out["flash_tile"] = flash_tile(worker.vae, turns, smi)
    server.server_close()
    worker.vae = None
    return out


def flash_tile(vae, turns: int, smi: str):
    """The JAX package's own flash A/B case: the int8 v1 encoder net on a
    ``FLASH_TILE`` clip, with K4 and inside ``no_flash_attention()``."""
    from cvvae_tpu_torch.ops.kernels import attention

    x = chip_smoke.randn(FLASH_TILE, 70, vae.device, vae.dtype).clamp(-1, 1)
    fns = {}
    for name, flash in (("k4", True), ("no_flash", False)):
        def fn(flash=flash):
            with torch.inference_mode(), setting(False, flash):
                return vae.encoder(x)
        fns[name] = fn
    before = attention.launches
    fns["k4"]()
    k4 = attention.launches - before
    ms = in_turns(fns, turns, chip_smoke.time_ms)
    with torch.inference_mode():
        a, b = fns["k4"]().float(), fns["no_flash"]().float()
    row = dict(tile=list(FLASH_TILE), k4_launches=k4, card=smi,
               **{n: _spread(v) for n, v in ms.items()},
               psnr=_psnr(a, b, 2 * b.abs().max().item()))
    print(f"[int8_ab] flash A/B: int8 v1 encoder net on {FLASH_TILE}: with "
          f"K4 ({k4} launches) {row['k4']['median']!r} +- "
          f"{row['k4']['spread']!r} ms, no_flash_attention "
          f"{row['no_flash']['median']!r} +- {row['no_flash']['spread']!r} "
          f"ms; moments PSNR {row['psnr']!r} dB; card {smi}", flush=True)
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--turns", type=int, default=3)
    ap.add_argument("--parts", nargs="+", default=["convs", "serve"],
                    choices=["convs", "serve"])
    ap.add_argument("--out", default=None, help="also write the rows here "
                    "as JSON")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("int8_ab: needs a CUDA card")
    from cvvae_tpu_torch.ops.kernels import _build
    _build.library()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = chip_smoke.nvidia_smi_line()
    dev = torch.device("cuda", 0)
    rows = {}
    if "convs" in args.parts:
        rows["convs"] = convs(dev, args.turns, smi)
    if "serve" in args.parts:
        rows["serve"] = [serve_variants(f, args.turns, smi)
                         for f in ("v1", "sd3")]
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
