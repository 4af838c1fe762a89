"""The yardstick's arithmetic: the card's published peaks, each kernel's
operations and bytes a call, and the kernel groups a profile books device
time under.

``work`` is a frozen copy of the kernel work functions of the repository's
``chip_smoke.py`` (its ``work``, for the kernels a served request runs),
and ``GROUPS`` of ``cvvae_tpu_torch/utils/profiling.py``'s table, kept
here so that a change to the program does not move the yardstick: a
later change that fuses or replaces a kernel still faces the same work.
"""

from __future__ import annotations

import math
import re

#: NVIDIA H100 SXM data sheet, dense: HBM bytes/s and operations/s by the
#: type of the products' inputs
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {"bf16": 989e12, "fp32": 67e12, "int8": 1979e12}
#: bytes an element
ELEMENT_BYTES = {"bf16": 2, "fp32": 4, "int8": 1}

#: K5's staged tensor: input channels rounded up to the GEMM's K chunk
K5_K_CHUNK = 128

#: kernel-name patterns -> group (first match wins)
GROUPS = [
    ("K4.bwd flash attention backward", r"flash_bwd|\browdot\b"),
    ("K4 flash attention", r"flash_fwd"),
    ("K1.bwd GroupNorm+SiLU backward", r"\bgn_bwd\b"),
    ("K1.partial split GroupNorm moments", r"\bgn_partial(_fold)?\b"),
    ("K1.combine split GroupNorm combination", r"\bgn_combine(_coef)?\b"),
    ("K1 GroupNorm+SiLU", r"gn_stats|gn_merge|gn_apply"),
    ("K1.int8 GroupNorm+SiLU on int8",
     r"\bgnq_(stats|merge|apply|apply_arith)\b"),
    ("K2.bwd subpixel interleave backward",
     r"subpixel_unshuffle|\bbias_grad\b"),
    ("K2 subpixel interleave", r"subpixel|interleave"),
    ("K3.bwd stem conv backward", r"stem_bwd"),
    ("K3 stem conv", r"stem"),
    ("K5.gemm int8 GEMM", r"int8_gemm"),
    ("K5.stage int8 staging", r"int8_stage"),
    ("K6 int8 residual add", r"\bqflow_add(_sliced)?\b"),
    ("K6.requant int8 requantization", r"\bqflow_requant\b"),
    ("GEMMs (dense, attention)", r"xmma_gemm|nvjet|cublas|gemv"),
    ("cuDNN convs", r"xmma|implicit_gemm|conv|cudnn|cutlass|fprop|wgrad"),
    ("replicate pads", r"replication_pad"),
    ("zero pads", r"constant_pad"),
    ("layout copies", r"copy|CatArray|cat_"),
    ("GEMMs (dense, attention)", r"gemm|sm90_|ampere_|cublas"),
    ("softmax", r"(?i)softmax"),
    ("reductions (norm moments)", r"reduce_kernel"),
    ("elementwise", r"elementwise|Functor|vectorized"),
    ("device copies (memcpy DtoD)", r"Memcpy DtoD"),
    ("host<->device copies", r"Memcpy|memcpy"),
]
_COMPILED = [(g, re.compile(p)) for g, p in GROUPS]


def group_of(kernel: str) -> str:
    """The group a device event's name falls in ("other" if none)."""
    return next((g for g, pat in _COMPILED if pat.search(kernel)), "other")


def out_extents(shape, kernel, stride, pads):
    """(T', H', W') of a conv of (B, T, H, W, C) ``shape``."""
    return tuple((n + lo + hi - k) // s + 1 for n, k, s, (lo, hi)
                 in zip(shape[1:4], kernel, stride, pads))


def staged_shape(shape, pads, sw: int = 1) -> tuple:
    """K5.stage's output (B, T + pT, H + pH, W', Cp): W + pW rounded up to
    a multiple of the W stride, Cin to the K chunk."""
    b, t, h, w, c = shape
    (t0, t1), (h0, h1), (w0, w1) = pads
    return (b, t + t0 + t1, h + h0 + h1, -(-(w + w0 + w1) // sw) * sw,
            -(-c // K5_K_CHUNK) * K5_K_CHUNK)


def work(key, shape, dtype, silu=True, cout=128, kernel=None, stride=None,
         pads=None):
    """(bytes, operations) of one call of kernel ``key`` on a (B, T, H, W,
    C) ``shape`` in ``dtype`` ("bf16" or "fp32"): each input read once and
    each output written once.

    K1: x in, y out, fp32 weight and bias; 3 operations an element for the
    moments, 2 for the affine, 4 more with SiLU.  K5 (the GEMM): x in and
    the output out in x's dtype, the int8 kernel, fp32 scales and bias;
    2 * taps * Cin int8 operations an output value, ``cout`` channels, a
    ``kernel`` at ``stride`` with ``pads``.  K5.stage: x in, the staged
    int8 tensor out; one division an input value."""
    e = ELEMENT_BYTES[dtype]
    numel = math.prod(shape)
    if key == "K1":
        return 2 * numel * e + 2 * shape[-1] * 4, numel * (5 + 4 * silu)
    if key == "K5":
        out = math.prod(out_extents(shape, kernel, stride, pads)) \
            * shape[0] * cout
        taps = math.prod(kernel)
        return ((numel + out) * e + cout * shape[-1] * taps + 8 * cout,
                out * 2 * shape[-1] * taps)
    if key == "K5.stage":
        return (numel * e + math.prod(staged_shape(shape, pads, stride[2]))
                + 4, numel)
    raise KeyError(key)


def bound_s(key, shape, dtype, **kw) -> float:
    """The least seconds a call of ``key`` takes on the card: the larger of
    its bytes over the HBM rate and its operations over the peak of their
    type (K5's products are int8, K5.stage's divisions fp32)."""
    nbytes, ops = work(key, shape, dtype, **kw)
    peak = PEAK_OPS[{"K5": "int8", "K5.stage": "fp32"}.get(key, dtype)]
    return max(nbytes / HBM_BYTES_PER_S, ops / peak)
