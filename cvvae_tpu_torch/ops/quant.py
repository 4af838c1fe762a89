"""int8 quantized inference for the conv stack.

Port of ``cvvae_tpu/ops/quant.py``.  The scheme, post-training and
symmetric:

* weights: int8 per output channel, ``scale_w[o] = max|w[o]| / 127``,
  computed once by :func:`quantize_conv_params`;
* activations: int8 per tensor, with a static scale calibrated on a clip
  (``scale_x``, :func:`attach_activation_scales`) or, without one, a
  dynamic ``max|x| / 127`` taken right before the conv;
* the s8·s8 products summed in int32, the sum dequantised by
  ``scale_x * scale_w[o]`` (their product in fp32), the bias added in fp32
  and the result cast to the activation dtype.  GroupNorm, SiLU,
  attention and the resampling stay in the activation dtype.

A conv is quantized when its kernel is 5-D with ``C_in >= min_cin``
(64), ``C_out >= min_cout`` (16) and more than one tap: the pixel stem,
the RGB and latent heads and the 1×1×1 shortcuts stay in float.

On a CUDA tensor the int8 conv is the hand-written kernel K5
(``ops/kernels/conv_int8.py``) in the reference's steps: a staging pass
quantizes the activation and materialises its pads on the int8 tensor (as
the default path of the reference's ``conv3d_int8`` does), then an s8
GEMM reads a window of it.  The reference's other branch
(``EDGE_FAST_SPACE``, off by default) is not ported: K5.stage pads in the
quantizing pass it runs anyway, and on an H100 the branch was slower at
every conv and served path measured (``utils/int8_ab.py``, which holds
it for that A/B; PERF.md §5).  K5's packed kernel
is built once per module at first use (:func:`packed_weight`) and kept as
a non-persistent buffer, never in the state dict, and built again when
the int8 kernel it came from changes (:func:`derived`).

Below ``INT8_MIN_POSITIONS`` positions (T·H·W) a quantized conv runs in
float on the dequantized kernel, as the reference does, so the two
compute the same function at every shape.
"""

from __future__ import annotations

import contextlib
import weakref
from typing import Callable, Dict, Optional, Tuple

import torch
from torch import nn

from cvvae_tpu_torch.ops.kernels import conv_int8 as k5
from cvvae_tpu_torch.parallel import shard
from cvvae_tpu_torch.utils import spans

#: T*H*W below which a quantized conv runs in float on the dequantized
#: kernel (the reference's threshold, ``cvvae_tpu/ops/quant.py:50``; the
#: port keeps it so that both compute the same function)
INT8_MIN_POSITIONS = 5 * 64 * 64


def _over_127(t: torch.Tensor) -> torch.Tensor:
    """t / 127 rounded as one division on every device: PyTorch's CUDA
    division by a Python number multiplies by its rounded reciprocal,
    which can differ from the CPU's quotient in the last bit."""
    return t / t.new_tensor(127.0)


def quantize_kernel(weight: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(O, I, kT, kH, kW) float -> (int8 kernel, fp32 per-O scale)."""
    w = weight.float()
    scale = _over_127(w.abs().amax(dim=(1, 2, 3, 4)))
    scale = torch.clamp_min(scale, 1e-12)
    wq = torch.clamp(torch.round(w / scale[:, None, None, None, None]),
                     -127, 127).to(torch.int8)
    return wq, scale


def dequantize_kernel(params) -> torch.Tensor:
    """Inverse of quantize_kernel (fp32) for a module holding
    ``weight_q`` and ``scale_w``."""
    return params.weight_q.float() * params.scale_w[:, None, None, None, None]


def quantize_act(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dynamic symmetric per-tensor int8: (int8 x, fp32 scale)."""
    scale = act_scale(x)
    return quantize_act_static(x, scale), scale


def act_scale(x: torch.Tensor) -> torch.Tensor:
    """The dynamic scale of ``x``: max(max|x| / 127, 1e-12), an fp32
    scalar tensor on x's device (one reduction, no host sync).  In a net
    call split over a mesh, max|x| is taken over every rank's part of the
    tensor (an all-reduce MAX), so every shard quantizes by the scale the
    unsplit tensor has."""
    m = x.float().abs().amax()
    ctx = shard.current()
    if ctx is not None:
        m = ctx.max(m)
    return torch.clamp_min(_over_127(m), 1e-12)


def quantize_act_static(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Symmetric int8 with a given scale; divides by it, as the reference
    does (a reciprocal would round differently)."""
    return torch.clamp(torch.round(x.float() / scale), -127, 127).to(torch.int8)


# ---------------------------------------------------------------------------
# activation-scale calibration
# ---------------------------------------------------------------------------

_CALIB: Optional[Dict[nn.Module, float]] = None


@contextlib.contextmanager
def calibration_scope():
    """Record each quantized conv's max|x| into the yielded dict, keyed by
    the conv's module; apply :func:`attach_activation_scales` after."""
    global _CALIB
    prev = _CALIB
    _CALIB = {}
    try:
        yield _CALIB
    finally:
        _CALIB = prev


def maybe_record_act(params: nn.Module, x: torch.Tensor) -> None:
    """Inside a calibration_scope, record max|x| (taken in fp32) for this
    conv; a no-op otherwise.  Calibration runs unsharded (``quantize``
    comes before ``with_mesh``)."""
    if _CALIB is None:
        return
    if shard.current() is not None:
        raise ValueError("calibrate before with_mesh: a shard holds part "
                         "of each activation")
    m = float(x.float().abs().amax())
    _CALIB[params] = max(_CALIB.get(params, 0.0), m)


def attach_activation_scales(calib: Dict[nn.Module, float], *,
                             margin: float = 1.1) -> None:
    """Give every conv recorded in ``calib`` a ``scale_x`` buffer,
    ``max(recorded_max * margin / 127, 1e-12)`` taken in Python floats and
    stored as an fp32 scalar, as the reference rounds it.  Values beyond
    the calibrated range clip at ±127 when served."""
    for module, m in calib.items():
        scale = max(m * margin / 127.0, 1e-12)
        module.register_buffer("scale_x", torch.tensor(
            scale, dtype=torch.float32, device=module.weight_q.device))


def conv_int8(x: torch.Tensor, scale_x: torch.Tensor, kernel_fp: torch.Tensor,
              pads, modes, stride=(1, 1, 1)) -> torch.Tensor:
    """int8 conv of ``x`` quantized with ``scale_x`` and a float kernel
    (O, I, kT, kH, kW) quantized here per channel (the reference's helper
    for derived kernels), no bias, output in x's dtype.  The upsample's
    phases take K5's staged form instead (``ops/upsample_conv.py``)."""
    wq, scale_w = quantize_kernel(kernel_fp)
    return k5.conv3d_int8(x, wq, scale_w, scale_x, None, stride, pads, modes)


def derived(params, name: str,
            build: Callable[[], torch.Tensor]) -> torch.Tensor:
    """The non-persistent buffer ``name`` of a quantized conv, ``build()``
    from its ``weight_q`` and ``scale_w``.  It is kept while those are the
    same tensors at the same version and address, and built again when
    one changes: ``load_state_dict`` copies into them (a new version), a
    move to another device or an assignment replaces them."""
    src = [(weakref.ref(t), t._version, t.data_ptr())
           for t in (params.weight_q, params.scale_w)]
    made = params.__dict__.setdefault("_derived_from", {})
    old = made.get(name)
    buf = params._buffers.get(name)
    if buf is None or old is None or any(
            r0() is not r1() or v0 != v1 or p0 != p1
            for (r0, v0, p0), (r1, v1, p1) in zip(old, src)):
        buf = build()
        params.register_buffer(name, buf, persistent=False)
        made[name] = src
    return buf


def packed_weight(params) -> Optional[torch.Tensor]:
    """K5's B (``conv_int8.pack_weight``) of a quantized conv on the card,
    the non-persistent buffer ``k5_wpk`` (:func:`derived`); None on the
    CPU, whose plain version reads ``weight_q``."""
    if params.weight_q.device.type == "cpu":
        return None
    return derived(params, "k5_wpk",
                   lambda: k5.pack_weight(params.weight_q))


def _eligible(m: nn.Module, min_cin: int, min_cout: int) -> bool:
    w = m._parameters.get("weight")
    return (w is not None and w.ndim == 5 and w.shape[1] >= min_cin
            and w.shape[0] >= min_cout
            and w.shape[2] * w.shape[3] * w.shape[4] > 1)


def quantize_conv_params(model: nn.Module, *, min_cin: int = 64,
                         min_cout: int = 16,
                         skip_paths: Tuple[str, ...] = ()) -> nn.Module:
    """Quantize ``model``'s eligible convs in place and return it: each
    module holding a 5-D ``weight`` (O, I, kT, kH, kW) with I >= min_cin,
    O >= min_cout and more than one tap loses it and gains the buffers
    ``weight_q`` (int8, same shape) and ``scale_w`` (O,) fp32; its ``bias``
    stays.  A module whose path has a segment containing any string of
    ``skip_paths`` stays float (list indices are not matched, as the
    reference walks only dict keys)."""
    for name, m in list(model.named_modules()):
        segments = [s for s in name.split(".") if not s.isdigit()]
        if any(s in seg for s in skip_paths for seg in segments):
            continue
        if not _eligible(m, min_cin, min_cout):
            continue
        wq, scale = quantize_kernel(m.weight.detach())
        del m.weight
        m.register_buffer("weight_q", wq)
        m.register_buffer("scale_w", scale)
    return model


def is_quantized(params) -> bool:
    return hasattr(params, "weight_q")


def load_quantized_state(model: nn.Module, state: Dict[str, torch.Tensor]):
    """Load a quantized model's ``state_dict`` (or one converted from a
    quantized JAX tree) into ``model``, already quantized the same way,
    with ``strict=True``: the convs that carry a ``scale_x`` in ``state``
    gain the buffer first."""
    for key in state:
        if key.endswith(".scale_x"):
            m = model.get_submodule(key[:-len(".scale_x")])
            m.register_buffer("scale_x", torch.zeros(
                (), dtype=torch.float32, device=m.weight_q.device))
    model.load_state_dict(state, strict=True)
    return model


def conv3d_int8(x: torch.Tensor, params, spec) -> torch.Tensor:
    """The quantized conv with the padding of ``spec``: x (B,T,H,W,C) ->
    (B,T',H',W',O) in x's dtype.  The activation scale is the calibrated
    ``scale_x`` where the conv has one, else the dynamic one."""
    with spans.span("cvvae.op.conv3d_int8"):
        scale_x = getattr(params, "scale_x", None)
        if scale_x is None:
            scale_x = act_scale(x)
        return k5.conv3d_int8(x, params.weight_q, params.scale_w, scale_x,
                              params.bias, spec.stride, spec.pads,
                              spec.modes, packed_weight(params))
