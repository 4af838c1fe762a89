"""int8 activation *residency*: activations kept in int8 between ops.

Port of ``cvvae_tpu/ops/qflow.py``, its public surface and its function.
The calibrated int8 mode (``ops/quant.py``) quantizes only inside each
conv; every tensor between ops stays bf16.  Here they stay int8:

* :class:`QTensor`: an int8 tensor and its fp32 scale, a scalar or one a
  channel of the last axis;
* :func:`dequant` / :func:`requant`: to and from float (requant divides
  and rounds half to even, clipped to ±127);
* :func:`qconv3d`: the int8 conv of an int8 activation with a scalar
  scale, its epilogue requantizing per output channel (``out_scale``) or
  writing ``out_dtype``; :func:`qconv3d_fold` folds a per-channel input
  scale into the float kernel first and quantizes that per channel;
* :func:`qgroup_norm_silu`: GroupNorm + SiLU reading int8 (dequantized in
  registers) and writing int8 at the consumer's scale, or float;
* :func:`qadd`: the residual add in fp32, requantized.

Parameters are mappings of the port's leaf names (a conv's ``weight_q``
(O, I, kT, kH, kW) int8, ``scale_w`` (O,), ``bias``; a norm's ``weight``
and ``bias``), such as ``utils/convert.from_jax_params`` gives, which
also carries the calibrated residency scales (``scale_y``, ``scale_res``,
``scale_entry``, ``scale_up``).  A conv's mapping may hold ``k5_wpk``,
K5's packed kernel (``conv_int8.pack_weight``), so a call does not pack it.

On a CPU tensor every function runs its plain version; on a CUDA tensor
it launches the kernels (K5 staging the int8 input and writing int8 or
``out_dtype``, K1's int8 mode, K6's requantization and residual add) or
raises.  ``qconv3d_fold``'s weight fold and per-channel quantization of
the small float kernel are PyTorch ops on either device.  ``dequant`` is
one PyTorch expression, for a chain's end.  The module is wired into no
serving path, as the JAX package's is not.
"""

from __future__ import annotations

from typing import Mapping, NamedTuple, Optional

import torch

from cvvae_tpu_torch.ops.kernels import conv_int8 as k5
from cvvae_tpu_torch.ops.kernels import groupnorm as k1
from cvvae_tpu_torch.ops.kernels import qflow as k6


class QTensor(NamedTuple):
    """int8 activation + fp32 scale (a scalar, or one a last-axis channel)."""

    q: torch.Tensor       # int8, (..., C)
    scale: torch.Tensor   # fp32, () or (C,)

    @property
    def shape(self):
        return self.q.shape

    @property
    def ndim(self):
        return self.q.ndim


def dequant(x: QTensor, dtype=torch.float32) -> torch.Tensor:
    return (x.q.float() * x.scale.to(device=x.q.device,
                                     dtype=torch.float32)).to(dtype)


def requant(xf: torch.Tensor, scale: torch.Tensor) -> QTensor:
    """Float -> int8 at ``scale`` (K6 on the card)."""
    return QTensor(k6.requant(xf, scale), scale)


def _qconv(x: QTensor, weight_q, scale_w, scale_x, bias, spec, out_scale,
           out_dtype, wpk=None):
    """K5 from the int8 activation (``conv_int8.conv3d_int8_resident``),
    writing int8 at ``out_scale`` or ``out_dtype``."""
    return k5.conv3d_int8_resident(
        x.q, weight_q, scale_w, scale_x, bias, spec.stride, spec.pads,
        spec.modes, wpk,
        out_dtype=None if out_scale is not None else out_dtype,
        out_scale=out_scale)


def _wrap(y, out_scale):
    return y if out_scale is None else QTensor(y, out_scale)


def qconv3d(x: QTensor, params: Mapping[str, torch.Tensor], spec, *,
            out_scale: Optional[torch.Tensor] = None,
            out_dtype=torch.bfloat16):
    """int8 conv on an int8-resident activation.

    ``x.scale`` must be a scalar (GroupNorm emits at the conv's calibrated
    per-tensor ``scale_x``).  With ``out_scale`` (fp32 (C_out,)) the
    epilogue requantizes and the result stays int8-resident (a QTensor);
    without it the conv writes ``out_dtype``."""
    if x.scale.ndim != 0:
        raise ValueError("qconv3d input must carry a per-tensor scale")
    y = _qconv(x, params["weight_q"], params["scale_w"], x.scale,
               params.get("bias"), spec, out_scale, out_dtype,
               params.get("k5_wpk"))
    return _wrap(y, out_scale)


def qconv3d_fold(x: QTensor, kernel_fp: torch.Tensor,
                 bias: Optional[torch.Tensor], spec, *,
                 out_scale: Optional[torch.Tensor] = None,
                 out_dtype=torch.bfloat16):
    """int8 conv of an input with a PER-CHANNEL scale: the scale is folded
    into the float kernel ``kernel_fp`` (O, I, kT, kH, kW) (w'[o, c] =
    w[o, c] * s_in[c]), which is then quantized per output channel
    (max|w'| / 127, at least 1e-12) — kernels are tiny next to the
    activations.  Used by the nin shortcut and the upsample phase convs,
    whose inputs are residual-stream QTensors."""
    sin = x.scale.to(device=x.q.device, dtype=torch.float32)
    w = kernel_fp.to(device=x.q.device, dtype=torch.float32)
    if sin.ndim:
        w = w * sin.reshape(1, -1, 1, 1, 1)
        s_eff = torch.ones((), dtype=torch.float32, device=x.q.device)
    else:
        s_eff = sin
    # divided by a tensor 127: a CUDA division by a Python number
    # multiplies by its reciprocal
    sw = torch.clamp_min(w.abs().amax(dim=(1, 2, 3, 4)) / w.new_tensor(127.0),
                         1e-12)
    wq = torch.clamp(torch.round(w / sw.reshape(-1, 1, 1, 1, 1)), -127,
                     127).to(torch.int8)
    y = _qconv(x, wq, sw, s_eff, bias, spec, out_scale, out_dtype)
    return _wrap(y, out_scale)


def qgroup_norm_silu(x: QTensor, params: Mapping[str, torch.Tensor], *,
                     num_groups: int, eps: float,
                     out_scale: Optional[torch.Tensor] = None,
                     out_dtype=torch.bfloat16):
    """GroupNorm + SiLU reading an int8-resident tensor (K1's int8 mode on
    the card): fp32 one-pass moments of the dequantized values, the
    dequant folded into the affine, SiLU in fp32, requantized to
    ``out_scale`` (the consuming conv's calibrated per-tensor scale_x), or
    ``out_dtype`` without one."""
    y = k1.group_norm_silu_int8(
        x.q, x.scale, params["weight"], params["bias"],
        num_groups=num_groups, eps=eps, out_scale=out_scale,
        out_dtype=out_dtype)
    return _wrap(y, out_scale)


def qadd(x: QTensor, h: QTensor, out_scale: torch.Tensor) -> QTensor:
    """Residual add in fp32, requantized (per channel) at ``out_scale``."""
    return QTensor(k6.qadd(x.q, x.scale, h.q, h.scale, out_scale), out_scale)
