"""Checkpoints -> the port's ``state_dict``.

Two sources:

* **A JAX params tree** (``from_jax_params``), the inverse of
  ``cvvae_tpu/utils/convert.py:59-78``.  The port's module paths follow
  the JAX params tree, so conversion is a path join plus a per-tensor
  layout change:

  - a conv kernel (kT, kH, kW, I, O)       -> weight (O, I, kT, kH, kW)
    (a per-frame kernel (1, kH, kW, I, O)  -> a Conv3d weight (O, I, 1, kH, kW))
  - a dense kernel (I, O)                  -> weight (O, I)
  - a norm's scale / bias                  -> its weight / bias
  - a quantized conv's kernel_q (kT, kH, kW, I, O) int8 -> weight_q
    (O, I, kT, kH, kW); its scale_w and scale_x as they are

* **The reference's checkpoints** (``convert_state_dict``,
  ``load_reference_checkpoint``, ``load_torch_checkpoint_file``): HF
  ``from_pretrained`` directories (config.json + *.safetensors) of
  ``vae3d``, ``vae3d_v1-1`` (CVVAEModel) and ``vae3d_sd3``
  (CVVAESD3Model), or Lightning ``.ckpt`` / raw ``.pt`` state dicts.  Keys
  go through the JAX package's path rewrites (its copy below; the port
  imports nothing of it); tensors keep the reference's torch layout
  except where the port's module differs:

  - Conv3d (O, I, kT, kH, kW)     -> as it is
  - Conv2d (O, I, kH, kW)         -> (O, I, 1, kH, kW) (a per-frame conv)
  - a dense 1x1 Conv2d (O, I, 1, 1) -> (O, I); a Linear (O, I) as it is
  - a norm's weight / bias        -> as they are

Load the result with ``load_state_dict(..., strict=True)`` so that a key
missed on either side fails; a quantized tree loads with
``ops.quant.load_quantized_state`` into a model quantized the same way
(``VideoVAE.quantize()``), also strictly.

``.safetensors`` files are read by the ``safetensors`` package, imported
at first use.
"""

from __future__ import annotations

import json
import os
import re
from typing import Dict, List, Tuple

import numpy as np
import torch


def _convert_leaf(leaf: str, value: np.ndarray):
    if leaf == "scale":
        return "weight", value
    if leaf == "kernel":
        if value.ndim == 5:
            return "weight", value.transpose(4, 3, 0, 1, 2)
        if value.ndim == 2:
            return "weight", value.T
        raise ValueError(f"kernel of rank {value.ndim} has no counterpart")
    if leaf == "kernel_q":
        return "weight_q", value.transpose(4, 3, 0, 1, 2)
    if leaf in ("bias", "scale_w", "scale_x"):
        return leaf, value
    raise ValueError(f"unexpected leaf {leaf!r}")


def from_jax_params(params: dict) -> Dict[str, torch.Tensor]:
    """{"encoder": ..., "decoder": ...} of array-likes -> state_dict."""
    out: Dict[str, torch.Tensor] = {}

    def visit(node, path):
        if isinstance(node, dict):
            items = node.items()
        elif isinstance(node, (list, tuple)):
            items = enumerate(node)
        else:
            name, value = _convert_leaf(path[-1], np.asarray(node))
            key = ".".join(path[:-1] + [name])
            out[key] = torch.from_numpy(np.array(value, order="C"))
            return
        for k, v in items:
            visit(v, path + [str(k)])

    visit(params, [])
    return out


# ---------------------------------------------------------------------------
# The reference's key rules (a copy of cvvae_tpu/utils/convert.py:27-56)
# ---------------------------------------------------------------------------

#: modules whose weight/bias are a norm's (GroupNorm / LayerNorm)
_NORM_NAMES = {"norm", "norm1", "norm2", "norm3", "norm_t", "norm_out",
               "conv_norm_out", "group_norm"}
#: modules that are dense whatever their torch rank (1x1 Conv2d in v1
#: attention, nn.Linear in temporal attention / SD3)
_DENSE_NAMES = {"q", "k", "v", "proj_out", "q_t", "k_t", "v_t",
                "proj_out_t", "to_q", "to_k", "to_v", "to_out"}

_PATH_REWRITES = [
    (re.compile(r"\bdownsample\.conv\."), "downsample."),
    (re.compile(r"\bupsample\.conv\."), "upsample."),
    (re.compile(r"\b(downsamplers\.\d+)\.conv\."), r"\1."),
    (re.compile(r"\b(upsamplers\.\d+)\.conv\."), r"\1."),
    (re.compile(r"\bto_out\.0\."), "to_out."),
    # diffusers GEGLU feed-forward (UNet transformer blocks)
    (re.compile(r"\bff\.net\.0\.proj\."), "ff_proj."),
    (re.compile(r"\bff\.net\.2\."), "ff_out."),
]


def _translate_key(key: str) -> Tuple[List, str, str]:
    """torch key -> (tree path, module_name, leaf name)."""
    for pat, rep in _PATH_REWRITES:
        key = pat.sub(rep, key)
    parts = key.split(".")
    leaf = parts[-1]
    path = [int(p) if p.isdigit() else p for p in parts[:-1]]
    module_name = next((p for p in reversed(path) if isinstance(p, str)), "")
    return path, module_name, leaf


def _convert_tensor(value: torch.Tensor, module_name: str, leaf: str
                    ) -> Tuple[str, torch.Tensor]:
    """A reference tensor -> (the port's leaf name, its tensor): the
    torch-layout counterpart of ``cvvae_tpu/utils/convert.py:59-78``."""
    if module_name in _NORM_NAMES or leaf != "weight":
        return leaf, value
    if module_name in _DENSE_NAMES:
        if value.ndim == 4:          # 1x1 Conv2d (O, I, 1, 1)
            value = value[:, :, 0, 0]
        return "weight", value
    if value.ndim == 4:              # Conv2d -> a per-frame Conv3d
        return "weight", value[:, :, None]
    return "weight", value           # Conv3d, Linear


def convert_state_dict(state_dict: Dict[str, object],
                       prefixes: Tuple[str, ...] = ("encoder", "decoder"),
                       dtype: torch.dtype = torch.float32
                       ) -> Tuple[Dict[str, torch.Tensor], List[str]]:
    """A reference state dict -> (the port's state dict, skipped keys).

    Keys outside ``prefixes`` are skipped and reported (the reference's
    strict=False load, lvdm/models/autoencoder.py:68-86)."""
    out: Dict[str, torch.Tensor] = {}
    skipped: List[str] = []
    for key, value in state_dict.items():
        if key.split(".", 1)[0] not in prefixes:
            skipped.append(key)
            continue
        value = torch.as_tensor(value).detach().cpu()
        path, module_name, leaf = _translate_key(key)
        name, converted = _convert_tensor(value, module_name, leaf)
        out[".".join([str(p) for p in path] + [name])] = \
            converted.to(dtype).contiguous()
    return out, skipped


# ---------------------------------------------------------------------------
# Files
# ---------------------------------------------------------------------------

def _config_from_json(cfg_json: dict):
    """Build a VideoVAEConfig from a diffusers config.json, every default
    as ``cvvae_tpu/utils/convert.py:126-176`` has it."""
    from cvvae_tpu_torch.models.vae_sd3 import VAESD3Config
    from cvvae_tpu_torch.models.vae_v1 import VAE1Config
    from cvvae_tpu_torch.models.video_vae import VideoVAEConfig

    cls_name = cfg_json.get("_class_name", "CVVAEModel")
    common = dict(
        en_de_n_frames_a_time=cfg_json.get("en_de_n_frames_a_time", 16),
        time_n_compress=cfg_json.get("time_n_compress", 4),
        spatial_n_compress=cfg_json.get("spatial_n_compress", 8),
        tile_spatial_size=cfg_json.get("tile_spatial_size", 576),
        tile_overlap_ratio=cfg_json.get("tile_overlap_ratio", 0.2222),
        num_video_frames=cfg_json.get("num_video_frames"),
    )
    if cls_name == "CVVAESD3Model":
        net = VAESD3Config(
            in_channels=cfg_json.get("in_channels", 3),
            latent_channels=cfg_json.get("out_channels", 16),
            block_out_channels=tuple(cfg_json.get(
                "block_out_channels", (128, 256, 512, 512))),
            layers_per_block=cfg_json.get("layers_per_block", 2),
            norm_num_groups=cfg_json.get("norm_num_groups", 32),
            double_z=cfg_json.get("double_z", True),
            mid_block_add_attention=cfg_json.get("mid_block_add_attention", True),
            causal_encoder=cfg_json.get("causal_encoder", True),
            causal_decoder=cfg_json.get("causal_decoder", False),
            half_3d=cfg_json.get("half_3d", True),
        )
        return VideoVAEConfig(
            family="sd3", net=net,
            scaling_factor=cfg_json.get("scaling_factor", 1.5305), **common)
    net = VAE1Config(
        z_channels=cfg_json.get("z_channels", 4),
        in_channels=cfg_json.get("in_channels", 3),
        out_ch=cfg_json.get("out_ch", 3),
        ch=cfg_json.get("ch", 128),
        ch_mult=tuple(cfg_json.get("ch_mult", (1, 2, 4, 4))),
        num_res_blocks=cfg_json.get("num_res_blocks", 2),
        attn_resolutions=tuple(cfg_json.get("attn_resolutions", ())),
        resolution=cfg_json.get("resolution", 256),
        use_3d_conv=cfg_json.get("use_3d_conv", True),
        dropout=cfg_json.get("dropout", 0.0),
        double_z=cfg_json.get("double_z", True),
        half_3d=cfg_json.get("half_3d", True),
        causal_encoder=cfg_json.get("causal_encoder", True),
        causal_decoder=cfg_json.get("causal_decoder", False),
    )
    return VideoVAEConfig(
        family="v1", net=net,
        scaling_factor=cfg_json.get("scaling_factor", 0.18215), **common)


def _read_state(path: str) -> Dict[str, torch.Tensor]:
    """A state dict file on the CPU: ``.safetensors`` through the
    ``safetensors`` package (bf16 included), anything else through
    ``torch.load`` (a Lightning checkpoint nests its state under
    "state_dict")."""
    if path.endswith(".safetensors"):
        from safetensors.torch import load_file
        return load_file(path, device="cpu")
    blob = torch.load(path, map_location="cpu", weights_only=False)
    return blob.get("state_dict", blob)


def load_reference_checkpoint(cls, path: str, dtype=torch.float32,
                              device="cuda"):
    """Load an HF-style checkpoint dir (config.json + *.safetensors) into
    a ``cls`` (VideoVAE) on ``device`` in ``dtype``, strictly."""
    with open(os.path.join(path, "config.json")) as f:
        cfg_json = json.load(f)
    config = _config_from_json(cfg_json)

    files = sorted(f for f in os.listdir(path) if f.endswith(".safetensors"))
    if not files:
        raise FileNotFoundError(f"no .safetensors files in {path}")
    state: Dict[str, torch.Tensor] = {}
    for fname in files:
        state.update(_read_state(os.path.join(path, fname)))
    converted, skipped = convert_state_dict(state)
    if skipped:
        print(f"[cvvae_tpu_torch] skipped {len(skipped)} non-VAE keys "
              f"(e.g. {skipped[:3]})")
    with torch.device("meta"):      # every tensor comes from the file
        vae = cls(config)
    vae.load_state_dict(converted, strict=True, assign=True)
    return vae.to(device=device, dtype=dtype).eval().requires_grad_(False)


def load_torch_checkpoint_file(path: str, dtype=torch.float32,
                               prefixes=("encoder", "decoder")):
    """Load a Lightning .ckpt / raw .pt / .safetensors state dict and
    convert the VAE subtrees (reference: lvdm/models/autoencoder.py:68-86).
    Returns (the port's state dict, skipped keys)."""
    return convert_state_dict(_read_state(path), prefixes=prefixes,
                              dtype=dtype)
