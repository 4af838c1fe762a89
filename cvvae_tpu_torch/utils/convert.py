"""Checkpoints -> the port's ``state_dict``.

Two sources:

* **A JAX params tree** (``from_jax_params``), the inverse of
  ``cvvae_tpu/utils/convert.py:59-78``.  The port's module paths follow
  the JAX params tree, so conversion is a path join plus a per-tensor
  layout change:

  - a conv kernel (kT, kH, kW, I, O)       -> weight (O, I, kT, kH, kW)
    (a per-frame kernel (1, kH, kW, I, O)  -> a Conv3d weight (O, I, 1, kH, kW);
    with ``conv2d``, the UNet's            -> a Conv2d weight (O, I, kH, kW))
  - a dense kernel (I, O)                  -> weight (O, I)
  - a norm's scale / bias                  -> its weight / bias
  - a quantized conv's kernel_q (kT, kH, kW, I, O) int8 -> weight_q
    (O, I, kT, kH, kW); its scale_w and scale_x as they are
  - CLIP's bare ``token_embedding`` / ``position_embedding`` tables ->
    that embedding's weight, as they are

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

* **The latent-compat demo's checkpoints**: a diffusers SD 2.x UNet
  (``convert_unet_state_dict``, ``load_unet_checkpoint``) and a
  transformers CLIPTextModel (``convert_clip_text_state_dict``,
  ``load_clip_text_checkpoint``), the counterparts of
  ``cvvae_tpu/utils/convert.py:223-364``.  Their tensors keep torch's
  layout (the port's UNet convs are Conv2d, its dense layers Linear).

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


#: the bare embedding tables of the JAX CLIP tree
_EMBEDDINGS = {"token_embedding", "position_embedding"}


def _convert_leaf(leaf: str, value: np.ndarray, conv2d: bool = False):
    if leaf == "scale":
        return "weight", value
    if leaf in _EMBEDDINGS:
        return f"{leaf}.weight", value
    if leaf == "kernel":
        if conv2d and value.ndim == 5 and value.shape[0] == 1:
            return "weight", value[0].transpose(3, 2, 0, 1)
        if value.ndim == 5:
            return "weight", value.transpose(4, 3, 0, 1, 2)
        if value.ndim == 4:  # a 2D conv (kH, kW, I, O): LPIPS's VGG, heads
            return "weight", value.transpose(3, 2, 0, 1)
        if value.ndim == 2:
            return "weight", value.T
        raise ValueError(f"kernel of rank {value.ndim} has no counterpart")
    if leaf == "kernel_q":
        return "weight_q", value.transpose(4, 3, 0, 1, 2)
    if leaf in ("bias", "scale_w", "scale_x", "mean", "var", "loc",
                "initialized", "logvar", "logvar_2d"):
        return leaf, value
    raise ValueError(f"unexpected leaf {leaf!r}")


def from_jax_params(params: dict, conv2d: bool = False
                    ) -> Dict[str, torch.Tensor]:
    """A JAX params tree of array-likes -> state_dict: the VideoVAE's
    {"encoder", "decoder"}, the training engine's generator tree (with
    the 0-d ``logvar`` / ``logvar_2d``), a discriminator (Disc3D; Disc2D
    with BatchNorm ``mean``/``var`` or ActNorm ``loc``/``initialized``),
    LPIPS ({"vgg", "lins"}, 2D kernels), a 2D constraint net, the CLIP
    text tower, or with ``conv2d`` the UNet (its (1, kH, kW, I, O) kernels
    become Conv2d weights).  An optimizer's moments of any of these
    convert alike."""
    out: Dict[str, torch.Tensor] = {}

    def visit(node, path):
        if isinstance(node, dict):
            items = node.items()
        elif isinstance(node, (list, tuple)):
            items = enumerate(node)
        else:
            name, value = _convert_leaf(path[-1], np.asarray(node), conv2d)
            key = ".".join(path[:-1] + [name])
            out[key] = torch.from_numpy(np.array(value, order="C"))
            return
        for k, v in items:
            visit(v, path + [str(k)])

    visit(params, [])
    return out


def _adam_state(opt_state):
    """optax's ScaleByAdamState (count, mu, nu) inside a
    ``chain(clip_by_global_norm, inject_hyperparams(adamw))`` state."""
    if hasattr(opt_state, "mu") and hasattr(opt_state, "nu"):
        return opt_state
    children = (opt_state if isinstance(opt_state, (tuple, list))
                else [getattr(opt_state, "inner_state", None)])
    for child in children:
        if child is not None and not isinstance(child, (int, float)):
            found = _adam_state(child)
            if found is not None:
                return found
    return None


def from_jax_train_state(state) -> dict:
    """A JAX ``TrainState`` (step, params, disc params, the two optax
    clip + AdamW states, the EMA) -> the port's ``TrainState.state_dict()``
    form: load it with ``TrainState.load_state_dict`` (strict).  optax's
    moments ``mu``/``nu`` and its ``count`` become the port's AdamW state,
    keyed and laid out like the parameters."""
    def adam(opt_state):
        a = _adam_state(opt_state)
        if a is None:
            raise ValueError("no ScaleByAdamState in the optimizer state")
        return {"count": int(np.asarray(a.count)),
                "mu": from_jax_params(a.mu), "nu": from_jax_params(a.nu)}

    ema = None
    if state.ema is not None:
        ema = {"shadow": from_jax_params(state.ema.shadow),
               "num_updates": int(np.asarray(state.ema.num_updates))}
    return {"step": int(np.asarray(state.step)),
            "params": from_jax_params(state.params),
            "disc_params": from_jax_params(state.disc_params),
            "opt_g": adam(state.opt_g), "opt_d": adam(state.opt_d),
            "ema": ema}


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


def _read_safetensors_dir(path: str) -> Dict[str, torch.Tensor]:
    """Every ``*.safetensors`` file of a checkpoint dir, in one state dict
    (empty where there is none)."""
    state: Dict[str, torch.Tensor] = {}
    for fname in sorted(os.listdir(path)):
        if fname.endswith(".safetensors"):
            state.update(_read_state(os.path.join(path, fname)))
    return state


def load_reference_checkpoint(cls, path: str, dtype=torch.float32,
                              device="cuda"):
    """Load an HF-style checkpoint dir (config.json + *.safetensors) into
    a ``cls`` (VideoVAE) on ``device`` in ``dtype``, strictly."""
    with open(os.path.join(path, "config.json")) as f:
        cfg_json = json.load(f)
    config = _config_from_json(cfg_json)

    state = _read_safetensors_dir(path)
    if not state:
        raise FileNotFoundError(f"no .safetensors files in {path}")
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


# ---------------------------------------------------------------------------
# The latent-compat demo: UNet2DConditionModel and CLIPTextModel
# ---------------------------------------------------------------------------

def convert_unet_state_dict(state_dict: Dict[str, object],
                            dtype: torch.dtype = torch.float32
                            ) -> Dict[str, torch.Tensor]:
    """A diffusers UNet2DConditionModel state dict (SD 2.x,
    use_linear_projection) -> the state dict of ``models/unet2d.UNet2D``.

    The UNet has no top-level prefix, so every key converts, through the
    same path rewrites as the VAE's (``downsamplers.0.conv`` ->
    ``downsamplers.0``, ``to_out.0`` -> ``to_out``, the GEGLU's
    ``ff.net.0.proj`` / ``ff.net.2`` -> ``ff_proj`` / ``ff_out``); every
    tensor keeps its torch layout."""
    out: Dict[str, torch.Tensor] = {}
    for key, value in state_dict.items():
        path, _, leaf = _translate_key(key)
        out[".".join([str(p) for p in path] + [leaf])] = \
            torch.as_tensor(value).detach().to(dtype).contiguous()
    return out


def unet_config_from_json(cfg_json: dict):
    """A UNet2DConfig from a diffusers config.json.  A list-valued
    ``attention_head_dim`` (per-block head *counts* in old configs) gives
    block_out_channels[0] // its first entry, as the JAX package's loader
    has it."""
    from cvvae_tpu_torch.models.unet2d import UNet2DConfig

    head = cfg_json.get("attention_head_dim", 64)
    if isinstance(head, (list, tuple)):
        head = cfg_json["block_out_channels"][0] // head[0]
    return UNet2DConfig(
        in_channels=cfg_json.get("in_channels", 4),
        out_channels=cfg_json.get("out_channels", 4),
        block_out_channels=tuple(cfg_json["block_out_channels"]),
        layers_per_block=cfg_json.get("layers_per_block", 2),
        cross_attention_dim=cfg_json.get("cross_attention_dim", 1024),
        attention_head_dim=head,
        norm_num_groups=cfg_json.get("norm_num_groups", 32))


def load_unet_checkpoint(path: str, dtype: torch.dtype = torch.float32,
                         device="cuda"):
    """A diffusers UNet checkpoint dir (config.json + *.safetensors) ->
    ``models/unet2d.UNet2D`` on ``device`` in ``dtype``, loaded strictly
    (its ``config`` is the UNet2DConfig); on the card unless the caller
    asks for the CPU, and without a card the default raises."""
    from cvvae_tpu_torch.models import unet2d
    from cvvae_tpu_torch.models.video_vae import on_device

    device = on_device(device, "load_unet_checkpoint")
    with open(os.path.join(path, "config.json")) as f:
        cfg = unet_config_from_json(json.load(f))
    state = convert_unet_state_dict(_read_safetensors_dir(path), dtype)
    with torch.device("meta"):
        unet = unet2d.UNet2D(cfg)
    unet.load_state_dict(state, strict=True, assign=True)
    return unet2d.to_device(unet, device, dtype)


_CLIP_LAYER_RE = re.compile(r"^text_model\.encoder\.layers\.(\d+)\.(.+)$")
#: transformers' module names in a layer -> the port's
CLIP_MODULES = {"self_attn.q_proj": "attn.q", "self_attn.k_proj": "attn.k",
                "self_attn.v_proj": "attn.v", "self_attn.out_proj": "attn.out",
                "layer_norm1": "ln1", "layer_norm2": "ln2", "mlp.fc1": "fc1",
                "mlp.fc2": "fc2"}
#: transformers' keys outside the layers -> the port's
CLIP_TOP = {"text_model.embeddings.token_embedding.weight":
            "token_embedding.weight",
            "text_model.embeddings.position_embedding.weight":
            "position_embedding.weight",
            "text_model.final_layer_norm.weight": "final_ln.weight",
            "text_model.final_layer_norm.bias": "final_ln.bias"}


def convert_clip_text_state_dict(state_dict: Dict[str, object],
                                 dtype: torch.dtype = torch.float32
                                 ) -> Dict[str, torch.Tensor]:
    """A transformers ``CLIPTextModel`` state dict -> the state dict of
    ``models/clip_text.CLIPText``.

    Names are the real transformers names (pinned full-size in
    tests/data/clip_sd21_keys.json); tensors keep torch's layout.
    ``position_ids`` buffers and the projection head of
    ``CLIPTextModelWithProjection`` are skipped; any other unknown key
    raises."""
    out: Dict[str, torch.Tensor] = {}
    for key, value in state_dict.items():
        if key.endswith("position_ids") or key == "text_projection.weight":
            continue
        name = CLIP_TOP.get(key)
        if name is None:
            m = _CLIP_LAYER_RE.match(key)
            mod, leaf = m.group(2).rsplit(".", 1) if m else (None, None)
            if mod not in CLIP_MODULES:
                raise KeyError(f"unrecognised CLIP text key: {key}")
            name = f"layers.{m.group(1)}.{CLIP_MODULES[mod]}.{leaf}"
        out[name] = torch.as_tensor(value).detach().to(dtype).contiguous()
    return out


def load_clip_text_checkpoint(path: str, dtype: torch.dtype = torch.float32,
                              device="cuda"):
    """A transformers CLIPTextModel checkpoint dir (config.json +
    *.safetensors, or pytorch_model.bin) -> ``models/clip_text.CLIPText``
    on ``device`` in ``dtype``, loaded strictly (its ``config`` is the
    CLIPTextConfig); on the card unless the caller asks for the CPU, and
    without a card the default raises."""
    from cvvae_tpu_torch.models.clip_text import CLIPText, CLIPTextConfig
    from cvvae_tpu_torch.models.video_vae import on_device

    device = on_device(device, "load_clip_text_checkpoint")
    with open(os.path.join(path, "config.json")) as f:
        cfg_json = json.load(f)
    cfg = CLIPTextConfig(
        vocab_size=cfg_json.get("vocab_size", 49408),
        hidden_size=cfg_json.get("hidden_size", 1024),
        intermediate_size=cfg_json.get("intermediate_size", 4096),
        num_hidden_layers=cfg_json.get("num_hidden_layers", 23),
        num_attention_heads=cfg_json.get("num_attention_heads", 16),
        max_position_embeddings=cfg_json.get("max_position_embeddings", 77),
        hidden_act=cfg_json.get("hidden_act", "gelu"),
        layer_norm_eps=cfg_json.get("layer_norm_eps", 1e-5))
    state = _read_safetensors_dir(path)
    if not state:
        state = torch.load(os.path.join(path, "pytorch_model.bin"),
                           map_location="cpu", weights_only=True)
    state = convert_clip_text_state_dict(state, dtype)
    with torch.device("meta"):
        model = CLIPText(cfg)
    model.load_state_dict(state, strict=True, assign=True)
    return model.to(device=device, dtype=dtype).eval().requires_grad_(False)
