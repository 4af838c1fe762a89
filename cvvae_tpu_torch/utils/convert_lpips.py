"""Convert pretrained LPIPS weights into the blob the port trains with.

Port of ``tools/convert_lpips.py``.  The reference optimises against a
*pretrained* LPIPS metric: torchvision VGG16 features + learned 1x1
"lin" heads downloaded and md5-checked at first use
(lvdm/modules/autoencoding/lpips/util.py:1-43, loss/lpips.py:12-46).
Without a network the two artifacts are supplied offline:

  1. torchvision VGG16 ImageNet weights -- ``vgg16-397923af.pth``
     (keys ``features.0.weight`` ...; a bare ``features`` state dict with
     keys ``0.weight`` ... also works)
  2. the LPIPS lin-head checkpoint -- ``vgg.pth`` from the reference's
     URL_MAP["vgg_lpips"] (lpips/util.py:9), expected md5
     d507d7349b931f0638a25a48a722f98a (keys ``lin{k}.model.1.weight``)

Usage:
    python -m cvvae_tpu_torch.utils.convert_lpips --vgg16 \
        vgg16-397923af.pth --lpips vgg.pth --out lpips_blob.pth

The output is ``torch.save({"vgg": <features state dict>, "lins":
<lin-head state dict>})``, what ``train.py``'s
``model.frozen_ckpts.lpips`` reads (``cvvae_tpu_torch/train.py`` ->
``models/lpips.load_lpips_params``).  After writing it, the tool loads
the blob with ``strict=True`` into the port's LPIPS module.  An md5
mismatch warns and converts anyway.
"""

from __future__ import annotations

import argparse
import hashlib
import sys

import torch

from cvvae_tpu_torch.models.lpips import (LPIPS, LPIPS_CHANNELS,
                                          VGG_CONV_INDICES, load_lpips_params)

LIN_KEYS = [f"lin{k}.model.1.weight" for k in range(5)]
REFERENCE_LPIPS_MD5 = "d507d7349b931f0638a25a48a722f98a"  # lpips/util.py:13


def extract_vgg_features(state: dict) -> dict:
    """Normalise a torchvision VGG16 checkpoint to the bare ``features``
    layout ``load_lpips_params`` expects (keys '0.weight' ...)."""
    if "features.0.weight" in state:
        state = {k[len("features."):]: v for k, v in state.items()
                 if k.startswith("features.")}
    missing = [f"{i}.{p}" for i in VGG_CONV_INDICES
               for p in ("weight", "bias") if f"{i}.{p}" not in state]
    if missing:
        raise SystemExit(f"VGG16 checkpoint is missing conv keys {missing}: "
                         "expected torchvision vgg16 weights")
    out = {}
    for i in VGG_CONV_INDICES:
        w = state[f"{i}.weight"]
        if tuple(w.shape[2:]) != (3, 3):
            raise SystemExit(f"features.{i}.weight has shape {tuple(w.shape)}"
                             " -- not a VGG16 3x3 conv")
        out[f"{i}.weight"] = w
        out[f"{i}.bias"] = state[f"{i}.bias"]
    return out


def extract_lin_heads(state: dict) -> dict:
    """Pull the five 1x1 lin-head weights out of the reference's
    ``vgg.pth`` (extra keys like scaling_layer buffers are dropped: the
    shift/scale constants are in ``models/lpips.py``)."""
    missing = [k for k in LIN_KEYS if k not in state]
    if missing:
        raise SystemExit(f"lin-head checkpoint is missing {missing}: "
                         "expected the reference's vgg.pth (URL_MAP"
                         "['vgg_lpips'], lpips/util.py:9)")
    out = {}
    for k, c in zip(LIN_KEYS, LPIPS_CHANNELS):
        w = state[k]
        if tuple(w.shape) != (1, c, 1, 1):
            raise SystemExit(f"{k} has shape {tuple(w.shape)}, "
                             f"expected (1, {c}, 1, 1)")
        out[k] = w
    return out


def convert(vgg16_path: str, lpips_path: str, out_path: str,
            check_md5: bool = True) -> dict:
    if check_md5:
        with open(lpips_path, "rb") as f:
            md5 = hashlib.md5(f.read()).hexdigest()
        if md5 != REFERENCE_LPIPS_MD5:
            print(f"[convert_lpips] WARNING: {lpips_path} md5 {md5} != "
                  f"reference {REFERENCE_LPIPS_MD5} -- converting anyway",
                  file=sys.stderr)
    vgg_raw = torch.load(vgg16_path, map_location="cpu", weights_only=True)
    lin_raw = torch.load(lpips_path, map_location="cpu", weights_only=True)
    blob = {"vgg": extract_vgg_features(dict(vgg_raw)),
            "lins": extract_lin_heads(dict(lin_raw))}
    torch.save(blob, out_path)
    n = sum(v.numel() for d in blob.values() for v in d.values())
    print(f"[convert_lpips] wrote {out_path}: {len(blob['vgg'])//2} VGG "
          f"convs + {len(blob['lins'])} lin heads, {n:,} parameters")
    return blob


def load_check(blob: dict) -> LPIPS:
    """The blob through ``load_lpips_params`` into the port's LPIPS module,
    ``strict=True``, as ``train.py`` loads it."""
    net = LPIPS()
    net.load_state_dict(load_lpips_params(blob["vgg"], blob["lins"]),
                        strict=True)
    return net


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--vgg16", required=True,
                   help="torchvision vgg16-397923af.pth (or features-only "
                        "state dict)")
    p.add_argument("--lpips", required=True,
                   help="reference vgg.pth lin-head checkpoint")
    p.add_argument("--out", required=True, help="output blob path")
    p.add_argument("--no-md5-check", action="store_true")
    args = p.parse_args(argv)
    blob = convert(args.vgg16, args.lpips, args.out,
                   check_md5=not args.no_md5_check)
    net = load_check(blob)
    assert len(net.vgg) == 13 and len(net.lins) == 5
    print("[convert_lpips] blob verified against "
          "models.lpips.load_lpips_params (strict load into LPIPS)")


if __name__ == "__main__":
    main()
