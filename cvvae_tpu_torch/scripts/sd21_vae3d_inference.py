"""SD 2.1 + 3D-VAE latent-compat demo: sample image latents with an SD 2.x
UNet, then decode the same latents through the 3D CV-VAE
(``decode(z / scaling_factor, num_frames=1)``) and, with --vae2d_path,
through the 2D SD VAE's decoder beside it.

Port of ``scripts/sd21_vae3d_inference.py``, its flags and flow:

  python -m cvvae_tpu_torch.scripts.sd21_vae3d_inference \\
      --unet_path  /ckpts/sd21/unet \\
      --vae3d_path /ckpts/cv-vae [--subfolder vae3d] \\
      [--vae2d_path /ckpts/sd21/vae.safetensors] \\
      [--text_encoder_path /ckpts/sd21/text_encoder --prompt "..."] \\
      [--steps 50 --guidance 7.5 --height 512 --width 512] \\
      [--device cuda] [--out out.png]

Without --text_encoder_path the context is a fixed random embedding (a
structure demo; drawn by torch, so other numbers than the JAX script's);
with it, the prompt is tokenized by transformers' ``CLIPTokenizer``,
imported only then, and encoded by ``models/clip_text.py`` in bf16.  The
sampler is ``pipelines/diffusion.py``'s DDIM with the JAX package's
schedule.  As in the JAX script, the UNet and the 3D VAE are loaded in
bf16 and compute in the dtype of what they are given, the fp32 latents;
the 2D decoder is loaded in fp32.  Everything runs on the card unless
``--device cpu``.

--vae2d_path is a .safetensors / .ckpt / .pt state dict in the original
SD (LDM) layout: its ``decoder.*`` keys build ``models/vae2d.Decoder2D``
with the "sd21" naming, its widths, depth and mid attention read from the
tensors.  As the JAX script does, the panel decodes with the decoder
alone: a ``post_quant_conv`` in the file is read and not applied.
"""

from __future__ import annotations

import argparse
import re

import numpy as np
import torch


def build_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--unet_path", required=True)
    ap.add_argument("--vae3d_path", required=True)
    ap.add_argument("--subfolder", default=None)
    ap.add_argument("--vae2d_path", default=None)
    ap.add_argument("--text_encoder_path", default=None)
    ap.add_argument("--tokenizer_path", default=None)
    ap.add_argument("--prompt", default="a photograph of an astronaut "
                                        "riding a horse")
    ap.add_argument("--negative_prompt", default="")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--guidance", type=float, default=7.5)
    ap.add_argument("--height", type=int, default=512)
    ap.add_argument("--width", type=int, default=512)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default="sd21_vae3d.png")
    return ap


def vae2d_decoder(state: dict, device):
    """The 2D SD VAE's decoder (``models/vae2d.Decoder2D``, "sd21" naming)
    in fp32 from a converted LDM-layout state dict's ``decoder.*`` keys:
    latent channels, widths, depth and mid attention read from the
    tensors, 32 groups as the JAX script's VAE2DConfig(naming="sd21")."""
    from cvvae_tpu_torch.models.vae2d import Decoder2D, VAE2DConfig

    levels = sorted({int(m.group(1)) for k in state
                     if (m := re.match(r"decoder\.up\.(\d+)\.", k))})
    blocks = {int(m.group(1)) for k in state
              if (m := re.match(r"decoder\.up\.0\.block\.(\d+)\.", k))}
    cfg = VAE2DConfig(
        naming="sd21",
        latent_channels=state["decoder.conv_in.weight"].shape[1],
        out_channels=state["decoder.conv_out.weight"].shape[0],
        block_out_channels=tuple(
            state[f"decoder.up.{i}.block.0.conv2.weight"].shape[0]
            for i in levels),
        layers_per_block=len(blocks) - 1,
        mid_block_add_attention="decoder.mid.attn_1.q.weight" in state)
    dec = {k[len("decoder."):]: v for k, v in state.items()
           if k.startswith("decoder.")}
    with torch.device("meta"):
        net = Decoder2D(cfg)
    net.load_state_dict(dec, strict=True, assign=True)
    return net.to(device=device).eval().requires_grad_(False)


def main(argv=None) -> str:
    args = build_argparser().parse_args(argv)

    from cvvae_tpu_torch.models.unet2d import make_denoiser
    from cvvae_tpu_torch.models.video_vae import VideoVAE
    from cvvae_tpu_torch.pipelines.diffusion import (DDIMScheduler,
                                                     LatentDiffusionPipeline)
    from cvvae_tpu_torch.utils.convert import load_unet_checkpoint

    device = torch.device(args.device)
    unet = load_unet_checkpoint(args.unet_path, dtype=torch.bfloat16,
                                device=device)
    vae3d = VideoVAE.from_pretrained(args.vae3d_path, subfolder=args.subfolder,
                                     dtype=torch.bfloat16, device=device)

    if args.text_encoder_path:
        # tokenize with transformers' CLIPTokenizer (pure Python), encode
        # with the port's CLIP tower; the reference flow is
        # pipeline_stable_diffusion.py:302-427
        from transformers import CLIPTokenizer

        from cvvae_tpu_torch.models.clip_text import make_text_embedder
        from cvvae_tpu_torch.utils.convert import load_clip_text_checkpoint
        tok = CLIPTokenizer.from_pretrained(
            args.tokenizer_path or args.text_encoder_path)
        te = load_clip_text_checkpoint(args.text_encoder_path,
                                       dtype=torch.bfloat16, device=device)
        embedder = make_text_embedder(te)

        def embed(text):
            ids = tok(text, padding="max_length",
                      max_length=te.config.max_position_embeddings,
                      truncation=True, return_tensors="np").input_ids
            return embedder(torch.from_numpy(ids)).float()

        cond, uncond = embed(args.prompt), embed(args.negative_prompt)
    else:
        print("[demo] no text encoder given - using a fixed random context")
        g = torch.Generator().manual_seed(1)
        cond = torch.randn((1, 77, unet.config.cross_attention_dim),
                           generator=g).to(device)
        uncond = torch.zeros_like(cond)

    pipe = LatentDiffusionPipeline(vae3d, make_denoiser(unet),
                                   scheduler=DDIMScheduler())
    latents = pipe(torch.Generator().manual_seed(args.seed), cond=cond,
                   uncond=uncond, height=args.height, width=args.width,
                   num_inference_steps=args.steps,
                   guidance_scale=args.guidance, output_type="latent")

    # decode the same latents through the 3D VAE (the reference contract)
    with torch.inference_mode():
        panels = [pipe.decode_latents(latents).float()[0].cpu().numpy()]
        if args.vae2d_path:  # side by side with the original 2D SD VAE
            from cvvae_tpu_torch.utils.convert import \
                load_torch_checkpoint_file
            state, _ = load_torch_checkpoint_file(
                args.vae2d_path, prefixes=("decoder", "post_quant_conv"))
            z = latents / vae3d.config.scaling_factor
            frame2d = vae2d_decoder(state, device)(z[:, None])
            panels.append(frame2d.float()[0, 0].cpu().numpy())

    import cv2
    img = np.concatenate(panels, axis=1)
    img = np.clip((img + 1) * 127.5, 0, 255).astype(np.uint8)
    cv2.imwrite(args.out, cv2.cvtColor(img, cv2.COLOR_RGB2BGR))
    print(f"[demo] wrote {args.out} "
          f"({'3D | 2D side-by-side' if len(panels) == 2 else '3D decode'})")
    return args.out


if __name__ == "__main__":
    main()
