"""Per-stage timing of the SD3-family encoder/decoder (16-ch latent,
block_out 128/256/512/512) at the 720p bench tile shapes.

Port of ``tools/profile_stages_sd3.py``: the same method as
``profile_stages`` (``profile_stages.time_stages``: CUDA events at the
stage boundaries of one forward, and the whole forward as one interval),
the same flags and JSON; the stage split mirrors the reference
Encoder3D/Decoder3D structure (models/vae_models3d_sd3.py:55-391).

    python -m cvvae_tpu_torch.utils.profile_stages_sd3 [--dtype bf16]
        [--iters 3] [--quantize [--calibrate]] [--device cuda|cpu]

Prints a JSON dict of stage -> seconds (min over iters) as the last line.
"""

from __future__ import annotations

from cvvae_tpu_torch.models import vae_sd3
from cvvae_tpu_torch.ops.norm import group_norm
from cvvae_tpu_torch.utils import profile_stages as ps


def _out(net):
    def out(h):
        h = group_norm(h, net.conv_norm_out, num_groups=net.groups,
                       eps=vae_sd3.NORM_EPS, silu=True)
        return net.conv_out(h)
    return out


def encoder_stages(encoder: vae_sd3.Encoder,
                   cfg: vae_sd3.VAESD3Config) -> ps.Stages:
    """[(name, fn h -> h)]: conv_in, enc_level{i}, enc_mid, enc_out; their
    composition is ``encoder``'s forward."""
    stages = [("conv_in", encoder.conv_in)]
    for i, blk in enumerate(encoder.down_blocks):
        stages.append((f"enc_level{i}", blk))
    stages += [("enc_mid", encoder.mid_block), ("enc_out", _out(encoder))]
    return stages


def decoder_stages(decoder: vae_sd3.Decoder,
                   cfg: vae_sd3.VAESD3Config) -> ps.Stages:
    """[(name, fn)]: conv_in, dec_mid, then each up block's resnets
    (dec_blocks{n-1-i}, labelled by distance from the output as the v1
    table) and upsampler (dec_upsample{n-1-i}), then dec_out; their
    composition is ``decoder``'s forward."""
    def blocks(blk):
        def run(h):
            for r in blk.resnets:
                h = vae_sd3.run_resblock(r, h)
            return h
        return run

    n = cfg.num_levels
    stages = [("conv_in", decoder.conv_in), ("dec_mid", decoder.mid_block)]
    for i, blk in enumerate(decoder.up_blocks):
        stages.append((f"dec_blocks{n - 1 - i}", blocks(blk)))
        if blk.upsamplers is not None:
            stages.append((f"dec_upsample{n - 1 - i}", blk.upsamplers[0]))
    stages.append(("dec_out", _out(decoder)))
    return stages


def main(argv=None) -> dict:
    args = ps.build_argparser(__doc__.splitlines()[0]).parse_args(argv)
    cfg = vae_sd3.VAESD3Config()
    return ps.run(args, vae_sd3, cfg, cfg.latent_channels, encoder_stages,
                  decoder_stages, label="sd3 ")


if __name__ == "__main__":
    main()
