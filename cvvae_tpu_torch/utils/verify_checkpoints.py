"""One-command reference-checkpoint verification — port of
``tools/verify_checkpoints.py``.

The fidelity gate is "PSNR within 0.1 dB of the PyTorch reference" on the
three shipped checkpoints (subfolders vae3d / vae3d_v1-1 / vae3d_sd3):

    python -m cvvae_tpu_torch.utils.verify_checkpoints \\
        --vae_path /path/to/CV-VAE --clips a.mp4 b.mp4 \\
        [--subfolders vae3d vae3d_v1-1 vae3d_sd3] \\
        [--golden goldens.json] [--out report.json] [--device cuda]

For every (checkpoint, clip) pair this loads the HF safetensors dir with
``VideoVAE.from_pretrained``, reconstructs the clip as the reference CLIs
do (4k+1 frame truncation, /127.5-1 normalisation, the posterior MODE for
determinism, cvvae_inference_video.py:10-52) and prints a PSNR table
(``utils/metrics.reconstruction_report``; SSIM and L1 in the report).
With ``--golden`` (a JSON mapping "<subfolder>/<clip-name>" -> PSNR dB
measured with the PyTorch reference) it asserts agreement within
``--tolerance`` (default 0.1 dB) and exits 1 on any miss; 2 when nothing
was verified.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def verify_one(vae, clip: str, height: int, width: int,
               max_frames: int | None, dtype, device) -> dict:
    import torch

    from cvvae_tpu_torch.data import video_io
    from cvvae_tpu_torch.utils.metrics import reconstruction_report

    frames, _ = video_io.read_video(clip, height=height, width=width,
                                    max_frames=max_frames)
    n = video_io.truncate_to_4k1(len(frames))
    x_np = video_io.normalize(frames[:n])
    x = torch.from_numpy(x_np).to(device=device, dtype=dtype)[None]
    t0 = time.perf_counter()
    z = vae.encode(x).mode()           # deterministic: mode, not sample
    x_rec = vae.decode(z)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    # against the fp32 frames, as the reference measures it
    report = reconstruction_report(torch.from_numpy(x_np)[None],
                                   x_rec.float().cpu())
    return {"frames": int(n), "height": height, "width": width,
            "psnr_db": round(report["psnr_db"], 4),
            "ssim": round(report["ssim"], 5),
            "l1": round(report["l1"], 6),
            "latent_shape": list(z.shape), "seconds": round(dt, 2)}


def main(argv=None) -> int:
    from cvvae_tpu_torch.cli import require_device, torch_dtype
    from cvvae_tpu_torch.models.video_vae import VideoVAE

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--vae_path", required=True,
                   help="HF checkpoint root (subfolders) or a single "
                        "checkpoint dir containing config.json")
    p.add_argument("--subfolders", nargs="*",
                   default=["vae3d", "vae3d_v1-1", "vae3d_sd3"])
    p.add_argument("--clips", nargs="*", default=[])
    p.add_argument("--height", type=int, default=576)
    p.add_argument("--width", type=int, default=1024)
    p.add_argument("--max_frames", type=int, default=None)
    p.add_argument("--dtype", default="bf16", choices=["bf16", "fp32"])
    p.add_argument("--device", default="cuda")
    p.add_argument("--golden", default=None,
                   help="JSON {'<subfolder>/<clip>': psnr_db} from the "
                        "PyTorch reference")
    p.add_argument("--tolerance", type=float, default=0.1)
    p.add_argument("--out", default=None, help="write the report JSON here")
    args = p.parse_args(argv)

    dtype = torch_dtype(args.dtype)
    device = require_device(args.device)
    golden = {}
    if args.golden:
        with open(args.golden) as f:
            golden = json.load(f)
    if not args.clips:
        print("no clips (pass --clips)", file=sys.stderr)
        return 2

    # single-dir mode: --vae_path IS the checkpoint
    if os.path.exists(os.path.join(args.vae_path, "config.json")):
        targets = [("", args.vae_path)]
    else:
        targets = [(sf, os.path.join(args.vae_path, sf))
                   for sf in args.subfolders]

    report, failures = {}, []
    for sf, path in targets:
        if not os.path.exists(os.path.join(path, "config.json")):
            print(f"-- {sf or path}: MISSING (no config.json) -- skipped")
            continue
        vae = VideoVAE.from_pretrained(path, dtype=dtype, device=device)
        for clip in args.clips:
            key = f"{sf}/{os.path.basename(clip)}" if sf \
                else os.path.basename(clip)
            r = verify_one(vae, clip, args.height, args.width,
                           args.max_frames, dtype, device)
            report[key] = r
            line = (f"{key:55s} {r['frames']:4d}f "
                    f"{r['psnr_db']:7.3f} dB  {r['seconds']:6.2f}s")
            if key in golden:
                delta = r["psnr_db"] - float(golden[key])
                ok = abs(delta) <= args.tolerance
                line += (f"  ref {float(golden[key]):7.3f} dB  "
                         f"delta {delta:+.3f} dB  "
                         f"{'OK' if ok else 'FAIL'}")
                r["golden_psnr_db"] = float(golden[key])
                r["delta_db"] = round(delta, 4)
                if not ok:
                    failures.append(key)
            print(line)

    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
    if not report:
        print("nothing verified (no checkpoint dirs found)", file=sys.stderr)
        return 2
    if failures:
        print(f"FAILED the {args.tolerance} dB gate: {failures}",
              file=sys.stderr)
        return 1
    print(f"verified {len(report)} reconstruction(s)"
          + (f" within {args.tolerance} dB of the reference"
             if golden else " (no --golden reference supplied)"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
