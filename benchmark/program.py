"""The system under test, as the benchmark drives it: the port's
``VideoVAE`` built from a configuration file with the benchmark's
weights, set up as ``cvvae_tpu_torch.serve.prepare`` sets it up, and
served by the port's own HTTP server in this process."""

from __future__ import annotations

import dataclasses
import threading

import numpy as np
import torch

from benchmark.reference.cvvae import Config, init_bound, parameter_specs
from benchmark.traffic import sub_seed


def make_weights(cfg: Config, seed: int, device,
                 dtype: torch.dtype) -> dict:
    """The model's state dict drawn from ``seed`` on ``device`` in one
    uniform draw: conv and dense weights and biases U(+-1/sqrt(fan_in)),
    as torch's default init, norm affines ones and zeros; in ``dtype``."""
    specs = parameter_specs(cfg)
    drawn = [(k, shape) for k, (shape, kind) in specs.items()
             if kind not in ("ones", "zeros")]
    total = sum(int(np.prod(shape)) for _, shape in drawn)
    g = torch.Generator(device=device).manual_seed(sub_seed(seed, "weights"))
    u = torch.rand(total, generator=g, device=device)
    out, off = {}, 0
    for key, (shape, kind) in specs.items():
        if kind == "ones":
            out[key] = torch.ones(shape, dtype=dtype, device=device)
        elif kind == "zeros":
            out[key] = torch.zeros(shape, dtype=dtype, device=device)
        else:
            n = int(np.prod(shape))
            bound = init_bound(specs, key)
            out[key] = ((u[off:off + n] * 2 - 1) * bound).view(shape).to(dtype)
            off += n
    return out


def calibration_clip(cfg: Config, seed: int, device) -> torch.Tensor:
    """The (T, H, W, 3) uint8 clip that int8 calibration runs on, from the
    seed: uniform random bytes, as the server's own default clip."""
    t, h, w = cfg.int8["calibration_clip"]
    g = torch.Generator(device=device).manual_seed(sub_seed(seed,
                                                            "calibration"))
    return torch.randint(0, 256, (t, h, w, 3), dtype=torch.uint8,
                         generator=g, device=device)


def port_config(cfg: Config):
    """The port's ``VideoVAEConfig`` of a configuration file."""
    from cvvae_tpu_torch.models.vae_sd3 import VAESD3Config
    from cvvae_tpu_torch.models.vae_v1 import VAE1Config
    from cvvae_tpu_torch.models.video_vae import VideoVAEConfig

    net_cls = VAE1Config if cfg.family == "v1" else VAESD3Config
    fields = {f.name for f in dataclasses.fields(net_cls)}
    unknown = set(cfg.net) - fields
    if unknown:
        raise ValueError(f"net keys the port does not have: {unknown}")
    net = net_cls(**{k: tuple(v) if isinstance(v, list) else v
                     for k, v in cfg.net.items()})
    v = cfg.video
    return VideoVAEConfig(family=cfg.family, net=net,
                          scaling_factor=v["scaling_factor"],
                          en_de_n_frames_a_time=v["en_de_n_frames_a_time"],
                          time_n_compress=v["time_n_compress"],
                          spatial_n_compress=v["spatial_n_compress"])


def build(cfg: Config, weights: dict, height: int, width: int,
          calib_u8: torch.Tensor, precision: str):
    """The served model: the configuration's ``VideoVAE`` holding
    ``weights``, the serving preset for (height, width), and in int8 its
    quantized copy calibrated on ``calib_u8``, as ``serve.prepare`` makes
    it."""
    from cvvae_tpu_torch.cli import apply_serving_preset
    from cvvae_tpu_torch.models.video_vae import VideoVAE

    with torch.device("meta"):
        vae = VideoVAE(port_config(cfg))
    vae.load_state_dict(weights, strict=True, assign=True)
    vae.eval().requires_grad_(False)
    apply_serving_preset(vae, height, width)
    if precision == "int8":
        s = cfg.int8
        calib = calib_u8.cpu().numpy()[None].astype(np.float32) / 127.5 - 1.0
        vae = vae.quantize(calibration=calib, min_cin=s["min_cin"],
                           margin=s["margin"])
    return vae


def act_dtype(precision: str) -> torch.dtype:
    from cvvae_tpu_torch.cli import torch_dtype
    return torch_dtype(precision)


def serve(vae, precision: str, device):
    """The port's server for ``vae`` on 127.0.0.1 and a free port,
    serving from a thread; returns (server, thread)."""
    from cvvae_tpu_torch.serve import build_server

    server = build_server(vae, port=0, host="127.0.0.1",
                          act_dtype=act_dtype(precision),
                          device=torch.device(device))
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    return server, thread


def stop(server, thread) -> None:
    """Stop the server, join its thread, and let go of the model."""
    server.shutdown()
    server.server_close()
    thread.join(60)
    server.worker.vae = None
