"""cvvae_tpu_torch — the PyTorch/CUDA port of cvvae_tpu for NVIDIA Hopper.

A second package beside the JAX reference ``cvvae_tpu``: the same video
VAEs (the v1 and SD3 families), the same channels-last (B, T, H, W, C)
public layout and module names, with plain tensor code in PyTorch and every
Pallas TPU kernel on the serving path re-written by hand in CUDA C++
(``csrc/``, wrappers in ``ops/kernels/``).  It imports torch and never
jax.

A CPU tensor takes each kernel's plain PyTorch version; a CUDA tensor
launches the kernel or raises.
"""

__version__ = "0.1.0"

from cvvae_tpu_torch.models.video_vae import VideoVAE  # noqa: F401,E402
