"""Hand-written Hopper kernels, one module each, mirroring
``cvvae_tpu/ops/pallas/``.  Each module holds the wrapper, the plain
PyTorch version and a launch counter; the CUDA sources are in
``cvvae_tpu_torch/csrc/`` and are built at first use (``_build.py``)."""
