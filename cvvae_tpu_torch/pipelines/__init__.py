from cvvae_tpu_torch.pipelines.diffusion import (  # noqa: F401
    DDIMScheduler, EulerDiscreteScheduler, LatentDiffusionPipeline)
