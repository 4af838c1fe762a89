from cvvae_tpu_torch.losses.gan import hinge_d_loss, vanilla_d_loss  # noqa: F401
from cvvae_tpu_torch.losses.vae_loss import LossConfig  # noqa: F401
