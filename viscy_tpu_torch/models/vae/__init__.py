"""VAE models (counterpart of ``viscy_tpu/models/vae``; reference
``viscy_models/vae``)."""

from viscy_tpu_torch.models.vae.beta_vae_25d import BetaVae25D, VaeOutput, vae_loss
from viscy_tpu_torch.models.vae.beta_vae_conv import BetaVaeConv, BetaVaeMonai

__all__ = ["BetaVae25D", "BetaVaeConv", "BetaVaeMonai", "VaeOutput", "vae_loss"]
