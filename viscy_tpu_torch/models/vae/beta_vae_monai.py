"""Reference-path shim: ``viscy_models.vae.beta_vae_monai.BetaVaeMonai``
resolves here (counterpart of ``viscy_tpu/models/vae/beta_vae_monai.py``)."""

from viscy_tpu_torch.models.vae.beta_vae_conv import BetaVaeConv, BetaVaeMonai

__all__ = ["BetaVaeConv", "BetaVaeMonai"]
