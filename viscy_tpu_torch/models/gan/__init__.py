"""GAN components (counterpart of ``viscy_tpu/models/gan``; reference
``viscy_models/gan``)."""

from viscy_tpu_torch.models.gan.losses import (
    feature_matching_loss,
    gan_loss_d,
    gan_loss_g,
    lecam_penalty,
    lsgan_d_loss,
    lsgan_g_loss,
    mean_logit,
    nonsat_d_loss,
    nonsat_g_loss,
    r1_penalty,
    r2_penalty,
    rpgan_d_loss,
    rpgan_g_loss,
)
from viscy_tpu_torch.models.gan.patchgan3d import MultiScalePatchGAN3D, PatchGAN3D

__all__ = [
    "PatchGAN3D",
    "MultiScalePatchGAN3D",
    "gan_loss_d",
    "gan_loss_g",
    "lecam_penalty",
    "mean_logit",
    "feature_matching_loss",
    "lsgan_d_loss",
    "lsgan_g_loss",
    "nonsat_d_loss",
    "nonsat_g_loss",
    "r1_penalty",
    "r2_penalty",
    "rpgan_d_loss",
    "rpgan_g_loss",
]
