"""CELLDiff: flow-matching generative virtual staining (counterpart of
``viscy_tpu/models/celldiff``)."""

from viscy_tpu_torch.models.celldiff.celldiff_net import CELLDiffNet, UNetViT3D
from viscy_tpu_torch.models.celldiff.paths import GVPCPlan, ICPlan, VPCPlan
from viscy_tpu_torch.models.celldiff.transport import (
    Sampler,
    Transport,
    create_transport,
    euler_sampler,
    heun_sampler,
    sde_sampler,
)
from viscy_tpu_torch.models.celldiff.vit_bottleneck import ViTBottleneck3D

__all__ = [
    "ViTBottleneck3D",
    "CELLDiffNet",
    "UNetViT3D",
    "Transport",
    "Sampler",
    "create_transport",
    "ICPlan",
    "GVPCPlan",
    "VPCPlan",
    "euler_sampler",
    "heun_sampler",
    "sde_sampler",
]
