"""Foundation-model wrappers (counterpart of ``viscy_tpu/models/foundation``)."""

from viscy_tpu_torch.models.foundation.vit import DinoViT
from viscy_tpu_torch.models.foundation.wrappers import CellDinoModel, DINOv3Model, OpenPhenomModel

__all__ = ["DinoViT", "CellDinoModel", "DINOv3Model", "OpenPhenomModel"]
