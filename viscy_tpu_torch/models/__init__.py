"""Model zoo (counterpart of ``viscy_tpu/models``). The subpackages are
imported where they are used; the frozen foundation extractors are exported
here, as the JAX package exports them."""

from viscy_tpu_torch.models.foundation.wrappers import DINOv3Model, OpenPhenomModel

__all__ = ["DINOv3Model", "OpenPhenomModel"]
