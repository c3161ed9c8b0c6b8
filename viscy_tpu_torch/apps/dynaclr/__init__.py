"""DynaCLR: contrastive learning of cell-state embeddings, and the frozen
foundation-model embedding engine."""

from viscy_tpu_torch.apps.dynaclr.engine import ContrastiveModule
from viscy_tpu_torch.apps.dynaclr.foundation_engine import FoundationModule
from viscy_tpu_torch.apps.dynaclr.vae_engine import BetaVaeModule

__all__ = ["BetaVaeModule", "ContrastiveModule", "FoundationModule"]
