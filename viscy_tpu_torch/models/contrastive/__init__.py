"""Contrastive encoders and losses (DynaCLR)."""
