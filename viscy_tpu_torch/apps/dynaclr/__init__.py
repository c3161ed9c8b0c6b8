"""DynaCLR: contrastive learning of cell-state embeddings."""
