"""Dynacell (counterpart of ``viscy_tpu/apps/dynacell``): so far the nucleus
instance segmentation of the test stage's segmentation leg."""
