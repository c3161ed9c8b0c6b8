"""Dynacell evaluation: instance segmentation (``segmentation.py``)."""
