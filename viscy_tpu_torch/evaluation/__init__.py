"""Evaluation metrics of the test stage."""
