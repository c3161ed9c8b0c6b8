"""Dynacell (counterpart of ``viscy_tpu/apps/dynacell``): the benchmark
engines ``DynacellUNet`` and ``DynacellFlowMatching`` (CELLDiff), the
``CELLDiff3DVS`` sampling wrapper, and the nucleus instance segmentation of
the test stage's segmentation leg."""

from viscy_tpu_torch.apps.dynacell.celldiff_wrapper import CELLDiff3DVS, trajectory_sampler
from viscy_tpu_torch.apps.dynacell.engine import DynacellFlowMatching, DynacellGAN, DynacellUNet

__all__ = ["CELLDiff3DVS", "DynacellFlowMatching", "DynacellGAN", "DynacellUNet", "trajectory_sampler"]
