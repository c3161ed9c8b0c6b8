"""Dynacell (counterpart of ``viscy_tpu/apps/dynacell``): the benchmark
engines ``DynacellUNet`` and ``DynacellFlowMatching`` (CELLDiff), and the
nucleus instance segmentation of the test stage's segmentation leg."""

from viscy_tpu_torch.apps.dynacell.engine import DynacellFlowMatching, DynacellUNet

__all__ = ["DynacellFlowMatching", "DynacellUNet"]
