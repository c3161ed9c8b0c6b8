"""PyTorch/CUDA port of ``viscy_tpu`` for NVIDIA Hopper (H100).

The package mirrors ``viscy_tpu``'s layout module for module. It imports
torch, numpy and einops, never JAX, flax or ``viscy_tpu``. Entry points
take a ``device`` argument that defaults to ``"cuda"``; pass
``device="cpu"`` to run the plain PyTorch versions of the kernels.
"""

__version__ = "0.1.0"
