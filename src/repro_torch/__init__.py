"""repro_torch: the PyTorch/CUDA port of ``repro`` for NVIDIA Hopper.

Mirrors ``src/repro`` module for module.  Imports no JAX and nothing of
``repro``; entry points run on ``cuda`` unless the caller passes
``device="cpu"``.
"""

__version__ = "0.1.0"
