"""PyTorch/CUDA port of text2pos_tpu for NVIDIA Hopper.

The JAX package ``text2pos_tpu`` is the reference; this package mirrors its
module paths (``ops/lstm.py`` ↔ ``text2pos_tpu/ops/lstm.py`` …) and never
imports it. Entry points run on the CUDA device unless the caller passes
``device="cpu"``; the hand-written kernels under ``csrc/`` are built with
``nvcc`` at first use (``ops/_build.py``).
"""

from text2pos_torch.device import resolve_device

__all__ = ["resolve_device"]
