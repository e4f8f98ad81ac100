"""PyTorch port of DiverseFL for one NVIDIA H100.

The JAX package ``repro`` is the reference; this package mirrors its
layout (``repro_torch/<path>`` is the counterpart of ``repro/<path>``)
and imports nothing from it.  Entry points run on the CUDA card unless
the caller passes ``device="cpu"``; Steps 4 and 5 of DiverseFL run
through hand-written CUDA kernels (``kernels/csrc``).
"""
from .device import resolve_device

__all__ = ["resolve_device"]
