"""The phase marks of the federated round: ``csrc/phase_mark.cu``.

``phase_mark_cuda(index, device)`` launches the one-thread, argument-free
kernel ``fl_phase_<name>`` of phase ``index`` (``fl/telemetry.PHASES``
order) on the device's current stream, so a CUDA graph captured on that
stream keeps it as a node.  ``fl/telemetry.phase`` says when.  It has no plain version: off the card
``fl/telemetry.phase`` launches nothing.  It is not one of ``ops.KERNELS``:
it computes nothing, and the FL kernels' launch counts stay theirs.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

# phase_mark(phase, stream) in csrc/phase_mark.cu
_ARGTYPES = (ctypes.c_int, ctypes.c_void_p)


def phase_mark_cuda(index: int, device: torch.device) -> None:
    """Launch the mark of phase ``index`` on ``device``'s current stream."""
    fn = _build.entry_point("phase_mark", "phase_mark", _ARGTYPES)
    with torch.cuda.device(device):
        code = fn(index, torch.cuda.current_stream(device).cuda_stream)
    _build.check("phase_mark", code)
