"""Modality frontend stubs of the zoo.  The counterpart of
``repro/models/frontends.py``.

The [audio] and [vlm] architectures specify the transformer backbone; the
mel-spectrogram + conv feature extractor (Whisper) and the ViT/SigLIP
vision encoder + projector (Llama-3.2-Vision) are stubbed: these helpers
produce embedding tensors of the correct shape and dtype that stand in for
the frontend outputs, and add the sinusoidal positions the real frontends
would provide.

Each draw comes from an explicit ``torch.Generator`` on an explicit
device (the card unless given).  ``noise`` injects the standard-normal
draw instead, the seam through which a caller feeds the reference's
``jax.random.normal`` draw.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..device import DeviceLike, resolve_device
from .config import ModelConfig, torch_dtype


def sinusoidal(length: int, dim: int, dtype=torch.float32,
               device: DeviceLike = None) -> torch.Tensor:
    """(length, dim) positions: sin of every frequency, then cos; the
    angles in fp32."""
    dev = resolve_device(device)
    pos = torch.arange(length, dtype=torch.float32, device=dev)[:, None]
    half = dim // 2
    # log(10000) rounded to fp32 first, as jnp.log(10000.0)
    log_base = torch.log(torch.tensor(10000.0, dtype=torch.float32,
                                      device=dev))
    freq = torch.exp(-log_base * torch.arange(half, dtype=torch.float32,
                                              device=dev) / half)
    ang = pos * freq[None, :]
    return torch.cat([torch.sin(ang), torch.cos(ang)],
                     dim=-1).to(torch_dtype(dtype))


def _stub(gen, batch: int, length: int, cfg: ModelConfig, device,
          noise: Optional[torch.Tensor]) -> torch.Tensor:
    shape = (batch, length, cfg.d_model)
    if noise is None:
        dev = resolve_device(device)
        noise = torch.randn(shape, generator=gen, dtype=torch.float32,
                            device=dev)
    elif tuple(noise.shape) != shape:
        raise ValueError(f"noise has shape {tuple(noise.shape)}, expected "
                         f"{shape}")
    emb = noise.float() * 0.02
    return (emb + sinusoidal(length, cfg.d_model, device=emb.device)).to(
        torch_dtype(cfg.dtype))


def audio_frames(gen: Optional[torch.Generator], batch: int,
                 cfg: ModelConfig, device: DeviceLike = None,
                 noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Stub for mel-spectrogram + conv1d stack: (B, enc_seq, d_model) in
    ``cfg.dtype``."""
    return _stub(gen, batch, cfg.enc_seq, cfg, device, noise)


def vision_patches(gen: Optional[torch.Generator], batch: int,
                   cfg: ModelConfig, device: DeviceLike = None,
                   noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Stub for ViT encoder + projector: (B, n_patches, d_model) in
    ``cfg.dtype``."""
    return _stub(gen, batch, cfg.n_patches, cfg, device, noise)
