"""Rotary position embeddings (HF half-split rotation) with Llama-3 scaling."""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch


def rope_frequencies(
    head_dim: int,
    theta: float,
    rope_scaling: Optional[Tuple[float, float, float, int]] = None,
) -> np.ndarray:
    """Inverse frequencies (head_dim // 2,) float32, with optional Llama-3
    scaling ``(factor, low_freq_factor, high_freq_factor, original_max_pos)``
    computed in float64 on the host."""
    inv_freq = 1.0 / (theta ** (np.arange(0, head_dim, 2, dtype=np.float64) / head_dim))
    if rope_scaling is not None:
        factor, low_ff, high_ff, orig_max = rope_scaling
        low_wavelen = orig_max / low_ff
        high_wavelen = orig_max / high_ff
        wavelen = 2.0 * np.pi / inv_freq
        smooth = (orig_max / wavelen - low_ff) / (high_ff - low_ff)
        inv_freq = np.where(
            wavelen > low_wavelen,
            inv_freq / factor,
            np.where(
                wavelen < high_wavelen,
                inv_freq,
                (1.0 - smooth) / factor * inv_freq + smooth * inv_freq,
            ),
        )
    return inv_freq.astype(np.float32)


def rope_cos_sin(
    positions: torch.Tensor, inv_freq: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables (..., T, head_dim) in float32 from (..., T) positions."""
    angles = positions.float()[..., None] * inv_freq.float()
    angles = torch.cat([angles, angles], dim=-1)
    return torch.cos(angles), torch.sin(angles)


def _rotate_half(x: torch.Tensor) -> torch.Tensor:
    half = x.shape[-1] // 2
    return torch.cat([-x[..., half:], x[..., :half]], dim=-1)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x (..., T, H, D); cos/sin (..., T, D). fp32 math, input dtype out."""
    xf = x.float()
    c = cos[..., :, None, :]
    s = sin[..., :, None, :]
    return (xf * c + _rotate_half(xf) * s).to(x.dtype)
