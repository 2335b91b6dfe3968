"""Projection helper shared by the encoder, decoder and projector.

Only the float path is ported: ``x @ kernel (+ bias)``. Int8 (``kernel_q``)
and LoRA (``lora_a``/``lora_b``) parameter trees are a later slice.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

Params = Dict[str, Any]


def proj_apply(x: torch.Tensor, p: Params) -> torch.Tensor:
    """Linear projection with optional bias; the bias is added in the
    product's dtype, as the reference does."""
    if "kernel_q" in p:
        raise NotImplementedError("int8 projections are not ported yet")
    if "lora_a" in p:
        raise NotImplementedError("LoRA projections are not ported yet")
    out = x @ p["kernel"]
    if "bias" in p:
        out = out + p["bias"]
    return out
