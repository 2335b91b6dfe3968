"""Projection helper shared by the encoder, decoder and projector, and LoRA.

Target projection dicts gain stacked ``lora_a`` (L, in, r), ``lora_b``
(L, r, out) and ``lora_scale`` (L,) leaves, applied inside ``proj_apply`` as
``y += (x @ lora_a) @ lora_b * scale``; freezing is a trainable-pattern
selection (``.*lora_[ab]$``), and ``merge_lora`` folds the update into the
kernel. Int8 (``kernel_q``) trees and multi-LoRA banks are not ported yet.
"""

from __future__ import annotations

from typing import Any, Dict, Sequence

import torch

from ultravox_torch.models.config import LoraConfig

Params = Dict[str, Any]

# module name -> parameter-tree key, per tower
DECODER_TARGETS = {
    "q_proj": "q_proj",
    "k_proj": "k_proj",
    "v_proj": "v_proj",
    "o_proj": "o_proj",
    "gate_proj": "gate_proj",
    "up_proj": "up_proj",
    "down_proj": "down_proj",
}
ENCODER_TARGETS = {
    "q_proj": "q_proj",
    "k_proj": "k_proj",
    "v_proj": "v_proj",
    "out_proj": "out_proj",
    "fc1": "fc1",
    "fc2": "fc2",
}
# the default target_modules include wav2vec-style linear_k/linear_q
_ALIASES = {"linear_q": "q_proj", "linear_k": "k_proj"}


def lora_scale(cfg: LoraConfig) -> float:
    return cfg.lora_alpha / max(cfg.r, 1)


def add_lora(
    tower_params: Params,
    cfg: LoraConfig,
    generator: torch.Generator,
    targets: Dict[str, str],
    dtype=torch.float32,
) -> Params:
    """Add stacked lora_a/lora_b/lora_scale leaves to the targeted
    projections of one tower's ``layers`` subtree, on the generator's
    device. A is gaussian / r, B zeros, so the adapter starts as identity.
    The draws differ from the JAX package's."""
    if cfg.r <= 0:
        return tower_params
    layers = dict(tower_params["layers"])
    wanted = {_ALIASES.get(t, t) for t in (cfg.target_modules or targets.keys())}
    for mod, tree_key in sorted(targets.items()):
        if mod not in wanted or tree_key not in layers:
            continue
        proj = dict(layers[tree_key])
        L, d_in, d_out = proj["kernel"].shape
        dev = generator.device
        a = torch.randn((L, d_in, cfg.r), generator=generator, device=dev, dtype=torch.float32)
        proj["lora_a"] = (a * (1.0 / cfg.r)).to(dtype)
        proj["lora_b"] = torch.zeros((L, cfg.r, d_out), dtype=dtype, device=dev)
        # a per-layer scale leaf, so the projection helper needs no config
        proj["lora_scale"] = torch.full((L,), lora_scale(cfg), dtype=dtype, device=dev)
        layers[tree_key] = proj
    out = dict(tower_params)
    out["layers"] = layers
    return out


def apply_lora_to_model(
    params: Params,
    text_lora: LoraConfig,
    audio_lora: LoraConfig,
    generator: torch.Generator,
    dtype=torch.float32,
) -> Params:
    out = dict(params)
    if text_lora.r > 0 and "language_model" in out:
        out["language_model"] = add_lora(out["language_model"], text_lora, generator,
                                         DECODER_TARGETS, dtype)
    if audio_lora.r > 0 and "audio_tower" in out:
        out["audio_tower"] = add_lora(out["audio_tower"], audio_lora, generator,
                                      ENCODER_TARGETS, dtype)
    return out


def proj_apply(x: torch.Tensor, p: Params) -> torch.Tensor:
    """Linear projection with optional bias (added in the product's dtype)
    and LoRA path, as the reference computes them."""
    if "kernel_q" in p:
        raise NotImplementedError("int8 projections are not ported yet")
    out = x @ p["kernel"]
    if "bias" in p:
        out = out + p["bias"]
    if "lora_a" in p:
        # the delta runs in the promoted dtype, as JAX promotes a bf16 x fp32
        # product, and is cast to the base output's dtype: fp32 adapters over
        # a bf16 base must not promote the residual stream
        dt = torch.promote_types(x.dtype, p["lora_a"].dtype)
        delta = ((x.to(dt) @ p["lora_a"].to(dt)) @ p["lora_b"].to(dt)) * p["lora_scale"]
        out = out + delta.to(out.dtype)
    return out


def merge_lora(
    params: Params,
    towers: Sequence[str] = ("language_model", "audio_tower"),
) -> Params:
    """Fold LoRA into the kernels and drop the adapter leaves."""

    def merge_tower(tower: Params) -> Params:
        layers = {}
        for key, leaf in tower["layers"].items():
            if isinstance(leaf, dict) and "lora_a" in leaf:
                new = dict(leaf)
                a, b = new.pop("lora_a"), new.pop("lora_b")
                scale = new.pop("lora_scale")[:, None, None]
                delta = torch.einsum("lir,lro->lio", a, b) * scale
                new["kernel"] = new["kernel"] + delta.to(new["kernel"].dtype)
                layers[key] = new
            else:
                layers[key] = leaf
        out = dict(tower)
        out["layers"] = layers
        return out

    out = dict(params)
    for tower in towers:
        if tower in out and "layers" in out.get(tower, {}):
            out[tower] = merge_tower(out[tower])
    return out
