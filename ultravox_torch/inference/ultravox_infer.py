"""Checkpoint resolution and loading, and ``UltravoxInference``.

``resolve_checkpoint`` and ``load_ultravox_checkpoint`` load a published
Ultravox checkpoint directory (``config.json`` + safetensors) into the
port's parameter tree on the card, or on the CPU with ``device="cpu"``.
``UltravoxInference`` is a ``LocalInference`` built from such a directory:
the checkpoint, its tokenizer (``models.tokenizer.load_tokenizer``, on
``tokenizers`` and ``jinja2``) and the processor. With ``mesh`` (data 1)
every process loads the checkpoint, keeps its fsdp and tensor parts
(``parallel.shard_params``) and is called with the same inputs.
"""

from __future__ import annotations

import os
from typing import Optional

import torch

from ultravox_torch.inference.engine import resolve_device
from ultravox_torch.inference.infer import LocalInference
from ultravox_torch.models import ultravox as uv
from ultravox_torch.models import weights as weights_lib
from ultravox_torch.models.config import UltravoxConfig
from ultravox_torch.models.processor import make_processor
from ultravox_torch.models.tokenizer import load_tokenizer
from ultravox_torch.parallel.sharding import shard_params
from ultravox_torch.utils import wandb_utils


def resolve_checkpoint(path: str) -> str:
    """Resolve a checkpoint reference to a local directory: a local path,
    ``hf://repo`` or ``wandb://entity/project/artifact:vN`` (the last two
    download, and need network access and their packages)."""
    if wandb_utils.is_wandb_url(path):
        return wandb_utils.download_model_from_wandb(path)
    if path.startswith("hf://"):
        from huggingface_hub import snapshot_download

        return snapshot_download(path[len("hf://"):])
    if os.path.isdir(path):
        return path
    raise FileNotFoundError(f"checkpoint {path!r} not found")


def load_ultravox_checkpoint(
    model_path: str,
    dtype=torch.bfloat16,
    *,
    seed: int = 0,
    strict: bool = True,
    device=None,
):
    """Resolve and load a published Ultravox checkpoint into (cfg, params,
    dir), every leaf on ``device`` (the CUDA card unless ``"cpu"``).

    The load order is the reference's construct-then-load_state_dict: seeded
    random parameters, then the sub-model *base* weights that
    ``text_model_id`` / ``audio_model_id`` name when they are local
    directories, then the checkpoint's own state dict LAST, so trained or
    LoRA-merged tower weights in a full checkpoint win over the bases.

    With ``strict`` (default), raises when the language model, the audio
    tower or the projector would be left at random init: a diff
    (adapter-only) checkpoint without resolvable base models fails loudly
    instead of serving random weights."""
    dev = resolve_device(device)
    model_dir = resolve_checkpoint(model_path)
    cfg = UltravoxConfig.from_pretrained_dir(model_dir)
    params = uv.init_params(cfg, torch.Generator(device=dev).manual_seed(seed), dtype, dev)
    have_lm = have_enc = False

    # 1) base sub-model weights referenced by id (diff checkpoints)
    if cfg.text_model_id and os.path.isdir(cfg.text_model_id):
        sub_sd = weights_lib.load_safetensors_dir(cfg.text_model_id)
        if sub_sd:
            params["language_model"] = weights_lib.convert_decoder(
                sub_sd, cfg.text_config, dtype, dev)
            have_lm = True
    if cfg.audio_model_id and os.path.isdir(cfg.audio_model_id):
        sub_sd = weights_lib.load_safetensors_dir(cfg.audio_model_id)
        tower = weights_lib.convert_audio_tower_checkpoint(sub_sd, cfg.audio_config, dtype, dev)
        if tower is not None:
            params["audio_tower"] = tower
            have_enc = True

    # 2) the checkpoint itself, LAST (wins over the bases)
    sd = weights_lib.load_safetensors_dir(model_dir)
    have_lm = have_lm or weights_lib._covers_decoder(
        weights_lib._strip_prefix(sd, "language_model."), cfg.text_config)
    have_enc = have_enc or weights_lib._covers_encoder(
        weights_lib._strip_prefix(sd, "audio_tower."), cfg.audio_config)
    have_proj = any(k.startswith("multi_modal_projector.") for k in sd)
    params = weights_lib.convert_ultravox(sd, cfg, dtype, base=params, device=dev)

    if strict:
        missing = [
            name
            for name, ok in (
                ("language_model", have_lm),
                ("audio_tower", have_enc or cfg.llm_only_training),
                ("multi_modal_projector", have_proj or cfg.llm_only_training),
            )
            if not ok
        ]
        if missing:
            raise ValueError(
                f"checkpoint {model_dir!r} leaves {missing} at random init: "
                "the state dict does not cover them and no local "
                "text_model_id/audio_model_id base resolves. Refusing to "
                "load (pass strict=False to override)."
            )
    return cfg, params, model_dir


class UltravoxInference(LocalInference):
    """A LocalInference from a checkpoint reference (a directory,
    ``hf://repo`` or ``wandb://...``), on the card unless ``device="cpu"``."""

    def __init__(
        self,
        model_path: str,
        *,
        dtype=torch.bfloat16,
        max_cache_len: int = 4096,
        conversation_mode: bool = False,
        mesh=None,
        fused_greedy_decode: bool = False,
        strict: bool = True,
        quantize: Optional[str] = None,
        device=None,
    ):
        dev = resolve_device(device)
        cfg, params, model_dir = load_ultravox_checkpoint(model_path, dtype, strict=strict,
                                                          device=dev)
        if mesh is not None:
            params = shard_params(params, mesh, cfg=cfg)
        tokenizer = load_tokenizer(model_dir)
        tokenizer.padding_side = "right"
        if tokenizer.pad_token_id is None:
            tokenizer.pad_token = tokenizer.eos_token
        processor = make_processor(tokenizer, cfg)
        super().__init__(
            params, cfg, processor, max_cache_len=max_cache_len,
            conversation_mode=conversation_mode, cache_dtype=dtype,
            fused_greedy_decode=fused_greedy_decode, quantize=quantize, device=dev, mesh=mesh,
        )
