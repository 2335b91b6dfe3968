"""The composite model: encoder -> projector -> embedding splice -> LLM."""

from __future__ import annotations

from typing import Any, Dict

import torch

from ultravox_torch.models import decoder as decoder_lib
from ultravox_torch.models import projector as projector_lib
from ultravox_torch.models import whisper_encoder as encoder_lib
from ultravox_torch.models.config import UltravoxConfig

Params = Dict[str, Any]


def init_params(
    cfg: UltravoxConfig, generator: torch.Generator, dtype=torch.float32, device=None
) -> Params:
    """Seeded random parameters in the JAX package's tree layout
    (``language_model``, ``audio_tower``, ``projector``). The generator must
    live on ``device``; the draws differ from the JAX package's."""
    params: Params = {
        "language_model": decoder_lib.init_params(cfg.text_config, generator, dtype, device),
    }
    if not cfg.llm_only_training:
        params["audio_tower"] = encoder_lib.init_params(cfg.audio_config, generator, dtype, device)
        params["projector"] = projector_lib.init_params(cfg, generator, dtype, device)
    return params


def splice_audio_embeds(
    inputs_embeds: torch.Tensor,  # (B, T, D)
    audio_embeds: torch.Tensor,  # (N, T_a, D), N audio chunks across the batch
    audio_token_start_idx: torch.Tensor,  # (N,)
    audio_token_len: torch.Tensor,  # (N,)
    audio_chunk_batch_idx: torch.Tensor,  # (N,) batch row of each chunk
) -> torch.Tensor:
    """Overwrite each chunk's placeholder span with its first
    ``audio_token_len`` audio embeddings. Destinations outside the batch are
    dropped: they land in one spare row past the batch, so the write needs no
    host-side selection (which would wait for the card). The reference
    writes the same values through a one-hot matmul."""
    B, T, D = inputs_embeds.shape
    N, Ta, _ = audio_embeds.shape
    dev = inputs_embeds.device
    t = torch.arange(Ta, device=dev)
    dest = (
        audio_chunk_batch_idx.long()[:, None] * T
        + audio_token_start_idx.long()[:, None]
        + t[None]
    )
    valid = (t[None] < audio_token_len.long()[:, None]) & (dest >= 0) & (dest < B * T)
    out = torch.cat([inputs_embeds.reshape(B * T, D), inputs_embeds.new_zeros((1, D))])
    out[torch.where(valid, dest, B * T).reshape(-1)] = audio_embeds.reshape(N * Ta, D).to(out.dtype)
    return out[: B * T].reshape(B, T, D)


def prepare_audio_embeds(
    params: Params,
    cfg: UltravoxConfig,
    inputs_embeds: torch.Tensor,
    audio_values: torch.Tensor,  # (N, n_mels, T_mel)
    audio_lens: torch.Tensor,  # (N,) valid mel frames
    audio_token_start_idx: torch.Tensor,
    audio_token_len: torch.Tensor,
    audio_chunk_batch_idx: torch.Tensor,
    *,
    encoder_attn_impl: str = "xla",
) -> torch.Tensor:
    """Audio tower + projector + splice."""
    enc = encoder_lib.encoder_forward(
        params["audio_tower"],
        cfg.audio_config,
        audio_values.to(inputs_embeds.dtype),
        mel_lens=audio_lens,
        latency_block_size=cfg.audio_latency_block_size,
        attn_impl=encoder_attn_impl,
    )
    audio_embeds = projector_lib.projector_forward(params["projector"], cfg, enc)
    return splice_audio_embeds(
        inputs_embeds, audio_embeds, audio_token_start_idx, audio_token_len,
        audio_chunk_batch_idx,
    )


def ultravox_embed(
    params: Params,
    cfg: UltravoxConfig,
    input_ids: torch.Tensor,
    batch: Dict[str, torch.Tensor],
    *,
    encoder_attn_impl: str = "xla",
) -> torch.Tensor:
    """Token embeddings with audio spliced in when the batch carries audio."""
    inputs_embeds = decoder_lib.embed_lookup(params["language_model"], input_ids)
    if batch.get("audio_values") is not None:
        inputs_embeds = prepare_audio_embeds(
            params, cfg, inputs_embeds,
            batch["audio_values"], batch["audio_lens"],
            batch["audio_token_start_idx"], batch["audio_token_len"],
            batch["audio_chunk_batch_idx"],
            encoder_attn_impl=encoder_attn_impl,
        )
    return inputs_embeds
