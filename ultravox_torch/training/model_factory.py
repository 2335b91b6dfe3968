"""Model pack assembly: config + params + tokenizer + processor + collator.

Re-design of the reference's ``training/model_types.py``: builds the
composite UltravoxConfig from local HF checkpoint dirs (config.json +
safetensors) or inline config dicts, initialises/loads the parameter tree on
the training device, and bundles the host-side preprocessing objects.
"""

from __future__ import annotations

import dataclasses
import fnmatch
import json
import logging
import os
from typing import Any, Dict, Optional

import torch

from ultravox_torch.inference.engine import resolve_device
from ultravox_torch.models import ultravox as uv
from ultravox_torch.models import weights as weights_lib
from ultravox_torch.models.config import (
    DecoderConfig,
    LoraConfig,
    UltravoxConfig,
    WhisperEncoderConfig,
    make_audio_config,
)
from ultravox_torch.models.data_proc import UltravoxDataproc
from ultravox_torch.models.lora import apply_lora_to_model
from ultravox_torch.models.processor import (
    DataCollatorWithAudio,
    UltravoxProcessor,
    make_processor,
)
from ultravox_torch.models.tokenizer import load_tokenizer
from ultravox_torch.training.config import TrainConfig

logger = logging.getLogger(__name__)

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


@dataclasses.dataclass
class ModelPack:
    config: UltravoxConfig
    params: Any
    tokenizer: Any
    processor: UltravoxProcessor
    collator: DataCollatorWithAudio

    def wrap_with_data_proc(self, dataset, train_config: TrainConfig, **kw):
        return UltravoxDataproc(
            dataset,
            self.processor,
            loss_mask_type=train_config.loss_mask,
            include_alt_fields=train_config.loss_config.requires_alt_fields,
            max_response_tokens=train_config.max_response_tokens,
            num_workers=train_config.num_data_workers,
            **kw,
        )


def _load_hf_config_dict(path: str) -> Optional[Dict[str, Any]]:
    cfg_path = os.path.join(path, "config.json")
    if os.path.isfile(cfg_path):
        with open(cfg_path) as f:
            return json.load(f)
    return None


def create_model_pack(config: TrainConfig) -> ModelPack:
    """The pack on ``config.device`` (the card unless "cpu"); random weights
    come from a ``torch.Generator`` seeded with ``config.seed`` (the draws
    differ from the JAX package's)."""
    dtype = DTYPES[config.param_dtype]
    dev = resolve_device(config.device)

    # -- text config / decoder ------------------------------------------
    text_dict = config.text_model_config
    if text_dict is None:
        text_dict = _load_hf_config_dict(config.text_model)
    if text_dict is None:
        raise ValueError(
            f"cannot resolve text model config from {config.text_model!r}; "
            "provide text_model (local dir) or text_model_config (dict)"
        )
    text_cfg = DecoderConfig.from_hf_dict(text_dict)

    # -- audio config / encoder -------------------------------------------
    audio_cfg = None
    if not config.llm_only_training:
        audio_dict = config.audio_model_config
        if audio_dict is None and config.audio_model:
            audio_dict = _load_hf_config_dict(config.audio_model)
        if audio_dict is None:
            raise ValueError(
                "cannot resolve audio model config; provide audio_model "
                "(local dir) or audio_model_config (dict)"
            )
        audio_cfg = make_audio_config(audio_dict)

    uv_cfg = UltravoxConfig(
        audio_config=audio_cfg or WhisperEncoderConfig(),
        text_config=text_cfg,
        llm_only_training=config.llm_only_training,
        hidden_size=config.projector_hidden_size,
        stack_factor=config.stack_factor,
        norm_init=config.norm_init,
        projector_act=config.projector_act,
        projector_ln_mid=config.projector_ln_mid,
        audio_latency_block_size=config.audio_latency_block_size,
    )

    # -- params: random init, then overlay converted checkpoints ------------
    gen = torch.Generator(device=dev).manual_seed(config.seed)
    params = uv.init_params(uv_cfg, gen, dtype, dev)
    if config.text_model and os.path.isdir(config.text_model):
        sd = weights_lib.load_safetensors_dir(config.text_model)
        if sd:
            params["language_model"] = weights_lib.convert_decoder(sd, text_cfg, dtype, dev)
            logger.info("loaded text model weights from %s", config.text_model)
    if (
        not config.llm_only_training
        and config.audio_model
        and os.path.isdir(config.audio_model)
    ):
        sd = weights_lib.load_safetensors_dir(config.audio_model)
        if sd:
            params_tower = weights_lib.convert_audio_tower_checkpoint(sd, audio_cfg, dtype, dev)
            if params_tower is not None:
                params["audio_tower"] = params_tower
                logger.info("loaded audio tower weights from %s", config.audio_model)

    # LoRA adapters (reference: apply_lora / LoraConfigSimplified)
    text_lora = LoraConfig.from_dict(config.text_model_lora)
    audio_lora = LoraConfig.from_dict(config.audio_model_lora)
    if text_lora.r > 0 or audio_lora.r > 0:
        lora_gen = torch.Generator(device=dev).manual_seed(config.seed + 1)
        params = apply_lora_to_model(params, text_lora, audio_lora, lora_gen, dtype)

    if config.model_load_dir:
        sd_path = config.model_load_dir
        if os.path.isdir(sd_path):
            sd = weights_lib.load_safetensors_dir(sd_path)
            if config.model_load_parameters:
                sd = {
                    k: v
                    for k, v in sd.items()
                    if any(fnmatch.fnmatch(k, pat) for pat in config.model_load_parameters)
                }
                logger.info(
                    "selective load: %d params match %s",
                    len(sd), config.model_load_parameters,
                )
            params = weights_lib.convert_ultravox(sd, uv_cfg, dtype, base=params, device=dev)
            logger.info("overlaid ultravox checkpoint from %s", sd_path)

    # -- tokenizer / processor ---------------------------------------------
    tok_path = config.tokenizer_path or config.text_model
    tokenizer = load_tokenizer(tok_path)
    if tokenizer.pad_token_id is None:
        tokenizer.pad_token = tokenizer.eos_token
    processor = make_processor(tokenizer, uv_cfg)
    collator = DataCollatorWithAudio(
        pad_token_id=tokenizer.pad_token_id,
        include_alt_fields=config.loss_config.requires_alt_fields,
        pad_multiple=config.text_pad_multiple,
        mel_pad_multiple=config.mel_pad_multiple,
        max_audio_len=processor.audio_context_size or 3000,
    )
    return ModelPack(
        config=uv_cfg,
        params=params,
        tokenizer=tokenizer,
        processor=processor,
        collator=collator,
    )
