"""UltravoxDataproc: VoiceSample -> model features.

Re-design of the reference's ``ultravox_data_proc.py:10-154``: augmentation →
chat-template render → processor → label mask by ``LossMaskType`` → text-only
``alt_*`` fields for KL distillation → response-token truncation.
"""

from __future__ import annotations

import copy
import dataclasses
import threading
from typing import Any, Dict, Optional

import numpy as np

from ultravox_torch.data.datasets import Dataproc, SizedIterableDataset
from ultravox_torch.data.sample import VoiceSample
from ultravox_torch.models.config import LossMaskType
from ultravox_torch.models.processor import AUDIO_PLACEHOLDER, UltravoxProcessor


class UltravoxDataproc(Dataproc):
    def __init__(
        self,
        dataset: SizedIterableDataset,
        processor: UltravoxProcessor,
        *,
        loss_mask_type: LossMaskType = LossMaskType.LAST_ASSISTANT,
        include_alt_fields: bool = False,
        max_response_tokens: Optional[int] = None,
        augmentation=None,
        inference_mode: bool = False,
        num_workers: int = 1,
    ):
        super().__init__(dataset, num_workers=num_workers)
        self._shared_processor = processor
        self._shared_augmentation = augmentation
        self.loss_mask_type = loss_mask_type
        self.include_alt_fields = include_alt_fields
        self.max_response_tokens = max_response_tokens
        self.inference_mode = inference_mode
        # HF fast tokenizers are not thread-safe ("Already borrowed" under
        # concurrent use) and Augmentation carries a mutable RNG; with
        # num_workers > 1 each worker thread gets its own deep copies.
        self._tls = threading.local()

    @property
    def processor(self):
        if self._num_workers <= 1:
            return self._shared_processor
        if not hasattr(self._tls, "processor"):
            self._tls.processor = copy.deepcopy(self._shared_processor)
        return self._tls.processor

    @property
    def augmentation(self):
        if self._shared_augmentation is None or self._num_workers <= 1:
            return self._shared_augmentation
        if not hasattr(self._tls, "augmentation"):
            self._tls.augmentation = copy.deepcopy(self._shared_augmentation)
        return self._tls.augmentation

    def _render(self, messages, add_generation_prompt: bool) -> str:
        return self.processor.tokenizer.apply_chat_template(
            messages, tokenize=False, add_generation_prompt=add_generation_prompt
        )

    def _loss_mask_len(self, sample: VoiceSample, features: Dict[str, Any]) -> int:
        """Tokens (from the start) excluded from the loss
        (reference: ultravox_data_proc.py:45-110)."""
        if self.loss_mask_type == LossMaskType.ALL:
            return 0
        if self.loss_mask_type == LossMaskType.AFTER_AUDIO:
            if "audio_token_start_idx" in features:
                starts = features["audio_token_start_idx"]
                lens = features["audio_token_len"]
                return int(starts[-1] + lens[-1])
            return 0
        # LAST_ASSISTANT: everything up to (and incl.) the final assistant
        # header is masked — measured by tokenizing the conversation without
        # the last assistant message plus the generation prompt.
        prefix_text = self._render(sample.messages[:-1], add_generation_prompt=True)
        prefix = self.processor(
            text=prefix_text,
            audio=sample.audio if AUDIO_PLACEHOLDER in prefix_text else None,
        )
        return int(prefix["input_ids"].shape[-1])

    def _process(self, sample: VoiceSample) -> Dict[str, Any]:
        if self.augmentation is not None:
            sample = self.augmentation.apply_sample(sample)

        if self.inference_mode:
            sample = dataclasses.replace(sample)
            sample.messages = sample.messages[:-1] if (
                sample.messages and sample.messages[-1]["role"] == "assistant"
            ) else sample.messages
            text = self._render(sample.messages, add_generation_prompt=True)
            return self.processor(text=text, audio=sample.audio)

        text = self._render(sample.messages, add_generation_prompt=False)
        features = self.processor(text=text, audio=sample.audio)

        input_ids = np.asarray(features["input_ids"][0])
        mask_len = min(self._loss_mask_len(sample, features), len(input_ids))
        labels = input_ids.copy().astype(np.int64)
        labels[:mask_len] = -100

        # response-token truncation (reference: ultravox_data_proc.py:134-147)
        if self.max_response_tokens is not None:
            keep = mask_len + self.max_response_tokens
            if keep < len(input_ids):
                input_ids = input_ids[:keep]
                labels = labels[:keep]
                features["input_ids"] = input_ids[None]
                features["attention_mask"] = np.ones_like(features["input_ids"])
        features["labels"] = labels

        if self.include_alt_fields:
            alt_text = text.replace(
                AUDIO_PLACEHOLDER, sample.audio_transcript or ""
            )
            alt = self.processor(text=alt_text)
            alt_ids = np.asarray(alt["input_ids"][0])
            # text-only mask: same construction on the alt stream
            alt_prefix_text = self._render(
                sample.messages[:-1], add_generation_prompt=True
            ).replace(AUDIO_PLACEHOLDER, sample.audio_transcript or "")
            if self.loss_mask_type == LossMaskType.ALL:
                alt_mask_len = 0
            else:
                alt_mask_len = self.processor(text=alt_prefix_text)[
                    "input_ids"
                ].shape[-1]
            alt_labels = alt_ids.copy().astype(np.int64)
            alt_labels[: min(alt_mask_len, len(alt_ids))] = -100
            if self.max_response_tokens is not None:
                keep = alt_mask_len + self.max_response_tokens
                alt_ids = alt_ids[:keep]
                alt_labels = alt_labels[:keep]
            features["alt_input_ids"] = alt_ids
            features["alt_labels"] = alt_labels
        return features
