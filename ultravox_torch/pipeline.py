"""Pipeline surface: one-call speech + text inference.

    pipe = ultravox_torch.pipeline("path/to/checkpoint", device="cpu")
    text = pipe({"audio": waveform, "sampling_rate": 16000,
                 "turns": [...], "prompt": "<|audio|>"},
                max_new_tokens=100, temperature=0.7)

A standalone callable with the input and output contract of the
"ultravox-pipeline" ``transformers`` pipeline: audio dtypes normalised
(int16 / int32 / float64 to float32), ``prompt`` / ``turns`` handling, and
the ``<|audio|>`` placeholder appended to a prompt that lacks it.
"""

from __future__ import annotations

import logging
from typing import Any, Dict, List, Optional

import numpy as np

logger = logging.getLogger(__name__)


class UltravoxPipeline:
    """Callable wrapper around a LocalInference."""

    def __init__(self, inference):
        self.inference = inference
        self.tokenizer = inference.tokenizer

    def _normalize_audio(self, audio):
        if isinstance(audio, np.ndarray):
            if audio.dtype == np.float64:
                return audio.astype(np.float32)
            if audio.dtype == np.int16:
                return audio.astype(np.float32) / np.float32(32768.0)
            if audio.dtype == np.int32:
                return audio.astype(np.float32) / np.float32(2147483648.0)
        return audio

    def __call__(
        self,
        inputs: Dict[str, Any],
        *,
        max_new_tokens: Optional[int] = None,
        temperature: Optional[float] = None,
    ) -> str:
        from ultravox_torch.data.sample import VoiceSample

        turns: List[Dict[str, str]] = list(inputs.get("turns", []))
        audio = self._normalize_audio(inputs.get("audio"))
        if audio is not None and (not turns or turns[-1]["role"] != "user"):
            prompt = inputs.get("prompt", "<|audio|>")
            if "<|audio|>" not in prompt:
                logger.warning(
                    "Prompt does not contain '<|audio|>', appending it to the end of the prompt.")
                prompt += " <|audio|>"
            turns.append({"role": "user", "content": prompt})
        if audio is not None and "sampling_rate" not in inputs:
            logger.warning("No sampling rate provided, using default of 16kHz.")
        sample = VoiceSample(
            messages=turns, audio=audio, sample_rate=int(inputs.get("sampling_rate", 16000)),
        )
        out = self.inference.infer(sample, max_tokens=max_new_tokens, temperature=temperature)
        return out.text


def pipeline(
    model: str,
    *,
    chat_template: Optional[str] = None,
    dtype=None,
    max_cache_len: int = 4096,
    **kwargs,
) -> UltravoxPipeline:
    """An UltravoxPipeline from a checkpoint path, ``hf://`` or ``wandb://``
    reference; ``kwargs`` go to ``UltravoxInference`` (``device="cpu"`` runs
    it on the CPU)."""
    import torch

    from ultravox_torch.inference.ultravox_infer import UltravoxInference

    inference = UltravoxInference(
        model, dtype=dtype or torch.bfloat16, max_cache_len=max_cache_len, **kwargs,
    )
    if chat_template:
        inference.tokenizer.chat_template = chat_template
    return UltravoxPipeline(inference)
