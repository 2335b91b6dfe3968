"""Tokenizer helpers (reference: model/ultravox_tokenizer.py:8-25).

The ``<|audio|>`` placeholder is *not* in the vocabulary during training
(the processor splits text around it and fills the span with EOS repeats);
serving stacks that tokenize the placeholder directly (e.g. vLLM-protocol
frontends) need it registered as a special token.
"""

from __future__ import annotations

from typing import Optional

AUDIO_TOKEN = "<|audio|>"


def add_audio_token(tokenizer) -> int:
    """Register the audio placeholder as a special token; returns its id."""
    if AUDIO_TOKEN not in tokenizer.get_vocab():
        tokenizer.add_special_tokens(
            {"additional_special_tokens": [AUDIO_TOKEN]}
        )
    return tokenizer.convert_tokens_to_ids(AUDIO_TOKEN)


def get_audio_token_id(tokenizer) -> Optional[int]:
    vocab = tokenizer.get_vocab()
    return vocab.get(AUDIO_TOKEN)
