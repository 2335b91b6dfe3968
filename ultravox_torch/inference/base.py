"""Inference interfaces of the offline front doors: ``VoiceInference`` and
the records it yields (``VoiceOutput``, ``InferenceChunk``,
``InferenceStats``)."""

from __future__ import annotations

import abc
import dataclasses
from typing import Generator, List, Optional, Union

from ultravox_torch.data.sample import VoiceSample


@dataclasses.dataclass
class VoiceOutput:
    text: str
    input_tokens: int
    output_tokens: int
    thinking_content: Optional[str] = None


@dataclasses.dataclass
class InferenceChunk:
    text: str


@dataclasses.dataclass
class InferenceStats:
    input_tokens: int
    output_tokens: int
    ttft_s: Optional[float] = None
    total_s: Optional[float] = None


InferenceMessage = Union[InferenceChunk, InferenceStats]
InferenceGenerator = Generator[InferenceMessage, None, None]


class VoiceInference(abc.ABC):
    @abc.abstractmethod
    def infer(
        self,
        sample: VoiceSample,
        max_tokens: Optional[int] = None,
        temperature: Optional[float] = None,
    ) -> VoiceOutput: ...

    def infer_batch(
        self,
        samples: List[VoiceSample],
        max_tokens: Optional[int] = None,
        temperature: Optional[float] = None,
    ) -> List[VoiceOutput]:
        return [self.infer(s, max_tokens, temperature) for s in samples]

    def infer_stream(
        self,
        sample: VoiceSample,
        max_tokens: Optional[int] = None,
        temperature: Optional[float] = None,
    ) -> InferenceGenerator:
        out = self.infer(sample, max_tokens, temperature)
        yield InferenceChunk(out.text)
        yield InferenceStats(out.input_tokens, out.output_tokens)

    def update_conversation(self, past_messages=None, past_cache=None) -> None:
        """Hook for conversation-mode engines; no-op by default."""
