"""Augmentation base: probability-gated transforms with children composition
(reference: data/aug/base.py:11-58)."""

from __future__ import annotations

import dataclasses
import random
from typing import List, Optional

import numpy as np

from ultravox_torch.data.sample import SAMPLE_RATE, VoiceSample


@dataclasses.dataclass
class AugmentationArgs:
    sample_rate: int = SAMPLE_RATE
    seed: int = 42


class Augmentation:
    """Base transform. ``p`` gates application; ``children`` compose — a
    grouped augmentation applies all its children when it fires."""

    def __init__(
        self,
        args: AugmentationArgs,
        p: float = 1.0,
        children: Optional[List["Augmentation"]] = None,
        name: Optional[str] = None,
    ):
        self.args = args
        self.p = p
        self.children = children or []
        self._name = name or self.__class__.__name__
        self._rng = random.Random(args.seed)

    @property
    def name(self) -> str:
        return self._name

    def apply_sample(self, sample: VoiceSample) -> VoiceSample:
        if sample.audio is None:
            return sample
        audio = self.apply_audio(sample.audio)
        out = dataclasses.replace(sample)
        out.audio = audio
        return out

    def apply_audio(self, audio: np.ndarray) -> np.ndarray:
        if self._rng.random() > self.p:
            return audio
        audio = self._apply(audio)
        for child in self.children:
            audio = child.apply_audio(audio)
        return audio

    def _apply(self, audio: np.ndarray) -> np.ndarray:
        return audio


class NoopAugmentation(Augmentation):
    pass
