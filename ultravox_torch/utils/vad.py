"""Energy-based voice activity detection with reply-on-pause semantics.

Replaces the reference voice demo's ``gradio_webrtc.ReplyOnPause``
(reference: tools/gradio_voice.py) without external VAD dependencies: an
adaptive-noise-floor energy detector over fixed frames, plus a state machine
that fires once speech has started and a pause of ``pause_ms`` follows.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np


@dataclasses.dataclass
class VadConfig:
    sample_rate: int = 16000
    frame_ms: int = 30
    # speech when frame RMS > max(abs_threshold, noise_floor * snr_ratio)
    abs_threshold: float = 0.008
    snr_ratio: float = 3.0
    noise_decay: float = 0.98  # noise-floor EMA on non-speech frames
    start_frames: int = 3  # consecutive speech frames to enter SPEECH
    pause_ms: int = 700  # silence run that ends an utterance
    min_speech_ms: int = 250  # utterances shorter than this are dropped
    pre_roll_ms: int = 240  # audio kept from before speech start


class ReplyOnPause:
    """Feed PCM float32 chunks with ``process(chunk)``; returns the full
    utterance (np.float32 at the configured rate) when the speaker pauses,
    else None. ``flush()`` force-ends the current utterance."""

    def __init__(self, config: Optional[VadConfig] = None):
        self.config = config or VadConfig()
        c = self.config
        self._frame_len = c.sample_rate * c.frame_ms // 1000
        self._pause_frames = max(1, c.pause_ms // c.frame_ms)
        self._min_speech_frames = max(1, c.min_speech_ms // c.frame_ms)
        self._pre_roll_frames = max(1, c.pre_roll_ms // c.frame_ms)
        self.reset()

    def reset(self) -> None:
        self._residual = np.zeros(0, np.float32)
        self._noise_floor = self.config.abs_threshold
        self._in_speech = False
        self._speech_run = 0
        self._silence_run = 0
        self._pre_roll: List[np.ndarray] = []
        self._utterance: List[np.ndarray] = []
        self._speech_frames = 0

    def _frame_is_speech(self, frame: np.ndarray) -> bool:
        rms = float(np.sqrt(np.mean(np.square(frame))))
        threshold = max(
            self.config.abs_threshold, self._noise_floor * self.config.snr_ratio
        )
        if rms <= threshold:
            self._noise_floor = (
                self.config.noise_decay * self._noise_floor
                + (1 - self.config.noise_decay) * rms
            )
            return False
        return True

    def process(self, chunk: np.ndarray) -> Optional[np.ndarray]:
        """Returns a finished utterance when a pause ends one, else None.

        Frames of the chunk AFTER the completed utterance are kept in the
        residual buffer (they may contain the onset of the next utterance)
        and are consumed by the next ``process`` call."""
        buf = np.concatenate([self._residual, np.asarray(chunk, np.float32)])
        n_frames = len(buf) // self._frame_len
        self._residual = buf[n_frames * self._frame_len:]
        for i in range(n_frames):
            frame = buf[i * self._frame_len: (i + 1) * self._frame_len]
            out = self._step(frame)
            if out is not None:
                self._residual = np.concatenate(
                    [buf[(i + 1) * self._frame_len: n_frames * self._frame_len],
                     self._residual]
                )
                return out
        return None

    def _step(self, frame: np.ndarray) -> Optional[np.ndarray]:
        speech = self._frame_is_speech(frame)
        if not self._in_speech:
            self._pre_roll.append(frame)
            if len(self._pre_roll) > self._pre_roll_frames:
                self._pre_roll.pop(0)
            self._speech_run = self._speech_run + 1 if speech else 0
            if self._speech_run >= self.config.start_frames:
                self._in_speech = True
                self._utterance = list(self._pre_roll)
                self._speech_frames = self._speech_run
                self._silence_run = 0
            return None
        self._utterance.append(frame)
        if speech:
            self._speech_frames += 1
            self._silence_run = 0
            return None
        self._silence_run += 1
        if self._silence_run >= self._pause_frames:
            return self._finish()
        return None

    def _finish(self) -> Optional[np.ndarray]:
        utterance = (
            np.concatenate(self._utterance)
            if self._utterance
            else np.zeros(0, np.float32)
        )
        long_enough = self._speech_frames >= self._min_speech_frames
        self._in_speech = False
        self._speech_run = 0
        self._silence_run = 0
        self._pre_roll = []
        self._utterance = []
        self._speech_frames = 0
        return utterance if long_enough else None

    def flush(self) -> Optional[np.ndarray]:
        """Force-end the in-progress utterance (stream closing)."""
        if self._in_speech:
            return self._finish()
        return None

    @property
    def in_speech(self) -> bool:
        return self._in_speech

    def partial(self) -> Optional[np.ndarray]:
        """Audio of the IN-PROGRESS utterance so far (pre-roll included) —
        a strict prefix of what a later ``process``/``flush`` will return.
        The streaming encoder consumes this incrementally."""
        if not self._in_speech or not self._utterance:
            return None
        return np.concatenate(self._utterance)
