"""``VoiceSample``, the data record of the front doors and the data pipeline
(chat ``messages`` + float32 16 kHz mono ``audio``), and WAV codecs for such
audio without librosa: the ``soundfile`` package where present, else the
stdlib ``wave`` module."""

from __future__ import annotations

import base64
import dataclasses
import io
from typing import Any, Dict, List, Optional

import numpy as np

SAMPLE_RATE = 16000


def audio_from_wav_bytes(data: bytes) -> tuple[np.ndarray, int]:
    """Decode a WAV file to float32 mono: (audio, sample rate)."""
    try:
        import soundfile as sf
    except ImportError:
        import wave

        with wave.open(io.BytesIO(data)) as w:
            sr = w.getframerate()
            n = w.getnframes()
            width = w.getsampwidth()
            channels = w.getnchannels()
            raw = w.readframes(n)
        dtype = {1: np.uint8, 2: np.int16, 4: np.int32}[width]
        audio = np.frombuffer(raw, dtype=dtype).astype(np.float32)
        if width == 1:
            audio = (audio - 128.0) / 128.0
        else:
            audio = audio / float(np.iinfo(dtype).max)
        if channels > 1:
            audio = audio.reshape(-1, channels).mean(axis=1)
        return audio, sr
    audio, sr = sf.read(io.BytesIO(data), dtype="float32")
    if audio.ndim > 1:
        audio = audio.mean(axis=1)
    return audio.astype(np.float32), sr


def audio_to_wav_bytes(audio: np.ndarray, sample_rate: int = SAMPLE_RATE) -> bytes:
    """16-bit PCM mono WAV of float audio in [-1, 1] (clipped)."""
    import wave

    pcm = np.clip(audio, -1.0, 1.0)
    pcm = (pcm * 32767.0).astype(np.int16)
    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sample_rate)
        w.writeframes(pcm.tobytes())
    return buf.getvalue()


def normalize_audio_dtype(audio: np.ndarray) -> np.ndarray:
    """int16 / int32 / float64 audio to float32 in [-1, 1]."""
    audio = np.asarray(audio)
    if audio.dtype == np.float32:
        return audio
    if audio.dtype == np.float64:
        return audio.astype(np.float32)
    if audio.dtype == np.int16:
        return (audio / np.float32(32768.0)).astype(np.float32)
    if audio.dtype == np.int32:
        return (audio / np.float32(2147483648.0)).astype(np.float32)
    raise ValueError(f"unsupported audio dtype {audio.dtype}")


@dataclasses.dataclass
class VoiceSample:
    """A chat conversation with optional audio bound to an ``<|audio|>``
    placeholder in one of the messages."""

    messages: List[Dict[str, str]]
    audio: Optional[np.ndarray] = None
    sample_rate: int = SAMPLE_RATE
    audio_transcript: Optional[str] = None
    label: Optional[str] = None
    extra_kwargs: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        if self.audio is not None:
            self.audio = normalize_audio_dtype(self.audio)

    @classmethod
    def from_prompt(cls, prompt: str) -> "VoiceSample":
        return cls(messages=[{"role": "user", "content": prompt}])

    @classmethod
    def from_prompt_and_audio(
        cls, prompt: str, audio: np.ndarray, sample_rate: int = SAMPLE_RATE
    ) -> "VoiceSample":
        if "<|audio|>" not in prompt:
            prompt = "<|audio|>\n" + prompt if prompt else "<|audio|>"
        return cls(messages=[{"role": "user", "content": prompt}], audio=audio,
                   sample_rate=sample_rate)

    @classmethod
    def from_prompt_and_raw_wav(cls, prompt: str, wav_bytes: bytes) -> "VoiceSample":
        audio, sr = audio_from_wav_bytes(wav_bytes)
        return cls.from_prompt_and_audio(prompt, audio, sr)

    @classmethod
    def from_json(cls, d: Dict[str, Any]) -> "VoiceSample":
        audio = None
        sr = d.get("sample_rate", SAMPLE_RATE)
        if d.get("audio_b64"):
            audio, sr = audio_from_wav_bytes(base64.b64decode(d["audio_b64"]))
        return cls(messages=d["messages"], audio=audio, sample_rate=sr)

    def to_json(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {"messages": self.messages}
        if self.audio is not None:
            out["audio_b64"] = base64.b64encode(
                audio_to_wav_bytes(self.audio, self.sample_rate)).decode()
            out["sample_rate"] = self.sample_rate
        return out

    def add_past_messages(self, past: List[Dict[str, str]]) -> None:
        self.messages = past + self.messages
