"""WAV codecs for 16 kHz mono float32 audio, without librosa: the
``soundfile`` package where present, else the stdlib ``wave`` module."""

from __future__ import annotations

import io

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
