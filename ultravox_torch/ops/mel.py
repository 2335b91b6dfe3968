"""Whisper-compatible log-mel spectrogram.

- ``log_mel_spectrogram_np``: host numpy in float64, the same numerics as
  HF ``WhisperFeatureExtractor``.
- ``log_mel_spectrogram``: batched torch version on any device (fp32 rFFT).

Whisper constants: n_fft=400, hop=160, 16 kHz, periodic Hann, reflect-centre
padding, power spectrogram, slaney mel scale and norm, log10 with a 1e-10
floor, per-sample ``max(x, x.max() - 8)``, then ``(x + 4) / 4``.
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

SAMPLE_RATE = 16000
N_FFT = 400
HOP_LENGTH = 160
N_MELS = 80


def hertz_to_mel_slaney(freq):
    freq = np.asarray(freq, dtype=np.float64)
    min_log_hertz, min_log_mel = 1000.0, 15.0
    logstep = 27.0 / np.log(6.4)
    mels = 3.0 * freq / 200.0
    return np.where(
        freq >= min_log_hertz,
        min_log_mel + np.log(np.maximum(freq, 1e-12) / min_log_hertz) * logstep,
        mels,
    )


def mel_to_hertz_slaney(mels):
    mels = np.asarray(mels, dtype=np.float64)
    min_log_hertz, min_log_mel = 1000.0, 15.0
    logstep = np.log(6.4) / 27.0
    freq = 200.0 * mels / 3.0
    return np.where(
        mels >= min_log_mel,
        min_log_hertz * np.exp(logstep * (mels - min_log_mel)),
        freq,
    )


@functools.lru_cache(maxsize=8)
def mel_filter_bank(
    num_frequency_bins: int = N_FFT // 2 + 1,
    num_mel_filters: int = N_MELS,
    min_frequency: float = 0.0,
    max_frequency: float = 8000.0,
    sampling_rate: int = SAMPLE_RATE,
) -> np.ndarray:
    """Slaney-scale, slaney-normalised triangular filters
    (num_frequency_bins, num_mel_filters), float32."""
    fft_freqs = np.linspace(0, sampling_rate // 2, num_frequency_bins)
    mel_freqs = np.linspace(
        hertz_to_mel_slaney(min_frequency),
        hertz_to_mel_slaney(max_frequency),
        num_mel_filters + 2,
    )
    filter_freqs = mel_to_hertz_slaney(mel_freqs)
    fdiff = np.diff(filter_freqs)
    slopes = filter_freqs[np.newaxis, :] - fft_freqs[:, np.newaxis]
    down = -slopes[:, :-2] / fdiff[:-1]
    up = slopes[:, 2:] / fdiff[1:]
    fb = np.maximum(0.0, np.minimum(down, up))
    enorm = 2.0 / (filter_freqs[2 : num_mel_filters + 2] - filter_freqs[:num_mel_filters])
    return (fb * enorm[np.newaxis, :]).astype(np.float32)


def hann_window(n: int = N_FFT) -> np.ndarray:
    """Periodic Hann window."""
    return np.hanning(n + 1)[:-1].astype(np.float64)


def log_mel_spectrogram_np(
    waveform: np.ndarray, num_mel_filters: int = N_MELS
) -> np.ndarray:
    """One waveform -> (num_mel_filters, len(waveform) // HOP_LENGTH) float32
    (the final STFT frame is dropped, as the HF extractor does)."""
    waveform = np.asarray(waveform, dtype=np.float64)
    half = N_FFT // 2
    padded = np.pad(waveform, (half, half), mode="reflect")
    num_frames = 1 + (len(padded) - N_FFT) // HOP_LENGTH
    idx = np.arange(num_frames)[:, None] * HOP_LENGTH + np.arange(N_FFT)[None, :]
    frames = padded[idx] * hann_window(N_FFT)[None, :]
    power = np.abs(np.fft.rfft(frames, axis=-1)) ** 2
    fb = mel_filter_bank(num_mel_filters=num_mel_filters).astype(np.float64)
    log_spec = np.log10(np.maximum(power @ fb, 1e-10)).T[:, :-1]
    log_spec = np.maximum(log_spec, log_spec.max() - 8.0)
    return ((log_spec + 4.0) / 4.0).astype(np.float32)


def log_mel_spectrogram(
    waveforms: torch.Tensor,  # (B, n_samples) float
    num_mel_filters: int = N_MELS,
    num_frames: Optional[int] = None,
) -> torch.Tensor:
    """Batched log-mel on the waveforms' device: (B, n_mels, num_frames),
    num_frames defaulting to n_samples // HOP_LENGTH. The dynamic-range
    clamp is per sample over all of its frames, as in the host version."""
    B, n_samples = waveforms.shape
    if num_frames is None:
        num_frames = n_samples // HOP_LENGTH
    half = N_FFT // 2
    x = F.pad(waveforms.float()[:, None], (half, half), mode="reflect")[:, 0]
    frames = x.unfold(-1, N_FFT, HOP_LENGTH)[:, :num_frames]  # (B, T, N_FFT)
    window = torch.as_tensor(hann_window().astype(np.float32), device=x.device)
    stft = torch.fft.rfft(frames * window, dim=-1)
    power = stft.real.square() + stft.imag.square()
    fb = torch.as_tensor(mel_filter_bank(num_mel_filters=num_mel_filters), device=x.device)
    mel = torch.einsum("btk,km->btm", power, fb)
    log_spec = torch.log10(torch.clamp(mel, min=1e-10))
    max_val = log_spec.amax(dim=(1, 2), keepdim=True)
    log_spec = torch.maximum(log_spec, max_val - 8.0)
    return ((log_spec + 4.0) / 4.0).transpose(1, 2)
