"""Augmentation implementations.

Reference: data/aug/{noise,gain,resampling,filter,compression}.py — colored
noise, random gain, down-up resampling, Butterworth band/low-pass, and μ-law /
a-law codec round-trips. All host-side numpy/scipy: the data pipeline runs on
the CPU, on its own threads.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ultravox_torch.data.aug.base import Augmentation
from ultravox_torch.utils.audio import resample


class GainAugmentation(Augmentation):
    """Random gain in dB (reference: aug/gain.py:9-45)."""

    def __init__(self, *args, min_gain_db: float = -6.0, max_gain_db: float = 6.0, **kw):
        super().__init__(*args, **kw)
        self.min_gain_db = min_gain_db
        self.max_gain_db = max_gain_db

    def _apply(self, audio: np.ndarray) -> np.ndarray:
        gain_db = self._rng.uniform(self.min_gain_db, self.max_gain_db)
        return (audio * (10.0 ** (gain_db / 20.0))).astype(np.float32)


class ColoredNoiseAugmentation(Augmentation):
    """Additive colored noise at a random SNR. ``exponent`` sets the spectral
    slope: 0 = white, 1 = pink, 2 = brown (reference: aug/noise.py:9-41)."""

    def __init__(
        self, *args,
        min_snr_db: float = 5.0, max_snr_db: float = 30.0,
        exponent: float = 0.0, **kw,
    ):
        super().__init__(*args, **kw)
        self.min_snr_db = min_snr_db
        self.max_snr_db = max_snr_db
        self.exponent = exponent

    def _apply(self, audio: np.ndarray) -> np.ndarray:
        n = len(audio)
        rng = np.random.default_rng(self._rng.randrange(2**31))
        white = rng.standard_normal(n).astype(np.float32)
        if self.exponent > 0:
            spec = np.fft.rfft(white)
            freqs = np.fft.rfftfreq(n)
            freqs[0] = freqs[1] if n > 1 else 1.0
            spec = spec / (freqs ** (self.exponent / 2.0))
            white = np.fft.irfft(spec, n).astype(np.float32)
        noise_rms = np.sqrt(np.mean(white**2)) + 1e-9
        signal_rms = np.sqrt(np.mean(audio**2)) + 1e-9
        snr_db = self._rng.uniform(self.min_snr_db, self.max_snr_db)
        target_noise_rms = signal_rms / (10.0 ** (snr_db / 20.0))
        return (audio + white * (target_noise_rms / noise_rms)).astype(np.float32)


class ResamplingAugmentation(Augmentation):
    """Downsample to a random rate and back (lossy) — reference:
    aug/resampling.py:10-35."""

    def __init__(self, *args, min_rate: int = 8000, max_rate: int = 16000, **kw):
        super().__init__(*args, **kw)
        self.min_rate = min_rate
        self.max_rate = max_rate

    def _apply(self, audio: np.ndarray) -> np.ndarray:
        rate = self._rng.randrange(self.min_rate, self.max_rate + 1, 1000)
        sr = self.args.sample_rate
        if rate >= sr:
            return audio
        down = resample(audio, sr, rate)
        return resample(down, rate, sr)[: len(audio)].astype(np.float32)


class ButterworthFilterAugmentation(Augmentation):
    """Band-pass / low-pass Butterworth filter (reference: aug/filter.py:10-44)."""

    def __init__(
        self, *args,
        btype: str = "lowpass",
        min_cutoff_hz: float = 2000.0, max_cutoff_hz: float = 7500.0,
        order: int = 4, **kw,
    ):
        super().__init__(*args, **kw)
        self.btype = btype
        self.min_cutoff_hz = min_cutoff_hz
        self.max_cutoff_hz = max_cutoff_hz
        self.order = order

    def _apply(self, audio: np.ndarray) -> np.ndarray:
        from scipy.signal import butter, sosfilt

        nyq = self.args.sample_rate / 2.0
        if self.btype == "bandpass":
            low = self._rng.uniform(50.0, 300.0)
            high = self._rng.uniform(self.min_cutoff_hz, self.max_cutoff_hz)
            wn = [low / nyq, min(high / nyq, 0.99)]
        else:
            wn = min(
                self._rng.uniform(self.min_cutoff_hz, self.max_cutoff_hz) / nyq,
                0.99,
            )
        sos = butter(self.order, wn, btype=self.btype, output="sos")
        return sosfilt(sos, audio).astype(np.float32)


def _mulaw(audio: np.ndarray, mu: float = 255.0) -> np.ndarray:
    x = np.clip(audio, -1.0, 1.0)
    comp = np.sign(x) * np.log1p(mu * np.abs(x)) / np.log1p(mu)
    q = np.round((comp + 1.0) / 2.0 * mu) / mu * 2.0 - 1.0  # 8-bit quantise
    return (np.sign(q) * ((1.0 + mu) ** np.abs(q) - 1.0) / mu).astype(np.float32)


def _alaw(audio: np.ndarray, A: float = 87.6) -> np.ndarray:
    x = np.clip(audio, -1.0, 1.0)
    ax = np.abs(x)
    lnA = 1.0 + np.log(A)
    with np.errstate(divide="ignore"):
        comp = np.sign(x) * np.where(
            ax < 1.0 / A, A * ax / lnA, (1.0 + np.log(np.maximum(A * ax, 1e-30))) / lnA
        )
    q = np.round((comp + 1.0) / 2.0 * 255.0) / 255.0 * 2.0 - 1.0
    aq = np.abs(q)
    return (
        np.sign(q)
        * np.where(aq < 1.0 / lnA, aq * lnA / A, np.exp(aq * lnA - 1.0) / A)
    ).astype(np.float32)


class CompressionAugmentation(Augmentation):
    """Telephony codec round-trip: μ-law or a-law 8-bit companding
    (reference: aug/compression.py:186-199 — the audioop path, re-implemented
    since ``audioop`` is removed in Python 3.13)."""

    def __init__(self, *args, codec: str = "mulaw", **kw):
        super().__init__(*args, **kw)
        assert codec in ("mulaw", "alaw")
        self.codec = codec

    def _apply(self, audio: np.ndarray) -> np.ndarray:
        return _mulaw(audio) if self.codec == "mulaw" else _alaw(audio)


# intermediate sample rate + extra encode flags per codec: AMR-NB is an
# 8 kHz codec, AMR-WB a 16 kHz one (both land back at args.sample_rate)
_FFMPEG_CODECS = {
    "amr": {"rate": 8000, "ext": "amr"},
    "amrwb": {"rate": 16000, "ext": "amr", "flags": ["-acodec", "amr_wb"]},
}
# the reference's random AMR sweep (aug/compression.py:202-218): every
# standard AMR-NB + AMR-WB bitrate
AMR_NB_BITRATES = (4750, 5150, 5900, 6700, 7400, 7950, 10200, 12200)
AMR_WB_BITRATES = (
    6600, 8850, 12650, 14250, 15850, 18250, 19850, 23050, 23850,
)


class FfmpegCodecAugmentation(Augmentation):
    """Real lossy-codec round-trip via an ffmpeg subprocess (reference:
    aug/compression.py:16-41,60-183 — FfmpegCompression): encode to AMR-NB /
    AMR-WB at a given bitrate, decode back to the pipeline sample rate, so
    training sees genuine codec artifacts (band-limiting, quantization,
    frame effects) rather than companding alone.

    Differences from the reference (deliberate): audio rides raw f32le pipes
    (stdin -> encoder; decoder -> stdout) with one temp file for the
    compressed container instead of three temp WAVs; and when ffmpeg is
    ABSENT the augmentation degrades to a one-time-warned no-op instead of
    raising, so recipes listing it still run in environments without codecs
    installed (this build's zero-egress CI included). ``ffmpeg_bin`` is
    injectable for tests.

    ``codec="random_amr"`` draws a random (codec, bitrate) from the standard
    AMR-NB/WB tables per call — the reference's AmrCompression sweep."""

    def __init__(
        self, *args,
        codec: str = "amr",
        bitrate: Optional[int] = None,
        ffmpeg_bin: str = "ffmpeg",
        **kw,
    ):
        super().__init__(*args, **kw)
        if codec != "random_amr" and codec not in _FFMPEG_CODECS:
            raise ValueError(
                f"unsupported ffmpeg codec {codec!r}; "
                f"known: {sorted(_FFMPEG_CODECS)} + ['random_amr']"
            )
        if codec in _FFMPEG_CODECS and bitrate is None:
            raise ValueError(f"codec {codec!r} requires a bitrate")
        self.codec = codec
        self.bitrate = bitrate
        self.ffmpeg_bin = ffmpeg_bin
        self._available: Optional[bool] = None  # probed lazily, once
        self._warned = False

    def _probe(self) -> bool:
        if self._available is None:
            import shutil

            self._available = shutil.which(self.ffmpeg_bin) is not None
        return self._available

    def _skip(self, audio: np.ndarray, why: str) -> np.ndarray:
        if not self._warned:
            import logging

            logging.getLogger(__name__).warning(
                "%s: %s — codec round-trip skipped (audio passes through)",
                self.name, why,
            )
            self._warned = True
        return audio

    def _apply(self, audio: np.ndarray) -> np.ndarray:
        if not self._probe():
            return self._skip(audio, f"{self.ffmpeg_bin!r} not on PATH")
        codec, bitrate = self.codec, self.bitrate
        if codec == "random_amr":
            table = [("amr", b) for b in AMR_NB_BITRATES] + [
                ("amrwb", b) for b in AMR_WB_BITRATES
            ]
            codec, bitrate = table[self._rng.randrange(len(table))]
        spec = _FFMPEG_CODECS[codec]
        sr = self.args.sample_rate
        import os
        import subprocess
        import tempfile

        fd, comp_path = tempfile.mkstemp(suffix=f".{spec['ext']}")
        os.close(fd)
        try:
            quiet = ["-hide_banner", "-loglevel", "error", "-y"]
            enc = subprocess.run(
                [self.ffmpeg_bin, *quiet,
                 "-f", "f32le", "-ar", str(sr), "-ac", "1", "-i", "-",
                 "-ar", str(spec["rate"]), "-ac", "1",
                 "-ab", str(int(bitrate)), *spec.get("flags", []),
                 comp_path],
                input=np.ascontiguousarray(audio, np.float32).tobytes(),
                capture_output=True, timeout=60,
            )
            if enc.returncode != 0:
                return self._skip(
                    audio, f"encode failed: {enc.stderr[-200:]!r}"
                )
            dec = subprocess.run(
                [self.ffmpeg_bin, *quiet, "-i", comp_path,
                 "-f", "f32le", "-ar", str(sr), "-ac", "1", "-"],
                capture_output=True, timeout=60,
            )
            if dec.returncode != 0 or not dec.stdout:
                return self._skip(
                    audio, f"decode failed: {dec.stderr[-200:]!r}"
                )
        except (subprocess.SubprocessError, OSError) as e:
            return self._skip(audio, f"ffmpeg subprocess error: {e}")
        finally:
            try:
                os.unlink(comp_path)
            except OSError:
                pass
        out = np.frombuffer(dec.stdout, np.float32)
        # codecs add algorithmic delay: keep the caller's length contract
        # (pad/trim to the input length, like the resampling aug)
        if len(out) < len(audio):
            out = np.pad(out, (0, len(audio) - len(out)))
        return out[: len(audio)].astype(np.float32)
