"""Streaming audio front end: incremental mel and block-causal encode.

For models trained with ``audio_latency_block_size`` the encoder is
block-causal, so audio can be encoded while the user is still speaking:
each completed latency block runs one ``encoder_stream_step`` (O(block)
work against the cached K/V, see models/whisper_encoder.py), and at the end
of an utterance only the last partial block and the projector remain
before prefill. The voice WebSocket (inference/serving/api_server.py) uses
this to take the audio tower off the pause-to-first-token path.

Each block's output stays on the device until ``finalize`` concatenates
them. The step and finalize run under ``torch.inference_mode()`` on the
calling thread: autograd's mode is per thread, and a server's handler
threads do not inherit the engine loop's.

Mel caveat: Whisper's log-mel clamps at (global max - 8.0), a statistic of
the whole utterance. The streaming front end clamps each block with the
running max at emit time, so frames more than 80 dB below a peak that
arrives later can differ from the batch front end's; everything above that
floor is bit-identical. In practice this touches only near-silence frames.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from ultravox_torch.models import projector as projector_lib
from ultravox_torch.models import whisper_encoder as encoder_lib
from ultravox_torch.ops import mel as mel_lib


class EncoderWindowExceeded(ValueError):
    """The streamed utterance outgrew the encoder's single-window stream
    state; callers fall back to the batch path's 30 s chunking."""


class StreamingMel:
    """Incremental Whisper log-mel (numpy, float64 inside): ``feed`` returns
    the frames that are final given the audio so far (a frame needs 200
    samples of lookahead); ``finalize`` emits the tail frames with the batch
    front end's reflect padding at the end."""

    def __init__(self, num_mel_filters: int = 80):
        self.n_mels = num_mel_filters
        self._samples = np.zeros(0, np.float32)
        self._emitted = 0  # frames already returned
        self._running_max = -np.inf

    @property
    def frames_emitted(self) -> int:
        return self._emitted

    def _raw_frames(self, a: int, b: int) -> np.ndarray:
        """log10 mel (before the clamp) of frames [a, b)."""
        half = mel_lib.N_FFT // 2
        hop = mel_lib.HOP_LENGTH
        lo = a * hop - half
        hi = (b - 1) * hop + half + 1
        left_pad = max(-lo, 0)
        right_pad = max(hi - len(self._samples), 0)
        seg = self._samples[max(lo, 0): min(hi, len(self._samples))]
        seg = np.asarray(seg, np.float64)
        if left_pad or right_pad:
            # the stream's edges reproduce the batch front end's reflect padding
            seg = np.pad(seg, (left_pad, right_pad), mode="reflect")
        window = mel_lib.hann_window(mel_lib.N_FFT)
        idx = np.arange(b - a)[:, None] * hop + np.arange(mel_lib.N_FFT)[None]
        frames = seg[idx] * window[None]
        power = np.abs(np.fft.rfft(frames, axis=-1)) ** 2
        fb = mel_lib.mel_filter_bank(num_mel_filters=self.n_mels).astype(np.float64)
        return np.log10(np.maximum(power @ fb, 1e-10)).T  # (n_mels, b - a)

    def _emit(self, upto: int) -> Optional[np.ndarray]:
        if upto <= self._emitted:
            return None
        raw = self._raw_frames(self._emitted, upto)
        self._running_max = max(self._running_max, float(raw.max()))
        out = np.maximum(raw, self._running_max - 8.0)
        out = ((out + 4.0) / 4.0).astype(np.float32)
        self._emitted = upto
        return out

    def feed(self, samples: np.ndarray) -> Optional[np.ndarray]:
        """Append samples; return the newly final frames (n_mels, n_new) or
        None. Frame f needs the samples through f * hop + n_fft / 2."""
        self._samples = np.concatenate([self._samples, np.asarray(samples, np.float32)])
        half, hop = mel_lib.N_FFT // 2, mel_lib.HOP_LENGTH
        safe = (len(self._samples) - half - 1) // hop + 1
        # the batch front end emits len // hop frames in all; never more
        safe = min(max(safe, 0), len(self._samples) // hop)
        return self._emit(safe)

    def finalize(self) -> Optional[np.ndarray]:
        """Emit the remaining frames with reflect padding at the end (as
        ``log_mel_spectrogram_np`` on the whole waveform)."""
        return self._emit(len(self._samples) // mel_lib.HOP_LENGTH)


class StreamingAudioEncoder:
    """Incremental block-causal encode and projection of one utterance. Feed
    float32 PCM at 16 kHz; ``finalize`` returns the audio token embeddings
    (n_tokens, d_text) on the tower's device, in ``dtype``, with everything
    but the last partial block computed during the stream. ``dtype`` is the
    dtype the tower computes in (the mel windows, activations and K/V)."""

    def __init__(self, params, cfg, *, dtype=torch.float32):
        if not cfg.audio_latency_block_size:
            raise ValueError("streaming encode needs a block-causal encoder "
                             "(audio_latency_block_size set)")
        self.params = params
        self.cfg = cfg
        self.block = int(cfg.audio_latency_block_size)  # encoder positions
        self.acfg = cfg.audio_config
        self.device = params["audio_tower"]["embed_positions"].device
        self._dtype = dtype
        self.mel = StreamingMel(self.acfg.num_mel_bins)
        with torch.inference_mode():
            self.state = encoder_lib.EncoderStreamState.zeros(self.acfg, dtype, self.device)
        self._mel_frames = np.zeros((self.acfg.num_mel_bins, 0), np.float32)
        self._outputs: List[torch.Tensor] = []  # per block (C, d_model), on the device
        self._blocks_done = 0

    def _window(self, k: int) -> torch.Tensor:
        """Mel window [2kC-2, 2(k+1)C+1) on the device, zero outside the
        stream (the batch conv's zero padding)."""
        C2 = 2 * self.block
        lo, hi = k * C2 - 2, (k + 1) * C2 + 1
        n = self._mel_frames.shape[1]
        w = np.zeros((self.acfg.num_mel_bins, hi - lo), np.float32)
        s, e = max(lo, 0), min(hi, n)
        if e > s:
            w[:, s - lo: e - lo] = self._mel_frames[:, s:e]
        t = torch.from_numpy(w)
        if self.device.type == "cuda":
            # pinned and non-blocking: a pageable copy would wait for every
            # kernel queued on the stream, the engine's included
            t = t.pin_memory().to(self.device, non_blocking=True)
        return t.to(self.device, self._dtype)

    def _check_window(self):
        """The stream state covers one encoder window (max_source_positions,
        about 30 s); past it a block's K/V and position embeddings would not
        fit. Callers catch this and fall back to the batch path, which
        chunks long audio."""
        if (self._blocks_done + 1) * self.block > self.acfg.max_source_positions:
            raise EncoderWindowExceeded(
                f"utterance exceeds the {self.acfg.max_source_positions}-position encoder "
                "window; use the batch path (30 s chunking via audio_is_continuation) for "
                "longer audio")

    def _step(self, n_valid: int):
        self._check_window()
        _, out = encoder_lib.encoder_stream_step(
            self.params["audio_tower"], self.state, self._window(self._blocks_done), n_valid,
            cfg=self.acfg, block_size=self.block)
        self._outputs.append(out)
        self._blocks_done += 1

    def _run_ready_blocks(self):
        """Step every block whose whole mel window (with its one frame of
        lookahead) has arrived."""
        C2 = 2 * self.block
        while (self._blocks_done + 1) * C2 + 1 <= self._mel_frames.shape[1]:
            self._step(self.block)

    def feed(self, samples: np.ndarray) -> None:
        new = self.mel.feed(samples)
        if new is not None:
            self._mel_frames = np.concatenate([self._mel_frames, new], axis=1)
        with torch.inference_mode():
            self._run_ready_blocks()

    @property
    def blocks_encoded(self) -> int:
        return self._blocks_done

    def finalize(self) -> torch.Tensor:
        """Complete the stream: encode the remaining (partial and padding)
        blocks and run the projector. Returns (n_tokens, d_text)."""
        tail = self.mel.finalize()
        if tail is not None:
            self._mel_frames = np.concatenate([self._mel_frames, tail], axis=1)
        with torch.inference_mode():
            self._run_ready_blocks()
            mel_len = self._mel_frames.shape[1]
            feat_len = encoder_lib.feat_extract_output_length(mel_len) if mel_len else 0
            n_tokens = projector_lib.num_audio_tokens(mel_len, self.cfg.audio_token_compression)
            if n_tokens == 0:
                # a stream shorter than one hop has no audio tokens
                d_text = self.params["projector"]["linear_2"]["kernel"].shape[-1]
                return torch.zeros((0, d_text), dtype=self._dtype, device=self.device)
            # the positions the projector stacks, the last token's padding
            # positions included: step zero-mel blocks until they are covered
            need_pos = n_tokens * self.cfg.stack_factor
            C = self.block
            while self._blocks_done * C < need_pos:
                self._step(int(np.clip(feat_len - self._blocks_done * C, 0, C)))
            enc = torch.cat(self._outputs)[:need_pos]
            embeds = projector_lib.projector_forward(self.params["projector"], self.cfg,
                                                     enc[None].to(self._dtype))
            return embeds[0, :n_tokens]
