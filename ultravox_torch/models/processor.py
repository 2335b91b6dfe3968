"""Joint text+audio preprocessing and batch collation.

Re-implementation of the reference ``UltravoxProcessor`` +
``DataCollatorForSeq2SeqWithAudio`` (ultravox_processing.py:12-387) on top of
the in-repo mel frontend (no HF feature-extractor dependency), producing
numpy batches, which both engines take:

- long audio is chunked into ≤ ``audio_context_size`` (=3000 mel frame / 30 s)
  encoder windows, continuation chunks sharing one text placeholder
  (ultravox_processing.py:153-215);
- each chunk occupies ``ceil(mel_len / (encoder_ds × stack_factor))`` LLM
  positions, spliced at ``<|audio|>`` placeholders (:316-366);
- the collator flattens chunks across the batch and emits an explicit
  ``audio_chunk_batch_idx`` mapping (instead of the reference's
  ``audio_batch_size`` counts) so the model-side scatter is fixed-shape;
- padding is right-side everywhere (positions and cache offsets stay
  prefix-contiguous; the reference's left-padding displacement fix at
  :53-63 becomes unnecessary).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Sequence, Union

import numpy as np

from ultravox_torch.ops import mel as mel_lib

AUDIO_PLACEHOLDER = "<|audio|>"


@dataclasses.dataclass
class RawAudioFeatureExtractor:
    """Wav2Vec2-style raw-waveform 'features': right-padded waveforms shaped
    (B, 1, T_samples) so the chunking/collation path treats them like mel
    features; lens are sample counts. Optional per-utterance zero-mean /
    unit-variance normalisation (HF Wav2Vec2FeatureExtractor do_normalize)."""

    sampling_rate: int = 16000
    hop_length: int = 1  # samples are the time unit
    normalize: bool = True

    def __call__(self, audios: Sequence[np.ndarray]):
        lens = [len(a) for a in audios]
        max_len = max(lens)
        feats = []
        for a in audios:
            a = np.asarray(a, dtype=np.float32)
            if self.normalize and len(a):
                a = (a - a.mean()) / np.sqrt(a.var() + 1e-7)
            feats.append(np.pad(a, (0, max_len - len(a)))[None])  # (1, T)
        return np.stack(feats), np.asarray(lens, dtype=np.int64)


@dataclasses.dataclass
class AudioFeatureExtractor:
    """WhisperFeatureExtractor-equivalent built on ``ultravox_torch.ops.mel``.

    ``__call__`` takes a list of 1-D float32 waveforms, right-pads the batch
    to the longest length rounded up to a multiple of ``hop_length``, and
    returns (features (B, n_mels, T_frames), frame_lens (B,)) where
    frame_lens[i] = ceil(len_i / hop) — matching the reference's
    ``attention_mask.sum(-1)`` semantics (ultravox_processing.py:295-310).
    """

    num_mel_bins: int = 80
    hop_length: int = mel_lib.HOP_LENGTH
    sampling_rate: int = mel_lib.SAMPLE_RATE

    def __call__(self, audios: Sequence[np.ndarray]):
        hop = self.hop_length
        lens = [len(a) for a in audios]
        max_len = max(lens)
        max_len = (max_len + hop - 1) // hop * hop
        feats = []
        for a in audios:
            a = np.asarray(a, dtype=np.float32)
            padded = np.pad(a, (0, max_len - len(a)))
            feats.append(
                mel_lib.log_mel_spectrogram_np(padded, self.num_mel_bins)
            )
        frame_lens = np.array([-(-l // hop) for l in lens], dtype=np.int64)
        return np.stack(feats), frame_lens


class UltravoxProcessor:
    """Prepares one text sequence with any number of audios for the model.

    Args mirror the reference (ultravox_processing.py:86-128): ``tokenizer``
    is any HF-compatible tokenizer (host-side library); the audio-placeholder
    positions are filled with ``tokenizer.eos_token`` repeats.
    """

    def __init__(
        self,
        tokenizer,
        num_mel_bins: int = 80,
        encoder_ds_factor: int = 2,
        stack_factor: int = 8,
        audio_placeholder: str = AUDIO_PLACEHOLDER,
        audio_context_size: Optional[int] = 3000,
        audio_arch: str = "whisper",
        wav2vec2_config=None,  # the tower config (feature_lengths, min_samples) for wav2vec2
        normalize_audio: bool = True,  # wav2vec2: per-utterance zero-mean/unit-var
    ):
        assert tokenizer.eos_token is not None, "tokenizer has no EOS token"
        self.tokenizer = tokenizer
        self.audio_arch = audio_arch
        self.wav2vec2_config = wav2vec2_config
        self.normalize_audio = normalize_audio
        if audio_arch == "wav2vec2":
            assert wav2vec2_config is not None, (
                "wav2vec2 processing needs the tower config for the conv "
                "length formula"
            )
            self.feature_extractor = RawAudioFeatureExtractor(
                normalize=normalize_audio
            )
            # 30 s of raw samples per encoder window
            if audio_context_size == 3000:  # whisper default -> samples
                audio_context_size = 30 * 16000
        else:
            self.feature_extractor = AudioFeatureExtractor(
                num_mel_bins=num_mel_bins
            )
        self.encoder_ds_factor = encoder_ds_factor
        self.stack_factor = stack_factor
        self.audio_placeholder = audio_placeholder
        self.audio_context_size = audio_context_size
        self.audio_token_replacement = tokenizer.eos_token
        self.audio_replacement_token_id = tokenizer.get_vocab()[tokenizer.eos_token]
        if tokenizer.pad_token_id is None:
            tokenizer.pad_token_id = tokenizer.eos_token_id

    @property
    def token_compression(self) -> int:
        return self.encoder_ds_factor * self.stack_factor

    def _num_audio_tokens(self, lens: np.ndarray) -> np.ndarray:
        """LLM tokens per audio chunk: whisper = ceil(frames / (ds*stack));
        wav2vec2 = ceil(conv_out(samples) / stack)."""
        if self.audio_arch == "wav2vec2":
            frames = self.wav2vec2_config.feature_lengths(
                np.asarray(lens, dtype=np.int64)
            )
            return np.ceil(
                np.maximum(frames, 1) / self.stack_factor
            ).astype(np.int32)
        return np.ceil(np.asarray(lens) / self.token_compression).astype(
            np.int32
        )

    def _chunk_and_pad_audio(self, audio_values: np.ndarray, audio_lens: np.ndarray):
        """Split each item into ≤context_size windows (reference:
        ultravox_processing.py:153-215)."""
        context = self.audio_context_size or audio_values.shape[-1]
        chunks: List[np.ndarray] = []
        chunk_lens: List[int] = []
        is_continuation: List[bool] = []
        num_chunks: List[int] = []
        for i in range(audio_values.shape[0]):
            n = int(math.ceil(audio_lens[i] / context))
            num_chunks.append(n)
            for offset in range(0, int(audio_lens[i]), context):
                cont = offset > 0
                chunk = audio_values[i, :, offset : offset + context]
                if cont and chunk.shape[-1] < context:
                    chunk = np.pad(chunk, ((0, 0), (0, context - chunk.shape[-1])))
                chunks.append(chunk)
                chunk_lens.append(min(int(audio_lens[i]) - offset, context))
                is_continuation.append(cont)
        return {
            "audio_values": np.stack(chunks),
            "audio_lens": np.asarray(chunk_lens, dtype=np.int64),
            "audio_is_continuation": np.asarray(is_continuation, dtype=bool),
            "audio_num_chunks": np.asarray(num_chunks, dtype=np.int64),
        }

    def __call__(
        self,
        text: Optional[str] = None,
        audio: Optional[np.ndarray] = None,
        audios: Optional[Sequence[np.ndarray]] = None,
        sampling_rate: int = 16000,
        audio_token_lens: Optional[Sequence[int]] = None,
    ) -> Dict[str, np.ndarray]:
        """Returns numpy features: input_ids/attention_mask (1, T) and, with
        audio, audio_values (N, n_mels, T_mel) + audio_lens/audio_token_len/
        audio_token_start_idx/audio_num_chunks (ultravox_processing.py:217-370).

        ``audio_token_lens``: expand the placeholders for KNOWN per-chunk
        token counts WITHOUT extracting features — the streaming voice path
        computes audio embeddings incrementally (inference/streaming.py) and
        submits them precomputed, so no mel/audio_values are needed here.
        """
        if audio is not None and audios is not None:
            raise ValueError("Only one of `audio` or `audios` should be provided.")
        if audio_token_lens is not None:
            if audio is not None or audios is not None:
                raise ValueError(
                    "audio_token_lens replaces audio/audios, not both"
                )
            parts = self.tokenizer(
                text.split(self.audio_placeholder), add_special_tokens=False
            )["input_ids"]
            if len(parts) != len(audio_token_lens) + 1:
                raise ValueError(
                    f"Text has {len(parts) - 1} audio placeholders for "
                    f"{len(audio_token_lens)} audio_token_lens"
                )
            input_ids: List[int] = []
            starts: List[int] = []
            for i, tl in enumerate(audio_token_lens):
                input_ids.extend(parts[i])
                starts.append(len(input_ids))
                input_ids.extend(
                    [self.audio_replacement_token_id] * int(tl)
                )
            input_ids.extend(parts[-1])
            ids = np.asarray([input_ids], dtype=np.int32)
            return {
                "input_ids": ids,
                "attention_mask": np.ones_like(ids),
                "audio_token_len": np.asarray(audio_token_lens, np.int32),
                "audio_token_start_idx": np.asarray(starts, np.int32),
                "audio_chunk_batch_idx": np.zeros(
                    len(starts), np.int32
                ),
            }
        if audio is not None:
            audios = audio if isinstance(audio, list) or audio.ndim == 2 else [audio]
        elif audios is None:
            audios = []
        if sampling_rate != self.feature_extractor.sampling_rate:
            raise ValueError(
                f"expected {self.feature_extractor.sampling_rate} Hz audio, "
                f"got {sampling_rate}; resample on the data path first."
            )

        data: Dict[str, np.ndarray] = {}
        audio_is_continuation = np.zeros(0, dtype=bool)
        if len(audios) > 0:
            hop = self.feature_extractor.hop_length
            min_len = (
                self.wav2vec2_config.min_samples
                if self.audio_arch == "wav2vec2"
                else 2 * hop
            )
            audios = [
                np.pad(x, (0, min_len - len(x))) if len(x) < min_len else np.asarray(x)
                for x in audios
            ]
            feats, frame_lens = self.feature_extractor(audios)
            data.update(self._chunk_and_pad_audio(feats, frame_lens))
            audio_is_continuation = data.pop("audio_is_continuation")
            data["audio_token_len"] = self._num_audio_tokens(data["audio_lens"])

        if text is not None:
            if not isinstance(text, str):
                raise ValueError("Text must be a string. Batch mode not supported yet.")
            parts = self.tokenizer(
                text.split(self.audio_placeholder), add_special_tokens=False
            )["input_ids"]

            input_ids: List[int] = []
            audio_token_start_idx: List[int] = []
            placeholder_index = -1
            for i, token_len in enumerate(data.get("audio_token_len", [])):
                if not audio_is_continuation[i]:
                    placeholder_index += 1
                    if placeholder_index >= len(parts):
                        raise ValueError(
                            "Text contains too few audio placeholders. "
                            f"(Expected {len(audios)} placeholders)"
                        )
                    input_ids.extend(parts[placeholder_index])
                audio_token_start_idx.append(len(input_ids))
                input_ids.extend([self.audio_replacement_token_id] * int(token_len))

            placeholder_index += 1
            if placeholder_index != len(parts) - 1:
                found = len(parts) - 1
                raise ValueError(
                    f"Text contains {found} audio placeholder(s) but "
                    f"{len(audios)} audio clip(s) were provided. "
                    "(One <|audio|> per clip.)"
                )
            input_ids.extend(parts[placeholder_index])

            if "audio_token_len" in data:
                data["audio_token_start_idx"] = np.asarray(
                    audio_token_start_idx, dtype=np.int32
                )
            data["input_ids"] = np.asarray([input_ids], dtype=np.int32)
            data["attention_mask"] = np.ones_like(data["input_ids"])
        return data

    def decode(self, *args, **kwargs):
        return self.tokenizer.decode(*args, **kwargs)

    def batch_decode(self, *args, **kwargs):
        return self.tokenizer.batch_decode(*args, **kwargs)


def make_processor(tokenizer, cfg) -> UltravoxProcessor:
    """The processor for an ``UltravoxConfig``'s tower: log-mel features for
    Whisper, raw samples (normalised per utterance) for wav2vec2."""
    w2v = cfg.audio_arch == "wav2vec2"
    return UltravoxProcessor(
        tokenizer,
        num_mel_bins=getattr(cfg.audio_config, "num_mel_bins", 80),
        stack_factor=cfg.stack_factor,
        audio_arch=cfg.audio_arch,
        wav2vec2_config=cfg.audio_config if w2v else None,
    )


def _pad_to(arr: np.ndarray, length: int, value=0) -> np.ndarray:
    pad = [(0, 0)] * arr.ndim
    pad[-1] = (0, length - arr.shape[-1])
    return np.pad(arr, pad, constant_values=value)


@dataclasses.dataclass
class DataCollatorWithAudio:
    """Batch collation (reference: DataCollatorForSeq2SeqWithAudio,
    ultravox_processing.py:12-64), right-padding, with optional shape
    bucketing so the set of batch shapes stays bounded.

    ``pad_multiple`` rounds the text length up; ``mel_pad_multiple`` rounds
    the mel time axis up. ``include_alt_fields`` collates the text-only
    teacher stream for KL distillation.
    """

    pad_token_id: int
    include_alt_fields: bool = False
    pad_multiple: int = 64
    mel_pad_multiple: int = 400  # 4 s of mel frames
    label_pad_value: int = -100
    # cap on the padded audio time axis: the whisper encoder window is 3000
    # mel frames; wav2vec2 raw-sample batches need the processor's
    # audio_context_size (in samples) instead — a 3000 cap there yields
    # ragged chunk lengths and np.stack crashes
    max_audio_len: int = 3000

    def _collate_text(self, seqs: List[np.ndarray], pad_value) -> np.ndarray:
        max_len = max(s.shape[-1] for s in seqs)
        max_len = -(-max_len // self.pad_multiple) * self.pad_multiple
        return np.stack([_pad_to(np.asarray(s), max_len, pad_value) for s in seqs])

    def __call__(self, features: List[Dict[str, Any]]) -> Dict[str, np.ndarray]:
        features = [dict(f) for f in features]
        audio_values, audio_lens, token_len, start_idx, batch_idx = [], [], [], [], []
        for b, f in enumerate(features):
            vals = f.pop("audio_values", None)
            if vals is None or len(vals) == 0:
                f.pop("audio_lens", None)
                f.pop("audio_token_len", None)
                f.pop("audio_token_start_idx", None)
                f.pop("audio_num_chunks", None)
                continue
            n = len(vals)
            audio_values.extend(list(vals))
            audio_lens.extend(list(f.pop("audio_lens")))
            token_len.extend(list(f.pop("audio_token_len")))
            start_idx.extend(list(f.pop("audio_token_start_idx")))
            batch_idx.extend([b] * n)
            f.pop("audio_num_chunks", None)

        batch: Dict[str, np.ndarray] = {}
        ids = [np.asarray(f["input_ids"]).reshape(-1) for f in features]
        batch["input_ids"] = self._collate_text(ids, self.pad_token_id)
        batch["attention_mask"] = self._collate_text(
            [np.ones(len(s), dtype=np.int32) for s in ids], 0
        )
        if "labels" in features[0]:
            batch["labels"] = self._collate_text(
                [np.asarray(f["labels"]).reshape(-1) for f in features],
                self.label_pad_value,
            )
        if self.include_alt_fields:
            alt_ids = [np.asarray(f["alt_input_ids"]).reshape(-1) for f in features]
            batch["alt_input_ids"] = self._collate_text(alt_ids, self.pad_token_id)
            batch["alt_attention_mask"] = self._collate_text(
                [np.ones(len(s), dtype=np.int32) for s in alt_ids], 0
            )
            batch["alt_labels"] = self._collate_text(
                [np.asarray(f["alt_labels"]).reshape(-1) for f in features],
                self.label_pad_value,
            )

        if audio_values:
            max_mel = max(v.shape[-1] for v in audio_values)
            max_mel = -(-max_mel // self.mel_pad_multiple) * self.mel_pad_multiple
            max_mel = min(max_mel, self.max_audio_len)
            batch["audio_values"] = np.stack(
                [_pad_to(v, max(max_mel, v.shape[-1])) for v in audio_values]
            )
            batch["audio_lens"] = np.asarray(audio_lens, dtype=np.int32)
            batch["audio_token_len"] = np.asarray(token_len, dtype=np.int32)
            batch["audio_token_start_idx"] = np.asarray(start_idx, dtype=np.int32)
            batch["audio_chunk_batch_idx"] = np.asarray(batch_idx, dtype=np.int32)
        return batch
