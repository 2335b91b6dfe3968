"""Streaming datasets with declared lengths.

Re-design of the reference's ``data/datasets.py``: plain-Python iterables
that yield numpy (the training loop copies each collated batch to the card;
the data threads never touch torch), with the same semantics:

- ``SizedIterableDataset`` — iterable + ``__len__`` + ``name``;
- ``VoiceDataset`` — streaming base with sample filtering (missing audio,
  too-long audio, empty assistant message, too many input chars;
  datasets.py:184-245);
- ``GenericDataset`` — declarative config-driven dataset over HF streaming /
  local files with Jinja2 message templates (datasets.py:300-471);
- ``InterleaveDataset`` — weighted least-progress-fraction round-robin with
  exhausted-child restart (datasets.py:533-589);
- ``Range`` / ``EmptyDataset`` / ``Dataproc`` (datasets.py:515-670);
- ``SyntheticAsrDataset`` — the offline stand-in for the reference's
  LibriSpeechDummyDataset CI fixture (datasets.py:474-512), generating
  deterministic audio+transcripts with no network.
"""

from __future__ import annotations

import abc
import logging
import random
from typing import Any, Dict, Iterator, Optional, Sequence

import numpy as np

from ultravox_torch.data import types
from ultravox_torch.data.sample import SAMPLE_RATE, VoiceSample
from ultravox_torch.data import text_proc

logger = logging.getLogger(__name__)


class SizedIterableDataset(abc.ABC):
    """Iterable dataset with a declared (possibly estimated) length."""

    @abc.abstractmethod
    def __iter__(self) -> Iterator[VoiceSample]: ...

    @abc.abstractmethod
    def __len__(self) -> int: ...

    @property
    def name(self) -> str:
        return getattr(self, "_name", self.__class__.__name__)


class EmptyDataset(SizedIterableDataset):
    """Zero-length placeholder (reference: datasets.py:515-530)."""

    def __init__(self, estimated_length: int = 0):
        self._estimated_length = estimated_length

    def __iter__(self):
        return iter([])

    def __len__(self):
        return self._estimated_length


class VoiceDataset(SizedIterableDataset):
    """Base streaming dataset over row dicts, with sample filtering."""

    def __init__(self, args: types.VoiceDatasetArgs):
        self._args = args
        self._rng = random.Random(args.shuffle_seed)
        self._name = "voice"
        self._length = 0
        self._dataset: Any = []

    def _init_dataset(self, dataset: Any, name: str, length: int) -> None:
        self._dataset = dataset
        self._name = name
        self._length = length

    def __len__(self):
        return self._length

    def __iter__(self):
        for row in self._dataset:
            sample = self._get_sample(row)
            if sample is None:
                logger.warning("%s: skipping unparseable sample", self._name)
                continue
            if not self._check_sample(sample):
                continue
            yield sample

    @abc.abstractmethod
    def _get_sample(self, row: Dict[str, Any]) -> Optional[VoiceSample]: ...

    def _check_sample(self, sample: VoiceSample) -> bool:
        """Filters (reference: datasets.py:184-245)."""
        args = self._args
        if args.include_audio:
            if sample.audio is None or len(sample.audio) == 0:
                logger.warning("%s: skipping sample with no audio", self._name)
                return False
            duration = len(sample.audio) / sample.sample_rate
            if (
                args.max_audio_duration_secs is not None
                and duration > args.max_audio_duration_secs
            ):
                return False
            if (
                args.min_audio_duration_secs is not None
                and duration < args.min_audio_duration_secs
            ):
                return False
        if not sample.messages or sample.messages[-1]["role"] != "assistant":
            return False
        if not sample.messages[-1]["content"]:
            logger.warning("%s: skipping sample with empty assistant message", self._name)
            return False
        if args.max_input_characters is not None:
            n_chars = sum(len(m["content"]) for m in sample.messages)
            if n_chars > args.max_input_characters:
                return False
        return True

    # -- helpers for subclasses ------------------------------------------

    def _load_hf_dataset(
        self,
        path: str,
        subset: Optional[str] = None,
        split: Optional[str] = None,
        streaming: bool = True,
        audio_field: Optional[str] = None,
    ):
        """HF Hub / local dataset loading with streaming + retry config
        (reference: datasets.py:127-157)."""
        return _load_hf_dataset(
            path, subset, split=split, streaming=streaming, audio_field=audio_field,
            shuffle=self._args.shuffle, shuffle_seed=self._args.shuffle_seed,
        )

    def _load_mds_dataset(
        self,
        path: str,
        *,
        split: Optional[str] = None,
        batch_size: int = 1,
    ):
        """MosaicML-MDS loading (reference: datasets.py:159-182): local dirs
        read through the in-repo shard reader; gs://, s3:// need the
        mosaicml-streaming package."""
        from ultravox_torch.data import mds

        return mds.load_mds_dataset(
            path,
            split=split,
            shuffle=self._args.shuffle,
            shuffle_seed=self._args.shuffle_seed,
            batch_size=batch_size,
        )

    def _get_audio(
        self, row: Dict[str, Any], column: Optional[str] = "audio"
    ) -> Optional[np.ndarray]:
        if column is None or column not in row:
            return None
        audio = row[column]
        if isinstance(audio, (bytes, bytearray)):  # MDS rows store WAV bytes
            from ultravox_torch.data.sample import audio_from_wav_bytes
            from ultravox_torch.utils.audio import resample

            arr, sr = audio_from_wav_bytes(bytes(audio))
            if sr != SAMPLE_RATE:
                arr = resample(arr, sr, SAMPLE_RATE)
            return arr
        if isinstance(audio, dict):  # HF Audio feature
            arr = audio.get("array")
            sr = audio.get("sampling_rate", SAMPLE_RATE)
            if arr is None:
                return None
            arr = np.asarray(arr, dtype=np.float32)
            if sr != SAMPLE_RATE:
                from ultravox_torch.utils.audio import resample

                arr = resample(arr, sr, SAMPLE_RATE)
            return arr
        return np.asarray(audio, dtype=np.float32)


def _load_hf_dataset(
    path: str,
    subset: Optional[str] = None,
    *,
    split: Optional[str] = None,
    streaming: bool = True,
    audio_field: Optional[str] = None,
    shuffle: bool = False,
    shuffle_seed: int = 42,
    cache_dir: Optional[str] = None,
    keep_in_memory: Optional[bool] = None,
):
    """An HF ``datasets`` set, the data loader's one import of it (an
    optional dependency: without it, an HF set raises ImportError).
    ``cache_dir`` (default: HF's) holds the prepared Arrow files;
    ``keep_in_memory`` loads the split into memory, so later ``map`` calls
    keep no cache files of their own."""
    import datasets as hf_datasets

    ds = hf_datasets.load_dataset(
        path,
        subset,
        split=split,
        streaming=streaming,
        download_config=hf_datasets.DownloadConfig(max_retries=10),
        cache_dir=cache_dir,
        keep_in_memory=keep_in_memory,
    )
    if audio_field is not None:
        ds = ds.cast_column(
            audio_field, hf_datasets.Audio(sampling_rate=SAMPLE_RATE)
        )
    if shuffle:
        ds = ds.shuffle(seed=shuffle_seed)
    return ds


class GenericDataset(VoiceDataset):
    """Config-driven dataset (reference: datasets.py:300-471)."""

    def __init__(self, config: types.DatasetConfig, args: types.VoiceDatasetArgs):
        super().__init__(args)
        config.validate()
        self._config = config
        wanted = [
            s for s in (config.splits or []) if s.split == args.split
        ]
        total = sum(s.num_samples for s in wanted)
        datasets = [
            self._load_split(config, s) for s in wanted
        ]
        self._init_dataset(_chain(datasets), config.name, total)

    def _load_split(self, config: types.DatasetConfig, split_cfg):
        if config.use_mds:
            return self._load_mds_dataset(
                config.path,
                split=split_cfg.name,
                batch_size=config.mds_batch_size or 1,
            )
        return self._load_hf_dataset(
            config.path,
            config.subset,
            split=split_cfg.name,
            audio_field=config.audio_field if self._args.include_audio else None,
        )

    def _get_sample(self, row) -> Optional[VoiceSample]:
        cfg = self._config
        try:
            if cfg.messages_direct_column:
                messages = row[cfg.messages_direct_column]
            else:
                user_content = text_proc.render_template(
                    cfg.user_template,
                    row,
                    template_args=cfg.user_template_args,
                    language=self._args.language,
                )
                assistant_content = text_proc.render_template(
                    cfg.assistant_template or "{{text}}", row
                )
                messages = []
                if cfg.system_prompt:
                    messages.append(
                        {"role": "system", "content": cfg.system_prompt}
                    )
                messages.append({"role": "user", "content": user_content})
                messages.append({"role": "assistant", "content": assistant_content})
        except text_proc.TemplateError as e:
            logger.warning("%s: %s", self._name, e)
            return None

        audio = (
            self._get_audio(row, cfg.audio_field)
            if self._args.include_audio
            else None
        )
        transcript = None
        if cfg.transcript_template:
            try:
                transcript = text_proc.render_template(cfg.transcript_template, row)
            except text_proc.TemplateError:
                transcript = None

        if not self._args.include_audio:
            # no-audio fallback: replace the placeholder with the transcript
            # (reference: datasets.py GenericDataset no-audio path)
            messages = [
                {
                    "role": m["role"],
                    "content": m["content"].replace(
                        types.AUDIO_PLACEHOLDER, transcript or ""
                    ),
                }
                for m in messages
            ]
            audio = None
        return VoiceSample(
            messages=messages, audio=audio, audio_transcript=transcript
        )


def _chain(iterables: Sequence[Any]):
    class _Chain:
        def __iter__(self):
            for it in iterables:
                yield from it

    return _Chain()


class InterleaveDataset(SizedIterableDataset):
    """Weighted interleave by least progress fraction; exhausted children
    restart (infinite epoch semantics) — reference: datasets.py:533-589."""

    def __init__(
        self,
        datasets: Sequence[SizedIterableDataset],
        weights: Optional[Sequence[float]] = None,
    ):
        self._datasets = list(datasets)
        self._weights = list(weights) if weights else [1.0] * len(self._datasets)
        assert len(self._weights) == len(self._datasets)
        self._name = "+".join(d.name for d in self._datasets)

    def __len__(self):
        # one "epoch" = each dataset seen ~weight-proportionally
        return int(
            sum(w * len(d) for w, d in zip(self._weights, self._datasets))
        )

    def __iter__(self):
        iters = [iter(d) for d in self._datasets]
        counts = [0] * len(iters)
        targets = [
            w * len(d) if len(d) > 0 else 0
            for w, d in zip(self._weights, self._datasets)
        ]
        total_target = sum(targets)
        if total_target == 0:
            return
        emitted = 0
        while emitted < total_target:
            # pick the dataset with the least progress fraction
            fractions = [
                counts[i] / targets[i] if targets[i] > 0 else float("inf")
                for i in range(len(iters))
            ]
            i = int(np.argmin(fractions))
            if fractions[i] == float("inf"):
                return
            try:
                yield next(iters[i])
            except StopIteration:
                iters[i] = iter(self._datasets[i])  # restart exhausted child
                try:
                    yield next(iters[i])
                except StopIteration:
                    targets[i] = 0
                    continue
            counts[i] += 1
            emitted += 1


class Range(SizedIterableDataset):
    """Limit to the first ``num_samples`` (reference: datasets.py:618-670)."""

    def __init__(self, dataset: SizedIterableDataset, num_samples: Optional[int] = None):
        self._dataset = dataset
        self._length = (
            min(num_samples, len(dataset)) if num_samples else len(dataset)
        )
        self._name = dataset.name

    def __len__(self):
        return self._length

    def __iter__(self):
        for i, sample in enumerate(self._dataset):
            if i >= self._length:
                break
            yield sample


class Dataproc(SizedIterableDataset):
    """Preprocessing wrapper (reference: datasets.py:592-615).

    ``num_workers > 1`` maps ``_process`` over a thread pool with bounded
    lookahead, preserving order — the numpy mel/FFT work releases the GIL, so
    this parallelises the host feature pipeline (the reference uses torch
    DataLoader worker processes for the same purpose)."""

    def __init__(self, dataset: SizedIterableDataset, num_workers: int = 1):
        self._dataset = dataset
        self._name = dataset.name
        self._num_workers = num_workers

    @abc.abstractmethod
    def _process(self, sample: VoiceSample) -> Any: ...

    def __len__(self):
        return len(self._dataset)

    def __iter__(self):
        if self._num_workers <= 1:
            for sample in self._dataset:
                yield self._process(sample)
            return
        import collections
        import concurrent.futures

        lookahead = self._num_workers * 2
        with concurrent.futures.ThreadPoolExecutor(self._num_workers) as pool:
            pending: collections.deque = collections.deque()
            iterator = iter(self._dataset)
            try:
                while True:
                    while len(pending) < lookahead:
                        try:
                            sample = next(iterator)
                        except StopIteration:
                            break
                        pending.append(pool.submit(self._process, sample))
                    if not pending:
                        return
                    yield pending.popleft().result()
            except GeneratorExit:
                for fut in pending:
                    fut.cancel()
                raise


_WORDS = (
    "the quick brown fox jumps over a lazy dog while seven wizards "
    "toast bright vivid gems and every child sings small happy tunes"
).split()


class SyntheticAsrDataset(VoiceDataset):
    """Deterministic offline ASR dataset: synthesised tones as audio,
    word-list transcripts. Stand-in for LibriSpeechDummyDataset
    (reference: datasets.py:474-512) in a zero-egress environment."""

    def __init__(
        self,
        args: types.VoiceDatasetArgs,
        num_samples: int = 73,
        duration_secs: float = 1.0,
    ):
        super().__init__(args)
        rows = []
        rng = np.random.default_rng(0)
        n = int(duration_secs * SAMPLE_RATE)
        t = np.arange(n) / SAMPLE_RATE
        for i in range(num_samples):
            freq = 100.0 + 17.0 * (i % 23)
            audio = (0.1 * np.sin(2 * np.pi * freq * t)).astype(np.float32)
            audio += (0.01 * rng.standard_normal(n)).astype(np.float32)
            text = " ".join(
                _WORDS[(i + j) % len(_WORDS)] for j in range(4 + i % 5)
            ).upper()
            rows.append({"audio": audio, "text": text})
        self._init_dataset(rows, "synthetic-asr", num_samples)

    def _get_sample(self, row) -> Optional[VoiceSample]:
        prompt = types.TRANSCRIPTION_PROMPTS[0]
        return VoiceSample(
            messages=[
                {"role": "user", "content": prompt},
                {"role": "assistant", "content": row["text"].lower()},
            ],
            audio=row["audio"] if self._args.include_audio else None,
            audio_transcript=row["text"].lower(),
        )
