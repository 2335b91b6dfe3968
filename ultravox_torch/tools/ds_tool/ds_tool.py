"""Dataset factory CLI (reference: tools/ds_tool/ds_tool.py:25-287).

Processes an HF dataset in chunks through a task (text generation through
an OpenAI-compatible endpoint, TTS synthesis, augmentation, near-dedup,
ASR, audio splitting, voice-QA generation, background mixing, forced
alignment), with per-chunk retry by subdivision and disk caching, and
saves each finished chunk as it goes.

Tasks are plain dataclasses with ``map_split(dataset, num_proc)``; the
chat, TTS and ASR clients and the aligner are injectable. The chat client
is any OpenAI-compatible one: ``openai.OpenAI(base_url=...)``, or the
port's own server (``inference/serving/api_server.py``), which answers
``/v1/chat/completions`` with the model it serves for any model name.

HF ``datasets`` is imported only where a task or ``main`` needs it:
``AudioMixTask._pool_segments`` (a named pool), ``TimestampTask.map_split``
(to rebuild an HF split) and ``main``.

CLI: ``python -m ultravox_torch.tools.ds_tool.ds_tool textgen --dataset
<hf id or dir> --output_dir <out> --task_args '{model: gpt-4o-mini}'``.
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import logging
import os
from typing import Any, List, Optional

from ultravox_torch.tools.ds_tool.caching import CachingChatWrapper, DiskCache

logger = logging.getLogger(__name__)


# --------------------------------------------------------------------------
# Tasks
# --------------------------------------------------------------------------


@dataclasses.dataclass
class TextGenerationTask:
    """Generate a new column with an LLM (reference: tasks textgen; e.g.
    continuation generation for the -continuation training sets)."""

    new_column_name: str = "continuation"
    template: str = "Continue the following text:\n\n{{ text }}"
    model: str = "gpt-4o-mini"
    max_tokens: int = 128
    temperature: float = 0.0
    client: Any = None  # OpenAI-compatible; required at run time
    cache_dir: str = ".cache/ds_tool/chat"

    def map_split(self, dataset, num_proc: int = 1):
        import jinja2

        tmpl = jinja2.Template(self.template)
        chat = CachingChatWrapper(self.client, self.cache_dir)

        def generate(row):
            prompt = tmpl.render(**row)
            row[self.new_column_name] = chat.chat_completion(
                model=self.model,
                messages=[{"role": "user", "content": prompt}],
                max_tokens=self.max_tokens,
                temperature=self.temperature,
            )
            return row

        return dataset.map(generate)


@dataclasses.dataclass
class TtsTask:
    """Synthesize audio for a text column via an injectable TTS client
    (reference: tasks/tts.py). The client must expose
    ``synthesize(text, voice) -> (np.ndarray, sample_rate)``."""

    column_name: str = "question"
    audio_column_name: str = "question_audio"
    voice: Optional[str] = None
    sample_rate: int = 16000
    # injectable object, or a provider name ("azure"/"eleven") resolved to
    # the concrete HTTP client in tts.py (reference tts.py:164-169)
    client: Any = None

    def __post_init__(self):
        if isinstance(self.client, str):
            from ultravox_torch.tools.ds_tool.tts import create_client

            self.client = create_client(
                self.client, sample_rate=self.sample_rate
            )

    def map_split(self, dataset, num_proc: int = 1):
        def synth(row):
            audio, sr = self.client.synthesize(row[self.column_name], self.voice)
            row[self.audio_column_name] = {
                "array": audio,
                "sampling_rate": sr,
            }
            return row

        return dataset.map(synth)


@dataclasses.dataclass
class AugmentTask:
    """Apply a registered augmentation to the audio column offline
    (reference: tasks augment). The column's array is taken as float32
    numpy, as the other audio tasks take it (an HF split without an
    ``Audio`` feature yields lists, which some augmentations cannot
    take)."""

    audio_column_name: str = "audio"
    augmentation: str = "telephony"

    def map_split(self, dataset, num_proc: int = 1):
        import numpy as np

        from ultravox_torch.data.aug.registry import create_augmentation

        aug = create_augmentation(self.augmentation)
        aug.p = 1.0

        def apply(row):
            entry = dict(row[self.audio_column_name])
            entry["array"] = aug.apply_audio(np.asarray(entry["array"], dtype=np.float32))
            row[self.audio_column_name] = entry
            return row

        return dataset.map(apply)


@dataclasses.dataclass
class DedupTask:
    """Drop near-duplicate rows by normalised-text hash (replaces the
    reference's annoy-based embedding dedup with a deterministic offline
    method)."""

    column_name: str = "text"
    _seen: set = dataclasses.field(default_factory=set)

    def map_split(self, dataset, num_proc: int = 1):
        def key(row):
            norm = " ".join(str(row[self.column_name]).lower().split())
            return hashlib.sha1(norm.encode()).hexdigest()

        def unique(row):
            k = key(row)
            if k in self._seen:
                return False
            self._seen.add(k)
            return True

        return dataset.filter(unique)


@dataclasses.dataclass
class AsrTask:
    """Transcribe an audio column via an injectable ASR client (reference:
    tasks asr — Deepgram). The client must expose
    ``transcribe(audio: np.ndarray, sample_rate: int) -> str``."""

    audio_column_name: str = "audio"
    text_column_name: str = "asr_text"
    client: Any = None

    def map_split(self, dataset, num_proc: int = 1):
        def transcribe(row):
            entry = row[self.audio_column_name]
            row[self.text_column_name] = self.client.transcribe(
                entry["array"], entry.get("sampling_rate", 16000)
            )
            return row

        return dataset.map(transcribe)


@dataclasses.dataclass
class AudioSplitTask:
    """Split long audio rows into fixed windows, one output row per window
    (reference: tasks audiosplit)."""

    audio_column_name: str = "audio"
    window_secs: float = 30.0
    min_window_secs: float = 1.0

    def map_split(self, dataset, num_proc: int = 1):
        def split(batch):
            import numpy as np

            out = {k: [] for k in batch}
            for i in range(len(batch[self.audio_column_name])):
                entry = batch[self.audio_column_name][i]
                audio = np.asarray(entry["array"], dtype=np.float32)
                sr = entry.get("sampling_rate", 16000)
                window = int(self.window_secs * sr)
                for start in range(0, len(audio), window):
                    chunk = audio[start : start + window]
                    if len(chunk) < self.min_window_secs * sr:
                        continue
                    for key in batch:
                        if key == self.audio_column_name:
                            out[key].append(
                                {"array": chunk, "sampling_rate": sr}
                            )
                        else:
                            out[key].append(batch[key][i])
            return out

        return dataset.map(split, batched=True)


@dataclasses.dataclass
class VoiceDsGenTask:
    """Generate question/answer pairs grounded in a transcript column via an
    LLM (reference: tasks voice_ds_gen — manufactures voice-QA training sets
    whose questions are later TTS-synthesised)."""

    transcript_column: str = "text"
    question_column: str = "question"
    answer_column: str = "answer"
    model: str = "gpt-4o-mini"
    max_tokens: int = 256
    client: Any = None
    cache_dir: str = ".cache/ds_tool/chat"
    template: str = (
        "Passage:\n{{ transcript }}\n\n"
        "Write one question a listener could ask about this passage, then "
        "answer it. Respond in the form:\nQ: <question>\nA: <answer>"
    )

    def map_split(self, dataset, num_proc: int = 1):
        import re

        import jinja2

        tmpl = jinja2.Template(self.template)
        chat = CachingChatWrapper(self.client, self.cache_dir)

        def generate(row):
            prompt = tmpl.render(transcript=row[self.transcript_column])
            text = chat.chat_completion(
                model=self.model,
                messages=[{"role": "user", "content": prompt}],
                max_tokens=self.max_tokens,
                temperature=0.0,
            )
            m = re.search(r"Q:\s*(.+?)\s*A:\s*(.+)", text, re.DOTALL)
            row[self.question_column] = m.group(1).strip() if m else ""
            row[self.answer_column] = m.group(2).strip() if m else text.strip()
            return row

        return dataset.map(generate)


@dataclasses.dataclass
class AudioMixTask:
    """Mix background audio (noise/music pool) around each sample's audio
    (reference: tasks/audio_mix_task.py): a random-length slice of pool audio
    is volume-matched to a fraction of the sample's RMS and split into a
    prefix + suffix around the original audio; rows longer than
    ``max_length`` seconds are dropped.

    ``mix_rows`` is the pool: any iterable of rows whose ``mix_audio_field``
    holds an HF-Audio-style dict (tests inject it directly; the CLI loads
    ``mix_dataset``)."""

    mix_dataset: Optional[str] = None
    mix_subset: Optional[str] = None
    mix_split: str = "train"
    audio_field: str = "audio"
    mix_audio_field: str = "audio"
    max_length: float = 15.0
    min_volume_ratio: float = 0.2
    max_volume_ratio: float = 0.5
    normalize: bool = True
    seed: int = 42
    mix_rows: Any = None  # injectable pool (list of rows)

    def _pool_segments(self):
        """Infinite stream of pool audio arrays at 16 kHz float32."""
        import numpy as np

        if self.mix_rows is None:
            import datasets as hf_datasets

            self.mix_rows = hf_datasets.load_dataset(
                self.mix_dataset, self.mix_subset, split=self.mix_split
            )
        while True:
            for row in self.mix_rows:
                entry = row[self.mix_audio_field]
                arr = np.asarray(entry["array"], dtype=np.float32)
                sr = entry.get("sampling_rate", 16000)
                yield arr, sr

    def _take(self, gen, n_samples: int, sr: int):
        import numpy as np

        from ultravox_torch.utils.audio import resample

        out = np.zeros(0, np.float32)
        while len(out) < n_samples:
            arr, pool_sr = next(gen)
            if pool_sr != sr:
                arr = resample(arr, pool_sr, sr)
            out = np.concatenate([out, arr])
        return out[:n_samples]

    def map_split(self, dataset, num_proc: int = 1):
        import random

        import numpy as np

        rng = random.Random(self.seed)
        pool = self._pool_segments()

        def keep(row):
            entry = row[self.audio_field]
            sr = entry.get("sampling_rate", 16000)
            return len(entry["array"]) / sr < self.max_length

        def mix(row):
            entry = dict(row[self.audio_field])
            audio = np.asarray(entry["array"], dtype=np.float32)
            sr = entry.get("sampling_rate", 16000)
            available = max(0.0, self.max_length - len(audio) / sr)
            mix_secs = rng.uniform(available * 0.25, available)
            mix_arr = self._take(pool, int(mix_secs * sr), sr)
            if self.normalize and len(mix_arr):
                def rms(x):
                    return float(np.sqrt(np.mean(np.square(x)))) if len(x) else 0.0

                src, tgt = rms(mix_arr), rms(audio)
                if src > 0 and tgt > 0:
                    ratio = rng.uniform(
                        self.min_volume_ratio, self.max_volume_ratio
                    )
                    mix_arr = mix_arr * (tgt / src * ratio)
            split = rng.randint(0, len(mix_arr)) if len(mix_arr) else 0
            mixed = np.concatenate([mix_arr[:split], audio, mix_arr[split:]])
            peak = np.max(np.abs(mixed)) if len(mixed) else 0.0
            if peak > 1.0:
                mixed = mixed / peak
            entry["array"] = mixed
            row[self.audio_field] = entry
            return row

        return dataset.filter(keep).map(mix)


@dataclasses.dataclass
class TimestampTask:
    """Word-level timestamp generation via the Montreal Forced Aligner
    (reference: tasks/timestamp_gen_task.py): writes audio/text pairs to a
    temp corpus, shells out to ``mfa align``, parses the TextGrid word tier
    into ``[{start, end, text}, ...]`` per row. The ``aligner`` callable is
    injectable for offline tests; without MFA installed the task raises a
    clear error at construction."""

    template: str = "{{ text }}"
    mfa_acoustic_model: str = "english_mfa"
    mfa_dictionary: Optional[str] = None
    audio_field: str = "audio"
    timestamp_column: str = "timestamps"
    aligned_ratio_check: float = 0.95
    aligner: Any = None  # callable(corpus_dir, out_dir) -> None

    def __post_init__(self):
        if self.mfa_dictionary is None:
            self.mfa_dictionary = self.mfa_acoustic_model
        if self.aligner is None:
            import shutil

            if shutil.which("mfa") is None:
                raise RuntimeError(
                    "TimestampTask needs the Montreal Forced Aligner "
                    "('mfa' binary on PATH) or an injected aligner callable"
                )
            self.aligner = self._mfa_align

    def _mfa_align(self, corpus_dir: str, out_dir: str) -> None:
        import subprocess

        subprocess.run(
            [
                "mfa", "align", corpus_dir,
                self.mfa_dictionary, self.mfa_acoustic_model, out_dir,
                "--clean", "--use_mp",
            ],
            check=True,
        )

    @staticmethod
    def parse_textgrid_words(path: str):
        """Minimal TextGrid parser: the 'words' tier's non-empty intervals
        as [{start, end, text}]."""
        import re

        with open(path) as f:
            content = f.read()
        words = []
        # find the words tier, then its intervals
        tiers = re.split(r'item\s*\[\d+\]:', content)
        for tier in tiers:
            if '"words"' not in tier:
                continue
            for m in re.finditer(
                r"xmin\s*=\s*([\d.]+)\s*\n\s*xmax\s*=\s*([\d.]+)\s*\n\s*"
                r'text\s*=\s*"([^"]*)"',
                tier,
            ):
                text = m.group(3).strip()
                if text:
                    words.append(
                        {
                            "start": float(m.group(1)),
                            "end": float(m.group(2)),
                            "text": text,
                        }
                    )
        return words

    def map_split(self, dataset, num_proc: int = 1):
        import tempfile

        import jinja2
        import numpy as np

        tmpl = jinja2.Template(self.template)
        with tempfile.TemporaryDirectory() as tmp:
            corpus = os.path.join(tmp, "corpus")
            aligned = os.path.join(tmp, "aligned")
            os.makedirs(corpus)
            from ultravox_torch.data.sample import audio_to_wav_bytes

            rows = list(dataset)
            for i, row in enumerate(rows):
                entry = row[self.audio_field]
                arr = np.asarray(entry["array"], dtype=np.float32)
                sr = int(entry.get("sampling_rate", 16000))
                with open(os.path.join(corpus, f"utt{i:06d}.wav"), "wb") as f:
                    f.write(audio_to_wav_bytes(arr, sr))
                with open(os.path.join(corpus, f"utt{i:06d}.txt"), "w") as f:
                    f.write(tmpl.render(**row))
            self.aligner(corpus, aligned)

            n_aligned = 0
            for i, row in enumerate(rows):
                tg = os.path.join(aligned, f"utt{i:06d}.TextGrid")
                if os.path.exists(tg):
                    row[self.timestamp_column] = self.parse_textgrid_words(tg)
                    n_aligned += 1
                else:
                    row[self.timestamp_column] = None
            if n_aligned < self.aligned_ratio_check * len(rows):
                raise RuntimeError(
                    f"only {n_aligned}/{len(rows)} rows aligned "
                    f"(< {self.aligned_ratio_check:.0%})"
                )
        import datasets as hf_datasets

        if isinstance(dataset, hf_datasets.Dataset):
            return hf_datasets.Dataset.from_list(rows)
        return rows


TASKS = {
    "textgen": TextGenerationTask,
    "tts": TtsTask,
    "augment": AugmentTask,
    "dedup": DedupTask,
    "asr": AsrTask,
    "audiosplit": AudioSplitTask,
    "voice_ds_gen": VoiceDsGenTask,
    "audiomix": AudioMixTask,
    "timestamp": TimestampTask,
}


# --------------------------------------------------------------------------
# Chunked processing
# --------------------------------------------------------------------------


@dataclasses.dataclass
class DatasetChunkProcessor:
    """Process a dataset split in chunks with recursive subdivision on
    failure and an on-disk record of completed chunks
    (reference: ds_tool.py:137-211)."""

    task: Any
    output_dir: str
    chunk_size: int = 1000
    min_chunk_size: int = 10
    num_proc: int = 1

    def __post_init__(self):
        self._done = DiskCache(os.path.join(self.output_dir, ".chunks_done"))

    def process_split(self, dataset, split_name: str = "train") -> List[str]:
        """Returns the list of saved chunk directories."""
        n = len(dataset)
        saved: List[str] = []
        for start in range(0, n, self.chunk_size):
            end = min(start + self.chunk_size, n)
            saved.extend(self._process_range(dataset, split_name, start, end))
        return saved

    def _process_range(self, dataset, split_name, start, end) -> List[str]:
        tag = {"split": split_name, "start": start, "end": end}
        out_path = os.path.join(
            self.output_dir, f"{split_name}-{start:08d}-{end:08d}"
        )
        if os.path.exists(out_path):
            return [out_path]
        chunk = dataset.select(range(start, end))
        try:
            processed = self.task.map_split(chunk, self.num_proc)
            processed.save_to_disk(out_path)
            return [out_path]
        except Exception as e:  # noqa: BLE001
            size = end - start
            if size <= self.min_chunk_size:
                logger.error("chunk %s failed permanently: %s", tag, e)
                return []
            logger.warning("chunk %s failed (%s); subdividing", tag, e)
            mid = start + size // 2
            return self._process_range(
                dataset, split_name, start, mid
            ) + self._process_range(dataset, split_name, mid, end)


def main():
    import datasets as hf_datasets

    parser = argparse.ArgumentParser()
    parser.add_argument("task", choices=sorted(TASKS))
    parser.add_argument("--dataset", required=True)
    parser.add_argument("--subset", default=None)
    parser.add_argument("--split", default="train")
    parser.add_argument("--output_dir", required=True)
    parser.add_argument("--chunk_size", type=int, default=1000)
    parser.add_argument("--task_args", default="{}")
    args = parser.parse_args()

    import yaml

    logging.basicConfig(level=logging.INFO)
    task_kwargs = yaml.safe_load(args.task_args) or {}
    task_cls = TASKS[args.task]
    if args.task == "textgen" and "client" not in task_kwargs:
        import openai

        task_kwargs["client"] = openai.OpenAI()
    if args.task == "tts" and "client" not in task_kwargs:
        # concrete provider clients live in tts.py (reference tts.py default)
        task_kwargs["client"] = "azure"
    task = task_cls(**task_kwargs)

    ds = hf_datasets.load_dataset(args.dataset, args.subset, split=args.split)
    proc = DatasetChunkProcessor(
        task=task, output_dir=args.output_dir, chunk_size=args.chunk_size
    )
    saved = proc.process_split(ds, args.split)
    print(f"saved {len(saved)} chunks to {args.output_dir}")


if __name__ == "__main__":
    main()
