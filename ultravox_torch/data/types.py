"""Dataset configuration types.

Re-design of the reference's ``data/types.py``: declarative, inheritable
``DatasetConfig`` with Jinja2 templates for user/assistant/transcript/system
messages, split declarations with sample counts, and ``VoiceDatasetArgs``
train/val/eval specialisations.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Any, Dict, List, Optional

# Prompt templates (reference: data/types.py:9-34)
AUDIO_PLACEHOLDER = "<|audio|>"

TRANSCRIPTION_PROMPTS = [
    f"Transcribe\n{AUDIO_PLACEHOLDER}",
    f"Transcribe exactly what is said here\n{AUDIO_PLACEHOLDER}",
    f"Repeat exactly what is written here: {AUDIO_PLACEHOLDER}",
    f"Write down exactly what was said: {AUDIO_PLACEHOLDER}",
    f"First listen to the clip. Then, transcribe exactly what is said. {AUDIO_PLACEHOLDER}",
    f"Listen and transcribe: {AUDIO_PLACEHOLDER}",
    f"Transcribe the following: {AUDIO_PLACEHOLDER}",
    f"Provide a transcription of this audio: {AUDIO_PLACEHOLDER}",
]

TRANSCRIPTION_PROMPTS_LANGUAGE = [
    f"Transcribe this {{language}} audio\n{AUDIO_PLACEHOLDER}",
    f"Write down exactly what was said, in {{language}}: {AUDIO_PLACEHOLDER}",
    f"Transcribe the following {{language}} speech: {AUDIO_PLACEHOLDER}",
]

CONTINUATION_PROMPTS = [
    f"Continue the following text using less than 50 words:\n\n{AUDIO_PLACEHOLDER}",
    f"Keep going with this text, in less than 50 words:\n\n{AUDIO_PLACEHOLDER}",
    f"Complete this text, in less than 50 words:\n\n{AUDIO_PLACEHOLDER}",
]

QA_PROMPT = f"{AUDIO_PLACEHOLDER}"


class DatasetSplit(str, enum.Enum):
    TRAIN = "train"
    VALIDATION = "validation"
    TEST = "test"


@dataclasses.dataclass
class DatasetSplitConfig:
    name: str  # HF split name, e.g. "train" or "train.clean.360"
    num_samples: int
    split: DatasetSplit = DatasetSplit.TRAIN

    def __post_init__(self):
        if isinstance(self.split, str):
            self.split = DatasetSplit(self.split)
        # heuristic matching the reference: validation/test names map to
        # their eval splits by default
        if self.split == DatasetSplit.TRAIN:
            low = self.name.lower()
            if "val" in low or "dev" in low:
                self.split = DatasetSplit.VALIDATION
            elif low.startswith("test"):
                self.split = DatasetSplit.TEST


@dataclasses.dataclass
class EvalConfig:
    """Which metric scores this dataset's outputs (reference:
    types.py eval_config)."""

    metric: str
    args: Dict[str, Any] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class DatasetConfig:
    """Declarative dataset description; supports ``base`` inheritance chains
    resolved by the registry (reference: data/types.py:152-216)."""

    name: str
    base: Optional[str] = None
    path: Optional[str] = None  # HF dataset path or local dir / mds:// url
    subset: Optional[str] = None
    splits: Optional[List[DatasetSplitConfig]] = None
    # Jinja2 templates rendered with the row in scope
    user_template: Optional[str] = None
    user_template_args: Optional[Dict[str, str]] = None
    assistant_template: Optional[str] = None
    transcript_template: Optional[str] = None
    system_prompt: Optional[str] = None
    # column carrying pre-built chat messages (skips templates)
    messages_direct_column: Optional[str] = None
    audio_field: Optional[str] = "audio"
    use_mds: Optional[bool] = None
    mds_batch_size: Optional[int] = None
    eval_config: Optional[EvalConfig] = None

    def __post_init__(self):
        if self.splits:
            self.splits = [
                s if isinstance(s, DatasetSplitConfig) else DatasetSplitConfig(**s)
                for s in self.splits
            ]
        if self.eval_config and not isinstance(self.eval_config, EvalConfig):
            self.eval_config = EvalConfig(**self.eval_config)

    def merged_with(self, child: "DatasetConfig") -> "DatasetConfig":
        """Child fields override parent fields when set (reference:
        registry._merge_configs, data/registry.py:42-51)."""
        out = dataclasses.replace(self)
        for f in dataclasses.fields(child):
            v = getattr(child, f.name)
            if v is not None and f.name != "base":
                setattr(out, f.name, v)
        out.name = child.name
        out.base = None
        return out

    def validate(self):
        if self.path is None:
            raise ValueError(f"dataset {self.name}: path is required")
        if self.splits is None:
            raise ValueError(f"dataset {self.name}: splits are required")
        if self.user_template is None and self.messages_direct_column is None:
            raise ValueError(
                f"dataset {self.name}: user_template or "
                "messages_direct_column is required"
            )


@dataclasses.dataclass
class VoiceDatasetArgs:
    """Runtime iteration args (reference: data/types.py:50-118)."""

    shuffle: bool = False
    shuffle_seed: int = 42
    shuffle_buffer_size: int = 1000
    max_audio_duration_secs: Optional[float] = 16.0
    max_input_characters: Optional[int] = 2200
    min_audio_duration_secs: Optional[float] = None
    split: DatasetSplit = DatasetSplit.TRAIN
    language: Optional[str] = None
    include_audio: bool = True
    batch_size: int = 4


@dataclasses.dataclass
class TrainDatasetArgs(VoiceDatasetArgs):
    shuffle: bool = True


@dataclasses.dataclass
class ValDatasetArgs(VoiceDatasetArgs):
    split: DatasetSplit = DatasetSplit.VALIDATION


@dataclasses.dataclass
class EvalDatasetArgs(VoiceDatasetArgs):
    split: DatasetSplit = DatasetSplit.TEST
    max_audio_duration_secs: Optional[float] = None
    max_input_characters: Optional[int] = None
