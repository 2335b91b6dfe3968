"""Benchmark-suite dataset configs (reference: data/configs/voicebench.py,
audiobench.py, bigbenchaudio.py, ami.py, musan.py, seamlessalign.py)."""

from __future__ import annotations

from typing import List

from ultravox_torch.data import types
from ultravox_torch.data.types import (
    AUDIO_PLACEHOLDER,
    QA_PROMPT,
    DatasetConfig,
    DatasetSplitConfig,
    EvalConfig,
)

VOICEBENCH_SUBSETS = {
    # subset -> (num test samples, metric)
    "alpacaeval": (199, "voicebench_open"),
    "alpacaeval_full": (636, "voicebench_open"),
    "commoneval": (200, "voicebench_open"),
    "wildvoice": (1000, "voicebench_open"),
    "openbookqa": (455, "voicebench_mcq"),
    "mmsu": (3074, "voicebench_mcq"),
    "sd-qa": (553, "voicebench_qa"),
    "advbench": (520, "voicebench_harm"),
    "ifeval": (345, "voicebench_ifeval"),
    "bbh": (1000, "voicebench_mcq"),
}

AUDIOBENCH_SUBSETS = {
    "cn_college_listen_mcq_test": (2_271, "voicebench_mcq"),
    "dream_tts_mcq_test": (1_910, "voicebench_mcq"),
    "slue_p2_sqa5_test": (408, "audiobench_binary"),
    "public_sg_speech_qa_test": (688, "audiobench_binary"),
    "openhermes_audio_test": (100, "audiobench_scalar"),
    "alpaca_audio_test": (100, "audiobench_scalar"),
}


def configs() -> List[DatasetConfig]:
    out: List[DatasetConfig] = []

    # -- VoiceBench ----------------------------------------------------------
    out.append(
        DatasetConfig(
            name="voicebench",
            path="hlt-lab/voicebench",
            user_template=QA_PROMPT,
            assistant_template="{{reference if reference is defined else output}}",
            transcript_template="{{prompt}}",
        )
    )
    for subset, (n, metric) in VOICEBENCH_SUBSETS.items():
        out.append(
            DatasetConfig(
                name=f"voicebench-{subset}",
                base="voicebench",
                subset=subset,
                splits=[
                    DatasetSplitConfig(
                        name="test", num_samples=n, split=types.DatasetSplit.TEST
                    )
                ],
                eval_config=EvalConfig(metric=metric),
            )
        )

    # -- AudioBench ----------------------------------------------------------
    out.append(
        DatasetConfig(
            name="audiobench",
            path="AudioLLMs/audiobench",
            user_template=QA_PROMPT,
            assistant_template="{{answer}}",
            transcript_template="{{instruction}}",
        )
    )
    for subset, (n, metric) in AUDIOBENCH_SUBSETS.items():
        out.append(
            DatasetConfig(
                name=f"audiobench-{subset}",
                base="audiobench",
                subset=subset,
                splits=[
                    DatasetSplitConfig(
                        name="test", num_samples=n, split=types.DatasetSplit.TEST
                    )
                ],
                eval_config=EvalConfig(metric=metric),
            )
        )

    # -- BigBench Audio ---------------------------------------------------------
    out.append(
        DatasetConfig(
            name="bigbenchaudio",
            path="fixie-ai/big_bench_audio",
            splits=[
                DatasetSplitConfig(
                    name="train", num_samples=1_000, split=types.DatasetSplit.TEST
                )
            ],
            user_template=QA_PROMPT,
            assistant_template="{{official_answer}}",
            transcript_template="{{transcript}}",
            eval_config=EvalConfig(metric="bigbench"),
        )
    )

    # -- AMI meeting transcription ----------------------------------------------
    out.append(
        DatasetConfig(
            name="ami",
            path="edinburghcstr/ami",
            subset="ihm",
            splits=[
                DatasetSplitConfig(name="train", num_samples=108_502),
                DatasetSplitConfig(
                    name="test", num_samples=12_643, split=types.DatasetSplit.TEST
                ),
            ],
            user_template="Transcribe\n" + AUDIO_PLACEHOLDER,
            assistant_template="{{ text_proc.format_asr_text(text) }}",
            transcript_template="{{ text_proc.format_asr_text(text) }}",
            eval_config=EvalConfig(metric="wer"),
        )
    )

    # -- MUSAN (noise source for augmentation mixing) ------------------------------
    out.append(
        DatasetConfig(
            name="musan",
            path="ylacombe/musan",
            splits=[DatasetSplitConfig(name="train", num_samples=2_016)],
            user_template=QA_PROMPT,
            assistant_template="noise",
        )
    )

    # -- SeamlessAlign (speech-text alignment pairs) ----------------------------
    out.append(
        DatasetConfig(
            name="seamlessalign",
            path="fixie-ai/seamless-align-expressive",
            splits=[DatasetSplitConfig(name="train", num_samples=1_000_000)],
            user_template="Continue: " + AUDIO_PLACEHOLDER,
            assistant_template="{{continuation}}",
            transcript_template="{{text}}",
        )
    )
    return out
