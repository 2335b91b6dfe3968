"""Indic-language corpus configs (reference: data/configs/indicvoices.py,
shrutilipi.py, kathbath.py — together ~1.6K LoC of per-language configs)."""

from __future__ import annotations

from typing import List

from ultravox_torch.data.types import (
    CONTINUATION_PROMPTS,
    TRANSCRIPTION_PROMPTS_LANGUAGE,
    DatasetConfig,
    DatasetSplitConfig,
    EvalConfig,
)

INDICVOICES_LANGS = {
    "hindi": 188_584, "bengali": 97_031, "tamil": 96_980, "telugu": 90_852,
    "marathi": 91_618, "kannada": 70_783, "malayalam": 60_142,
    "gujarati": 48_062, "punjabi": 55_778, "odia": 55_334,
    "assamese": 58_062, "urdu": 41_309, "sanskrit": 26_279,
    "maithili": 28_279, "konkani": 25_094, "dogri": 23_078,
    "bodo": 24_755, "santali": 22_963, "kashmiri": 26_262,
    "manipuri": 25_763, "nepali": 25_631, "sindhi": 26_485,
}

SHRUTILIPI_LANGS = {
    "hindi": 1_620_000, "bengali": 400_000, "marathi": 1_000_000,
    "telugu": 390_000, "tamil": 790_000, "kannada": 460_000,
    "malayalam": 625_000, "gujarati": 460_000, "punjabi": 94_000,
    "odia": 600_000, "sanskrit": 29_000, "urdu": 29_000,
}

KATHBATH_LANGS = {
    "hindi": 95_267, "bengali": 47_476, "tamil": 90_609, "telugu": 70_661,
    "marathi": 75_931, "kannada": 66_161, "malayalam": 49_723,
    "gujarati": 66_861, "punjabi": 80_104, "odia": 51_294,
    "urdu": 53_399, "sanskrit": 26_841,
}


def _family(
    out: List[DatasetConfig],
    family: str,
    path: str,
    langs: dict,
    transcript_col: str,
) -> None:
    out.append(
        DatasetConfig(
            name=family,
            path=path,
            transcript_template="{{" + transcript_col + "}}",
        )
    )
    for lang, n_train in langs.items():
        cfg_name = f"{family}-{lang}"
        out.append(
            DatasetConfig(
                name=cfg_name,
                base=family,
                subset=lang,
                splits=[DatasetSplitConfig(name="train", num_samples=n_train)],
            )
        )
        out.append(
            DatasetConfig(
                name=f"{cfg_name}-transcription",
                base=cfg_name,
                user_template=TRANSCRIPTION_PROMPTS_LANGUAGE[0],
                user_template_args={"language": lang.capitalize()},
                assistant_template="{{" + transcript_col + "}}",
                eval_config=EvalConfig(metric="wer", args={"lang_id": lang}),
            )
        )
        # continuation leaves (reference: *_CONT_CONFIG entries — the
        # v0.5.1 hindi-focused recipes train on them)
        out.append(
            DatasetConfig(
                name=f"{cfg_name}-continuation",
                base=cfg_name,
                user_template=CONTINUATION_PROMPTS[0],
                assistant_template="{{continuation}}",
                transcript_template="{{" + transcript_col + "}}",
                eval_config=EvalConfig(metric="bleu"),
            )
        )


# SeamlessAlign indic2en (reference: data/configs/seamlessalign.py — one
# TRAIN split per language inside the subset)
SEAMLESS_LANGS = {
    "hindi": 1_020_000, "kannada": 68_600, "tamil": 479_000,
    "telugu": 329_000, "urdu": 1_110_000,
}


def _seamless(out: List[DatasetConfig]) -> None:
    out.append(
        DatasetConfig(
            name="seamless",
            path="fixie-ai/SeamlessAlign",
            subset="indic2en",
            transcript_template="{{transcription}}",
        )
    )
    for lang, n_train in SEAMLESS_LANGS.items():
        cfg_name = f"seamless-{lang}"
        out.append(
            DatasetConfig(
                name=cfg_name,
                base="seamless",
                splits=[DatasetSplitConfig(name=lang, num_samples=n_train)],
            )
        )
        out.append(
            DatasetConfig(
                name=f"{cfg_name}-transcription",
                base=cfg_name,
                user_template=TRANSCRIPTION_PROMPTS_LANGUAGE[0],
                user_template_args={"language": lang.capitalize()},
                assistant_template="{{transcription}}",
                eval_config=EvalConfig(metric="wer", args={"lang_id": lang}),
            )
        )
        out.append(
            DatasetConfig(
                name=f"{cfg_name}-continuation",
                base=cfg_name,
                user_template=CONTINUATION_PROMPTS[0],
                assistant_template="{{continuation}}",
                eval_config=EvalConfig(metric="bleu"),
            )
        )


def configs() -> List[DatasetConfig]:
    out: List[DatasetConfig] = []
    _family(out, "indicvoices", "ai4bharat/indicvoices_r", INDICVOICES_LANGS, "text")
    _family(out, "shrutilipi", "ai4bharat/shrutilipi", SHRUTILIPI_LANGS, "transcription")
    _family(out, "kathbath", "ai4bharat/kathbath", KATHBATH_LANGS, "transcript")
    _seamless(out)
    return out
